// K2 and K4 for 64 < n <= 1024 workers: the bf16 instances of the
// register-tiled mix (mixtrim_select.cuh), compiled apart from
// mixtrim_select.cu so that nvcc builds both in parallel.
#include "mixtrim_select.cuh"

namespace mixtrim_select {
template int launch_mix_n<__nv_bfloat16>(const Args&);
}  // namespace mixtrim_select
