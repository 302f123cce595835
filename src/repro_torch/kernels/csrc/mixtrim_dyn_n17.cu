// K2 / K4's n <= 64 body (csrc/mixtrim_dyn.cuh) compiled at heights
// 17..24: a translation unit of its own so that nvcc builds it in
// parallel with the others.
#include "mixtrim_dyn.cuh"

namespace mixtrim_dyn_detail {

template int launch_n<17>(const Args&);
template int launch_n<18>(const Args&);
template int launch_n<19>(const Args&);
template int launch_n<20>(const Args&);
template int launch_n<21>(const Args&);
template int launch_n<22>(const Args&);
template int launch_n<23>(const Args&);
template int launch_n<24>(const Args&);

}  // namespace mixtrim_dyn_detail
