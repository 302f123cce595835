// K2 / K4's n <= 64 body (csrc/mixtrim_dyn.cuh) compiled at heights 48
// (n = 33..48) and 64 (n = 49..64), with n read at run time: a
// translation unit of its own so that nvcc builds it in parallel with
// the others.
#include "mixtrim_dyn.cuh"

namespace mixtrim_dyn_detail {

template int launch_n<48>(const Args&);
template int launch_n<64>(const Args&);

}  // namespace mixtrim_dyn_detail
