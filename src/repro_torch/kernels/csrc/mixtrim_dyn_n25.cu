// K2 / K4's n <= 64 body (csrc/mixtrim_dyn.cuh) compiled at heights
// 25..32: a translation unit of its own so that nvcc builds it in
// parallel with the others.
#include "mixtrim_dyn.cuh"

namespace mixtrim_dyn_detail {

template int launch_n<25>(const Args&);
template int launch_n<26>(const Args&);
template int launch_n<27>(const Args&);
template int launch_n<28>(const Args&);
template int launch_n<29>(const Args&);
template int launch_n<30>(const Args&);
template int launch_n<31>(const Args&);
template int launch_n<32>(const Args&);

}  // namespace mixtrim_dyn_detail
