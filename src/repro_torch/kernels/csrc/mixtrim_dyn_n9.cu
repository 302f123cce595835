// K2 / K4's n <= 64 body (csrc/mixtrim_dyn.cuh) compiled at heights
// 9..16: a translation unit of its own so that nvcc builds it in
// parallel with the others.
#include "mixtrim_dyn.cuh"

namespace mixtrim_dyn_detail {

template int launch_n<9>(const Args&);
template int launch_n<10>(const Args&);
template int launch_n<11>(const Args&);
template int launch_n<12>(const Args&);
template int launch_n<13>(const Args&);
template int launch_n<14>(const Args&);
template int launch_n<15>(const Args&);
template int launch_n<16>(const Args&);

}  // namespace mixtrim_dyn_detail
