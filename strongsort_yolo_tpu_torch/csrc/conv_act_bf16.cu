// K7, CUDA-core taps form: the bfloat16 instances (the kernel and its note
// are in conv_act.cuh; the route's bfloat16 form is mma, conv_mma.cuh).

#include "conv_act.cuh"

cudaError_t conv_act_taps_bf16(const void* x, const void* w, const void* b,
                               void* out, int n, const k7cc::Geo& g, int k,
                               int n_tile, int act, int wvec, int ovec,
                               cudaStream_t s) {
  return k7cc::dispatch<__nv_bfloat16, false>(x, w, b, out, n, g, k, n_tile,
                                              act, wvec, ovec, s);
}
