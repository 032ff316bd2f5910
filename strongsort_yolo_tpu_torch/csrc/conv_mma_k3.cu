// K7, mma form: the k = 3 instances (the kernel and its note are in
// conv_mma.cuh).

#include "conv_mma.cuh"

cudaError_t conv_mma_k3(const void* x, const void* wp, const void* b, void* out,
                        int n, int h, int wd, int c_in, int c_out,
                        const long long* strides, int n_tile, int n_pad,
                        int chunks, int act, int vec, cudaStream_t s) {
  const Geometry g{h, wd, c_in, c_out, strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5], strides[6],
                   strides[7]};
  return dispatch<3>(x, wp, b, out, n, g, n_tile, n_pad, chunks, act, vec, s);
}
