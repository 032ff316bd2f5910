// K7, mma form: the k = 1 instances and the C entry point (the kernel
// and its note are in conv_mma.cuh; the k = 3 instances in
// conv_mma_k3.cu).

#include "conv_mma.cuh"

cudaError_t conv_mma_k1(const void* x, const void* wp, const void* b, void* out,
                        int n, int h, int wd, int c_in, int c_out,
                        const long long* strides, int n_tile, int n_pad,
                        int chunks, int act, int vec, cudaStream_t s) {
  const Geometry g{h, wd, c_in, c_out, strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5], strides[6],
                   strides[7]};
  return dispatch<1>(x, wp, b, out, n, g, n_tile, n_pad, chunks, act, vec, s);
}

// x (n, c_in, h, w) and out (n, c_out, h, w), bfloat16, through the given
// strides; wp the packed weights (chunks, k*k, 2, n_pad, 8) bfloat16
// (ops/cuda/conv_kernel.py::pack_mma: chunks of 16 input channels, a
// multiple of 4 for k = 1), n_pad a multiple of n_tile; b (c_out,)
// float32. k is 1 or 3.
extern "C" int ssyt_conv_mma(const void* x, const void* wp, const void* b,
                             void* out, int n, int h, int wd, int c_in,
                             int c_out, long long sxn, long long sxc,
                             long long sxh, long long sxw, long long son,
                             long long soc, long long soh, long long sow,
                             int k, int act, int n_tile, int n_pad,
                             int chunks, void* stream) {
  if ((k != 1 && k != 3) || n < 1 || n > 65535 || h < 1 || wd < 1 ||
      c_in < 1 || c_out < 1 || n_tile < 1 || n_pad % n_tile != 0 ||
      n_pad < c_out || chunks * 16 < c_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long strides[8] = {sxn, sxc, sxh, sxw, son, soc, soh, sow};
  const int vec = sow == 1 && soc % 8 == 0 && soh % 8 == 0 && son % 8 == 0 &&
                  wd % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k == 1 ? conv_mma_k1(x, wp, b, out, n, h, wd, c_in, c_out, strides,
                           n_tile, n_pad, chunks, act, vec, s)
             : conv_mma_k3(x, wp, b, out, n, h, wd, c_in, c_out, strides,
                           n_tile, n_pad, chunks, act, vec, s);
  return static_cast<int>(err);
}
