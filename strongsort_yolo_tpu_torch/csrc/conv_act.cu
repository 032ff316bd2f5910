// K7, CUDA-core forms: the float32 instances (taps, the route's float32
// form, and im2col) and the C entry point (the kernel and its note are in
// conv_act.cuh; the bfloat16 taps instances in conv_act_bf16.cu).

#include <limits.h>

#include "conv_act.cuh"

// x (n, c_in, h, w) and out (n, c_out, h, w) through the given strides, in
// float32 (dtype 0) or bfloat16 (1); w (k*k*c_in, c_out) row-major
// float32, rounded to x's dtype by the caller; b (c_out,) float32. k is 1
// or 3; form 0 is taps, 1 im2col (float32 only: the bfloat16 im2col form
// is ssyt_conv_im2col_mma); n_tile (32, 64, 80 or 128) output channels a
// block.
extern "C" int ssyt_conv_act(const void* x, const void* w, const void* b,
                             void* out, int n, int h, int wd, int c_in,
                             int c_out, long long sxn, long long sxc,
                             long long sxh, long long sxw, long long son,
                             long long soc, long long soh, long long sow,
                             int k, int act, int form, int dtype, int n_tile,
                             void* stream) {
  using k7cc::span;
  if ((k != 1 && k != 3) || (form != 0 && form != 1) ||
      (dtype != 0 && dtype != 1) || (form == 1 && dtype == 1) || n < 1 ||
      n > 65535 || h < 1 || wd < 1 || c_in < 1 || c_out < 1 || sxc < 0 ||
      sxh < 0 || sxw < 0 || soc < 0 || soh < 0 || sow < 0 ||
      span(c_in, h, wd, sxc, sxh, sxw) >= INT_MAX ||
      span(c_out, h, wd, soc, soh, sow) >= INT_MAX ||
      static_cast<long long>(n) * h * wd >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const k7cc::Geo g{h,  wd, c_in, c_out, sxn, son,
                    static_cast<int>(sxc), static_cast<int>(sxh),
                    static_cast<int>(sxw), static_cast<int>(soc),
                    static_cast<int>(soh), static_cast<int>(sow)};
  const int wvec = c_out % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // 8 pixels of a channel per 16-byte store: rows of unit stride, every
  // other stride a whole number of 16 bytes (im2col: runs of 8 pixels
  // inside one row)
  const int v = dtype == 1 ? 8 : 4;
  const int ovec = sow == 1 && soc % v == 0 && soh % v == 0 && son % v == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (form == 0 || wd % 8 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = conv_act_taps_bf16(x, w, b, out, n, g, k, n_tile, act, wvec, ovec, s);
  } else if (form == 1) {
    err = k7cc::dispatch<float, true>(x, w, b, out, n, g, k, n_tile, act,
                                      wvec, ovec, s);
  } else {
    err = k7cc::dispatch<float, false>(x, w, b, out, n, g, k, n_tile, act,
                                       wvec, ovec, s);
  }
  return static_cast<int>(err);
}
