// K4: per-detection bilinear crop-resize from a frame pyramid.
//
// Replaces strongsort_yolo_tpu/ops/pallas/crop_kernel.py: banded_crop_planar
// (the fixed-width form, reached through banded_crop) and banded_crop_packed
// (G packed slots, each with its own source frame). Both share the body
// _tap_and_sample: per crop, two-tap interpolation weights
// max(0, 1 - |i - clip(pos, 0, len - 1)|), a column pass whose sums are
// rounded to the compute dtype, then a row pass rounded again.
//
// The TPU kernel contracts a whole (256, 512) band of the chosen pyramid
// level against in-kernel tap matrices on the MXU; the band and its
// (8, 128) alignment only make the dynamic slice a native vector load and
// guarantee that both taps fall inside it. Here each thread samples the
// level directly: 4 reads per output pixel and channel instead of a band.
//
// Layout: the pyramid of S frames is stacked vertically and planar,
// (S, C=3, sum h_l, w_0) in the compute dtype; level l starts at row
// row_off[l]. Per slot g: scal[g] = [y_base, y_step, x_base, x_step, h_l,
// w_l] (float32, ops/crops.banded_prep), ints[g, 2] = l, slot_frame[g] =
// source frame. Output (G, 3, oh, ow) in the compute dtype: OSNet's NCHW
// input. One thread per (slot, output row, output column) covers the
// three channels, so the tap arithmetic is done once and stores are
// coalesced along the output row.
//
// Bound: memory and launch. At G = 1024 slots it writes 50 MB of bf16
// output and reads about as many scattered source pixels, mostly from
// L2 (the pyramid of 8 1080p frames is ~33 MB in bf16). No shared
// memory, no staging: a simple kernel that is right first.
//
// Arithmetic order matches the plain PyTorch version
// (ops/cuda/crop_kernel.py::banded_crop_plain) exactly: the sample
// position is one rounded multiply-add, every other product and sum is
// rounded on its own (_rn intrinsics; the build passes -fmad=false),
// tap weights and the column-pass sums rounded to the compute dtype where
// the TPU kernel rounds them. A tap at index h_l (or w_l), which the
// clipped position gives at a level's last row with weight 0, is read at
// h_l - 1 instead: the weight is 0 either way and nothing past the level
// is touched. An out-of-range frame or level index is clamped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float load_f(const T* p);

template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T to_t(float v);

template <>
__device__ __forceinline__ float to_t<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back to float
template <typename T>
__device__ __forceinline__ float round_t(float v);

template <>
__device__ __forceinline__ float round_t<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two taps of one output sample: indices (lo, hi) inside [0, len - 1] and
// their weights rounded to T.
template <typename T>
__device__ __forceinline__ void taps(float base, float step, int k, float len,
                                     int* lo, int* hi, float* w_lo,
                                     float* w_hi) {
  // base + k * step rounded once, as the reference computes it (XLA's
  // CPU backend contracts the multiply-add); the float32 product is
  // exact in double, and the plain version rounds the same double sum
  float pos = __double2float_rn(
      __dadd_rn(__dmul_rn((double)k, (double)step), (double)base));
  pos = fminf(fmaxf(pos, 0.0f), __fsub_rn(len, 1.0f));
  const float fl = floorf(pos);
  *w_lo = round_t<T>(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(fl, pos)))));
  *w_hi = round_t<T>(
      fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(__fadd_rn(fl, 1.0f), pos)))));
  const int n = (int)len;
  *lo = (int)fl;
  *hi = min(*lo + 1, n - 1);
}

template <typename T>
__global__ void banded_crop_kernel(const T* __restrict__ stack,
                                   const int32_t* __restrict__ row_off,
                                   int n_levels, const float* __restrict__ scal,
                                   const int32_t* __restrict__ ints,
                                   const int32_t* __restrict__ slot_frame,
                                   T* __restrict__ out, int S, int sum_h,
                                   int width, int G, int oh, int ow) {
  const int64_t total = (int64_t)G * oh * ow;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int q = (int)(idx % ow);
  const int64_t t = idx / ow;
  const int r = (int)(t % oh);
  const int g = (int)(t / oh);

  const float* sc = scal + (int64_t)g * 6;
  const int lvl = min(max(ints[(int64_t)g * 3 + 2], 0), n_levels - 1);
  const int f = min(max(slot_frame[g], 0), S - 1);

  int y0, y1, x0, x1;
  float wy0, wy1, wx0, wx1;
  taps<T>(sc[0], sc[1], r, sc[4], &y0, &y1, &wy0, &wy1);
  taps<T>(sc[2], sc[3], q, sc[5], &x0, &x1, &wx0, &wx1);

  const int64_t plane = (int64_t)sum_h * width;
  const int64_t row_a = (int64_t)(row_off[lvl] + y0) * width;
  const int64_t row_b = (int64_t)(row_off[lvl] + y1) * width;
  const int64_t hw_out = (int64_t)oh * ow;
  for (int c = 0; c < 3; ++c) {
    const T* p = stack + ((int64_t)f * 3 + c) * plane;
    const float a00 = load_f<T>(p + row_a + x0);
    const float a01 = load_f<T>(p + row_a + x1);
    const float a10 = load_f<T>(p + row_b + x0);
    const float a11 = load_f<T>(p + row_b + x1);
    // columns first: each needed row reduced with the column taps
    const float t0 =
        round_t<T>(__fadd_rn(__fmul_rn(wx0, a00), __fmul_rn(wx1, a01)));
    const float t1 =
        round_t<T>(__fadd_rn(__fmul_rn(wx0, a10), __fmul_rn(wx1, a11)));
    // then rows
    const float v = __fadd_rn(__fmul_rn(wy0, t0), __fmul_rn(wy1, t1));
    out[((int64_t)g * 3 + c) * hw_out + (int64_t)r * ow + q] = to_t<T>(v);
  }
}

}  // namespace

extern "C" int ssyt_banded_crop(const void* stack, int bf16,
                                const void* row_off, int n_levels,
                                const void* scal, const void* ints,
                                const void* slot_frame, void* out, int S,
                                int sum_h, int width, int G, int oh, int ow,
                                void* stream) {
  const int64_t total = (int64_t)G * oh * ow;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ro = static_cast<const int32_t*>(row_off);
  const float* sc = static_cast<const float*>(scal);
  const int32_t* in = static_cast<const int32_t*>(ints);
  const int32_t* sf = static_cast<const int32_t*>(slot_frame);
  if (bf16) {
    banded_crop_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(stack), ro, n_levels, sc, in, sf,
        static_cast<__nv_bfloat16*>(out), S, sum_h, width, G, oh, ow);
  } else {
    banded_crop_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(stack), ro, n_levels, sc, in, sf,
        static_cast<float*>(out), S, sum_h, width, G, oh, ow);
  }
  return (int)cudaGetLastError();
}
