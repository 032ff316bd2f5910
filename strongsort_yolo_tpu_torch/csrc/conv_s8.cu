// K8: the int8 conv of post-training quantization: quantize the input,
// int8 x int8 products summed exactly in int32, then
// y = fma(sum, xscale * wscale[c], b[c]), SiLU if act, one cast to the
// input dtype. One launch per conv.
//
// Replaces no Pallas kernel. Its counterpart is
// strongsort_yolo_tpu/ops/quant.py:41 conv_int8_apply: on the TPU an XLA
// convolution of int8 codes with preferred_element_type=int32 (the int8
// matrix unit), then the dequantize / bias / SiLU epilogue XLA fuses
// after it. PyTorch has no int8 convolution on CUDA, so the port writes
// it, for the int8 tensor cores (1,979 TOPS dense on the H100, 2x its
// bf16 rate).
//
// What it computes, as the JAX function does:
// - quantize: xq = clip(rint(x / xscale), -127, 127), x widened to
//   float32, xscale read from a device pointer (the dynamic scale is a
//   device reduction, the calibrated one a buffer), an IEEE division
//   (__fdiv_rn, as jnp's true division) and rint (half to even, as
//   jnp.round);
// - sum: int32 over (ky, kx, ci), exact, so equal to any other exact
//   order (the plain version sums in float64, exact below 2^53);
// - epilogue: fmaf((float)sum, xscale * wscale[c], b[c]) rounded once,
//   as XLA's CPU backend contracts y * s + b inside jit (the build has
//   -fmad=false, so the fused form is asked for by name); SiLU as
//   y * (1 / (1 + expf(-y))), the formula of torch.sigmoid on the card;
//   then one cast to the output dtype. With sums=1 the int32 sums are
//   written instead (the check of the exact part).
//
// Two forms, one entry point:
// - groups 1: an implicit GEMM on the tensor cores. M = output pixels
//   of one image, N = output channels, K = (tap, ci) with C_in padded to
//   32 per tap (the wrapper packs the weights so, zero where padded:
//   C_in 16 occurs). A block of 4 warps computes 64 pixels x 64
//   channels; per K step of 32 it stages the quantized A tile (each
//   thread one pixel, 16 of the 32 channels, quantized as it loads, zero
//   outside the image) and the B tile (16 bytes a thread) in shared
//   memory, rows padded to 48 bytes, and each warp runs 2 x 4
//   mma.sync.m16n8k32.s8 on its 32 x 32 quarter.
// - depthwise (groups = C_in = C_out): CUDA cores, a thread per output
//   value, its k*k products summed in int32, a row of blocks per
//   (image, channel) plane.
// x is read and the output written through their (n, c, h, w) strides,
// so NCHW activations need no transposing copy.
//
// Bound: the larger of the bytes (x read once, the weights once, the
// output written once) over 3.35 TB/s and 2 x MACs over 1,979 TOPS. The
// convs of a yolov8n forward at 640 move a few bytes per MAC, so most are
// bound by their bytes. This first kernel is not near either: it
// quantizes x again for every tap and every 64 output channels (an IEEE
// division each), loads A with scalar loads, and waits on each tile
// (no cp.async pipeline, no wgmma, no TMA). Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 32;        // K per step: one mma's depth
constexpr int kRow = 48;       // bytes per staged row (32 used)
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int kDwThreads = 256;

struct Geo {
  int h, w, c_in, c_out, h_out, w_out, k, stride, pad, ci_pad, act, sums;
  long long sxn, sxc, sxh, sxw;  // strides of x, in elements
  long long son, soc, soh, sow;  // strides of the output
};

template <typename T>
__device__ __forceinline__ float to_f(T v);

template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);

template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ int quantize(float v, float xs) {
  const float q = rintf(__fdiv_rn(v, xs));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// one output value: the epilogue, or the int32 sum itself
template <typename T>
__device__ __forceinline__ void store(void* out, long long off, int acc,
                                      float s, float b, const Geo& g) {
  if (g.sums) {
    static_cast<int*>(out)[off] = acc;
    return;
  }
  float y = fmaf(static_cast<float>(acc), s, b);
  if (g.act) y = y * (1.0f / (1.0f + expf(-y)));
  static_cast<T*>(out)[off] = from_f<T>(y);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wp: (co_pad, k*k*ci_pad) int8, a row per output channel, K-major
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_s8_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp,
                       const float* __restrict__ wscale,
                       const float* __restrict__ bias,
                       const float* __restrict__ xscale, void* out, Geo g) {
  __shared__ __align__(16) int8_t as[kBM * kRow];  // [pixel][k]
  __shared__ __align__(16) int8_t bs[kBN * kRow];  // [channel][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gq = lane >> 2, t4 = lane & 3;
  const int p0 = blockIdx.x * kBM, co0 = blockIdx.y * kBN;
  const int hw_out = g.h_out * g.w_out;
  const T* xn = x + static_cast<long long>(blockIdx.z) * g.sxn;
  const float xs = *xscale;

  // this thread's A entries: pixel am, channels ak0 + 2 j of each step
  const int am = tid & (kBM - 1), ak0 = tid >> 6;
  const int ap = p0 + am;
  const bool a_ok = ap < hw_out;
  const int iy0 = (a_ok ? ap / g.w_out : 0) * g.stride - g.pad;
  const int ix0 = (a_ok ? ap % g.w_out : 0) * g.stride - g.pad;
  // this thread's B piece: channel row br, bytes bh * 16 .. + 16
  const int br = tid >> 1, bh = tid & 1;
  const long long kpad = static_cast<long long>(g.k) * g.k * g.ci_pad;
  const int8_t* wrow = wp + static_cast<long long>(co0 + br) * kpad + bh * 16;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int chunks = g.ci_pad / kBK;
  const int steps = g.k * g.k * chunks;
  for (int step = 0; step < steps; ++step) {
    const int tap = step / chunks, ci0 = (step % chunks) * kBK;
    const int iy = iy0 + tap / g.k, ix = ix0 + tap % g.k;
    const bool in = a_ok && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
    const long long xoff = in ? iy * g.sxh + ix * g.sxw : 0;
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int kk = ak0 + 2 * j, ci = ci0 + kk;
      int q = 0;
      if (in && ci < g.c_in) q = quantize(to_f<T>(xn[xoff + ci * g.sxc]), xs);
      as[am * kRow + kk] = static_cast<int8_t>(q);
    }
    *reinterpret_cast<int4*>(bs + br * kRow + bh * 16) =
        *reinterpret_cast<const int4*>(wrow + static_cast<long long>(step) * kBK);
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* r = as + (wm * 32 + mi * 16 + gq) * kRow + t4 * 4;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(r);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(r + 8 * kRow);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(r + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(r + 8 * kRow + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* r = bs + (wn * 32 + ni * 8 + gq) * kRow + t4 * 4;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(r);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(r + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }

  const long long on = static_cast<long long>(blockIdx.z) * g.son;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 32 + mi * 16 + gq + half * 8;
      if (p >= hw_out) continue;
      const long long op = on + (p / g.w_out) * g.soh + (p % g.w_out) * g.sow;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = co0 + wn * 32 + ni * 8 + t4 * 2 + e;
          if (c < g.c_out) {
            store<T>(out, op + c * g.soc, acc[mi][ni][half * 2 + e],
                     xs * wscale[c], bias[c], g);
          }
        }
      }
    }
  }
}

// depthwise: wp (C, k*k) int8; a block row per (image, channel) plane
// (blockIdx.y), a thread per output pixel of it
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    conv_s8_dw_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp,
                      const float* __restrict__ wscale,
                      const float* __restrict__ bias,
                      const float* __restrict__ xscale, void* out, Geo g) {
  const int p = blockIdx.x * kDwThreads + threadIdx.x;
  if (p >= g.h_out * g.w_out) return;
  const float xs = *xscale;
  const int c = blockIdx.y % g.c_out, n = blockIdx.y / g.c_out;
  const int oy = p / g.w_out, ox = p % g.w_out;
  const T* xc = x + n * g.sxn + c * g.sxc;
  const int8_t* wc = wp + c * g.k * g.k;
  int acc = 0;
  for (int ky = 0; ky < g.k; ++ky) {
    const int iy = oy * g.stride - g.pad + ky;
    if (iy < 0 || iy >= g.h) continue;
    for (int kx = 0; kx < g.k; ++kx) {
      const int ix = ox * g.stride - g.pad + kx;
      if (ix < 0 || ix >= g.w) continue;
      acc += quantize(to_f<T>(xc[iy * g.sxh + ix * g.sxw]), xs) *
             static_cast<int>(wc[ky * g.k + kx]);
    }
  }
  store<T>(out, n * g.son + c * g.soc + oy * g.soh + ox * g.sow, acc,
           xs * wscale[c], bias[c], g);
}

template <typename T>
cudaError_t launch(const void* x, const void* wp, const float* wscale,
                   const float* bias, const float* xscale, void* out, int n,
                   const Geo& g, int depthwise, int co_pad,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* w8 = static_cast<const int8_t*>(wp);
  if (depthwise) {
    const dim3 grid((g.h_out * g.w_out + kDwThreads - 1) / kDwThreads,
                    n * g.c_out);
    conv_s8_dw_kernel<T><<<grid, kDwThreads, 0, stream>>>(
        xt, w8, wscale, bias, xscale, out, g);
  } else {
    const dim3 grid((g.h_out * g.w_out + kBM - 1) / kBM, co_pad / kBN, n);
    conv_s8_mma_kernel<T><<<grid, kThreads, 0, stream>>>(
        xt, w8, wscale, bias, xscale, out, g);
  }
  return cudaGetLastError();
}

}  // namespace

// x (n, c_in, h, w) through its strides, float32 (dtype 0) or bfloat16
// (1); wp the packed int8 weights (groups 1: (co_pad, k*k*ci_pad) with
// ci_pad a multiple of 32 and co_pad of 64, 16-byte aligned; depthwise:
// (c, k*k)); wscale, b (c_out,) float32; xscale one float32 on the
// device; out (n, c_out, h_out, w_out) through its strides, in x's dtype,
// or int32 sums with sums = 1.
extern "C" int ssyt_conv_s8(const void* x, const void* wp, const void* wscale,
                            const void* b, const void* xscale, void* out,
                            int n, int h, int wd, int c_in, int c_out,
                            int h_out, int w_out, long long sxn, long long sxc,
                            long long sxh, long long sxw, long long son,
                            long long soc, long long soh, long long sow, int k,
                            int stride, int pad, int depthwise, int ci_pad,
                            int co_pad, int act, int sums, int dtype,
                            void* stream) {
  if (k < 1 || stride < 1 || pad < 0 || n < 1 || n > 65535 || h < 1 ||
      wd < 1 || c_in < 1 || c_out < 1 || h_out < 1 || w_out < 1 ||
      (!depthwise && (ci_pad % kBK || ci_pad < c_in || co_pad % kBN ||
                      co_pad < c_out)) ||
      (depthwise && (c_in != c_out || n * c_out > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{h,   wd,  c_in, c_out, h_out, w_out, k,   stride, pad,
              ci_pad, act, sums, sxn, sxc, sxh,  sxw, son, soc,    soh,
              sow};
  const float* ws = static_cast<const float*>(wscale);
  const float* bb = static_cast<const float*>(b);
  const float* xs = static_cast<const float*>(xscale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(x, wp, ws, bb, xs, out, n, g,
                                         depthwise, co_pad, s)
                 : launch<float>(x, wp, ws, bb, xs, out, n, g, depthwise,
                                 co_pad, s);
  return static_cast<int>(err);
}
