// K7: 'same' stride-1 conv (k = 1 or 3, groups 1) + float32 bias +
// optional SiLU, rounded once to the input dtype.
//
// Replaces tools/prof/conv_kernel.py:164 pallas_conv_act (body
// _conv_kernel: nine shifted products of the whole plane with the border
// rows masked, accumulated in float32, the bias and SiLU on the float32
// accumulator, one cast) and tools/prof/_prof_conv2.py:145 call (its
// _kernel_im2col: one product over the gathered 9 * C_in row; _kernel_dy3
// is the same function grouped by rows). The two forms are the template
// parameter IM2COL: false is the taps form, which the route
// Pipeline(conv_kernel=True) runs; true is the im2col form.
//
// The TPU kernel holds whole planes in VMEM and rolls them row-wise for
// its matrix unit. Here one thread block computes one 16x16 tile of output
// pixels, one pixel per thread, for 16 output channels held in registers;
// the grid runs over (tiles, output-channel groups, images):
//
// - taps form: the input tile with its one-pixel halo (zero outside the
//   image) and the weights of 16 input channels x 16 output channels x k*k
//   taps are staged in shared memory, 16 input channels at a time; every
//   thread then walks the taps (dy outer, dx inner) and, inside each tap,
//   the staged input channels, reading its shifted neighbour from the
//   tile: the halo replaces the TPU kernel's masked rolls;
// - im2col form: each thread gathers 16 entries at a time of its pixel's
//   9 * C_in row (tap-major, channel-minor: the HWIO flattening of the
//   weights) into a (16, 256) tile in shared memory, zero where a tap
//   leaves the image, and the block multiplies that tile by the matching
//   16 weight rows;
// - sums are float32, in a fixed order per thread, without atomics, so
//   launches are bit-identical; the weights are rounded to the input dtype
//   T by the wrapper (the TPU kernel's w.astype(x.dtype)), the bias stays
//   float32 (its b2d); the epilogue y = acc + b, y * sigmoid(y) runs in
//   float32 and the output is rounded to T once.
//
// x and the output are addressed through their strides (n, c, h, w), so
// the model's NCHW activations and the public NHWC form are both read
// and written in place, with no transposing copy. C_out need not be a
// multiple of anything (51 and 80 occur): the last channel group is
// masked, and so is the last input-channel group and the ragged tiles.
//
// Bound: the shapes it takes (80x80 and 40x40 planes, C_in <= 192) do
// 9 * C_in * C_out multiply-adds per pixel on a few bytes per pixel; at
// the bf16 tensor-core rate most are bound by their bytes (x read once,
// y written once). This first kernel runs on the CUDA cores, one
// multiply-add instruction per product plus a broadcast shared-memory
// read of its weight, so it is bound by its instruction count, far above
// either bound. Tensor cores (wgmma), TMA staging and several images per
// block are left to a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                 // output tile side, pixels
constexpr int kThreads = kTile * kTile;   // one thread per output pixel
constexpr int kCo = 16;                   // output channels per block
constexpr int kCi = 16;                   // input channels per step (taps)
constexpr int kRows = 16;                 // row entries per step (im2col)

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

struct Geometry {
  int h, w, c_in, c_out;
  long long sxn, sxc, sxh, sxw;  // strides of x, in elements
  long long son, soc, soh, sow;  // strides of the output
};

// acc[j] += xv * w[j] for the kCo weights at wr, read as float4 broadcasts
__device__ __forceinline__ void axpy(float* acc, float xv, const float* wr) {
  const float4* w4 = reinterpret_cast<const float4*>(wr);
#pragma unroll
  for (int q = 0; q < kCo / 4; ++q) {
    const float4 v = w4[q];
    acc[4 * q + 0] = __fmaf_rn(xv, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = __fmaf_rn(xv, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = __fmaf_rn(xv, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = __fmaf_rn(xv, v.w, acc[4 * q + 3]);
  }
}

template <typename T, int K, bool IM2COL>
__global__ void __launch_bounds__(kThreads)
    conv_act_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                    const float* __restrict__ bias, T* __restrict__ out,
                    Geometry g, int tiles_x, int act) {
  constexpr int R = K / 2;
  constexpr int kSpan = kTile + 2 * R;  // input tile side with the halo
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int co0 = blockIdx.y * kCo;
  const T* xn = x + static_cast<long long>(blockIdx.z) * g.sxn;
  const int p = threadIdx.x;
  const int py = p / kTile, px = p % kTile;
  const int oy = ty0 + py, ox = tx0 + px;

  float acc[kCo];
#pragma unroll
  for (int j = 0; j < kCo; ++j) acc[j] = 0.f;

  if constexpr (!IM2COL) {
    __shared__ __align__(16) float xs[kCi * kSpan * kSpan];  // [ci][y][x]
    __shared__ __align__(16) float ws[K * K * kCi * kCo];    // [tap][ci][co]
    for (int ci0 = 0; ci0 < g.c_in; ci0 += kCi) {
      __syncthreads();  // the previous step's tiles are consumed
      for (int i = p; i < kCi * kSpan * kSpan; i += kThreads) {
        const int ci = ci0 + i / (kSpan * kSpan);
        const int r = i % (kSpan * kSpan);
        const int yy = ty0 - R + r / kSpan, xx = tx0 - R + r % kSpan;
        float v = 0.f;
        if (ci < g.c_in && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w) {
          v = to_f<T>(xn[ci * g.sxc + yy * g.sxh + xx * g.sxw]);
        }
        xs[i] = v;
      }
      for (int i = p; i < K * K * kCi * kCo; i += kThreads) {
        const int j = i % kCo, ci = ci0 + (i / kCo) % kCi;
        const int tap = i / (kCo * kCi);
        float v = 0.f;
        if (ci < g.c_in && co0 + j < g.c_out) {
          v = to_f<T>(wt[(static_cast<long long>(tap) * g.c_in + ci) * g.c_out +
                         co0 + j]);
        }
        ws[i] = v;
      }
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const float* xt = xs + (py + tap / K) * kSpan + px + tap % K;
#pragma unroll 4
        for (int ci = 0; ci < kCi; ++ci) {
          axpy(acc, xt[ci * kSpan * kSpan], ws + (tap * kCi + ci) * kCo);
        }
      }
    }
  } else {
    __shared__ __align__(16) float cs[kRows * kThreads];  // [row entry][pixel]
    __shared__ __align__(16) float ws[kRows * kCo];       // [row entry][co]
    const int rows = K * K * g.c_in;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        const int rr = r0 + r;
        float v = 0.f;
        if (rr < rows) {
          const int tap = rr / g.c_in, ci = rr % g.c_in;
          const int yy = oy + tap / K - R, xx = ox + tap % K - R;
          if (yy >= 0 && yy < g.h && xx >= 0 && xx < g.w) {
            v = to_f<T>(xn[ci * g.sxc + yy * g.sxh + xx * g.sxw]);
          }
        }
        cs[r * kThreads + p] = v;
      }
      for (int i = p; i < kRows * kCo; i += kThreads) {
        const int j = i % kCo, rr = r0 + i / kCo;
        ws[i] = (rr < rows && co0 + j < g.c_out)
                    ? to_f<T>(wt[static_cast<long long>(rr) * g.c_out + co0 + j])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        axpy(acc, cs[r * kThreads + p], ws + r * kCo);
      }
    }
  }

  if (oy < g.h && ox < g.w) {
    T* o = out + static_cast<long long>(blockIdx.z) * g.son + oy * g.soh +
           ox * g.sow;
#pragma unroll
    for (int j = 0; j < kCo; ++j) {
      if (co0 + j < g.c_out) {
        float y = acc[j] + bias[co0 + j];
        if (act) y = y * (1.0f / (1.0f + expf(-y)));
        o[(co0 + j) * g.soc] = from_f<T>(y);
      }
    }
  }
}

template <typename T, int K, bool IM2COL>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int n, const Geometry& g, int act, cudaStream_t stream) {
  const int tiles_x = (g.w + kTile - 1) / kTile;
  const int tiles_y = (g.h + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, (g.c_out + kCo - 1) / kCo, n);
  conv_act_kernel<T, K, IM2COL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(out), g, tiles_x, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* out,
                     int n, const Geometry& g, int k, int act, int form,
                     cudaStream_t stream) {
  if (k == 1) {
    return form ? launch<T, 1, true>(x, w, b, out, n, g, act, stream)
                : launch<T, 1, false>(x, w, b, out, n, g, act, stream);
  }
  return form ? launch<T, 3, true>(x, w, b, out, n, g, act, stream)
              : launch<T, 3, false>(x, w, b, out, n, g, act, stream);
}

}  // namespace

// x (n, c_in, h, w) and out (n, c_out, h, w) through the given strides, in
// float32 (dtype 0) or bfloat16 (1); w (k*k*c_in, c_out) row-major in the
// same dtype; b (c_out,) float32. k is 1 or 3; form 0 is taps, 1 im2col.
extern "C" int ssyt_conv_act(const void* x, const void* w, const void* b,
                             void* out, int n, int h, int wd, int c_in,
                             int c_out, long long sxn, long long sxc,
                             long long sxh, long long sxw, long long son,
                             long long soc, long long soh, long long sow,
                             int k, int act, int form, int dtype,
                             void* stream) {
  if ((k != 1 && k != 3) || n < 1 || n > 65535 || h < 1 || wd < 1 ||
      c_in < 1 || c_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{h, wd, c_in, c_out, sxn, sxc, sxh, sxw,
                   son, soc, soh, sow};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(x, w, b, out, n, g, k, act, form, s)
                 : dispatch<float>(x, w, b, out, n, g, k, act, form, s);
  return static_cast<int>(err);
}
