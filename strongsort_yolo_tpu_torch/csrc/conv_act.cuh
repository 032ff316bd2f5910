#pragma once

// K7, CUDA-core forms (the kernel template, shared by conv_act.cu, float32,
// and conv_act_bf16.cu): 'same' stride-1 conv (k = 1 or 3, groups 1) +
// float32 bias + optional SiLU, rounded once to the input dtype T.
//
// Replaces tools/prof/conv_kernel.py:164 pallas_conv_act (body
// _conv_kernel: nine shifted products of the whole plane with the border
// masked, float32 sums, the bias and SiLU on the float32 accumulator, one
// cast) in float32, where the route Pipeline(conv_kernel=True) runs this
// taps form: the tensor cores take float32 only as TF32, which would be
// another function. Its im2col form (IM2COL, float32 only) is
// tools/prof/_prof_conv2.py:145 call (_kernel_im2col: one product over
// the gathered 9 * C_in row) on the CUDA cores; in bfloat16 that form runs
// on the tensor cores (conv_im2col_mma.cu), and the taps form takes
// bfloat16 too, with float32 products.
//
// Bound: at the route's shapes (80x80 and 40x40 planes, C_in 16-192,
// C_out 16-128, S=8) a float32 conv does 9 * C_in * C_out multiply-adds
// per pixel on 4 * (C_in + C_out) bytes per pixel, far above the H100's
// ~20 float32 operations per byte (67 TFLOP/s over 3.35 TB/s): it is
// bound by the CUDA cores' multiply-add rate, so the design feeds them
// from registers. As an implicit GEMM with M = output pixels, N = C_out,
// K = k * k * C_in:
//
// - one block computes M = 128 output pixels for N output channels (N =
//   32, 64, 80 or 128, the smallest that holds C_out, else 128 and the
//   grid's y runs over N tiles): the taps form an 8x16 tile of one image,
//   the im2col form 128 consecutive pixels in (image, y, x) order, which
//   may cross rows and images as the TPU kernel's rows do. The input is
//   staged once for every output channel of the tile;
// - each thread holds an 8-pixel x 8-channel micro-tile, 64 float32
//   accumulators, fed by outer products: per (input channel, tap) it
//   reads 8 inputs and 8 weights from shared memory (float4 reads; the
//   taps form reads the 10 inputs of a row once for its 3 taps dx) and
//   does 64 multiply-adds. Its channels are nc0 + 4 tn + (0..3) and nc0 +
//   N/2 + 4 tn + (0..3), so a warp's weight reads cover consecutive words;
// - K runs in chunks (taps: 4 input channels x k*k taps for k = 3, 16
//   channels for k = 1; im2col: 16 entries of the row), each in one of
//   three shared-memory buffers: the input (taps: the channels' slab of
//   the tile with its halo; im2col: the gathered rows [entry][pixel]) and
//   the weights [tap][ci][co] (im2col: [entry][co]). Chunk c + 2 is copied
//   while chunk c is multiplied: cp.async with zero fill (float32 x, 4
//   bytes an element, through its strides, zero outside the image and past
//   C_in; the weights 16 bytes at a time where C_out % 4 == 0, else 4);
//   a bfloat16 slab is loaded and widened by the threads, whose wait for
//   their loads other warps' products cover. The taps slab is copied
//   position by position, each position's channels sxc apart, so a
//   copy costs a few instructions. One barrier per chunk;
// - the loops over K hold no integer division: the im2col gather walks
//   its pixel's row with a cursor (channel, tap, offset) advanced by
//   additions, and whether a tap lies inside the image is one bit of a
//   mask made once per pixel. The taps loop is not unrolled over k = 3's
//   channels (its 603 instructions a channel fit the instruction cache;
//   four channels unrolled did not and ran slower);
// - sums are float32 multiply-adds in a fixed order per output (taps:
//   input channel, then dy, then dx; im2col: the row's order), without
//   split-K or atomics, so two launches are bit-identical; the weights
//   come rounded to T by the wrapper (the TPU kernel's w.astype(x.dtype)),
//   as float32; the bias stays float32; the epilogue y = acc + b,
//   y / (1 + exp(-y)) runs in float32 (exp in full precision, the
//   division approximate: within 2 float32 units, without the IEEE
//   division's slow path) and rounds to T once, with 16-byte stores of 8
//   pixels of a channel where the output's rows allow.
//
// Bound in practice: a thread's 64 accumulators leave S=8 40x40 convs
// 200-800 warps for 528 schedulers, the 400 tiles of an 80x80 plane fill
// 132 SMs unevenly, and the products issue below the peak rate even
// where nothing is staged; the float32 route therefore runs well above
// its bound (PERF.md section 6).
//
// x and the output are addressed through their strides (n, c, h, w), so
// the model's NCHW activations and the public NHWC form are both read and
// written in place, with no transposing copy. C_out need not be a
// multiple of anything (51 and 80 occur): the last N tile is masked, and
// so is the last chunk past C_in and the ragged tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace k7cc {

constexpr int kTileH = 8;                 // taps: output tile rows
constexpr int kTileW = 16;                // taps: output tile columns
constexpr int kTileM = kTileH * kTileW;   // output pixels of a block
constexpr int kRing = 3;                  // chunk buffers in shared memory

// strides of x (the image's 64-bit, the others within one image: the
// entry point refuses an image that spans 2^31 elements or more)
struct Geo {
  int h, w, c_in, c_out;
  long long sxn, son;
  int sxc, sxh, sxw, soc, soh, sow;
};

// the largest element offset of a (c, h, w) image through its strides
inline long long span(int c, int h, int w, long long sc, long long sh,
                      long long sw) {
  return (c - 1) * sc + (h - 1) * sh + (w - 1) * sw;
}

// cp.async of 4 or 16 bytes; the bytes past src_bytes (0 or the size) are
// zero-filled without a read
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The walk along one pixel's im2col row (tap-major, channel-minor: the
// HWIO flattening of the weights): entry (tap, ci) reads x at the offset
// off = ci * sxc + (dy - R) * sxh + (dx - R) * sxw from the pixel. Every
// move is additions; a tap past k*k is the zero padding of the row.
template <int K>
struct Cursor {
  static constexpr int R = K / 2;
  int ci, tap, dx, off;

  __device__ __forceinline__ void init(const Geo& g) {
    ci = tap = dx = 0;
    off = -R * g.sxh - R * g.sxw;
  }
  __device__ __forceinline__ void next_tap(const Geo& g) {
    ++tap;
    off -= g.c_in * g.sxc;
    if (++dx == K) {
      dx = 0;
      off += g.sxh - (K - 1) * g.sxw;
    } else {
      off += g.sxw;
    }
  }
  __device__ __forceinline__ void step(const Geo& g) {
    off += g.sxc;
    if (++ci == g.c_in) {
      ci = 0;
      next_tap(g);
    }
  }
  __device__ __forceinline__ void advance(int n, const Geo& g) {
    ci += n;
    off += n * g.sxc;
    while (ci >= g.c_in) {
      ci -= g.c_in;
      next_tap(g);
    }
  }
  __device__ __forceinline__ bool inside(uint32_t mask) const {
    return tap < K * K && ((mask >> tap) & 1u);
  }
};

// bit dy * K + dx is set where tap (dy, dx) of pixel (y, x) is inside the
// image
template <int K>
__device__ __forceinline__ uint32_t tap_mask(int y, int x, const Geo& g) {
  constexpr int R = K / 2;
  uint32_t m = 0;
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int yy = y + dy - R, xx = x + dx - R;
      if (yy >= 0 && yy < g.h && xx >= 0 && xx < g.w) m |= 1u << (dy * K + dx);
    }
  return m;
}

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

template <typename T, int K, int N, bool IM2COL>
struct Cfg {
  static constexpr int R = K / 2;
  static constexpr int TN = N / 8;            // thread columns (channels)
  static constexpr int kThreads = kTileM / 8 * TN;  // groups of 8 pixels
  // K per chunk: taps, input channels (x k*k taps); im2col, row entries
  static constexpr int CK =
      IM2COL ? 16 : (K == 3 ? 4 : (sizeof(T) == 4 ? 16 : 8));
  static constexpr int kWRows = IM2COL ? CK : K * K * CK;
  static constexpr int SH = kTileH + 2 * R;   // taps slab rows
  static constexpr int SW = kTileW + 2 * R;   // taps slab columns
  static constexpr int kPitch = (SW + 3) / 4 * 4;
  static constexpr int kPlane = SH * kPitch;
  static constexpr int kXFloats = IM2COL ? CK * kTileM : CK * kPlane;
  static constexpr int kStage = kXFloats + kWRows * N;
  static constexpr int kSmemBytes = kRing * kStage * 4;
  // gathering threads of the im2col form and the pixels each walks
  static constexpr int kGather = kThreads < kTileM ? kThreads : kTileM;
  static constexpr int kPixPer = kTileM / kGather;
  // blocks an SM holds by the registers: at most 128 registers a thread
  // in float32 (64 accumulators, the operands of a tap row and the
  // staging's addresses), 255 in bfloat16, whose slab the threads load
  // and widen themselves
  static constexpr int kRegs = sizeof(T) == 4 ? 512 : 256;
  static constexpr int kMinBlocks = kThreads >= kRegs ? 1 : kRegs / kThreads;
};

template <typename T, int K, int N, bool IM2COL>
__global__ void __launch_bounds__((Cfg<T, K, N, IM2COL>::kThreads),
                                  (Cfg<T, K, N, IM2COL>::kMinBlocks))
    conv_act_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                    const float* __restrict__ bias, T* __restrict__ out,
                    Geo g, int tiles_x, int n_pix, int chunks, int act,
                    int wvec, int ovec) {
  using C = Cfg<T, K, N, IM2COL>;
  static_assert(!IM2COL || sizeof(T) == 4, "im2col on CUDA cores: float32");
  static_assert(kTileM % C::kGather == 0, "gathering threads cover the tile");
  constexpr int R = C::R;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tn = tid % C::TN, tm = tid / C::TN;
  const int nc0 = blockIdx.y * N;

  // taps: the tile's origin and image; im2col: its first flattened pixel
  const int ty0 = IM2COL ? 0 : (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = IM2COL ? 0 : (blockIdx.x % tiles_x) * kTileW;
  const T* xn = x + (IM2COL ? 0 : static_cast<long long>(blockIdx.z) * g.sxn);
  const int p0 = IM2COL ? blockIdx.x * kTileM : 0;

  // the weights of chunk c: rows (tap, ci) of the (k*k*C_in, C_out) matrix
  // (im2col: rows c*CK ..), this block's N channels
  auto stage_w = [&](int c, float* ws) {
    constexpr int kVec = C::kWRows * N / 4;
    for (int u = tid; u < kVec; u += C::kThreads) {
      const int row = u / (N / 4), q = u % (N / 4);
      int grow;
      bool ok;
      if (IM2COL) {
        grow = c * C::CK + row;
        ok = grow < K * K * g.c_in;
      } else {
        const int tap = row / C::CK, ci = c * C::CK + row % C::CK;
        grow = tap * g.c_in + ci;
        ok = ci < g.c_in;
      }
      const int co = nc0 + 4 * q;
      float* dst = ws + row * N + 4 * q;
      const float* src = wt + static_cast<long long>(grow) * g.c_out + co;
      if (wvec) {
        const bool in = ok && co < g.c_out;
        cp_async16z(dst, in ? src : wt, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = ok && co + e < g.c_out;
          cp_async4(dst + e, in ? src + e : wt, in ? 4 : 0);
        }
      }
    }
  };

  // im2col: the gathering threads' pixels and their tap masks; the
  // cursor is the same for every pixel (the chunks are issued in order)
  uint32_t mask[C::kPixPer];
  const T* xp[C::kPixPer];
  Cursor<K> cur;
  if constexpr (IM2COL) {
    cur.init(g);
#pragma unroll
    for (int j = 0; j < C::kPixPer; ++j) {
      const int pp = p0 + tid + j * C::kGather;
      mask[j] = 0u;
      xp[j] = x;
      if (tid < C::kGather && pp < n_pix) {
        const int hw = g.h * g.w;
        const int n = pp / hw, r = pp - n * hw;
        const int y = r / g.w, xx = r - y * g.w;
        mask[j] = tap_mask<K>(y, xx, g);
        xp[j] = x + n * g.sxn + y * g.sxh + xx * g.sxw;
      }
    }
  }

  // the input of chunk c. taps: each thread takes slab positions (yy, xx)
  // and copies them for every channel of the chunk, each channel sxc
  // further on (float32: cp.async with zero fill; bfloat16: loaded and
  // widened by the thread, whose wait for its loads other warps' products
  // cover); im2col: the gathering threads walk their pixels' rows
  auto stage_x = [&](int c, float* xs) {
    if constexpr (IM2COL) {
#pragma unroll 4
      for (int r = 0; r < C::CK; ++r) {
        if (tid < C::kGather) {
#pragma unroll
          for (int j = 0; j < C::kPixPer; ++j) {
            const bool in = cur.inside(mask[j]);
            cp_async4(xs + r * kTileM + tid + j * C::kGather,
                      in ? xp[j] + cur.off : x, in ? 4 : 0);
          }
        }
        cur.step(g);
      }
    } else {
      const int left = g.c_in - c * C::CK;  // channels of the chunk in C_in
      for (int pos = tid; pos < C::SH * C::SW; pos += C::kThreads) {
        const int yy = pos / C::SW, xx = pos % C::SW;
        const int gy = ty0 - R + yy, gx = tx0 - R + xx;
        const bool in = gy >= 0 && gy < g.h && gx >= 0 && gx < g.w;
        const T* src = xn + c * C::CK * g.sxc + gy * g.sxh + gx * g.sxw;
        float* dst = xs + yy * C::kPitch + xx;
#pragma unroll
        for (int cl = 0; cl < C::CK; ++cl) {
          const bool ok = in && cl < left;
          if constexpr (sizeof(T) == 4) {
            cp_async4(dst + cl * C::kPlane, ok ? src + cl * g.sxc : x, ok ? 4 : 0);
          } else {
            dst[cl * C::kPlane] = ok ? to_f<T>(src[cl * g.sxc]) : 0.0f;
          }
        }
      }
    }
  };

  auto issue = [&](int c) {
    if (c < chunks) {
      float* st = smem + (c % kRing) * C::kStage;
      stage_w(c, st + C::kXFloats);
      stage_x(c, st);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  issue(0);
  issue(1);

  const int tr = tm / 2, pc = 8 * (tm % 2);  // taps: the micro-tile's row
  constexpr int kUnrollCl = K == 3 ? 1 : 4;  // instructions to the i-cache
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_group<1>();
    __syncthreads();  // chunk c everywhere; chunk c - 1's buffer is free
    issue(c + 2);
    const float* xs = smem + (c % kRing) * C::kStage;
    const float* ws = xs + C::kXFloats + 4 * tn;
    if constexpr (IM2COL) {
#pragma unroll
      for (int r = 0; r < C::CK; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(xs + r * kTileM + 8 * tm);
        const float4 a1 = *reinterpret_cast<const float4*>(xs + r * kTileM + 8 * tm + 4);
        const float4 w0 = *reinterpret_cast<const float4*>(ws + r * N);
        const float4 w1 = *reinterpret_cast<const float4*>(ws + r * N + N / 2);
        const float xv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(xv[i], wv[j], acc[i][j]);
      }
    } else {
#pragma unroll(kUnrollCl)
      for (int cl = 0; cl < C::CK; ++cl) {
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          const float* xrow = xs + cl * C::kPlane + (tr + dy) * C::kPitch + pc;
          float xv[8 + 2 * R];
          const float4 a0 = *reinterpret_cast<const float4*>(xrow);
          const float4 a1 = *reinterpret_cast<const float4*>(xrow + 4);
          xv[0] = a0.x; xv[1] = a0.y; xv[2] = a0.z; xv[3] = a0.w;
          xv[4] = a1.x; xv[5] = a1.y; xv[6] = a1.z; xv[7] = a1.w;
          if constexpr (R == 1) {
            const float2 a2 = *reinterpret_cast<const float2*>(xrow + 8);
            xv[8] = a2.x;
            xv[9] = a2.y;
          }
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const float* wr = ws + ((dy * K + dx) * C::CK + cl) * N;
            const float4 w0 = *reinterpret_cast<const float4*>(wr);
            const float4 w1 = *reinterpret_cast<const float4*>(wr + N / 2);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = __fmaf_rn(xv[i + dx], wv[j], acc[i][j]);
          }
        }
      }
    }
  }

  // epilogue: + bias, SiLU, one rounding to T, stored per channel along
  // the pixels (8 at a time where the output's rows allow), each value
  // made where it is stored
  const int cb = nc0 + 4 * tn;  // channel j is cb + j, or cb + N/2 + j - 4
  auto finish = [&](float a, float bj) {
    float v = a + bj;
    if (act) v = __fdividef(v, 1.0f + expf(-v));
    return from_f<T>(v);
  };
  // the micro-tile's first pixel (image n, row oy, column ox) and whether
  // its 8 pixels are one run of a row
  int n, oy, ox;
  bool run;
  if constexpr (IM2COL) {
    const int pp = p0 + 8 * tm;
    const int hw = g.h * g.w;
    n = pp / hw;
    oy = (pp - n * hw) / g.w;
    ox = pp - n * hw - oy * g.w;
    run = pp + 8 <= n_pix && ox + 8 <= g.w;
  } else {
    n = blockIdx.z;
    oy = ty0 + tr;
    ox = tx0 + pc;
    run = oy < g.h && ox + 8 <= g.w;
  }
  if (ovec && run) {
    T* o = out + n * g.son + oy * g.soh + ox;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = cb + (j < 4 ? j : N / 2 + j - 4);
      if (co >= g.c_out) continue;
      const float bj = bias[co];
      T* oc = o + co * g.soc;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(oc) =
            make_float4(finish(acc[0][j], bj), finish(acc[1][j], bj),
                        finish(acc[2][j], bj), finish(acc[3][j], bj));
        *reinterpret_cast<float4*>(oc + 4) =
            make_float4(finish(acc[4][j], bj), finish(acc[5][j], bj),
                        finish(acc[6][j], bj), finish(acc[7][j], bj));
      } else {
        uint32_t u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = static_cast<uint32_t>(
                     __bfloat16_as_ushort(finish(acc[2 * q][j], bj))) |
                 (static_cast<uint32_t>(
                      __bfloat16_as_ushort(finish(acc[2 * q + 1][j], bj)))
                  << 16);
        }
        *reinterpret_cast<uint4*>(oc) = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (IM2COL ? p0 + 8 * tm + i < n_pix : (oy < g.h && ox < g.w)) {
        T* o = out + n * g.son + oy * g.soh + ox * g.sow;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = cb + (j < 4 ? j : N / 2 + j - 4);
          if (co < g.c_out) o[co * g.soc] = finish(acc[i][j], bias[co]);
        }
      }
      if constexpr (IM2COL) {  // the next pixel of the run
        if (++ox == g.w) {
          ox = 0;
          if (++oy == g.h) {
            oy = 0;
            ++n;
          }
        }
      } else {
        ++ox;
      }
    }
  }
}

template <typename T, int K, int N, bool IM2COL>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int n, const Geo& g, int act, int wvec, int ovec,
                   cudaStream_t stream) {
  using C = Cfg<T, K, N, IM2COL>;
  auto kernel = conv_act_kernel<T, K, N, IM2COL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_pix = n * g.h * g.w;
  const int tiles_x = (g.w + kTileW - 1) / kTileW;
  const int tiles_y = (g.h + kTileH - 1) / kTileH;
  const int n_tiles = (g.c_out + N - 1) / N;
  const int chunks = IM2COL ? (K * K * g.c_in + C::CK - 1) / C::CK
                            : (g.c_in + C::CK - 1) / C::CK;
  const dim3 grid = IM2COL ? dim3((n_pix + kTileM - 1) / kTileM, n_tiles, 1)
                           : dim3(tiles_x * tiles_y, n_tiles, n);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(out), g, tiles_x, n_pix,
      chunks, act, wvec, ovec);
  return cudaGetLastError();
}

template <typename T, bool IM2COL>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* out,
                     int n, const Geo& g, int k, int n_tile, int act,
                     int wvec, int ovec, cudaStream_t s) {
#define K7CC_N(KK)                                                          \
  switch (n_tile) {                                                         \
    case 32: return launch<T, KK, 32, IM2COL>(x, w, b, out, n, g, act, wvec, ovec, s);   \
    case 64: return launch<T, KK, 64, IM2COL>(x, w, b, out, n, g, act, wvec, ovec, s);   \
    case 80: return launch<T, KK, 80, IM2COL>(x, w, b, out, n, g, act, wvec, ovec, s);   \
    case 128: return launch<T, KK, 128, IM2COL>(x, w, b, out, n, g, act, wvec, ovec, s); \
    default: return cudaErrorInvalidValue;                                  \
  }
  if (k == 1) {
    K7CC_N(1)
  }
  K7CC_N(3)
#undef K7CC_N
}

}  // namespace k7cc

// the bfloat16 taps instances, in their own translation unit
// (conv_act_bf16.cu) so that the build compiles them in parallel
cudaError_t conv_act_taps_bf16(const void* x, const void* w, const void* b,
                               void* out, int n, const k7cc::Geo& g, int k,
                               int n_tile, int act, int wvec, int ovec,
                               cudaStream_t s);
