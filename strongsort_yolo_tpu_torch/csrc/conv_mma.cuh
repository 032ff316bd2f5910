#pragma once

// K7, mma form (the kernel template, shared by conv_mma.cu and
// conv_mma_k3.cu): 'same' stride-1 conv (k = 1 or 3, groups 1) + float32 bias
// + optional SiLU on bfloat16 activations, on the tensor cores (wgmma),
// rounded once to bfloat16.
//
// Replaces tools/prof/conv_kernel.py:164 pallas_conv_act (body
// _conv_kernel: nine shifted products of the whole plane, float32 sums,
// the bias and SiLU on the float32 accumulator, one cast). It computes
// the same function as the taps form of conv_act.cu, which stays for
// float32: the tensor cores take float32 only as TF32.
//
// Bound: at the route's shapes (80x80 and 40x40 planes, C_in 16-192,
// C_out 16-128, S=8) the work is 9 * C_in * C_out bf16 multiply-adds per
// pixel on 2 * (C_in + C_out) bytes per pixel: below the H100's ~295
// operations per byte, so the bound is the bytes (x read once, y written
// once); the CUDA-core taps form was bound by its instruction count
// instead. Design, as an implicit GEMM with M = output pixels, N = C_out,
// K = k * k * C_in:
//
// - one block is one warpgroup (128 threads) and one 8x16 tile of output
//   pixels of one image: two 64-pixel M tiles (8 rows x 8 columns each)
//   side by side, for N output channels (N = 16, 32, 64, 80 or 128, the
//   smallest that holds C_out; larger C_out loops over N chunks in the
//   grid's y), so x is staged once for every output channel;
// - K runs in chunks of 16 input channels, staged four at a time for
//   k = 1 and one at a time for k = 3 (C_in zero-padded to a whole
//   number of such stages).
//   Per chunk the threads stage the input slab with its halo (zero
//   outside the image: the 'same' padding) in shared memory as
//   [ci/8][y][x][8 channels]: 8 neighbouring pixels x 8 channels are one
//   contiguous 128-byte core matrix, so the shifted window of every tap is
//   a no-swizzle K-major wgmma operand straight from the slab (start
//   address + 16 B per dx and one row pitch per dy; SBO = the row pitch,
//   LBO = the ci/8 plane), with no re-pack per tap;
// - the threads read x through its strides (NCHW for the route, NHWC for
//   the public conv_act) and write it channel-minor: a transpose that TMA
//   cannot do, and NHWC with C_in = 51 has a pixel stride TMA refuses;
// - the weights are packed once per conv by the wrapper into (chunks,
//   k*k, 2, N_pad, 8) bfloat16, wgmma's canonical no-swizzle K-major
//   layout for B, and each stage's part is copied with cp.async;
// - per chunk and tap one wgmma.mma_async m64nNk16 per M tile; the slab
//   and weights are double-buffered, the next stage's loads issued while
//   the current stage's wgmmas run; the registers are bounded so that
//   three or four blocks share an SM where the accumulators allow;
// - epilogue on the float32 accumulators: + float32 bias, SiLU as
//   y / (1 + exp(-y)) (the special-function unit's exp and division),
//   one rounding to bfloat16, staged in shared memory and stored along
//   the output's unit stride, 16 bytes at a time for NCHW;
// - no split-K and no atomics: two launches are bit-identical. The tensor
//   cores sum the sixteen products of a chunk in their own order, so the
//   result differs from the plain version's float32 conv by float32
//   rounding only, well inside one bf16 unit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;          // output tile rows
constexpr int kTW = 16;         // output tile columns: two 8x8 M tiles
constexpr int kMT = 2;          // M tiles per block
constexpr int kThreads = 128;   // one warpgroup

struct Geometry {
  int h, w, c_in, c_out;
  long long sxn, sxc, sxh, sxw;  // strides of x, in elements
  long long son, soc, soh, sow;  // strides of the output
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, no swizzle (layout type 0): start address,
// leading byte offset (between the two core matrices along K) and stride
// byte offset (between core matrices along M or N), all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// makes the threads' shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int R>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32, in registers) += A (64 x 16) * B (16 x N), both
// bfloat16 K-major in shared memory
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<80> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int K, int N>
struct Shape {
  static constexpr int R = K / 2;
  static constexpr int SH = kTH + 2 * R;              // slab rows
  static constexpr int SW = kTW + 2 * R;              // slab columns
  // 16-channel chunks per stage: four for k = 1, whose chunk is two
  // wgmmas (fewer exposed load latencies), one for k = 3 (its chunk's
  // weights are 9 taps). The packed weights hold a whole number of
  // stages, zero past C_in (conv_kernel.py::pack_mma), so no wgmma group
  // branches.
  static constexpr int CPS = K == 1 ? 4 : 1;
  static constexpr int kPlaneVec = SH * SW;           // 16-byte vectors
  static constexpr int kSlabVec = 2 * CPS * kPlaneVec;
  static constexpr int kChunkWVec = K * K * 2 * N;
  static constexpr int kWVec = CPS * kChunkWVec;
  static constexpr int kXPer = (kSlabVec + kThreads - 1) / kThreads;
  static constexpr int kSmemBytes = (2 * kSlabVec + 2 * kWVec) * 16;
  // blocks per SM the registers are held to: enough that the 400 tiles
  // of an S=8 80x80 plane run in one wave where the accumulators allow
  static constexpr int kMinBlocks = N <= 64 ? 4 : (N <= 80 ? 3 : 2);
};

constexpr int kPix = kTH * kTW;   // output pixels of a tile
constexpr int kPitch = kPix + 8;  // staged row: spreads channels over banks

// + bias, SiLU (ACT), one rounding to bf16, into a staged tile
// [channel][pixel] of PITCH pixels a channel; px_of(mt, row) is the staged
// pixel of row `row` of M tile mt. The accumulator layout of m64nNk16:
// thread (warp w, lane l) holds rows 16w + l/4 (+8) of its M tile and
// columns 8j + 2(l%4) (+1). SiLU is y / (1 + exp(-y)) with the
// special-function unit's exp and its approximate division: within a few
// float32 units of the IEEE forms, far inside the one bf16 rounding that
// follows (an IEEE reciprocal here made the epilogue of a 1x1 conv cost
// more than its products). ACT is a template constant so that the
// unrolled loop has no branch and its exponentials overlap.
template <int N, bool ACT, int MT, int PITCH, typename PixelOf>
__device__ __forceinline__ void stage_acc(const float (&acc)[MT][N / 2],
                                          const float* __restrict__ bias,
                                          int nc0, int c_out,
                                          __nv_bfloat16* ot, PixelOf px_of) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = px_of(mt, 16 * warp + 8 * half + lane / 4);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + e;
          float y = acc[mt][4 * j + 2 * half + e] +
                    (nc0 + c < c_out ? bias[nc0 + c] : 0.0f);
          if (ACT) y = __fdividef(y, 1.0f + __expf(-y));
          ot[c * PITCH + px] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

// the mma form's tile: M tile mt is the 8x8 pixels at column 8 mt of the
// 8x16 tile, its row r the tile pixel (r / 8, 8 mt + r % 8)
template <int N, bool ACT>
__device__ __forceinline__ void stage_tile(const float (&acc)[kMT][N / 2],
                                           const float* __restrict__ bias,
                                           int nc0, int c_out,
                                           __nv_bfloat16* ot) {
  stage_acc<N, ACT, kMT, kPitch>(
      acc, bias, nc0, c_out, ot,
      [](int mt, int row) { return (row / 8) * kTW + 8 * mt + row % 8; });
}

// vec: the output is NCHW with rows of 16-byte-aligned 8-pixel groups
// (pixel stride 1, the other strides and the width multiples of 8, base
// 16-byte aligned), so that each store moves 8 pixels of one channel
template <int K, int N>
__global__ void __launch_bounds__(kThreads, (Shape<K, N>::kMinBlocks))
    conv_mma_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ wp,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                    Geometry g, int tiles_x, int n_pad, int stages, int act,
                    int vec) {
  using S = Shape<K, N>;
  extern __shared__ __align__(128) uint4 smem[];
  uint4* const slab0 = smem;                       // 2 x [2 CPS][SH][SW] vectors
  uint4* const wsm0 = smem + 2 * S::kSlabVec;      // 2 x [CPS][k*k][2][N] vectors

  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int nc0 = blockIdx.y * N;
  const int tid = threadIdx.x;
  const uint16_t* xn = x + static_cast<long long>(blockIdx.z) * g.sxn;

  // one stage's slab, 8 channels of one pixel per vector, into registers
  uint4 xr[S::kXPer];
  auto load_x = [&](int stage) {
#pragma unroll
    for (int q = 0; q < S::kXPer; ++q) {
      const int v = tid + q * kThreads;
      uint32_t e[4] = {0u, 0u, 0u, 0u};
      if (v < S::kSlabVec) {
        const int plane = v / S::kPlaneVec, pix = v % S::kPlaneVec;
        const int yy = ty0 - S::R + pix / S::SW, xx = tx0 - S::R + pix % S::SW;
        const int c0 = stage * 16 * S::CPS + plane * 8;
        if (yy >= 0 && yy < g.h && xx >= 0 && xx < g.w && c0 < g.c_in) {
          const uint16_t* p = xn + yy * g.sxh + xx * g.sxw;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + j;
            const uint32_t bits = c < g.c_in ? __ldg(p + c * g.sxc) : 0u;
            e[j / 2] |= bits << (16 * (j % 2));
          }
        }
      }
      xr[q] = make_uint4(e[0], e[1], e[2], e[3]);
    }
  };
  auto store_x = [&](uint4* slab) {
#pragma unroll
    for (int q = 0; q < S::kXPer; ++q) {
      const int v = tid + q * kThreads;
      if (v < S::kSlabVec) slab[v] = xr[q];
    }
  };
  // one stage's weights of this block's N channels, [chunk][tap][plane][n][8]
  auto load_w = [&](int stage, uint4* dst) {
    for (int u = tid; u < S::kWVec; u += kThreads) {
      const int n = u % N, tp = u / N;
      cp_async16(dst + u, wp + (static_cast<long long>(stage) * S::kWVec / N + tp) *
                                   n_pad + nc0 + n);
    }
    cp_async_commit();
  };

  float acc[kMT][N / 2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.0f;

  load_w(0, wsm0);
  load_x(0);
  store_x(slab0);
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();

  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    const uint32_t a0 = smem_u32(slab0 + buf * S::kSlabVec);
    const uint32_t b0 = smem_u32(wsm0 + buf * S::kWVec);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_operands<N / 2>(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < S::CPS; ++q) {
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const int dy = tap / K, dx = tap % K;
        const uint64_t db = make_desc(
            b0 + (q * S::kChunkWVec + tap * 2 * N) * 16, N * 16, 128);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint64_t da = make_desc(
              a0 + (2 * q * S::kPlaneVec + dy * S::SW + 8 * mt + dx) * 16,
              S::kPlaneVec * 16, S::SW * 16);
          Mma<N>::run(acc[mt], da, db);
        }
      }
    }
    wgmma_commit();
    if (st + 1 < stages) {  // the next stage, into the other buffer
      load_w(st + 1, wsm0 + (buf ^ 1) * S::kWVec);
      load_x(st + 1);
      store_x(slab0 + (buf ^ 1) * S::kSlabVec);
      cp_async_wait_all();
      fence_async_shared();
    }
    wgmma_wait_all();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_operands<N / 2>(acc[mt]);
    __syncthreads();
  }

  // epilogue, staged in shared memory (the slab and weight buffers are
  // free after the loop's last barrier), then stored along the output's
  // unit stride: pixels for NCHW, channels for NHWC
  __nv_bfloat16* const ot = reinterpret_cast<__nv_bfloat16*>(smem);
  if (act) {
    stage_tile<N, true>(acc, bias, nc0, g.c_out, ot);
  } else {
    stage_tile<N, false>(acc, bias, nc0, g.c_out, ot);
  }
  __syncthreads();
  __nv_bfloat16* on = out + static_cast<long long>(blockIdx.z) * g.son;
  if (vec) {  // 8 pixels of one channel per 16-byte store
    for (int i = tid; i < N * kPix / 8; i += kThreads) {
      const int c = i / (kPix / 8), px = (i % (kPix / 8)) * 8;
      const int co = nc0 + c, oy = ty0 + px / kTW, ox = tx0 + px % kTW;
      if (co < g.c_out && oy < g.h && ox < g.w) {
        *reinterpret_cast<uint4*>(on + co * g.soc + oy * g.soh + ox) =
            *reinterpret_cast<const uint4*>(ot + c * kPitch + px);
      }
    }
  } else {
    const bool pixel_major = g.sow == 1;
    for (int i = tid; i < N * kPix; i += kThreads) {
      const int c = pixel_major ? i / kPix : i % N;
      const int px = pixel_major ? i % kPix : i / N;
      const int co = nc0 + c, oy = ty0 + px / kTW, ox = tx0 + px % kTW;
      if (co < g.c_out && oy < g.h && ox < g.w) {
        on[co * g.soc + oy * g.soh + ox * g.sow] = ot[c * kPitch + px];
      }
    }
  }
}

template <int K, int N>
cudaError_t launch(const void* x, const void* wp, const void* b, void* out,
                   int n, const Geometry& g, int n_pad, int chunks, int act,
                   int vec, cudaStream_t stream) {
  using S = Shape<K, N>;
  if (chunks % S::CPS != 0) return cudaErrorInvalidValue;
  auto kernel = conv_mma_kernel<K, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (g.w + kTW - 1) / kTW;
  const int tiles_y = (g.h + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, n_pad / N, n);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(wp),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), g,
      tiles_x, n_pad, chunks / S::CPS, act, vec);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(const void* x, const void* wp, const void* b, void* out,
                     int n, const Geometry& g, int n_tile, int n_pad,
                     int chunks, int act, int vec, cudaStream_t s) {
  switch (n_tile) {
    case 16: return launch<K, 16>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 32: return launch<K, 32>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 64: return launch<K, 64>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 80: return launch<K, 80>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 128: return launch<K, 128>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// the launches of one k, each in its own translation unit (conv_mma.cu:
// k = 1, conv_mma_k3.cu: k = 3) so that the build compiles them in
// parallel; strides: x's (n, c, h, w), then the output's, in elements
cudaError_t conv_mma_k1(const void* x, const void* wp, const void* b, void* out,
                        int n, int h, int wd, int c_in, int c_out,
                        const long long* strides, int n_tile, int n_pad,
                        int chunks, int act, int vec, cudaStream_t s);
cudaError_t conv_mma_k3(const void* x, const void* wp, const void* b, void* out,
                        int n, int h, int wd, int c_in, int c_out,
                        const long long* strides, int n_tile, int n_pad,
                        int chunks, int act, int vec, cudaStream_t s);
