// K8: the int8 conv of post-training quantization: quantize the input,
// int8 x int8 products summed exactly in int32, then
// y = fma(sum, xscale * wscale[c], b[c]), SiLU if act, one cast to the
// input dtype. One call per conv: for groups 1 a quantize pass, then
// the implicit GEMM; for a depthwise conv one launch that quantizes its
// own tile.
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
// Bound: the larger of the bytes (x read once, the weights once, the
// output written once) over 3.35 TB/s and 2 x MACs over 1,979 TOPS. At
// yolov8n's shapes (S=8, 640) every conv is bound by its bytes: a few
// bytes per MAC against the ~600 int8 operations per byte the card needs
// before its tensor cores are the limit. What the card measured
// (tools/prof_s8.py) is latency: each launch has a few microseconds that
// the small planes cannot hide, and a block's loop over the K chunks is
// a chain of short steps with few warps to hide them. So the design
// quantizes once, keeps a chunk's step short, and fills the card:
//
// 1. conv_s8_quant_kernel quantizes each element of x once per conv. It
//    reads x through its (n, c, h, w) strides (NCHW, C2f's channel
//    slices, float32 or bfloat16), a thread per pixel and 16 channels:
//    the 16 loads, coalesced along the pixels, all in flight before the
//    divisions. It writes the codes channel-minor, (N, H, W, C_pitch)
//    with C_pitch = C_in padded with zero codes to 32, one K chunk, 16
//    bytes a store. The codes are half of bf16's bytes and fit the 50 MB
//    L2 at every yolov8n plane (the largest, 192 x 80 x 80 at S=8, is 9.8
//    MB), so the conv's re-reads of a tap's rows come from L2.
//    (Chunk-major codes, (N, C_pitch / 32, H, W, 32) with a thread per 32
//    channels, gave whole-sector gathers but a slower pass and no faster
//    conv.)
// 2. conv_s8_gemm_kernel (groups 1) is an implicit GEMM on the codes:
//    M = the flattened (n, oy, ox) output pixels, so a tile of 64 spans
//    images and a 20 x 20 plane leaves no rows idle; N = C_out in tiles
//    of BN = 32 or 64 (quant_kernel.n_tile); K = (tap, ci) in chunks
//    of 32 codes. One warpgroup per 64 x BN tile. Per chunk, each thread
//    gathers 16 codes of its pixel's tap with one cp.async,
//    zero-filled (src-size 0) outside the image, which covers
//    padding and any stride; the packed weights (pack_s8: [chunk][half]
//    [C_out to 64][16 codes]) come as contiguous 16-byte pieces. A
//    cursor walks the chunks by additions, with no division per chunk
//    (the first form's divisions cost more than its loads). Both tiles
//    land in wgmma's no-swizzle K-major layout (8 rows x 16 bytes a core
//    matrix; LBO the K half, SBO 128), so no tile is re-packed. A ring of
//    kStages stages of kCPS chunks in dynamic shared memory keeps
//    kStages - 2 stages of loads in flight while the tensor cores run
//    wgmma.mma_async.m64nBNk32.s32.s8.s8 on the current one, one wgmma
//    group in flight behind it; the first wgmma does not accumulate, so
//    no other instruction defines the accumulators. Tried on the card
//    and dropped (PERF.md §6):
//    a producer warpgroup feeding a consumer through mbarriers, deeper
//    or wider stages, no proxy fence (none was faster), programmatic
//    dependent launch after the quantize pass (slower, or barely faster
//    triggered at the end of its blocks: not worth a second launch
//    path), N tiles of 128 (slower than 64 on all but one conv),
//    chunk-major codes (whole sectors per gather, but a slower quantize
//    pass); in the quantize pass, 16-byte reads of x (fewer threads:
//    slower) and quotients by the rounded reciprocal with a division
//    fallback (no faster: the pass is not bound by its divisions).
//    Split-K is not taken: it would cost an atomic pass and a second
//    launch.
// 3. The epilogue computes on the int32 accumulators as the function
//    above says, stages the tile [channel][pixel] in shared memory (the
//    ring is free by then) and stores along the output's unit stride,
//    16 bytes (8 bf16 or 4 float32 / int32 pixels) a store where a
//    plane's pixel count allows.
// 4. conv_s8_dw_kernel (depthwise, groups = C_in = C_out) is one launch
//    that quantizes its own tile: no codes buffer, no quantize pass. A
//    block takes (image, a group of cg channels, a band of bh output
//    rows) (quant_kernel.dw_plan picks cg and bh so that the grid fills
//    the card); it reads the band's input rows and their halo straight
//    from x through its strides, coalesced along w, several loads of a
//    thread in flight before their divisions, and quantizes each element
//    into shared memory with the quantize pass's arithmetic (the same
//    quantize(): __fdiv_rn by *xscale, rint, clip to +-127), zero codes
//    in the padding. Then a thread sums the k*k int8 products of one
//    channel at 16 bytes' worth of consecutive output pixels (8 bf16, or
//    4 float32 / int32) in int32, applies the epilogue and stores them
//    as one 16-byte store where the plane allows, else one value at a
//    time; k = 3 and 5 are compiled with the taps in registers and the
//    loops unrolled, any other k reads them from shared memory. The
//    epilogue's per-channel constants are staged in shared memory while
//    the tile's loads are in flight. The conv is bound by launch latency, not by its bytes (at
//    yolo11n-pose's pe conv: 0.5 us of bytes in a launch of several), so
//    one launch with one round of loads, and no codes buffer read back
//    channel-minor (a byte per 32-byte sector), is the design.
// Two launches are bit-identical: no atomics, and every sum is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBM = 64;         // output pixels per block: one wgmma M tile
constexpr int kBK = 32;         // codes per K chunk: one wgmma's depth
constexpr int kCPS = 2;         // K chunks per pipeline stage
constexpr int kStages = 6;      // stages in the ring; kStages - 2 in flight
constexpr int kThreads = 128;   // one warpgroup
constexpr int kGemmBlocks = 4;  // conv blocks an SM holds (registers)
constexpr int kQThreads = 128;  // quantize pass: pixels per block
constexpr int kDwThreads = 256;  // depthwise: threads per block
constexpr int kDwBatch = 8;      // depthwise: loads of a thread in flight
constexpr int kDwSmem = 48 * 1024;  // depthwise: a block's shared memory
constexpr int kCoAlign = 64;    // packed weight rows: C_out padded to this

struct Geo {
  int n, h, w, c_in, c_out, h_out, w_out, k, stride, pad;
  int c_pitch;  // codes per pixel: C_in padded to 32
  int co_pad;   // packed weight rows per (chunk, half)
  int act, sums, vec;
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

__device__ __forceinline__ int quantize(float v, float xs) {
  const float q = rintf(__fdiv_rn(v, xs));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// the epilogue of one sum: dequantize, bias, SiLU, one cast (or the sum)
template <typename O>
__device__ __forceinline__ O epilogue(int acc, float s, float b, int act);

template <>
__device__ __forceinline__ int epilogue<int>(int acc, float, float, int) {
  return acc;
}

template <>
__device__ __forceinline__ float epilogue<float>(int acc, float s, float b,
                                                 int act) {
  float y = fmaf(static_cast<float>(acc), s, b);
  if (act) y = y * (1.0f / (1.0f + expf(-y)));
  return y;
}

template <>
__device__ __forceinline__ __nv_bfloat16 epilogue<__nv_bfloat16>(int acc,
                                                                 float s,
                                                                 float b,
                                                                 int act) {
  return __float2bfloat16_rn(epilogue<float>(acc, s, b, act));
}

// -- the quantize pass ---------------------------------------------------

// a thread per (pixel, 16 channels): blockIdx.x * kQThreads + threadIdx.x
// is the flattened (n, y, x), blockIdx.y the group of 16 channels
template <typename T>
__global__ void __launch_bounds__(kQThreads)
    conv_s8_quant_kernel(const T* __restrict__ x,
                         const float* __restrict__ xscale,
                         int8_t* __restrict__ codes, Geo g) {
  const int hw = g.h * g.w;
  const int p = blockIdx.x * kQThreads + threadIdx.x;
  if (p >= g.n * hw) return;
  const int n = p / hw, pix = p % hw;
  const int c0 = blockIdx.y * 16;
  const T* src = x + n * g.sxn + (pix / g.w) * g.sxh + (pix % g.w) * g.sxw +
                 c0 * g.sxc;
  // the 16 loads first, all in flight at once, then the divisions
  float v[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    v[c] = c0 + c < g.c_in ? to_f<T>(src[c * g.sxc]) : 0.0f;
  }
  const float xs = *xscale;
  uint32_t word[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    word[j] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = quantize(v[4 * j + e], xs);
      word[j] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * e);
    }
  }
  *reinterpret_cast<uint4*>(codes + static_cast<long long>(p) * g.c_pitch +
                            c0) = make_uint4(word[0], word[1], word[2], word[3]);
}

// -- the implicit GEMM on the tensor cores --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, no swizzle (layout type 0): start address,
// leading byte offset (between the two core matrices along K) and stride
// byte offset (between core matrices along M or N), in 16-byte units
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// makes the landed cp.async writes visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes, or 16 zeros where bytes = 0 (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int R>
__device__ __forceinline__ void fence_operands(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, int32, in registers) = A (64 x 32) * B (32 x N) (+ D where
// accumulate), both int8 K-major in shared memory
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <int BN>
struct Tile {
  static constexpr int kA = kBM * kBK;  // bytes of a chunk's A tile
  static constexpr int kB = BN * kBK;   // bytes of a chunk's B tile
  static constexpr int kStage = kCPS * (kA + kB);
  static constexpr int kRing = kStages * kStage;
  // the epilogue's staged tile: a row of 64 pixels per channel, padded
  // by 16 bytes (rows stay 16-byte aligned, channels 2 apart 8 banks)
  template <typename O>
  __host__ __device__ static constexpr int pitch() {
    return kBM + 16 / static_cast<int>(sizeof(O));
  }
  template <typename O>
  __host__ __device__ static constexpr int smem_bytes() {
    return kRing > BN * pitch<O>() * static_cast<int>(sizeof(O))
               ? kRing
               : BN * pitch<O>() * static_cast<int>(sizeof(O));
  }
};

// codes (N, H, W, c_pitch) int8; wp (chunks, 2, co_pad, 16) int8, the
// chunks over (ky, kx, ci / 32); out (N, C_out, H_out, W_out) of O
// through its strides. Block (blockIdx.x, blockIdx.y): output pixels
// 64 bx .. + 64 of the flattened (n, oy, ox), channels BN by .. + BN.
template <int BN, typename O>
__global__ void __launch_bounds__(kThreads, kGemmBlocks)
    conv_s8_gemm_kernel(const int8_t* __restrict__ codes,
                        const int8_t* __restrict__ wp,
                        const float* __restrict__ wscale,
                        const float* __restrict__ bias,
                        const float* __restrict__ xscale, O* __restrict__ out,
                        Geo g) {
  using S = Tile<BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int hw_out = g.h_out * g.w_out;
  const int m_total = g.n * hw_out;
  const int m0 = blockIdx.x * kBM, nc0 = blockIdx.y * BN;

  // this thread's A row (output pixel) and K half of each chunk
  const int arow = tid % kBM, ahalf = tid / kBM;
  const int am = m0 + arow;
  const bool a_ok = am < m_total;
  int iy0 = 0, ix0 = 0;
  const int8_t* img = codes;
  if (a_ok) {
    const int n = am / hw_out, pix = am % hw_out;
    iy0 = (pix / g.w_out) * g.stride - g.pad;
    ix0 = (pix % g.w_out) * g.stride - g.pad;
    img = codes + static_cast<long long>(n) * g.h * g.w * g.c_pitch +
          ahalf * 16;
  }
  const int nk = g.k * g.k * (g.c_pitch / kBK);  // chunks
  const int nst = (nk + kCPS - 1) / kCPS;
  // this thread's pieces of each chunk's B tile: piece u = half * BN + row
  constexpr int kBPer = (2 * BN + kThreads - 1) / kThreads;
  long long boff[kBPer];
#pragma unroll
  for (int i = 0; i < kBPer; ++i) {
    const int u = tid + i * kThreads;
    boff[i] = (static_cast<long long>(u / BN) * g.co_pad + nc0 + u % BN) * 16;
  }

  // the chunks are loaded in order: a cursor at the next one, (ky, kx,
  // ci0) and its weights, advanced by additions (no division per chunk)
  int ky = 0, kx = 0, ci0 = 0;
  const int8_t* wc = wp;
  const long long wstep = 2ll * g.co_pad * 16;
  // stage st's chunks into its ring slot; one cp.async group always
  auto load = [&](int st) {
    uint8_t* sa = smem + (st % kStages) * S::kStage;
    uint8_t* sb = sa + kCPS * S::kA;
#pragma unroll
    for (int q = 0; q < kCPS; ++q) {
      if (st * kCPS + q < nk) {
        const int iy = iy0 + ky, ix = ix0 + kx;
        const bool in = a_ok && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
        const int8_t* src =
            in ? img + (iy * g.w + ix) * g.c_pitch + ci0 : codes;
        cp_async16(sa + q * S::kA + ahalf * (kBM * 16) + arow * 16, src,
                   in ? 16 : 0);
#pragma unroll
        for (int i = 0; i < kBPer; ++i) {
          if (2 * BN % kThreads == 0 || tid + i * kThreads < 2 * BN) {
            cp_async16(sb + q * S::kB + (tid + i * kThreads) * 16,
                       wc + boff[i], 16);
          }
        }
        wc += wstep;
        ci0 += kBK;
        if (ci0 == g.c_pitch) {
          ci0 = 0;
          if (++kx == g.k) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
    cp_async_commit();
  };

  // written first by a wgmma that does not accumulate: no other
  // instruction defines them inside the pipeline, so ptxas keeps the
  // wgmmas asynchronous
  int acc[BN / 2];

#pragma unroll
  for (int st = 0; st < kStages - 2; ++st) load(st);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 3>();  // this thread's pieces of stage st
    fence_async_shared();
    wgmma_wait<1>();  // stage st - 2's products: its slot is free
    __syncthreads();
    load(st + kStages - 2);
    const uint32_t a0 = smem_u32(smem + (st % kStages) * S::kStage);
    const uint32_t b0 = a0 + kCPS * S::kA;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kCPS; ++q) {
      if (st * kCPS + q < nk) {
        Mma<BN>::run(acc, make_desc(a0 + q * S::kA, kBM * 16, 128),
                     make_desc(b0 + q * S::kB, BN * 16, 128), st + q > 0);
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands<BN / 2>(acc);
  cp_async_wait<0>();
  __syncthreads();  // every product and load done: the ring is free

  // the accumulator layout of m64nNk32: thread (warp w, lane l) holds
  // rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1)
  constexpr int kPitch = S::template pitch<O>();
  O* const ot = reinterpret_cast<O*>(smem);
  const int warp = tid / 32, lane = tid % 32;
  const float xs = *xscale;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * (lane % 4) + e, co = nc0 + c;
      float s = 0.0f, bb = 0.0f;
      if (co < g.c_out) {
        s = xs * wscale[co];
        bb = bias[co];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + lane / 4 + 8 * half;
        ot[c * kPitch + r] = epilogue<O>(acc[4 * j + 2 * half + e], s, bb, g.act);
      }
    }
  }
  __syncthreads();
  if (g.vec) {  // 16 bytes of one channel's consecutive pixels per store
    constexpr int kG = 16 / sizeof(O);
    for (int i = tid; i < BN * kBM / kG; i += kThreads) {
      const int c = i / (kBM / kG), p = (i % (kBM / kG)) * kG;
      const int co = nc0 + c, m = m0 + p;
      if (co < g.c_out && m < m_total) {
        const int n = m / hw_out, pix = m % hw_out;
        *reinterpret_cast<uint4*>(out + n * g.son + co * g.soc + pix) =
            *reinterpret_cast<const uint4*>(ot + c * kPitch + p);
      }
    }
  } else {
    for (int i = tid; i < BN * kBM; i += kThreads) {
      const int c = i / kBM, p = i % kBM;
      const int co = nc0 + c, m = m0 + p;
      if (co < g.c_out && m < m_total) {
        const int n = m / hw_out, pix = m % hw_out;
        out[n * g.son + co * g.soc + (pix / g.w_out) * g.soh +
            (pix % g.w_out) * g.sow] = ot[c * kPitch + p];
      }
    }
  }
}

// -- depthwise --------------------------------------------------------------

// a depthwise block's share of the conv (quant_kernel.dw_plan): cg
// channels and bh output rows of one image; ih input rows (the band's and
// its halo) of iw = w + 2 pad codes each; the grid's blocks walk
// (image, channel group, band), the band fastest. m_iw and m_ih divide by
// iw and ih (div_by).
struct DwPlan {
  int cg, bh, ih, iw, groups, bands;
  unsigned long long m_iw, m_ih;
};

// bytes of a block's shared memory: the codes tile, the taps, then (from
// a multiple of 4 bytes) the channels' xscale * wscale and bias
__host__ __device__ inline int dw_codes_bytes(const DwPlan& d, int k) {
  return (d.cg * d.ih * d.iw + d.cg * k * k + 3) / 4 * 4;
}

__host__ __device__ inline int dw_smem_bytes(const DwPlan& d, int k) {
  return dw_codes_bytes(d, k) + 8 * d.cg;
}

// n / d for n < 2^17 and 1 <= d < 2^23, from m = ceil(2^40 / d): n m / 2^40
// exceeds n / d by less than 2^-23 < 1 / d, so the floor is exact
__host__ __device__ inline unsigned long long div_magic(int d) {
  return ((1ull << 40) + d - 1) / d;
}

__device__ __forceinline__ int div_by(int n, unsigned long long m) {
  return static_cast<int>((static_cast<unsigned long long>(n) * m) >> 40);
}

// a value's bits, in the low bits of a word
__device__ __forceinline__ uint32_t bits_of(int v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// The k*k taps of one channel and the sum of their products at an output
// pixel of the band: KT = k a compile-time constant (3 and 5), the taps in
// registers and the loops unrolled; KT = 0 any k, read from shared memory.
template <int KT>
struct DwTaps {
  int w[KT * KT];
  __device__ __forceinline__ DwTaps(const int8_t* taps, int, int) {
#pragma unroll
    for (int q = 0; q < KT * KT; ++q) w[q] = taps[q];
  }
  __device__ __forceinline__ int sum(const int8_t* t, int iw) const {
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < KT; ++ky)
#pragma unroll
      for (int kx = 0; kx < KT; ++kx) acc += static_cast<int>(t[ky * iw + kx]) * w[ky * KT + kx];
    return acc;
  }
};

template <>
struct DwTaps<0> {
  const int8_t* w;
  int k;
  __device__ __forceinline__ DwTaps(const int8_t* taps, int k_, int) : w(taps), k(k_) {}
  __device__ __forceinline__ int sum(const int8_t* t, int iw) const {
    int acc = 0;
    for (int ky = 0; ky < k; ++ky)
      for (int kx = 0; kx < k; ++kx)
        acc += static_cast<int>(t[ky * iw + kx]) * static_cast<int>(w[ky * k + kx]);
    return acc;
  }
};

// x (N, C, H, W) of T through its strides; wp (C, k*k) int8; out (N, C,
// H_out, W_out) of O through its strides
template <typename T, typename O, int KT>
__global__ void __launch_bounds__(kDwThreads)
    conv_s8_dw_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp,
                      const float* __restrict__ wscale,
                      const float* __restrict__ bias,
                      const float* __restrict__ xscale, O* __restrict__ out,
                      Geo g, DwPlan d) {
  extern __shared__ __align__(16) int8_t dsm[];
  int8_t* tile = dsm;                          // (cg, ih, iw) codes
  int8_t* taps = dsm + d.cg * d.ih * d.iw;     // (cg, k*k)
  float* scale = reinterpret_cast<float*>(dsm + dw_codes_bytes(d, g.k));  // (cg,)
  float* shift = scale + d.cg;                 // (cg,) the bias
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int band = b % d.bands;
  b /= d.bands;
  const int c0 = (b % d.groups) * d.cg, n = b / d.groups;
  const int oy0 = band * d.bh;
  const int rows = min(d.bh, g.h_out - oy0);  // output rows of the band
  const int cgv = min(d.cg, g.c_out - c0);   // channels of the group
  const int iy0 = oy0 * g.stride - g.pad;
  const int kk = g.k * g.k;
  const float xs = *xscale;
  // the taps and each channel's epilogue constants, staged while the
  // tile's loads are in flight
  for (int e = tid; e < cgv * kk; e += kDwThreads) taps[e] = wp[c0 * kk + e];
  for (int c = tid; c < cgv; c += kDwThreads) {
    scale[c] = xs * wscale[c0 + c];
    shift[c] = bias[c0 + c];
  }

  // the band's rows and halo, quantized: a thread's kDwBatch loads in
  // flight at once, then their divisions; zero codes outside the image
  const T* xn = x + n * g.sxn + c0 * g.sxc;
  const int total = d.cg * d.ih * d.iw;
  for (int e0 = 0; e0 < total; e0 += kDwThreads * kDwBatch) {
    float v[kDwBatch];
    bool in[kDwBatch];
#pragma unroll
    for (int j = 0; j < kDwBatch; ++j) {
      const int e = e0 + j * kDwThreads + tid;
      const int r = div_by(e, d.m_iw), ix = e - r * d.iw - g.pad;
      const int c = div_by(r, d.m_ih), iy = iy0 + r - c * d.ih;
      in[j] = e < total && c < cgv && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      v[j] = in[j] ? to_f<T>(xn[c * g.sxc + iy * g.sxh + ix * g.sxw]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kDwBatch; ++j) {
      const int e = e0 + j * kDwThreads + tid;
      if (e < total) tile[e] = static_cast<int8_t>(in[j] ? quantize(v[j], xs) : 0);
    }
  }
  __syncthreads();

  // a thread per kG consecutive output pixels of one channel (16 bytes)
  // where the plane takes 16-byte stores, else per output value
  const int pix = rows * g.w_out;  // the band's output pixels per channel
  constexpr int kG = 16 / static_cast<int>(sizeof(O));
  const int rs = g.stride * d.iw;  // tile bytes from one output row to the next
  if (g.vec && (d.bh * g.w_out) % kG == 0) {
    const int per = pix / kG;
    for (int e = tid; e < cgv * per; e += kDwThreads) {
      const int c = e / per, q = (e - c * per) * kG;
      int oy = q / g.w_out, ox = q - oy * g.w_out;
      const DwTaps<KT> w(taps + c * kk, g.k, 0);
      const int8_t* tc = tile + c * d.ih * d.iw;
      const float s = scale[c], bb = shift[c];
      uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const O v = epilogue<O>(w.sum(tc + oy * rs + ox * g.stride, d.iw), s, bb, g.act);
        word[j * sizeof(O) / 4] |= bits_of(v) << (j * sizeof(O) * 8 % 32);
        if (++ox == g.w_out) {
          ox = 0;
          ++oy;
        }
      }
      *reinterpret_cast<uint4*>(out + n * g.son + (c0 + c) * g.soc +
                                oy0 * g.w_out + q) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  } else {
    for (int e = tid; e < cgv * pix; e += kDwThreads) {
      const int c = e / pix, q = e - c * pix;
      const int oy = q / g.w_out, ox = q - oy * g.w_out;
      const DwTaps<KT> w(taps + c * kk, g.k, 0);
      out[n * g.son + (c0 + c) * g.soc + (oy0 + oy) * g.soh + ox * g.sow] =
          epilogue<O>(w.sum(tile + c * d.ih * d.iw + oy * rs + ox * g.stride, d.iw),
                      scale[c], shift[c], g.act);
    }
  }
}

// -- launches ---------------------------------------------------------------

// the dynamic shared memory above 48 KB is asked for once per device
template <int BN, typename O>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  auto kernel = conv_s8_gemm_kernel<BN, O>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<BN>::template smem_bytes<O>());
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int BN, typename O>
cudaError_t launch_gemm(const int8_t* codes, const int8_t* wp,
                        const float* ws, const float* bb, const float* xs,
                        void* out, const Geo& g, cudaStream_t stream) {
  const cudaError_t err = allow_smem<BN, O>();
  if (err != cudaSuccess) return err;
  const int m_total = g.n * g.h_out * g.w_out;
  const dim3 grid((m_total + kBM - 1) / kBM, (g.c_out + BN - 1) / BN);
  auto kernel = conv_s8_gemm_kernel<BN, O>;
  kernel<<<grid, kThreads, Tile<BN>::template smem_bytes<O>(), stream>>>(
      codes, wp, ws, bb, xs, static_cast<O*>(out), g);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_gemm_tile(const int8_t* codes, const int8_t* wp,
                             const float* ws, const float* bb, const float* xs,
                             void* out, const Geo& g, int n_tile,
                             cudaStream_t stream) {
  switch (n_tile) {
    case 32: return launch_gemm<32, O>(codes, wp, ws, bb, xs, out, g, stream);
    case 64: return launch_gemm<64, O>(codes, wp, ws, bb, xs, out, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, const float* xs, int8_t* codes,
                         const Geo& g, cudaStream_t stream) {
  const dim3 grid((g.n * g.h * g.w + kQThreads - 1) / kQThreads,
                  g.c_pitch / 16);
  conv_s8_quant_kernel<T><<<grid, kQThreads, 0, stream>>>(
      static_cast<const T*>(x), xs, codes, g);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_dw(const void* x, const int8_t* wp, const float* ws,
                      const float* bb, const float* xs, void* out,
                      const Geo& g, const DwPlan& d, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(g.n) * d.groups * d.bands;
  const int smem = dw_smem_bytes(d, g.k);
  const T* xt = static_cast<const T*>(x);
  O* o = static_cast<O*>(out);
  if (g.k == 3) {
    conv_s8_dw_kernel<T, O, 3><<<blocks, kDwThreads, smem, stream>>>(xt, wp, ws, bb, xs, o, g, d);
  } else if (g.k == 5) {
    conv_s8_dw_kernel<T, O, 5><<<blocks, kDwThreads, smem, stream>>>(xt, wp, ws, bb, xs, o, g, d);
  } else {
    conv_s8_dw_kernel<T, O, 0><<<blocks, kDwThreads, smem, stream>>>(xt, wp, ws, bb, xs, o, g, d);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_out(const void* x, const int8_t* wp, const float* ws,
                          const float* bb, const float* xs, void* out,
                          const Geo& g, const DwPlan& d, cudaStream_t stream) {
  return g.sums ? launch_dw<T, int>(x, wp, ws, bb, xs, out, g, d, stream)
                : launch_dw<T, T>(x, wp, ws, bb, xs, out, g, d, stream);
}

}  // namespace

// groups 1. x (n, c_in, h, w) through its strides, float32 (dtype 0) or
// bfloat16 (1); wp the packed int8 weights, (k*k*c_pitch/32, 2, co_pad,
// 16) with co_pad a multiple of 64, 16-byte aligned; wscale, b (c_out,)
// float32; xscale one float32 on the device; codes a scratch of
// n*h*w*c_pitch bytes, 16-byte aligned, c_pitch a multiple of 32; out
// (n, c_out, h_out, w_out) through its strides, in x's dtype, or int32
// sums with sums = 1. n_tile: output channels per block of the
// tensor-core form (32 or 64). vec: the output's planes are contiguous
// and 16-byte aligned in groups of 16 bytes (h_out * w_out, son and soc
// multiples of 16 / element size, sow = 1, soh = w_out).
extern "C" int ssyt_conv_s8(const void* x, const void* wp, const void* wscale,
                            const void* b, const void* xscale, void* codes,
                            void* out, int n, int h, int wd, int c_in,
                            int c_out, int h_out, int w_out, long long sxn,
                            long long sxc, long long sxh, long long sxw,
                            long long son, long long soc, long long soh,
                            long long sow, int k, int stride, int pad,
                            int c_pitch, int co_pad, int n_tile, int act,
                            int sums, int dtype, int vec, void* stream) {
  const long long pixels = static_cast<long long>(n) * h * wd;
  if (k < 1 || stride < 1 || pad < 0 || n < 1 || h < 1 || wd < 1 ||
      c_in < 1 || c_out < 1 || h_out < 1 || w_out < 1 || c_pitch % kBK ||
      c_pitch < c_in || pixels >= (1ll << 31) ||
      static_cast<long long>(n) * h_out * w_out >= (1ll << 31) ||
      static_cast<long long>(h) * wd * c_pitch >= (1ll << 31) ||
      co_pad % kCoAlign || co_pad < c_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{n,   h,    wd,      c_in,   c_out, h_out, w_out, k,
              stride, pad, c_pitch, co_pad, act, sums,  vec,   sxn,
              sxc,  sxh,  sxw,     son,    soc,   soh,   sow};
  const int8_t* w8 = static_cast<const int8_t*>(wp);
  const float* ws = static_cast<const float*>(wscale);
  const float* bb = static_cast<const float*>(b);
  const float* xs = static_cast<const float*>(xscale);
  int8_t* cd = static_cast<int8_t*>(codes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch_quant<__nv_bfloat16>(x, xs, cd, g, s)
                               : launch_quant<float>(x, xs, cd, g, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sums) {
    err = launch_gemm_tile<int>(cd, w8, ws, bb, xs, out, g, n_tile, s);
  } else if (dtype == 1) {
    err = launch_gemm_tile<__nv_bfloat16>(cd, w8, ws, bb, xs, out, g, n_tile, s);
  } else {
    err = launch_gemm_tile<float>(cd, w8, ws, bb, xs, out, g, n_tile, s);
  }
  return static_cast<int>(err);
}

// depthwise (groups = c = c_out), one launch: x, wscale, b, xscale, out,
// act, sums, dtype and vec as ssyt_conv_s8's; wp (c, k*k) int8; a block
// per (image, cg channels, bh output rows) (quant_kernel.dw_plan). The
// grid's limit is its own: n * ceil(c / cg) * ceil(h_out / bh) blocks
// below 2^31, and a block's codes tile, taps and epilogue constants
// within 48 KB.
extern "C" int ssyt_conv_s8_dw(const void* x, const void* wp,
                               const void* wscale, const void* b,
                               const void* xscale, void* out, int n, int h,
                               int wd, int c, int h_out, int w_out,
                               long long sxn, long long sxc, long long sxh,
                               long long sxw, long long son, long long soc,
                               long long soh, long long sow, int k, int stride,
                               int pad, int cg, int bh, int act, int sums,
                               int dtype, int vec, void* stream) {
  if (k < 1 || stride < 1 || pad < 0 || n < 1 || h < 1 || wd < 1 || c < 1 ||
      h_out < 1 || w_out < 1 || cg < 1 || bh < 1 ||
      (h_out - 1) * stride + k > h + 2 * pad ||
      (w_out - 1) * stride + k > wd + 2 * pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwPlan d;
  d.cg = cg < c ? cg : c;
  d.bh = bh < h_out ? bh : h_out;
  d.ih = (d.bh - 1) * stride + k;
  d.iw = wd + 2 * pad;
  d.groups = (c + d.cg - 1) / d.cg;
  d.bands = (h_out + d.bh - 1) / d.bh;
  d.m_iw = div_magic(d.iw);
  d.m_ih = div_magic(d.ih);
  const long long blocks = static_cast<long long>(n) * d.groups * d.bands;
  if (blocks >= (1ll << 31) ||
      static_cast<long long>(d.cg) * d.ih * d.iw + d.cg * k * k + 3 + 8 * d.cg > kDwSmem ||
      d.iw >= (1 << 23) ||
      static_cast<long long>(d.cg) * d.bh * w_out >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g{};
  g.n = n;
  g.h = h;
  g.w = wd;
  g.c_in = g.c_out = c;
  g.h_out = h_out;
  g.w_out = w_out;
  g.k = k;
  g.stride = stride;
  g.pad = pad;
  g.act = act;
  g.sums = sums;
  g.vec = vec;
  g.sxn = sxn;
  g.sxc = sxc;
  g.sxh = sxh;
  g.sxw = sxw;
  g.son = son;
  g.soc = soc;
  g.soh = soh;
  g.sow = sow;
  const int8_t* w8 = static_cast<const int8_t*>(wp);
  const float* ws = static_cast<const float*>(wscale);
  const float* bb = static_cast<const float*>(b);
  const float* xs = static_cast<const float*>(xscale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch_dw_out<__nv_bfloat16>(x, w8, ws, bb, xs, out, g, d, s)
                 : launch_dw_out<float>(x, w8, ws, bb, xs, out, g, d, s);
  return static_cast<int>(err);
}

// the quantize pass alone (the codes of x, as ssyt_conv_s8 writes them
// before its conv of groups 1): for the tests and the profiling tool
extern "C" int ssyt_conv_s8_quantize(const void* x, const void* xscale,
                                     void* codes, int n, int h, int wd,
                                     int c_in, long long sxn, long long sxc,
                                     long long sxh, long long sxw,
                                     int c_pitch, int dtype, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c_in < 1 || c_pitch % kBK ||
      c_pitch < c_in || static_cast<long long>(n) * h * wd >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g{};
  g.n = n;
  g.h = h;
  g.w = wd;
  g.c_in = c_in;
  g.c_pitch = c_pitch;
  g.sxn = sxn;
  g.sxc = sxc;
  g.sxh = sxh;
  g.sxw = sxw;
  const float* xs = static_cast<const float*>(xscale);
  int8_t* cd = static_cast<int8_t*>(codes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch_quant<__nv_bfloat16>(x, xs, cd, g, s)
                 : launch_quant<float>(x, xs, cd, g, s);
  return static_cast<int>(err);
}
