// K7, im2col form in bfloat16: 'same' stride-1 conv (k = 1 or 3, groups 1)
// + float32 bias + optional SiLU on bfloat16 activations, as one product
// of the gathered rows by the weights, on the tensor cores (wgmma),
// rounded once to bfloat16.
//
// Replaces tools/prof/_prof_conv2.py:145 call with _kernel_im2col (the TPU
// shootout's formulation: the 9 shifted planes concatenated along the
// lanes into (rows, 9 * C_in), ONE dot with the (9 * C_in, C_out) weight,
// float32 sums, the bias and SiLU on the float32 accumulator, one cast;
// its _kernel_dy3 is the same function summed in another grouping). The
// float32 im2col form runs on the CUDA cores (conv_act.cuh).
//
// Bound: at the route's shapes the work is 9 * C_in * C_out bf16
// multiply-adds per pixel on 2 * (C_in + C_out) bytes per pixel, below the
// H100's ~295 operations per byte: bound by the bytes (x read once, y
// written once). The gathered row reads each input up to 9 times, from L1
// and L2; those reads and the gather's instructions are what this form
// costs beyond the mma form, which reads a slab once per tile. As a GEMM
// with M = output pixels, N = C_out, K = k * k * C_in:
//
// - one block is one warpgroup (128 threads) and M = 64 consecutive output
//   pixels in (image, y, x) order, the TPU kernel's rows, which may cross
//   rows and images, for N output channels (16, 32, 64, 80 or 128, the
//   smallest that holds C_out, else 128 and the grid's y runs over N
//   tiles);
// - K is the row in (ky, kx, ci) order, the HWIO flattening, so B is the
//   (k*k*C_in, C_out) weight itself, packed once per conv by the wrapper
//   (conv_kernel.py::pack_im2col: pack_mma's layout for a 1x1 conv of
//   k*k*C_in channels, zero past the row and past C_out): per 16 entries,
//   two (N_pad, 8) planes, wgmma's no-swizzle K-major layout;
// - K runs in stages of 32 entries (two wgmma k16 steps) through a ring of
//   three stages in shared memory: A as [entry/8][pixel][8] (8 pixels x 8
//   entries a 128-byte core matrix), B by cp.async. Each thread gathers 16
//   entries of one pixel a stage: where 8 entries share a tap (C_in % 8 ==
//   0, or away from a tap's end) one bounds test serves them, and x is
//   read through its strides, zero where the tap leaves the image or past
//   the row. The gathers of stage s + 3 are issued into registers while
//   stage s's wgmmas run, and stored into the ring one stage later;
// - the loops over K hold no integer division: a cursor (channel, tap,
//   offset) advanced by additions, and a tap mask made once per pixel
//   (conv_act.cuh's Cursor, tap_mask);
// - epilogue on the float32 accumulators as the mma form's (conv_mma.cuh's
//   stage_acc: + float32 bias, SiLU, one rounding to bfloat16, staged in
//   shared memory), stored along the output's unit stride, 16 bytes of 8
//   pixels of a channel where W % 8 == 0;
// - no split-K and no atomics: two launches are bit-identical. The tensor
//   cores sum each k16 step's products in their own order, so the result
//   differs from the plain version's float32 conv by float32 rounding
//   only, well inside one bf16 unit.

#include <limits.h>

#include "conv_act.cuh"

namespace k7im2col {

using k7cc::Cursor;
using k7cc::Geo;

constexpr int kM = 64;             // output pixels of a block
constexpr int kKS = 32;            // row entries per stage: two k16 steps
constexpr int kRing = 3;           // stages in shared memory
constexpr int kThreads = 128;      // one warpgroup
constexpr int kAVec = kKS / 8 * kM;  // A: [entry/8][pixel] 16-byte vectors
constexpr int kPitchO = kM + 8;    // staged output row, bf16

template <int N>
struct Sh {
  static constexpr int kBVec = kKS / 8 * N;  // [k16 step][plane][N]
  static constexpr int kStageVec = kAVec + kBVec;
  static constexpr int kRingBytes = kRing * kStageVec * 16;
  static constexpr int kOutBytes = N * kPitchO * 2;
  static constexpr int kSmemBytes = kRingBytes > kOutBytes ? kRingBytes : kOutBytes;
  static constexpr int kMinBlocks = N <= 64 ? 4 : 3;
};

__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// vec: NCHW output with W % 8 == 0 and 16-byte aligned rows, so that 8
// consecutive pixels of a block are one 16-byte run of a row
template <int K, int N>
__global__ void __launch_bounds__(kThreads, (Sh<N>::kMinBlocks))
    conv_im2col_mma_kernel(const uint16_t* __restrict__ x,
                           const uint4* __restrict__ wp,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, Geo g, int n_pix,
                           int n_pad, int stages, int act, int vec) {
  using S = Sh<N>;
  extern __shared__ __align__(128) uint4 smem[];
  const int tid = threadIdx.x;
  const int p = tid % kM, half = tid / kM;  // pixel; entries 16 half + 0..15
  const int p0 = blockIdx.x * kM;
  const int nc0 = blockIdx.y * N;
  const int hw = g.h * g.w;

  uint32_t mask = 0u;
  const uint16_t* xp = x;
  if (p0 + p < n_pix) {
    const int pp = p0 + p;
    const int n = pp / hw, r = pp - n * hw;
    const int y = r / g.w, xx = r - y * g.w;
    mask = k7cc::tap_mask<K>(y, xx, g);
    xp = x + n * g.sxn + y * g.sxh + xx * g.sxw;
  }
  Cursor<K> cur;
  cur.init(g);
  cur.advance(16 * half, g);

  // this thread's 16 entries of the next stage, two 8-entry vectors
  uint32_t ar[8];
  auto gather = [&]() {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      uint32_t e[4] = {0u, 0u, 0u, 0u};
      if (cur.ci + 8 <= g.c_in) {  // one tap for the 8 entries
        if (cur.inside(mask)) {
          const uint16_t* q = xp + cur.off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            e[j / 2] |= static_cast<uint32_t>(__ldg(q + j * g.sxc)) << (16 * (j % 2));
          }
        }
        cur.advance(8, g);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cur.inside(mask)) {
            e[j / 2] |= static_cast<uint32_t>(__ldg(xp + cur.off)) << (16 * (j % 2));
          }
          cur.step(g);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) ar[4 * v + q] = e[q];
    }
    cur.advance(16, g);  // the other half's entries
  };
  auto store_a = [&](int buf) {
    uint4* a = smem + buf * S::kStageVec;
    a[(2 * half) * kM + p] = make_uint4(ar[0], ar[1], ar[2], ar[3]);
    a[(2 * half + 1) * kM + p] = make_uint4(ar[4], ar[5], ar[6], ar[7]);
  };
  // stage s's weights of this block's N channels: 16-entry chunks 2s and
  // 2s + 1 of the packed (chunks, 1, 2, n_pad, 8) weights
  auto load_b = [&](int s, int buf) {
    uint4* dst = smem + buf * S::kStageVec + kAVec;
    for (int u = tid; u < S::kBVec; u += kThreads) {
      const int n = u % N, tp = u / N;
      cp_async16(dst + u, wp + static_cast<long long>(4 * s + tp) * n_pad + nc0 + n);
    }
  };

  float acc[1][N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[0][i] = 0.0f;

  gather();
  store_a(0);
  load_b(0, 0);
  cp_async_commit();
  if (stages > 1) {
    gather();
    store_a(1);
    load_b(1, 1);
  }
  cp_async_commit();
  if (stages > 2) gather();
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();

  for (int s = 0; s < stages; ++s) {
    const int buf = s % kRing;
    const uint32_t a0 = smem_u32(smem + buf * S::kStageVec);
    const uint32_t b0 = smem_u32(smem + buf * S::kStageVec + kAVec);
    fence_operands<N / 2>(acc[0]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t da = make_desc(a0 + 2 * h * kM * 16, kM * 16, 128);
      const uint64_t db = make_desc(b0 + 2 * h * N * 16, N * 16, 128);
      Mma<N>::run(acc[0], da, db);
    }
    wgmma_commit();
    wgmma_wait_1();  // stage s - 1's products are done: its buffer is free
    fence_operands<N / 2>(acc[0]);
    if (s + 2 < stages) {
      const int nb = (s + 2) % kRing;
      store_a(nb);
      load_b(s + 2, nb);
    }
    cp_async_commit();
    if (s + 3 < stages) gather();
    k7cc::cp_async_wait_group<1>();  // stage s + 1's weights
    fence_async_shared();
    __syncthreads();
  }
  wgmma_wait_all();
  fence_operands<N / 2>(acc[0]);
  __syncthreads();  // every warp's products are done with the ring

  __nv_bfloat16* const ot = reinterpret_cast<__nv_bfloat16*>(smem);
  const auto px_of = [](int, int row) { return row; };
  if (act) {
    stage_acc<N, true, 1, kPitchO>(acc, bias, nc0, g.c_out, ot, px_of);
  } else {
    stage_acc<N, false, 1, kPitchO>(acc, bias, nc0, g.c_out, ot, px_of);
  }
  __syncthreads();
  if (vec) {  // 8 pixels of one channel per 16-byte store
    for (int i = tid; i < N * kM / 8; i += kThreads) {
      const int c = i / (kM / 8), q = i % (kM / 8);
      const int co = nc0 + c, pp = p0 + 8 * q;
      if (co < g.c_out && pp < n_pix) {
        const int n = pp / hw, r = pp - n * hw;
        const int y = r / g.w, xx = r - y * g.w;
        *reinterpret_cast<uint4*>(out + n * g.son + co * g.soc + y * g.soh + xx) =
            *reinterpret_cast<const uint4*>(ot + c * kPitchO + 8 * q);
      }
    }
  } else {
    const bool pixel_major = g.sow == 1;
    for (int i = tid; i < N * kM; i += kThreads) {
      const int c = pixel_major ? i / kM : i % N;
      const int q = pixel_major ? i % kM : i / N;
      const int co = nc0 + c, pp = p0 + q;
      if (co < g.c_out && pp < n_pix) {
        const int n = pp / hw, r = pp - n * hw;
        const int y = r / g.w, xx = r - y * g.w;
        out[n * g.son + co * g.soc + y * g.soh + xx * g.sow] = ot[c * kPitchO + q];
      }
    }
  }
}

template <int K, int N>
cudaError_t launch(const void* x, const void* wp, const void* b, void* out,
                   int n, const Geo& g, int n_pad, int chunks, int act,
                   int vec, cudaStream_t stream) {
  using S = Sh<N>;
  auto kernel = conv_im2col_mma_kernel<K, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_pix = n * g.h * g.w;
  const dim3 grid((n_pix + kM - 1) / kM, n_pad / N, 1);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(wp),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), g,
      n_pix, n_pad, chunks / 2, act, vec);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(const void* x, const void* wp, const void* b, void* out,
                     int n, const Geo& g, int n_tile, int n_pad, int chunks,
                     int act, int vec, cudaStream_t s) {
  switch (n_tile) {
    case 16: return launch<K, 16>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 32: return launch<K, 32>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 64: return launch<K, 64>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 80: return launch<K, 80>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    case 128: return launch<K, 128>(x, wp, b, out, n, g, n_pad, chunks, act, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k7im2col

// x (n, c_in, h, w) and out (n, c_out, h, w), bfloat16, through the given
// strides; wp the packed weights (chunks, 1, 2, n_pad, 8) bfloat16
// (ops/cuda/conv_kernel.py::pack_im2col: chunks of 16 row entries, an even
// number, covering k*k*c_in), n_pad a multiple of n_tile; b (c_out,)
// float32. k is 1 or 3.
extern "C" int ssyt_conv_im2col_mma(const void* x, const void* wp,
                                    const void* b, void* out, int n, int h,
                                    int wd, int c_in, int c_out, long long sxn,
                                    long long sxc, long long sxh, long long sxw,
                                    long long son, long long soc, long long soh,
                                    long long sow, int k, int act, int n_tile,
                                    int n_pad, int chunks, void* stream) {
  using k7cc::span;
  if ((k != 1 && k != 3) || n < 1 || h < 1 || wd < 1 || c_in < 1 ||
      c_out < 1 || n_tile < 1 || n_pad % n_tile != 0 || n_pad < c_out ||
      chunks % 2 != 0 || chunks * 16 < k * k * c_in || sxc < 0 || sxh < 0 ||
      sxw < 0 || soc < 0 || soh < 0 || sow < 0 ||
      span(c_in, h, wd, sxc, sxh, sxw) >= INT_MAX ||
      span(c_out, h, wd, soc, soh, sow) >= INT_MAX ||
      static_cast<long long>(n) * h * wd >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const k7cc::Geo g{h,  wd, c_in, c_out, sxn, son,
                    static_cast<int>(sxc), static_cast<int>(sxh),
                    static_cast<int>(sxw), static_cast<int>(soc),
                    static_cast<int>(soh), static_cast<int>(sow)};
  const int vec = sow == 1 && soc % 8 == 0 && soh % 8 == 0 && son % 8 == 0 &&
                  wd % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k == 1 ? k7im2col::dispatch<1>(x, wp, b, out, n, g, n_tile, n_pad,
                                     chunks, act, vec, s)
             : k7im2col::dispatch<3>(x, wp, b, out, n, g, n_tile, n_pad,
                                     chunks, act, vec, s);
  return static_cast<int>(err);
}
