#pragma once

// K6's tensor-core stage body, shared by its launches: one block per crop
// (os_stage_mma.cu, whose note describes the design) and a cluster of K
// blocks per crop, each on a band of whole rows (os_stage_cluster.cu,
// whose note describes what crosses the blocks), in bfloat16; and the
// same two in float32 (os_stage_tf32.cu, os_stage_tf32_cluster.cu), whose
// 1x1 products run as 3xTF32 (the note of os_stage_tf32.cu). The body is
// one template over the element type T and K: with K = 1 every cluster
// step compiles away.

#include <cooperative_groups.h>

#include "os_stage.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr long long kMaxSmem = 227 * 1024;

// the least row stride >= c (in elements of T) whose 4-byte words step by
// 4 mod 8 banks from row to row: bf16, 8 more than a multiple of 16;
// float32, 4 more than a multiple of 8. The 8 rows of a fragment load
// then hit 8 different groups of 4 banks (the columns past c of a K chunk
// are never read: the fragments zero them)
template <typename T>
__host__ __device__ constexpr int row_stride(int c) {
  return sizeof(T) == 2 ? (c + 7) / 16 * 16 + 8 : (c + 3) / 8 * 8 + 4;
}

// element offsets of the shared-memory regions, and the bytes in all
struct Layout {
  int sx, sm, sxa, se;        // row strides (elements) of X, the mid columns, XA, E
  long long cols, xa, halo;   // element offsets of the columns, XA and the halo rows
  long long floats;           // byte offset of the float arrays
  long long bytes;
};

// pixels: a block's pixels (the crop's, or its band's in a cluster of k
// blocks of w-wide rows); elements of T
template <typename T>
__host__ __device__ constexpr Layout layout(int c_in, int c_out, int mid, int pixels,
                                            int w = 0, int k = 1) {
  Layout l{};
  const long long m = pixels;
  l.sx = row_stride<T>(c_in);
  l.sm = row_stride<T>(mid);
  l.sxa = row_stride<T>(c_out);
  l.se = l.sxa;
  l.cols = m * l.sx;
  // X and the four columns (y, s, agg, u), overlaid at the end by E, the
  // transition's or conv5's output
  long long region = l.cols + 4 * m * l.sm;
  if (m * l.se > region) region = m * l.se;
  l.xa = (region + 7) / 8 * 8;
  l.halo = l.xa + m * l.sxa;
  // in a cluster: the lite buffer's rows above and below the band, two
  // sets by the lite conv's parity, each a (w, sm) crop row
  l.floats = (l.halo + (k > 1 ? 4LL * w * l.sm : 0)) * (long long)sizeof(T);
  // the gate's mean and values; in a cluster the k bands' partial sums
  l.bytes = l.floats + 4LL * (2 + (k > 1 ? k : 0)) * mid;
  return l;
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma1688(float* c, const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, on the bit pattern: the value as float32 bits, the low 13 zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo + (what 3xTF32 drops): hi = tf32(v), lo = tf32(v - hi);
// v - hi is exact in float32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// the cluster barrier, in two halves: arrive releases this thread's
// earlier shared-memory writes (its own block's and other blocks'), wait
// acquires every block's; every thread of every block of the cluster
// takes part
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a barrier over the block, or over the cluster where a crop spans K blocks
template <int K>
__device__ __forceinline__ void band_sync() {
  if constexpr (K > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// acc[mb][nb] += A[row0 + 16 mb .., :K] x W[n0 + 8 nb .., :K]^T: the A
// rows in shared memory (stride sa), W (N, K) row-major bf16 in global
// memory; K a multiple of 8, the last chunk zero-padded past K. Each
// 16-wide chunk is summed by the tensor cores from zero and added to acc
// in float32, rounded to nearest: the tensor cores align a chunk's
// products to the largest of them and drop the bits below, so summing
// into a large running value would lose more of each chunk.
__device__ __forceinline__ void mma_unit(float (&acc)[2][4][4], const bf16* A, int sa,
                                         int row0, const bf16* __restrict__ w, int K,
                                         int N, int n0, int g, int t) {
  const int kpad = (K + 15) / 16 * 16;
  for (int k0 = 0; k0 < kpad; k0 += 16) {
    const bool hi = k0 + 16 <= K;  // columns k0 + 8 .. k0 + 15 exist
    uint32_t a[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const bf16* p0 = A + (row0 + 16 * mb + g) * sa + k0 + 2 * t;
      const bf16* p1 = p0 + 8 * sa;
      a[mb][0] = lds32(p0);
      a[mb][1] = lds32(p1);
      a[mb][2] = hi ? lds32(p0 + 8) : 0u;
      a[mb][3] = hi ? lds32(p1 + 8) : 0u;
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int n = n0 + 8 * nb;
      if (n < N) {  // warp-uniform: N is a multiple of 8
        const bf16* wp = w + (n + g) * K + k0 + 2 * t;
        const uint32_t b0 = ldg32(wp);
        const uint32_t b1 = hi ? ldg32(wp + 8) : 0u;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma16816(part, a[mb], b0, b1);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mb][nb][q] = acc[mb][nb][q] + part[q];
        }
      }
    }
  }
}

// The float32 unit, 3xTF32: as above with 8-wide K chunks of
// mma.sync m16n8k8 on TF32 operands. Each float32 operand is split into
// hi + lo (split_tf32), and a chunk's sum is lo.hi + hi.lo + hi.hi,
// three mma.syncs into one float32 fragment from zero (the small terms
// first), added to acc in float32: the products keep about 21 of
// float32's 24 bits (only lo.lo and the bits past lo are dropped) at up
// to 495 / 3 TFLOP/s, against 67 on the CUDA cores. K a multiple of 8.
// The A fragment (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, col): b0 (k t, n g), b1 (k t + 4, n g);
// the accumulators as m16n8k16's.
__device__ __forceinline__ void mma_unit(float (&acc)[2][4][4], const float* A, int sa,
                                         int row0, const float* __restrict__ w, int K,
                                         int N, int n0, int g, int t) {
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const float* p0 = A + (row0 + 16 * mb + g) * sa + k0 + t;
      const float* p1 = p0 + 8 * sa;
      split_tf32(p0[0], ah[mb][0], al[mb][0]);
      split_tf32(p1[0], ah[mb][1], al[mb][1]);
      split_tf32(p0[4], ah[mb][2], al[mb][2]);
      split_tf32(p1[4], ah[mb][3], al[mb][3]);
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int n = n0 + 8 * nb;
      if (n < N) {  // warp-uniform: N is a multiple of 8
        const float* wp = w + (n + g) * K + k0 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(__ldg(wp), bh0, bl0);
        split_tf32(__ldg(wp + 4), bh1, bl1);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma1688(part, al[mb], bh0, bh1);
          mma1688(part, ah[mb], bl0, bl1);
          mma1688(part, ah[mb], bh0, bh1);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mb][nb][q] = acc[mb][nb][q] + part[q];
        }
      }
    }
  }
}

// out[row, n] = epi(row, n, sum_k A[row, k] W[n, k], sum_k A2[row, k] W2[n, k])
// for rows < mv (a multiple of 32) and n < N, two columns at a time; the
// second product only with kDual
template <typename T>
struct NoDeduce {
  typedef T type;
};

template <int NW, bool kDual, typename T, typename Epi>
__device__ __forceinline__ void gemm(int mv, int N, const T* A, int sa,
                                     const T* __restrict__ w, int K,
                                     const typename NoDeduce<T>::type* A2, int sa2,
                                     const typename NoDeduce<T>::type* __restrict__ w2,
                                     int K2, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = mv / 32, nt = (N + 31) / 32;
  for (int u = warp; u < mt * nt; u += NW) {
    const int row0 = (u % mt) * 32, n0 = (u / mt) * 32;
    float acc[2][4][4], acc2[2][4][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mb][nb][q] = acc2[mb][nb][q] = 0.0f;
    mma_unit(acc, A, sa, row0, w, K, N, n0, g, t);
    if (kDual) mma_unit(acc2, A2, sa2, row0, w2, K2, N, n0, g, t);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = n0 + 8 * nb + 2 * t;
        if (n0 + 8 * nb < N) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            epi(row0 + 16 * mb + g + 8 * h, col, acc[mb][nb][2 * h],
                acc[mb][nb][2 * h + 1], acc2[mb][nb][2 * h], acc2[mb][nb][2 * h + 1]);
        }
      }
  }
}

// walks (row, channel pair) over rows < mv and n2 pairs, NT threads at
// a time, without a division per step
template <int NT, typename Fn>
__device__ __forceinline__ void for_pairs(int mv, int n2, Fn fn) {
  int row = threadIdx.x / n2, c2 = threadIdx.x - row * n2;
  const int drow = NT / n2, dc = NT - drow * n2;
  while (row < mv) {
    fn(row, 2 * c2);
    c2 += dc;
    row += drow;
    if (c2 >= n2) {
      c2 -= n2;
      ++row;
    }
  }
}

constexpr int kMaxHidden = 8;  // the gate's hidden width, mid / 16, at most
constexpr int kRun = 4;        // pixels of a crop row one thread's stencil takes
constexpr int kLites = 10;     // lite convs of an OS block

// s = round(relu(3x3 depthwise stencil of u + bias)) over the block's B
// pixels, band `rank` of K of a crop of W-wide rows: a thread keeps one
// channel pair, its 18 taps and 2 biases in registers, and walks runs of
// kRun pixels of a crop row, loading the 3 x (kRun + 2) neighbourhood
// once; the rows above and below a band come from `halo` (the row above,
// then the row below); outside the crop the neighbours are 0, which adds
// +-0 to a sum: the same value as leaving the tap out. Each output sums
// its 9 products in float32, dy outer and dx inner, each product and sum
// rounded on its own, as os_stage_plain.
template <typename T, int B, int W, int NT, int K>
__device__ __forceinline__ void stencil(const T* u, T* s, int sm, int mid,
                                        const float* __restrict__ taps,
                                        const float* __restrict__ dwb,
                                        const T* halo, int rank) {
  constexpr int HB = B / W, H = HB * K, kRuns = W / kRun;
  const int n2 = mid / 2, per = NT / n2;  // threads per channel pair
  const int c = 2 * (threadIdx.x % n2);
  const int first = threadIdx.x / n2;
  if (first >= per) return;  // the threads past a whole number of pairs
  float t0[9], t1[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    t0[q] = __ldg(taps + q * mid + c);
    t1[q] = __ldg(taps + q * mid + c + 1);
  }
  const float b0 = __ldg(dwb + c), b1 = __ldg(dwb + c + 1);
  constexpr int items = HB * kRuns;
  for (int it = first; it < items; it += per) {
    const int rr = it / kRuns, x0 = (it - rr * kRuns) * kRun;
    const int y = rank * HB + rr, row = rr * W;  // the run's first pixel: row + x0
    float2 v[3][kRun + 2];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const bool in_y = (dy > 0 || y > 0) && (dy < 2 || y < H - 1);
      const T* line = u + (row + (dy - 1) * W) * sm;  // the crop row at x = 0
      if constexpr (K > 1) {
        if (dy == 0 && rr == 0) line = halo;
        if (dy == 2 && rr == HB - 1) line = halo + W * sm;
      }
#pragma unroll
      for (int dx = 0; dx < kRun + 2; ++dx) {
        const int xx = x0 + dx - 1;
        v[dy][dx] = (in_y && xx >= 0 && xx < W) ? load2(line + xx * sm + c)
                                                : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          a0 = a0 + v[dy][j + dx].x * t0[dy * 3 + dx];
          a1 = a1 + v[dy][j + dx].y * t1[dy * 3 + dx];
        }
      }
      store2(s + (row + x0 + j) * sm + c, fmaxf(a0 + b0, 0.0f), fmaxf(a1 + b1, 0.0f));
    }
  }
}

// One stage on the B pixels of a block: the whole crop (K = 1, the block
// is the crop's), or band `rank` of a crop split over a cluster of K
// blocks, each on B / W whole rows. What differs in a cluster: a lite
// conv's pointwise output is also stored into the neighbouring bands'
// halo rows, and the barrier that follows it is the cluster's; the gate's
// mean is the sum of the K bands' partial sums, which every band pushes
// into every band's shared memory before a cluster barrier, added in rank
// order 0 .. K-1 by each band alike.
template <typename T, int B, int W, int NT, int K>
__device__ __forceinline__ void stage_body(const T* __restrict__ x,
                                           const T* __restrict__ mats,
                                           const float* __restrict__ vecs,
                                           const int32_t* __restrict__ offs,
                                           T* __restrict__ out, int c_in, int c_out,
                                           int mid, int gap) {
  constexpr int NW = NT / 32;
  constexpr int P = B * K;  // the crop's pixels
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(c_in, c_out, mid, B, W, K);
  const int R = mid / 16 > 0 ? mid / 16 : 1;  // the gate's hidden width
  T* base = reinterpret_cast<T*>(smem);
  T* xs = base;                 // (B, c_in) block input
  T* ycol = base + L.cols;      // conv1's output y
  T* scol = ycol + B * L.sm;    // the current stream s
  T* acol = scol + B * L.sm;    // the aggregate
  T* ucol = acol + B * L.sm;    // a lite conv's pointwise output
  T* es = base;                 // the transition's or conv5's output
  T* xa = base + L.xa;          // (B, c_out) block output
  T* halo = base + L.halo;      // (2 parities, above and below, W, sm)
  float* gmean = reinterpret_cast<float*>(smem + L.floats);  // (mid,)
  float* gval = gmean + mid;                                  // (mid,)
  float* gpart = gval + mid;       // (K, mid): each band's sums, by rank
  const int sm = L.sm, sx = L.sx, sxa = L.sxa, se = L.se;
  const int halo_set = 2 * W * sm;  // one parity's halo rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t g = blockIdx.x;  // the crop
  int rank = 0;            // its band
  if constexpr (K > 1) {
    rank = (int)cg::this_cluster().block_rank();
    g = blockIdx.x / K;
    // no block stores into another before every block of the cluster runs
    cluster_arrive();
  }
  constexpr int mv = B;
  const int n2 = mid / 2;
  // float32 in blocks of 16 warps (128 registers a thread) takes block a's
  // down conv and conv3 in two passes: the dual pass's 64 accumulators
  // spilled there
  constexpr bool kSplitDown = sizeof(T) == 4 && NT >= 512;

  // the band, NCHW in global memory, to [pixel][channel]
  {
    const T* xg = x + g * c_in * P + rank * B;
    for (int e = tid; e < c_in * B; e += NT) xs[(e % B) * sx + e / B] = xg[(e / B) * P + e % B];
  }
  __syncthreads();

#pragma unroll 1
  for (int blk = 0; blk < 2; ++blk) {
    const int32_t* bo = offs + blk * kBlockEntries;
    const int cin = blk == 0 ? c_in : c_out;
    const T* src = blk == 0 ? xs : xa;
    const int ssrc = blk == 0 ? sx : sxa;

    // conv1 -> relu -> round
    {
      const float* b1 = vecs + bo[kB1];
      gemm<NW, false>(mv, mid, src, ssrc, mats + bo[kW1], cin, nullptr, 0, nullptr, 0,
                      [&](int row, int col, float v0, float v1, float, float) {
                        store2(ycol + row * sm + col, fmaxf(v0 + b1[col], 0.0f),
                               fmaxf(v1 + b1[col + 1], 0.0f));
                      });
    }
    __syncthreads();
    if constexpr (K > 1) {
      if (blk == 0) cluster_wait();
    }

#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
#pragma unroll 1
      for (int k = 0; k <= t; ++k) {
        const int lite = t * (t + 1) / 2 + k;
        const int32_t* lo = bo + kLite0 + 4 * lite;
        const float* pwb = vecs + lo[1];
        // the halo set of this lite conv: the one before it in the stage
        // used the other, and a band's readers of this one passed the
        // cluster barrier after that conv before it is written again
        const int hs = ((blk * kLites + lite) & 1) * halo_set;
        // the halo rows of the bands above and below that this band's
        // first and last rows go to (mapped here, not held across the
        // stage: registers are scarce in the dual GEMM)
        T* above = nullptr;
        T* below = nullptr;
        if constexpr (K > 1) {
          if (rank > 0) above = cg::this_cluster().map_shared_rank(halo + hs + W * sm, rank - 1);
          if (rank < K - 1) below = cg::this_cluster().map_shared_rank(halo + hs, rank + 1);
        }
        // pointwise -> round (the stream starts at y)
        gemm<NW, false>(mv, mid, k == 0 ? ycol : scol, sm, mats + lo[0], mid, nullptr,
                        0, nullptr, 0,
                        [&](int row, int col, float v0, float v1, float, float) {
                          const float a = v0 + pwb[col], b = v1 + pwb[col + 1];
                          store2(ucol + row * sm + col, a, b);
                          if constexpr (K > 1) {
                            if (row < W && above) store2(above + row * sm + col, a, b);
                            if (row >= B - W && below)
                              store2(below + (row - (B - W)) * sm + col, a, b);
                          }
                        });
        band_sync<K>();
        stencil<T, B, W, NT, K>(ucol, scol, sm, mid, vecs + lo[2], vecs + lo[3],
                             halo + hs, rank);
        __syncthreads();
      }

      // the gate: per channel, the mean over the crop (a warp per
      // channel: lanes, then shuffles, in a fixed order; in a cluster each
      // band's sum goes to every band, lane j's to rank j) -> round
      for (int m = warp; m < mid; m += NW) {
        float v = 0.0f;
        for (int q = lane; q < B; q += 32) v = v + to_f<T>(scol[q * sm + m]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
        if constexpr (K > 1) {
          if (lane < K) cg::this_cluster().map_shared_rank(gpart, lane)[rank * mid + m] = v;
        } else {
          if (lane == 0) gmean[m] = round_t<T>(v / (float)P);
        }
      }
      band_sync<K>();
      // one warp: (in a cluster, the mean from the bands' sums in rank
      // order) the hidden layer (lanes over the channels, then shuffles)
      // -> relu -> round, then the gate -> sigmoid -> round
      if (warp == 0) {
        if constexpr (K > 1) {
          for (int c = lane; c < mid; c += 32) {
            float v = 0.0f;
#pragma unroll
            for (int j = 0; j < K; ++j) v = v + gpart[j * mid + c];
            gmean[c] = round_t<T>(v / (float)P);
          }
          __syncwarp();
        }
        const T* g1 = mats + bo[kG1];
        const float* g1b = vecs + bo[kG1b];
        const T* g2 = mats + bo[kG2];
        const float* g2b = vecs + bo[kG2b];
        float hid[kMaxHidden];
#pragma unroll
        for (int j = 0; j < kMaxHidden; ++j) {
          if (j < R) {
            float a = 0.0f;
            for (int c = lane; c < mid; c += 32)
              a = a + to_f<T>(g1[j * mid + c]) * gmean[c];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) a = a + __shfl_xor_sync(0xffffffffu, a, o);
            hid[j] = round_t<T>(fmaxf(a + g1b[j], 0.0f));
          }
        }
        for (int m = lane; m < mid; m += 32) {
          float z = 0.0f;
#pragma unroll
          for (int j = 0; j < kMaxHidden; ++j)
            if (j < R) z = z + to_f<T>(g2[m * R + j]) * hid[j];
          z = z + g2b[m];
          gval[m] = round_t<T>(1.0f / (1.0f + expf(-z)));
        }
      }
      __syncthreads();
      // s * g -> round, summed into the aggregate -> round (the first
      // stream's gs is the aggregate itself)
      for_pairs<NT>(mv, n2, [&](int row, int c) {
        const float* gv = gval + c;
        const float2 s = load2(scol + row * sm + c);
        const float gs0 = round_t<T>(s.x * gv[0]), gs1 = round_t<T>(s.y * gv[1]);
        if (t == 0) {
          store2(acol + row * sm + c, gs0, gs1);
        } else {
          const float2 a = load2(acol + row * sm + c);
          store2(acol + row * sm + c, a.x + gs0, a.y + gs1);
        }
      });
      // the next stream's pointwise conv reads y and writes u, which this
      // pass does not touch; its stencil writes s after a barrier
    }
    __syncthreads();

    // conv3 + residual (down, or the input itself) -> relu -> round, into
    // XA; block b works in place, each value read and written by one thread
    // (only block a has a down conv: its input and output widths differ)
    {
      const float* b3 = vecs + bo[kB3];
      const int wd_off = bo[kWd];
      if (kSplitDown && wd_off >= 0) {
        // the down conv + its bias first, stored into XA (exact: XA holds
        // float32), then conv3 adds it as the residual, as the identity
        // residual below: the roundings of one dual pass with half its
        // accumulators live
        const float* bd = vecs + bo[kBd];
        gemm<NW, false>(mv, c_out, src, ssrc, mats + wd_off, cin, nullptr, 0, nullptr, 0,
                        [&](int row, int col, float d0, float d1, float, float) {
                          store2(xa + row * sxa + col, d0 + bd[col], d1 + bd[col + 1]);
                        });
        gemm<NW, false>(mv, c_out, acol, sm, mats + bo[kW3], mid, nullptr, 0, nullptr, 0,
                        [&](int row, int col, float v0, float v1, float, float) {
                          const float2 r = load2(xa + row * sxa + col);
                          store2(xa + row * sxa + col, fmaxf((v0 + b3[col]) + r.x, 0.0f),
                                 fmaxf((v1 + b3[col + 1]) + r.y, 0.0f));
                        });
      } else if (wd_off >= 0) {
        const float* bd = vecs + bo[kBd];
        gemm<NW, true>(mv, c_out, acol, sm, mats + bo[kW3], mid, src, ssrc,
                       mats + wd_off, cin,
                       [&](int row, int col, float v0, float v1, float d0, float d1) {
                         store2(xa + row * sxa + col,
                                fmaxf((v0 + b3[col]) + (d0 + bd[col]), 0.0f),
                                fmaxf((v1 + b3[col + 1]) + (d1 + bd[col + 1]), 0.0f));
                       });
      } else {
        gemm<NW, false>(mv, c_out, acol, sm, mats + bo[kW3], mid, nullptr, 0, nullptr, 0,
                        [&](int row, int col, float v0, float v1, float, float) {
                          const float2 r = load2(src + row * ssrc + col);
                          store2(xa + row * sxa + col, fmaxf((v0 + b3[col]) + r.x, 0.0f),
                                 fmaxf((v1 + b3[col + 1]) + r.y, 0.0f));
                        });
      }
    }
    __syncthreads();
  }
  // (in a cluster, the last store into another block's shared memory, the
  // last gate's sums, came before the last cluster barrier: a block may
  // exit without waiting for the others)

  // the transition or conv5 -> relu -> round, into E over the dead input
  // columns; then the 2x2 mean or the global mean, in a fixed order
  {
    const float* eb = vecs + offs[kEpB];
    gemm<NW, false>(mv, c_out, xa, sxa, mats + offs[kEpW], c_out, nullptr, 0, nullptr, 0,
                    [&](int row, int col, float v0, float v1, float, float) {
                      store2(es + row * se + col, fmaxf(v0 + eb[col], 0.0f),
                             fmaxf(v1 + eb[col + 1], 0.0f));
                    });
  }
  __syncthreads();
  if (K == 1 && gap) {
    for (int co = tid; co < c_out; co += NT) {
      float sum = 0.0f;
      for (int q = 0; q < P; ++q) sum = sum + to_f<T>(es[q * se + co]);
      out[g * c_out + co] = from_f<T>(sum / (float)P);
    }
  } else {
    // the band's output rows: B / W is even, so its 2x2 windows are its own
    constexpr int w2 = W / 2, nq = B / 4;
    for (int e = tid; e < c_out * nq; e += NT) {
      const int q = e % nq, co = e / nq;
      const int top = (q / w2) * 2 * W + (q % w2) * 2;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sum = sum + to_f<T>(es[(top + (k >> 1) * W + (k & 1)) * se + co]);
      out[(g * c_out + co) * (nq * K) + rank * nq + q] = from_f<T>(sum * 0.25f);
    }
  }
}

// launches `kernel` as G clusters of k blocks of nt threads, a crop a
// cluster, each block with `bytes` of dynamic shared memory
template <typename T>
int launch_clusters(void (*kernel)(const T*, const T*, const float*, const int32_t*, T*),
                    int k, int nt, long long bytes, const void* x, const void* mats,
                    const void* vecs, const void* offs, void* out, int G,
                    cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G * k);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(mats),
                           static_cast<const float*>(vecs),
                           static_cast<const int32_t*>(offs), static_cast<T*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
