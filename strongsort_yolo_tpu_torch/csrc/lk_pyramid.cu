// K5: dense pyramidal Lucas-Kanade estimate of a global affine, coarse to
// fine, for N (previous, current) gray pyramids in one launch.
//
// Replaces strongsort_yolo_tpu/ops/pallas/lk_kernel.py: lk_pyramid_pallas
// (all levels in one call, body _lk_pyramid_kernel) and lk_level_pallas
// (one level, body _lk_kernel); both run _refine_level. Per Gauss-Newton
// iteration and pixel: the current plane translated by the integer part of
// the translation (kx, ky) and blended bilinearly with its fraction; the
// gradients as centred differences of the blended taps times 0.5 * s; the
// validity mask [1, w - 2.001] on the shifted coordinate; the residual
// e = ct - prev + (linear part, linearised); trimming at
// max(3 * sum|e|valid / (sum valid + 1), 40); then 21 + 6 sums of the
// normal equations, Levenberg damping 1e-4 * trace / 6 + 1e-6 and an
// unrolled 6x6 Cholesky with a 1e-20 floor.
//
// The TPU kernel holds one level's padded planes in VMEM and shifts them
// with rotates; a wrapped row lands where the mask is zero. Here each
// thread reads its taps from global memory (the planes, 2 x 302 KB per
// pair for three levels, stay in L1/L2) at clamped indices, so nothing
// needs padding: for a valid pixel every tap row i + ky + dy (dy in -1..2)
// already lies in [0, h - 1], because the mask holds floor(i + typ) in
// [1, h - 3]; a masked pixel reads the clamped edge and is multiplied by
// weight 0 (a clamp, never an out-of-range read that could bring in a
// non-finite value).
//
// Layout: the level planes as they are, up to three of prev and three of
// cur, finest first, each (N, h_l, w_l) float32 with unit column stride,
// its own pair and row strides (nothing is packed or copied);
// params_in/out (N, 6) float32, (a11, a12, tx, a21, a22, ty) normalised by
// the level's w / 2.
//
// Design: a thread block cluster of kCluster = 7 blocks of 256 threads per
// pair, launched with cudaLaunchKernelEx, so S = 8 pairs run on 56 SMs.
// Block `rank` takes rows [h * rank / 7, h * (rank + 1) / 7) of every
// level: the split depends on the level's shape alone, never on N, so a
// pair's result is the same bit for bit in any batch. Each Gauss-Newton
// step walks the band once in pass 1, row by row and column by column
// (the thread's row and column advance by fixed steps, no division per
// pixel), computing each pixel's twelve taps (one row pointer and fixed
// offsets where the 4 x 4 window lies inside the plane, clamped indices
// near an edge), blend, gradients and residual, and keeps e, ixw and iyw
// in dynamic shared memory (12 bytes a pixel: 98 KB for a 26 x 320 band
// of the finest level); the mask is recomputed from the coordinates, and
// the centred coordinates (j - cx) / s and (i - cy) / s are tables filled
// once per level. Pass 2 reads the pixels back instead of recomputing the
// taps. Every sum is taken in a fixed order: each thread over its pixels
// in order, then each warp's 32 values in lane order and the block's warps
// in order (through a padded shared array, free of bank conflicts; pass
// 2's sums reuse the pixel store's room), then each block pushes its
// totals into every cluster block's slot for its rank through distributed
// shared memory (two slot sets, alternating between reductions, so one
// cluster barrier per reduction is enough), and every block adds the
// ranks' totals in rank order and solves the 6x6 system itself: all seven
// hold the same params without a broadcast, and launches are bit-identical
// (no atomics).
//
// Why 7 blocks of 256 threads, not the 8 of 512 first tried: a block needs
// ~106 KB of shared memory, so two fit an SM, and the card's GPCs (whose
// SMs a cluster must share) hold 32 clusters of 7 at once but only 30 of
// 8 (cudaOccupancyMaxActiveClusters); with 8, N = 32 pairs ran in two
// waves and took 2.3x the time of N = 8, with 7 they run in one. 256
// threads keep every value in registers (up to 128 a thread at two blocks
// an SM; 512 threads spilled at 64) and halve the warps each reduction
// waits for.
//
// Bound: 15 dependent steps per pair (8, 5 and 2 at the coarse, middle
// and fine level), each with two block reductions, two cluster barriers
// and a serial 6x6 solve, ~5 us a step where a band is a few hundred
// pixels; at the fine level the ~280 instructions a pixel of the two
// passes over a 26 x 320 band on one SM, ~20 us a step. Not bytes: the
// planes are read from L1/L2.
//
// Arithmetic order follows the plain version (ops/cuda/lk_kernel.py) and
// the TPU kernel expression by expression; the build passes -fmad=false, so
// no multiply-add is contracted. Sums are taken in another order than the
// plain version's, so the two agree to a tolerance (a pixel can cross the
// trimming threshold), not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 3;
constexpr int kCluster = 7;  // blocks per pair
// largest translation a level samples, level pixels (MAX_SHIFT of the
// wrapper; the TPU kernel's m)
constexpr float kMaxShift = 32.0f;
constexpr int kSums = 27;  // 21 of H (lower triangle, row major) + 6 of g
constexpr long long kMaxSmem = 227 * 1024;

struct LkLevel {
  const float* prev;
  const float* cur;
  long long prev_pair, cur_pair;  // strides in floats
  int prev_row, cur_row;
  int h, w, iters;
};

struct LkArgs {
  LkLevel lv[kMaxLevels];
  int n;      // levels
  int wmax;   // widest level
  int rmax;   // most rows of a band
  int cap;    // most pixels of a band
  int store;  // floats of the pixel store, which pass 2's sums reuse
};

constexpr int kLaneStride = 33;  // a warp's 32 values, padded by one
constexpr int kRedStride = kWarps * kLaneStride;  // one sum's thread values
static_assert(kSums * kWarps <= kThreads, "a thread per warp and sum");

// The fixed part of the shared memory; the pixel store and the coordinate
// tables follow it.
struct __align__(16) Fixed {
  float red2[2 * kRedStride];        // pass 1's two values of each thread
  float partial[kWarps * kSums];     // warp totals, [warp][sum]
  float slots[2][kCluster][kSums];  // the cluster's block totals by rank
  float tot[kSums];
  float sp[6];
};

__host__ __device__ inline int band_rows_max(int h) {
  return (h + kCluster - 1) / kCluster;
}

// Sum v[0..K) over the block in a fixed order (each warp's 32 values in
// lane order, then the warps in order) and push the block's totals into
// slot set `buf`, at this block's rank, of every block of the cluster;
// returns after the cluster barrier, when every rank's totals are in.
// red: K * kRedStride floats of scratch (thread t's value k at
// red[k * kRedStride + (t / 32) * 33 + t % 32], so the writes and the
// lane-order reads are free of bank conflicts).
template <int K>
__device__ __forceinline__ void cluster_push(const float (&v)[K], float* red,
                                             Fixed& f, int buf,
                                             cg::cluster_group& cluster,
                                             int rank) {
  const int t = threadIdx.x;
  const int slot = (t >> 5) * kLaneStride + (t & 31);
#pragma unroll
  for (int k = 0; k < K; ++k) red[k * kRedStride + slot] = v[k];
  __syncthreads();
  if (t < K * kWarps) {  // warp g's values of sum k
    const int k = t / kWarps, g = t % kWarps;
    const float* r = red + k * kRedStride + g * kLaneStride;
    float x = r[0];
#pragma unroll
    for (int l = 1; l < 32; ++l) x += r[l];
    f.partial[g * K + k] = x;
  }
  __syncthreads();
  if (t < K) {
    float x = f.partial[t];
    for (int g = 1; g < kWarps; ++g) x += f.partial[g * K + t];
    for (int r = 0; r < kCluster; ++r)
      cluster.map_shared_rank(&f.slots[buf][rank][0], r)[t] = x;
  }
  cluster.sync();
}

// The cluster's total of sum k in slot set `buf`: the ranks in order.
__device__ __forceinline__ float cluster_total(const Fixed& f, int buf,
                                               int k) {
  float x = f.slots[buf][0][k];
  for (int r = 1; r < kCluster; ++r) x += f.slots[buf][r][k];
  return x;
}

struct Step {
  float a11m1, a12, a21, a22m1;  // a11 - 1, a12, a21, a22 - 1
  float txp, typ, fx, fy, omfx, omfy;
  int kx, ky;
};

// The validity mask of pixel (i, j): its shifted coordinate in
// [1, w - 2.001] x [1, h - 2.001].
__device__ __forceinline__ float valid_at(int i, int j, const Step& st,
                                          float hi_x, float hi_y) {
  const float sx = (float)j + st.txp, sy = (float)i + st.typ;
  return (sx >= 1.0f && sx <= hi_x && sy >= 1.0f && sy <= hi_y) ? 1.0f : 0.0f;
}

// The per-pixel quantities of one iteration.
struct Pix {
  float e, ixw, iyw, valid;
};

__device__ __forceinline__ Pix pixel(const float* __restrict__ P, int rsp,
                                     const float* __restrict__ C, int rsc,
                                     int h, int w, int i, int j,
                                     const Step& st, float half_s, float gxn,
                                     float gyn, float hi_x, float hi_y) {
  // the taps T(dy, dx) = cur[i + ky + dy, j + kx + dx], dy, dx in -1..2
  float t_m1_0, t_m1_1, t0_m1, t0_0, t0_1, t0_2, t1_m1, t1_0, t1_1, t1_2, t2_0,
      t2_1;
  const int y0 = i + st.ky - 1, x0 = j + st.kx - 1;
  if (y0 >= 0 && y0 + 3 < h && x0 >= 0 && x0 + 3 < w) {
    // the 4 x 4 window lies in the plane: one row pointer, fixed offsets
    const float* q = C + y0 * rsc + x0;
    t_m1_0 = __ldg(q + 1);
    t_m1_1 = __ldg(q + 2);
    q += rsc;
    t0_m1 = __ldg(q);
    t0_0 = __ldg(q + 1);
    t0_1 = __ldg(q + 2);
    t0_2 = __ldg(q + 3);
    q += rsc;
    t1_m1 = __ldg(q);
    t1_0 = __ldg(q + 1);
    t1_1 = __ldg(q + 2);
    t1_2 = __ldg(q + 3);
    q += rsc;
    t2_0 = __ldg(q + 1);
    t2_1 = __ldg(q + 2);
  } else {
    // near an edge: rows and columns clamped into the plane
    int r[4], c[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      r[d] = min(max(y0 + d, 0), h - 1) * rsc;
      c[d] = min(max(x0 + d, 0), w - 1);
    }
#define T(dy, dx) __ldg(C + r[(dy) + 1] + c[(dx) + 1])
    t_m1_0 = T(-1, 0);
    t_m1_1 = T(-1, 1);
    t0_m1 = T(0, -1);
    t0_0 = T(0, 0);
    t0_1 = T(0, 1);
    t0_2 = T(0, 2);
    t1_m1 = T(1, -1);
    t1_0 = T(1, 0);
    t1_1 = T(1, 1);
    t1_2 = T(1, 2);
    t2_0 = T(2, 0);
    t2_1 = T(2, 1);
#undef T
  }
  const float omfx = st.omfx, fx = st.fx, omfy = st.omfy, fy = st.fy;
  // blend(dy, dx) = (1-fy)((1-fx)T(dy,dx) + fx T(dy,dx+1))
  //                 + fy((1-fx)T(dy+1,dx) + fx T(dy+1,dx+1))
  const float b00 = omfy * (omfx * t0_0 + fx * t0_1) + fy * (omfx * t1_0 + fx * t1_1);
  const float b01 = omfy * (omfx * t0_1 + fx * t0_2) + fy * (omfx * t1_1 + fx * t1_2);
  const float b0m = omfy * (omfx * t0_m1 + fx * t0_0) + fy * (omfx * t1_m1 + fx * t1_0);
  const float b10 = omfy * (omfx * t1_0 + fx * t1_1) + fy * (omfx * t2_0 + fx * t2_1);
  const float bm0 = omfy * (omfx * t_m1_0 + fx * t_m1_1) + fy * (omfx * t0_0 + fx * t0_1);
  Pix p;
  p.ixw = (b01 - b0m) * half_s;
  p.iyw = (b10 - bm0) * half_s;
  p.valid = valid_at(i, j, st, hi_x, hi_y);
  p.e = ((b00 - __ldg(P + i * rsp + j)) +
         (st.a11m1 * gxn + st.a12 * gyn) * p.ixw) +
        (st.a21 * gxn + st.a22m1 * gyn) * p.iyw;
  return p;
}

// (H + damp I) x = g by the unrolled Cholesky of the TPU kernel's _solve6;
// hs: the 21 lower-triangle sums, row major; g: 6 sums. The factor
// overwrites the lower triangle in place (m[i * (i + 1) / 2 + j] holds
// H[i][j], then L[i][j]), so the solve lives in few registers.
__device__ __forceinline__ void solve6(const float* hs, const float* g,
                                       float* x) {
  float m[21];
#pragma unroll
  for (int q = 0; q < 21; ++q) m[q] = hs[q];
  const float trace = m[0] + m[2] + m[5] + m[9] + m[14] + m[20];
  const float damp = 1e-4f * trace / 6.0f + 1e-6f;
#pragma unroll
  for (int i = 0; i < 6; ++i) m[i * (i + 1) / 2 + i] = m[i * (i + 1) / 2 + i] + damp;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = m[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k)
        s = s - m[i * (i + 1) / 2 + k] * m[j * (j + 1) / 2 + k];
      if (i == j) {
        m[i * (i + 1) / 2 + j] = sqrtf(s >= 1e-20f || s != s ? s : 1e-20f);
      } else {
        m[i * (i + 1) / 2 + j] = s / m[j * (j + 1) / 2 + j];
      }
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - m[i * (i + 1) / 2 + k] * y[k];
    y[i] = s / m[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - m[k * (k + 1) / 2 + i] * x[k];
    x[i] = s / m[i * (i + 1) / 2 + i];
  }
}

// The pixel store, in floats: e, ixw and iyw of a band, and at least the
// room pass 2's sums take.
__host__ __device__ inline int store_floats(int cap) {
  return 3 * cap > kSums * kRedStride ? 3 * cap : kSums * kRedStride;
}

__host__ __device__ inline long long smem_bytes(const LkArgs& a) {
  return (long long)sizeof(Fixed) + 4LL * (a.store + a.wmax + a.rmax);
}

__global__ void __launch_bounds__(kThreads, 2)
    lk_pyramid_kernel(const LkArgs a, const float* __restrict__ params_in,
                      float* __restrict__ params_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Fixed& f = *reinterpret_cast<Fixed*>(smem);
  float* const se = reinterpret_cast<float*>(smem + sizeof(Fixed));
  float* const sx = se + a.cap;
  float* const sy = sx + a.cap;
  float* const gxt = se + a.store;  // (j - cx) / s by column
  float* const gyt = gxt + a.wmax;  // (i - cy) / s by row of the band

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t pair = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  int buf = 0;
  if (tid < 6) f.sp[tid] = params_in[pair * 6 + tid];
  cluster.sync();  // every block runs before any pushes into its slots

  for (int lvl = a.n - 1; lvl >= 0; --lvl) {
    const LkLevel& L = a.lv[lvl];
    const int h = L.h, w = L.w;
    const int r0 = h * rank / kCluster, r1 = h * (rank + 1) / kCluster;
    const int npx = (r1 - r0) * w;
    const float* P = L.prev + pair * L.prev_pair;
    const float* C = L.cur + pair * L.cur_pair;
    const float s = (float)(w / 2.0);
    const float half_s = 0.5f * s;
    const float cx = (float)((w - 1) / 2.0), cy = (float)((h - 1) / 2.0);
    const float hi_x = (float)(w - 2.001), hi_y = (float)(h - 2.001);
    // the tables are read after the barrier that opens each step; the
    // last step of the level before has passed its cluster barriers
    for (int j = tid; j < w; j += kThreads) gxt[j] = ((float)j - cx) / s;
    for (int r = tid; r < r1 - r0; r += kThreads)
      gyt[r] = ((float)(r0 + r) - cy) / s;
    // the thread's first pixel of the band, and its step: kThreads pixels
    const int i_first = tid / w, j_first = tid - i_first * w;
    const int i_step = kThreads / w, j_step = kThreads - i_step * w;

    for (int it = 0; it < L.iters; ++it) {
      __syncthreads();  // sp and the tables hold this step's values
      Step st;
      const float a11 = f.sp[0], a12 = f.sp[1], tx = f.sp[2];
      const float a21 = f.sp[3], a22 = f.sp[4], ty = f.sp[5];
      st.a11m1 = a11 - 1.0f;
      st.a12 = a12;
      st.a21 = a21;
      st.a22m1 = a22 - 1.0f;
      // clip(s * t, -m, m); a NaN translation (degenerate input) clamps to
      // -m here, which keeps every index inside the plane
      st.txp = fminf(fmaxf(s * tx, -kMaxShift), kMaxShift);
      st.typ = fminf(fmaxf(s * ty, -kMaxShift), kMaxShift);
      const float kxf = floorf(st.txp), kyf = floorf(st.typ);
      st.fx = st.txp - kxf;
      st.fy = st.typ - kyf;
      st.omfx = 1.0f - st.fx;
      st.omfy = 1.0f - st.fy;
      st.kx = (int)kxf;
      st.ky = (int)kyf;

      // pass 1: every pixel of the band once, kept; the trimming threshold
      float v2[2] = {0.0f, 0.0f};
      int i = i_first, j = j_first;
      for (int q = tid; q < npx; q += kThreads) {
        const Pix p = pixel(P, L.prev_row, C, L.cur_row, h, w, r0 + i, j, st,
                            half_s, gxt[j], gyt[i], hi_x, hi_y);
        v2[0] += fabsf(p.e) * p.valid;
        v2[1] += p.valid;
        se[q] = p.e;
        sx[q] = p.ixw;
        sy[q] = p.iyw;
        i += i_step;
        j += j_step;
        if (j >= w) {
          j -= w;
          ++i;
        }
      }
      cluster_push<2>(v2, f.red2, f, buf, cluster, rank);
      const float thr = fmaxf(
          3.0f * cluster_total(f, buf, 0) / (cluster_total(f, buf, 1) + 1.0f),
          40.0f);
      buf ^= 1;

      // pass 2: the normal equations from the kept pixels (each thread
      // reads back what it wrote)
      float v[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
      i = i_first;
      j = j_first;
      for (int q = tid; q < npx; q += kThreads) {
        const float e = se[q], ixw = sx[q], iyw = sy[q];
        const float gxn = gxt[j], gyn = gyt[i];
        const float wgt =
            fabsf(e) < thr ? valid_at(r0 + i, j, st, hi_x, hi_y) : 0.0f;
        const float js[6] = {gxn * ixw, gyn * ixw, ixw,
                             gxn * iyw, gyn * iyw, iyw};
        int k = 0;
#pragma unroll
        for (int b = 0; b < 6; ++b) {
#pragma unroll
          for (int c = 0; c <= b; ++c, ++k) v[k] += js[b] * js[c] * wgt;
        }
        const float ew = e * wgt;
#pragma unroll
        for (int b = 0; b < 6; ++b) v[21 + b] += js[b] * ew;
        i += i_step;
        j += j_step;
        if (j >= w) {
          j -= w;
          ++i;
        }
      }
      __syncthreads();  // the pixel store is read; its room takes the sums
      cluster_push<kSums>(v, se, f, buf, cluster, rank);
      if (tid < 32) {  // warp 0 totals the sums; lane 0 solves
        if (tid < kSums) f.tot[tid] = cluster_total(f, buf, tid);
        __syncwarp();
        if (tid == 0) {
          float d[6];
          solve6(f.tot, f.tot + 21, d);
          f.sp[0] = a11 - d[0];
          f.sp[1] = a12 - d[1];
          f.sp[2] = tx - d[2];
          f.sp[3] = a21 - d[3];
          f.sp[4] = a22 - d[4];
          f.sp[5] = ty - d[5];
        }
      }
      buf ^= 1;
    }
  }
  __syncthreads();
  if (rank == 0 && tid < 6) params_out[pair * 6 + tid] = f.sp[tid];
}

// dims: 3 ints per level, finest first: h, w, iterations. -> the launch's
// layout, or false if a dimension is out of range.
bool layout(int n_levels, const int* dims, LkArgs& a) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  a.n = n_levels;
  a.wmax = a.rmax = a.cap = 0;
  for (int l = 0; l < n_levels; ++l) {
    LkLevel& L = a.lv[l];
    L.h = dims[3 * l];
    L.w = dims[3 * l + 1];
    L.iters = dims[3 * l + 2];
    if (L.h < 1 || L.w < 1 || L.iters < 0 || L.h > (1 << 24) ||
        L.w > (1 << 24))
      return false;
    const int rows = band_rows_max(L.h);
    if ((long long)rows * L.w > (1 << 24)) return false;
    a.wmax = L.w > a.wmax ? L.w : a.wmax;
    a.rmax = rows > a.rmax ? rows : a.rmax;
    a.cap = rows * L.w > a.cap ? rows * L.w : a.cap;
  }
  a.store = store_floats(a.cap);
  return true;
}

// A launch of one cluster of kCluster blocks per pair.
cudaLaunchConfig_t launch_config(int n_pairs, long long bytes,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * n_pairs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Shared memory one block of the launch needs, in bytes (-1 for dims out
// of range); the launch needs it within 227 KB.
extern "C" long long ssyt_lk_pyramid_smem_bytes(int n_levels,
                                                const int* dims) {
  LkArgs a;
  if (!layout(n_levels, dims, a)) return -1;
  return smem_bytes(a);
}

// prev, cur: n_levels plane pointers each, finest first; strides: 4 per
// level, in floats: prev pair, prev row, cur pair, cur row.
extern "C" int ssyt_lk_pyramid(const void* const* prev, const void* const* cur,
                               const long long* strides, const void* params_in,
                               void* params_out, int n_pairs, int n_levels,
                               const int* dims, void* stream) {
  if (n_pairs == 0) return 0;
  LkArgs a;
  if (n_pairs < 0 || n_pairs > (1 << 26) || !layout(n_levels, dims, a))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_levels; ++l) {
    LkLevel& L = a.lv[l];
    L.prev = static_cast<const float*>(prev[l]);
    L.cur = static_cast<const float*>(cur[l]);
    L.prev_pair = strides[4 * l];
    L.prev_row = (int)strides[4 * l + 1];
    L.cur_pair = strides[4 * l + 2];
    L.cur_row = (int)strides[4 * l + 3];
    if (strides[4 * l + 1] != L.prev_row || strides[4 * l + 3] != L.cur_row ||
        (long long)L.prev_row * (L.h - 1) + L.w > 0x7fffffffLL ||
        (long long)L.cur_row * (L.h - 1) + L.w > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  }
  const long long bytes = smem_bytes(a);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lk_pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      n_pairs, bytes, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, lk_pyramid_kernel, a,
                           static_cast<const float*>(params_in),
                           static_cast<float*>(params_out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks per pair (the cluster's size), for the smoke test's report.
extern "C" int ssyt_lk_pyramid_cluster() { return kCluster; }

// How many pairs' clusters the card holds at once for these levels
// (cudaOccupancyMaxActiveClusters), or -1: a launch of more pairs runs in
// waves.
extern "C" int ssyt_lk_pyramid_max_clusters(int n_levels, const int* dims) {
  LkArgs a;
  if (!layout(n_levels, dims, a)) return -1;
  const long long bytes = smem_bytes(a);
  if (bytes > kMaxSmem ||
      cudaFuncSetAttribute(lk_pyramid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1024, bytes, nullptr, &attr);
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(&clusters, lk_pyramid_kernel, &cfg) !=
      cudaSuccess)
    return -1;
  return clusters;
}
