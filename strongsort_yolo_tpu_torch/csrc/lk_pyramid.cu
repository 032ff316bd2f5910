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
// Layout: prev and cur are (N, sum_l h_l * w_l) float32, level l of pair n
// at n * total + off_l, finest level first; params_in/out (N, 6) float32,
// (a11, a12, tx, a21, a22, ty) normalised by the level's w / 2.
//
// Design: one thread block per pair walks every level (coarsest first) and
// iteration. An iteration is two passes over the level's pixels: the
// first sums |e| * valid and valid for the trimming threshold, the second
// recomputes each pixel's values and sums the 27 normal-equation terms.
// Each thread accumulates its pixels in a fixed order; a warp reduces with
// shuffles in a fixed order, and one thread per sum adds the warp partials
// in order, so the same input gives bit-identical params on every launch
// (no atomics). Thread 0 solves the 6x6 system and broadcasts the new
// params through shared memory.
//
// Bound: 15 dependent iterations per pair (8, 5 and 2 at the coarse,
// middle and fine level), each with two block-wide reductions and one
// serial solve, and every pixel's twelve tap loads and arithmetic run on
// one SM alone: latency and a single SM's instruction rate, not bytes. With
// one block per pair, S = 8 streams use 8 of the card's 132 SMs, and N = 8
// and N = 32 pairs take the same time. Splitting a pair across a cluster
// of blocks is left for later.
//
// Arithmetic order follows the plain version (ops/cuda/lk_kernel.py) and
// the TPU kernel expression by expression; the build passes -fmad=false, so
// no multiply-add is contracted. Sums are taken in another order than the
// plain version's, so the two agree to a tolerance (a pixel can cross the
// trimming threshold), not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 3;
// largest translation a level samples, level pixels (MAX_SHIFT of the
// wrapper; the TPU kernel's m)
constexpr float kMaxShift = 32.0f;
constexpr int kSums = 27;  // 21 of H (lower triangle, row major) + 6 of g

struct LkLevels {
  int n;
  int total;  // floats per pair over all levels
  int h[kMaxLevels];
  int w[kMaxLevels];
  int iters[kMaxLevels];
  int off[kMaxLevels];
};

// Sum v[0..K) over the block in a fixed order; every thread gets the
// totals in out[0..K). partial holds kWarps * K floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* partial,
                                          float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) partial[warp * K + k] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float t = partial[threadIdx.x];
    for (int q = 1; q < kWarps; ++q) t += partial[q * K + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// The per-pixel quantities of one iteration.
struct Pix {
  float e, ixw, iyw, valid, gxn, gyn;
};

struct Step {
  float a11m1, a12, a21, a22m1;  // a11 - 1, a12, a21, a22 - 1
  float txp, typ, fx, fy, omfx, omfy;
  int kx, ky;
};

__device__ __forceinline__ Pix pixel(const float* __restrict__ P,
                                     const float* __restrict__ C, int h, int w,
                                     int i, int j, const Step& st, float s,
                                     float half_s, float cx, float cy,
                                     float hi_x, float hi_y) {
  // tap rows and columns, clamped into the plane
  int r[4], c[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    r[d] = min(max(i + st.ky + d - 1, 0), h - 1);
    c[d] = min(max(j + st.kx + d - 1, 0), w - 1);
  }
  // T(dy, dx) = cur[i + ky + dy, j + kx + dx]; index d = dy + 1
#define T(dy, dx) __ldg(C + r[(dy) + 1] * w + c[(dx) + 1])
  const float t_m1_0 = T(-1, 0), t_m1_1 = T(-1, 1);
  const float t0_m1 = T(0, -1), t0_0 = T(0, 0), t0_1 = T(0, 1), t0_2 = T(0, 2);
  const float t1_m1 = T(1, -1), t1_0 = T(1, 0), t1_1 = T(1, 1), t1_2 = T(1, 2);
  const float t2_0 = T(2, 0), t2_1 = T(2, 1);
#undef T
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
  const float fxj = (float)j, fyi = (float)i;
  const float sx = fxj + st.txp, sy = fyi + st.typ;
  p.valid = (sx >= 1.0f && sx <= hi_x && sy >= 1.0f && sy <= hi_y) ? 1.0f : 0.0f;
  p.gxn = (fxj - cx) / s;
  p.gyn = (fyi - cy) / s;
  p.e = ((b00 - __ldg(P + i * w + j)) +
         (st.a11m1 * p.gxn + st.a12 * p.gyn) * p.ixw) +
        (st.a21 * p.gxn + st.a22m1 * p.gyn) * p.iyw;
  return p;
}

// (H + damp I) x = g by the unrolled Cholesky of the TPU kernel's _solve6;
// hs: the 21 lower-triangle sums, row major; g: 6 sums.
__device__ void solve6(const float* hs, const float* g, float* x) {
  float a[6][6];
  int q = 0;
  for (int i = 0; i < 6; ++i)
    for (int k = 0; k <= i; ++k, ++q) a[i][k] = a[k][i] = hs[q];
  const float trace = a[0][0] + a[1][1] + a[2][2] + a[3][3] + a[4][4] + a[5][5];
  const float damp = 1e-4f * trace / 6.0f + 1e-6f;
  for (int i = 0; i < 6; ++i) a[i][i] = a[i][i] + damp;
  float l[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = a[i][j];
      for (int k = 0; k < j; ++k) s = s - l[i][k] * l[j][k];
      if (i == j) {
        l[i][j] = sqrtf(s >= 1e-20f || s != s ? s : 1e-20f);
      } else {
        l[i][j] = s / l[j][j];
      }
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s = s - l[i][k] * y[k];
    y[i] = s / l[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - l[k][i] * x[k];
    x[i] = s / l[i][i];
  }
}

__global__ void __launch_bounds__(kThreads)
    lk_pyramid_kernel(const float* __restrict__ prev,
                      const float* __restrict__ cur,
                      const float* __restrict__ params_in,
                      float* __restrict__ params_out, LkLevels lv) {
  __shared__ float sp[6];
  __shared__ float part2[kWarps * 2];
  __shared__ float tot2[2];
  __shared__ float part27[kWarps * kSums];
  __shared__ float tot27[kSums];
  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 6) sp[tid] = params_in[(int64_t)pair * 6 + tid];

  for (int lvl = lv.n - 1; lvl >= 0; --lvl) {
    const int h = lv.h[lvl], w = lv.w[lvl], hw = h * w;
    const float* P = prev + (int64_t)pair * lv.total + lv.off[lvl];
    const float* C = cur + (int64_t)pair * lv.total + lv.off[lvl];
    const float s = (float)(w / 2.0);
    const float half_s = 0.5f * s;
    const float cx = (float)((w - 1) / 2.0), cy = (float)((h - 1) / 2.0);
    const float hi_x = (float)(w - 2.001), hi_y = (float)(h - 2.001);
    for (int it = 0; it < lv.iters[lvl]; ++it) {
      __syncthreads();  // sp holds this iteration's params
      Step st;
      const float a11 = sp[0], a12 = sp[1], tx = sp[2];
      const float a21 = sp[3], a22 = sp[4], ty = sp[5];
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

      // pass 1: the trimming threshold
      float v2[2] = {0.0f, 0.0f};
      for (int q = tid; q < hw; q += kThreads) {
        const Pix p = pixel(P, C, h, w, q / w, q % w, st, s, half_s, cx, cy,
                            hi_x, hi_y);
        v2[0] += fabsf(p.e) * p.valid;
        v2[1] += p.valid;
      }
      block_sum<2>(v2, part2, tot2);
      const float thr = fmaxf(3.0f * tot2[0] / (tot2[1] + 1.0f), 40.0f);

      // pass 2: the normal equations
      float v[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
      for (int q = tid; q < hw; q += kThreads) {
        const Pix p = pixel(P, C, h, w, q / w, q % w, st, s, half_s, cx, cy,
                            hi_x, hi_y);
        const float wgt = fabsf(p.e) < thr ? p.valid : 0.0f;
        const float js[6] = {p.gxn * p.ixw, p.gyn * p.ixw, p.ixw,
                             p.gxn * p.iyw, p.gyn * p.iyw, p.iyw};
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b, ++k) v[k] += js[a] * js[b] * wgt;
        }
        const float ew = p.e * wgt;
#pragma unroll
        for (int a = 0; a < 6; ++a) v[21 + a] += js[a] * ew;
      }
      block_sum<kSums>(v, part27, tot27);
      if (tid == 0) {
        float d[6];
        solve6(tot27, tot27 + 21, d);
        sp[0] = a11 - d[0];
        sp[1] = a12 - d[1];
        sp[2] = tx - d[2];
        sp[3] = a21 - d[3];
        sp[4] = a22 - d[4];
        sp[5] = ty - d[5];
      }
    }
  }
  __syncthreads();
  if (tid < 6) params_out[(int64_t)pair * 6 + tid] = sp[tid];
}

}  // namespace

// dims: 3 ints per level, finest first: h, w, iterations.
extern "C" int ssyt_lk_pyramid(const void* prev, const void* cur,
                               const void* params_in, void* params_out,
                               int n_pairs, int n_levels, const int* dims,
                               void* stream) {
  if (n_pairs == 0) return 0;
  if (n_pairs < 0 || n_levels < 1 || n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  LkLevels lv;
  lv.n = n_levels;
  int64_t total = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = dims[3 * l];
    lv.w[l] = dims[3 * l + 1];
    lv.iters[l] = dims[3 * l + 2];
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.iters[l] < 0)
      return (int)cudaErrorInvalidValue;
    lv.off[l] = (int)total;
    total += (int64_t)lv.h[l] * lv.w[l];
  }
  if (total > (int64_t)1 << 30) return (int)cudaErrorInvalidValue;
  lv.total = (int)total;
  lk_pyramid_kernel<<<n_pairs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur),
      static_cast<const float*>(params_in), static_cast<float*>(params_out), lv);
  return (int)cudaGetLastError();
}
