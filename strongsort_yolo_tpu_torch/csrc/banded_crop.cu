// K4: per-detection bilinear crop-resize from a frame pyramid.
//
// Replaces strongsort_yolo_tpu/ops/pallas/crop_kernel.py: banded_crop_planar
// (the fixed-width form, reached through banded_crop) and banded_crop_packed
// (G packed slots, each with its own source frame). Both share the body
// _tap_and_sample: per crop, two-tap interpolation weights
// max(0, 1 - |i - clip(pos, 0, len - 1)|), a column pass whose sums are
// rounded to the compute dtype, then a row pass rounded again.
//
// Layout: the pyramid of S frames is stacked vertically and planar,
// (S, C=3, sum h_l, w_0) in the compute dtype; level l starts at row
// row_off[l]. Per slot g: scal[g] = [y_base, y_step, x_base, x_step, h_l,
// w_l] (float32, ops/crops.banded_prep), ints[g, 2] = l, slot_frame[g] =
// source frame. Output (G, 3, oh, ow) in the compute dtype: OSNet's NCHW
// input.
//
// Bound: memory. At G = 480 slots it writes 23.6 MB of bf16 crops and
// reads the slots' source sectors, mostly from L2. The design keeps the
// TPU kernel's separable structure, with a block per (slot, tile of 16
// output rows, tile of 64 output columns):
// - the slot's scalars, level and frame are read once per block, the
//   three (frame, channel) plane bases are 64-bit once; no thread splits
//   a flat index by a runtime size (a 64-bit division is a software
//   routine of dozens of instructions);
// - the tile's column taps and row taps are computed once, into shared
//   memory (not once per output element);
// - the row taps name the source rows the tile reads; one warp keeps
//   each distinct one once (a small upsampled box reads each source row
//   for two or three output rows), and the column pass runs once per
//   distinct row: t[row][c][q] = round_T(wx0 a[x0] + wx1 a[x1]), lanes
//   along q, gathers through the read-only cache, each warp gathering
//   its next row while it forms this one;
// - the row pass, out = round_T(wy0 t[y0] + wy1 t[y1]), writes runs of 8
//   output columns as 16-byte streaming stores per channel plane.
// t for a (source row, column) is the same expression whichever output
// row reads it, so the result is that of one thread per output value.
//
// Arithmetic order matches the plain PyTorch version
// (ops/cuda/crop_kernel.py::banded_crop_plain) exactly: the sample
// position is one rounded multiply-add, every other product and sum is
// rounded on its own (_rn intrinsics; the build passes -fmad=false),
// tap weights and the column-pass sums rounded to the compute dtype where
// the TPU kernel rounds them. The lo tap's weight is above zero; a hi tap
// of weight 0 is not read: the pyramid holds [0, 1] pixels, so its
// product is +0, and s + (+0) == s for every s >= 0, bit for bit. A tap
// at index h_l (or w_l), which the clipped position gives at a level's
// last row with weight 0, is clamped to h_l - 1: nothing past the level
// is touched. An out-of-range frame or level index is clamped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTileRows = 16;  // output rows per block: 2 taps each, one warp
constexpr int kCands = 2 * kTileRows;
constexpr int kTileCols = 64;  // output columns per block
constexpr int kRun = 8;        // output columns per store
constexpr int kRuns = kTileCols / kRun;
static_assert(kTileRows * kRuns == kThreads, "a thread per row and run");

template <typename T>
__device__ __forceinline__ float load_f(const T* p);

template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
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
__device__ __forceinline__ float round_t(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight consecutive values of t (16-byte aligned in shared memory) as floats.
__device__ __forceinline__ void load_run(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_run(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Eight values rounded to T into dst: 16-byte stores where `whole` (dst
// aligned, the run inside the row), else the first n one at a time. The
// 16-byte stores carry the streaming hint (st.global.cs): the crops are
// not read again here, and the pyramid the gathers read stays in L2.
__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float* v,
                                          bool whole, int n) {
  if (whole) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
              << 16);
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (i < n) dst[i] = __float2bfloat16_rn(v[i]);
}

__device__ __forceinline__ void store_run(float* dst, const float* v,
                                          bool whole, int n) {
  if (whole) {
    float4* d = reinterpret_cast<float4*>(dst);
    __stcs(d, make_float4(v[0], v[1], v[2], v[3]));
    __stcs(d + 1, make_float4(v[4], v[5], v[6], v[7]));
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (i < n) dst[i] = v[i];
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
__global__ void __launch_bounds__(kThreads)
    banded_crop_kernel(const T* __restrict__ stack,
                       const int32_t* __restrict__ row_off, int n_levels,
                       const float* __restrict__ scal,
                       const int32_t* __restrict__ ints,
                       const int32_t* __restrict__ slot_frame,
                       T* __restrict__ out, int S, int sum_h, int width,
                       int oh, int ow) {
  __shared__ int s_xlo[kTileCols], s_xhi[kTileCols];
  __shared__ float s_wx0[kTileCols], s_wx1[kTileCols];
  __shared__ int s_row[kCands];    // distinct source rows, level-relative
  __shared__ int s_slot[kCands];   // candidate (row 2i + tap) -> its t row
  __shared__ float s_wy[kCands];   // candidate weight
  __shared__ int s_nrows;
  __shared__ __align__(16) T s_t[kCands][3][kTileCols];

  const int g = blockIdx.x;
  const int r0 = blockIdx.y * kTileRows;
  const int q0 = blockIdx.z * kTileCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* sc = scal + (int64_t)g * 6;
  const int lvl = min(max(__ldg(ints + (int64_t)g * 3 + 2), 0), n_levels - 1);
  const int f = min(max(__ldg(slot_frame + g), 0), S - 1);

  if (tid < kTileCols) {  // column taps, once per block
    int lo = 0, hi = 0;
    float w0 = 0.0f, w1 = 0.0f;  // columns past ow: read column 0, unused
    if (q0 + tid < ow)
      taps<T>(__ldg(sc + 2), __ldg(sc + 3), q0 + tid, __ldg(sc + 5), &lo, &hi,
              &w0, &w1);
    s_xlo[tid] = lo;
    s_xhi[tid] = hi;
    s_wx0[tid] = w0;
    s_wx1[tid] = w1;
  } else if (warp == 2) {
    // lane 2i + j: tap j of the tile's output row i; the lo tap is always
    // read, the hi tap where its weight is not 0. Each distinct source row
    // gets one t row, numbered in order of first appearance.
    const int r = r0 + (lane >> 1);
    int lo = 0, hi = 0;
    float w0 = 0.0f, w1 = 0.0f;
    if (r < oh)
      taps<T>(__ldg(sc + 0), __ldg(sc + 1), r, __ldg(sc + 4), &lo, &hi, &w0,
              &w1);
    const bool is_hi = lane & 1;
    const int row = is_hi ? hi : lo;
    const bool need = r < oh && (!is_hi || w1 != 0.0f);
    // lanes that read the same row share a t row: the first such lane's
    // (a lane with no row to read has a key of its own)
    const int dup =
        __ffs(__match_any_sync(0xffffffffu, need ? row : -1 - lane)) - 1;
    const unsigned firsts = __ballot_sync(0xffffffffu, need && dup == lane);
    const int slot = need ? __popc(firsts & ((1u << dup) - 1u)) : -1;
    s_slot[lane] = slot;
    s_wy[lane] = is_hi ? w1 : w0;
    if (need && dup == lane) s_row[slot] = row;
    if (lane == 0) s_nrows = __popc(firsts);
  }
  __syncthreads();

  // column pass: one t row per distinct source row, lanes along q
  const int64_t plane = (int64_t)sum_h * width;
  const T* base = stack + (int64_t)f * 3 * plane +
                  (int64_t)__ldg(row_off + lvl) * width;
  const int n_rows = s_nrows;
  constexpr int kHalves = kTileCols / 32;
  // this lane's column taps: the same for every row of the tile
  int x0[kHalves], x1[kHalves];
  float wx0[kHalves], wx1[kHalves];
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    const int q = lane + 32 * h;
    x0[h] = s_xlo[q];
    x1[h] = s_xhi[q];
    wx0[h] = s_wx0[q];
    wx1[h] = s_wx1[q];
  }
  // the gathers of row d: a at the lo tap, b at the hi tap where weighed
  auto gather = [&](int d, float (&a)[kHalves][3], float (&b)[kHalves][3]) {
    const T* line = base + (int64_t)s_row[d] * width;
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[h][c] = load_f<T>(line + c * plane + x0[h]);
        b[h][c] = wx1[h] != 0.0f ? load_f<T>(line + c * plane + x1[h]) : 0.0f;
      }
  };
  // a software pipeline over the warp's rows: the next row's gathers are
  // in flight while this row's sums are formed
  float a[kHalves][3], b[kHalves][3];
  if (warp < n_rows) gather(warp, a, b);
  for (int d = warp; d < n_rows; d += kThreads / 32) {
    float na[kHalves][3], nb[kHalves][3];
    const int next = d + kThreads / 32;
    if (next < n_rows) gather(next, na, nb);
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float t = __fmul_rn(wx0[h], a[h][c]);
        if (wx1[h] != 0.0f) t = __fadd_rn(t, __fmul_rn(wx1[h], b[h][c]));
        s_t[d][c][lane + 32 * h] = to_t<T>(t);
        a[h][c] = na[h][c];
        b[h][c] = nb[h][c];
      }
  }
  __syncthreads();

  // row pass: thread (row tid / 8, run tid % 8) weighs the row's two t
  // rows into 8 output columns of each channel plane
  const int rr = tid / kRuns, q = q0 + (tid % kRuns) * kRun;
  const int r = r0 + rr;
  if (r >= oh || q >= ow) return;
  const int s0 = s_slot[2 * rr], s1 = s_slot[2 * rr + 1];
  const float wy0 = s_wy[2 * rr], wy1 = s_wy[2 * rr + 1];
  const int64_t plane_out = (int64_t)oh * ow;
  T* dst = out + (int64_t)g * 3 * plane_out + (int64_t)r * ow + q;
  const bool whole = ow % kRun == 0 && q + kRun <= ow;
  const int n = min(kRun, ow - q);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v[kRun], t1[kRun];
    load_run(&s_t[s0][c][q - q0], v);
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = __fmul_rn(wy0, v[j]);
    if (s1 >= 0) {
      load_run(&s_t[s1][c][q - q0], t1);
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        v[j] = __fadd_rn(v[j], __fmul_rn(wy1, t1[j]));
    }
    store_run(dst + c * plane_out, v, whole, n);
  }
}

}  // namespace

extern "C" int ssyt_banded_crop(const void* stack, int bf16,
                                const void* row_off, int n_levels,
                                const void* scal, const void* ints,
                                const void* slot_frame, void* out, int S,
                                int sum_h, int width, int G, int oh, int ow,
                                void* stream) {
  if ((int64_t)G * oh * ow == 0) return 0;
  const dim3 grid(G, (oh + kTileRows - 1) / kTileRows,
                  (ow + kTileCols - 1) / kTileCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ro = static_cast<const int32_t*>(row_off);
  const float* sc = static_cast<const float*>(scal);
  const int32_t* in = static_cast<const int32_t*>(ints);
  const int32_t* sf = static_cast<const int32_t*>(slot_frame);
  if (bf16) {
    banded_crop_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(stack), ro, n_levels, sc, in, sf,
        static_cast<__nv_bfloat16*>(out), S, sum_h, width, oh, ow);
  } else {
    banded_crop_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(stack), ro, n_levels, sc, in, sf,
        static_cast<float*>(out), S, sum_h, width, oh, ow);
  }
  return (int)cudaGetLastError();
}
