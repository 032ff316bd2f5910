// K3: Bertsekas auction with lapjv cost-limit semantics, one block per
// problem of a (P, R, C) batch.
//
// Replaces strongsort_yolo_tpu/ops/pallas/auction_kernel.py
// (pallas_auction, body _auction_kernel) and follows its semantics
// exactly, not those of the XLA path in ops/assignment.py:
//   - cost clipped to +-1e6; benefit w = (t - cost) / crange on valid
//     pairs, -4 elsewhere, crange = max(cmax - cmin, 1e-6) with t folded
//     into both extremes;
//   - an implicit zero-benefit sentinel per row: a bidding row whose best
//     value is < 0 retires to it for good; the sentinel caps the
//     second-best value at 0;
//   - bid = w[i, best_j] - second + eps; lowest index wins ties, both
//     for a row's best column and for a column's winning row;
//   - eps *= 8 before any round r > 0 with r % 16 == 0;
//   - at most max_rounds = 16 * R_pad rounds (R_pad = R rounded up to a
//     multiple of 8, computed by the wrapper);
//   - matches are filtered on the raw (clipped) cost: cost <= t + 1e-6.
//
// Bound: latency of the rounds, not bytes: the 256 x 128 f32 benefit
// block (128 KB) is read from device memory once, and every round is a
// few passes over it. The design keeps the block in dynamic shared
// memory (row stride C + 1, so the per-row scans of a warp hit 32
// different banks), runs the row phase with one thread per row and the
// column phase with one thread per column (threads stride over both when
// a side passes 1024), and lets each block leave its loop as soon as its
// own problem is done, so an easy problem does not wait for a hard one.
//
// Two forms of the same kernel, by where the benefit block w lives
// (template parameter kSharedW): in shared memory where it fits a block,
// else in a global scratch of (P, C, R) float32 that the wrapper
// allocates, column-major per problem so that the row phase's reads at
// one column are coalesced across a warp (the column phase never reads
// w); the per-row and per-column arrays stay in shared memory (13 R + 9 C
// bytes, 15 KB at 1100 x 300). Three launches of 8 problems of 512 x 250
// are 4 MB of scratch, which stays in the 50 MB L2.
//
// Every sum and quotient is rounded on its own (the _rn intrinsics;
// -fmad=false), in the order of the plain PyTorch version
// (strongsort_yolo_tpu_torch/ops/cuda/auction_kernel.py::auction_plain).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clip_cost(float c) {
  return fminf(fmaxf(c, -1e6f), 1e6f);
}

__device__ float block_reduce(float v, bool is_min, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_min ? fminf(v, o) : fmaxf(v, o);
  }
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  float r = scratch[0];
  for (int w = 1; w < nwarps; ++w)
    r = is_min ? fminf(r, scratch[w]) : fmaxf(r, scratch[w]);
  __syncthreads();
  return r;
}

// w[i, j]: shared memory with row stride C + 1, or the problem's (C, R)
// block of the global scratch
template <bool kSharedW>
__device__ __forceinline__ int64_t w_at(int i, int j, int R, int C) {
  return kSharedW ? (int64_t)i * (C + 1) + j : (int64_t)j * R + i;
}

template <bool kSharedW>
__global__ void __launch_bounds__(1024) auction_kernel(const float* __restrict__ cost,
                               const float* __restrict__ thresh,
                               const uint8_t* __restrict__ row_valid,
                               const uint8_t* __restrict__ col_valid,
                               int32_t* __restrict__ r2c,
                               int32_t* __restrict__ c2r, float* w_scratch,
                               int R, int C, float eps0, int max_rounds) {
  extern __shared__ float smem[];
  // w is written and read by this block only: plain loads, not the
  // read-only path
  float* w = kSharedW ? smem : w_scratch + (int64_t)blockIdx.x * R * C;
  float* price = kSharedW ? smem + R * (C + 1) : smem;  // C
  float* bid = price + C;              // R
  int* owner = (int*)(bid + R);        // C
  int* best_j = owner + C;             // R
  uint8_t* rv = (uint8_t*)(best_j + R);  // R
  uint8_t* cv = rv + R;                // C
  uint8_t* sent = cv + C;              // R
  uint8_t* owned = sent + R;           // R
  uint8_t* place = owned + R;          // R
  __shared__ float scratch[32];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* cp = cost + (int64_t)p * R * C;
  const float t = thresh[p];

  for (int i = tid; i < R; i += nt) {
    rv[i] = row_valid[(int64_t)p * R + i];
    sent[i] = 0;
  }
  for (int j = tid; j < C; j += nt) {
    cv[j] = col_valid[(int64_t)p * C + j];
    price[j] = 0.0f;
    owner[j] = -1;
  }
  __syncthreads();

  float lmin = t, lmax = t;
  for (int e = tid; e < R * C; e += nt) {
    const int i = e / C, j = e - (e / C) * C;
    if (rv[i] && cv[j]) {
      const float c = clip_cost(cp[e]);
      lmin = fminf(lmin, c);
      lmax = fmaxf(lmax, c);
    }
  }
  const float cmin = block_reduce(lmin, true, scratch);
  const float cmax = block_reduce(lmax, false, scratch);
  const float crange = fmaxf(__fsub_rn(cmax, cmin), 1e-6f);
  for (int e = tid; e < R * C; e += nt) {
    const int i = e / C, j = e - (e / C) * C;
    w[w_at<kSharedW>(i, j, R, C)] = (rv[i] && cv[j])
                         ? __fdiv_rn(__fsub_rn(t, clip_cost(cp[e])), crange)
                         : -4.0f;
  }
  __syncthreads();

  float eps = eps0;
  for (int rounds = 0;; ++rounds) {
    for (int i = tid; i < R; i += nt) owned[i] = 0;
    __syncthreads();
    for (int j = tid; j < C; j += nt)
      if (owner[j] >= 0) owned[owner[j]] = 1;
    __syncthreads();
    int open = 0;
    for (int i = tid; i < R; i += nt) open |= !(sent[i] || owned[i]);
    if (!__syncthreads_or(open) || rounds >= max_rounds) break;
    if (rounds > 0 && rounds % 16 == 0) eps = __fmul_rn(eps, 8.0f);

    // row phase: best and second-best value against current prices
    for (int i = tid; i < R; i += nt) {
      float bv = __fsub_rn(w[w_at<kSharedW>(i, 0, R, C)], price[0]);
      float sv = -INFINITY;
      int bj = 0;
      for (int j = 1; j < C; ++j) {
        const float v = __fsub_rn(w[w_at<kSharedW>(i, j, R, C)], price[j]);
        if (v > bv) {
          sv = bv;
          bv = v;
          bj = j;
        } else if (v > sv) {
          sv = v;
        }
      }
      const bool bidding = !sent[i] && !owned[i];
      const bool retire = bidding && bv < 0.0f;
      if (retire) sent[i] = 1;
      place[i] = bidding && !retire;
      bid[i] = __fadd_rn(
          __fsub_rn(w[w_at<kSharedW>(i, bj, R, C)], fmaxf(sv, 0.0f)), eps);
      best_j[i] = bj;
    }
    __syncthreads();

    // column phase: highest bid wins, lowest row index among equals
    for (int j = tid; j < C; j += nt) {
      int win = -1;
      float wb = 0.0f;
      for (int i = 0; i < R; ++i) {
        if (place[i] && best_j[i] == j && (win < 0 || bid[i] > wb)) {
          wb = bid[i];
          win = i;
        }
      }
      if (win >= 0) {
        price[j] = wb;
        owner[j] = win;
      }
    }
    __syncthreads();
  }

  int32_t* r2c_p = r2c + (int64_t)p * R;
  int32_t* c2r_p = c2r + (int64_t)p * C;
  for (int i = tid; i < R; i += nt) r2c_p[i] = -1;
  __syncthreads();
  const float limit = __fadd_rn(t, 1e-6f);
  for (int j = tid; j < C; j += nt) {
    const int o = owner[j];
    const bool ok = o >= 0 && rv[o] && cv[j] &&
                    clip_cost(cp[(int64_t)o * C + j]) <= limit;
    c2r_p[j] = ok ? o : -1;
    if (ok) r2c_p[o] = j;
  }
}

}  // namespace

// Dynamic shared memory of a block: the per-row and per-column arrays,
// plus the benefit block when shared_w is nonzero.
extern "C" long long ssyt_auction_smem_bytes(int R, int C, int shared_w) {
  const long long arrays = 4LL * C + 4LL * R + 4LL * C + 4LL * R + R + C + 3LL * R;
  return arrays + (shared_w ? 4LL * R * (C + 1) : 0LL);
}

// w_scratch null: the benefit block in shared memory; else a (P, C, R)
// float32 scratch for it.
extern "C" int ssyt_auction(const void* cost, const void* thresh,
                            const void* row_valid, const void* col_valid,
                            void* r2c, void* c2r, void* w_scratch, int P,
                            int R, int C, float eps0, int max_rounds,
                            void* stream) {
  if (P == 0 || R == 0 || C == 0) return 0;
  const bool shared_w = w_scratch == nullptr;
  const long long smem = ssyt_auction_smem_bytes(R, C, shared_w);
  auto kernel = shared_w ? auction_kernel<true> : auction_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = R > C ? R : C;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  kernel<<<P, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const float*>(thresh),
      static_cast<const uint8_t*>(row_valid),
      static_cast<const uint8_t*>(col_valid), static_cast<int32_t*>(r2c),
      static_cast<int32_t*>(c2r), static_cast<float*>(w_scratch), R, C, eps0,
      max_rounds);
  return (int)cudaGetLastError();
}
