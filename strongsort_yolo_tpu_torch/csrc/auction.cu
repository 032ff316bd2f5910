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
// few passes over the rows still bidding. The design keeps the block in
// dynamic shared memory (row stride C + 1) and cuts the serial work of a
// round to what its bidders need:
//   - the rows that bid (!sent && !owned) are compacted into a list once
//     per round; rows that cannot bid no longer scan;
//   - each bidding row gets a warp: its lanes scan strided columns with
//     the serial rule (v > bv, else v > sv, so the best is the first
//     maximum and the second-best the largest value at any other index,
//     ties included), then five shuffle steps merge the lanes' top-2,
//     the lower index winning among equal bests;
//   - each placing row writes its bid to its column with one 64-bit
//     atomicMax on a key: the bid's order-preserving bits high, ~row low,
//     so the highest bid wins and the lowest row among equal bids; a max
//     does not depend on the order of the writes, so launches stay
//     deterministic, and the per-column scan over all rows is gone;
//   - ownership is kept up to date where a column changes hands (a row
//     owns at most one column and bids only when it owns none), not
//     rebuilt from the owners every round;
//   - three barriers a round: after the compaction, after the bids, after
//     the columns take them;
// and lets each block leave its loop as soon as its own problem is done,
// so an easy problem does not wait for a hard one.
//
// Two forms of the same kernel, by where the benefit block w lives
// (template parameter kSharedW): in shared memory where it fits a block,
// else in a global scratch of (P, R, C) float32 that the wrapper
// allocates, row-major so that a warp's reads of one row coalesce; the
// per-row and per-column arrays stay in shared memory (7 R + 17 C bytes,
// 12.8 KB at 1100 x 300). Three launches of 8 problems of 512 x 250 are
// 4 MB of scratch, which stays in the 50 MB L2.
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

// w[i, j]: shared memory with row stride C + 1, or the problem's (R, C)
// block of the global scratch
template <bool kSharedW>
__device__ __forceinline__ int64_t w_at(int i, int j, int C) {
  return (int64_t)i * (kSharedW ? C + 1 : C) + j;
}

// a bid's column key: the float's order-preserving bits high (+0 for
// either zero, which compare equal), ~row low; 0 is below every bid
__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  unsigned int u = __float_as_uint(bid == 0.0f ? 0.0f : bid);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned int)(~row);
}

__device__ __forceinline__ float key_bid(unsigned long long key) {
  const unsigned int u = (unsigned int)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

template <bool kSharedW>
__global__ void __launch_bounds__(1024) auction_kernel(const float* __restrict__ cost,
                               const float* __restrict__ thresh,
                               const uint8_t* __restrict__ row_valid,
                               const uint8_t* __restrict__ col_valid,
                               int32_t* __restrict__ r2c,
                               int32_t* __restrict__ c2r, float* w_scratch,
                               int R, int C, float eps0, int max_rounds) {
  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* key = smem_keys;  // C: this round's best bid per column
  float* price = reinterpret_cast<float*>(key + C);  // C
  int* owner = reinterpret_cast<int*>(price + C);     // C
  int* bidders = owner + C;                           // R: this round's list
  // w is written and read by this block only: plain loads, not the
  // read-only path
  float* w = kSharedW ? reinterpret_cast<float*>(bidders + R)
                      : w_scratch + (int64_t)blockIdx.x * R * C;
  uint8_t* rv = kSharedW ? reinterpret_cast<uint8_t*>(w + (int64_t)R * (C + 1))
                         : reinterpret_cast<uint8_t*>(bidders + R);  // R
  uint8_t* cv = rv + R;      // C
  uint8_t* sent = cv + C;    // R
  uint8_t* owned = sent + R; // R
  __shared__ float scratch[32];
  __shared__ int n_bid;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const float* cp = cost + (int64_t)p * R * C;
  const float t = thresh[p];

  for (int i = tid; i < R; i += nt) {
    rv[i] = row_valid[(int64_t)p * R + i];
    sent[i] = 0;
    owned[i] = 0;
  }
  for (int j = tid; j < C; j += nt) {
    cv[j] = col_valid[(int64_t)p * C + j];
    price[j] = 0.0f;
    owner[j] = -1;
    key[j] = 0ull;
  }
  if (tid == 0) n_bid = 0;
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
    w[w_at<kSharedW>(i, j, C)] = (rv[i] && cv[j])
                         ? __fdiv_rn(__fsub_rn(t, clip_cost(cp[e])), crange)
                         : -4.0f;
  }
  __syncthreads();

  float eps = eps0;
  for (int rounds = 0;; ++rounds) {
    // the rows that bid this round, in any order (each row's work is its
    // own, and the column keys take a max)
    for (int i = tid; i < R; i += nt)
      if (!sent[i] && !owned[i]) bidders[atomicAdd(&n_bid, 1)] = i;
    __syncthreads();
    const int nb = n_bid;
    if (nb == 0 || rounds >= max_rounds) break;
    if (rounds > 0 && rounds % 16 == 0) eps = __fmul_rn(eps, 8.0f);

    // row phase, a warp per bidding row: best and second-best value
    // against current prices
    for (int b = warp; b < nb; b += n_warps) {
      const int i = bidders[b];
      float bv = -INFINITY, sv = -INFINITY;
      int bj = 0x7fffffff;
      for (int j = lane; j < C; j += 32) {
        const float v = __fsub_rn(w[w_at<kSharedW>(i, j, C)], price[j]);
        if (bj == 0x7fffffff || v > bv) {
          sv = bv;
          bv = v;
          bj = j;
        } else if (v > sv) {
          sv = v;
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float obv = __shfl_xor_sync(0xffffffffu, bv, off);
        const float osv = __shfl_xor_sync(0xffffffffu, sv, off);
        const int obj = __shfl_xor_sync(0xffffffffu, bj, off);
        // a lane without columns holds (-inf, INT_MAX): it never wins,
        // and its -inf never raises a second-best
        if (obv > bv || (obv == bv && obj < bj)) {
          sv = bv > osv ? bv : osv;
          bv = obv;
          bj = obj;
        } else {
          sv = obv > sv ? obv : sv;
        }
      }
      if (lane == 0) {
        if (bv < 0.0f) {
          sent[i] = 1;  // retires to its sentinel for good
        } else {
          const float bid = __fadd_rn(
              __fsub_rn(w[w_at<kSharedW>(i, bj, C)], fmaxf(sv, 0.0f)), eps);
          atomicMax(&key[bj], bid_key(bid, i));
        }
      }
    }
    __syncthreads();

    // column phase: each column with a bid takes its best one
    for (int j = tid; j < C; j += nt) {
      const unsigned long long k = key[j];
      if (k != 0ull) {
        const int win = (int)(~(unsigned int)k);
        const int old = owner[j];
        if (old >= 0) owned[old] = 0;
        owned[win] = 1;
        owner[j] = win;
        price[j] = key_bid(k);
        key[j] = 0ull;
      }
    }
    if (tid == 0) n_bid = 0;
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
  const long long arrays = 8LL * C + 4LL * C + 4LL * C + 4LL * R + R + C + 2LL * R;
  return arrays + (shared_w ? 4LL * R * (C + 1) : 0LL);
}

// w_scratch null: the benefit block in shared memory; else a (P, R, C)
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
  // warps for the bidding rows: 16 at least, one per row or column beyond
  int threads = R > C ? R : C;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 512) threads = 512;
  if (threads > 1024) threads = 1024;
  kernel<<<P, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const float*>(thresh),
      static_cast<const uint8_t*>(row_valid),
      static_cast<const uint8_t*>(col_valid), static_cast<int32_t*>(r2c),
      static_cast<int32_t*>(c2r), static_cast<float*>(w_scratch), R, C, eps0,
      max_rounds);
  return (int)cudaGetLastError();
}
