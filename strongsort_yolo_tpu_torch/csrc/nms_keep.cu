// K2: greedy NMS keep mask over score-sorted, class-offset candidates.
//
// Replaces strongsort_yolo_tpu/ops/pallas/nms_kernel.py (pallas_nms_keep,
// bodies _nms_keep_kernel and _nms_keep_kernel_blockseq). The TPU kernel
// builds the K x K IoU in VMEM and iterates the fixpoint
//   keep[i] = valid[i] & !any_{j<i}(keep[j] & iou[j,i] > t)
// with MXU matvecs. Here a cluster of kCluster = 8 thread blocks takes one
// frame of a (S, K) batch:
//   1. every block loads the frame's boxes (as float4) and areas into its
//      shared memory; the cluster's 128 warps take rows j in turn, and for
//      each word w of the row that can hold a bit (32 w + 31 > j) the 32
//      lanes take the 32 columns i = 32 w + lane, each reading box i as
//      one float4 and area i beside its neighbours' (conflict-free: a
//      warp reads 32 consecutive boxes; row j's box is one broadcast);
//      each lane evaluates iou[j, i] > t for i > j, and __ballot_sync
//      forms the word sup[j][w], which lane 0 stores into block 0's mask
//      through distributed shared memory (512 x 16 x 4 B = 32 KB at
//      K = 512); one cluster barrier, and blocks 1..7 are done;
//   2. one warp of block 0 scans the mask 32 rows at a time, lane w
//      holding the removed bits of word w: for tile t (rows 32 t ..
//      32 t + 31) every lane takes the tile's removed word and the 32
//      diagonal words sup[32 t + b][t] (a shuffle each, independent of
//      the chain) and resolves the tile's keep bits in registers, row by
//      row in order, which is exactly the greedy rule: row b is kept if
//      valid and not yet removed, and a kept row ORs its diagonal word
//      into the removed bits; then each lane w > t ORs into its removed
//      word the rows sup[32 t + b][w] of the tile's kept rows b, looping
//      over the set bits. K / 32 = 16 tile steps replace the K = 512
//      dependent shuffle -> load -> OR steps of a row-by-row scan.
// The scan is the greedy definition itself, whose unique solution is the
// fixpoint the Pallas kernel and ops/nms.py::_greedy_keep_fixpoint
// converge to, so the mask is bit-identical to both.
//
// The design before this one mapped a thread to (row j, word w) with
// item = j * nwords + w and looped over the word's 32 bits: the 16 lanes
// of a row then read boxes 128 floats apart, all in one shared-memory
// bank, so each of the five loads per bit was a 16-way bank conflict
// (~330k shared wavefronts per frame on one SM); with one block per
// frame it ran on 8 SMs at S = 8, 0.22 ms.
//
// Bound now: per frame ~131k IoUs (~15 operations each, an IEEE
// division among them) over the 8 SMs of a cluster, ~34 ballots per warp,
// then the scan's 16 tile steps (32 dependent bit steps each) on one
// warp, and two cluster barriers: latency, not bytes (the input is 10 KB
// a frame).
//
// The IoU is in the Pallas/JAX expression order,
//   inter / (area_j + area_i - inter + 1e-7),
// every operation rounded on its own (the _rn intrinsics; -fmad=false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NMS_MAX_K 512
#define NMS_WORDS (NMS_MAX_K / 32)

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks per frame

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void __launch_bounds__(kThreads)
    nms_keep_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ conf, uint8_t* __restrict__ keep,
                    int K, float iou_thres, float conf_thres) {
  __shared__ float4 bx[NMS_MAX_K];
  __shared__ float area[NMS_MAX_K];
  __shared__ uint8_t valid[NMS_MAX_K];
  __shared__ uint32_t sup[NMS_MAX_K * NMS_WORDS];  // block 0's is the mask

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t s = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* b = boxes + s * K * 4;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float4 v = make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2],
                                 b[4 * i + 3]);
    bx[i] = v;
    area[i] = box_area(v.x, v.y, v.z, v.w);
    valid[i] = conf[s * K + i] >= conf_thres;
  }
  // the boxes are in; every block of the cluster runs before any store
  // into block 0's mask
  cluster.sync();

  const int nwords = (K + 31) / 32;
  uint32_t* const mask = cluster.map_shared_rank(sup, 0);
  for (int j = rank * kWarps + warp; j < K; j += kCluster * kWarps) {
    const float4 bj = bx[j];
    const float aj = area[j];
    for (int w = j >> 5; w < nwords; ++w) {
      const int i = 32 * w + lane;
      bool hit = false;
      if (i > j && i < K) {
        const float4 bi = bx[i];
        const float iw =
            fmaxf(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.0f);
        const float ih =
            fmaxf(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float den =
            __fadd_rn(__fsub_rn(__fadd_rn(aj, area[i]), inter), 1e-7f);
        hit = __fdiv_rn(inter, den) > iou_thres;
      }
      const uint32_t word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) mask[j * NMS_WORDS + w] = word;
    }
  }
  cluster.sync();  // the mask is whole in block 0
  if (rank != 0 || warp != 0) return;

  uint8_t* out = keep + s * K;
  uint32_t removed = 0;  // lane w < nwords: removed bits of word w
  for (int t = 0; t < nwords; ++t) {
    const int i = 32 * t + lane;
    const uint32_t vbits = __ballot_sync(0xffffffffu, i < K && valid[i]);
    const uint32_t diag = i < K ? sup[i * NMS_WORDS + t] : 0u;  // row i's
    uint32_t r = __shfl_sync(0xffffffffu, removed, t);
    uint32_t kept = 0;
#pragma unroll
    for (int bit = 0; bit < 32; ++bit) {
      const uint32_t d = __shfl_sync(0xffffffffu, diag, bit);
      const uint32_t alive = ((vbits & ~r) >> bit) & 1u;
      kept |= alive << bit;
      r |= d & (0u - alive);
    }
    if (i < K) out[i] = (kept >> lane) & 1u;
    if (lane > t && lane < nwords) {
      for (uint32_t kb = kept; kb != 0; kb &= kb - 1)
        removed |= sup[(32 * t + __ffs(kb) - 1) * NMS_WORDS + lane];
    }
  }
}

}  // namespace

extern "C" int ssyt_nms_keep(const void* boxes, const void* conf, void* keep,
                             int S, int K, float iou_thres, float conf_thres,
                             void* stream) {
  if (S == 0 || K == 0) return 0;
  if (S < 0 || K < 0 || K > NMS_MAX_K || S > (1 << 26))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, nms_keep_kernel, static_cast<const float*>(boxes),
      static_cast<const float*>(conf), static_cast<uint8_t*>(keep), K,
      iou_thres, conf_thres);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks per frame (the cluster's size), for the smoke test's report.
extern "C" int ssyt_nms_keep_cluster() { return kCluster; }
