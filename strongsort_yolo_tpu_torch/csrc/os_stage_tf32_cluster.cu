// K6: the float32 tensor-core cluster form (the float32 design is in
// os_stage_tf32.cu, what crosses the blocks of a cluster in
// os_stage_cluster.cu, the body in os_stage_mma.cuh).
//
// The seven float32 stages whose crop does not fit one block split it
// over a thread block cluster of k blocks, a band of h / k whole rows a
// block (an even number of rows, a multiple of 32 pixels, k within the
// portable 8). The split (ops/cuda/osnet_kernel.py, CLUSTER_SPLIT) is,
// where the band rule allows, one past the least that fits, so that two
// blocks of 8 warps share an SM, as in the bf16 cluster form: it ran 8-12%
// faster than the least split at x0_25 stage 2, x0_5 stages 2 and 3 and
// x0_75 stage 3 (tools/prof_k6.py, H100 SXM at 700 W). Where one block
// fills an SM (x0_75's and x1_0's stage 2, x1_0's stage 3), a block has
// 16 warps, 12-16% faster than 8; within their 128 registers a thread,
// block a's down conv and conv3 run as two passes (stage_body's
// kSplitDown), which the dual pass spilled.

#include "os_stage_mma.cuh"

namespace {

template <int B, int W, int NT, int K, int CI, int CO, int MID, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    os_stage_tf32_cluster_kernel(const float* __restrict__ x,
                                 const float* __restrict__ mats,
                                 const float* __restrict__ vecs,
                                 const int32_t* __restrict__ offs,
                                 float* __restrict__ out) {
  stage_body<float, B, W, NT, K>(x, mats, vecs, offs, out, CI, CO, MID, 0);
}

// G clusters of K blocks of NT threads, a crop of H x W pixels a cluster;
// two blocks an SM where two fit its shared memory
template <int H, int W, int K, int CI, int CO, int MID, int NT = 256>
int launch(const void* x, const void* mats, const void* vecs, const void* offs, void* out,
           int G, cudaStream_t stream) {
  constexpr int B = H * W / K;
  constexpr long long kBytes = layout<float>(CI, CO, MID, B, W, K).bytes;
  constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 228 * 1024 ? 2 : 1;
  return launch_clusters<float>(
      os_stage_tf32_cluster_kernel<B, W, NT, K, CI, CO, MID, kMinBlocks>, K, NT, kBytes, x,
      mats, vecs, offs, out, G, stream);
}

struct Built {
  int c_in, c_out, mid, h, w, k;
};
constexpr Built kBuilt[] = {
    {16, 64, 16, 32, 16, 4},    // x0_25 stage 2
    {32, 128, 32, 32, 16, 8},   // x0_5 stage 2
    {128, 192, 48, 16, 8, 4},   // x0_5 stage 3
    {48, 192, 48, 32, 16, 8},   // x0_75 stage 2
    {192, 288, 72, 16, 8, 4},   // x0_75 stage 3
    {64, 256, 64, 32, 16, 8},   // x1_0 stage 2
    {256, 384, 96, 16, 8, 4},   // x1_0 stage 3
};

int built(int c_in, int c_out, int mid, int h, int w, int k) {
  for (int i = 0; i < (int)(sizeof(kBuilt) / sizeof(kBuilt[0])); ++i) {
    const Built& b = kBuilt[i];
    if (b.c_in == c_in && b.c_out == c_out && b.mid == mid && b.h == h && b.w == w && b.k == k)
      return i;
  }
  return -1;
}

}  // namespace

long long os_stage_tf32_cluster_bytes(int c_in, int c_out, int mid, int h, int w, int k) {
  if (built(c_in, c_out, mid, h, w, k) < 0) return -1;
  const long long bytes = layout<float>(c_in, c_out, mid, h * w / k, w, k).bytes;
  return bytes <= kMaxSmem ? bytes : -1;
}

int os_stage_tf32_cluster(const void* x, const void* mats, const void* vecs,
                          const void* offs, void* out, int G, int c_in, int c_out, int mid,
                          int h, int w, int k, cudaStream_t s) {
  if (os_stage_tf32_cluster_bytes(c_in, c_out, mid, h, w, k) < 0 || G > (1 << 26))
    return (int)cudaErrorInvalidValue;
  switch (built(c_in, c_out, mid, h, w, k)) {
    case 0: return launch<32, 16, 4, 16, 64, 16>(x, mats, vecs, offs, out, G, s);
    case 1: return launch<32, 16, 8, 32, 128, 32>(x, mats, vecs, offs, out, G, s);
    case 2: return launch<16, 8, 4, 128, 192, 48>(x, mats, vecs, offs, out, G, s);
    case 3: return launch<32, 16, 8, 48, 192, 48, 512>(x, mats, vecs, offs, out, G, s);
    case 4: return launch<16, 8, 4, 192, 288, 72>(x, mats, vecs, offs, out, G, s);
    case 5: return launch<32, 16, 8, 64, 256, 64, 512>(x, mats, vecs, offs, out, G, s);
    default: return launch<16, 8, 4, 256, 384, 96, 512>(x, mats, vecs, offs, out, G, s);
  }
}
