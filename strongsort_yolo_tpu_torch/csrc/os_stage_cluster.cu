// K6: the tensor-core cluster form, for bfloat16 (the note on the stage,
// and what the forms share, are in os_stage.cuh; the tensor-core design,
// in os_stage_mma.cu).
//
// For the four stages whose crop does not fit one block's 227 KB in the
// tensor-core layout (stage 2 of x0_5, x0_75 and x1_0: 336, 480 and 625
// KB; stage 3 of x1_0: 269 KB). A thread block cluster of K blocks holds
// one crop, each block a band of h / K whole rows (an even number of
// rows a band), and runs the tensor-core form's body (os_stage_mma.cuh)
// on its band: a layout of B = h w / K pixels. The wrapper's split
// (ops/cuda/osnet_kernel.py, CLUSTER_SPLIT) is the least K at which two
// blocks of 8 warps share an SM: K = 4 for x0_5 stage 2 (90 KB a block)
// and x1_0 stage 3 (76 KB), K = 8 for x0_75 and x1_0 stage 2 (69 and 90
// KB). A stage is a chain of ~110 barriers around small GEMMs, so what
// hides their latency is the warps an SM holds: at the least K that fits
// one block (2, 4, 4, 2; 128-174 KB a block) the stages ran 5-18% slower
// at G = 96 and 2-14% at G = 480, and one block of 16 warps about as slow
// as two of 8 (tools/prof_k6.py on builds of each split, H100 SXM at 700
// W).
//
// What stays in a block: every 1x1 product is per pixel, so conv1, the
// ten lite pointwise convs, conv3, down and the transition are the band's
// own GEMMs (M = B), summed by the same mma.sync chunks as one block's
// crop; the 2x2 pool's windows lie within a band (its rows are even).
//
// What crosses blocks, through distributed shared memory:
// - the stencil's halo. A lite conv's pointwise epilogue stores the
//   band's first and last crop rows also into the halo rows of the bands
//   above and below (st to the address `map_shared_rank` gives), then a
//   cluster barrier (arrive.release / wait.acquire) publishes them; the
//   stencil reads the rows past its band from its own halo rows, and
//   zero outside the crop. The halo rows are two sets, taken by the lite
//   conv's parity over the stage: a set is written again two lite convs
//   later, after its readers passed the barrier of the conv between.
//   One cluster barrier a lite conv, where one block had __syncthreads.
// - the channel gate's mean. Each band sums its pixels per channel in a
//   fixed order (a warp per channel), and lane j of that warp stores the
//   sum into band j's slot for this rank; after a cluster barrier, every
//   band adds the K sums in rank order 0 .. K-1 and divides by the crop's
//   pixels. Every band holds the same gate, two launches are
//   bit-identical and a crop's output does not depend on the batch.
// - lifetimes: stores only, no block reads another's shared memory. The
//   first store waits for a cluster barrier begun at the block's start
//   (every block of the cluster runs); each store precedes a cluster
//   barrier that every block passes before that memory is read or reused,
//   and the last one (the last gate's sums) precedes the stage's last
//   cluster barrier, so a block may exit after it.
// 29 cluster barriers a stage: the first, 20 lite convs and 8 gates.
//
// Bound: as the tensor-core form's (os_stage.cuh); here a crop's weights
// are read by K blocks, through L1 and L2.

#include "os_stage_mma.cuh"

namespace {

constexpr int kClusterThreads = 256;

// The body specialised on the stage's widths: its strides, its layout and
// its loop bounds become constants, which kept the kernel within 128
// registers (two blocks an SM) without a spill and ran it 1.4-1.6x faster
// than one instance per band shape with the widths as arguments.
template <int B, int W, int NT, int K, int CI, int CO, int MID>
__global__ void __launch_bounds__(NT, 2)
    os_stage_cluster_kernel(const bf16* __restrict__ x, const bf16* __restrict__ mats,
                            const float* __restrict__ vecs,
                            const int32_t* __restrict__ offs, bf16* __restrict__ out) {
  stage_body<bf16, B, W, NT, K>(x, mats, vecs, offs, out, CI, CO, MID, 0);
}

// a cluster of K blocks per crop of H x W pixels, G K blocks
template <int H, int W, int K, int CI, int CO, int MID>
int launch_cluster(const void* x, const void* mats, const void* vecs, const void* offs,
                   void* out, int G, cudaStream_t stream) {
  constexpr int NT = kClusterThreads, B = H * W / K;
  return launch_clusters<bf16>(os_stage_cluster_kernel<B, W, NT, K, CI, CO, MID>, K, NT,
                               layout<bf16>(CI, CO, MID, B, W, K).bytes, x, mats, vecs,
                               offs, out, G, stream);
}

// The stages and splits the cluster form is built for: (c_in, c_out,
// mid, h, w, k). A band is an even number of rows and a multiple of 32
// pixels, the tensor-core units' rows.
struct Built {
  int c_in, c_out, mid, h, w, k;
};
constexpr Built kBuilt[] = {
    {32, 128, 32, 32, 16, 4},   // x0_5 stage 2
    {48, 192, 48, 32, 16, 8},   // x0_75 stage 2
    {64, 256, 64, 32, 16, 8},   // x1_0 stage 2
    {256, 384, 96, 16, 8, 4},   // x1_0 stage 3
};

// the row of kBuilt, or -1
int built(int c_in, int c_out, int mid, int h, int w, int k) {
  for (int i = 0; i < (int)(sizeof(kBuilt) / sizeof(kBuilt[0])); ++i) {
    const Built& b = kBuilt[i];
    if (b.c_in == c_in && b.c_out == c_out && b.mid == mid && b.h == h && b.w == w && b.k == k)
      return i;
  }
  return -1;
}

}  // namespace

long long os_stage_cluster_bytes(int c_in, int c_out, int mid, int h, int w, int k) {
  if (built(c_in, c_out, mid, h, w, k) < 0) return -1;
  const long long bytes = layout<bf16>(c_in, c_out, mid, h * w / k, w, k).bytes;
  return bytes <= kMaxSmem ? bytes : -1;
}

int os_stage_cluster(const void* x, const void* mats, const void* vecs, const void* offs,
                     void* out, int G, int c_in, int c_out, int mid, int h, int w, int k,
                     cudaStream_t s) {
  if (os_stage_cluster_bytes(c_in, c_out, mid, h, w, k) < 0 || G > (1 << 26))
    return (int)cudaErrorInvalidValue;
  switch (built(c_in, c_out, mid, h, w, k)) {
    case 0: return launch_cluster<32, 16, 4, 32, 128, 32>(x, mats, vecs, offs, out, G, s);
    case 1: return launch_cluster<32, 16, 8, 48, 192, 48>(x, mats, vecs, offs, out, G, s);
    case 2: return launch_cluster<32, 16, 8, 64, 256, 64>(x, mats, vecs, offs, out, G, s);
    default: return launch_cluster<16, 8, 4, 256, 384, 96>(x, mats, vecs, offs, out, G, s);
  }
}
