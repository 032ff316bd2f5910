// K6: the tensor-core form, for bfloat16 (the note on the stage, and
// what the forms share, are in os_stage.cuh).
//
// A block holds one whole crop, so that the 1x1 convs (conv1, the ten
// lite pointwise convs, conv3, down and the transition or conv5; about
// 86% of a stage's multiply-adds) are GEMMs with M = the crop's pixels
// (512, 128 or 32), N = the conv's output channels and K = its input
// channels. They run on the tensor cores as warp-level mma.sync
// m16n8k16 (bf16 operands, float32 accumulators): the narrow N and K
// here (mid 16-128, K = 24 zero-padded to 32 in the fragments) suit its
// 16 x 8 x 16 tiles better than wgmma's 64-row ones. Each warp takes a
// unit of 32 pixels x 32 output channels and walks K in 16-wide chunks;
// the float32 bias, the ReLU, the residual and the rounding to bf16 run
// on the accumulators.
//
// - Activations live in shared memory pixel-major, [pixel][channel] in
//   bf16 with a row stride of 8 more than a multiple of 16 elements, so
//   that the A fragments are 32-bit loads that hit 32 different banks. y, s, the
//   aggregate and the lite buffer are such columns of mid channels: every
//   value stored there is already rounded to bf16, so nothing is lost.
// - The B fragments are the packed (out, in) row-major bf16 matrices of
//   stage_weights as they are: a fragment's k pairs are neighbours there,
//   so each is one 32-bit load through the read-only cache, shared by the
//   unit's two m16 tiles; one weight load feeds 32 multiply-adds of a
//   warp. A conv's weights (at most 32 KB at x0_25) are read by every
//   block and stay in L1 and L2, so they are not staged in shared memory,
//   which would cost a barrier and a copy per conv.
// - What stays on the CUDA cores, over all the block's threads: the 3x3
//   depthwise stencil (a thread keeps a channel pair and its taps in
//   registers and walks runs of 4 pixels), the gate's mean (a warp per
//   channel, lanes then shuffles in a fixed order), its two small layers
//   (one warp), s * g and the stream sums; then the 2x2 pool or the GAP
//   from the transition's or conv5's output, kept in shared memory over
//   the dead input columns.
// - Reductions run in a fixed order, with no atomics and no split K, so
//   two launches are bit-identical, and a crop's output does not depend
//   on the batch around it. The tensor cores add the products of a chunk
//   in their own order, so a bf16 rounding here and there lands on the
//   other side from os_stage_plain's, and a flipped gate value moves a
//   whole channel: the bar against the plain version is statistical
//   (chip_smoke.K6_BF16_MEAN).
//
// One crop per block, not a tile of several: the weights come through
// L1 either way, and a smaller block keeps more blocks resident per SM
// (stage 3: 70 KB, 3 blocks; stage 4: 27 KB and 4 warps a crop), which
// hides the ~85 barriers of a stage. A stage whose crop does not fit a
// block's shared memory (stage 2 of x0_5, x0_75 and x1_0, stage 3 of
// x1_0) splits it over a cluster of blocks (os_stage_cluster.cu). The
// stage's body, shared by both launches, is in os_stage_mma.cuh.

#include "os_stage_mma.cuh"

namespace {

template <int P, int W, int NT>
__global__ void __launch_bounds__(NT, 1)
    os_stage_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ mats,
                        const float* __restrict__ vecs, const int32_t* __restrict__ offs,
                        bf16* __restrict__ out, int c_in, int c_out, int mid,
                        int gap) {
  stage_body<bf16, P, W, NT, 1>(x, mats, vecs, offs, out, c_in, c_out, mid, gap);
}

template <int P, int W, int NT>
int launch_mma(const void* x, const void* mats, const void* vecs, const void* offs,
               void* out, int G, int c_in, int c_out, int mid, int gap,
               cudaStream_t stream) {
  const long long bytes = layout<bf16>(c_in, c_out, mid, P).bytes;
  auto kernel = os_stage_mma_kernel<P, W, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, NT, (size_t)bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(mats),
      static_cast<const float*>(vecs), static_cast<const int32_t*>(offs),
      static_cast<bf16*>(out), c_in, c_out, mid, gap);
  return (int)cudaGetLastError();
}

}  // namespace

long long os_stage_mma_bytes(int c_in, int c_out, int mid, int h, int w) {
  const int pixels = h * w;
  const bool built = (pixels == 512 && w == 16) || (pixels == 128 && w == 8) ||
                     (pixels == 32 && w == 4);
  if (!built || mid % 8 != 0 || c_out % 16 != 0 || c_in % 16 != 0 || mid / 16 > 8)
    return -1;
  const long long bytes = layout<bf16>(c_in, c_out, mid, pixels).bytes;
  return bytes <= kMaxSmem ? bytes : -1;
}

int os_stage_mma(const void* x, const void* mats, const void* vecs, const void* offs,
                 void* out, int G, int c_in, int c_out, int mid, int h, int w, int gap,
                 cudaStream_t s) {
  if (os_stage_mma_bytes(c_in, c_out, mid, h, w) < 0) return (int)cudaErrorInvalidValue;
  const int pixels = h * w;
  if (pixels == 512)
    return launch_mma<512, 16, 512>(x, mats, vecs, offs, out, G, c_in, c_out, mid, gap, s);
  if (pixels == 128)
    return launch_mma<128, 8, 256>(x, mats, vecs, offs, out, G, c_in, c_out, mid, gap, s);
  return launch_mma<32, 4, 128>(x, mats, vecs, offs, out, G, c_in, c_out, mid, gap, s);
}
