// K6: the float32 tensor-core form, one block a crop (the note on the
// stage, and what the forms share, are in os_stage.cuh; the tensor-core
// design, in os_stage_mma.cu; the body, in os_stage_mma.cuh).
//
// Float32 runs through the body the bfloat16 form runs, with T = float:
// activations [pixel][channel] in float32 in shared memory (row strides
// of 4 more than a multiple of 8 floats: conflict-free fragment loads),
// the 3x3 stencil, the gate, the pools and every rounding point as the
// bf16 form's, each value rounded to float32 (a no-op where the bf16 form
// rounds to bf16). The 1x1 products (about 86% of a stage's multiply-adds)
// run on the tensor cores as 3xTF32 (mma_unit in os_stage_mma.cuh): each
// operand split into a TF32 hi and a TF32 lo, a chunk of 8 of K summed
// as lo.hi + hi.lo + hi.hi by three mma.sync m16n8k8 into a float32
// fragment from zero, the chunks added in float32. TF32 alone keeps 11
// bits of each operand and would miss the 1e-4 bar against the plain
// version; 3xTF32 drops only lo.lo and what lies past lo, about float32's
// accuracy (tests/test_torch_osnet_kernel.py emulates it against the JAX
// stage), at up to 495 / 3 = 165 TFLOP/s against the CUDA cores' 67.
// The weights are split in the unit, from the float32 matrices
// stage_weights packs.
//
// Float32 doubles the body's shared memory: a crop fits one block only
// at x0_25's stage 3 (140 KB) and at every stage 4 (47-180 KB); the
// other seven stages split each crop over a cluster of blocks
// (os_stage_tf32_cluster.cu). Each stage is its own instance, its
// widths, strides and loop bounds constants (in the bf16 cluster form
// that was 1.4-1.6x faster and removed its spills).

#include "os_stage_mma.cuh"

namespace {

template <int P, int W, int NT, int CI, int CO, int MID, int GAP>
__global__ void __launch_bounds__(NT, 1)
    os_stage_tf32_kernel(const float* __restrict__ x, const float* __restrict__ mats,
                         const float* __restrict__ vecs, const int32_t* __restrict__ offs,
                         float* __restrict__ out) {
  stage_body<float, P, W, NT, 1>(x, mats, vecs, offs, out, CI, CO, MID, GAP);
}

template <int H, int W, int NT, int CI, int CO, int MID, int GAP>
int launch_tf32(const void* x, const void* mats, const void* vecs, const void* offs,
                void* out, int G, cudaStream_t stream) {
  constexpr int P = H * W;
  const long long bytes = layout<float>(CI, CO, MID, P).bytes;
  auto kernel = os_stage_tf32_kernel<P, W, NT, CI, CO, MID, GAP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, NT, (size_t)bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(mats),
      static_cast<const float*>(vecs), static_cast<const int32_t*>(offs),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The stages whose crop fits one block in float32: (c_in, c_out, mid, h,
// w, gap)
struct Built {
  int c_in, c_out, mid, h, w, gap;
};
constexpr Built kBuilt[] = {
    {64, 96, 24, 16, 8, 0},    // x0_25 stage 3
    {96, 128, 32, 8, 4, 1},    // x0_25 stage 4
    {192, 256, 64, 8, 4, 1},   // x0_5 stage 4
    {288, 384, 96, 8, 4, 1},   // x0_75 stage 4
    {384, 512, 128, 8, 4, 1},  // x1_0 stage 4
};

int built(int c_in, int c_out, int mid, int h, int w) {
  for (int i = 0; i < (int)(sizeof(kBuilt) / sizeof(kBuilt[0])); ++i) {
    const Built& b = kBuilt[i];
    if (b.c_in == c_in && b.c_out == c_out && b.mid == mid && b.h == h && b.w == w) return i;
  }
  return -1;
}

}  // namespace

long long os_stage_tf32_bytes(int c_in, int c_out, int mid, int h, int w) {
  if (built(c_in, c_out, mid, h, w) < 0) return -1;
  const long long bytes = layout<float>(c_in, c_out, mid, h * w).bytes;
  return bytes <= kMaxSmem ? bytes : -1;
}

int os_stage_tf32(const void* x, const void* mats, const void* vecs, const void* offs,
                  void* out, int G, int c_in, int c_out, int mid, int h, int w, int gap,
                  cudaStream_t s) {
  const int i = built(c_in, c_out, mid, h, w);
  if (i < 0 || os_stage_tf32_bytes(c_in, c_out, mid, h, w) < 0 || kBuilt[i].gap != gap)
    return (int)cudaErrorInvalidValue;
  switch (i) {
    case 0: return launch_tf32<16, 8, 256, 64, 96, 24, 0>(x, mats, vecs, offs, out, G, s);
    case 1: return launch_tf32<8, 4, 128, 96, 128, 32, 1>(x, mats, vecs, offs, out, G, s);
    case 2: return launch_tf32<8, 4, 256, 192, 256, 64, 1>(x, mats, vecs, offs, out, G, s);
    case 3: return launch_tf32<8, 4, 256, 288, 384, 96, 1>(x, mats, vecs, offs, out, G, s);
    default: return launch_tf32<8, 4, 256, 384, 512, 128, 1>(x, mats, vecs, offs, out, G, s);
  }
}
