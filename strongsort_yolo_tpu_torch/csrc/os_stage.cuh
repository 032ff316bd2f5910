#pragma once

// K6: one fused OSNet backbone stage per crop.
//
// Replaces strongsort_yolo_tpu/ops/pallas/osnet_kernel.py: os_stage (body
// _stage_kernel). A stage is two OS blocks (1x1 conv1, four streams of one
// to four lite convs - pointwise 1x1 then depthwise 3x3 - the shared
// channel gate, the aggregation, 1x1 conv3 and the residual), then the 1x1
// transition with a 2x2 average pool, or conv5 with the global average
// pool for the last stage. BN is folded into every conv (ops/cuda/
// osnet_kernel.py::stage_weights packs the weights).
//
// The TPU kernel holds a tile of 8 crops in VMEM as a (8*C, H*W) array and
// turns each pointwise conv into a kron(I_8, w) left product for its matrix
// unit. That layout is not carried over. Here a thread block computes one
// crop's whole stage, or a band of its rows in a thread block cluster of
// blocks a crop, with the 1x1 convs (conv1, the ten lite pointwise
// convs, conv3, down and the transition or conv5; about 86% of a stage's
// multiply-adds) as GEMMs on the tensor cores, M the pixels (the note of
// os_stage_mma.cu); the 3x3 stencil, the gate and the pools stay on the
// CUDA cores.
//
// Rounding follows the TPU kernel (and the plain version, ops/cuda/
// osnet_kernel.py::os_stage_plain): products accumulate in float32, each
// sum and product rounded on its own (the build passes -fmad=false), and
// the values are rounded to the compute dtype T where the TPU kernel
// casts: conv1, the lite pointwise, the stencil output, the gate's mean,
// its hidden layer, the gate, s * g, the stream sum, the block output, the
// transition output and the pooled output. Shared memory holds T: every
// value stored there is already rounded to T.
//
// Bound: at G = 480 crops x0_25's three stages do 15.1 GFLOP on 29.6 MB
// of bf16 activations in and out, 0.015 ms at the bf16 tensor-core peak
// and 0.23 ms at the float32 CUDA-core peak.
//
// Built for the stages of the four released widths (x0_25, x0_5, x0_75,
// x1_0) at 128x64 crops: 512, 128 and 32 pixels, mid 16 to 128. Forms of
// one function, all on the body of os_stage_mma.cuh:
//
// - bfloat16, mma.sync m16n8k16: one block per crop (os_stage_mma.cu)
//   for every stage whose crop fits a block's shared memory: the three
//   x0_25 stages, stages 3 and 4 of x0_5 and x0_75 and stage 4 of x1_0;
//   the others (stage 2 of x0_5, x0_75 and x1_0, stage 3 of x1_0) split
//   each crop over a thread block cluster, a band of rows a block
//   (os_stage_cluster.cu);
// - float32, 3xTF32 on mma.sync m16n8k8 (os_stage_tf32.cu, its note
//   there): one block per crop for x0_25's stage 3 and every stage 4,
//   a cluster of blocks a crop for the seven others
//   (os_stage_tf32_cluster.cu).
//
// This header holds what the forms share; os_stage.cu holds the C entry
// points. Each launch compiles apart, so that the build runs them in
// parallel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockEntries = 50;  // entries of one block in the offsets table
// entries within a block's part of the table (stage_weights' _layout)
constexpr int kW1 = 0, kB1 = 1, kLite0 = 2, kG1 = 42, kG1b = 43, kG2 = 44,
              kG2b = 45, kW3 = 46, kB3 = 47, kWd = 48, kBd = 49;
constexpr int kEpW = 100, kEpB = 101;

template <typename T>
__device__ __forceinline__ float to_f(T v);

template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);

template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back to float
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

}  // namespace

// the tensor-core form (os_stage_mma.cu, bfloat16): its dynamic shared
// memory, -1 where it is not built for the stage or a crop does not fit
long long os_stage_mma_bytes(int c_in, int c_out, int mid, int h, int w);
int os_stage_mma(const void* x, const void* mats, const void* vecs,
                 const void* offs, void* out, int G, int c_in, int c_out,
                 int mid, int h, int w, int gap, cudaStream_t s);

// its cluster form (os_stage_cluster.cu, bfloat16, pool stages): a
// block's dynamic shared memory with a crop in k bands, -1 where it is not
// built for the stage and k or a band does not fit
long long os_stage_cluster_bytes(int c_in, int c_out, int mid, int h, int w,
                                 int k);
int os_stage_cluster(const void* x, const void* mats, const void* vecs,
                     const void* offs, void* out, int G, int c_in, int c_out,
                     int mid, int h, int w, int k, cudaStream_t s);

// the float32 forms (os_stage_tf32.cu, os_stage_tf32_cluster.cu): as the
// two above, on float32 tensors
long long os_stage_tf32_bytes(int c_in, int c_out, int mid, int h, int w);
int os_stage_tf32(const void* x, const void* mats, const void* vecs,
                  const void* offs, void* out, int G, int c_in, int c_out,
                  int mid, int h, int w, int gap, cudaStream_t s);
long long os_stage_tf32_cluster_bytes(int c_in, int c_out, int mid, int h,
                                      int w, int k);
int os_stage_tf32_cluster(const void* x, const void* mats, const void* vecs,
                          const void* offs, void* out, int G, int c_in,
                          int c_out, int mid, int h, int w, int k,
                          cudaStream_t s);
