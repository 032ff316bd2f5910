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
// unit. That layout is not carried over. Here one thread block computes one
// crop's whole stage, one thread per pixel:
//
// - the pointwise convs, the gate scaling, conv3, the residual and the
//   aggregation need only their own pixel, so the narrow activations of a
//   pixel (conv1's output y, the current stream s and the aggregate, mid
//   values each) stay in registers;
// - only the lite convs' pointwise outputs need neighbours, for the 3x3
//   stencil: they go to shared memory, ping-ponged between two buffers, so
//   each lite conv costs one barrier;
// - the block input X and the first block's output XA (c_in and c_out
//   wide) sit in shared memory, each pixel's column read and written only
//   by its own thread; the second block writes its output over XA in
//   place (its residual is the identity);
// - the gate's per-channel mean is a fixed-order reduction (warp shuffles,
//   then the warps' partial sums in order), so launches are bit-identical;
// - the epilogue runs after one barrier: threads walk (output channel,
//   output pixel) pairs, the pool computing the four pixels of a window,
//   the GAP all pixels of a channel, in a fixed order.
//
// Weights are read from global memory through the read-only cache, every
// thread of a warp reading the same element (a broadcast): stage 4's
// weights alone are 283 KB in float32, more than a block's shared memory.
// (The tensor-core form, os_stage_mma.cu, reads them as mma fragments.)
//
// Rounding follows the TPU kernel (and the plain version, ops/cuda/
// osnet_kernel.py::os_stage_plain): products accumulate in float32, each
// product and sum rounded on its own (the build passes -fmad=false), and
// the values are rounded to the compute dtype T where the TPU kernel
// casts: conv1, the lite pointwise, the stencil output, the gate's mean,
// its hidden layer, the gate, s * g, the stream sum, the block output, the
// transition output and the pooled output. Shared memory holds T: every
// value stored there is already rounded to T.
//
// Bound: at G = 480 crops the three stages do 15.1 GFLOP on 29.6 MB of
// bf16 activations in and out, 0.015 ms at the bf16 tensor-core peak and
// 0.23 ms at the float32 CUDA-core peak. The CUDA-core forms are bound by
// their instruction count: every multiply-add is a weight load, a
// multiply and an add. In bfloat16 the 1x1 products run on the tensor
// cores instead (os_stage_mma.cu).
//
// Built for the stages of the four released widths (x0_25, x0_5, x0_75,
// x1_0) at 128x64 crops: 512, 128 and 32 pixels, mid 16 to 128. Forms of
// one function:
//
// - bfloat16: the tensor-core form (os_stage_mma.cu, its note there), one
//   block per crop, for every stage whose crop fits a block's shared
//   memory: the three x0_25 stages, stages 3 and 4 of x0_5 and x0_75 and
//   stage 4 of x1_0; the others (stage 2 of x0_5, x0_75 and x1_0, stage
//   3 of x1_0) take its cluster form (os_stage_cluster.cu), each crop
//   split over a thread block cluster, a band of rows a block;
// - float32 (the tensor cores would take it only as TF32): the register
//   form above, with mid a template constant and y, agg and s in
//   registers: the OSNet-x0_25 stages, (mid, pixels) = (16, 512), (24,
//   128) and (32, 32), whose X, XA and lite buffers fit shared memory;
// - the columns form, for every other float32 stage: mid is a loop
//   bound, and y, s and agg become columns of a workspace, as X, XA and
//   the lite buffers are, each pixel's column read and written by its own
//   thread: registers no longer hold 3 * mid floats at mid 64-128, and
//   the loops would unroll into megabytes of code. The workspace, (c_in +
//   c_out + 5 mid, pixels) floats, sits in shared memory where it fits a
//   block; otherwise the wrapper allocates a global scratch of (G, c_out
//   + 5 mid, pixels) floats, X is read from the input in place, and the
//   columns go through L1 and L2 (x1_0's stage 2 needs 1.2 MB per crop).
//
// This header holds what the forms share; os_stage.cu holds the register
// form and the C entry points, os_stage_columns.cu the columns form,
// os_stage_mma.cu and os_stage_cluster.cu the tensor-core forms (their
// body in os_stage_mma.cuh), compiled apart so that the build runs them
// in parallel.

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

// epilogue: 1x1 -> relu -> round, then the 2x2 mean or the global mean;
// threads walk (output channel, output pixel) pairs in a fixed order
template <typename T, int NT>
__device__ __forceinline__ void stage_epilogue(
    const T* xa, const T* __restrict__ mats, const float* __restrict__ vecs,
    const int32_t* __restrict__ offs, T* __restrict__ out, int c_out, int h,
    int w, int gap, int64_t g, int p) {
  constexpr int P = NT;
  const T* ew = mats + offs[kEpW];
  const float* eb = vecs + offs[kEpB];
  if (gap) {
    for (int co = p; co < c_out; co += NT) {
      float sum = 0.0f;
      for (int q = 0; q < P; ++q) {
        float e = 0.0f;
        for (int c = 0; c < c_out; ++c) e = e + to_f<T>(ew[co * c_out + c]) * to_f<T>(xa[c * P + q]);
        sum = sum + round_t<T>(fmaxf(e + eb[co], 0.0f));
      }
      out[g * c_out + co] = from_f<T>(sum / (float)P);
    }
  } else {
    const int w2 = w / 2, nq = (h / 2) * w2;
    for (int i = p; i < nq * c_out; i += NT) {
      const int co = i / nq, q = i % nq;
      const int top = (q / w2) * 2 * w + (q % w2) * 2;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pp = top + (k >> 1) * w + (k & 1);
        float e = 0.0f;
        for (int c = 0; c < c_out; ++c) e = e + to_f<T>(ew[co * c_out + c]) * to_f<T>(xa[c * P + pp]);
        sum = sum + round_t<T>(fmaxf(e + eb[co], 0.0f));
      }
      out[(g * c_out + co) * nq + q] = from_f<T>(sum * 0.25f);
    }
  }
}

// bytes of the columns form's: the gate's float arrays, plus the
// workspace where it is in shared memory
template <typename T>
long long columns_bytes(int c_in, int c_out, int mid, int pixels, bool shared) {
  const long long floats = (long long)(pixels / 32 + 2) * mid + 8;
  return floats * sizeof(float) +
         (shared ? (long long)(c_in + c_out + 5 * mid) * pixels * sizeof(T) : 0);
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

// the columns form's launch (os_stage_columns.cu, float32): scratch null
// puts the workspace in shared memory
int os_stage_columns(const void* x, const void* mats, const void* vecs,
                     const void* offs, void* out, void* scratch, int G,
                     int c_in, int c_out, int mid, int h, int w, int gap,
                     cudaStream_t s);
