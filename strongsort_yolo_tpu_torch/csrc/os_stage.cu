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
// 0.23 ms at the float32 CUDA-core peak. This first kernel runs on the
// CUDA cores and is bound by its instruction count: every multiply-add is
// a weight load, a multiply and an add. Tensor cores (mma on the pointwise
// products) are left to a later kernel.
//
// Built for OSNet-x0_25 at 128x64 crops: (mid, pixels) = (16, 512),
// (24, 128) and (32, 32), the three stages; other shapes are refused.

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

template <typename T, int MID, int NT>
__global__ void __launch_bounds__(NT)
    os_stage_kernel(const T* __restrict__ x, const T* __restrict__ mats,
                    const float* __restrict__ vecs,
                    const int32_t* __restrict__ offs, T* __restrict__ out,
                    int c_in, int c_out, int h, int w, int gap) {
  constexpr int P = NT;  // one thread per pixel
  constexpr int kWarps = NT / 32;
  constexpr int R = MID / 16 > 0 ? MID / 16 : 1;  // the gate's hidden width
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // (c_in, P) block input
  T* xa = xs + c_in * P;               // (c_out, P) block output
  T* ubuf = xa + c_out * P;            // 2 x (MID, P) lite pointwise outputs
  float* part = reinterpret_cast<float*>(ubuf + 2 * MID * P);  // (kWarps, MID)
  float* gmean = part + kWarps * MID;  // (MID,) the gate's mean
  float* gval = gmean + MID;           // (MID,) the gate

  const int p = threadIdx.x;
  const int py = p / w, px = p % w;
  const int lane = p & 31, warp = p >> 5;
  const int64_t g = blockIdx.x;

  const T* xg = x + g * c_in * P;
  for (int c = 0; c < c_in; ++c) xs[c * P + p] = xg[c * P + p];

  int parity = 0;  // which U buffer the next lite conv writes
#pragma unroll 1
  for (int blk = 0; blk < 2; ++blk) {
    const int32_t* bo = offs + blk * kBlockEntries;
    const int cin = blk == 0 ? c_in : c_out;
    const T* src = blk == 0 ? xs : xa;

    // conv1 -> relu -> round
    float y[MID];
#pragma unroll
    for (int m = 0; m < MID; ++m) y[m] = 0.0f;
    {
      const T* w1 = mats + bo[kW1];
      for (int c = 0; c < cin; ++c) {
        const float xc = to_f<T>(src[c * P + p]);
#pragma unroll
        for (int m = 0; m < MID; ++m) y[m] = y[m] + to_f<T>(w1[m * cin + c]) * xc;
      }
      const float* b1 = vecs + bo[kB1];
#pragma unroll
      for (int m = 0; m < MID; ++m) y[m] = round_t<T>(fmaxf(y[m] + b1[m], 0.0f));
    }

    float agg[MID];
#pragma unroll
    for (int m = 0; m < MID; ++m) agg[m] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      float s[MID];
#pragma unroll
      for (int m = 0; m < MID; ++m) s[m] = y[m];
#pragma unroll 1
      for (int k = 0; k <= t; ++k) {
        const int32_t* lo = bo + kLite0 + 4 * (t * (t + 1) / 2 + k);
        const T* pw = mats + lo[0];
        const float* pwb = vecs + lo[1];
        const float* taps = vecs + lo[2];
        const float* dwb = vecs + lo[3];
        T* u = ubuf + parity * MID * P;
        parity ^= 1;
        // pointwise -> round, into shared memory
#pragma unroll
        for (int m = 0; m < MID; ++m) {
          float acc = 0.0f;
#pragma unroll
          for (int c = 0; c < MID; ++c) acc = acc + to_f<T>(pw[m * MID + c]) * s[c];
          u[m * P + p] = from_f<T>(acc + pwb[m]);
        }
        // one barrier per lite conv: the other buffer's readers all
        // passed this barrier's predecessor before it is written again
        __syncthreads();
        // 3x3 depthwise stencil, dy outer and dx inner, zero outside the
        // crop, then + bias -> relu -> round
#pragma unroll
        for (int m = 0; m < MID; ++m) {
          float acc = 0.0f;
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              const int yy = py + dy, xx = px + dx;
              if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
                acc = acc + to_f<T>(u[m * P + yy * w + xx]) *
                                taps[((dy + 1) * 3 + dx + 1) * MID + m];
              }
            }
          }
          s[m] = round_t<T>(fmaxf(acc + dwb[m], 0.0f));
        }
      }

      // the gate: per-channel sums over the crop, warp shuffles then the
      // warps' partials in order
#pragma unroll
      for (int m = 0; m < MID; ++m) {
        float v = s[m];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) part[warp * MID + m] = v;
      }
      __syncthreads();
      if (p < MID) {
        float sum = 0.0f;
        for (int q = 0; q < kWarps; ++q) sum = sum + part[q * MID + p];
        gmean[p] = round_t<T>(sum / (float)P);
      }
      __syncthreads();
      if (p < MID) {
        const T* g1 = mats + bo[kG1];
        const float* g1b = vecs + bo[kG1b];
        const T* g2 = mats + bo[kG2];
        const float* g2b = vecs + bo[kG2b];
        float a[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int c = 0; c < MID; ++c) acc = acc + to_f<T>(g1[j * MID + c]) * gmean[c];
          a[j] = round_t<T>(fmaxf(acc + g1b[j], 0.0f));
        }
        float z = 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) z = z + to_f<T>(g2[p * R + j]) * a[j];
        z = z + g2b[p];
        gval[p] = round_t<T>(1.0f / (1.0f + expf(-z)));
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < MID; ++m) {
        // the first stream's 0 + gs is gs itself
        agg[m] = round_t<T>(agg[m] + round_t<T>(s[m] * gval[m]));
      }
    }

    // conv3 + residual -> relu -> round, into XA (own pixel's column)
    const T* w3 = mats + bo[kW3];
    const float* b3 = vecs + bo[kB3];
    const int wd_off = bo[kWd];
    const T* wd = mats + (wd_off < 0 ? 0 : wd_off);
    const float* bd = vecs + (wd_off < 0 ? 0 : bo[kBd]);
    for (int co = 0; co < c_out; ++co) {
      float o = 0.0f;
#pragma unroll
      for (int m = 0; m < MID; ++m) o = o + to_f<T>(w3[co * MID + m]) * agg[m];
      o = o + b3[co];
      float r;
      if (wd_off >= 0) {
        r = 0.0f;
        for (int c = 0; c < cin; ++c) r = r + to_f<T>(wd[co * cin + c]) * to_f<T>(src[c * P + p]);
        r = r + bd[co];
      } else {
        r = to_f<T>(src[co * P + p]);
      }
      xa[co * P + p] = from_f<T>(fmaxf(o + r, 0.0f));
    }
  }
  __syncthreads();

  // epilogue: 1x1 -> relu -> round, then the 2x2 mean or the global mean
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

template <typename T, int MID, int NT>
int launch(const void* x, const void* mats, const void* vecs, const void* offs,
           void* out, int G, int c_in, int c_out, int h, int w, int gap,
           cudaStream_t stream) {
  const size_t bytes = (size_t)(c_in + c_out + 2 * MID) * NT * sizeof(T) +
                       (size_t)(NT / 32 + 2) * MID * sizeof(float);
  auto kernel = os_stage_kernel<T, MID, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mats),
      static_cast<const float*>(vecs), static_cast<const int32_t*>(offs),
      static_cast<T*>(out), c_in, c_out, h, w, gap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* mats, const void* vecs,
             const void* offs, void* out, int G, int c_in, int c_out, int mid,
             int h, int w, int gap, cudaStream_t s) {
  const int pixels = h * w;
  if (mid == 16 && pixels == 512)
    return launch<T, 16, 512>(x, mats, vecs, offs, out, G, c_in, c_out, h, w, gap, s);
  if (mid == 24 && pixels == 128)
    return launch<T, 24, 128>(x, mats, vecs, offs, out, G, c_in, c_out, h, w, gap, s);
  if (mid == 32 && pixels == 32)
    return launch<T, 32, 32>(x, mats, vecs, offs, out, G, c_in, c_out, h, w, gap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssyt_os_stage(const void* x, const void* mats, const void* vecs,
                             const void* offs, void* out, int G, int c_in,
                             int c_out, int mid, int h, int w, int gap,
                             int bf16, void* stream) {
  if (G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(x, mats, vecs, offs, out, G, c_in, c_out,
                                   mid, h, w, gap, s);
  }
  return dispatch<float>(x, mats, vecs, offs, out, G, c_in, c_out, mid, h, w,
                         gap, s);
}
