// K1: letterbox of uint8 BGR frames into the model's NCHW input.
//
// Replaces strongsort_yolo_tpu/ops/pallas/resize_kernel.py
// (decimate_resize_planar, decimate_resize_contig, decimate_resize): the
// TPU kernels decimate 1080p frames to 640x360 and leave the 114 bars,
// the BGR->RGB flip and the /255 to the stem conv (ops/stem_fuse.py).
// Here one kernel writes the finished (B, 3, S, S) input: a separable
// two-tap cv2 INTER_LINEAR resize (half-pixel centres, edge clamp) from
// per-row and per-column (lo, hi, w_lo, w_hi) tables built on the host,
// the flip, the bars and the /255, with one rounding to the output type.
// Pure decimation is the w_hi = 0 case of the same tables.
//
// Bound: memory. At S=8 from 1080p it reads the 360 weighed source rows
// of each frame (16.6 MB) and writes 19.7 MB of bf16 output; there is
// little arithmetic. The design: one block per (output row, frame), so
// no thread splits a flat index by a runtime size (a 64-bit division is
// a software routine of dozens of instructions); the frame's base is
// 64-bit once per block, offsets inside a row are 32-bit.
// - A bar row (above or below the picture) stores the gray with 16-byte
//   vector stores and exits.
// - A content row reads its row taps once; each thread then writes a run
//   of 8 consecutive output columns of all three planes (16-byte stores
//   in bf16, two in f32), reading each source pixel's BGR bytes once for
//   the three planes, straight from the frame through L1 (row y1 only
//   where its weight is not 0). A run may straddle a side bar (`left`
//   need not be a multiple of 8): each element decides content or bar on
//   its own. Where all four weights are 1 and 0 (decimation) a 256-entry
//   table of byte / 255, built by the rows that use it, replaces the
//   products and the division.
// Staging the source rows in shared memory with 16-byte loads was slower
// than reading them in place (tools/prof_resample.py).
//
// Arithmetic order matches the plain PyTorch version
// (strongsort_yolo_tpu_torch/ops/letterbox.py::letterbox) exactly: rows
// first, then columns, every product and sum rounded on its own (the
// _rn intrinsics, and the build passes -fmad=false), then v / 255. A hi
// tap of weight 0 is not read: pixels and weights are >= 0, so its
// product is +0, and s + (+0) == s for every s >= 0, bit for bit. The lo
// tap is always read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 8;                 // output columns per thread and run
constexpr int kMaxFramesPerLaunch = 65535;  // gridDim.y

template <typename T>
__device__ __forceinline__ T to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two bf16 values as one 32-bit word, a first.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// Eight values to dst: 16-byte stores where `whole` (dst 16-byte aligned,
// all eight inside the row), else the first n one at a time.
__device__ __forceinline__ void store_run(__nv_bfloat16* dst,
                                          const __nv_bfloat16* v, bool whole,
                                          int n) {
  if (whole) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (i < n) dst[i] = v[i];
}

__device__ __forceinline__ void store_run(float* dst, const float* v,
                                          bool whole, int n) {
  if (whole) {
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (i < n) dst[i] = v[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    letterbox_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst,
                     const int32_t* __restrict__ taps_idx,
                     const float* __restrict__ taps_w, int n_taps, int H,
                     int W, int size, int new_h, int new_w, int top, int left,
                     float pad_value, int b0) {
  __shared__ T s_div255[256];  // b / 255 rounded to T, for each byte b
  const int y = blockIdx.x;
  const int b = b0 + blockIdx.y;
  const int n_runs = (size + kRun - 1) / kRun;
  // size a multiple of 8 keeps every run's start 16-byte aligned (the
  // wrapper allocates the output)
  const bool vec = (size % kRun) == 0;
  T* out0 = dst + ((int64_t)b * 3 * size + y) * size;
  const int64_t plane = (int64_t)size * size;
  const T pad = to_out<T>(__fdiv_rn(pad_value, 255.0f));

  const int yy = y - top;
  if (yy < 0 || yy >= new_h) {  // a bar row
    T v[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = pad;
    for (int i = threadIdx.x; i < 3 * n_runs; i += kThreads) {
      const int c = i / n_runs;  // 32-bit, once per 8 values of a plane
      const int x = (i - c * n_runs) * kRun;
      store_run(out0 + c * plane + x, v, vec && x + kRun <= size,
                min(kRun, size - x));
    }
    return;
  }

  const int y0 = __ldg(taps_idx + yy), y1 = __ldg(taps_idx + n_taps + yy);
  const float wy0 = __ldg(taps_w + yy), wy1 = __ldg(taps_w + n_taps + yy);
  const int row_bytes = 3 * W;
  const uint8_t* frame = src + (int64_t)b * H * row_bytes;
  const uint8_t* __restrict__ r0 = frame + (int64_t)y0 * row_bytes;
  const uint8_t* __restrict__ r1 = frame + (int64_t)y1 * row_bytes;
  // weights of exactly 1 and 0 (decimation) leave the pixel as it is: its
  // rounded v / 255 comes from the table, the same value bit for bit; the
  // condition is the same for the whole block, and so is the barrier
  const bool unit_row = wy0 == 1.0f && wy1 == 0.0f;
  if (unit_row) {
    for (int i = threadIdx.x; i < 256; i += kThreads)
      s_div255[i] = to_out<T>(__fdiv_rn((float)i, 255.0f));
    __syncthreads();
  }

  const int32_t* cx_lo = taps_idx + new_h;
  const int32_t* cx_hi = taps_idx + n_taps + new_h;
  const float* cw_lo = taps_w + new_h;
  const float* cw_hi = taps_w + n_taps + new_h;
  for (int run = threadIdx.x; run < n_runs; run += kThreads) {
    const int x = run * kRun;
    T v[3][kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int xx = x + j - left;
      if (xx < 0 || xx >= new_w) {  // a side bar (or past the row)
        v[0][j] = v[1][j] = v[2][j] = pad;
        continue;
      }
      const int x0 = 3 * __ldg(cx_lo + xx), x1 = 3 * __ldg(cx_hi + xx);
      const float wx0 = __ldg(cw_lo + xx), wx1 = __ldg(cw_hi + xx);
      if (unit_row && wx0 == 1.0f && wx1 == 0.0f) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c][j] = s_div255[__ldg(r0 + x0 + 2 - c)];
        continue;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int sc = 2 - c;  // BGR -> RGB
        float t0 = __fmul_rn(wy0, (float)__ldg(r0 + x0 + sc));
        if (wy1 != 0.0f)
          t0 = __fadd_rn(t0, __fmul_rn(wy1, (float)__ldg(r1 + x0 + sc)));
        float s = __fmul_rn(wx0, t0);
        if (wx1 != 0.0f) {
          float t1 = __fmul_rn(wy0, (float)__ldg(r0 + x1 + sc));
          if (wy1 != 0.0f)
            t1 = __fadd_rn(t1, __fmul_rn(wy1, (float)__ldg(r1 + x1 + sc)));
          s = __fadd_rn(s, __fmul_rn(wx1, t1));
        }
        v[c][j] = to_out<T>(__fdiv_rn(s, 255.0f));
      }
    }
    const bool whole = vec && x + kRun <= size;
    const int n = min(kRun, size - x);
#pragma unroll
    for (int c = 0; c < 3; ++c) store_run(out0 + c * plane + x, v[c], whole, n);
  }
}

template <typename T>
int launch(const uint8_t* in, T* out, const int32_t* ti, const float* tw,
           int B, int H, int W, int size, int new_h, int new_w, int top,
           int left, float pad_value, cudaStream_t s) {
  const int n_taps = new_h + new_w;
  for (int b0 = 0; b0 < B; b0 += kMaxFramesPerLaunch) {
    const dim3 grid(size, min(B - b0, kMaxFramesPerLaunch));
    letterbox_kernel<T><<<grid, kThreads, 0, s>>>(
        in, out, ti, tw, n_taps, H, W, size, new_h, new_w, top, left,
        pad_value, b0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" int ssyt_letterbox_u8(const void* src, void* dst, int out_bf16,
                                 const void* taps_idx, const void* taps_w,
                                 int B, int H, int W, int size, int new_h,
                                 int new_w, int top, int left, float pad_value,
                                 void* stream) {
  if ((int64_t)B * size == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  const int32_t* ti = static_cast<const int32_t*>(taps_idx);
  const float* tw = static_cast<const float*>(taps_w);
  if (out_bf16) {
    return launch<__nv_bfloat16>(in, static_cast<__nv_bfloat16*>(dst), ti,
                                 tw, B, H, W, size, new_h, new_w, top, left,
                                 pad_value, s);
  }
  return launch<float>(in, static_cast<float*>(dst), ti, tw, B, H, W, size,
                       new_h, new_w, top, left, pad_value, s);
}
