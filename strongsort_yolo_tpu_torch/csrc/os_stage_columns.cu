// K6: the columns form, for float32 (the note, and what the forms share,
// are in os_stage.cuh).

#include "os_stage.cuh"

namespace {

// acc[j] = sum over c ascending of w[(o0 + j) * n_in + c] * in[c * P + p],
// j < 8: eight output channels of a pointwise product at one pixel, each
// summed in the register form's order
template <typename T, int P>
__device__ __forceinline__ void dot8(const T* __restrict__ w, const T* in,
                                     int n_in, int o0, int p, float* acc) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  for (int c = 0; c < n_in; ++c) {
    const float v = to_f<T>(in[c * P + p]);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = acc[j] + to_f<T>(w[(o0 + j) * n_in + c]) * v;
  }
}

// The columns form (see the note at the top): the register form's
// arithmetic with mid a loop bound and y, s and agg as T columns of the
// workspace. scratch null: the workspace (X, XA, two lite buffers, y, s,
// agg) follows the gate's float arrays in shared memory; else it is the
// crop's (c_out + 5 mid, P) block of scratch and X is read from x.
// mid and c_out are multiples of 8.
template <typename T, int NT>
__global__ void __launch_bounds__(NT)
    os_stage_columns_kernel(const T* __restrict__ x, const T* __restrict__ mats,
                            const float* __restrict__ vecs,
                            const int32_t* __restrict__ offs, T* __restrict__ out,
                            T* scratch, int c_in, int c_out, int mid, int h,
                            int w, int gap) {
  constexpr int P = NT;  // one thread per pixel
  constexpr int kWarps = NT / 32;
  const int R = mid / 16 > 0 ? mid / 16 : 1;  // the gate's hidden width
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);  // (kWarps, mid)
  float* gmean = part + kWarps * mid;            // (mid,) the gate's mean
  float* gval = gmean + mid;                     // (mid,) the gate
  float* ghid = gval + mid;                      // (R,) its hidden layer

  const int p = threadIdx.x;
  const int py = p / w, px = p % w;
  const int lane = p & 31, warp = p >> 5;
  const int64_t g = blockIdx.x;

  const T* xg = x + g * c_in * P;
  const T* xs;
  T* cols;
  if (scratch == nullptr) {
    T* ws = reinterpret_cast<T*>(ghid + 8);
    for (int c = 0; c < c_in; ++c) ws[c * P + p] = xg[c * P + p];
    xs = ws;
    cols = ws + c_in * P;
  } else {
    xs = xg;
    cols = scratch + g * (int64_t)(c_out + 5 * mid) * P;
  }
  T* xa = cols;                   // (c_out, P) block output
  T* ubuf = xa + c_out * P;       // 2 x (mid, P) lite pointwise outputs
  T* ycol = ubuf + 2 * mid * P;   // (mid, P) conv1's output y
  T* scol = ycol + mid * P;       // (mid, P) the current stream s
  T* acol = scol + mid * P;       // (mid, P) the aggregate

  int parity = 0;  // which U buffer the next lite conv writes
  float acc[8];
#pragma unroll 1
  for (int blk = 0; blk < 2; ++blk) {
    const int32_t* bo = offs + blk * kBlockEntries;
    const int cin = blk == 0 ? c_in : c_out;
    const T* src = blk == 0 ? xs : xa;

    // conv1 -> relu -> round
    {
      const T* w1 = mats + bo[kW1];
      const float* b1 = vecs + bo[kB1];
      for (int m0 = 0; m0 < mid; m0 += 8) {
        dot8<T, P>(w1, src, cin, m0, p, acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ycol[(m0 + j) * P + p] = from_f<T>(fmaxf(acc[j] + b1[m0 + j], 0.0f));
          acol[(m0 + j) * P + p] = from_f<T>(0.0f);
        }
      }
    }

#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
#pragma unroll 1
      for (int k = 0; k <= t; ++k) {
        const int32_t* lo = bo + kLite0 + 4 * (t * (t + 1) / 2 + k);
        const T* pw = mats + lo[0];
        const float* pwb = vecs + lo[1];
        const float* taps = vecs + lo[2];
        const float* dwb = vecs + lo[3];
        const T* sin = k == 0 ? ycol : scol;  // the stream starts at y
        T* u = ubuf + parity * mid * P;
        parity ^= 1;
        // pointwise -> round, into the lite buffer
        for (int m0 = 0; m0 < mid; m0 += 8) {
          dot8<T, P>(pw, sin, mid, m0, p, acc);
#pragma unroll
          for (int j = 0; j < 8; ++j) u[(m0 + j) * P + p] = from_f<T>(acc[j] + pwb[m0 + j]);
        }
        __syncthreads();  // one barrier per lite conv, as the register form
        // 3x3 depthwise stencil, dy outer and dx inner, zero outside the
        // crop, then + bias -> relu -> round
        for (int m = 0; m < mid; ++m) {
          float a = 0.0f;
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              const int yy = py + dy, xx = px + dx;
              if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
                a = a + to_f<T>(u[m * P + yy * w + xx]) *
                            taps[((dy + 1) * 3 + dx + 1) * mid + m];
              }
            }
          }
          scol[m * P + p] = from_f<T>(fmaxf(a + dwb[m], 0.0f));
        }
      }

      // the gate: per-channel sums over the crop, warp shuffles then the
      // warps' partials in order
      for (int m = 0; m < mid; ++m) {
        float v = to_f<T>(scol[m * P + p]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) part[warp * mid + m] = v;
      }
      __syncthreads();
      for (int m = p; m < mid; m += NT) {
        float sum = 0.0f;
        for (int q = 0; q < kWarps; ++q) sum = sum + part[q * mid + m];
        gmean[m] = round_t<T>(sum / (float)P);
      }
      __syncthreads();
      const T* g1 = mats + bo[kG1];
      const float* g1b = vecs + bo[kG1b];
      const T* g2 = mats + bo[kG2];
      const float* g2b = vecs + bo[kG2b];
      for (int j = p; j < R; j += NT) {
        float a = 0.0f;
        for (int c = 0; c < mid; ++c) a = a + to_f<T>(g1[j * mid + c]) * gmean[c];
        ghid[j] = round_t<T>(fmaxf(a + g1b[j], 0.0f));
      }
      __syncthreads();
      for (int m = p; m < mid; m += NT) {
        float z = 0.0f;
        for (int j = 0; j < R; ++j) z = z + to_f<T>(g2[m * R + j]) * ghid[j];
        z = z + g2b[m];
        gval[m] = round_t<T>(1.0f / (1.0f + expf(-z)));
      }
      __syncthreads();
      for (int m = 0; m < mid; ++m) {
        const float gs = round_t<T>(to_f<T>(scol[m * P + p]) * gval[m]);
        acol[m * P + p] = from_f<T>(to_f<T>(acol[m * P + p]) + gs);
      }
    }

    // conv3 + residual -> relu -> round, into XA (own pixel's column)
    const T* w3 = mats + bo[kW3];
    const float* b3 = vecs + bo[kB3];
    const int wd_off = bo[kWd];
    const T* wd = mats + (wd_off < 0 ? 0 : wd_off);
    const float* bd = vecs + (wd_off < 0 ? 0 : bo[kBd]);
    for (int co0 = 0; co0 < c_out; co0 += 8) {
      float res[8];
      if (wd_off >= 0) {
        dot8<T, P>(wd, src, cin, co0, p, res);
#pragma unroll
        for (int j = 0; j < 8; ++j) res[j] = res[j] + bd[co0 + j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) res[j] = to_f<T>(src[(co0 + j) * P + p]);
      }
      dot8<T, P>(w3, acol, mid, co0, p, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float o = acc[j] + b3[co0 + j];
        xa[(co0 + j) * P + p] = from_f<T>(fmaxf(o + res[j], 0.0f));
      }
    }
  }
  __syncthreads();

  stage_epilogue<T, NT>(xa, mats, vecs, offs, out, c_out, h, w, gap, g, p);
}

template <typename T, int NT>
int launch_columns(const void* x, const void* mats, const void* vecs,
                   const void* offs, void* out, void* scratch, int G, int c_in,
                   int c_out, int mid, int h, int w, int gap,
                   cudaStream_t stream) {
  const long long bytes =
      columns_bytes<T>(c_in, c_out, mid, NT, scratch == nullptr);
  auto kernel = os_stage_columns_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, NT, (size_t)bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mats),
      static_cast<const float*>(vecs), static_cast<const int32_t*>(offs),
      static_cast<T*>(out), static_cast<T*>(scratch), c_in, c_out, mid, h, w,
      gap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_columns(const void* x, const void* mats, const void* vecs,
                     const void* offs, void* out, void* scratch, int G,
                     int c_in, int c_out, int mid, int h, int w, int gap,
                     cudaStream_t s) {
  const int pixels = h * w;
  if (pixels == 512)
    return launch_columns<T, 512>(x, mats, vecs, offs, out, scratch, G, c_in, c_out, mid, h, w, gap, s);
  if (pixels == 128)
    return launch_columns<T, 128>(x, mats, vecs, offs, out, scratch, G, c_in, c_out, mid, h, w, gap, s);
  if (pixels == 32)
    return launch_columns<T, 32>(x, mats, vecs, offs, out, scratch, G, c_in, c_out, mid, h, w, gap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int os_stage_columns(const void* x, const void* mats, const void* vecs,
                     const void* offs, void* out, void* scratch, int G,
                     int c_in, int c_out, int mid, int h, int w, int gap,
                     cudaStream_t s) {
  if (mid % 8 != 0 || c_out % 8 != 0 || mid / 16 > 8) return (int)cudaErrorInvalidValue;
  return dispatch_columns<float>(x, mats, vecs, offs, out, scratch, G, c_in, c_out, mid,
                                 h, w, gap, s);
}
