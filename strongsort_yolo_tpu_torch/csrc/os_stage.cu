// K6: one fused OSNet backbone stage per crop: the register form and the
// C entry points (the note, and what the forms share, are in
// os_stage.cuh; the columns form is in os_stage_columns.cu, the
// tensor-core forms in os_stage_mma.cu and os_stage_cluster.cu).

#include "os_stage.cuh"

namespace {

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

  stage_epilogue<T, NT>(xa, mats, vecs, offs, out, c_out, h, w, gap, g, p);
}

// bytes of the register form's dynamic shared memory
template <typename T>
long long register_bytes(int c_in, int c_out, int mid, int pixels) {
  return (long long)(c_in + c_out + 2 * mid) * pixels * sizeof(T) +
         (long long)(pixels / 32 + 2) * mid * sizeof(float);
}

bool has_register_form(int mid, int pixels) {
  return (mid == 16 && pixels == 512) || (mid == 24 && pixels == 128) ||
         (mid == 32 && pixels == 32);
}

template <typename T, int MID, int NT>
int launch_registers(const void* x, const void* mats, const void* vecs,
                     const void* offs, void* out, int G, int c_in, int c_out,
                     int h, int w, int gap, cudaStream_t stream) {
  const long long bytes = register_bytes<T>(c_in, c_out, MID, NT);
  auto kernel = os_stage_kernel<T, MID, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, NT, (size_t)bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mats),
      static_cast<const float*>(vecs), static_cast<const int32_t*>(offs),
      static_cast<T*>(out), c_in, c_out, h, w, gap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* mats, const void* vecs,
             const void* offs, void* out, void* scratch, int G, int c_in,
             int c_out, int mid, int h, int w, int gap, cudaStream_t s) {
  const int pixels = h * w;
  if (scratch == nullptr && has_register_form(mid, pixels)) {
    if (mid == 16)
      return launch_registers<T, 16, 512>(x, mats, vecs, offs, out, G, c_in, c_out, h, w, gap, s);
    if (mid == 24)
      return launch_registers<T, 24, 128>(x, mats, vecs, offs, out, G, c_in, c_out, h, w, gap, s);
    return launch_registers<T, 32, 32>(x, mats, vecs, offs, out, G, c_in, c_out, h, w, gap, s);
  }
  return os_stage_columns(x, mats, vecs, offs, out, scratch, G, c_in, c_out,
                          mid, h, w, gap, s);
}

}  // namespace

// Dynamic shared memory of a block of the form the stage takes (cluster:
// the blocks a crop is split over in bfloat16, 1 for one block a crop):
// in bfloat16 the tensor-core form, or its cluster form; in float32 the
// register form where it is built for (mid, h*w), else the columns form
// with its workspace in shared memory. -1 where the form is not built
// for the stage or does not fit. Above what a block can use (float32
// only), the wrapper passes a (G, c_out + 5 mid, h*w) float32 scratch.
extern "C" long long ssyt_os_stage_smem_bytes(int c_in, int c_out, int mid,
                                              int h, int w, int bf16,
                                              int cluster) {
  const int pixels = h * w;
  if (bf16) {
    return cluster > 1 ? os_stage_cluster_bytes(c_in, c_out, mid, h, w, cluster)
                       : os_stage_mma_bytes(c_in, c_out, mid, h, w);
  }
  if (cluster != 1) return -1;
  if (has_register_form(mid, pixels))
    return register_bytes<float>(c_in, c_out, mid, pixels);
  return columns_bytes<float>(c_in, c_out, mid, pixels, true);
}

// The form a stage takes: 0 registers, 1 columns in shared memory, 2
// columns in the global scratch, 3 tensor cores, 4 tensor cores in a
// cluster of `cluster` blocks a crop; -1 none.
extern "C" int ssyt_os_stage_form(int c_in, int c_out, int mid, int h, int w,
                                  int bf16, int cluster) {
  if (bf16) {
    if (ssyt_os_stage_smem_bytes(c_in, c_out, mid, h, w, 1, cluster) < 0) return -1;
    return cluster > 1 ? 4 : 3;
  }
  if (cluster != 1) return -1;
  if (has_register_form(mid, h * w)) return 0;
  return ssyt_os_stage_smem_bytes(c_in, c_out, mid, h, w, 0, 1) <= 227 * 1024 ? 1 : 2;
}

// bfloat16 takes the tensor-core form (cluster 1) or its cluster form,
// float32 the register or the columns form (cluster 1); any other stage
// and split is refused with cudaErrorInvalidValue.
extern "C" int ssyt_os_stage(const void* x, const void* mats, const void* vecs,
                             const void* offs, void* out, void* scratch, int G,
                             int c_in, int c_out, int mid, int h, int w,
                             int gap, int bf16, int cluster, void* stream) {
  if (G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (scratch != nullptr) return (int)cudaErrorInvalidValue;
    if (cluster > 1) {
      if (gap) return (int)cudaErrorInvalidValue;
      return os_stage_cluster(x, mats, vecs, offs, out, G, c_in, c_out, mid, h, w,
                              cluster, s);
    }
    if (cluster != 1) return (int)cudaErrorInvalidValue;
    return os_stage_mma(x, mats, vecs, offs, out, G, c_in, c_out, mid, h, w, gap, s);
  }
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  return dispatch<float>(x, mats, vecs, offs, out, scratch, G, c_in, c_out,
                         mid, h, w, gap, s);
}
