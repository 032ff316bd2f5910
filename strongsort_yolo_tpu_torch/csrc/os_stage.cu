// K6: one fused OSNet backbone stage per crop: the C entry points (the
// note, and what the forms share, are in os_stage.cuh; the forms are in
// os_stage_mma.cu, os_stage_cluster.cu, os_stage_tf32.cu and
// os_stage_tf32_cluster.cu).

#include "os_stage.cuh"

// Dynamic shared memory of a block of the form the stage takes (cluster:
// the blocks a crop is split over, 1 for one block a crop), in bfloat16
// (bf16 = 1) or float32; -1 where the form is not built for the stage and
// split or does not fit a block.
extern "C" long long ssyt_os_stage_smem_bytes(int c_in, int c_out, int mid,
                                              int h, int w, int bf16,
                                              int cluster) {
  if (bf16) {
    return cluster > 1 ? os_stage_cluster_bytes(c_in, c_out, mid, h, w, cluster)
                       : os_stage_mma_bytes(c_in, c_out, mid, h, w);
  }
  return cluster > 1 ? os_stage_tf32_cluster_bytes(c_in, c_out, mid, h, w, cluster)
                     : os_stage_tf32_bytes(c_in, c_out, mid, h, w);
}

// The form a stage takes: 0 bfloat16 tensor cores, 1 the same in a cluster
// of `cluster` blocks a crop, 2 float32 3xTF32 tensor cores, 3 the same in
// a cluster; -1 none.
extern "C" int ssyt_os_stage_form(int c_in, int c_out, int mid, int h, int w,
                                  int bf16, int cluster) {
  if (cluster < 1 || ssyt_os_stage_smem_bytes(c_in, c_out, mid, h, w, bf16, cluster) < 0)
    return -1;
  return (bf16 ? 0 : 2) + (cluster > 1 ? 1 : 0);
}

// One stage on G crops in the form ssyt_os_stage_form names; a stage and
// split that no form is built for, or a cluster on the last stage, is
// refused with cudaErrorInvalidValue.
extern "C" int ssyt_os_stage(const void* x, const void* mats, const void* vecs,
                             const void* offs, void* out, int G, int c_in,
                             int c_out, int mid, int h, int w, int gap,
                             int bf16, int cluster, void* stream) {
  if (G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster < 1 || (cluster > 1 && gap)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    return cluster > 1 ? os_stage_cluster(x, mats, vecs, offs, out, G, c_in, c_out, mid,
                                          h, w, cluster, s)
                       : os_stage_mma(x, mats, vecs, offs, out, G, c_in, c_out, mid, h,
                                      w, gap, s);
  }
  return cluster > 1 ? os_stage_tf32_cluster(x, mats, vecs, offs, out, G, c_in, c_out,
                                             mid, h, w, cluster, s)
                     : os_stage_tf32(x, mats, vecs, offs, out, G, c_in, c_out, mid, h, w,
                                     gap, s);
}
