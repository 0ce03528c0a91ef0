// K5: the GAT edge-softmax partial over one padded ELL adjacency:
//   e[i,k]   = LeakyReLU_0.2(s_dst[i] + s_src[nbr[i,k]]), -1e30 where
//              valid[i,k] is false;
//   m[i]     = max_k e[i,k];  l[i] = sum_k exp(e[i,k] - m[i]);
//   acc[i,f] = sum_k exp(e[i,k] - m[i]) * z[nbr[i,k], f];
// as the online softmax (m, l, acc) the caller merges across DIGEST's in-
// and out-of-subgraph edge sets (kernels/gat_edge/ref.py::merge_partials).
//
// Replaces the TPU kernel src/repro/kernels/gat_edge/gat_edge.py::
// gat_edge_partial_pallas (body _gat_kernel), and keeps its arithmetic:
// the degree loop updates m, l and acc online, k = 0 .. deg-1 in order.
// The reference's 128-row / 128-feature divisibility guard was a TPU
// tiling limit: here the grid masks its own ragged edges.
//
// What bounds it on an H100: bytes.  Per edge and feature it does one
// FMA and a rescale against one gathered z element (about 0.5 FLOP per
// byte); per edge one gathered score and two exps.  The least traffic is
// nbr, valid, s_dst, the referenced s_src and z rows, acc, m and l, each
// once: about 5 MB at GAT's per-head shape on the papers-sim partition.
//
// Design: one thread per (row, feature), the layout of the ELL SpMM
// (common.cuh): a warp reads consecutive features of one gathered z row,
// and the row's nbr/valid/s_src entries are broadcast loads.  Every thread
// of a row repeats the scalar score and softmax update (cheap next to the
// gather) so no thread waits on another; the thread of feature 0 writes m
// and l.  No atomics: the result is the same run to run.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLeakySlope = 0.2f;

__global__ void __launch_bounds__(kThreadsPerBlock)
gat_edge_kernel(const int32_t* __restrict__ nbr,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ s_dst,
                const float* __restrict__ s_src, const float* __restrict__ z,
                float* __restrict__ acc_out, float* __restrict__ m_out,
                float* __restrict__ l_out, int rows, int deg, int feat) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= rows || f >= feat) return;
  const int32_t* nr = nbr + static_cast<int64_t>(r) * deg;
  const uint8_t* vr = valid + static_cast<int64_t>(r) * deg;
  const float sd = s_dst[r];
  float m = kNegInf, l = 0.f, acc = 0.f;
  for (int k = 0; k < deg; ++k) {
    const int64_t idx = nr[k];
    float e = sd + s_src[idx];
    e = e >= 0.f ? e : kLeakySlope * e;
    if (!vr[k]) e = kNegInf;
    const float m_new = fmaxf(m, e);
    const float alpha = expf(m - m_new);
    const float p = expf(e - m_new);
    l = alpha * l + p;
    acc = acc * alpha + p * z[idx * feat + f];
    m = m_new;
  }
  acc_out[static_cast<int64_t>(r) * feat + f] = acc;
  if (f == 0) {
    m_out[r] = m;
    l_out[r] = l;
  }
}

}  // namespace

extern "C" int gat_edge_partial_launch(const void* nbr, const void* valid,
                                       const void* s_dst, const void* s_src,
                                       const void* z, void* acc, void* m,
                                       void* l, int rows, int deg, int feat,
                                       void* stream) {
  if (rows == 0 || feat == 0) return 0;
  const dim3 block = ell_block(feat);
  gat_edge_kernel<<<ell_grid(rows, feat, block), block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(s_dst), static_cast<const float*>(s_src),
      static_cast<const float*>(z), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), rows, deg, feat);
  return static_cast<int>(cudaGetLastError());
}
