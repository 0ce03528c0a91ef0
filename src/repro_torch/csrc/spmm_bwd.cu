// The two backward kernels of the ELL SpMM (K1),
//
//   out[i, f] = sum_k wts[i, k] * table[nbr[i, k], f]:
//
//   spmm_bwd_table:  dtable[j, f] = sum_{(i,k): nbr[i,k] = j} wts[i,k] * g[i, f]
//   spmm_bwd_wts:    dwts[i, k]   = sum_f g[i, f] * table[nbr[i, k], f]
//
// No TPU kernel is replaced: the reference takes these gradients by
// autodiff of its jnp oracle (src/repro/kernels/spmm/ref.py::spmm_ref),
// a scatter-add for dtable and a gather-dot for dwts.
//
// What bounds them on an H100: bytes.  Each output element costs one FMA
// per term against one gathered element, as in the forward.  At the
// training shape (papers-sim, one subgraph: in-ELL 5256 x 56, 128 wide)
// spmm_bwd_table moves the positions, the weights, g and dtable, about
// 9 MB; spmm_bwd_wts at GAT's per-head shape (5256 x 56 over 5257 x 32)
// about 5 MB.
//
// What the design does about it, and the numerics.  The scatter-add of
// dtable would need float atomics, whose order changes from run to run.
// spmm_bwd_table gathers instead, through the transposed ELL built on the
// host (repro_torch/graph/transpose.py): one thread per (table row,
// feature) walks that row's flat ELL positions p in ascending order and
// accumulates wts[p] * g[p / deg] with fp32 FMAs; padding (p == rows*deg)
// ends the walk.  A warp reads 32 consecutive features of one g row
// (coalesced); the row's positions and weights are broadcast loads.
// spmm_bwd_wts takes one thread per (row, slot) and sums the feature
// dot product in ascending f with fp32 FMAs.  Neither uses atomics, so
// both results are deterministic.  The sentinel row's positions are not
// in the transpose (it is a constant of the layout), so its dtable row is
// 0.
#include "common.cuh"

__global__ void __launch_bounds__(kThreadsPerBlock)
bwd_table_kernel(const int32_t* __restrict__ pos,
                 const float* __restrict__ wts, const float* __restrict__ g,
                 float* __restrict__ dtab, int n_tab, int t_deg, int deg,
                 int n_pos, int feat) {
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n_tab || f >= feat) return;
  const int32_t* pj = pos + static_cast<int64_t>(j) * t_deg;
  float acc = 0.f;
  for (int t = 0; t < t_deg; ++t) {
    const int p = pj[t];
    if (p >= n_pos) break;               // padding: the row's list ended
    const int64_t i = p / deg;
    acc = __fmaf_rn(wts[p], g[i * feat + f], acc);
  }
  dtab[static_cast<int64_t>(j) * feat + f] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsPerBlock)
bwd_wts_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ g,
               const T* __restrict__ table, float* __restrict__ dwts,
               int rows, int deg, int feat) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (p >= static_cast<int64_t>(rows) * deg) return;
  const int64_t i = p / deg;
  const T* row = table + static_cast<int64_t>(nbr[p]) * feat;
  const float* gi = g + i * feat;
  float acc = 0.f;
  for (int f = 0; f < feat; ++f) {
    acc = __fmaf_rn(gi[f], to_float(row[f]), acc);
  }
  dwts[p] = acc;
}

extern "C" int spmm_bwd_table_launch(const void* pos, const void* wts,
                                     const void* g, void* dtab, int n_tab,
                                     int t_deg, int deg, int n_pos, int feat,
                                     void* stream) {
  if (n_tab == 0 || feat == 0) return 0;
  if (deg < 1 || t_deg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = ell_block(feat);
  bwd_table_kernel<<<ell_grid(n_tab, feat, block), block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const float*>(wts),
      static_cast<const float*>(g), static_cast<float*>(dtab), n_tab, t_deg,
      deg, n_pos, feat);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static void launch_wts(const void* nbr, const void* g, const void* table,
                       void* dwts, int rows, int deg, int feat,
                       cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(rows) * deg;
  const int blocks = static_cast<int>((n + kThreadsPerBlock - 1)
                                      / kThreadsPerBlock);
  bwd_wts_kernel<T><<<blocks, kThreadsPerBlock, 0, stream>>>(
      static_cast<const int32_t*>(nbr), static_cast<const float*>(g),
      static_cast<const T*>(table), static_cast<float*>(dwts), rows, deg,
      feat);
}

extern "C" int spmm_bwd_wts_launch(const void* nbr, const void* g,
                                   const void* table, int dtype, void* dwts,
                                   int rows, int deg, int feat,
                                   void* stream) {
  if (rows == 0 || deg == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch_wts<float>(nbr, g, table, dwts, rows, deg, feat, s);
      break;
    case kBFloat16:
      launch_wts<__nv_bfloat16>(nbr, g, table, dwts, rows, deg, feat, s);
      break;
    case kInt8:
      launch_wts<int8_t>(nbr, g, table, dwts, rows, deg, feat, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
