// K1: ELL SpMM, out[i, f] = sum_k wts[i, k] * table[nbr[i, k], f].
//
// Replaces the TPU kernel src/repro/kernels/spmm/spmm.py::spmm_pallas
// (body _spmm_kernel): the neighbour aggregation of every GNN layer.
//
// What bounds it on an H100: bytes.  Each output element costs one FMA per
// edge against one gathered table element, about 0.5 FLOP per byte, far
// below the card's compute-to-bandwidth ratio.  The least traffic is
// nbr + wts + the referenced table rows + out, read or written once.  At
// the products-sim refresh shape (12000 x 80 edges over a 12001 x 128 fp32
// table) that is about 20 MB.
//
// What the design does about it: one thread per (row, feature); a warp
// reads 32 consecutive features of one gathered row (coalesced), and the
// row's nbr/wts entries are broadcast loads shared by the warp.  The table
// (at most a few MB here) stays in the 50 MB L2, so repeated gathers of a
// hub row are L2 hits rather than HBM reads.  The TPU carried the table
// into VMEM per 128-wide feature stripe; on this card nothing is staged.
//
// Summation order: each thread accumulates k = 0 .. deg-1 in order with
// fp32 FMAs, the order of the TPU kernel's fori_loop.  No atomics, so the
// result is deterministic run to run.  The sentinel row (zero, weight 0)
// makes padding need no mask.  Precondition, as on the TPU: every index is
// below n_tab; the wrapper documents it and does not scan the indices.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreadsPerBlock)
spmm_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ wts,
            const T* __restrict__ table, float* __restrict__ out, int rows,
            int deg, int feat) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= rows || f >= feat) return;
  const int32_t* nr = nbr + static_cast<int64_t>(r) * deg;
  const float* wr = wts + static_cast<int64_t>(r) * deg;
  float acc = 0.f;
  for (int k = 0; k < deg; ++k) {
    const int64_t idx = nr[k];
    acc = __fmaf_rn(wr[k], to_float(table[idx * feat + f]), acc);
  }
  out[static_cast<int64_t>(r) * feat + f] = acc;
}

template <typename T>
static void launch(const void* nbr, const void* wts, const void* table,
                   void* out, int rows, int deg, int feat,
                   cudaStream_t stream) {
  const dim3 block = ell_block(feat);
  spmm_kernel<T><<<ell_grid(rows, feat, block), block, 0, stream>>>(
      static_cast<const int32_t*>(nbr), static_cast<const float*>(wts),
      static_cast<const T*>(table), static_cast<float*>(out), rows, deg,
      feat);
}

extern "C" int spmm_launch(const void* nbr, const void* wts,
                           const void* table, int dtype, void* out, int rows,
                           int deg, int feat, void* stream) {
  if (rows == 0 || feat == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch<float>(nbr, wts, table, out, rows, deg, feat, s);
      break;
    case kBFloat16:
      launch<__nv_bfloat16>(nbr, wts, table, out, rows, deg, feat, s);
      break;
    case kInt8:
      launch<int8_t>(nbr, wts, table, out, rows, deg, feat, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
