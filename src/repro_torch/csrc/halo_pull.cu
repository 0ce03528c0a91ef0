// K2 and K3: fused halo pull + dequantise + aggregate over a store slab,
//
//   out[i, f] = sum_k w[i,k] * scale[s] * data[s, f]
//             + gamma * w[i,k] * pscale[s] * pdata[s, f],   s = nbr[i, k],
//
// with data/pdata in fp32, bf16 or int8 and the optional per-row scales
// and SAT predictor slab (pdata/pscale/gamma) passed as null pointers when
// absent.
//
// K2 (halo_spmm_resident_launch) replaces the TPU kernel
// src/repro/kernels/spmm/halo_pull.py::halo_spmm_pallas (bodies
// _halo_kernel_scaled and _make_resident_pred_kernel).
// K3 (halo_spmm_stream_launch) replaces
// halo_pull.py::halo_spmm_stream_pallas (bodies _make_stream_kernel and
// _chunk_contrib): the same sum taken chunk by chunk over chunk_rows-row
// slab chunks in ascending order.  Each chunk's partial is accumulated
// over k and then added to the output, in _chunk_contrib's order.
//
// What bounds them on an H100: bytes, as for K1 (one FMA per gathered
// element).  The least traffic is nbr + wts + the referenced slab rows
// (+ their scales) + out.  A serving query batch (256 x 80 edges over a
// 12616 x 128 slab) moves at most a few MB, so at that shape launch
// latency, not bandwidth, sets the time.
//
// What the design does about it: one thread per (row, feature), gathering
// from global memory; the slab (1.7 MB int8 to 6.5 MB fp32 at that shape)
// fits in the 50 MB L2, so on this card nothing needs to be "resident" and
// the TPU's VMEM staging has no counterpart.  int8 rows are dequantised in
// registers, and the per-row scale is folded into the edge weight
// (w * scale[s]) so the inner loop stays one FMA per term.  K3 keeps the
// chunked order only for its numerics: it re-reads the row's nbr/wts once
// per chunk (L1 hits) and skips edges outside the chunk.
//
// Numerics.  Accumulation is fp32 with explicit FMAs in a fixed order and
// no atomics, so results are deterministic.  K2 and K3 share one body, and
// when one chunk covers the slab K3 takes the very same FMAs as K2: equal
// values (0 + x may turn a -0.0 partial into +0.0, nothing else).  The TPU
// kernel pads the slab to whole chunks and masks out-of-chunk edges to an
// exact +-0.0 term; this kernel does not pad (the last chunk is ragged)
// and skips those edges instead.  The two agree except when the slab holds
// inf or NaN, where the TPU's 0 * inf term is NaN and the skipped edge is
// nothing.
#include "common.cuh"

template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreadsPerBlock)
halo_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ wts,
            const T* __restrict__ data, const float* __restrict__ scale,
            const T* __restrict__ pdata, const float* __restrict__ pscale,
            float gamma, float* __restrict__ out, int rows, int deg,
            int n_tab, int feat, int chunk_rows) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= rows || f >= feat) return;
  const int32_t* nr = nbr + static_cast<int64_t>(r) * deg;
  const float* wr = wts + static_cast<int64_t>(r) * deg;
  const int n_chunks = kStream ? (n_tab + chunk_rows - 1) / chunk_rows : 1;
  float total = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int lo = c * chunk_rows;
    const int hi = lo + chunk_rows;
    float part = 0.f;
    for (int k = 0; k < deg; ++k) {
      const int s = nr[k];
      if (kStream && (s < lo || s >= hi)) continue;
      const float w = wr[k];
      const float ws = scale != nullptr ? w * scale[s] : w;
      const int64_t off = static_cast<int64_t>(s) * feat + f;
      part = __fmaf_rn(ws, to_float(data[off]), part);
      if (pdata != nullptr) {
        float wp = w * gamma;
        if (pscale != nullptr) wp = wp * pscale[s];
        part = __fmaf_rn(wp, to_float(pdata[off]), part);
      }
    }
    total = kStream ? total + part : part;
  }
  out[static_cast<int64_t>(r) * feat + f] = total;
}

template <bool kStream>
static int launch(const void* nbr, const void* wts, const void* data,
                  int dtype, const void* scale, const void* pdata,
                  const void* pscale, float gamma, void* out, int rows,
                  int deg, int n_tab, int feat, int chunk_rows,
                  void* stream) {
  if (rows == 0 || feat == 0) return 0;
  if (kStream && chunk_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block = ell_block(feat);
  const dim3 grid = ell_grid(rows, feat, block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const float* w = static_cast<const float*>(wts);
  const float* sc = static_cast<const float*>(scale);
  const float* psc = static_cast<const float*>(pscale);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case kFloat32:
      halo_kernel<float, kStream><<<grid, block, 0, s>>>(
          n, w, static_cast<const float*>(data), sc,
          static_cast<const float*>(pdata), psc, gamma, o, rows, deg, n_tab,
          feat, chunk_rows);
      break;
    case kBFloat16:
      halo_kernel<__nv_bfloat16, kStream><<<grid, block, 0, s>>>(
          n, w, static_cast<const __nv_bfloat16*>(data), sc,
          static_cast<const __nv_bfloat16*>(pdata), psc, gamma, o, rows, deg,
          n_tab, feat, chunk_rows);
      break;
    case kInt8:
      halo_kernel<int8_t, kStream><<<grid, block, 0, s>>>(
          n, w, static_cast<const int8_t*>(data), sc,
          static_cast<const int8_t*>(pdata), psc, gamma, o, rows, deg, n_tab,
          feat, chunk_rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int halo_spmm_resident_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, void* stream) {
  return launch<false>(nbr, wts, data, dtype, scale, pdata, pscale, gamma,
                       out, rows, deg, n_tab, feat, 0, stream);
}

extern "C" int halo_spmm_stream_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, int chunk_rows,
    void* stream) {
  return launch<true>(nbr, wts, data, dtype, scale, pdata, pscale, gamma,
                      out, rows, deg, n_tab, feat, chunk_rows, stream);
}
