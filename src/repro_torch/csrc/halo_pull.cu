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
// K4 (halo_spmm_skip_launch) replaces halo_pull.py::halo_spmm_skip_pallas
// (body _make_skip_kernel): K3 visiting only the chunks on its 128-row
// block's worklist, wl_ids[b, 0 .. wl_cnt[b]-1] (ascending), b = row / 128.
// Every edge of a skipped chunk lies outside it, so K3 adds exactly +0.0
// for that chunk: K4 equals K3 bit for bit at equal chunk_rows (a -0.0
// total may turn into +0.0).  On the TPU skipping saved the chunk's DMA;
// here every gather goes through L2 and what it saves is loop trips,
// about avg(wl_cnt) / n_chunks of K3's.  With a visits pointer the first
// thread of each block writes the chunk it visited at each worklist step
// (-1 past wl_cnt), the reference's count_visits output.
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

// Chunk walk of each kernel: K2 one pass over the slab, K3 every chunk,
// K4 the chunks on the row block's worklist.
enum HaloMode { kResident = 0, kStream = 1, kSkip = 2 };

// Row block of K4's worklist (the reference kernels' 128-row tile).
constexpr int kSkipBlockRows = 128;

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreadsPerBlock)
halo_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ wts,
            const T* __restrict__ data, const float* __restrict__ scale,
            const T* __restrict__ pdata, const float* __restrict__ pscale,
            float gamma, float* __restrict__ out, int rows, int deg,
            int n_tab, int feat, int chunk_rows,
            const int32_t* __restrict__ wl_ids,
            const int32_t* __restrict__ wl_cnt, int max_chunks,
            int32_t* __restrict__ visits) {
  constexpr bool kChunked = kMode != kResident;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= rows || f >= feat) return;
  const int32_t* nr = nbr + static_cast<int64_t>(r) * deg;
  const float* wr = wts + static_cast<int64_t>(r) * deg;
  const int b = r / kSkipBlockRows;
  const int32_t* wl = wl_ids + static_cast<int64_t>(b) * max_chunks;
  const bool log = kMode == kSkip && visits != nullptr && f == 0
                   && r == b * kSkipBlockRows;
  const int n_steps = kMode == kSkip
                          ? wl_cnt[b]
                          : (kChunked ? (n_tab + chunk_rows - 1) / chunk_rows
                                      : 1);
  float total = 0.f;
  for (int t = 0; t < n_steps; ++t) {
    const int c = kMode == kSkip ? wl[t] : t;
    if (log) visits[static_cast<int64_t>(b) * max_chunks + t] = c;
    const int lo = c * chunk_rows;
    const int hi = lo + chunk_rows;
    float part = 0.f;
    for (int k = 0; k < deg; ++k) {
      const int s = nr[k];
      if (kChunked && (s < lo || s >= hi)) continue;
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
    total = kChunked ? total + part : part;
  }
  if (log) {
    for (int t = n_steps; t < max_chunks; ++t) {
      visits[static_cast<int64_t>(b) * max_chunks + t] = -1;
    }
  }
  out[static_cast<int64_t>(r) * feat + f] = total;
}

template <int kMode>
static int launch(const void* nbr, const void* wts, const void* data,
                  int dtype, const void* scale, const void* pdata,
                  const void* pscale, float gamma, void* out, int rows,
                  int deg, int n_tab, int feat, int chunk_rows,
                  const void* wl_ids, const void* wl_cnt, int max_chunks,
                  void* visits, void* stream) {
  if (rows == 0 || feat == 0) return 0;
  if (kMode != kResident && chunk_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kMode == kSkip && (wl_ids == nullptr || wl_cnt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block = ell_block(feat);
  const dim3 grid = ell_grid(rows, feat, block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const float* w = static_cast<const float*>(wts);
  const float* sc = static_cast<const float*>(scale);
  const float* psc = static_cast<const float*>(pscale);
  const int32_t* ids = static_cast<const int32_t*>(wl_ids);
  const int32_t* cnt = static_cast<const int32_t*>(wl_cnt);
  int32_t* vis = static_cast<int32_t*>(visits);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case kFloat32:
      halo_kernel<float, kMode><<<grid, block, 0, s>>>(
          n, w, static_cast<const float*>(data), sc,
          static_cast<const float*>(pdata), psc, gamma, o, rows, deg, n_tab,
          feat, chunk_rows, ids, cnt, max_chunks, vis);
      break;
    case kBFloat16:
      halo_kernel<__nv_bfloat16, kMode><<<grid, block, 0, s>>>(
          n, w, static_cast<const __nv_bfloat16*>(data), sc,
          static_cast<const __nv_bfloat16*>(pdata), psc, gamma, o, rows, deg,
          n_tab, feat, chunk_rows, ids, cnt, max_chunks, vis);
      break;
    case kInt8:
      halo_kernel<int8_t, kMode><<<grid, block, 0, s>>>(
          n, w, static_cast<const int8_t*>(data), sc,
          static_cast<const int8_t*>(pdata), psc, gamma, o, rows, deg, n_tab,
          feat, chunk_rows, ids, cnt, max_chunks, vis);
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
  return launch<kResident>(nbr, wts, data, dtype, scale, pdata, pscale,
                           gamma, out, rows, deg, n_tab, feat, 0, nullptr,
                           nullptr, 1, nullptr, stream);
}

extern "C" int halo_spmm_stream_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, int chunk_rows,
    void* stream) {
  return launch<kStream>(nbr, wts, data, dtype, scale, pdata, pscale, gamma,
                         out, rows, deg, n_tab, feat, chunk_rows, nullptr,
                         nullptr, 1, nullptr, stream);
}

extern "C" int halo_spmm_skip_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, int chunk_rows,
    const void* wl_ids, const void* wl_cnt, int max_chunks, void* visits,
    void* stream) {
  return launch<kSkip>(nbr, wts, data, dtype, scale, pdata, pscale, gamma,
                       out, rows, deg, n_tab, feat, chunk_rows, wl_ids,
                       wl_cnt, max_chunks, visits, stream);
}
