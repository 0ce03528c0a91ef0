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
// Edges on chunks off the worklist are dropped.  With a visits pointer the
// block holding a row block's first row writes the chunk visited at each
// worklist step (-1 past wl_cnt), the reference's count_visits output.
//
// What bounds them on an H100: bytes, as for K1 (one FMA per gathered
// element).  The least traffic is nbr + wts + the referenced slab rows
// (+ their scales) + out.  A serving query batch (256 x 80 edges over a
// 12616 x 128 slab) moves at most a few MB, so at that shape launch
// latency, not bandwidth, sets the time.  At K4's training shape (5256 x
// 64 edges over a 14289 x 128 fp32 slab, 7.3 MB) every gather is an L2
// hit, and what bounds a row is latency: its chain of dependent gathers
// and warp-wide steps.
//
// What the design does about it (K2, K3): one thread per (row, feature),
// gathering from global memory; the slab (1.7 MB int8 to 6.5 MB fp32 at
// the serving shape) fits in the 50 MB L2, so on this card nothing needs
// to be "resident" and the TPU's VMEM staging has no counterpart.  int8
// rows are dequantised in registers, and the per-row scale is folded into
// the edge weight (w * scale[s]) so the inner loop stays one FMA per term.
// K3 keeps the chunked order only for its numerics: it re-reads the row's
// nbr/wts once per chunk (L1 hits) and skips edges outside the chunk.
//
// K4 takes one pass over each row's edges (K3's body, restricted to the
// worklist, would walk all of them once per visited chunk: wl_cnt x deg
// branchy trips per output element).  One warp owns a row, and a block
// holds 8 rows of one 128-row worklist block; it turns the block's
// worklist into a bitmap over the slab's chunks in shared memory once.  The warp loads the row's
// nbr/wts once into registers (lane j holds edges j, j+32, ...; edges past
// 128 are re-read, L1 hits) and computes each edge's chunk id (none if
// the chunk is off the worklist) and folded weights once.  It then visits
// only the row's own chunks, in ascending order: a __reduce_min_sync over
// the lanes' edge chunks above the last one gives the next chunk, and a
// __ballot_sync per 32-edge segment the row's edges in it.  The warp walks
// the set bits in ascending k, takes s and the weights by __shfl_sync, and
// each lane gathers a vector of features (16 bytes of fp32, 8 of bf16, 4
// of int8 where feat % 4 == 0 and the slab is aligned; else one feature)
// of up to four edges at once before their FMAs.  Every branch is
// warp-uniform.  That is deg gathers plus, per distinct chunk of the row,
// one reduction and ceil(deg / 32) ballots, instead of wl_cnt x deg loop
// trips (at the training shape a row has 5.6 real edges in an ELL row of
// 64 and its block's worklist 35 chunks).  The lanes split features,
// never edges, so each partial is the same chain of FMAs as K3's.
//
// Numerics.  Accumulation is fp32 with explicit FMAs in a fixed order and
// no atomics, so results are deterministic.  K2 and K3 share one body, and
// when one chunk covers the slab K3 takes the very same FMAs as K2: equal
// values (0 + x may turn a -0.0 partial into +0.0, nothing else).  K4
// takes K3's order exactly: per worklist chunk, a partial from +0.0 over
// the chunk's edges in ascending k (data term, then predictor term), then
// total = total + part.  It skips the worklist chunks in which the row has
// no edge.  K3 adds a +0.0 partial for each of them, which leaves its
// total unchanged bit for bit (the total starts at +0.0, and a
// round-to-nearest sum is -0.0 only when both terms are), so K4 equals K3
// at equal chunk_rows where the worklist lists every chunk the row reads;
// were a zero's sign to differ, torch.equal would still accept it.  A
// chunk listed twice is visited once, as in the plain version.
// The TPU kernel pads the slab to whole chunks and masks out-of-chunk
// edges to an exact +-0.0 term; these kernels do not pad (the last chunk
// is ragged) and skip those edges instead.  The two agree except when the
// slab holds inf or NaN, where the TPU's 0 * inf term is NaN and the
// skipped edge is nothing.
#include <type_traits>

#include "common.cuh"

// Row block of K4's worklist (the reference kernels' 128-row tile).
constexpr int kSkipBlockRows = 128;
// K4: rows (one warp each) per block; divides kSkipBlockRows, so a
// block's rows share one worklist.
constexpr int kSkipWarps = 8;
// K4: 32-edge segments of a row held in registers; later ones are re-read.
constexpr int kSkipRegSegs = 4;
// K4: edges gathered together before their FMAs (loads in flight).
constexpr int kSkipBatch = 4;
// K4: chunk id of an edge that is past the row's degree or whose chunk is
// not on the worklist (it matches no chunk the warp visits).
constexpr int kNoChunk = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;

// K2 (kChunked false: one pass over the slab) and K3 (every chunk_rows-row
// chunk in ascending order).
template <typename T, bool kChunked>
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
  const int n_steps = kChunked ? (n_tab + chunk_rows - 1) / chunk_rows : 1;
  float total = 0.f;
  for (int c = 0; c < n_steps; ++c) {
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
  out[static_cast<int64_t>(r) * feat + f] = total;
}

// kVec consecutive slab elements at p, as fp32 (one 16-, 8- or 4-byte load
// for fp32, bf16 or int8 when kVec is 4).
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&x)[kVec]) {
  if constexpr (kVec == 1) {
    x[0] = to_float(p[0]);
  } else if constexpr (std::is_same_v<T, float>) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    x[0] = __low2float(a); x[1] = __high2float(a);
    x[2] = __low2float(b); x[3] = __high2float(b);
  } else {
    const char4 u = *reinterpret_cast<const char4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  }
}

// One edge of a K4 row as its owning lane holds it: slot s, chunk c
// (kNoChunk past the row's degree or off the worklist) and the folded
// weights w * scale[s] and w * gamma * pscale[s], rounded as K3 rounds
// them.
struct SkipEdge {
  int s, c;
  float ws, wp;
};

__device__ __forceinline__ SkipEdge skip_edge(
    const int32_t* __restrict__ nr, const float* __restrict__ wr, int k,
    int deg, const float* __restrict__ scale,
    const float* __restrict__ pscale, float gamma, int chunk_rows,
    const uint32_t* on_list) {
  SkipEdge e{0, kNoChunk, 0.f, 0.f};
  if (k < deg) {
    e.s = nr[k];
    const float w = wr[k];
    const int c = e.s / chunk_rows;
    if (on_list[c >> 5] >> (c & 31) & 1) e.c = c;
    e.ws = scale != nullptr ? w * scale[e.s] : w;
    e.wp = w * gamma;
    if (pscale != nullptr) e.wp = e.wp * pscale[e.s];
  }
  return e;
}

// The lane's smallest edge chunk above `prev` (kNoChunk if none).
__device__ __forceinline__ int next_chunk(const SkipEdge& e, int prev,
                                          int best) {
  return e.c > prev && e.c < best ? e.c : best;
}

// Adds the edges of one 32-edge segment whose lanes are set in `hit`
// (warp-uniform) to the lane's partials, in ascending k: per edge the data
// term, then the predictor term (kPred).
template <typename T, int kVec, bool kPred>
__device__ __forceinline__ void skip_segment(
    unsigned hit, const SkipEdge& e, const T* __restrict__ data,
    const T* __restrict__ pdata, int feat, int f, bool live,
    float (&part)[kVec]) {
  while (hit != 0) {
    int s[kSkipBatch];
    float ws[kSkipBatch], wp[kSkipBatch];
    int n = 0;
#pragma unroll
    for (int u = 0; u < kSkipBatch; ++u) {
      if (hit != 0) {
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        s[u] = __shfl_sync(kFullMask, e.s, src);
        ws[u] = __shfl_sync(kFullMask, e.ws, src);
        if constexpr (kPred) wp[u] = __shfl_sync(kFullMask, e.wp, src);
        n = u + 1;
      }
    }
    float x[kSkipBatch][kVec], px[kSkipBatch][kVec];
#pragma unroll
    for (int u = 0; u < kSkipBatch; ++u) {
      if (u < n && live) {
        const int64_t off = static_cast<int64_t>(s[u]) * feat + f;
        load_vec<T, kVec>(data + off, x[u]);
        if constexpr (kPred) load_vec<T, kVec>(pdata + off, px[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kSkipBatch; ++u) {
      if (u < n && live) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          part[v] = __fmaf_rn(ws[u], x[u][v], part[v]);
          if constexpr (kPred) part[v] = __fmaf_rn(wp[u], px[u][v], part[v]);
        }
      }
    }
  }
}

// K4: one warp per row (module note).  Dynamic shared memory: a bitmap of
// the block's worklist over the slab's n_chunks chunks.  kPred: with the
// predictor slab (pdata, pscale, gamma).
template <typename T, int kVec, bool kPred>
__global__ void __launch_bounds__(kSkipWarps * 32, 3)
halo_skip_kernel(const int32_t* __restrict__ nbr,
                 const float* __restrict__ wts, const T* __restrict__ data,
                 const float* __restrict__ scale, const T* __restrict__ pdata,
                 const float* __restrict__ pscale, float gamma,
                 float* __restrict__ out, int rows, int deg, int feat,
                 int chunk_rows, int n_chunks,
                 const int32_t* __restrict__ wl_ids,
                 const int32_t* __restrict__ wl_cnt, int max_chunks,
                 int32_t* __restrict__ visits) {
  extern __shared__ uint32_t on_list[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kSkipWarps;
  const int b = row0 / kSkipBlockRows;
  const int32_t* ids = wl_ids + static_cast<int64_t>(b) * max_chunks;
  const int n_steps = min(wl_cnt[b], max_chunks);
  const int words = (n_chunks + 31) / 32;
  for (int i = threadIdx.x; i < words; i += blockDim.x) on_list[i] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < n_steps; t += blockDim.x) {
    const int c = ids[t];
    if (c >= 0 && c < n_chunks) atomicOr(&on_list[c >> 5], 1u << (c & 31));
  }
  if (visits != nullptr && row0 == b * kSkipBlockRows) {
    int32_t* vb = visits + static_cast<int64_t>(b) * max_chunks;
    for (int t = threadIdx.x; t < max_chunks; t += blockDim.x) {
      vb[t] = t < n_steps ? ids[t] : -1;
    }
  }
  __syncthreads();
  const int r = row0 + warp;
  if (r >= rows) return;                      // the whole warp leaves

  const int32_t* nr = nbr + static_cast<int64_t>(r) * deg;
  const float* wr = wts + static_cast<int64_t>(r) * deg;
  const int n_seg = (deg + 31) / 32;
  SkipEdge held[kSkipRegSegs];
#pragma unroll
  for (int j = 0; j < kSkipRegSegs; ++j) {
    held[j] = skip_edge(nr, wr, j * 32 + lane, deg, scale, pscale, gamma,
                        chunk_rows, on_list);
  }
  float* orow = out + static_cast<int64_t>(r) * feat;
  for (int f0 = 0; f0 < feat; f0 += 32 * kVec) {
    const int f = f0 + lane * kVec;
    const bool live = f < feat;
    float total[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) total[v] = 0.f;
    // The row's chunks on the worklist, in ascending order: each step
    // takes the warp's smallest edge chunk above the last one.
    for (int prev = -1;;) {
      int c = kNoChunk;
#pragma unroll
      for (int j = 0; j < kSkipRegSegs; ++j) {
        if (j < n_seg) c = next_chunk(held[j], prev, c);
      }
      for (int j = kSkipRegSegs; j < n_seg; ++j) {
        c = next_chunk(skip_edge(nr, wr, j * 32 + lane, deg, scale, pscale,
                                 gamma, chunk_rows, on_list),
                       prev, c);
      }
      c = __reduce_min_sync(kFullMask, c);
      if (c == kNoChunk) break;
      float part[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) part[v] = 0.f;
#pragma unroll
      for (int j = 0; j < kSkipRegSegs; ++j) {
        if (j < n_seg) {
          const unsigned hit = __ballot_sync(kFullMask, held[j].c == c);
          skip_segment<T, kVec, kPred>(hit, held[j], data, pdata, feat, f,
                                       live, part);
        }
      }
      for (int j = kSkipRegSegs; j < n_seg; ++j) {
        const SkipEdge e = skip_edge(nr, wr, j * 32 + lane, deg, scale,
                                     pscale, gamma, chunk_rows, on_list);
        const unsigned hit = __ballot_sync(kFullMask, e.c == c);
        skip_segment<T, kVec, kPred>(hit, e, data, pdata, feat, f, live,
                                     part);
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) total[v] = total[v] + part[v];
      prev = c;
    }
    if (live) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) orow[f + v] = total[v];
    }
  }
}

template <typename T>
static void launch_typed(bool chunked, const int32_t* n, const float* w,
                         const void* data, const float* sc,
                         const void* pdata, const float* psc, float gamma,
                         float* o, int rows, int deg, int n_tab, int feat,
                         int chunk_rows, cudaStream_t s) {
  const dim3 block = ell_block(feat);
  const dim3 grid = ell_grid(rows, feat, block);
  const T* d = static_cast<const T*>(data);
  const T* pd = static_cast<const T*>(pdata);
  if (chunked) {
    halo_kernel<T, true><<<grid, block, 0, s>>>(
        n, w, d, sc, pd, psc, gamma, o, rows, deg, n_tab, feat, chunk_rows);
  } else {
    halo_kernel<T, false><<<grid, block, 0, s>>>(
        n, w, d, sc, pd, psc, gamma, o, rows, deg, n_tab, feat, chunk_rows);
  }
}

static int launch(bool chunked, const void* nbr, const void* wts,
                  const void* data, int dtype, const void* scale,
                  const void* pdata, const void* pscale, float gamma,
                  void* out, int rows, int deg, int n_tab, int feat,
                  int chunk_rows, void* stream) {
  if (rows == 0 || feat == 0) return 0;
  if (chunked && chunk_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const float* w = static_cast<const float*>(wts);
  const float* sc = static_cast<const float*>(scale);
  const float* psc = static_cast<const float*>(pscale);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case kFloat32:
      launch_typed<float>(chunked, n, w, data, sc, pdata, psc, gamma, o,
                          rows, deg, n_tab, feat, chunk_rows, s);
      break;
    case kBFloat16:
      launch_typed<__nv_bfloat16>(chunked, n, w, data, sc, pdata, psc,
                                  gamma, o, rows, deg, n_tab, feat,
                                  chunk_rows, s);
      break;
    case kInt8:
      launch_typed<int8_t>(chunked, n, w, data, sc, pdata, psc, gamma, o,
                           rows, deg, n_tab, feat, chunk_rows, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static cudaError_t launch_skip(const int32_t* n, const float* w,
                               const void* data, const float* sc,
                               const void* pdata, const float* psc,
                               float gamma, float* o, int rows, int deg,
                               int n_tab, int feat, int chunk_rows,
                               const int32_t* ids, const int32_t* cnt,
                               int max_chunks, int32_t* vis,
                               cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const T* pd = static_cast<const T*>(pdata);
  // Vector gathers where every gathered row starts on a vector boundary.
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = feat % 4 == 0
                   && reinterpret_cast<uintptr_t>(d) % align == 0
                   && reinterpret_cast<uintptr_t>(pd) % align == 0;
  const int n_chunks = (n_tab + chunk_rows - 1) / chunk_rows;
  const dim3 grid((rows + kSkipWarps - 1) / kSkipWarps);
  const dim3 block(kSkipWarps * 32);
  const size_t smem = static_cast<size_t>((n_chunks + 31) / 32)
                      * sizeof(uint32_t);
  const auto kernel = vec ? (pd != nullptr ? halo_skip_kernel<T, 4, true>
                                          : halo_skip_kernel<T, 4, false>)
                         : (pd != nullptr ? halo_skip_kernel<T, 1, true>
                                          : halo_skip_kernel<T, 1, false>);
  if (smem > 48 * 1024) {       // a slab of more than 393,216 chunks
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, s>>>(n, w, d, sc, pd, psc, gamma, o, rows, deg,
                                   feat, chunk_rows, n_chunks, ids, cnt,
                                   max_chunks, vis);
  return cudaGetLastError();
}

extern "C" int halo_spmm_resident_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, void* stream) {
  return launch(false, nbr, wts, data, dtype, scale, pdata, pscale, gamma,
                out, rows, deg, n_tab, feat, 0, stream);
}

extern "C" int halo_spmm_stream_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, int chunk_rows,
    void* stream) {
  return launch(true, nbr, wts, data, dtype, scale, pdata, pscale, gamma,
                out, rows, deg, n_tab, feat, chunk_rows, stream);
}

extern "C" int halo_spmm_skip_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, int chunk_rows,
    const void* wl_ids, const void* wl_cnt, int max_chunks, void* visits,
    void* stream) {
  if (rows == 0 || feat == 0) return 0;
  if (chunk_rows < 1 || max_chunks < 1 || wl_ids == nullptr
      || wl_cnt == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
      return static_cast<int>(launch_skip<float>(
          n, w, data, sc, pdata, psc, gamma, o, rows, deg, n_tab, feat,
          chunk_rows, ids, cnt, max_chunks, vis, s));
    case kBFloat16:
      return static_cast<int>(launch_skip<__nv_bfloat16>(
          n, w, data, sc, pdata, psc, gamma, o, rows, deg, n_tab, feat,
          chunk_rows, ids, cnt, max_chunks, vis, s));
    case kInt8:
      return static_cast<int>(launch_skip<int8_t>(
          n, w, data, sc, pdata, psc, gamma, o, rows, deg, n_tab, feat,
          chunk_rows, ids, cnt, max_chunks, vis, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
