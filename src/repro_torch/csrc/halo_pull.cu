// K2, K3 and K4: fused halo pull + dequantise + aggregate over a store
// slab,
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
// halo_spmm_stream_walk_launch runs K3 on its chunk walk at any degree.
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
// 12616 x 128 slab) moves at most a few MB, and the slab (1.7 MB int8 to
// 6.5 MB fp32) stays in the 50 MB L2, so on this card nothing needs to be
// "resident" and the TPU's VMEM staging has no counterpart.  With 256 rows
// the card holds one or two warps an SM: what bounds a row is latency, its
// chain of dependent L2 round trips and warp-wide steps, not bandwidth.
// The same holds at the training shape (5256 x 64 edges over a 14289 x
// 128 fp32 slab, 7.3 MB: every gather an L2 hit).
//
// One design for all three: one warp owns an output row.  Lanes split
// features, never edges: each lane gathers a vector of features (16 bytes
// of fp32, 8 of bf16, 4 of int8 where feat % 4 == 0 and the slab is
// aligned; else one feature) of one slab row, in 128- (or 32-) feature
// stripes; lanes past feat idle.  The warp reads the row's nbr/wts once
// into registers (lane j holds edges j, j + 32, ...; all their loads go
// out before any scale load; edges past 128 are re-read, L1 hits), and
// the owning lane folds each edge's weights once, ws = w * scale[s] and
// wp = w * gamma * pscale[s], rounded as the plain version rounds them;
// the others take them from shared memory or by __shfl_sync.  int8 rows
// are dequantised in registers, so every term is one FMA.  Several edges'
// gathers go out before their FMAs, and every branch is warp-uniform.
// The bodies differ in how the warp orders the row's edges by chunk:
//
// * K2 and K3 (halo_list_kernel): the warp writes the row's edges into a
//   list in shared memory, K3 in (chunk, k) order: each lane ranks its
//   edges by the key c * deg + k against the row's keys, staged in shared
//   memory (deg compares an edge, broadcast reads), and writes each at
//   its rank; K2's list stays in k order.  The warp then streams the
//   list kRowBatch (8) edges at a time, all their gathers before any
//   conversion or FMA (a conversion right after its load would make each
//   gather wait for the one before), closing a chunk's partial where the
//   next edge's chunk differs.  A row costs about deg / 8 round trips to
//   L2 whatever its number of chunks (a serving row: 80 ELL slots, 69
//   real edges over 21 of 25 chunks).  A block of kRowWarps rows gives
//   their lists at most kListSmemMax bytes (20 an edge); a longer row
//   takes the walk.
// * The chunk walk (halo_walk_kernel, K2's and K3's body past the list's
//   room, and halo_spmm_stream_walk_launch): K4's walk without a
//   worklist.  A __reduce_min_sync over the lanes' edge chunks above the
//   last one gives the next chunk and a __ballot_sync per 32-edge segment
//   the row's edges in it, gathered kRowBatch (8) at a time: one round of
//   warp steps per distinct chunk of the row, and no shared memory.  On
//   the card it is the slower body (PERF.md, section 6).
// * K4 (halo_skip_kernel): the walk restricted to the chunks on its
//   128-row block's worklist.  A block holds 8 rows of one 128-row
//   worklist block; it turns the block's worklist into a bitmap over the
//   slab's chunks in shared memory once, and an edge whose chunk is off it
//   matches no chunk the warp visits.  It gathers 4 edges at a time (at
//   the training shape a row has 5.6 real edges in an ELL row of 64 and
//   its block's worklist 35 chunks).
//
// Numerics.  Accumulation is fp32 with explicit FMAs in a fixed order and
// no atomics, so results are deterministic.  K3 and K4 take
// _chunk_contrib's order: per chunk, a partial from +0.0 over the chunk's
// edges in ascending k (data term, then predictor term), then total =
// total + part in ascending chunk order.  Only the FMAs are pinned, not the
// loads, so the list and the walk give the same bits.  Both skip the
// chunks in which the row has no edge; the plain version adds a +0.0
// partial for each, which leaves its total unchanged bit for bit (the
// total starts at +0.0, and a round-to-nearest sum is -0.0 only when both
// terms are), so K4 equals K3 at equal chunk_rows where the worklist
// lists every chunk the row reads; were a zero's sign to differ,
// torch.equal would still accept it.  A chunk listed twice is visited
// once, as in the plain version.  K2 is the one-chunk case and writes its
// one partial: K3 over one chunk writes 0 + that partial, the very same
// FMAs (0 + x may turn a -0.0 into +0.0, nothing else).  Zero-weight
// edges are not skipped.
// The TPU kernel pads the slab to whole chunks and masks out-of-chunk
// edges to an exact +-0.0 term; these kernels do not pad (the last chunk
// is ragged) and take each edge in its own chunk only.  The two agree
// except when the slab holds inf or NaN, where the TPU's 0 * inf term is
// NaN and the skipped edge is nothing.
#include <climits>
#include <type_traits>

#include "common.cuh"

// Row block of K4's worklist (the reference kernels' 128-row tile).
constexpr int kSkipBlockRows = 128;
// K4: rows (one warp each) per block; divides kSkipBlockRows, so a
// block's rows share one worklist.
constexpr int kSkipWarps = 8;
// 32-edge segments of a row held in registers (K2, K3, K4); later ones
// are re-read.
constexpr int kSkipRegSegs = 4;
// K4: edges gathered together before their FMAs (loads in flight).
constexpr int kSkipBatch = 4;
// Chunk id of an edge past the row's degree or, in K4, off the worklist
// (it matches no chunk the warp visits).
constexpr int kNoChunk = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;
// K2 and K3: rows (one warp each) per block, fewer where a row's edge
// list would not fit.
constexpr int kRowWarps = 4;
// K2 and K3: edges gathered together before their FMAs, and the shared
// memory a block may give its rows' edge lists (20 bytes an edge); longer
// rows take the chunk walk.
constexpr int kRowBatch = 8;
constexpr int kListSmemMax = 64 * 1024;

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

// One edge of a row as its owning lane holds it: slot s, chunk c
// (kNoChunk past the row's degree or off K4's worklist) and the folded
// weights w * scale[s] and w * gamma * pscale[s], rounded as the plain
// version rounds them.
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
// term, then the predictor term (kPred); kBatch edges' gathers at a time.
template <typename T, int kVec, bool kPred, int kBatch = kSkipBatch>
__device__ __forceinline__ void skip_segment(
    unsigned hit, const SkipEdge& e, const T* __restrict__ data,
    const T* __restrict__ pdata, int feat, int f, bool live,
    float (&part)[kVec]) {
  while (hit != 0) {
    int s[kBatch];
    float ws[kBatch], wp[kBatch];
    int n = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (hit != 0) {
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        s[u] = __shfl_sync(kFullMask, e.s, src);
        ws[u] = __shfl_sync(kFullMask, e.ws, src);
        if constexpr (kPred) wp[u] = __shfl_sync(kFullMask, e.wp, src);
        n = u + 1;
      }
    }
    float x[kBatch][kVec], px[kBatch][kVec];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < n && live) {
        const int64_t off = static_cast<int64_t>(s[u]) * feat + f;
        load_vec<T, kVec>(data + off, x[u]);
        if constexpr (kPred) load_vec<T, kVec>(pdata + off, px[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
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

// Edge k of a K2/K3 row: chunk c = s / chunk_rows (K2 passes INT_MAX: one
// chunk), kNoChunk past the row's degree.
__device__ __forceinline__ SkipEdge row_edge(
    const int32_t* __restrict__ nr, const float* __restrict__ wr, int k,
    int deg, const float* __restrict__ scale,
    const float* __restrict__ pscale, float gamma, int chunk_rows) {
  SkipEdge e{0, kNoChunk, 0.f, 0.f};
  if (k < deg) {
    e.s = nr[k];
    const float w = wr[k];
    e.c = e.s / chunk_rows;
    e.ws = scale != nullptr ? w * scale[e.s] : w;
    e.wp = w * gamma;
    if (pscale != nullptr) e.wp = e.wp * pscale[e.s];
  }
  return e;
}

// Edges j * 32 + lane (j < kSegs) of a row, as row_edge computes them,
// with every segment's nbr/wts loads issued before any scale load.
template <int kSegs>
__device__ __forceinline__ void row_edges(
    const int32_t* __restrict__ nr, const float* __restrict__ wr, int lane,
    int deg, const float* __restrict__ scale,
    const float* __restrict__ pscale, float gamma, int chunk_rows,
    SkipEdge (&e)[kSegs]) {
  float w[kSegs], sc[kSegs], psc[kSegs];
#pragma unroll
  for (int j = 0; j < kSegs; ++j) {
    const int k = j * 32 + lane;
    e[j].s = k < deg ? nr[k] : 0;
    w[j] = k < deg ? wr[k] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kSegs; ++j) {
    const bool live = j * 32 + lane < deg;
    sc[j] = scale != nullptr && live ? scale[e[j].s] : 1.f;
    psc[j] = pscale != nullptr && live ? pscale[e[j].s] : 1.f;
  }
#pragma unroll
  for (int j = 0; j < kSegs; ++j) {
    e[j].c = j * 32 + lane < deg ? e[j].s / chunk_rows : kNoChunk;
    e[j].ws = scale != nullptr ? w[j] * sc[j] : w[j];
    e[j].wp = w[j] * gamma;
    if (pscale != nullptr) e[j].wp = e[j].wp * psc[j];
  }
}

// The chunk walk (module note): one warp per row, K4's walk over the
// row's own chunks with no worklist.  `chunked` false (K2): every edge is
// in chunk 0 and the row's sum is its one partial.
template <typename T, int kVec, bool kPred>
__global__ void __launch_bounds__(kRowWarps * 32)
halo_walk_kernel(const int32_t* __restrict__ nbr,
                 const float* __restrict__ wts, const T* __restrict__ data,
                 const float* __restrict__ scale, const T* __restrict__ pdata,
                 const float* __restrict__ pscale, float gamma,
                 float* __restrict__ out, int rows, int deg, int feat,
                 int chunk_rows, bool chunked) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;                      // the whole warp leaves
  const int32_t* nr = nbr + static_cast<int64_t>(r) * deg;
  const float* wr = wts + static_cast<int64_t>(r) * deg;
  const int n_seg = (deg + 31) / 32;
  SkipEdge held[kSkipRegSegs];
  row_edges(nr, wr, lane, deg, scale, pscale, gamma, chunk_rows, held);
  float* orow = out + static_cast<int64_t>(r) * feat;
  for (int f0 = 0; f0 < feat; f0 += 32 * kVec) {
    const int f = f0 + lane * kVec;
    const bool live = f < feat;
    float total[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) total[v] = 0.f;
    for (int prev = -1;;) {
      int c = kNoChunk;
#pragma unroll
      for (int j = 0; j < kSkipRegSegs; ++j) {
        if (j < n_seg) c = next_chunk(held[j], prev, c);
      }
      for (int j = kSkipRegSegs; j < n_seg; ++j) {
        c = next_chunk(row_edge(nr, wr, j * 32 + lane, deg, scale, pscale,
                                gamma, chunk_rows),
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
          skip_segment<T, kVec, kPred, kRowBatch>(hit, held[j], data, pdata,
                                                   feat, f, live, part);
        }
      }
      for (int j = kSkipRegSegs; j < n_seg; ++j) {
        const SkipEdge e = row_edge(nr, wr, j * 32 + lane, deg, scale,
                                    pscale, gamma, chunk_rows);
        const unsigned hit = __ballot_sync(kFullMask, e.c == c);
        skip_segment<T, kVec, kPred, kRowBatch>(hit, e, data, pdata, feat,
                                                 f, live, part);
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        total[v] = chunked ? total[v] + part[v] : part[v];
      }
      prev = c;
    }
    if (live) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) orow[f + v] = total[v];
    }
  }
}

__device__ __forceinline__ int4 list_entry(const SkipEdge& e) {
  return make_int4(e.s, e.c, __float_as_int(e.ws), __float_as_int(e.wp));
}

// The raw bits of kVec consecutive slab elements: one 16-, 8- or 4-byte
// load of fp32, bf16 or int8 when kVec is 4 (int8 as one 32-bit word).
// The list body gathers a batch of these before it converts any (unpack),
// so that no gather waits on the one before it.
template <typename T, int kVec>
using Raw = std::conditional_t<
    kVec == 1, T,
    std::conditional_t<std::is_same_v<T, float>, float4,
                       std::conditional_t<std::is_same_v<T, __nv_bfloat16>,
                                          uint2, int>>>;

template <typename T, int kVec>
__device__ __forceinline__ void unpack(const Raw<T, kVec>& u,
                                       float (&x)[kVec]) {
  if constexpr (kVec == 1) {
    x[0] = to_float(u);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // A bf16 is the upper half of the fp32 of the same value.
    x[0] = __uint_as_float(u.x << 16);
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (std::is_same_v<T, float>) {
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else {
    // Four int8 codes, lowest address in the low byte, sign-extended.
    x[0] = static_cast<float>((u << 24) >> 24);
    x[1] = static_cast<float>((u << 16) >> 24);
    x[2] = static_cast<float>((u << 8) >> 24);
    x[3] = static_cast<float>(u >> 24);
  }
}

// K2 and K3 (module note): one warp per row.  Dynamic shared memory: each
// warp's edge list (deg int4 entries {s, c, ws, wp}) for all the block's
// warps, then each warp's deg sort keys.  `chunked` false (K2): the list
// stays in k order, every edge in chunk 0, and the row's one partial is
// written.
template <typename T, int kVec, bool kPred>
__global__ void __launch_bounds__(kRowWarps * 32)
halo_list_kernel(const int32_t* __restrict__ nbr,
                 const float* __restrict__ wts, const T* __restrict__ data,
                 const float* __restrict__ scale, const T* __restrict__ pdata,
                 const float* __restrict__ pscale, float gamma,
                 float* __restrict__ out, int rows, int deg, int feat,
                 int chunk_rows, bool chunked) {
  extern __shared__ int4 lists[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * warps + warp;
  if (r >= rows) return;                      // only warp-level syncs below
  int4* list = lists + static_cast<int64_t>(warp) * deg;
  int* keys = reinterpret_cast<int*>(lists + static_cast<int64_t>(warps) * deg)
              + static_cast<int64_t>(warp) * deg;
  const int32_t* nr = nbr + static_cast<int64_t>(r) * deg;
  const float* wr = wts + static_cast<int64_t>(r) * deg;

  // The row's edges, read once (lane j: edges j, j + 32, ...).  K3 ranks
  // each by its key c * deg + k among the row's keys, staged in shared
  // memory, and writes it at its rank: the list in (chunk, k) order.
  SkipEdge held[kSkipRegSegs];
  row_edges(nr, wr, lane, deg, scale, pscale, gamma, chunk_rows, held);
  if (chunked) {
    int mine[kSkipRegSegs], at[kSkipRegSegs];
#pragma unroll
    for (int j = 0; j < kSkipRegSegs; ++j) {
      const int k = j * 32 + lane;
      mine[j] = k < deg ? held[j].c * deg + k : INT_MAX;
      if (k < deg) keys[k] = mine[j];
      at[j] = 0;
    }
    for (int k = kSkipRegSegs * 32 + lane; k < deg; k += 32) {
      keys[k] = nr[k] / chunk_rows * deg + k;
    }
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < deg; ++i) {
      const int key = keys[i];
#pragma unroll
      for (int j = 0; j < kSkipRegSegs; ++j) at[j] += key < mine[j];
    }
#pragma unroll
    for (int j = 0; j < kSkipRegSegs; ++j) {
      if (j * 32 + lane < deg) list[at[j]] = list_entry(held[j]);
    }
    for (int k = kSkipRegSegs * 32 + lane; k < deg; k += 32) {
      const SkipEdge e = row_edge(nr, wr, k, deg, scale, pscale, gamma,
                                  chunk_rows);
      const int key = e.c * deg + k;
      int rank = 0;
      for (int i = 0; i < deg; ++i) rank += keys[i] < key;
      list[rank] = list_entry(e);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSkipRegSegs; ++j) {
      const int k = j * 32 + lane;
      if (k < deg) list[k] = list_entry(held[j]);
    }
    for (int k = kSkipRegSegs * 32 + lane; k < deg; k += 32) {
      list[k] = list_entry(row_edge(nr, wr, k, deg, scale, pscale, gamma,
                                    chunk_rows));
    }
  }
  __syncwarp();

  // Stream the list kRowBatch edges at a time: all their gathers, then
  // their FMAs in list order, closing a chunk's partial where the next
  // edge's chunk differs (a warp-uniform test).
  float* orow = out + static_cast<int64_t>(r) * feat;
  for (int f0 = 0; f0 < feat; f0 += 32 * kVec) {
    const int f = f0 + lane * kVec;
    const bool live = f < feat;
    float total[kVec], part[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) total[v] = part[v] = 0.f;
    int cur = deg > 0 ? list[0].y : 0;
    for (int p = 0; p < deg; p += kRowBatch) {
      int4 e[kRowBatch];
      Raw<T, kVec> x[kRowBatch], px[kRowBatch];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        if (p + u < deg) e[u] = list[p + u];
      }
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        if (p + u < deg && live) {
          const int64_t off = static_cast<int64_t>(e[u].x) * feat + f;
          x[u] = *reinterpret_cast<const Raw<T, kVec>*>(data + off);
          if constexpr (kPred) {
            px[u] = *reinterpret_cast<const Raw<T, kVec>*>(pdata + off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        if (p + u < deg) {
          if (e[u].y != cur) {
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
              total[v] = total[v] + part[v];
              part[v] = 0.f;
            }
            cur = e[u].y;
          }
          if (live) {
            const float ws = __int_as_float(e[u].z);
            const float wp = __int_as_float(e[u].w);
            float a[kVec], b[kVec];
            unpack<T, kVec>(x[u], a);
            if constexpr (kPred) unpack<T, kVec>(px[u], b);
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
              part[v] = __fmaf_rn(ws, a[v], part[v]);
              if constexpr (kPred) part[v] = __fmaf_rn(wp, b[v], part[v]);
            }
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        orow[f + v] = chunked ? total[v] + part[v] : part[v];
      }
    }
  }
}

// Vector gathers where every gathered row starts on a vector boundary.
template <typename T>
static bool vec_gathers(const T* d, const T* pd, int feat) {
  const uintptr_t align = 4 * sizeof(T);
  return feat % 4 == 0 && reinterpret_cast<uintptr_t>(d) % align == 0
         && reinterpret_cast<uintptr_t>(pd) % align == 0;
}

// Which body a launch asks for: K2 or K3 (the edge list where the row
// fits, else the walk), or K3 on the walk.
enum HaloBody { kResident, kStream, kStreamWalk };

template <typename T, int kVec, bool kPred>
static cudaError_t launch_rows(HaloBody body, const int32_t* n,
                               const float* w, const T* d, const float* sc,
                               const T* pd, const float* psc, float gamma,
                               float* o, int rows, int deg, int n_tab,
                               int feat, int chunk_rows, cudaStream_t s) {
  int warps = kRowWarps;
  const bool chunked = body != kResident;
  if (!chunked) chunk_rows = INT_MAX;          // every edge in chunk 0
  const int64_t n_chunks = (static_cast<int64_t>(n_tab) + chunk_rows - 1)
                           / chunk_rows;
  const size_t per_warp = static_cast<size_t>(deg) * (sizeof(int4)
                                                      + sizeof(int));
  const bool list = body != kStreamWalk && per_warp <= kListSmemMax
                    && n_chunks * deg <= INT_MAX;
  if (!list) {
    halo_walk_kernel<T, kVec, kPred>
        <<<(rows + warps - 1) / warps, warps * 32, 0, s>>>(
            n, w, d, sc, pd, psc, gamma, o, rows, deg, feat, chunk_rows,
            chunked);
    return cudaGetLastError();
  }
  while (warps > 1 && warps * per_warp > kListSmemMax) warps /= 2;
  const size_t smem = warps * per_warp;
  const auto kernel = halo_list_kernel<T, kVec, kPred>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(rows + warps - 1) / warps, warps * 32, smem, s>>>(
      n, w, d, sc, pd, psc, gamma, o, rows, deg, feat, chunk_rows, chunked);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_typed(HaloBody body, const int32_t* n,
                                const float* w, const void* data,
                                const float* sc, const void* pdata,
                                const float* psc, float gamma, float* o,
                                int rows, int deg, int n_tab, int feat,
                                int chunk_rows, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const T* pd = static_cast<const T*>(pdata);
  const auto run = vec_gathers(d, pd, feat)
                   ? (pd != nullptr ? launch_rows<T, 4, true>
                                    : launch_rows<T, 4, false>)
                   : (pd != nullptr ? launch_rows<T, 1, true>
                                    : launch_rows<T, 1, false>);
  return run(body, n, w, d, sc, pd, psc, gamma, o, rows, deg, n_tab, feat,
             chunk_rows, s);
}

static int launch(HaloBody body, const void* nbr, const void* wts,
                  const void* data, int dtype, const void* scale,
                  const void* pdata, const void* pscale, float gamma,
                  void* out, int rows, int deg, int n_tab, int feat,
                  int chunk_rows, void* stream) {
  if (rows == 0 || feat == 0) return 0;
  if (body != kResident && chunk_rows < 1) {
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
      return static_cast<int>(launch_typed<float>(
          body, n, w, data, sc, pdata, psc, gamma, o, rows, deg, n_tab, feat,
          chunk_rows, s));
    case kBFloat16:
      return static_cast<int>(launch_typed<__nv_bfloat16>(
          body, n, w, data, sc, pdata, psc, gamma, o, rows, deg, n_tab, feat,
          chunk_rows, s));
    case kInt8:
      return static_cast<int>(launch_typed<int8_t>(
          body, n, w, data, sc, pdata, psc, gamma, o, rows, deg, n_tab, feat,
          chunk_rows, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const bool vec = vec_gathers(d, pd, feat);
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
  return launch(kResident, nbr, wts, data, dtype, scale, pdata, pscale,
                gamma, out, rows, deg, n_tab, feat, 0, stream);
}

extern "C" int halo_spmm_stream_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, int chunk_rows,
    void* stream) {
  return launch(kStream, nbr, wts, data, dtype, scale, pdata, pscale, gamma,
                out, rows, deg, n_tab, feat, chunk_rows, stream);
}

// K3 on its chunk walk at any degree (the body it takes for rows too long
// for the edge list), so that the walk can be checked and timed at every
// shape.
extern "C" int halo_spmm_stream_walk_launch(
    const void* nbr, const void* wts, const void* data, int dtype,
    const void* scale, const void* pdata, const void* pscale, float gamma,
    void* out, int rows, int deg, int n_tab, int feat, int chunk_rows,
    void* stream) {
  return launch(kStreamWalk, nbr, wts, data, dtype, scale, pdata, pscale,
                gamma, out, rows, deg, n_tab, feat, chunk_rows, stream);
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
