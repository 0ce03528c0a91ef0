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
// What bounds them on an H100.  Each output element costs one FMA per
// term against one gathered element, as in the forward, and g (2.7 MB at
// the training shape) stays in the L2.  At the training shape (papers-sim,
// one subgraph: in-ELL 5256 x 56, 128 wide; its transpose 5257 x 49 with
// 3.0 live positions a row) spmm_bwd_table moves the positions, the
// weights, g and dtable, about 9 MB (2.3 us at the HBM rate), but each row
// is a chain of dependent round trips: the positions, then the weights and
// g rows they name.  That latency bounds it.  spmm_bwd_wts at GAT's
// per-head shape (5256 x 56 over 5257 x 32) moves about 3.7 MB (1.1 us at
// the HBM rate): nbr, g, the referenced table rows and dwts, each once.
//
// spmm_bwd_table.  The scatter-add of dtable would need float atomics,
// whose order changes from run to run; the kernel gathers instead,
// through the transposed ELL built on the host
// (repro_torch/graph/transpose.py): row j lists the flat ELL positions p
// with nbr[p] = j in ascending order, padded with n_pos = rows * deg.
// One warp owns a table row j, its lanes split features as in K1 (the same
// launch layout, common.cuh row_layout).  The warp reads pos[j, 0:32] in
// one coalesced load, and a __ballot_sync of p < n_pos gives the live
// positions; padding ends the walk, so a segment that is not full is the
// row's last (the transpose pads at the end of a row).  The lane of each
// live position loads its weight wts[p] and row i = p / deg; the rows are
// handed out in ascending order by __shfl_sync and all of a batch's g[i]
// gathers are issued before the weights are shuffled in (their loads were
// in flight beside them) and the FMAs run; a list in shared memory, as
// K1 uses, measured slower here (PERF.md, section 6).  Each element is one
// fp32
// accumulator from +0.0 with one __fmaf_rn per position in ascending
// order, the order of spmm_bwd_table_plain.  The sentinel row's positions
// are not in the transpose (it is a constant of the layout), so its dtable
// row is 0.
//
// spmm_bwd_wts.  One warp owns an ELL row i (8 a block), as K1 does.  It
// reads the row's nbr 64 slots at a time (two coalesced loads in flight
// with g[i]'s first 128 features), and a __ballot_sync per 32-slot
// segment appends the live slots, those whose index is not the sentinel
// n_tab - 1, to the warp's list in shared memory in ascending k, and
// notes each slot's list position; the sentinel row gets one entry of its
// own, once a row.  g[i] is staged in shared memory.  Lane e % 32 then
// takes list entry e: it gathers its table row, 4 vectors (8 elements) in
// flight before it converts any, and sums <g[i], table[s]> from +0.0 with
// one __fmaf_rn a feature in ascending f, g read by broadcast: the chain
// of the one-thread-per-slot kernel this replaces, so each value is bit
// for bit the same.  The warp writes dwts[i, :] in one coalesced pass,
// every sentinel slot taking the sentinel's value.  That equals the
// slot-by-slot result for any contents of the sentinel row (zero,
// nonzero or NaN) and any weights, so unlike K1's skip it needs no
// precondition.  At GAT's in-ELL (5256 x 56, 3.0 real edges a row) a warp
// computes four dot products where the old kernel ran 56 threads, each
// re-reading g[i] and walking its own row with uncoalesced scalar loads.
// What remains is latency, the nbr round trip and then one of gathers,
// and instruction issue: registers are capped at 48 so that all 5256
// rows are in flight at once (two or four rows a warp measured slower
// over the four GAT shapes, PERF.md, section 6).  Neither kernel uses
// atomics, so both results are deterministic.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;      // warps a block

// Positions gathered together before their FMAs, for vector lanes or one
// feature a lane, and the blocks an SM must hold (a cap of 40 registers a
// thread: a row has about three positions, so warps in flight, not the
// batch, hide the round trip).
template <int kVec>
constexpr int kBatch = kVec == 4 ? 2 : 4;
constexpr int kMinBlocks = 6;

// The lanes of the next (up to) kBatch slots set in `hit` (warp-uniform),
// lowest first, cleared from `hit`; returns how many.  src[u] for u past
// the count is left as it was.
template <int kBatch>
__device__ __forceinline__ int take_lanes(unsigned& hit,
                                          int (&src)[kBatch]) {
  int n = 0;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (hit != 0) {
      src[u] = __ffs(hit) - 1;
      hit &= hit - 1;
      n = u + 1;
    }
  }
  return n;
}

// Adds the slots set in `hit` (warp-uniform; lane j holds its slot in e)
// to the lane's sums acc[v] += w * table[s, f + v], in ascending lane
// order, one __fmaf_rn each, kBatch at a time.  Each batch shuffles the
// rows out, issues all its gathers, and only then shuffles the weights in
// and converts, so no gather waits on a weight load or on the gather
// before it.  `on` false: the lane's features lie past the row (it still
// shuffles).
template <typename T, int kVec, int kBatch>
__device__ __forceinline__ void add_slots(unsigned hit, const Slot& e,
                                          const T* __restrict__ table,
                                          int feat, int f, bool on,
                                          float (&acc)[kVec]) {
  while (hit != 0) {
    int src[kBatch], s[kBatch];
    const int n = take_lanes<kBatch>(hit, src);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < n) s[u] = __shfl_sync(kFullMask, e.s, src[u]);
    }
    Raw<T, kVec> x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < n && on) {
        x[u] = *reinterpret_cast<const Raw<T, kVec>*>(
            table + static_cast<int64_t>(s[u]) * feat + f);
      }
    }
    float w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < n) w[u] = __shfl_sync(kFullMask, e.w, src[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < n && on) {
        float a[kVec];
        unpack<T, kVec>(x[u], a);
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = __fmaf_rn(w[u], a[v], acc[v]);
      }
    }
  }
}

// The bits of `m` below its lowest clear bit: the live positions of a
// segment before its first padding.
__device__ __forceinline__ unsigned live_prefix(unsigned m) {
  return m == kFullMask ? kFullMask : (1u << (__ffs(~m) - 1)) - 1;
}

// Segment q of table row j's positions: the lane's slot (g row p / deg
// and weight wts[p], loaded by the position's own lane) and the segment's
// live positions before its first padding in `hit`; returns whether the
// segment was full (no padding met, so the row may go on).
__device__ __forceinline__ bool position_segment(
    const int32_t* __restrict__ pj, int q, int t_deg, int deg, int n_pos,
    const float* __restrict__ wts, Slot& e, unsigned& hit) {
  const int t = q * 32 + (threadIdx.x & 31);
  const int p = t < t_deg ? pj[t] : n_pos;
  const unsigned m = __ballot_sync(kFullMask, p < n_pos);
  hit = live_prefix(m);
  e = Slot{0, 0.f};
  if (hit >> (threadIdx.x & 31) & 1) {
    e.s = p / deg;
    e.w = wts[p];
  }
  return m == kFullMask;
}

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
bwd_table_kernel(const int32_t* __restrict__ pos,
                 const float* __restrict__ wts, const float* __restrict__ g,
                 float* __restrict__ dtab, int n_tab, int t_deg, int deg,
                 int n_pos, int feat, int split) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps
                    + (threadIdx.x >> 5);
  const int64_t j = w / split;
  if (j >= n_tab) return;                     // the whole warp leaves
  const int first = static_cast<int>(w % split);
  const int32_t* pj = pos + j * t_deg;
  // The first segment is held for every stripe; a full one (padding not
  // met) means the row goes on, segment by segment.
  Slot e0;
  unsigned h0;
  const bool full0 = position_segment(pj, 0, t_deg, deg, n_pos, wts, e0,
                                      h0);
  constexpr int kStripe = 32 * kVec;
  float* orow = dtab + j * feat;
  for (int f0 = first * kStripe; f0 < feat; f0 += split * kStripe) {
    const int f = f0 + lane * kVec;
    const bool on = f < feat;
    float acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
    add_slots<float, kVec, kBatch<kVec>>(h0, e0, g, feat, f, on, acc);
    bool more = full0;
    for (int q = 1; more && q * 32 < t_deg; ++q) {
      Slot e;
      unsigned h;
      more = position_segment(pj, q, t_deg, deg, n_pos, wts, e, h);
      add_slots<float, kVec, kBatch<kVec>>(h, e, g, feat, f, on, acc);
    }
    if (on) store_sums<kVec>(orow + f, acc);
  }
}

template <int kVec>
cudaError_t run_table(const int32_t* pos, const float* wts, const float* g,
                      float* dtab, int n_tab, int t_deg, int deg, int n_pos,
                      int feat, int split, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(n_tab) * split;
  bwd_table_kernel<kVec><<<static_cast<unsigned>((warps + kWarps - 1)
                                                 / kWarps),
                           kWarps * 32, 0, stream>>>(
      pos, wts, g, dtab, n_tab, t_deg, deg, n_pos, feat, split);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// spmm_bwd_wts: a warp per ELL row, a lane per live slot
// ---------------------------------------------------------------------------

constexpr int kWtsSlots = 64;    // slots a list round reads: two segments
constexpr int kGChunk = 128;     // features of g[i] staged at a time
// Table elements a lane gathers together before their FMAs (vectors of 4,
// or single elements), and the blocks an SM must hold: a cap of 48
// registers a thread, so that the 5256 rows of the training ELLs are all
// in flight at once (40 warps an SM; a cap of 64 left a second wave).
template <int kVec>
constexpr int kWtsBatch = kVec == 4 ? 4 : 8;
constexpr int kWtsMinBlocks = 5;

// acc + sum_f gs[f] * row[f] over f < nf: one __fmaf_rn a feature in
// ascending f, kWtsBatch gathers issued before any is converted.  gs is
// the warp's staged chunk of g[i], read by broadcast.
template <typename T, int kVec>
__device__ __forceinline__ float dot_chunk(const float* gs,
                                           const T* __restrict__ row, int nf,
                                           float acc) {
  constexpr int kB = kWtsBatch<kVec>;
  for (int f = 0; f < nf; f += kB * kVec) {
    Raw<T, kVec> x[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (f + u * kVec < nf) {
        x[u] = *reinterpret_cast<const Raw<T, kVec>*>(row + f + u * kVec);
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (f + u * kVec < nf) {
        float a[kVec], gv[kVec];
        unpack<T, kVec>(x[u], a);
        if constexpr (kVec == 4) {
          const float4 q = *reinterpret_cast<const float4*>(gs + f + 4 * u);
          gv[0] = q.x; gv[1] = q.y; gv[2] = q.z; gv[3] = q.w;
        } else {
          gv[0] = gs[f + u];
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc = __fmaf_rn(gv[v], a[v], acc);
      }
    }
  }
  return acc;
}

// g[i, f0 + lane + 32 m] for m < kGChunk / 32 (0 past the row).
__device__ __forceinline__ void load_g(const float* __restrict__ gi, int f0,
                                       int feat,
                                       float (&x)[kGChunk / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kGChunk / 32; ++m) {
    const int f = f0 + lane + 32 * m;
    x[m] = f < feat ? gi[f] : 0.f;
  }
}

__device__ __forceinline__ void store_g(float* gs,
                                        const float (&x)[kGChunk / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kGChunk / 32; ++m) gs[lane + 32 * m] = x[m];
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32, kWtsMinBlocks)
bwd_wts_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ g,
               const T* __restrict__ table, float* __restrict__ dwts,
               int rows, int deg, int feat, int sentinel) {
  __shared__ __align__(16) float g_s[kWarps][kGChunk];
  __shared__ int list_s[kWarps][kWtsSlots + 1];
  __shared__ float val_s[kWarps][kWtsSlots + 1];
  __shared__ int at_s[kWarps][kWtsSlots];
  constexpr int kSeg = kWtsSlots / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (i >= rows) return;                      // the whole warp leaves
  const int32_t* nr = nbr + i * deg;
  const float* gi = g + i * feat;
  float* out = dwts + i * deg;
  float* gs = g_s[warp];
  int* list = list_s[warp];
  float* val = val_s[warp];
  int* at = at_s[warp];
  float sent = 0.f;          // <g[i], table[sentinel]> once computed
  bool have_sent = false;    // warp-uniform
  for (int k0 = 0; k0 < deg; k0 += kWtsSlots) {
    // The round's slots and g's first chunk: all loads in flight at once.
    int s[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int k = k0 + 32 * j + lane;
      s[j] = k < deg ? nr[k] : sentinel;
    }
    float gx[kGChunk / 32];
    load_g(gi, 0, feat, gx);
    __syncwarp();            // the warp is done with the last round
    // The live slots (not the sentinel) in ascending k, each slot's list
    // position in `at` (-1: the sentinel), then one entry for the
    // sentinel row if the round has a sentinel slot and no earlier round
    // computed it.
    int n = 0;
    bool any_sent = false;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const bool in = k0 + 32 * j + lane < deg;
      const bool live = in && s[j] != sentinel;
      const unsigned m = __ballot_sync(kFullMask, live);
      const int rank = n + __popc(m & ((1u << lane) - 1));
      if (live) list[rank] = s[j];
      at[32 * j + lane] = live ? rank : -1;
      n += __popc(m);
      any_sent |= __any_sync(kFullMask, in && s[j] == sentinel);
    }
    int sent_at = -1;
    if (any_sent && !have_sent) {
      if (lane == 0) list[n] = sentinel;
      sent_at = n++;
    }
    store_g(gs, gx);
    __syncwarp();
    // Lane e % 32 computes entry e over g's chunks in ascending f.
    for (int f0 = 0; f0 < feat; f0 += kGChunk) {
      if (f0 > 0) {
        load_g(gi, f0, feat, gx);
        __syncwarp();        // every lane is done with the last chunk
        store_g(gs, gx);
        __syncwarp();
      }
      const int nf = min(kGChunk, feat - f0);
      for (int e = lane; e < n; e += 32) {
        val[e] = dot_chunk<T, kVec>(
            gs, table + static_cast<int64_t>(list[e]) * feat + f0, nf,
            f0 == 0 ? 0.f : val[e]);
      }
    }
    __syncwarp();
    if (sent_at >= 0) {
      sent = val[sent_at];
      have_sent = true;
    }
    // The round's values in one coalesced pass.
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int k = k0 + 32 * j + lane;
      if (k < deg) {
        const int a = at[32 * j + lane];
        out[k] = a < 0 ? sent : val[a];
      }
    }
  }
}

template <typename T, int kVec>
cudaError_t run_wts(const int32_t* nbr, const float* g, const T* table,
                    float* dwts, int rows, int deg, int feat, int sentinel,
                    cudaStream_t stream) {
  bwd_wts_kernel<T, kVec><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                            stream>>>(nbr, g, table, dwts, rows, deg, feat,
                                      sentinel);
  return cudaGetLastError();
}

// Vector lanes where every table row and every g row starts on a vector
// boundary.
template <typename T>
cudaError_t launch_wts(const void* nbr, const void* g, const void* table,
                       void* dwts, int rows, int deg, int n_tab, int feat,
                       cudaStream_t stream) {
  const auto* n = static_cast<const int32_t*>(nbr);
  const auto* gp = static_cast<const float*>(g);
  const auto* t = static_cast<const T*>(table);
  auto* d = static_cast<float*>(dwts);
  return vec_rows(t, feat) && vec_rows(gp, feat)
             ? run_wts<T, 4>(n, gp, t, d, rows, deg, feat, n_tab - 1, stream)
             : run_wts<T, 1>(n, gp, t, d, rows, deg, feat, n_tab - 1, stream);
}

}  // namespace

extern "C" int spmm_bwd_table_launch(const void* pos, const void* wts,
                                     const void* g, void* dtab, int n_tab,
                                     int t_deg, int deg, int n_pos, int feat,
                                     void* stream) {
  if (n_tab == 0 || feat == 0) return 0;
  if (deg < 1 || t_deg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* gp = static_cast<const float*>(g);
  const RowLayout lay = row_layout(gp, n_tab, feat);
  const auto run = lay.vec == 4 ? run_table<4> : run_table<1>;
  return static_cast<int>(run(
      static_cast<const int32_t*>(pos), static_cast<const float*>(wts), gp,
      static_cast<float*>(dtab), n_tab, t_deg, deg, n_pos, feat, lay.split,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int spmm_bwd_wts_launch(const void* nbr, const void* g,
                                   const void* table, int dtype, void* dwts,
                                   int rows, int deg, int n_tab, int feat,
                                   void* stream) {
  if (rows == 0 || deg == 0) return 0;
  if (n_tab < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feat == 0) {
    return static_cast<int>(cudaMemsetAsync(
        dwts, 0, sizeof(float) * static_cast<size_t>(rows) * deg, s));
  }
  switch (dtype) {
    case kFloat32:
      return static_cast<int>(launch_wts<float>(nbr, g, table, dwts, rows,
                                                deg, n_tab, feat, s));
    case kBFloat16:
      return static_cast<int>(launch_wts<__nv_bfloat16>(
          nbr, g, table, dwts, rows, deg, n_tab, feat, s));
    case kInt8:
      return static_cast<int>(launch_wts<int8_t>(nbr, g, table, dwts, rows,
                                                 deg, n_tab, feat, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
