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
// per-head shape (5256 x 56 over 5257 x 32) moves about 5 MB.
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
// spmm_bwd_wts takes one thread per (row, slot) and sums the feature dot
// product in ascending f with fp32 FMAs.  Neither kernel uses atomics, so
// both results are deterministic.
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

}  // namespace

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
  const auto* gp = static_cast<const float*>(g);
  const RowLayout lay = row_layout(gp, n_tab, feat);
  const auto run = lay.vec == 4 ? run_table<4> : run_table<1>;
  return static_cast<int>(run(
      static_cast<const int32_t*>(pos), static_cast<const float*>(wts), gp,
      static_cast<float*>(dtab), n_tab, t_deg, deg, n_pos, feat, lay.split,
      static_cast<cudaStream_t>(stream)));
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
