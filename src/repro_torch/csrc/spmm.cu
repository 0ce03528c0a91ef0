// K1: ELL SpMM, out[i, f] = sum_k wts[i, k] * table[nbr[i, k], f].
//
// Replaces the TPU kernel src/repro/kernels/spmm/spmm.py::spmm_pallas
// (body _spmm_kernel): the neighbour aggregation of every GNN layer.
//
// What bounds it on an H100.  One FMA per gathered element, about 0.5
// FLOP a byte: never the arithmetic.  The tables (at most a few MB) stay in
// the 50 MB L2, so what bounds a launch is how fast gathered rows come
// from the L2, or how long a row's chain of round trips to it is:
// * the full-graph refresh (12000 x 80 slots over a 12001 x 128 fp32
//   table, 49.6 real edges a row): the L2's gather rate.  The real edges
//   are 305 MB of L2-to-SM traffic against 20 MB for the HBM bound (about
//   6 us), and consecutive rows share few neighbours (unique/real 0.97 over
//   16 rows, 0.88 over 64), so staging rows in shared memory would save
//   little;
// * the training ELLs (in-ELL 5256 x 56, 3.0 real edges a row; out-ELL
//   5256 x 64, 5.6) and the 256 x 80 query batch: latency, the row's one
//   nbr/wts round trip and then one round trip per batch of gathers.
//
// Skipping padding.  Padding points at the table's last row, the zero
// sentinel, with weight 0; a slot is skipped exactly when its weight is 0
// and its row is that sentinel (n_tab - 1), wherever it lies in the row.
// The plain version adds 0 * table[sentinel] for such a slot: a signed
// zero while the sentinel row is finite, which leaves the sum equal up to
// the sign of a zero result.  A zero weight on a real row is kept (0 * inf
// is NaN there, as in the plain version), and so is a nonzero weight on
// the sentinel.  At the training in-ELL 95% of the slots are padding.
//
// Design.  One warp owns an output row, and lanes split features, never
// slots.  The warp reads the row's nbr/wts once, 128 slots at a time (lane
// j holds slots j, j + 32, j + 64, j + 96: four coalesced loads in flight
// together), a __ballot_sync per 32-slot segment gives the live slots, and
// their (s, w) pairs are appended in ascending k to the warp's list in
// shared memory.  Every lane then streams the list, broadcast reads, 4
// (vector lanes) or 16 (one feature a lane) at a time, all of a batch's
// gathers issued before it converts any or does any FMA (a bf16 or int8
// conversion beside its load would make each gather wait for the one
// before).  Rows of at most 128 slots build their list once for all
// stripes.  On the card the list beat handing the pairs out by
// __shfl_sync, which took a serial find-first-set and two shuffles a slot
// (PERF.md, section 6).  Registers are capped (64 a thread for vector lanes,
// 85 for one feature a lane) so that 32 or 24 warps fit on an SM: at the
// training ELLs a row is one round trip of gathers, and the SM's warps in
// flight, not the batch, hide it.  The launch layout (common.cuh,
// row_layout): with enough rows to give every SM 8 warps, a warp walks all
// of its row's stripes, 16 bytes of fp32, 8 of bf16 or 4 of int8 a lane
// where feat % 4 == 0 and the table is aligned (128 features a stripe),
// else one feature a lane (32); with fewer rows (the query batch) one
// feature a lane and ceil(feat / 32) warps a row, each warp building the
// row's list itself.
//
// Numerics.  Each output element is one fp32 accumulator from +0.0,
// updated by one __fmaf_rn per live slot in ascending k: the order of the
// TPU kernel's fori_loop, of the plain version (which rounds each product
// first) and of K3 over one chunk, so K3 over one chunk equals K1 bit for
// bit.  The layouts keep each element's chain, so they agree bit for bit.
// No atomics: the result is the same run to run.  Precondition, as on the
// TPU: every index is below n_tab; the wrapper documents it and does not
// scan the indices.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;        // warps a block
constexpr int kListSlots = 128;  // slots a list round reads: four segments

// Slots gathered together before their FMAs, and the blocks an SM must
// hold (the register cap): vector lanes, or one feature a lane.
template <int kVec>
constexpr int kBatch = kVec == 4 ? 4 : 16;
template <int kVec>
constexpr int kMinBlocks = kVec == 4 ? 4 : 3;

// Appends the live slots among slots k0 .. k0 + 127 of the row to the
// warp's list (emptied first); returns its length.
__device__ __forceinline__ int build_list(const int32_t* __restrict__ nr,
                                          const float* __restrict__ wr,
                                          int k0, int deg, int sentinel,
                                          int2* list) {
  const int lane = threadIdx.x & 31;
  Slot e[kListSlots / 32];
#pragma unroll
  for (int j = 0; j < kListSlots / 32; ++j) {
    e[j] = ell_slot(nr, wr, k0 + j * 32 + lane, deg, sentinel);
  }
  __syncwarp();                   // the warp is done reading the old list
  int n = 0;
#pragma unroll
  for (int j = 0; j < kListSlots / 32; ++j) {
    n = append_live(live_slot(e[j], sentinel),
                    make_int2(e[j].s, __float_as_int(e[j].w)), list, n);
  }
  __syncwarp();
  return n;
}

// acc[v] += w * table[s, f + v] over the list's n slots in order, kBatch
// gathers in flight at a time.
template <typename T, int kVec>
__device__ __forceinline__ void add_list(const int2* list, int n,
                                         const T* __restrict__ table,
                                         int feat, int f, bool on,
                                         float (&acc)[kVec]) {
  constexpr int kB = kBatch<kVec>;
  for (int p = 0; p < n; p += kB) {
    int2 e[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (p + u < n) e[u] = list[p + u];
    }
    Raw<T, kVec> x[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (p + u < n && on) {
        x[u] = *reinterpret_cast<const Raw<T, kVec>*>(
            table + static_cast<int64_t>(e[u].x) * feat + f);
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (p + u < n && on) {
        float a[kVec];
        unpack<T, kVec>(x[u], a);
        const float w = __int_as_float(e[u].y);
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = __fmaf_rn(w, a[v], acc[v]);
      }
    }
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks<kVec>)
spmm_kernel(const int32_t* __restrict__ nbr, const float* __restrict__ wts,
            const T* __restrict__ table, float* __restrict__ out, int rows,
            int deg, int feat, int sentinel, int split) {
  __shared__ int2 lists[kWarps][kListSlots];
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps
                    + (threadIdx.x >> 5);
  const int64_t r = w / split;
  if (r >= rows) return;                      // the whole warp leaves
  const int first = static_cast<int>(w % split);
  const int32_t* nr = nbr + r * deg;
  const float* wr = wts + r * deg;
  int2* list = lists[threadIdx.x >> 5];
  constexpr int kStripe = 32 * kVec;
  float* orow = out + r * feat;
  if (deg <= kListSlots) {
    // The row's one list serves all of the warp's stripes.
    const int n = build_list(nr, wr, 0, deg, sentinel, list);
    for (int f0 = first * kStripe; f0 < feat; f0 += split * kStripe) {
      const int f = f0 + lane * kVec;
      const bool on = f < feat;
      float acc[kVec] = {};
      add_list<T, kVec>(list, n, table, feat, f, on, acc);
      if (on) store_sums<kVec>(orow + f, acc);
    }
    return;
  }
  for (int f0 = first * kStripe; f0 < feat; f0 += split * kStripe) {
    const int f = f0 + lane * kVec;
    const bool on = f < feat;
    float acc[kVec] = {};
    for (int k0 = 0; k0 < deg; k0 += kListSlots) {
      add_list<T, kVec>(list, build_list(nr, wr, k0, deg, sentinel, list),
                        table, feat, f, on, acc);
    }
    if (on) store_sums<kVec>(orow + f, acc);
  }
}

template <typename T, int kVec>
cudaError_t run(const int32_t* nbr, const float* wts, const T* table,
                float* out, int rows, int deg, int feat, int sentinel,
                int split, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(rows) * split;
  spmm_kernel<T, kVec><<<static_cast<unsigned>((warps + kWarps - 1)
                                               / kWarps),
                         kWarps * 32, 0, stream>>>(
      nbr, wts, table, out, rows, deg, feat, sentinel, split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* nbr, const void* wts, const void* table,
                   void* out, int rows, int deg, int n_tab, int feat,
                   cudaStream_t stream) {
  const auto* n = static_cast<const int32_t*>(nbr);
  const auto* w = static_cast<const float*>(wts);
  const auto* t = static_cast<const T*>(table);
  auto* o = static_cast<float*>(out);
  const RowLayout lay = row_layout(t, rows, feat);
  return lay.vec == 4
             ? run<T, 4>(n, w, t, o, rows, deg, feat, n_tab - 1, lay.split,
                         stream)
             : run<T, 1>(n, w, t, o, rows, deg, feat, n_tab - 1, lay.split,
                         stream);
}

}  // namespace

extern "C" int spmm_launch(const void* nbr, const void* wts,
                           const void* table, int dtype, void* out, int rows,
                           int deg, int n_tab, int feat, void* stream) {
  if (rows == 0 || feat == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return static_cast<int>(launch<float>(nbr, wts, table, out, rows, deg,
                                            n_tab, feat, s));
    case kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(nbr, wts, table, out,
                                                    rows, deg, n_tab, feat,
                                                    s));
    case kInt8:
      return static_cast<int>(launch<int8_t>(nbr, wts, table, out, rows,
                                             deg, n_tab, feat, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
