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
// the online recurrence over k = 0 .. deg-1 in order,
//   m_k = max(m_{k-1}, e_k),  alpha_k = exp(m_{k-1} - m_k),
//   p_k = exp(e_k - m_k),  l = alpha_k l + p_k,  acc = acc alpha_k + p_k z,
// from m = -1e30, l = 0, acc = 0.  The reference's 128-row / 128-feature
// divisibility guard was a TPU tiling limit: here the grid masks its own
// ragged edges.
//
// What bounds it on an H100.  Per slot and feature it does two multiplies
// and an add against one gathered z element (under 1 FLOP a byte), and
// the least traffic (nbr, valid, s_dst, the referenced s_src and z rows,
// acc, m and l, each once) is about 4 MB at GAT's per-head shape on the
// papers-sim partition, about 1.3 us at the HBM rate.  The tables stay in
// the 50 MB L2.  What a launch costs beyond that: the row's dependent
// round trips (nbr, then its s_src and z gathers) and the instructions
// of the chain, which runs over every slot, padding included (no slot may
// be skipped, below): about nine a slot for each lane.
//
// Design: one warp per output row, 8 rows a block, no atomics.  The
// recurrence only looks serial: m_k is a prefix max, and max is exact, so
// any scan order gives the same bits; once the m_k are known, alpha_k and
// p_k depend on nothing else; only the l and acc updates chain.  So the
// row is taken in segments of up to 128 slots, in order, with (m, l, acc)
// carried across segments, and each segment in two phases:
// * Phase A, all slots at once: lane j holds slots j, j + 32, j + 64 and
//   j + 96 (coalesced nbr / valid loads, their s_src gathers in flight
//   together; a 32-slot group with no slot of the row is left out),
//   computes e with the plain version's fp32 ops (one add, one multiply by
//   0.2f, one select), the inclusive prefix max of each 32-slot group by
//   __shfl_up_sync with the carried max folded in, then alpha and p by
//   expf, and writes (idx, alpha, p) to the warp's list in shared memory
//   (1.5 KB a warp).
// * Phase B, in slot order: lane j takes features j, j + 32, ... (one
//   32-feature stripe after another), streams the list by broadcast
//   reads four entries at a time, issues a batch of 8 z gathers, then
//   runs the batch's 8 steps of the chain on registers, so no load sits
//   inside it.  Lane 0 writes m and l.  Rows of at most 128 slots build
//   their list once for all feature stripes; longer rows rebuild each
//   segment's list per stripe.  (GAT's per-head width on the main path
//   is 32: one stripe.)
//
// Numerics.  The max returns NaN when either operand is NaN, as
// torch.maximum and jnp.maximum do (fmaxf would drop it), so a NaN score
// at a valid slot makes m NaN from there on, as in the reference.  The
// chain uses __fmul_rn / __fadd_rn, which are never fused into an FMA, so
// l and acc round as the plain version's separate torch ops do, and expf
// (no fast math) is the function torch's own exp calls on the card.  No
// slot is skipped: an invalid slot after the row's first valid one has
// alpha = 1 and p = 0, but 0 * z is NaN where z holds Inf or NaN; a row's
// leading invalid slots carry l = 1 and acc += z each until its first
// valid slot resets them (alpha = exp(-1e30 - e) = 0); a row with no valid
// slot ends with m = -1e30, l = deg and acc = sum of its z rows; deg = 0
// gives m = -1e30, l = 0, acc = 0.  All four are the reference's
// semantics.  Precondition, as on the TPU: every index is below n_tab; the
// wrapper documents it and does not scan the indices.
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLeakySlope = 0.2f;
constexpr int kWarps = 8;     // rows (warps) a block
constexpr int kSeg = 128;     // slots a segment: four 32-slot groups

// z gathers in flight ahead of the chain (a multiple of 4: the list is
// read four entries at a time).
constexpr int kBatch = 8;
// Blocks an SM must hold (the register cap: at most 48 registers), so
// that five blocks of 8 rows on each of 132 SMs take the 5256 rows of
// GAT's training ELLs in one wave.
constexpr int kMinBlocks = 5;

// max(a, b) that returns NaN when either is NaN; b on a tie, as
// torch.cummax's later element does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// A warp's list of one segment's slots, read four entries at a time.
struct alignas(16) List {
  int idx[kSeg];
  float alpha[kSeg];
  float p[kSeg];
};

// Phase A over slots k0 .. k0 + 127 of the row (fewer at its end):
// writes the segment's (idx, alpha, p) to the warp's list and advances
// the running max m.  Returns the segment's length.
__device__ __forceinline__ int build_list(const int32_t* __restrict__ nr,
                                          const uint8_t* __restrict__ vr,
                                          const float* __restrict__ s_src,
                                          float sd, int k0, int deg,
                                          float& m, List& list) {
  constexpr int kGroups = kSeg / 32;
  const int lane = threadIdx.x & 31;
  const int n = min(kSeg, deg - k0);
  const int groups = (n + 31) / 32;   // the 32-slot groups that hold slots
  int idx[kGroups];
  bool ok[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int k = q * 32 + lane;
    ok[q] = k < n;
    idx[q] = ok[q] ? nr[k0 + k] : 0;
  }
  float e[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const bool v = ok[q] && vr[k0 + q * 32 + lane];
    float x = ok[q] ? __fadd_rn(sd, s_src[idx[q]]) : 0.f;
    x = x >= 0.f ? x : __fmul_rn(kLeakySlope, x);
    // Past the row's end -INFINITY, which leaves any running max as it
    // is: those slots come after every real slot of the segment.
    e[q] = v ? x : (ok[q] ? kNegInf : -INFINITY);
  }
  // Inclusive prefix max within each 32-slot group (the groups' scans
  // are independent, so their shuffles interleave).
  float s[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) s[q] = e[q];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (q < groups) {
        const float t = __shfl_up_sync(kFullMask, s[q], off);
        if (lane >= off) s[q] = nan_max(t, s[q]);
      }
    }
  }
  __syncwarp();                   // the warp is done reading the old list
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (q < groups) {
      const float incl = nan_max(m, s[q]);
      float prev = __shfl_up_sync(kFullMask, incl, 1);
      if (lane == 0) prev = m;
      m = __shfl_sync(kFullMask, incl, 31);
      if (ok[q]) {
        list.idx[q * 32 + lane] = idx[q];
        list.alpha[q * 32 + lane] = expf(prev - incl);
        list.p[q * 32 + lane] = expf(e[q] - incl);
      }
    }
  }
  __syncwarp();
  return n;
}

using Gathered = float[kBatch];

// The z gathers of list entries b .. b + kBatch - 1 (those below n where
// kTail), all issued before any is used.
template <bool kTail>
__device__ __forceinline__ void gather(const List& list, int b, int n,
                                       const float* __restrict__ zf,
                                       int feat, bool on, Gathered& x) {
  int idx[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; u += 4) {
    const int4 i4 = *reinterpret_cast<const int4*>(&list.idx[b + u]);
    idx[u] = i4.x; idx[u + 1] = i4.y; idx[u + 2] = i4.z; idx[u + 3] = i4.w;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if ((!kTail || b + u < n) && on) {
      x[u] = zf[static_cast<int64_t>(idx[u]) * feat];
    }
  }
}

// The chain's steps over the same entries, in order (a lane past the
// row's features, `on` false, updates only l).
template <bool kTail>
__device__ __forceinline__ void steps(const List& list, int b, int n,
                                      const Gathered& x, bool on,
                                      float& acc, float& l) {
  float alpha[kBatch], p[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; u += 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(&list.alpha[b + u]);
    const float4 p4 = *reinterpret_cast<const float4*>(&list.p[b + u]);
    alpha[u] = a4.x; alpha[u + 1] = a4.y; alpha[u + 2] = a4.z;
    alpha[u + 3] = a4.w;
    p[u] = p4.x; p[u + 1] = p4.y; p[u + 2] = p4.z; p[u + 3] = p4.w;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (!kTail || b + u < n) {
      l = __fadd_rn(__fmul_rn(alpha[u], l), p[u]);
      if (on) {
        acc = __fadd_rn(__fmul_rn(acc, alpha[u]), __fmul_rn(p[u], x[u]));
      }
    }
  }
}

// Phase B over the list's n slots in order: acc = acc * alpha + p * z and
// l = alpha * l + p, a batch of gathers at a time.
__device__ __forceinline__ void chain(const List& list, int n,
                                      const float* __restrict__ zf, int feat,
                                      bool on, float& acc, float& l) {
  for (int b = 0; b < n; b += kBatch) {
    Gathered x;
    if (b + kBatch <= n) {
      gather<false>(list, b, n, zf, feat, on, x);
      steps<false>(list, b, n, x, on, acc, l);
    } else {
      gather<true>(list, b, n, zf, feat, on, x);
      steps<true>(list, b, n, x, on, acc, l);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
gat_edge_kernel(const int32_t* __restrict__ nbr,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ s_dst,
                const float* __restrict__ s_src, const float* __restrict__ z,
                float* __restrict__ acc_out, float* __restrict__ m_out,
                float* __restrict__ l_out, int rows, int deg, int feat) {
  __shared__ List lists[kWarps];
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps
                    + (threadIdx.x >> 5);
  if (r >= rows) return;                      // the whole warp leaves
  const int32_t* nr = nbr + r * deg;
  const uint8_t* vr = valid + r * deg;
  List& list = lists[threadIdx.x >> 5];
  const float sd = s_dst[r];
  const bool once = deg <= kSeg;
  float m = kNegInf, l = 0.f;
  int n = 0;
  // At least one stripe, so that m and l are computed when feat is 0.
  for (int f0 = 0; f0 == 0 || f0 < feat; f0 += 32) {
    const int f = f0 + lane;
    const bool on = f < feat;
    float acc = 0.f;
    l = 0.f;
    if (!once) m = kNegInf;
    for (int k0 = 0; k0 < deg; k0 += kSeg) {
      if (!once || f0 == 0) {
        n = build_list(nr, vr, s_src, sd, k0, deg, m, list);
      }
      chain(list, n, z + f, feat, on, acc, l);
    }
    if (on) acc_out[r * feat + f] = acc;
  }
  if (lane == 0) {
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
  if (rows == 0) return 0;
  const int64_t blocks = (static_cast<int64_t>(rows) + kWarps - 1) / kWarps;
  gat_edge_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(s_dst), static_cast<const float*>(s_src),
      static_cast<const float*>(z), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), rows, deg, feat);
  return static_cast<int>(cudaGetLastError());
}
