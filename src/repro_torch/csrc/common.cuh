// Shared helpers of the port's hand-written CUDA kernels (sm_90a).
//
// Each kernel library has a plain C interface loaded with ctypes: pointers
// and the stream arrive as void*, shapes as int, and every launch entry
// returns cudaGetLastError() so the Python wrapper can raise on a launch
// the runtime refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Storage dtype codes shared with repro_torch/kernels/_build.py.
enum StorageDtype { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// Thread layout of the one-thread-per-element ELL kernels (K5 and the
// SpMM weight gradient): one thread per (row, feature) pair.  Consecutive
// threads take consecutive features, so a gathered table row is read
// coalesced and the row's nbr/wts entries are one broadcast load per k.
// blockDim = (feature threads, rows per block).
constexpr int kThreadsPerBlock = 256;

inline dim3 ell_block(int feat) {
  int bx = ((feat + 31) / 32) * 32;
  if (bx > 128) bx = 128;
  return dim3(bx, kThreadsPerBlock / bx);
}

inline dim3 ell_grid(int rows, int feat, dim3 block) {
  return dim3((rows + block.y - 1) / block.y,
              (feat + block.x - 1) / block.x);
}

// The raw bits of kVec consecutive table elements: one 16-, 8- or 4-byte
// load of fp32, bf16 or int8 when kVec is 4 (int8 as one 32-bit word).
// The warp-per-row bodies gather a batch of these before they convert any
// (unpack), so that no gather waits on the one before it.
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

// ---------------------------------------------------------------------------
// Live slots of an ELL row (K1 and the SpMM table gradient)
// ---------------------------------------------------------------------------
//
// A warp owns an output row and walks the row's slots in 32-slot segments:
// lane j holds slot 32q + j of segment q, and a __ballot_sync gives the
// segment's live slots.  They are handed to every lane in ascending slot
// order, so that all lanes gather the same table rows (lanes split
// features, never slots) and the FMAs keep the slot order: K1 appends them
// to a list in shared memory (append_live); the table gradient, whose rows
// hold about three positions, passes them by __shfl_sync (spmm_bwd.cu).

// One slot as its lane holds it: the table row it reads and its weight.
struct Slot {
  int s;
  float w;
};

// Slot k of an ELL row (nr, wr); past the row's degree, the sentinel with
// weight 0.  Only loads: a caller issues every segment it reads together
// before it ballots any, so their loads are in flight at once.
__device__ __forceinline__ Slot ell_slot(const int32_t* __restrict__ nr,
                                         const float* __restrict__ wr,
                                         int k, int deg, int sentinel) {
  Slot e{sentinel, 0.f};
  if (k < deg) {
    e.s = nr[k];
    e.w = wr[k];
  }
  return e;
}

// A slot the product must take: all but padding, which is a zero weight
// on the sentinel row.  A zero weight on a real row stays (0 * inf is
// NaN), and so does a nonzero weight on the sentinel.
__device__ __forceinline__ bool live_slot(const Slot& e, int sentinel) {
  return !(e.w == 0.f && e.s == sentinel);
}

// Appends the entries of the lanes where `live` holds to the warp's
// list after its first n entries, in lane order; returns the new length.
// Every lane must call it; the caller __syncwarp()s before reading the
// list and before overwriting entries the warp may still read.
__device__ __forceinline__ int append_live(bool live, int2 entry,
                                           int2* list, int n) {
  const unsigned m = __ballot_sync(kFullMask, live);
  const int lane = threadIdx.x & 31;
  if (live) list[n + __popc(m & ((1u << lane) - 1))] = entry;
  return n + __popc(m);
}

// Writes a lane's kVec sums (one 16-byte store when kVec is 4).
template <int kVec>
__device__ __forceinline__ void store_sums(float* __restrict__ p,
                                           const float (&acc)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v) p[v] = acc[v];
  }
}

// How the warp-per-row kernels (K1, the table gradient) lay a launch out.
// A warp owns an output row.  Where rows x stripes give every SM at least
// kMinWarpsPerSm warps, a warp walks all of its row's stripes: kVec
// features a lane (4 where `vec`), 32 * kVec a stripe.  Where they do not
// (a 256-row query batch has 256 warps for 132 SMs), a row's 32-feature
// stripes go to ceil(feat / 32) warps of one feature a lane, so the row's
// gathers are spread over more warps.  Each output element keeps its own
// FMA chain in both, so both give the same bits.
constexpr int kMinWarpsPerSm = 8;

struct RowLayout {
  int vec;    // features a lane: 4 or 1
  int split;  // warps a row
};

// SMs of the current card (cached): the launchers choose how many warps a
// row gets from it.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// Vector access (kVec = 4) where every row starts on a vector boundary.
template <typename T>
inline bool vec_rows(const T* p, int feat) {
  return feat % 4 == 0
         && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// The layout (above) of `rows` output rows of `feat` features gathered
// from `table`.
template <typename T>
inline RowLayout row_layout(const T* table, int rows, int feat) {
  const bool vec = vec_rows(table, feat);
  const int lanes_f = vec ? 4 : 1;
  const int64_t stripes = (feat + 32 * lanes_f - 1) / (32 * lanes_f);
  if (static_cast<int64_t>(rows) * stripes
      >= static_cast<int64_t>(kMinWarpsPerSm) * sm_count()) {
    return {lanes_f, 1};
  }
  return {1, (feat + 31) / 32};
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
