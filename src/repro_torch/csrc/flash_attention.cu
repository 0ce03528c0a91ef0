// K6: blocked flash attention forward, out = softmax(scale * Q K^T) V,
// causal or not, with grouped-query heads.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body _attn_kernel): the prefill attention of the LM transformer.
//
// What it computes, as the TPU kernel does: the running row max m,
// normaliser l and accumulator acc are fp32; causal masking writes -1e30;
// K/V tiles strictly above the diagonal are not visited; out = acc /
// max(l, 1e-30), cast to the input type.  The inputs are fp32 or bf16.
// Grouped-query attention reads K/V head h / (H / KV) directly, where the
// reference repeats K/V in ops.py first.  The reference's seq % block
// guard was a TPU tiling limit: here the last Q and K tiles may be ragged,
// and key columns past the sequence are masked like causal ones.
// flash_attention_launch picks the kernel by dtype, one launch per call.
//
// What bounds it on an H100: operations.  At the LM slice's shape (B 4,
// S 1024, H 16, KV 8, D 128, causal) the work is 17.2 GFLOP over 50 MB
// of inputs and output: 17 us at the bf16 tensor-core rate, 257 us at
// the fp32 rate of the CUDA cores.
//
// fp32 inputs (flash_attention_f32) keep the reference's arithmetic on
// the CUDA cores: Q is scaled by sm_scale in fp32 first, each S element is
// one fp32 FMA chain over d in ascending order, the online softmax runs per
// 64-key tile, and O takes one FMA per key in ascending order.  No TF32.
// What held the first body (one 64-row tile, a 4 x 4 micro-tile a thread)
// to 3.5x its bound was shared memory: scalar reads fed 2-2.7 FMAs a word,
// 115 KB a block left one block of 8 warps an SM, and loads did not overlap
// the math.  This body, per block of 256 threads and one 128-row Q tile
// (the heaviest causal tiles scheduled first):
// - Register-blocked micro-tiles fed by 16-byte shared reads.  Thread
//   (rg, cg) owns rows rg + 16 u (u < 8): an 8 x 4 tile of S (columns
//   cg + 16 v), Q and K read as float4 along d (12 reads a 128 FMAs), and
//   8 x D/16 of O, P read as float4 along the keys and V as float4 along d
//   (16 reads a 256 FMAs at D 128).  Q and K rows are padded to D + 4
//   floats, P rows to 80, so no read or write of a warp conflicts beyond
//   its bytes.
// - K double-buffered and V single-buffered by cp.async (16-byte .cg
//   copies; a view that is not 16-byte aligned takes 4-byte copies in the
//   same kernel): K tile t + 1 and V tile t are in flight while tile t's
//   S and softmax run.  Three barriers a tile.  Rows past the sequence
//   arrive as zeros.
// - 204 KB of shared memory at D 128 (Q, two K stages, V, P): one block
//   of 8 warps an SM, each warp with 64 independent FMA chains.  A 128-row
//   Q tile halves the K/V traffic and the barriers per FMA of a 64-row
//   one; two 64-row blocks an SM would not fit K's two stages.
// The row max and sum reduce over the 16 lanes of a half-warp by shuffles,
// in the order of the first body, whose results this body repeats.
//
// bf16 inputs (flash_attention_wgmma) run on the tensor cores: fp32 FMAs
// fed from shared memory reach about 20 TFLOP/s, 50x the bf16 bound.
// Numerics, as close to the reference's fp32 arithmetic as the tensor
// cores allow:
// - S = Q K^T is taken on the unscaled bf16 inputs (their products are
//   exact in fp32, the sum is fp32) and then scaled by sm_scale in fp32.
// - m, l and acc stay fp32 in registers.
// - P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and acc
//   takes P_hi V + P_lo V: P carries about 16 significant bits, where one
//   bf16 P (8 bits) would put outputs near zero outside the bar of fp32
//   2e-5 plus one bf16 ulp.  The split costs a second P V product, 1.5x
//   the tensor work (the bound counts the function's work, not this).
// Design, per block: consumer warpgroups of 64 Q rows each and one
// producer warp.  A block serves the same 64-row Q tile of one or two
// query heads that share a KV head (two when H / KV is even), so both
// warpgroups read each K/V tile from one copy.  The producer's first lane
// copies the Q tiles once and then keeps K/V tiles in flight in a
// two-stage ring in dynamic shared memory, by TMA (cp.async.bulk.tensor
// over a 4-D map of the strided (B, heads, S, D) view, so transposed views
// and flat 3-D tensors are read in place; the map is encoded through
// cudaGetDriverEntryPoint, so the library needs no -lcuda), each stage
// guarded by a full and an empty mbarrier.  Tiles are swizzled by the
// widest of 128/64/32 bytes that divides a D-row (D 96: 64 bytes, in
// three 32-column boxes).  Each warpgroup computes S by wgmma m64n64k16
// with Q and K from shared memory (K-major), masks and scales it, runs
// the online softmax on the accumulator fragments (a row's 64 columns lie
// in the 4 lanes of a quad: two shuffles per reduction), splits P into
// bf16 A fragments in registers (the accumulator layout is the A-operand
// layout) and takes O += P V by wgmma m64nDk16 with V read from its
// natural (key, d) rows through the transpose bit.  Causal blocks stop at
// the diagonal tile and the heaviest Q tiles are scheduled first; OOB rows
// of a ragged last tile arrive as zeros from TMA and their columns are
// masked.  Every sum runs in a fixed order: no atomics, the same result
// run to run.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t o_b, o_h, o_s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// fp32: register-blocked CUDA-core tiles, K/V fed by cp.async
// ---------------------------------------------------------------------------

constexpr int kF32Q = 128;              // Q rows per block
constexpr int kF32K = 64;               // K/V rows per tile
constexpr int kF32Threads = 256;        // 16 row groups x 16 column groups
constexpr int kF32Rows = kF32Q / 16;    // rows a thread: rg + 16 u
constexpr int kF32Cols = kF32K / 16;    // S columns a thread: cg + 16 v
// P row stride: the two row groups of a warp write and read 16 banks
// apart.
constexpr int kLdP = kF32K + 16;

// Shared-memory geometry of the fp32 body at head dim D (sizes in
// floats).  Q and K rows are padded by 4 floats, so the rows a warp reads
// at one d start 4 banks apart and keep 16-byte alignment.
template <int D>
struct F32Geo {
  static constexpr int kLd = D + 4;      // Q and K row stride
  static constexpr int kTn = D / 16;     // O columns a thread
  static constexpr int kVw = kTn % 4 == 0 ? 4 : kTn % 2 == 0 ? 2 : 1;
  static constexpr int kQ = kF32Q * kLd;
  static constexpr int kK = kF32K * kLd;  // one of two stages
  static constexpr int kV = kF32K * D;
  static constexpr int kP = kF32Q * kLdP;
  static constexpr size_t kBytes = sizeof(float) * (kQ + 2 * kK + kV + kP);
};

// cp.async of kBytes (16: .cg, 4: .ca) from src to shared dst; `valid`
// false writes zeros and reads nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest cp.async groups are in
// flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts copying rows r0 .. r0 + kRowsT - 1 of a head's (S, D) view (row
// stride ld_g elements) into shared rows of stride ld_s; rows at or past S
// arrive as zeros.  kVec: 16-byte copies (aligned views), else 4-byte.
template <int D, int kRowsT, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int ld_s,
                                          const float* __restrict__ src,
                                          int64_t ld_g, int r0, int S) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kPerRow = D / kW;
#pragma unroll 4
  for (int e = threadIdx.x; e < kRowsT * kPerRow; e += kF32Threads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kW;
    const bool ok = r0 + r < S;
    cp_async<4 * kW>(dst + r * ld_s + c,
                     ok ? src + (r0 + r) * ld_g + c : src, ok);
  }
}

// How far the S and P V loops are unrolled (4-wide steps): measured
// best of 1-32 and 1-16 on the card (PERF.md, section 6).
constexpr int kUnrollS = 8;
constexpr int kUnrollPV = 4;

// One K/V tile of the fp32 body, from K tile t landed to O updated: S,
// the masked online softmax, P to shared memory, then O += P V once V
// tile t has landed.  kUpper: the tile lies wholly above the diagonal for
// the Q tile's first 64 rows (u < kF32Rows / 2), so those rows are left
// as they are (each would add p = 0 at alpha = 1: exactly nothing).
template <int D, bool kUpper>
__device__ __forceinline__ void f32_tile(
    const float* qs, const float* kt, const float* vs, float* ps, int rg,
    int cg, int q0, int k0, int S, int causal, float (&m)[kF32Rows],
    float (&l)[kF32Rows], float (&o)[kF32Rows][F32Geo<D>::kTn]) {
  using G = F32Geo<D>;
  constexpr int u0 = kUpper ? kF32Rows / 2 : 0;

  // S = Q K^T: one FMA chain over d in ascending order per element,
  // operands read as float4 along d.
  float s[kF32Rows][kF32Cols];
#pragma unroll
  for (int u = u0; u < kF32Rows; ++u)
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) s[u][c] = 0.f;
#pragma unroll (kUnrollS)
  for (int d = 0; d < D; d += 4) {
    float4 kk[kF32Cols];
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) {
      kk[c] = *reinterpret_cast<const float4*>(kt + (cg + 16 * c) * G::kLd
                                               + d);
    }
#pragma unroll
    for (int u = u0; u < kF32Rows; ++u) {
      const float4 qq = *reinterpret_cast<const float4*>(
          qs + (rg + 16 * u) * G::kLd + d);
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c) {
        s[u][c] = fmaf(qq.x, kk[c].x, s[u][c]);
        s[u][c] = fmaf(qq.y, kk[c].y, s[u][c]);
        s[u][c] = fmaf(qq.z, kk[c].z, s[u][c]);
        s[u][c] = fmaf(qq.w, kk[c].w, s[u][c]);
      }
    }
  }

  // Mask, the online softmax of each row (its 64 columns lie in the 16
  // lanes of a half-warp), and P into shared memory.
#pragma unroll
  for (int u = u0; u < kF32Rows; ++u) {
    const int r = q0 + rg + 16 * u;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) {
      const int col = k0 + cg + 16 * c;
      if (col >= S || (causal && col > r)) s[u][c] = kNegInf;
      mx = fmaxf(mx, s[u][c]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
    const float m_new = fmaxf(m[u], mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) {
      const float p = expf(s[u][c] - m_new);
      ps[(rg + 16 * u) * kLdP + cg + 16 * c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFullMask, sum, off);
    const float alpha = expf(m[u] - m_new);
    l[u] = alpha * l[u] + sum;
    m[u] = m_new;
#pragma unroll
    for (int c = 0; c < G::kTn; ++c) o[u][c] *= alpha;
  }
  cp_async_wait<1>();        // V tile t has landed
  __syncthreads();           // ... and every row's P is in place

  // O += P V: for each key in ascending order one FMA per element; P read
  // as float4 along the keys, V as kVw-wide vectors along d.
#pragma unroll (kUnrollPV)
  for (int j = 0; j < kF32K; j += 4) {
    float4 pp[kF32Rows];
#pragma unroll
    for (int u = u0; u < kF32Rows; ++u) {
      pp[u] = *reinterpret_cast<const float4*>(ps + (rg + 16 * u) * kLdP
                                               + j);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* vr = vs + (j + jj) * D + G::kVw * cg;
      float vv[G::kTn];
#pragma unroll
      for (int w = 0; w < G::kTn / G::kVw; ++w) {
        if constexpr (G::kVw == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vr + 64 * w);
          vv[4 * w] = x.x; vv[4 * w + 1] = x.y;
          vv[4 * w + 2] = x.z; vv[4 * w + 3] = x.w;
        } else if constexpr (G::kVw == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vr + 32 * w);
          vv[2 * w] = x.x; vv[2 * w + 1] = x.y;
        } else {
          vv[w] = vr[16 * w];
        }
      }
#pragma unroll
      for (int u = u0; u < kF32Rows; ++u) {
        const float p = jj == 0 ? pp[u].x : jj == 1 ? pp[u].y
                        : jj == 2 ? pp[u].z : pp[u].w;
#pragma unroll
        for (int c = 0; c < G::kTn; ++c) o[u][c] = fmaf(p, vv[c], o[u][c]);
      }
    }
  }
}

// Block (blockIdx.x, blockIdx.y): batch * head bh, and the 128-row Q tile
// counted from the last one (the heaviest under causal masking first).
// Thread (rg, cg) = (tid / 16, tid % 16) owns rows rg + 16 u (u < 8) of
// the tile; of S its columns cg + 16 v (v < 4) and of O its columns
// kVw cg + 16 kVw w + x (x < kVw, w < kTn / kVw).
template <int D, bool kVec>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int H, int KV, int S, Strides st, int causal,
                    float sm_scale) {
  using G = F32Geo<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kF32Q][kLd], scaled by sm_scale
  float* ks = qs + G::kQ;            // two stages of [kF32K][kLd]
  float* vs = ks + 2 * G::kK;        // [kF32K][D]
  float* ps = vs + G::kV;            // [kF32Q][kLdP]

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Q;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + kvh * st.k_h;
  const float* vb = v + b * st.v_b + kvh * st.v_h;
  const int k_end = causal ? min(S, q0 + kF32Q) : S;
  const int n_tiles = (k_end + kF32K - 1) / kF32K;

  // Group 0: the Q tile and K tile 0.
  load_tile<D, kF32Q, kVec>(qs, G::kLd, qb, st.q_s, q0, S);
  load_tile<D, kF32K, kVec>(ks, G::kLd, kb, st.k_s, 0, S);
  cp_async_commit();

  float m[kF32Rows], l[kF32Rows], o[kF32Rows][G::kTn];
#pragma unroll
  for (int u = 0; u < kF32Rows; ++u) {
    m[u] = kNegInf;
    l[u] = 0.f;
#pragma unroll
    for (int c = 0; c < G::kTn; ++c) o[u][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kF32K;
    // P V of tile t - 1 is done: V, P and K stage (t + 1) & 1 are free.
    __syncthreads();
    // Two more groups: V tile t, then K tile t + 1 (empty past the last).
    load_tile<D, kF32K, kVec>(vs, D, vb, st.v_s, k0, S);
    cp_async_commit();
    if (t + 1 < n_tiles) {
      load_tile<D, kF32K, kVec>(ks + ((t + 1) & 1) * G::kK, G::kLd, kb,
                                st.k_s, k0 + kF32K, S);
    }
    cp_async_commit();
    cp_async_wait<2>();        // K tile t (and the Q tile) have landed
    __syncthreads();
    if (t == 0) {
      // Q is scaled by sm_scale first, as in the reference.
      for (int e = tid; e < kF32Q * D; e += kF32Threads) {
        const int r = e / D;
        qs[r * G::kLd + e - r * D] *= sm_scale;
      }
      __syncthreads();
    }
    const float* kt = ks + (t & 1) * G::kK;
    if (causal && k0 >= q0 + kF32Q / 2) {
      f32_tile<D, true>(qs, kt, vs, ps, rg, cg, q0, k0, S, causal, m, l, o);
    } else {
      f32_tile<D, false>(qs, kt, vs, ps, rg, cg, q0, k0, S, causal, m, l,
                         o);
    }
  }

  float* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int u = 0; u < kF32Rows; ++u) {
    const int r = q0 + rg + 16 * u;
    if (r >= S) continue;
    const float denom = fmaxf(l[u], 1e-30f);
    float* orow = ob + r * st.o_s + G::kVw * cg;
#pragma unroll
    for (int w = 0; w < G::kTn / G::kVw; ++w) {
      const float* x = o[u] + G::kVw * w;
      float* dst = orow + 16 * G::kVw * w;
      if constexpr (G::kVw == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            x[0] / denom, x[1] / denom, x[2] / denom, x[3] / denom);
      } else if constexpr (G::kVw == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(x[0] / denom,
                                                      x[1] / denom);
      } else {
        dst[0] = x[0] / denom;
      }
    }
  }
}

// Whether a (B, heads, S, D) fp32 view can be copied 16 bytes at a time:
// a 16-byte aligned base and strides of whole vectors (over dims of
// extent above 1).
inline bool vec16(const void* p, int B, int heads, int S, int64_t sb,
                  int64_t sh, int64_t ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || sb % 4 == 0)
         && (heads == 1 || sh % 4 == 0) && (S == 1 || ss % 4 == 0);
}

template <int D, bool kVec>
cudaError_t run_fp32(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int KV, int S, const Strides& st,
                     int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = F32Geo<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32<D, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kF32Q - 1) / kF32Q);
  flash_attention_f32<D, kVec><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KV, S, st,
      causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int KV, int S,
                        const Strides& st, int causal, float sm_scale,
                        cudaStream_t stream) {
  const bool vec = vec16(q, B, H, S, st.q_b, st.q_h, st.q_s)
                   && vec16(k, B, KV, S, st.k_b, st.k_h, st.k_s)
                   && vec16(v, B, KV, S, st.v_b, st.v_h, st.v_s);
  return vec ? run_fp32<D, true>(q, k, v, out, B, H, KV, S, st, causal,
                                 sm_scale, stream)
             : run_fp32<D, false>(q, k, v, out, B, H, KV, S, st, causal,
                                  sm_scale, stream);
}

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA on TMA-fed tiles
// ---------------------------------------------------------------------------

constexpr int kTile = 64;        // Q rows per warpgroup, K/V rows per tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kWgThreads = 128;  // threads of one warpgroup

// Shared-memory geometry of one 64-row bf16 tile of head dim D: rows of
// kSwz bytes (the swizzle span), kBoxes boxes of kBoxCols columns side by
// side, box after box.
template <int D>
struct Geo {
  static constexpr int kSwz = (2 * D) % 128 == 0 ? 128
                              : (2 * D) % 64 == 0 ? 64 : 32;
  static constexpr int kBoxCols = kSwz / 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kBoxBytes = kTile * kSwz;
  static constexpr int kTileBytes = kTile * 2 * D;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  // swizzle.
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kSwz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A wait that outlasts ~10 s of clock (a copy that never lands) traps, so a
// fault surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

// One box of a 4-D tensor map (d, row, head, batch) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(head), "r"(batch), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | layout << 62;
}

// Descriptor of the 16-column slice kk of a tile read K-major (Q as A, K as
// B of S = Q K^T): the slice lies in box 16 kk / kBoxCols at a byte offset
// inside the swizzled row; 8-row groups are 8 rows of kSwz bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  using G = Geo<D>;
  const uint32_t addr = tile + (16 * kk / G::kBoxCols) * G::kBoxBytes
                        + (16 * kk % G::kBoxCols) * 2;
  return make_desc(addr, 16, 8 * G::kSwz, G::kLayout);
}

// Descriptor of the 16-key slice kk of a V tile read MN-major (B of O +=
// P V, N = D along the row): 8-key groups 8 rows apart (stride byte
// offset), column boxes kBoxBytes apart (leading byte offset).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  using G = Geo<D>;
  return make_desc(tile + kk * 16 * G::kSwz, G::kBoxBytes, 8 * G::kSwz,
                   G::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of wgmma's registers across the
// fence, commit and wait of an asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// S (+)= Q K^T over one 16-wide slice of D: m64n64k16, Q and K from
// shared memory (K-major), fp32 accumulators d; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_q,
                                         uint64_t desc_k, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_q), "l"(desc_k), "r"(scale_d));
}

// O += P V over one 16-key slice: m64nDk16, P from registers (bf16 A
// fragments), V from shared memory in its natural (key, d) rows, read
// through wgmma's transpose bit.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v);

template <>
__device__ __forceinline__ void wgmma_pv<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Dynamic shared memory of flash_attention_wgmma<D> with `nwg` consumer
// warpgroups: 1024 bytes of alignment slack, the Q tiles, the K and V
// rings, then the barriers.
template <int D>
constexpr size_t wgmma_smem(int nwg) {
  return 1024 + static_cast<size_t>(nwg + 2 * kStages) * Geo<D>::kTileBytes
         + (2 * kStages + 1) * sizeof(uint64_t);
}

// Block (blockIdx.x, blockIdx.y): batch b, KV head kvh, query heads
// kvh * rep + grp * nwg + g for warpgroup g < nwg, and the 64-row Q tile
// counted from the last one (the heaviest under causal masking first).
// Threads: nwg consumer warpgroups, then one producer warp.
template <int D>
__global__ void __launch_bounds__(2 * kWgThreads + 32, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out, int KV, int rep,
                      int nwg, int S, int64_t o_b, int64_t o_h, int64_t o_s,
                      int causal, float sm_scale) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* q_tiles = base;
  uint8_t* k_ring = q_tiles + nwg * G::kTileBytes;
  uint8_t* v_ring = k_ring + kStages * G::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_ring
                                               + kStages * G::kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int groups = rep / nwg;
  const int b = blockIdx.x / (KV * groups);
  const int kvh = blockIdx.x / groups % KV;
  const int h0 = kvh * rep + blockIdx.x % groups * nwg;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int k_end = causal ? min(S, q0 + kTile) : S;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], nwg * kWgThreads);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * nwg) {
    // Producer: the Q tiles once, then the K/V ring.
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_bar, nwg * G::kTileBytes);
      for (int g = 0; g < nwg; ++g) {
        for (int x = 0; x < G::kBoxes; ++x) {
          tma_load(q_tiles + g * G::kTileBytes + x * G::kBoxBytes, &tm_q,
                   q_bar, x * G::kBoxCols, q0, h0 + g, b);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[st], 2 * G::kTileBytes);
        for (int x = 0; x < G::kBoxes; ++x) {
          const int off = st * G::kTileBytes + x * G::kBoxBytes;
          tma_load(k_ring + off, &tm_k, &full[st], x * G::kBoxCols,
                   t * kTile, kvh, b);
          tma_load(v_ring + off, &tm_v, &full[st], x * G::kBoxCols,
                   t * kTile, kvh, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup g: rows r0 and r0 + 8 of its Q tile in this thread;
  // accumulator element 4 j + e sits at row r0 + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2.
  const int g = warp / 4;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * (warp % 4) + lane / 4;
  const int r1 = r0 + 8;
  const int c_lane = 2 * (lane % 4);
  const uint32_t q_tile = smem_u32(q_tiles + g * G::kTileBytes);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kTile;
    mbar_wait(&full[st], (t / kStages) & 1);
    const uint32_t k_tile = smem_u32(k_ring + st * G::kTileBytes);
    const uint32_t v_tile = smem_u32(v_ring + st * G::kTileBytes);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_qk(s, desc_k_major<D>(q_tile, kk), desc_k_major<D>(k_tile, kk),
               kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scale, mask, and the online softmax of rows r0 (e < 2) and r1.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * j + c_lane + (e & 1);
        const int r = e < 2 ? r0 : r1;
        float x = s[4 * j + e] * sm_scale;
        if (c >= S || (causal && c > r)) x = kNegInf;
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * j + e] - (e < 2 ? mx0 : mx1));
        s[4 * j + e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float alpha0 = expf(m0 - mx0);
    const float alpha1 = expf(m1 - mx1);
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // P_hi and P_lo as A fragments: for the 16-key slice kk, register i
    // holds the pair at accumulator elements 8 kk + 2 i, 8 kk + 2 i + 1.
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = s[8 * kk + 2 * i];
        const float x1 = s[8 * kk + 2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        p_hi[kk][i] = bf16x2_bits(hi);
        p_lo[kk][i] = bf16x2_bits(__floats2bfloat162_rn(
            x0 - __low2float(hi), x1 - __high2float(hi)));
      }
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<D>(o, p_hi[kk], desc_mn_major<D>(v_tile, kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<D>(o, p_lo[kk], desc_mn_major<D>(v_tile, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[st]);
  }

  const int h = h0 + g;
  __nv_bfloat16* ob = out + b * o_b + h * o_h;
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + c_lane;
    if (r0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_s + c) =
          __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
    }
    if (r1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_s + c) =
          __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// CUDA's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda
// at link time); null where it is unavailable.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Tensor map of a (B, heads, S, D) bf16 view with element strides
// (st_b, st_h, st_s) and a unit stride over D, in boxes of
// (box_cols, 64 rows); out-of-range rows read as zeros.  A dim of extent 1
// takes a stride TMA accepts (it is never stepped).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int heads,
                     int S, int D, int64_t st_b, int64_t st_h, int64_t st_s,
                     int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int64_t row = 2 * static_cast<int64_t>(D);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(S > 1 ? 2 * st_s : row),
      static_cast<cuuint64_t>(heads > 1 ? 2 * st_h : row),
      static_cast<cuuint64_t>(B > 1 ? 2 * st_b : row)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(kTile), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int KV, int S,
                         const Strides& st, int causal, float sm_scale,
                         cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, B, H, S, D, st.q_b, st.q_h, st.q_s,
                             G::kBoxCols, G::kTmaSwizzle);
  if (err == cudaSuccess) {
    err = make_map(&tm_k, k, B, KV, S, D, st.k_b, st.k_h, st.k_s,
                   G::kBoxCols, G::kTmaSwizzle);
  }
  if (err == cudaSuccess) {
    err = make_map(&tm_v, v, B, KV, S, D, st.v_b, st.v_h, st.v_s,
                   G::kBoxCols, G::kTmaSwizzle);
  }
  if (err != cudaSuccess) return err;
  const int rep = H / KV;
  const int nwg = rep % 2 == 0 ? 2 : 1;
  const size_t smem = wgmma_smem<D>(nwg);
  err = cudaFuncSetAttribute(flash_attention_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wgmma_smem<D>(2)));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV * (rep / nwg), (S + kTile - 1) / kTile);
  flash_attention_wgmma<D><<<grid, nwg * kWgThreads + 32, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), KV, rep, nwg, S,
      st.o_b, st.o_h, st.o_s, causal, sm_scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     void* out, int dtype, int B, int H, int KV, int S,
                     int D, const Strides& st, int causal, float sm_scale,
                     cudaStream_t s) {
#define FA_CASE(DIM)                                                        \
  case DIM:                                                                 \
    return dtype == kFloat32                                                \
               ? launch_fp32<DIM>(q, k, v, out, B, H, KV, S, st, causal,   \
                                  sm_scale, s)                             \
               : launch_wgmma<DIM>(q, k, v, out, B, H, KV, S, st, causal,  \
                                   sm_scale, s);
  switch (D) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(96)
    FA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// q, out: (B, H, S, D) and k, v: (B, KV, S, D), each with its own strides
// (in elements) over the first three dims and a unit stride over D.  bf16
// tensors need 16-byte aligned bases and strides (TMA's rule), which the
// wrapper checks.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int KV, int S, int D, long long q_b, long long q_h, long long q_s,
    long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h,
    long long o_s, int causal, float sm_scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != kFloat32 && dtype != kBFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
                   o_b, o_h, o_s};
  return static_cast<int>(dispatch(q, k, v, out, dtype, B, H, KV, S, D, st,
                                   causal, sm_scale,
                                   static_cast<cudaStream_t>(stream)));
}
