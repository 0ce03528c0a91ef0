// K6: blocked flash attention forward, out = softmax(scale * Q K^T) V,
// causal or not, with grouped-query heads.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body _attn_kernel): the prefill attention of the LM transformer.
//
// What it computes, as the TPU kernel does: Q is scaled by sm_scale in
// fp32; the running row max m, normaliser l and accumulator acc are fp32;
// causal masking writes -1e30; K/V tiles strictly above the diagonal are
// not visited; out = acc / max(l, 1e-30), cast to the input type.  The
// inputs are fp32 or bf16.  Grouped-query attention reads K/V head
// h / (H / KV) directly, where the reference repeats K/V in ops.py first.
// The reference's seq % block guard was a TPU tiling limit: here the last
// Q and K tiles may be ragged, and key columns past the sequence are
// masked like causal ones.
//
// What bounds it on an H100: operations.  At the LM slice's shape (B 4,
// S 1024, H 16, KV 8, D 128, bf16, causal) the work is 17.2 GFLOP over
// 50 MB of inputs and output: 17 us at the bf16 tensor-core rate.  This
// first kernel uses no tensor cores: every product is an fp32 FMA on the
// CUDA cores (67 TFLOP/s at most, 257 us for that work), fed from shared
// memory.  wgmma with TMA-fed tiles is the later redesign.
//
// Design: one block of 256 threads per (batch * head, 64-row Q tile), the
// heaviest (last) causal tiles scheduled first.  The scaled Q tile, one
// 64-row K tile and one V tile are staged in shared memory as fp32 (K and
// Q rows padded to D + 1 floats, so a warp's column reads hit distinct
// banks).  Thread (tx, ty) of the 16 x 16 grid owns rows ty + 16 i
// (i < 4) of the tile: it computes S at columns tx + 16 j (j < 4), the
// row max and sum by shuffles across the 16 threads of the row, writes P
// to shared memory, and accumulates acc at head dims tx + 16 j
// (j < D / 16).  Every sum runs in a fixed order: no atomics, the same
// result run to run.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;           // Q rows per block
constexpr int kBK = 64;           // K/V rows per tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kRows = kBQ / 16;   // rows per thread
constexpr int kCols = kBK / 16;   // S columns per thread
constexpr int kLdP = kBK + 1;     // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t o_b, o_h, o_s;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kLdP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int KV, int S, Strides st, int causal,
                       float sm_scale) {
  constexpr int kLd = D + 1;
  constexpr int kDims = D / 16;   // head dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;        // [kBK][kLd]
  float* vs = ks + kBK * kLd;        // [kBK][D]
  float* ps = vs + kBK * D;          // [kBQ][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    float x = 0.f;
    if (q0 + r < S) x = to_float(qb[(q0 + r) * st.q_s + c]) * sm_scale;
    qs[r * kLd + c] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < S) {
        kx = to_float(kb[(k0 + r) * st.k_s + c]);
        vx = to_float(vb[(k0 + r) * st.v_s + c]);
      }
      ks[r * kLd + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qa[kRows], kc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= S || (causal && c > r)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDims; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDims; ++j)
      ob[r * st.o_s + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int S, const Strides& st,
                   int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, S, st, causal,
      sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     void* out, int B, int H, int KV, int S, int D,
                     const Strides& st, int causal, float sm_scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, H, KV, S, st, causal, sm_scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, KV, S, st, causal, sm_scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, KV, S, st, causal, sm_scale,
                           stream);
    case 96:
      return launch<T, 96>(q, k, v, out, B, H, KV, S, st, causal, sm_scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, KV, S, st, causal, sm_scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, H, S, D) and k, v: (B, KV, S, D), each with its own strides
// (in elements) over the first three dims and a unit stride over D.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int KV, int S, int D, long long q_b, long long q_h, long long q_s,
    long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h,
    long long o_s, int causal, float sm_scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
                   o_b, o_h, o_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kFloat32:
      err = dispatch<float>(q, k, v, out, B, H, KV, S, D, st, causal,
                            sm_scale, s);
      break;
    case kBFloat16:
      err = dispatch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, D, st, causal,
                                    sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
