// A whole LoFTR encoder layer, f32, for sm_90a.
//
// Replaces the TPU kernel cfpnet_tpu/ops/pallas_loftr.py::_fused_loftr_impl
// (kernel `_kernel`, public `fused_loftr`). Computes, for x [N, L, C] and
// source [N, S, C], with the weights of the port's nn.Linear modules as they
// are stored ([out, in], row-major):
//   q = x Wq^T, k = src Wk^T, v = src Wv^T; per group n and head h, with
//   Kf = elu(k)+1, Qf = elu(q)+1:
//     KV = sum_s Kf^T (v / S),  ksum = sum_s Kf,
//     msg = (Qf KV) * (1 / (Qf . ksum + eps)) * S
//   m = LN1(msg Wm^T)
//   h = relu([x, m] W0^T)          (W0's x half and message half are its
//                                   column ranges [0, C) and [C, 2C))
//   out = LN2(h W1^T) + x
// which is cfpnet_torch/ops/loftr.py::loftr_apply term for term: elu+1 as
// x > 0 ? x + 1 : exp(x), the /S guard, eps 1e-6 in the denominator, and
// both LayerNorms with flax's fast variance max(0, E[x^2] - E[x]^2) and
// eps 1e-5.
//
// Bound on the H100: the operations. A row costs 8 C^2 multiply-adds in the
// projections and the MLP against 8 C bytes of input and output, so every
// call of the production forward is far above the card's ~20 flop/byte
// ridge for f32 outside the tensor cores; the largest, LSA at 1/8 scale
// (5103 rows, C = 64), does 0.43 GFLOP, ~6.4 us at 67 TFLOP/s.
//
// Design.
// - Two launches per call. Pass 1 (summary) computes each group's K and V
//   projections, KV and ksum, one block per (group, head): a head needs only
//   D rows of Wk and Wv, so no block reduces across blocks and no group's
//   summary is computed twice. Where a head has fewer sums than threads
//   (D = 4, 8), several threads share a sum over interleaved source rows. Pass 2 (rows) tiles the N*L rows of x,
//   TL = 2048 / C rows a block (16, 32, 64 at C = 128, 64, 32), across group
//   boundaries, and reads each row's KV from pass 1 (L2-resident). The TPU
//   kernel instead recomputes the summary in every L-tile; here that would
//   cost up to half the row work again at GSA's N = 1.
// - Blocks per call on the production forward: pass 2 has 64-79 at 1/16
//   (1024-1260 rows), 98-160 at 1/8, 196-315 at 1/4; pass 1 has N*H.
// - The TPU kernel keeps every weight in VMEM; at C = 128 the ten weights
//   are 642 KB, against 227 KB of shared memory a block. So each product
//   streams its weight through two 32-column K-slabs in shared memory by
//   cp.async (slab s+1 in flight while slab s is used). Activations stay in
//   shared memory for the whole layer: x and the message side by side as the
//   MLP's concat input [TL][2C], elu(q)+1 and the attention output [TL][C]
//   each, and the MLP hidden [TL][2C] over those two once they are spent;
//   32 KB a block, plus 18-74 KB of slabs.
// - Each warp owns TL/8 rows and each lane 1-8 output columns strided by
//   32, so a float4 of a weight slab serves TL/8 rows and a broadcast float4
//   of activations serves up to 8 columns.
// - No G-group packing and no [C,C] block-diagonal head mask (H times the
//   MACs): those fed the TPU's MXU. Attention works per head on [D,D].
// - LayerNorms: a warp per row, sums by shuffles.
// No tensor cores: f32 throughout, TF32 would leave the tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileElems = 2048;   // TL * C of pass 2
constexpr int kKS = 32;            // weight columns (K) per slab
constexpr int kWStride = kKS + 4;  // slab row stride: 16-byte rows, conflict-free float4 reads
constexpr int kTS = 64;            // source rows staged per step of pass 1
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Pass 1. grid (N * H). kv: [N, H, D*D + D] (KV row-major, then ksum).
// wk, wv: [C, C] as [out, in]; head h owns their rows h*D .. h*D + D - 1.
// Where a head's P = D*D + D sums are fewer than the block's threads, R
// threads share each sum, each over every R-th source row, and the R
// partials are added in a fixed order at the end (no atomics).
template <int C, int D>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const float* __restrict__ src, const float* __restrict__ wk,
               const float* __restrict__ wv, float* __restrict__ kv, int S) {
  constexpr int H = C / D;
  constexpr int P = D * D + D;
  constexpr int R = P < kThreads ? kThreads / P : 1;  // row slices per sum
  constexpr int NP = (P + kThreads - 1) / kThreads;   // sums per thread
  constexpr int WS = C + 1;  // padded: neighbouring threads read neighbouring weight rows
  extern __shared__ float smem[];
  float* s_wk = smem;            // [D][WS]
  float* s_wv = s_wk + D * WS;   // [D][WS]
  float* s_src = s_wv + D * WS;  // [kTS][C]
  float* s_k = s_src + kTS * C;  // [kTS][D], elu'd
  float* s_v = s_k + kTS * D;    // [kTS][D], divided by S
  float* s_red = s_v + kTS * D;  // [R][P], the partials when R > 1

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  for (int i = threadIdx.x; i < D * C; i += kThreads) {
    const int d = i / C, c = i % C;
    const size_t off = static_cast<size_t>(h * D + d) * C + c;
    s_wk[d * WS + c] = wk[off];
    s_wv[d * WS + c] = wv[off];
  }
  const float s_len = static_cast<float>(S);
  const float* sn = src + static_cast<size_t>(n) * S * C;
  const int slice = threadIdx.x / P;  // < R for the threads that sum when R > 1

  float acc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) acc[j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kTS) {
    const int rows = min(kTS, S - s0);
    __syncthreads();  // the weights are staged; the last step's readers are done
    for (int i = threadIdx.x; i < rows * C; i += kThreads)
      s_src[i] = sn[static_cast<size_t>(s0) * C + i];
    __syncthreads();
    for (int i = threadIdx.x; i < rows * 2 * D; i += kThreads) {
      const int r = i / (2 * D), j = i % (2 * D);
      const bool is_v = j >= D;
      const int d = is_v ? j - D : j;
      const float* w = (is_v ? s_wv : s_wk) + d * WS;
      const float* a = s_src + r * C;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < C; ++c) s = fmaf(a[c], w[c], s);
      if (is_v)
        s_v[r * D + d] = s / s_len;
      else
        s_k[r * D + d] = elu1(s);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int p = R > 1 ? threadIdx.x % P : threadIdx.x + j * kThreads;
      const int r0 = R > 1 ? slice : 0;
      if (r0 >= R || p >= P) continue;
      float s = acc[j];
      if (p < D * D) {
        const int a = p / D, b = p % D;
        for (int r = r0; r < rows; r += R) s = fmaf(s_k[r * D + a], s_v[r * D + b], s);
      } else {
        const int a = p - D * D;
        for (int r = r0; r < rows; r += R) s += s_k[r * D + a];
      }
      acc[j] = s;
    }
  }

  float* out = kv + static_cast<size_t>(blockIdx.x) * P;
  if constexpr (R > 1) {
    if (slice < R) s_red[slice * P + threadIdx.x % P] = acc[0];
    __syncthreads();
    if (threadIdx.x < P) {
      float s = 0.f;
      for (int j = 0; j < R; ++j) s += s_red[j * P + threadIdx.x];
      out[threadIdx.x] = s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int p = threadIdx.x + j * kThreads;
      if (p < P) out[p] = acc[j];
    }
  }
}

// acc[i][j] = sum_k A[warp + 8 i][k] * W[lane + 32 j][k], k < K, for a tile of
// TL rows. A: shared, row stride lda. W: global, row o at W + o * ldw (a
// column range of a wider matrix is taken by offsetting W). The weight comes
// through two K-slabs of shared memory at s_w (2 * O * kWStride floats). The
// first __syncthreads comes before A is read, so the caller's writes to A
// need no barrier of their own; the last one comes after the last read.
template <int TL, int K, int O>
__device__ __forceinline__ void gemm(const float* A, int lda, const float* __restrict__ W,
                                     int ldw, float* s_w, float (&acc)[TL / kWarps][O / 32]) {
  constexpr int RM = TL / kWarps;
  constexpr int RN = O / 32;
  constexpr int NS = K / kKS;
  constexpr int kSlab = O * kWStride;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  auto load = [&](int s) {
    float* dst = s_w + (s & 1) * kSlab;
    for (int i = threadIdx.x; i < O * (kKS / 4); i += kThreads) {
      const int o = i / (kKS / 4), q = i % (kKS / 4);
      cp_async16(dst + o * kWStride + q * 4, W + static_cast<size_t>(o) * ldw + s * kKS + q * 4);
    }
    cp_async_commit();
  };

  load(0);
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    if (s + 1 < NS)
      load(s + 1);
    else
      cp_async_commit();  // an empty group, so that wait_group 1 means slab s is in
    cp_async_wait1();
    __syncthreads();
    const float* sw = s_w + (s & 1) * kSlab;
    const float* as = A + s * kKS;
#pragma unroll
    for (int k4 = 0; k4 < kKS; k4 += 4) {
      float4 w[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j)
        w[j] = *reinterpret_cast<const float4*>(sw + (lane + 32 * j) * kWStride + k4);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(as + (warp + kWarps * i) * lda + k4);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          float t = acc[i][j];
          t = fmaf(a.x, w[j].x, t);
          t = fmaf(a.y, w[j].y, t);
          t = fmaf(a.z, w[j].z, t);
          t = fmaf(a.w, w[j].w, t);
          acc[i][j] = t;
        }
      }
    }
    __syncthreads();
  }
}

// Mean and 1/sqrt(var + eps) of a row of C floats, by one warp, with flax's
// fast variance.
template <int C>
__device__ __forceinline__ void row_stats(const float* v, float& mean, float& rstd) {
  const int lane = threadIdx.x % 32;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = lane; c < C; c += 32) {
    const float t = v[c];
    s += t;
    s2 = fmaf(t, t, s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  mean = s / C;
  const float var = fmaxf(0.f, s2 / C - mean * mean);
  rstd = rsqrtf(var + kLnEps);
}

// Pass 2. grid (ceil(N*L / TL)). x, out: [N*L, C]; kv from pass 1. Weights
// as [out, in]: wq, wm [C, C]; w0 [2C, 2C]; w1 [C, 2C]; g*, b* [C].
template <int C, int D>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ x, const float* __restrict__ kv,
            const float* __restrict__ wq, const float* __restrict__ wm,
            const float* __restrict__ g1, const float* __restrict__ b1,
            const float* __restrict__ w0, const float* __restrict__ w1,
            const float* __restrict__ g2, const float* __restrict__ b2,
            float* __restrict__ out, int NL, int L, int S, float eps) {
  constexpr int H = C / D;
  constexpr int P = D * D + D;
  constexpr int TL = kTileElems / C;
  constexpr int RM = TL / kWarps;
  extern __shared__ float4 smem4[];
  float* s_xm = reinterpret_cast<float*>(smem4);  // [TL][2C]: x | message
  float* s_q = s_xm + TL * 2 * C;                  // [TL][C]: elu(q)+1
  float* s_a = s_q + TL * C;                       // [TL][C]: attention output
  float* s_h = s_q;                                // [TL][2C]: MLP hidden, once s_q, s_a are spent
  float* s_den = s_a + TL * C;                     // [TL][H]
  float* s_w = s_den + TL * H;                     // two weight slabs

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * TL;
  const int rows = min(TL, NL - row0);
  const int last_group = (NL - 1) / L;

  // the x tile; rows past the end are zero (computed, never written)
  for (int i = threadIdx.x; i < TL * (C / 4); i += kThreads) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = reinterpret_cast<const float4*>(x + static_cast<size_t>(row0 + r) * C)[c4];
    reinterpret_cast<float4*>(s_xm + r * 2 * C)[c4] = v;
  }

  float acc[RM][C / 32];
  gemm<TL, C, C>(s_xm, 2 * C, wq, C, s_w, acc);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j) s_q[(warp + kWarps * i) * C + lane + 32 * j] = elu1(acc[i][j]);
  __syncthreads();

  // attention against the row's group summary
  for (int i = threadIdx.x; i < TL * H; i += kThreads) {
    const int r = i / H, hh = i % H;
    const int g = min((row0 + r) / L, last_group);
    const float* ksum = kv + (static_cast<size_t>(g) * H + hh) * P + D * D;
    const float* qr = s_q + r * C + hh * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], __ldg(ksum + d), s);
    s_den[i] = s + eps;
  }
  __syncthreads();
  const float s_len = static_cast<float>(S);
  for (int i = threadIdx.x; i < TL * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const int hh = c / D, e = c % D;
    const int g = min((row0 + r) / L, last_group);
    const float* kvh = kv + (static_cast<size_t>(g) * H + hh) * P;
    const float* qr = s_q + r * C + hh * D;
    float num = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) num = fmaf(qr[d], __ldg(kvh + d * D + e), num);
    s_a[i] = num * (1.f / s_den[r * H + hh]) * s_len;
  }

  // merge, then LN1 in place: the message half of the concat input
  gemm<TL, C, C>(s_a, C, wm, C, s_w, acc);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
      s_xm[(warp + kWarps * i) * 2 * C + C + lane + 32 * j] = acc[i][j];
  __syncthreads();
  for (int r = warp; r < TL; r += kWarps) {
    float* v = s_xm + r * 2 * C + C;
    float mean, rstd;
    row_stats<C>(v, mean, rstd);
#pragma unroll
    for (int c = lane; c < C; c += 32) v[c] = (v[c] - mean) * (rstd * g1[c]) + b1[c];
  }

  // MLP: relu([x, m] W0^T) W1^T
  {
    float hacc[RM][2 * C / 32];
    gemm<TL, 2 * C, 2 * C>(s_xm, 2 * C, w0, 2 * C, s_w, hacc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 2 * C / 32; ++j)
        s_h[(warp + kWarps * i) * 2 * C + lane + 32 * j] = fmaxf(hacc[i][j], 0.f);
  }
  gemm<TL, 2 * C, C>(s_h, 2 * C, w1, 2 * C, s_w, acc);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
      s_xm[(warp + kWarps * i) * 2 * C + C + lane + 32 * j] = acc[i][j];
  __syncthreads();

  // LN2 and the residual
  for (int r = warp; r < rows; r += kWarps) {
    const float* v = s_xm + r * 2 * C + C;
    float mean, rstd;
    row_stats<C>(v, mean, rstd);
    float* o = out + static_cast<size_t>(row0 + r) * C;
#pragma unroll
    for (int c = lane; c < C; c += 32)
      o[c] = (v[c] - mean) * (rstd * g2[c]) + b2[c] + s_xm[r * 2 * C + c];
  }
}

template <int C, int D>
int launch(const float* x, const float* src, const float* wq, const float* wk, const float* wv,
           const float* wm, const float* g1, const float* b1, const float* w0, const float* w1,
           const float* g2, const float* b2, float* out, float* kv, int N, int L, int S, float eps,
           cudaStream_t stream) {
  constexpr int H = C / D;
  constexpr int TL = kTileElems / C;
  constexpr size_t smem1 =
      sizeof(float) * (2 * D * (C + 1) + kTS * C + 2 * kTS * D + kThreads);
  constexpr size_t smem2 = sizeof(float) * (TL * 4 * C + TL * H + 2 * 2 * C * kWStride);
  cudaError_t err = cudaFuncSetAttribute(summary_kernel<C, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(rows_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  summary_kernel<C, D><<<N * H, kThreads, smem1, stream>>>(src, wk, wv, kv, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NL = N * L;
  rows_kernel<C, D><<<(NL + TL - 1) / TL, kThreads, smem2, stream>>>(
      x, kv, wq, wm, g1, b1, w0, w1, g2, b2, out, NL, L, S, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [N, L, C]; src: [N, S, C]; wq, wk, wv, wm: [C, C]; w0: [2C, 2C];
// w1: [C, 2C] (weights as [out, in], row-major); g1, b1, g2, b2: [C]; all
// f32, contiguous, 16-byte aligned. kv: N*(C/D)*(D*D + D) floats of scratch.
// Built for C = 32, 64, 128 with 4 or 8 heads. Returns the cudaError_t of
// the launches (0 = success).
extern "C" int cfp_fused_loftr_f32(const float* x, const float* src, const float* wq,
                                   const float* wk, const float* wv, const float* wm,
                                   const float* g1, const float* b1, const float* w0,
                                   const float* w1, const float* g2, const float* b2, float* out,
                                   float* kv, int N, int L, int S, int C, int D, float eps,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CFP_LOFTR_CASE(CC, DD)                                                                 \
  if (C == CC && D == DD)                                                                      \
    return launch<CC, DD>(x, src, wq, wk, wv, wm, g1, b1, w0, w1, g2, b2, out, kv, N, L, S, eps, \
                          st);
  CFP_LOFTR_CASE(32, 8)
  CFP_LOFTR_CASE(32, 4)
  CFP_LOFTR_CASE(64, 16)
  CFP_LOFTR_CASE(64, 8)
  CFP_LOFTR_CASE(128, 32)
  CFP_LOFTR_CASE(128, 16)
#undef CFP_LOFTR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
