// Multi-head elu+1 linear attention, f32, for sm_90a.
//
// Replaces the TPU kernel cfpnet_tpu/ops/pallas_attention.py::
// linear_attention_pallas (kernel `_kernel`), reached from
// cfpnet_tpu/ops/dispatch.py::attention when no mask is given.
//
// Computes, per batch row n and head h, with Kf = elu(K)+1, Qf = elu(Q)+1:
//   KV[h]   = sum_s Kf[s,h,:]^T (V[s,h,:] / S)          (D x D)
//   ksum[h] = sum_s Kf[s,h,:]                           (D)
//   out[l,h,:] = (Qf[l,h,:] . KV[h]) * (1 / (Qf[l,h,:] . ksum[h] + eps)) * S
// which is cfpnet_tpu/ops/attention.py::linear_attention term for term
// (the /S guard and the eps placement included).
//
// Bound on the H100: the bytes. Every input is read once and the output
// written once; the work is about 2*C*D*(S + L) flops over 8*C*(S + L)
// bytes, i.e. about D/4 <= 8 flops per byte, under the card's ~20 flops/byte
// ridge for f32 outside the tensor cores. The largest call of the
// production forward (LoFTRNewCross9 at 1/4 scale: L=19200, S=12544, C=32)
// moves about 8 MB, ~2.4 us at 3.35 TB/s, so at bs=1 launch overhead is
// what these calls cost.
//
// Design. The TPU kernel turns the per-head products into one [C,C]
// block-diagonal matmul for the MXU (H times the MACs). Here each head is
// worked on directly:
//   pass 1 (kv_partial) splits S into chunks over blocks, because the cross-
//           zone layers have only N*H = 4 (n,h) pairs but S = 12544 keys;
//           each block writes its partial KV and ksum;
//   pass 2 (kv_reduce) sums the partials in a fixed order, so results are
//           deterministic (no atomics);
//   pass 3 (apply) streams tiles of queries: the whole KV of row n (at most
//           C*D + C floats) and an elu'd query tile sit in shared memory, one
//           thread per output element.
// No tensor cores: at D <= 32 the products are too small to need them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileS = 64;        // keys staged per step of pass 1
constexpr int kTileElems = 2048;  // query tile of pass 3, in floats (TL * C)

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

// Pass 1. grid (N*H, nchunk). partial: [N*H, nchunk, D*D + D].
template <int D>
__global__ void __launch_bounds__(kThreads)
kv_partial_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ partial, int S, int H, int chunk, int nchunk) {
  constexpr int P = D * D + D;
  constexpr int NP = (P + kThreads - 1) / kThreads;
  __shared__ float ks[kTileS][D];
  __shared__ float vs[kTileS][D];

  const int nh = blockIdx.x;
  const int n = nh / H, h = nh % H;
  const int C = H * D;
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(S, s_begin + chunk);
  const float s_len = static_cast<float>(S);
  const float* kb = k + static_cast<size_t>(n) * S * C + h * D;
  const float* vb = v + static_cast<size_t>(n) * S * C + h * D;

  float acc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) acc[j] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += kTileS) {
    const int rows = min(kTileS, s_end - s0);
    for (int i = threadIdx.x; i < kTileS * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float kf = 0.f, vv = 0.f;
      if (r < rows) {
        const size_t off = static_cast<size_t>(s0 + r) * C + d;
        kf = elu1(kb[off]);
        vv = vb[off] / s_len;
      }
      ks[r][d] = kf;
      vs[r][d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int p = threadIdx.x + j * kThreads;
      if (p < D * D) {
        const int a = p / D, b = p % D;
        float s = acc[j];
        for (int r = 0; r < rows; ++r) s = fmaf(ks[r][a], vs[r][b], s);
        acc[j] = s;
      } else if (p < P) {
        const int a = p - D * D;
        float s = acc[j];
        for (int r = 0; r < rows; ++r) s += ks[r][a];
        acc[j] = s;
      }
    }
    __syncthreads();
  }

  float* out = partial + (static_cast<size_t>(nh) * nchunk + blockIdx.y) * P;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int p = threadIdx.x + j * kThreads;
    if (p < P) out[p] = acc[j];
  }
}

// Pass 2. grid (N*H). kv: [N*H, D*D + D].
__global__ void __launch_bounds__(kThreads)
kv_reduce_kernel(const float* __restrict__ partial, float* __restrict__ kv, int P, int nchunk) {
  const size_t nh = blockIdx.x;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    float s = 0.f;
    for (int c = 0; c < nchunk; ++c) s += partial[(nh * nchunk + c) * P + p];
    kv[nh * P + p] = s;
  }
}

// Pass 3. grid (ceil(L / tile_l), N). q, out: [N, L, H*D].
template <int D>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ q, const float* __restrict__ kv, float* __restrict__ out,
             int L, int S, int H, int tile_l, float eps) {
  constexpr int P = D * D + D;
  extern __shared__ float smem[];
  const int C = H * D;
  float* s_kv = smem;                  // [H][P]
  float* s_q = s_kv + H * P;           // [tile_l][C], elu'd
  float* s_den = s_q + tile_l * C;     // [tile_l][H]

  const int n = blockIdx.y;
  const int l0 = blockIdx.x * tile_l;
  const int rows = min(tile_l, L - l0);
  const float* kvn = kv + static_cast<size_t>(n) * H * P;
  const float* qn = q + (static_cast<size_t>(n) * L + l0) * C;
  float* on = out + (static_cast<size_t>(n) * L + l0) * C;

  for (int i = threadIdx.x; i < H * P; i += kThreads) s_kv[i] = kvn[i];
  for (int i = threadIdx.x; i < rows * C; i += kThreads) s_q[i] = elu1(qn[i]);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    const int r = i / H, hh = i % H;
    const float* qr = s_q + r * C + hh * D;
    const float* ksum = s_kv + hh * P + D * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], ksum[d], s);
    s_den[i] = s + eps;
  }
  __syncthreads();

  const float s_len = static_cast<float>(S);
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const int hh = c / D, e = c % D;
    const float* qr = s_q + r * C + hh * D;
    const float* kvh = s_kv + hh * P;
    float num = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) num = fmaf(qr[d], kvh[d * D + e], num);
    on[i] = num * (1.f / s_den[r * H + hh]) * s_len;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, float* partial, float* kv,
           int N, int L, int S, int H, int nchunk, int chunk, float eps, cudaStream_t stream) {
  constexpr int P = D * D + D;
  const int C = H * D;
  kv_partial_kernel<D><<<dim3(N * H, nchunk), kThreads, 0, stream>>>(k, v, partial, S, H, chunk,
                                                                       nchunk);
  kv_reduce_kernel<<<N * H, kThreads, 0, stream>>>(partial, kv, P, nchunk);
  const int tile_l = kTileElems / C > 0 ? kTileElems / C : 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(H) * P + tile_l * C + tile_l * H);
  apply_kernel<D><<<dim3((L + tile_l - 1) / tile_l, N), kThreads, smem, stream>>>(
      q, kv, out, L, S, H, tile_l, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [N, L, H*D]; k, v: [N, S, H*D]; out: [N, L, H*D], all f32 contiguous.
// partial: N*H*nchunk*(D*D+D) floats; kv: N*H*(D*D+D) floats (scratch).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int cfp_linear_attention_f32(const float* q, const float* k, const float* v, float* out,
                                        float* partial, float* kv, int N, int L, int S, int H,
                                        int D, int nchunk, int chunk, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(q, k, v, out, partial, kv, N, L, S, H, nchunk, chunk, eps, st);
    case 8: return launch<8>(q, k, v, out, partial, kv, N, L, S, H, nchunk, chunk, eps, st);
    case 16: return launch<16>(q, k, v, out, partial, kv, N, L, S, H, nchunk, chunk, eps, st);
    case 32: return launch<32>(q, k, v, out, partial, kv, N, L, S, H, nchunk, chunk, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
