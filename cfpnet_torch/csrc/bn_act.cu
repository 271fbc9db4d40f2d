// Eval-mode BatchNorm with the activation and the shortcut add that follow
// it, as one pass, f32 or bf16, for sm_90a:
//
//   y = act((x - mean[c]) * s[c] + bias[c]) (+ r),
//   s[c] = rsqrt(var[c] + eps) * weight[c],
//
// act one of identity, SiLU (v / (1 + exp(-v))), LeakyReLU(0.01) or ReLU; r
// the block's shortcut, added after the activation. x, r and y have one
// element type T; weight, bias and the running statistics are T too (a bf16
// model casts them with its parameters). s is computed here, in f32, from
// the module's own parameters and buffers at every call, so a graph that
// captured the call reads whatever the weights hold when it replays.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm, its activation
// and the residual add to XLA, which fuses them into one loop. The port's
// eager and CUDA-graph forward has no such fusion, and written out in
// PyTorch the formula is six launches (three on [C], three full-tensor
// broadcast passes) plus one pass for the activation and one for the add
// (models/layers.py::BatchNorm, kernels/bn_act.py::bn_act_plain).
//
// Bound on the H100: the bytes. Each element is read once (twice with a
// shortcut) and written once, for about ten operations: two orders of
// magnitude under the card's ratio of operations to bytes. The eval forward's
// 122 calls (CFPNet) move 2 x 134.7 MB in bf16 and the shortcuts, ~0.08 ms
// at 3.35 TB/s; most calls are 0.1-1 MB, where what a call costs is its
// launch and one round trip to memory.
//
// Design: the tensor is [outer, C, inner] in memory (NCHW: inner = H*W;
// channel-innermost tokens, or an NCHW map in channels-last memory:
// inner = 1). A thread takes one 16-byte vector (4 f32 or 8 bf16 elements)
// of x, of r and of y, arithmetic in f32 and one rounding to T at the store,
// so a warp reads and writes 512 contiguous bytes: whole sectors, all
// threads of the card resident with one vector each in flight, about the 2
// MB that Little's law asks of HBM at full rate. The channel of a vector's
// first element comes from two divisions by constants done as a multiply
// and shift (FastDiv, the constants from kernels/bn_act.py::fast_div), once
// a vector; the other lanes follow without a division:
//   PLANE  (inner >= the vector width): at most one channel boundary lies in
//          a vector, so a lane takes channel c or c + 1 by comparing its
//          offset in the plane with inner. Planes of 300 or 1,200 bf16
//          elements (15x20, 30x40) are not whole vectors, and vectors
//          straddle two channels there.
//   TOKENS (inner == 1, C a multiple of the vector width): a vector holds
//          the consecutive channels c .. c + N - 1, whose parameters are
//          read as 16-byte vectors too.
//   SCALAR (anything else: a plane narrower than a vector, C not a multiple
//          of it, or a pointer not 16-byte aligned): a thread an element,
//          its channel by the same two divisions.
// In the vector modes the elements past the last whole vector (fewer than
// N) are taken one by one by one more thread. The per-channel parameters are
// read through the read-only cache; they are a few KB against the MB of
// the map. The mode and the grid come from kernels/bn_act.py::launch_plan.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;

enum Mode : int { kPlane = 0, kTokens = 1, kScalar = 2 };
enum Act : int { kIdentity = 0, kSilu = 1, kLeakyRelu = 2, kRelu = 3 };

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (d > 1), or n (d ==
// 1): mul = ceil(2^(31 + l) / d), shift = l - 1, l = ceil(log2 d)
struct FastDiv {
  unsigned d, mul, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shift;
  }
};

struct Args {
  long long n;     // elements
  unsigned items;  // vectors (PLANE, TOKENS) or elements (SCALAR)
  unsigned C;
  FastDiv inner, channels;
  float eps;
  int act;
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kSilu:
      return v / (1.0f + expf(-v));  // torch's silu, f32 opmath
    case kLeakyRelu:
      return v > 0.0f ? v : v * 0.01f;
    case kRelu:
      return v > 0.0f ? v : 0.0f;
    default:
      return v;
  }
}

// 16 bytes as f32: 4 f32 or 8 bf16 elements
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(cfp::pack2(v[0], v[1]), cfp::pack2(v[2], v[3]),
                                            cfp::pack2(v[4], v[5]), cfp::pack2(v[6], v[7]));
}

template <class T>
struct Params {
  const T *weight, *bias, *mean, *var;
};

// one channel's (mean, scale, bias) in f32
struct Chan {
  float m, s, b;
};

template <class T>
__device__ __forceinline__ Chan channel(const Params<T>& p, unsigned c, float eps) {
  return Chan{cfp::to_f32(__ldg(p.mean + c)),
              rsqrtf(cfp::to_f32(__ldg(p.var + c)) + eps) * cfp::to_f32(__ldg(p.weight + c)),
              cfp::to_f32(__ldg(p.bias + c))};
}

__device__ __forceinline__ float bn(float x, const Chan& k, int act) {
  return activate((x - k.m) * k.s + k.b, act);
}

// the channel of element e: (e / inner) mod C
__device__ __forceinline__ unsigned channel_of(unsigned e, const Args& a) {
  const unsigned q = a.inner.div(e);
  return q - a.channels.div(q) * a.C;
}

template <class T>
__device__ __forceinline__ void one(const T* x, const T* r, T* y, const Params<T>& p,
                                    unsigned e, const Args& a) {
  float v = bn(cfp::to_f32(x[e]), channel(p, channel_of(e, a), a.eps), a.act);
  if (r != nullptr) v += cfp::to_f32(r[e]);
  cfp::store1(y + e, v);
}

template <class T, int MODE>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y,
                  Params<T> p, Args a) {
  constexpr int N = 16 / sizeof(T);
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (MODE == kScalar) {
    if (i < a.items) one(x, r, y, p, i, a);
    return;
  }
  if (i >= a.items) {
    if (i == a.items)  // the elements past the last whole vector
      for (unsigned e = a.items * N; e < a.n; ++e) one(x, r, y, p, e, a);
    return;
  }
  const unsigned e0 = i * N;
  float v[N], res[N];
  load16(x + e0, v);
  if (r != nullptr) load16(r + e0, res);
  if constexpr (MODE == kPlane) {
    const unsigned q = a.inner.div(e0);
    const unsigned c = q - a.channels.div(q) * a.C;
    // lanes from `split` on lie in the next plane, of channel c + 1 (mod C)
    const unsigned split = a.inner.d - (e0 - q * a.inner.d);
    const Chan k0 = channel(p, c, a.eps);
    if (split >= N) {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = bn(v[j], k0, a.act);
    } else {
      const Chan k1 = channel(p, c + 1 == a.C ? 0 : c + 1, a.eps);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = bn(v[j], j < split ? k0 : k1, a.act);
    }
  } else {  // kTokens: lanes are the channels c .. c + N - 1
    const unsigned c = e0 - a.channels.div(e0) * a.C;
    float w[N], b[N], m[N], s[N];
    load16(p.weight + c, w);
    load16(p.bias + c, b);
    load16(p.mean + c, m);
    load16(p.var + c, s);
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = bn(v[j], Chan{m[j], rsqrtf(s[j] + a.eps) * w[j], b[j]}, a.act);
  }
  if (r != nullptr) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += res[j];
  }
  store16(y + e0, v);
}

template <class T>
int launch(const T* x, const T* r, const T* w, const T* b, const T* mean, const T* var, T* y,
           long long n, unsigned C, int mode, unsigned items, int blocks, unsigned inner,
           unsigned inner_mul, unsigned inner_shift, unsigned c_mul, unsigned c_shift, float eps,
           int act, void* stream) {
  const Args a{n, items, C, FastDiv{inner, inner_mul, inner_shift}, FastDiv{C, c_mul, c_shift},
               eps, act};
  const Params<T> p{w, b, mean, var};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlane:
      bn_act_kernel<T, kPlane><<<blocks, kThreads, 0, st>>>(x, r, y, p, a);
      break;
    case kTokens:
      bn_act_kernel<T, kTokens><<<blocks, kThreads, 0, st>>>(x, r, y, p, a);
      break;
    case kScalar:
      bn_act_kernel<T, kScalar><<<blocks, kThreads, 0, st>>>(x, r, y, p, a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). r may be null (no
// shortcut). mode, items, blocks and the FastDiv constants of inner and C
// come from kernels/bn_act.py::launch_plan; act is its ACTS index. Every
// tensor is f32 (cfp_bn_act_f32) or every one bf16 (cfp_bn_act_bf16).
#define CFP_BN_ACT_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const T* x, const T* r, const T* w, const T* b, const T* mean,            \
                      const T* var, T* y, long long n, unsigned C, int mode, unsigned items,    \
                      int blocks,                                                               \
                      unsigned inner, unsigned inner_mul, unsigned inner_shift, unsigned c_mul, \
                      unsigned c_shift, float eps, int act, void* stream) {                     \
    return launch(x, r, w, b, mean, var, y, n, C, mode, items, blocks, inner, inner_mul,        \
                  inner_shift, c_mul, c_shift, eps, act, stream);                                \
  }

CFP_BN_ACT_ENTRY(cfp_bn_act_f32, float)
CFP_BN_ACT_ENTRY(cfp_bn_act_bf16, __nv_bfloat16)
