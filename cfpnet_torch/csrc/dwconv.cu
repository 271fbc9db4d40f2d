// SAME-padded stride-1 k x k depthwise convolution plus bias, NHWC, f32,
// for sm_90a.
//
// Replaces the TPU kernel cfpnet_tpu/ops/pallas_dwconv.py::
// depthwise_conv2d_pallas (kernel `_kernel`), reached from
// cfpnet_tpu/ops/dispatch.py::dwconv2d inside models/convnext.py::Block14:
// k=31 at 120x160x32, k=15 at 60x80x64, k=7 at 30x40x128 in the production
// forward.
//
// Bound on the H100: the operations. At k=31, bs=1 the call does
// 2*31^2*120*160*32 = 1.18 GFLOP of f32 FMA on 4.9 MB of data, ~18 us at
// 67 TFLOP/s (f32 outside the tensor cores) against ~1.5 us of memory time.
//
// Design. The TPU kernel keeps the whole padded image (3.6 MB at k=31) in
// VMEM; a block here has at most 227 KB of shared memory. So the output is
// tiled: a block owns a kTH x kTW output tile of kCB channels, and stages
// that tile's input with its k-1 halo, channel-major so that neighbouring
// threads read neighbouring words, plus the kCB k*k weights (61 KB at
// k=31). Each thread computes kRX outputs along a row: per kernel row it
// loads a window of k+kRX-1 inputs into registers once and reuses every
// weight it loads kRX times, which keeps shared-memory traffic under the
// FMA rate. Accumulation is f32, taps in (dy, dx) order, bias last: the
// order of the plain version (cfpnet_torch/ops/dwconv.py).

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 16;                   // output rows per block
constexpr int kTW = 32;                   // output columns per block
constexpr int kRX = 8;                    // outputs per thread along a row
constexpr int kCB = 4;                    // channels per block
constexpr int kThreadsX = kTW / kRX;      // 4
constexpr int kThreads = kThreadsX * kTH * kCB;  // 256

template <int K>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kCB) * (kTH + K - 1) * (kTW + K - 1) + kCB * K * K);
}

// grid (tiles_y * tiles_x, ceil(C / kCB), B). x, out: [B, H, W, C];
// w: [C, 1, K, K] (torch depthwise layout); b: [C] or null.
template <int K>
__global__ void __launch_bounds__(kThreads)
dwconv_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
              float* __restrict__ out, int H, int W, int C) {
  constexpr int P = (K - 1) / 2;
  constexpr int SH = kTH + K - 1;
  constexpr int SW = kTW + K - 1;
  extern __shared__ float smem[];
  float* s_in = smem;                    // [kCB][SH][SW]
  float* s_w = smem + kCB * SH * SW;     // [kCB][K*K]

  const int tiles_x = (W + kTW - 1) / kTW;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int ty0 = (blockIdx.x / tiles_x) * kTH;
  const int c0 = blockIdx.y * kCB;
  const float* xb = x + static_cast<size_t>(blockIdx.z) * H * W * C;
  float* ob = out + static_cast<size_t>(blockIdx.z) * H * W * C;

  // stage the input tile with its halo; channel fastest in the global read
  for (int i = threadIdx.x; i < SH * SW * kCB; i += kThreads) {
    const int cc = i % kCB;
    const int t = i / kCB;
    const int xx = t % SW, yy = t / SW;
    const int gy = ty0 + yy - P, gx = tx0 + xx - P, gc = c0 + cc;
    float val = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
      val = xb[(static_cast<size_t>(gy) * W + gx) * C + gc];
    s_in[(cc * SH + yy) * SW + xx] = val;
  }
  for (int i = threadIdx.x; i < kCB * K * K; i += kThreads) {
    const int gc = c0 + i / (K * K);
    s_w[i] = gc < C ? w[static_cast<size_t>(gc) * K * K + i % (K * K)] : 0.f;
  }
  __syncthreads();

  const int lx = threadIdx.x % kThreadsX;
  const int ly = (threadIdx.x / kThreadsX) % kTH;
  const int cc = threadIdx.x / (kThreadsX * kTH);
  const float* in_c = s_in + (cc * SH + ly) * SW + lx * kRX;
  const float* w_c = s_w + cc * K * K;

  float acc[kRX];
#pragma unroll
  for (int r = 0; r < kRX; ++r) acc[r] = 0.f;

#pragma unroll 1
  for (int dy = 0; dy < K; ++dy) {
    float win[K + kRX - 1];
#pragma unroll
    for (int i = 0; i < K + kRX - 1; ++i) win[i] = in_c[dy * SW + i];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float wv = w_c[dy * K + dx];
#pragma unroll
      for (int r = 0; r < kRX; ++r) acc[r] = fmaf(win[dx + r], wv, acc[r]);
    }
  }

  const int gc = c0 + cc, gy = ty0 + ly;
  if (gc >= C || gy >= H) return;
  const float bias = b != nullptr ? b[gc] : 0.f;
#pragma unroll
  for (int r = 0; r < kRX; ++r) {
    const int gx = tx0 + lx * kRX + r;
    if (gx < W) ob[(static_cast<size_t>(gy) * W + gx) * C + gc] = acc[r] + bias;
  }
}

template <int K>
int launch(const float* x, const float* w, const float* b, float* out, int B, int H, int W, int C,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(dwconv_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  dwconv_kernel<K><<<dim3(tiles, (C + kCB - 1) / kCB, B), kThreads, smem, stream>>>(x, w, b, out,
                                                                                   H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Built for the large kernels of Block14 (K = 7, 15, 31).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int cfp_dwconv2d_f32(const float* x, const float* w, const float* b, float* out, int B,
                                int H, int W, int C, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 7: return launch<7>(x, w, b, out, B, H, W, C, st);
    case 15: return launch<15>(x, w, b, out, B, H, W, C, st);
    case 31: return launch<31>(x, w, b, out, B, H, W, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
