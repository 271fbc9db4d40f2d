// SAME-padded stride-1 k x k depthwise convolution plus bias, NHWC, f32 or
// bf16, for sm_90a.
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
// At k=7 both are under 0.4 us, so there the launch and one round trip to
// memory are the cost.
//
// Design. A block owns a TH x TW output tile (TW = 4 RX, TH = TY RY) of CB
// channels (a multiple of 4) and stages that tile's input with its k-1 halo
// in shared memory, one plane per channel, plus the CB k x k weights. The
// tiling is kernels/dwconv.py::TILING, chosen per k so that all blocks are
// resident at once, the busiest SM runs a multiple of 4 warps (one share
// for each of its four schedulers: at 10 warps two of them run 3 and the
// SM takes as long as 12), and little of the tile lies outside the map. Its
// fixed part (RX, RY, NS, D, MAXT, F4) is compiled in: kernels/build.py
// passes it as -DCFP_DWCONV_<NAME>_<k>. Each launch passes the rest (TY, CB
// and the shared-memory pitches) from kernels/dwconv.py::launch_plan.
//
// Staging: 16-byte loads of whole 4-channel groups of the NHWC input (C % 4
// == 0), each scattered into its four channel planes, and of the block's
// weights, F4 loads a thread in flight at a time, so that a block waits for
// one or two round trips to memory and not one per element. Several blocks
// an SM (k=15, k=7) stage while others compute; at k=31 (one block an SM)
// the staging is exposed.
//
// Taps: a thread computes RY rows x RX columns of one channel, over all k
// kernel columns (NS=1) or over one of two column splits [0, D), [D, k)
// (NS=2; the block then has twice the threads, which gives the SM 20 warps
// at k=31 and k=15, and the second split's sums are added to the first's at
// the end). Per input row a thread loads its window of RX+len-1 inputs
// (rounded up to whole float4s) once with 16-byte shared loads, and for each
// of its RY output rows that the input row reaches, that kernel row's len
// weights (float4 loads of one address for all lanes of a channel), then
// does len*RX FMAs. At k=31 (RX=8, RY=2, two splits of 16 and 15 columns) a
// warp runs 6 + 2*4 shared loads per 2*128 FFMAs: 6*4 wavefronts for the
// windows and 2*4 or 2*8 for the weights (a warp spans one or two channels),
// 0.13 to 0.16 wavefronts per FFMA, under the 0.25 at which the shared-memory
// pipe (1 wavefront a cycle) would set the pace of the four FMA pipes of an
// SM.
//
// Bank arithmetic. Thread t is (lx, ly, cc) = (t % 4, t / 4 % TY, t / 4TY)
// within its split, with TY even, so a quarter warp (the 8 lanes one 16-byte
// shared load serves per wavefront) is 4 lx x 2 consecutive ly of one channel
// and one split. Input row y starts at float y*pitch + swz*((y / RY) % 2):
// every other band of RY rows is shifted by swz (0 or 4) floats. Lane
// (lx, ly) reads float4 number lx*RX/4 + ly*RY*pitch/4 + (shift of its
// row)/4 + j (j and the split's start the same for all lanes), whose bank
// group is that number mod 8. RX=8: the lx terms are {0,2,4,6}; with RY odd
// an odd pitch/4 puts the other ly on {1,3,5,7}; with RY even
// ly*RY*pitch/4 is even, and the one-float4 shift, which differs between the
// two ly, makes it odd. RX=4: the lx terms are {0,1,2,3}, and RY*pitch/4 = 4
// mod 8 puts the other ly on {4,5,6,7}. Either way 8 distinct bank groups: no
// conflict. launch_plan picks pitch and swz; tests/test_torch_port_dwconv.py
// checks the arithmetic. A channel plane holds an odd number of float4s, so
// the staging stores of two 4-channel groups fall 16 banks apart.
//
// Output: the tile goes back through shared memory, so that the stores are
// 16-byte groups of 4 channels, as the input was read.
//
// Order of the sums: each output adds its taps in (dy, dx) order, bias last,
// as the plain version (cfpnet_torch/ops/dwconv.py) does; with two column
// splits (k=31, k=15) it adds the sum over dx >= D to the sum over dx < D,
// then the bias.
//
// bf16 (cfp_dwconv2d_bf16): the Pallas kernel upcasts each tap to f32,
// multiplies by the weight and adds the bias in f32, and rounds the output
// once (pallas_dwconv.py:33-37), so in bf16 it is the f32 kernel on
// bf16-valued data. Here the staging converts: 8-byte loads of 4 bf16
// where the f32 path does 16-byte loads of 4 floats, into the same f32
// channel planes, so the taps, TILING and the bank arithmetic are those of
// f32; the output is rounded to bf16 once, at the store (8 bytes a
// 4-channel group).

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

struct Plan {
  int ty;      // thread rows a channel, even; TH = ty * RY
  int cb;      // channels a block, a power of two >= 4
  int pitch;   // floats a staged input row
  int swz;     // floats every other band of RY rows is shifted by (0 or 4)
  int plane;   // floats a channel's staged input
  int wplane;  // floats a channel's staged weights
  int tiles_x;
};

// The taps of kernel columns [D0, D0 + LEN) for a thread's RY x RX outputs:
// per input row, its window of RX+LEN-1 inputs by float4 loads, then for
// each output row the input row reaches, that kernel row's LEN weights and
// LEN*RX FMAs, in (dy, dx) order.
template <int K, int RX, int RY, int D0, int LEN>
__device__ __forceinline__ void tap_rows(const float* in_t, const float* w_t, int pitch, int swz,
                                         int ly, float (&acc)[RY][RX]) {
  constexpr int WIN = round4(RX + LEN - 1);
  constexpr int KP = round4(K);
#pragma unroll 1
  for (int r = 0; r < RY + K - 1; ++r) {
    const int row = ly * RY + r;
    const float4* src =
        reinterpret_cast<const float4*>(in_t + row * pitch + ((row / RY) & 1) * swz + D0);
    float win[WIN];
#pragma unroll
    for (int j = 0; j < WIN / 4; ++j) {
      const float4 v = src[j];
      win[4 * j] = v.x;
      win[4 * j + 1] = v.y;
      win[4 * j + 2] = v.z;
      win[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int oy = 0; oy < RY; ++oy) {
      const int dy = r - oy;
      if (dy < 0 || dy >= K) continue;
      float wr[round4(LEN)];
      const float4* wrow = reinterpret_cast<const float4*>(w_t + dy * KP + D0);
#pragma unroll
      for (int j = 0; j < round4(LEN) / 4; ++j) {
        const float4 v = wrow[j];
        wr[4 * j] = v.x;
        wr[4 * j + 1] = v.y;
        wr[4 * j + 2] = v.z;
        wr[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int dx = 0; dx < LEN; ++dx)
#pragma unroll
        for (int i = 0; i < RX; ++i) acc[oy][i] = fmaf(win[dx + i], wr[dx], acc[oy][i]);
    }
  }
}

// grid (tiles_x * tiles_y, ceil(C / cb), B), NS * 4 * ty * cb threads.
// x, out: [B, H, W, C], C % 4 == 0, aligned to 4 elements; w: [C, 1, K, K]
// (torch depthwise layout), aligned to 4 elements; b: [C] or null; all of
// element type T (float or __nv_bfloat16).
// D: the kernel columns of the first split (K when NS == 1); MAXT: the most
// threads a block may have; F4: the float4 loads a thread keeps in flight
// while staging.
template <class T, int K, int RX, int RY, int NS, int D, int MAXT, int F4>
__global__ void __launch_bounds__(MAXT)
dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
              T* __restrict__ out, int H, int W, int C, Plan p) {
  constexpr int P = (K - 1) / 2;
  constexpr int TW = 4 * RX;
  constexpr int SW = TW + K - 1;           // staged columns
  constexpr int KP = round4(K);            // floats a staged weight row
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                      // [cb][plane]
  float* s_w = smem + p.cb * p.plane;      // [cb][wplane]: K rows of KP floats

  const int tid = threadIdx.x;
  const int nthreads = NS * 4 * p.ty * p.cb;
  const int th = p.ty * RY;
  const int sh = th + K - 1;               // staged rows
  const int tx0 = (blockIdx.x % p.tiles_x) * TW;
  const int ty0 = (blockIdx.x / p.tiles_x) * th;
  const int c0 = blockIdx.y * p.cb;
  const int ng_log2 = __ffs(p.cb) - 3;     // log2 of the 4-channel groups a block
  const T* xb = x + static_cast<size_t>(blockIdx.z) * H * W * C;
  T* ob = out + static_cast<size_t>(blockIdx.z) * H * W * C;

  auto row_off = [&](int row) { return row * p.pitch + ((row / RY) & 1) * p.swz; };
  // group of 4 q < nw: the block's weights, cb*K*K contiguous elements from
  // channel c0 (c0*K*K is a multiple of 4), each scattered to [cc][dy][dx];
  // then the input, 4-channel group fastest, then column, then row
  const T* wsrc = w + static_cast<size_t>(c0) * K * K;
  const int nw = (min(p.cb, C - c0) * K * K) / 4;
  const int n = nw + ((sh * SW) << ng_log2);
  auto load = [&](int q) {
    if (q < nw) return cfp::load4(wsrc + 4 * q);
    q -= nw;
    const int cg = q & ((1 << ng_log2) - 1), t = q >> ng_log2;
    const int gy = ty0 + t / SW - P, gx = tx0 + t % SW - P, gc = c0 + 4 * cg;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W || gc >= C) return make_float4(0.f, 0.f, 0.f, 0.f);
    return cfp::load4(xb + (static_cast<size_t>(gy) * W + gx) * C + gc);
  };
  auto store = [&](int q, float4 v) {
    if (q < nw) {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 4 * q + i, cc = f / (K * K), t = f % (K * K);
        s_w[cc * p.wplane + t / K * KP + t % K] = e[i];
      }
      return;
    }
    q -= nw;
    const int cg = q & ((1 << ng_log2) - 1), t = q >> ng_log2;
    float* d = s_in + 4 * cg * p.plane + row_off(t / SW) + t % SW;
    d[0] = v.x;
    d[p.plane] = v.y;
    d[2 * p.plane] = v.z;
    d[3 * p.plane] = v.w;
  };
  for (int base = 0; base < n; base += F4 * nthreads) {
    float4 v[F4];
#pragma unroll
    for (int j = 0; j < F4; ++j)
      if (base + j * nthreads + tid < n) v[j] = load(base + j * nthreads + tid);
#pragma unroll
    for (int j = 0; j < F4; ++j)
      if (base + j * nthreads + tid < n) store(base + j * nthreads + tid, v[j]);
  }
  __syncthreads();

  const int tl = tid % (4 * p.ty * p.cb);
  const int split = tid / (4 * p.ty * p.cb);  // which kernel columns: [0, D) or [D, K)
  const int lx = tl & 3;
  const int ly = (tl >> 2) % p.ty;
  const int cc = (tl >> 2) / p.ty;
  const float* in_t = s_in + cc * p.plane + lx * RX;
  const float* w_t = s_w + cc * p.wplane;

  float acc[RY][RX];
#pragma unroll
  for (int oy = 0; oy < RY; ++oy)
#pragma unroll
    for (int i = 0; i < RX; ++i) acc[oy][i] = 0.f;
  if constexpr (NS == 1) {
    tap_rows<K, RX, RY, 0, K>(in_t, w_t, p.pitch, p.swz, ly, acc);
  } else if (split == 0) {
    tap_rows<K, RX, RY, 0, D>(in_t, w_t, p.pitch, p.swz, ly, acc);
  } else {
    tap_rows<K, RX, RY, D, K - D>(in_t, w_t, p.pitch, p.swz, ly, acc);
  }

  // the tile through shared memory, [cb][th][TW], then out in 4-channel
  // groups; with two splits the second's sums are added to the first's,
  // then the bias
  const float bias = b != nullptr && c0 + cc < C ? cfp::to_f32(b[c0 + cc]) : 0.f;
  const int oplane = th * TW + 4;
  float* o_t = s_in + cc * oplane + ly * RY * TW + lx * RX;
  __syncthreads();
  if (NS == 2 && split == 1) {
#pragma unroll
    for (int oy = 0; oy < RY; ++oy)
#pragma unroll
      for (int i = 0; i < RX; ++i) o_t[oy * TW + i] = acc[oy][i];
  }
  if (NS == 2) __syncthreads();
  if (split == 0) {
#pragma unroll
    for (int oy = 0; oy < RY; ++oy)
#pragma unroll
      for (int i = 0; i < RX; ++i)
        o_t[oy * TW + i] = (NS == 2 ? acc[oy][i] + o_t[oy * TW + i] : acc[oy][i]) + bias;
  }
  __syncthreads();
  const int nq = (th * TW) << ng_log2;
  for (int q = tid; q < nq; q += nthreads) {
    const int cg = q & ((1 << ng_log2) - 1), pix = q >> ng_log2;
    const int gy = ty0 + pix / TW, gx = tx0 + pix % TW, gc = c0 + 4 * cg;
    if (gy >= H || gx >= W || gc >= C) continue;
    const float* s = s_in + 4 * cg * oplane + pix;
    cfp::store4(ob + (static_cast<size_t>(gy) * W + gx) * C + gc,
                make_float4(s[0], s[oplane], s[2 * oplane], s[3 * oplane]));
  }
}

template <class T, int K, int RX, int RY, int NS, int D, int MAXT, int F4>
int launch(const T* x, const T* w, const T* b, T* out, int B, int H, int W, int C, Plan p,
           cudaStream_t stream) {
  // the largest dynamic shared memory a block may ask for, set once per device
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(dwconv_kernel<T, K, RX, RY, NS, D, MAXT, F4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  const int th = p.ty * RY;
  const int threads = NS * 4 * p.ty * p.cb;
  const size_t smem = sizeof(float) * static_cast<size_t>(p.cb) * (p.plane + p.wplane);
  p.tiles_x = (W + 4 * RX - 1) / (4 * RX);
  const int tiles_y = (H + th - 1) / th;
  const dim3 grid(p.tiles_x * tiles_y, (C + p.cb - 1) / p.cb, B);
  dwconv_kernel<T, K, RX, RY, NS, D, MAXT, F4><<<grid, threads, smem, stream>>>(x, w, b, out, H,
                                                                              W, C, p);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int dispatch(const T* x, const T* w, const T* b, T* out, int B, int H, int W, int C, int K,
             const Plan& p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CFP_DWCONV_CASE(k)                                                                      \
  if (K == k)                                                                                   \
    return launch<T, k, CFP_DWCONV_RX_##k, CFP_DWCONV_RY_##k, CFP_DWCONV_NS_##k, CFP_DWCONV_D_##k, \
                  CFP_DWCONV_MAXT_##k, CFP_DWCONV_F4_##k>(x, w, b, out, B, H, W, C, p, st);
  CFP_DWCONV_CASE(31)
  CFP_DWCONV_CASE(15)
  CFP_DWCONV_CASE(7)
#undef CFP_DWCONV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success); cudaErrorInvalidValue
// for a K this library was not built for. ty, cb, pitch, swz, plane and
// wplane come from kernels/dwconv.py::launch_plan. x, w, b and out are all
// f32 (cfp_dwconv2d_f32) or all bf16 (cfp_dwconv2d_bf16).
extern "C" int cfp_dwconv2d_f32(const float* x, const float* w, const float* b, float* out, int B,
                                int H, int W, int C, int K, int ty, int cb, int pitch, int swz,
                                int plane, int wplane, void* stream) {
  return dispatch(x, w, b, out, B, H, W, C, K, Plan{ty, cb, pitch, swz, plane, wplane, 0},
                  stream);
}

extern "C" int cfp_dwconv2d_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                 const __nv_bfloat16* b, __nv_bfloat16* out, int B, int H, int W,
                                 int C, int K, int ty, int cb, int pitch, int swz, int plane,
                                 int wplane, void* stream) {
  return dispatch(x, w, b, out, B, H, W, C, K, Plan{ty, cb, pitch, swz, plane, wplane, 0},
                  stream);
}
