// Multi-head elu+1 linear attention, f32 or bf16, for sm_90a.
//
// Replaces the TPU kernel cfpnet_tpu/ops/pallas_attention.py::
// linear_attention_pallas (kernel `_kernel`), reached from
// cfpnet_tpu/ops/dispatch.py::attention when no mask is given.
//
// Computes, per batch row n and head h, with Kf = elu(K)+1, Qf = elu(Q)+1
// (elu(x)+1 as x > 0 ? x + 1 : exp(x)):
//   KV[h]   = sum_s Kf[s,h,:]^T (V[s,h,:] / S)          (D x D)
//   ksum[h] = sum_s Kf[s,h,:]                           (D)
//   out[l,h,:] = (Qf[l,h,:] . KV[h]) * (1 / (Qf[l,h,:] . ksum[h] + eps)) * S
// which is cfpnet_tpu/ops/attention.py::linear_attention term for term
// (the /S guard and the eps placement included).
//
// Bound on the H100: the bytes. Every input is read once and the output
// written once; the work is about 2*C*D*(S + L) flops over 8*C*(S + L)
// bytes, i.e. about D/4 <= 8 flops per byte, under the card's ~20 flops/byte
// ridge for f32 outside the tensor cores. So no tensor cores: they would
// speed up work that is not the limit. The largest call of the production
// forward (LoFTRNewCross9 at 1/4 scale: L=19200, S=12544, C=32) moves about
// 8 MB, ~2.4 us at 3.35 TB/s; at bs=1 what a call costs is its latency:
// launches, round trips to memory, block-wide syncs.
//
// Design: two device kernels a call, no global partial buffer beyond one
// sum per cluster, and no reduce launch. The geometry of both comes from
// kernels/linear_attention.py::launch_plan (one table; the CPU tests check
// it).
//   summary (attention_sum_kernel): a block takes `hb` heads (all of them on
//     the main path) of one batch row n over a range of keys, in tiles of
//     `tk` keys (one tile on the main path). Key and value rows are read
//     whole, with 16-byte loads, 4 of each in flight a thread, and stored
//     to shared memory with elu and /S applied once, on the way. A 4x4
//     block of KV[h] (and, where its columns start the row, 4 entries of
//     ksum[h]) is an item: 20 independent accumulators fed by two 16-byte
//     shared loads a key. Where a head has few items (D = 4, 8, 16, and
//     D = 32 at 512 threads) an item is `slices` adjacent lanes that split
//     the keys and add up by a butterfly of warp shuffles (key rows padded
//     so that those lanes read distinct bank groups). The `cl` blocks of a
//     thread-block cluster (up to 16; above 8 non-portable, checked with
//     cudaOccupancyMaxActiveClusters) add their sums
//     through distributed shared memory: every block stores each of its
//     values into the shared memory of the rank that owns it, one cluster
//     barrier, and each rank adds the rows it received in rank order and
//     writes its share of the cluster's sum; `g` clusters per (n, head
//     group) write g sums. The pass lets the apply pass start at once
//     (griddepcontrol.launch_dependents).
//   apply (attention_apply_kernel): launched with programmatic stream
//     serialization, so its blocks are resident while the summary runs
//     (its registers are bounded so that they fit beside the summary's).
//     Before griddepcontrol.wait a thread loads its query row's head slice
//     with 16-byte loads and applies elu in registers: q is safe to read
//     there, because the summary is launched without the attribute and so
//     starts only after the producer of q, k and v has finished. After the
//     wait a block loads the g cluster sums of row n at once, every thread
//     a few, into shared memory, adds them in order g = 0..g-1 (heads at a
//     pitch that keeps the KV loads of a warp on distinct bank groups), and
//     each thread computes EO outputs of one query row and head from
//     registers and writes them with 16-byte stores. The query tile is
//     chosen so that the grid fills the 132 SMs in about one round.
// Every sum runs in a fixed order with no atomics, so two calls on the same
// inputs give the same bits.
//
// bf16 (cfp_linear_attention_bf16): q, k, v and out are bf16, every sum is
// f32, and values are rounded to bf16 where the Pallas kernel holds them in
// bf16 (pallas_attention.py:71-88): elu(k)+1 and v / S as they are staged,
// elu(q)+1 as it is loaded, ksum (the f32 sum over all keys) as the apply
// pass reads it, and the output at the store. KV, the denominator and the
// numerator accumulate in f32, as the Pallas products do with
// preferred_element_type f32. Loads are 8 bytes (4 bf16) where f32 loads
// 16; the shared memory and the geometry are those of f32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "elem.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDevices = 64;
constexpr int kClusterMax = 16;  // the H100's largest cluster (above 8: non-portable)
constexpr int kLoads = 4;        // loads of the cluster sums in flight an apply thread

// one call's geometry, from kernels/linear_attention.py::launch_plan
struct Plan {
  int N, L, S, H;
  int hb, hg;          // heads a summary block, head groups
  int cl, g;           // blocks a cluster, clusters a (n, head group)
  int chunk, tk;       // keys a summary block, keys a tile
  int kpitch;          // floats a key row takes in the summary's shared memory
  int slices;          // lanes of an item, that split a tile's keys (a power of two <= 32)
  int sum_threads, sum_smem;
  int tl;              // query rows an apply block
  int pitch;           // floats a head's KV and ksum take in the apply's shared memory
  int apply_threads, apply_smem;
};

template <int D>
struct Cfg {
  static constexpr int P = D * D + D;            // KV and ksum of a head
  static constexpr int W4 = D / 4;               // float4 groups of a head's row
  static constexpr int ITEMS_HEAD = W4 * W4;     // 4x4 blocks of KV a head
  static constexpr int EO = D < 8 || D == 32 ? 4 : 8;  // outputs an apply thread
  static constexpr int W = D / EO;               // apply threads a head of a row
  static constexpr int SUM_MAXT = D == 32 ? 512 : 256;
  static constexpr int APPLY_MAXT = D == 8 ? 640 : 512;  // at two blocks an SM
};

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

// the two halves of a cluster barrier: arriving does not wait, so a block
// can arrive at its start and wait only where it first touches another
// block's shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// grid: N * hg * g * cl blocks in clusters of cl. k, v: [N, S, H*D] of T;
// sums: [N][g][H][D*D + D] f32, one sum per cluster.
template <class T, int D>
__global__ void __launch_bounds__(Cfg<D>::SUM_MAXT)
attention_sum_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     float* __restrict__ sums, Plan p) {
  using K = Cfg<D>;
  constexpr int P = K::P, W4 = K::W4;
  cfp::launch_dependents();
  if (p.cl > 1) cluster_arrive();
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);  // [tk][kpitch], elu'd
  float* s_v = s_k + p.tk * p.kpitch;            // [tk][kpitch], divided by S
  float* s_part = s_v + p.tk * p.kpitch;         // [cl][share], the cluster's sums received

  const int rank = blockIdx.x % p.cl;
  const int cluster_id = blockIdx.x / p.cl;
  const int gi = cluster_id % p.g;
  const int unit = cluster_id / p.g;
  const int n = unit / p.hg, h0 = (unit % p.hg) * p.hb;
  const int heads = min(p.hb, p.H - h0);
  const int C = p.H * D;
  const int s_begin = min(p.S, (gi * p.cl + rank) * p.chunk);
  const int nrows = min(p.S, s_begin + p.chunk) - s_begin;
  const T* kb = k + (static_cast<size_t>(n) * p.S + s_begin) * C + h0 * D;
  const T* vb = v + (static_cast<size_t>(n) * p.S + s_begin) * C + h0 * D;

  // loads: thread -> (key rows lr, lr + rstep, ..., float4 column lc)
  const int row4 = heads * D / 4;  // float4s of a key row this block reads (<= threads)
  const int lc = threadIdx.x % row4, lr = threadIdx.x / row4;
  const int rstep = blockDim.x / row4;
  // sums: thread -> (item, slice), the `slices` lanes of an item adjacent;
  // item -> (head hh, 4x4 block of KV at rows 4 d4, columns 4 e4)
  const int slice = threadIdx.x % p.slices, item = threadIdx.x / p.slices;
  const int hh = item / K::ITEMS_HEAD;
  const int d4 = item % K::ITEMS_HEAD / W4, e4 = item % W4;
  const bool active = hh < heads;
  float a[4][4] = {}, ks[4] = {};
  const float s_len = static_cast<float>(p.S);

  for (int r0 = 0; r0 < nrows; r0 += p.tk) {
    const int rows = min(p.tk, nrows - r0);
    if (r0 > 0) __syncthreads();  // the previous tile has been summed
    // the tile's key and value rows into shared memory, elu'd and divided by
    // S on the way (and rounded to T), 4 loads of each in flight a thread
    if (lr < rstep) {
      for (int r = lr; r < rows; r += 4 * rstep) {
        float4 kx[4], vx[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const size_t off = static_cast<size_t>(r0 + r + u * rstep) * C + 4 * lc;
          if (r + u * rstep < rows) {
            kx[u] = cfp::load4(kb + off);
            vx[u] = cfp::load4(vb + off);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rr = r + u * rstep;
          if (rr < rows) {
            *reinterpret_cast<float4*>(s_k + rr * p.kpitch + 4 * lc) = make_float4(
                cfp::round_to<T>(elu1(kx[u].x)), cfp::round_to<T>(elu1(kx[u].y)),
                cfp::round_to<T>(elu1(kx[u].z)), cfp::round_to<T>(elu1(kx[u].w)));
            *reinterpret_cast<float4*>(s_v + rr * p.kpitch + 4 * lc) = make_float4(
                cfp::round_to<T>(vx[u].x / s_len), cfp::round_to<T>(vx[u].y / s_len),
                cfp::round_to<T>(vx[u].z / s_len), cfp::round_to<T>(vx[u].w / s_len));
          }
        }
      }
    }
    __syncthreads();
    if (active) {
      const float* kp = s_k + hh * D + 4 * d4;
      const float* vp = s_v + hh * D + 4 * e4;
      for (int r = slice; r < rows; r += p.slices) {
        const float4 kk = *reinterpret_cast<const float4*>(kp + r * p.kpitch);
        const float4 vv = *reinterpret_cast<const float4*>(vp + r * p.kpitch);
        const float kr[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i][0] = fmaf(kr[i], vv.x, a[i][0]);
          a[i][1] = fmaf(kr[i], vv.y, a[i][1]);
          a[i][2] = fmaf(kr[i], vv.z, a[i][2]);
          a[i][3] = fmaf(kr[i], vv.w, a[i][3]);
          ks[i] += kr[i];
        }
      }
    }
  }

  // the slices of an item added by a butterfly over their lanes: a fixed
  // pairwise order, and every lane ends with the same bits
  for (int m = 1; m < p.slices; m <<= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] += __shfl_xor_sync(0xffffffffu, a[i][j], m);
      ks[i] += __shfl_xor_sync(0xffffffffu, ks[i], m);
    }
  }

  // the block's sums, [heads][P]: KV[hh][4 d4 + i][4 e4 ..], and ksum[hh][4 d4 ..]
  // from the items with e4 == 0
  float* dst = sums + ((static_cast<size_t>(n) * p.g + gi) * p.H + h0) * P;
  const bool writer = active && slice == 0;
  if (p.cl == 1) {
    if (writer) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(dst + hh * P + (4 * d4 + i) * D + 4 * e4) =
            make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
      if (e4 == 0)
        *reinterpret_cast<float4*>(dst + hh * P + D * D + 4 * d4) =
            make_float4(ks[0], ks[1], ks[2], ks[3]);
    }
    return;
  }

  // the cluster's sum: rank q owns float4s [q share4, (q + 1) share4) of the
  // sums; every block stores its values into the owner's receive rows at row
  // `rank` (distributed shared memory), one barrier, and each owner adds its
  // rows in rank order
  const int share4 = (p.hb * P / 4 + p.cl - 1) / p.cl;
  float4* recv = reinterpret_cast<float4*>(s_part);  // [cl][share4]
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every block of the cluster has started (arrived at the top)
  auto push = [&](int at, float4 val) {
    const int x4 = at / 4;
    *(cluster.map_shared_rank(recv, x4 / share4) + rank * share4 + x4 % share4) = val;
  };
  if (writer) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      push(hh * P + (4 * d4 + i) * D + 4 * e4, make_float4(a[i][0], a[i][1], a[i][2], a[i][3]));
    if (e4 == 0) push(hh * P + D * D + 4 * d4, make_float4(ks[0], ks[1], ks[2], ks[3]));
  }
  cluster.sync();
  const int n4 = heads * P / 4;
  for (int x = threadIdx.x; x < share4 && rank * share4 + x < n4; x += blockDim.x) {
    float4 t[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < p.cl) t[q] = recv[q * share4 + x];
    float4 s4 = t[0];
#pragma unroll
    for (int q = 1; q < kClusterMax; ++q)
      if (q < p.cl) s4 = add4(s4, t[q]);
    reinterpret_cast<float4*>(dst)[rank * share4 + x] = s4;
  }
}

// grid (ceil(L / tl), N); thread -> (query row, head hh, outputs w*4 + 4 W i
// of the head, i < EO / 4). q, out: [N, L, H*D] of T; sums from the summary
// pass. (registers bounded for two blocks an SM, so that the apply's blocks
// find room beside the summary's and start while it runs)
template <class T, int D>
__global__ void __launch_bounds__(Cfg<D>::APPLY_MAXT, 2)
attention_apply_kernel(const T* __restrict__ q, const float* sums, T* __restrict__ out, Plan p,
                       float eps) {
  using K = Cfg<D>;
  constexpr int P = K::P, EO = K::EO, W = K::W;
  extern __shared__ float4 smem4[];
  float* s_kv = reinterpret_cast<float*>(smem4);  // [H][pitch]
  const int C = p.H * D;
  const int n = blockIdx.y;
  const int tpr = p.H * W;
  const int row = threadIdx.x / tpr, j = threadIdx.x % tpr;
  const int hh = j / W, w = j % W;
  const int l = blockIdx.x * p.tl + row;
  const bool active = row < p.tl && l < p.L;
  const size_t at = (static_cast<size_t>(n) * p.L + l) * C + hh * D;

  // before the summary has ended: this thread's query slice, elu'd (and
  // rounded to T)
  float qf[D];
  if (active) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 x = cfp::load4(q + at + 4 * i);
      qf[4 * i] = cfp::round_to<T>(elu1(x.x));
      qf[4 * i + 1] = cfp::round_to<T>(elu1(x.y));
      qf[4 * i + 2] = cfp::round_to<T>(elu1(x.z));
      qf[4 * i + 3] = cfp::round_to<T>(elu1(x.w));
    }
  }
  cfp::wait_for_primary();

  // KV and ksum of row n: the g cluster sums, loaded all at once (kLoads
  // float4s in flight a thread) into shared memory, then added in order
  // g = 0..g-1 (one sum goes straight to its place)
  const int hp4 = p.H * P / 4, all4 = p.g * hp4;
  const float4* src = reinterpret_cast<const float4*>(sums) + static_cast<size_t>(n) * all4;
  float4* s_in = reinterpret_cast<float4*>(s_kv + p.H * p.pitch);  // [g][hp4] where g > 1
  auto place = [&](int x) {
    return reinterpret_cast<float4*>(s_kv + x / (P / 4) * p.pitch + 4 * (x % (P / 4)));
  };
  for (int x0 = threadIdx.x; x0 < all4; x0 += kLoads * blockDim.x) {
    float4 t[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (x0 + u * blockDim.x < all4) t[u] = src[x0 + u * blockDim.x];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x < all4) *(p.g > 1 ? s_in + x : place(x)) = t[u];
    }
  }
  if (p.g > 1) {
    __syncthreads();
    for (int x = threadIdx.x; x < hp4; x += blockDim.x) {
      float4 s4 = s_in[x];
      for (int gi = 1; gi < p.g; ++gi) s4 = add4(s4, s_in[gi * hp4 + x]);
      *place(x) = s4;
    }
  }
  __syncthreads();
  if (!active) return;

  const float* kvh = s_kv + hh * p.pitch;
  float den = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) den = fmaf(qf[d], cfp::round_to<T>(kvh[D * D + d]), den);
  const float scale = (1.f / (den + eps)) * static_cast<float>(p.S);
  float acc[EO] = {};
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int i = 0; i < EO / 4; ++i) {
      const float4 kv = *reinterpret_cast<const float4*>(kvh + d * D + 4 * w + 4 * W * i);
      acc[4 * i] = fmaf(qf[d], kv.x, acc[4 * i]);
      acc[4 * i + 1] = fmaf(qf[d], kv.y, acc[4 * i + 1]);
      acc[4 * i + 2] = fmaf(qf[d], kv.z, acc[4 * i + 2]);
      acc[4 * i + 3] = fmaf(qf[d], kv.w, acc[4 * i + 3]);
    }
  }
#pragma unroll
  for (int i = 0; i < EO / 4; ++i)
    cfp::store4(out + at + 4 * w + 4 * W * i,
                make_float4(acc[4 * i] * scale, acc[4 * i + 1] * scale, acc[4 * i + 2] * scale,
                            acc[4 * i + 3] * scale));
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, bool (&done)[kMaxDevices], int dev) {
  if (done[dev]) return cudaSuccess;
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done[dev] = err == cudaSuccess;
  return err;
}

// Whether clusters of p.cl blocks (wider than the portable 8) of this
// launch fit the card, asked once per device and launch shape.
template <class T, int D>
cudaError_t wide_clusters_fit(int dev, const cudaLaunchConfig_t& cfg, const Plan& p) {
  struct Shape {
    int dev, cl, threads, smem;
  };
  static Shape fit[16];
  static int nfit = 0;
  for (int i = 0; i < nfit; ++i)
    if (fit[i].dev == dev && fit[i].cl == p.cl && fit[i].threads == p.sum_threads &&
        fit[i].smem == p.sum_smem)
      return cudaSuccess;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, attention_sum_kernel<T, D>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  if (nfit < 16) fit[nfit++] = Shape{dev, p.cl, p.sum_threads, p.sum_smem};
  return cudaSuccess;
}

template <class T, int D>
int launch(const T* q, const T* k, const T* v, T* out, float* sums, const Plan& p, float eps,
           cudaStream_t stream) {
  // the largest dynamic shared memory a block may ask for, set once per device
  static bool sum_in[kMaxDevices] = {}, apply_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if ((err = opt_in(attention_sum_kernel<T, D>, sum_in, dev)) != cudaSuccess ||
      (err = opt_in(attention_apply_kernel<T, D>, apply_in, dev)) != cudaSuccess)
    return static_cast<int>(err);
  static bool wide_in[kMaxDevices] = {};
  if (p.cl > 8 && !wide_in[dev]) {
    err = cudaFuncSetAttribute(attention_sum_kernel<T, D>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide_in[dev] = true;
  }

  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.cl;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N * p.hg * p.g * p.cl);
  cfg.blockDim = dim3(p.sum_threads);
  cfg.dynamicSmemBytes = p.sum_smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = p.cl > 1 ? 1 : 0;
  if (p.cl > 8 && (err = wide_clusters_fit<T, D>(dev, cfg, p)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, attention_sum_kernel<T, D>, k, v, sums, p);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((p.L + p.tl - 1) / p.tl, p.N);
  cfg.blockDim = dim3(p.apply_threads);
  cfg.dynamicSmemBytes = p.apply_smem;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, attention_apply_kernel<T, D>, q,
                                             static_cast<const float*>(sums), out, p, eps));
}

template <class T>
int dispatch(const T* q, const T* k, const T* v, T* out, float* sums, int D, const Plan& p,
             float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<T, 4>(q, k, v, out, sums, p, eps, st);
    case 8: return launch<T, 8>(q, k, v, out, sums, p, eps, st);
    case 16: return launch<T, 16>(q, k, v, out, sums, p, eps, st);
    case 32: return launch<T, 32>(q, k, v, out, sums, p, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [N, L, H*D]; k, v: [N, S, H*D]; out: [N, L, H*D], all f32
// (cfp_linear_attention_f32) or all bf16 (cfp_linear_attention_bf16),
// contiguous, aligned to 4 elements. sums: N*g*H*(D*D + D) floats of
// scratch. The geometry (hb .. apply_smem) is
// kernels/linear_attention.py::launch_plan's. Returns the cudaError_t of the
// launches (0 = success).
#define CFP_ATTENTION_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* out, float* sums, int N, int L,     \
                      int S, int H, int D, int hb, int hg, int cl, int g, int chunk, int tk,     \
                      int kpitch, int slices, int sum_threads, int sum_smem, int tl, int pitch,  \
                      int apply_threads, int apply_smem, float eps, void* stream) {              \
    const Plan p{N, L, S, H, hb, hg, cl, g, chunk, tk, kpitch, slices, sum_threads, sum_smem,   \
                 tl, pitch, apply_threads, apply_smem};                                          \
    return dispatch(q, k, v, out, sums, D, p, eps, stream);                                      \
  }
CFP_ATTENTION_ENTRY(cfp_linear_attention_f32, float)
CFP_ATTENTION_ENTRY(cfp_linear_attention_bf16, __nv_bfloat16)
#undef CFP_ATTENTION_ENTRY
