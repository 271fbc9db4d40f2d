// A whole LoFTR encoder layer in bf16 for sm_90a, on the bf16 tensor cores.
//
// Replaces the TPU kernel cfpnet_tpu/ops/pallas_loftr.py::_fused_loftr_impl
// (kernel `_kernel`, public `fused_loftr`) on bf16 inputs, as
// cfpnet_torch/ops/loftr.py::loftr_apply computes it there: x, source, every
// weight and the output are bf16; q, k and v are accumulated and kept in
// f32, as are the attention's sums, the KV summary, the LayerNorm statistics,
// LN2 and the residual; the message before the merge, LN1's output, the ReLU
// output and the output are rounded to bf16 (pallas_loftr.py:115-117,
// 135-142), and nothing else is. fused_loftr.cu is the f32 layer: the same
// algorithm and the same two passes, there in 3xTF32 on f32 operands.
//
// Bound on the H100: a call moves 2 (2 N L C + N S C + 10 C^2) bytes and
// does 2 (8 N L C^2 + 2 N S C^2) product operations, 0.3-1.2 us at the dense
// bf16 rate for each call of the bs=1 forward and 1.6-9.3 us at bs=8; a call
// is a few small grids whose phases wait on one another, so its latency
// (launches, the weights' arrival, barriers) sets its time at bs=1.
//
// Design: the summary pass and the row pass, the second started early by
// programmatic dependent launch, as in f32. Every operand of a product is
// bf16-valued (x and the source, the weights, the rounded message, LN1's
// rounded output, the rounded hidden), so every product is bf16 x bf16 with
// f32 sums: mma.sync m16n8k16 (wgmma needs 64-row tiles per warpgroup and
// would leave the 32-row tiles of the bs=1 calls and the cluster's column
// slices mostly idle; each phase here is a few dependent k steps, so the
// synchronous instruction costs nothing that an asynchronous one would
// hide). Fragments come from ldmatrix.x4: A from activations whose rows are
// an odd number of 16-byte chunks apart, B (two 8-column tiles a load) from
// the weights in the TMA's swizzled layout; both free of bank conflicts.
//
// 1. Summary pass (per group n: KV and ksum of every head): blocks of one
//    head group of OW = max(D, 16) columns; where there are few groups the
//    source rows of a group are split over a cluster of up to 8 blocks,
//    else each block walks a few groups of its head group (the plan's
//    sum_groups), its weights staged once. The block's OW rows of Wk and of
//    Wv and up to TS source rows a step are copied by cp.async as they are
//    (no registers, no conversion); k and v are projected 64 rows at a
//    time, elu(k)+1 and v / S kept in f32, and the sums are those of f32 (a
//    fixed order, no atomics; the cluster's partials added by block 0 in
//    rank order through distributed shared memory), written to kv as they
//    are complete. Latency-bound: four blocks an SM where the kernel fits 64
//    registers, else three.
// 2. Row pass: persistent over row tiles of TM rows, 2-block clusters at C
//    = 128 (one block at C = 32, 64), each block holding the rows of Wq,
//    Wm, W0 and W1 for its C / CL output columns in bf16, loaded once by TMA
//    (2-D tensor maps over the [out, in] storage, boxes of 64 columns =
//    128-byte rows with the 128-byte swizzle; 32 columns with the 64-byte
//    swizzle for the C = 32 matrices), one mbarrier a matrix: the Q product
//    starts as soon as Wq has landed.
//    - x tile (bf16) -> q (f32) -> elu(q)+1 (f32, the block's heads) ->
//      attention against the group's summary (f32 on the CUDA cores, four
//      output columns a thread; the message rounded to bf16 and written into
//      every cluster block's message tile) -> merge -> LN1 -> the bf16
//      message half of [x, m] in every block -> mlp_0, ReLU, rounded hidden
//      into every block -> mlp_1 -> LN2 + x -> the output, each block its
//      own columns.
//    - The LayerNorms work on the accumulators of the merge and mlp_1
//      products: one warp tile a warp; each warp's row sums and sums of
//      squares over its columns go into one slot of every cluster block's
//      statistics, one cluster barrier, then every thread adds a row's
//      slots in slot order (the same sums in every block) and normalises its
//      own values with flax's fast variance. No f32 copy of a product's rows
//      is kept.
//    - As many blocks an SM as shared memory allows, up to three (C = 32:
//      three, C = 64: two, C = 128: one); the launch plan (tile rows,
//      cluster, resident clusters, the summary's split and blocks) comes from
//      kernels/fused_loftr.py::launch_plan at each call; the row variants
//      built are CFP_BF16_ROW_VARIANTS below.
//
// Shared memory a block (bytes), row pass: weights 2 * 8 C^2 / CL (16,384
// at C = 32; 65,536 at C = 64; 131,072 at C = 128); [x | m] TM (4 C + 16);
// one region TM * max(4 C + 16, 2 C + 16 + 4 C / CL) for the hidden, or the
// message and elu(q)+1; TM * 8 a statistics slot; 1024 for alignment: 40,960
// / 63,488 at C = 32 (TM 64 / 128), 89,088 / 110,592 at C = 64 (32 / 64),
// 167,936 / 201,728 at C = 128 (32 / 64).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;
constexpr int kSmemPerSm = 233472;  // bytes an SM holds for its blocks
constexpr int kSmemPerBlock = 232448;
constexpr int kSmemReserved = 1024;  // bytes the runtime keeps per resident block

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// the dynamic shared memory from its first 1024-byte boundary, where the
// swizzle's pattern starts
__device__ __forceinline__ char* aligned_smem(float4* smem) {
  return reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem) + 1023) &
                                 ~static_cast<uintptr_t>(1023));
}

// A weight of O rows by K columns as the TMA lays it out: slabs of E = 64
// columns (rows of 128 bytes, 128-byte swizzle), or one slab of E = 32
// columns at K = 32 (rows of 64 bytes, 64-byte swizzle); slab s at byte s * O
// * B, the 16-byte chunk c (8 columns) of row n at swz<B>(n, c).
template <int K>
struct Slab {
  static constexpr int E = K < 64 ? K : 64;  // columns a slab
  static constexpr int B = 2 * E;             // bytes a row
};

template <int B>
__device__ __forceinline__ uint32_t swz(int n, int c) {
  if constexpr (B == 128)
    return n * 128 + ((c ^ (n & 7)) << 4);
  else
    return n * 64 + ((c ^ ((n >> 1) & 3)) << 4);
}

// acc[j] = A W^T for the warp's 16 rows of A and the NT 8-column tiles of W
// from row n0 (a multiple of 16), K deep. A: bf16 in shared memory, rows lda
// elements apart (an odd number of 16-byte chunks, so the 8 rows an
// ldmatrix matrix reads fall in 8 bank groups), at the warp's first row. W: the O rows
// of a weight as Slab lays them out, at shared address w. Per k step one
// ldmatrix.x4 for A and one for each two n tiles of B.
template <int K, int O, int NT>
__device__ __forceinline__ void mma_rows(const bf16* A, int lda, uint32_t w, int n0,
                                         float (&acc)[NT][4]) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "tiles");
  constexpr int E = Slab<K>::E, B = Slab<K>::B;
  const int lane = threadIdx.x % 32;
  // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const uint32_t a = cfp::smem_addr(A + (lane % 16) * lda + 8 * (lane / 16));
  // B: (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of two n tiles
  const int bn = n0 + lane % 8 + 8 * (lane / 16), bc = (lane / 8) % 2;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    cfp::ldmatrix_x4(af, a + 2 * k0);
    const uint32_t ws = w + (k0 / E) * O * B;
    const int c = (k0 % E) / 8 + bc;
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t bf[4];
      cfp::ldmatrix_x4(bf, ws + swz<B>(bn + 16 * jj, c));
      cfp::mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
      cfp::mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// The fewest 8-column tiles a warp tile (2, 4, ... up to NTMAX, dividing
// NTT) that leave no more warp tiles than warps, else NTMAX.
template <int MT, int NTT, int NTMAX>
__host__ __device__ constexpr int warp_tile_width() {
  for (int nt = 2; nt < NTMAX; nt *= 2)
    if (NTT % nt == 0 && MT * (NTT / nt) <= kWarps) return nt;
  return NTMAX;
}

// The TM x O product of A (TM rows, K deep) and the O rows of a weight at
// shared address W; store(r, c, v) takes columns c, c + 1 of row r. Warps
// walk over warp tiles of 16 rows by NT 8-column tiles.
template <int TM, int K, int O, int NTMAX, class Store>
__device__ __forceinline__ void product(const bf16* A, int lda, uint32_t W, Store store) {
  constexpr int MT = TM / 16, NTT = O / 8;
  constexpr int NT = warp_tile_width<MT, NTT, NTMAX>();
  constexpr int WPM = NTT / NT, WT = MT * WPM;  // warp tiles an m-tile, warp tiles
  static_assert(NT * WPM == NTT, "warp tiling");
  const int lane = threadIdx.x % 32;
  for (int wt = threadIdx.x / 32; wt < WT; wt += kWarps) {
    const int m0 = (wt / WPM) * 16, n0 = (wt % WPM) * NT * 8;
    float acc[NT][4];
    mma_rows<K, O, NT>(A + m0 * lda, lda, W, n0, acc);
    const int r = m0 + lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      store(r, c, make_float2(acc[j][0], acc[j][1]));
      store(r + 8, c, make_float2(acc[j][2], acc[j][3]));
    }
  }
}

// Warp tiles of the LayerNorm products (TM x OC, one warp tile a warp at
// most): NT 8-column tiles each, the fewest that fit the warps; a row's
// statistics come in SLOTS partial sums, WPM warp tiles of each of the CL
// blocks.
__host__ __device__ constexpr int ln_tile_width(int MT, int NTT) {
  for (int nt = 2; nt <= NTT; nt *= 2)
    if (NTT % nt == 0 && MT * (NTT / nt) <= kWarps) return nt;
  return 0;
}

template <int TM, int OC, int CL>
struct LnTiles {
  static constexpr int MT = TM / 16, NTT = OC / 8;
  static constexpr int NT = ln_tile_width(MT, NTT);
  static_assert(NT > 0, "a LayerNorm product needs one warp tile a warp at most");
  static constexpr int WPM = NTT / NT, WT = MT * WPM, SLOTS = CL * WPM;
};

template <int CL>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CL > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// v to the same place `local` in every block of the cluster
template <int CL, class V>
__device__ __forceinline__ void put(V* local, V v) {
  if constexpr (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int q = 0; q < CL; ++q) *cluster.map_shared_rank(local, q) = v;
  } else {
    *local = v;
  }
}

// The merge (K = C) and mlp_1 (K = 2C) products with their LayerNorm: the TM
// x OC product of A and the block's OC rows of a weight, normalised over the
// C columns of each row from the accumulators (see the design notes);
// emit(r, c, v) takes the normalised columns c, c + 1 of row r, c among the
// block's columns. Contains one cluster barrier.
template <int TM, int K, int C, int CL, class Emit>
__device__ __forceinline__ void ln_product(const bf16* A, int lda, uint32_t W,
                                           const bf16* __restrict__ gamma,
                                           const bf16* __restrict__ beta, float2* s_stat,
                                           int rank, Emit emit) {
  constexpr int OC = C / CL;
  using T = LnTiles<TM, OC, CL>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = (warp / T::WPM) * 16, wn = warp % T::WPM, n0 = wn * T::NT * 8;
  const bool active = warp < T::WT;
  float acc[T::NT][4];
  if (active) {
    mma_rows<K, OC, T::NT>(A + m0 * lda, lda, W, n0, acc);
    float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};  // rows g, g + 8
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] += acc[j][2 * h] + acc[j][2 * h + 1];
        q[h] = fmaf(acc[j][2 * h], acc[j][2 * h], fmaf(acc[j][2 * h + 1], acc[j][2 * h + 1], q[h]));
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
        q[h] += __shfl_xor_sync(0xffffffffu, q[h], off);
      }
    if (t == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put<CL>(s_stat + (m0 + g + 8 * h) * T::SLOTS + rank * T::WPM + wn,
                make_float2(s[h], q[h]));
  }
  cluster_sync<CL>();
  if (!active) return;
  float mean[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2* st = s_stat + (m0 + g + 8 * h) * T::SLOTS;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < T::SLOTS; ++i) {
      sum += st[i].x;
      sq += st[i].y;
    }
    mean[h] = sum / C;
    rstd[h] = rsqrtf(fmaxf(0.f, sq / C - mean[h] * mean[h]) + kLnEps);
  }
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    const int c = n0 + 8 * j + 2 * t, col = rank * OC + c;
    const float2 gm = unpack2(__ldg(reinterpret_cast<const unsigned int*>(gamma + col)));
    const float2 bt = unpack2(__ldg(reinterpret_cast<const unsigned int*>(beta + col)));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      emit(m0 + g + 8 * h, c,
           make_float2((acc[j][2 * h] - mean[h]) * (rstd[h] * gm.x) + bt.x,
                       (acc[j][2 * h + 1] - mean[h]) * (rstd[h] * gm.y) + bt.y));
  }
}

// ---------------------------------------------------------------- summary

template <int C, int D>
struct SumCfg {
  static constexpr int H = C / D;
  static constexpr int P = D * D + D;            // KV then ksum, per head
  static constexpr int OW = D > 16 ? D : 16;     // columns of k (and of v) a block
  static constexpr int HB = OW / D;              // heads a block
  static constexpr int HG = C / OW;              // blocks a group
  // source rows staged a step: all of S on the main path (S <= 144 at C = 32)
  static constexpr int TS = C == 32 ? 160 : 8192 / C;
  static constexpr int LDS = C + 8;              // bf16 (an odd number of 16-byte chunks)
  // the sums as items of four: KV[d][e..e+3], then ksum[d..d+3], per head
  static constexpr int ITEMS = HB * D * (D + 1) / 4;
  static constexpr int R = ITEMS >= kThreads ? 1 : kThreads / ITEMS;  // row slices an item
  static constexpr int NI = (ITEMS + kThreads - 1) / kThreads;        // items a thread
  // bytes from the 1024-byte boundary
  static constexpr int kW = 0;                          // Wk rows then Wv rows, Slab<C>
  static constexpr int kSrc = kW + 2 * 2 * OW * C;      // [TS][LDS] bf16
  static constexpr int kK = kSrc + 2 * TS * LDS;        // [TS][OW] f32, elu'd
  static constexpr int kV = kK + 4 * TS * OW;           // [TS][OW] f32, divided by S
  static constexpr int kRed = kV + 4 * TS * OW;         // [R][ITEMS] float4: row slices' sums
  static constexpr int kPart = kRed + 16 * R * ITEMS;   // [HB * P] f32, for the cluster
  static constexpr int kSmem = 1024 + kPart + 4 * HB * P;
  // blocks an SM the launch bound asks for: four (64 registers) where ptxas
  // keeps the kernel there without spilling (D = 4, 16), else three (80);
  // the pass is latency-bound, and a fourth block hides more of it
  static constexpr int kMinBlocks = D == 4 || D == 16 ? 4 : 3;
  static_assert(kSmem <= kSmemPerBlock, "shared memory of a block");
  static_assert((TS * C / 4) % kThreads == 0, "loop trips");
};

// grid: a multiple of HG * split, clusters of `split` blocks when split > 1
// (then one group a cluster, N * HG * split blocks); at split = 1 each block
// walks the groups of its head group, its weights staged once. kv: [N, H,
// D*D + D] f32 (KV row-major, then ksum). src [N, S, C]; wk, wv [C, C] as
// [out, in], 16-byte aligned.
template <int C, int D>
__global__ void __launch_bounds__(kThreads, SumCfg<C, D>::kMinBlocks)
bf16_summary_kernel(const bf16* __restrict__ src, const bf16* __restrict__ wk,
                    const bf16* __restrict__ wv, float* __restrict__ kv, int N, int S,
                    int split) {
  using K = SumCfg<C, D>;
  constexpr int E = Slab<C>::E, B = Slab<C>::B;
  cfp::launch_dependents();
  extern __shared__ float4 smem4[];
  char* sm = aligned_smem(smem4);
  bf16* s_src = reinterpret_cast<bf16*>(sm + K::kSrc);
  float* s_k = reinterpret_cast<float*>(sm + K::kK);
  float* s_v = reinterpret_cast<float*>(sm + K::kV);
  const uint32_t s_w = cfp::smem_addr(sm + K::kW);
  const int rank = blockIdx.x % split, unit = blockIdx.x / split;
  const int hg = unit % K::HG, n_step = gridDim.x / split / K::HG;

  // the block's OW rows of Wk and of Wv, 16-byte chunks into the layout the
  // products read, by asynchronous copies (the first group's wait covers them)
  for (int i = threadIdx.x; i < 2 * K::OW * C / 8; i += kThreads) {
    const int o = i / (C / 8), k = 8 * (i % (C / 8));
    const bf16* w = o < K::OW ? wk + static_cast<size_t>(hg * K::OW + o) * C
                              : wv + static_cast<size_t>(hg * K::OW + o - K::OW) * C;
    cfp::cp_async16(sm + K::kW + (k / E) * 2 * K::OW * B + swz<B>(o, (k % E) / 8), w + k);
  }
  const int per_rank = (S + split - 1) / split;
  const int s_begin = rank * per_rank, s_end = min(S, s_begin + per_rank);
  const float s_len = static_cast<float>(S);
  float* s_part = reinterpret_cast<float*>(sm + K::kPart);
  float4* s_red = reinterpret_cast<float4*>(sm + K::kRed);

  for (int n = unit / K::HG; n < N; n += n_step) {
    const bf16* sn = src + static_cast<size_t>(n) * S * C;
    float4 part[K::NI];
#pragma unroll
    for (int j = 0; j < K::NI; ++j) part[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int slice = K::R > 1 ? threadIdx.x / K::ITEMS : 0;  // the thread's rows: slice + R j

    // the sync after the staging covers the weights too; the last step's
    // readers of s_src are past the sync after the last product
    for (int s0 = s_begin; s0 < s_end; s0 += K::TS) {
      const int rows = min(K::TS, s_end - s0);
#pragma unroll 1  // the copies hold no registers; unrolled, their addresses spill
      for (int it = 0; it < K::TS * C / 4 / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int r = i / (C / 4), c4 = i % (C / 4);
        // 8-byte copies; rows past the chunk are zero (src_bytes 0)
        cfp::cp_async8(s_src + r * K::LDS + 4 * c4,
                       sn + static_cast<size_t>(s0 + min(r, rows - 1)) * C + 4 * c4,
                       r < rows ? 8 : 0);
      }
      cfp::cp_async_wait_all();
      __syncthreads();
      // k and v of the chunk's rows, 64 rows a product (32 for the last 32 or
      // fewer, so that a 16-row group does not pay for 64)
      for (int r0 = 0; r0 < rows; r0 += 64) {
        auto store = [&](int r, int o, float2 v) {
          if (o < K::OW)
            *reinterpret_cast<float2*>(s_k + (r0 + r) * K::OW + o) =
                make_float2(elu1(v.x), elu1(v.y));
          else
            *reinterpret_cast<float2*>(s_v + (r0 + r) * K::OW + o - K::OW) =
                make_float2(v.x / s_len, v.y / s_len);
        };
        if (rows - r0 > 32)
          product<64, C, 2 * K::OW, 2>(s_src + r0 * K::LDS, K::LDS, s_w, store);
        else
          product<32, C, 2 * K::OW, 2>(s_src + r0 * K::LDS, K::LDS, s_w, store);
      }
      __syncthreads();
      // the sums, four at a time over the thread's row slice; four
      // independent accumulators, fixed order
#pragma unroll
      for (int j = 0; j < K::NI; ++j) {
        const int item = (K::R > 1 ? threadIdx.x % K::ITEMS : threadIdx.x) + j * kThreads;
        if (item >= K::ITEMS || slice >= K::R) continue;
        const int hb = item / (D * (D + 1) / 4), q = item % (D * (D + 1) / 4);
        const bool is_kv = q < D * D / 4;
        const float* kp = s_k + hb * D + (is_kv ? q / (D / 4) : 4 * (q - D * D / 4));
        const float* vp = s_v + hb * D + 4 * (q % (D / 4));
        float4 acc = part[j];
        for (int r = slice; r < rows; r += K::R) {
          if (is_kv) {
            const float k = kp[r * K::OW];
            const float4 v = *reinterpret_cast<const float4*>(vp + r * K::OW);
            acc.x = fmaf(k, v.x, acc.x);
            acc.y = fmaf(k, v.y, acc.y);
            acc.z = fmaf(k, v.z, acc.z);
            acc.w = fmaf(k, v.w, acc.w);
          } else {
            const float4 k = *reinterpret_cast<const float4*>(kp + r * K::OW);
            acc.x += k.x;
            acc.y += k.y;
            acc.z += k.z;
            acc.w += k.w;
          }
        }
        part[j] = acc;
      }
    }

    // the block's heads hg * HB .. are contiguous in kv; item i holds four
    // sums at p(i) of them
    float* out = kv + (static_cast<size_t>(n) * K::H + hg * K::HB) * K::P;
    auto p_of = [](int item) {
      const int hb = item / (D * (D + 1) / 4), q = item % (D * (D + 1) / 4);
      return hb * K::P + (q < D * D / 4 ? 4 * q : D * D + 4 * (q - D * D / 4));
    };
    // without a cluster the sums go to kv as they are complete; the next
    // group's writes of s_red come after its staging barrier, which every
    // thread reaches only past these reads
    if (K::R == 1 && split == 1) {
#pragma unroll
      for (int j = 0; j < K::NI; ++j) {
        const int item = threadIdx.x + j * kThreads;
        if (item < K::ITEMS) *reinterpret_cast<float4*>(out + p_of(item)) = part[j];
      }
      continue;
    }
    // else add the row slices in order
#pragma unroll
    for (int j = 0; j < K::NI; ++j) {
      const int item = (K::R > 1 ? threadIdx.x % K::ITEMS : threadIdx.x) + j * kThreads;
      if (item < K::ITEMS && slice < K::R) s_red[slice * K::ITEMS + item] = part[j];
    }
    __syncthreads();
    for (int item = threadIdx.x; item < K::ITEMS; item += kThreads) {
      float4 t = s_red[item];
      for (int q = 1; q < K::R; ++q) {
        const float4 u = s_red[q * K::ITEMS + item];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      if (split == 1)
        *reinterpret_cast<float4*>(out + p_of(item)) = t;
      else
        *reinterpret_cast<float4*>(s_part + p_of(item)) = t;
    }
    if (split == 1) continue;
    __syncthreads();
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int p = threadIdx.x; p < K::HB * K::P; p += kThreads) {
        float s = 0.f;
        for (int q = 0; q < split; ++q) s += cluster.map_shared_rank(s_part, q)[p];
        out[p] = s;
      }
    }
    cluster.sync();  // the partials stay in place until block 0 has read them
  }
}

// ---------------------------------------------------------------- row pass

template <int C, int D, int TM_, int CL_>
struct RowCfg {
  static constexpr int H = C / D;
  static constexpr int P = D * D + D;
  static constexpr int CL = CL_;                // blocks a cluster
  static constexpr int TM = TM_;                // rows a tile
  static constexpr int OC = C / CL;             // the block's columns of q, the merge and mlp_1
  static constexpr int OH = 2 * C / CL;         // its columns of the MLP hidden
  static constexpr int HB = OC / D;             // its heads
  static constexpr int LDX = 2 * C + 8;         // [x | m] and hidden rows (bf16)
  static constexpr int LDA = C + 8;             // message rows (bf16)
  static constexpr int LQ = OC;                 // elu(q)+1 rows (f32)
  using LN = LnTiles<TM, OC, CL>;
  // bytes from the 1024-byte boundary; the weights in Slab layout
  static constexpr int kWq = 0;
  static constexpr int kWm = kWq + 2 * OC * C;
  static constexpr int kW0 = kWm + 2 * OC * C;
  static constexpr int kW1 = kW0 + 2 * OH * 2 * C;
  static constexpr int kXm = kW1 + 2 * OC * 2 * C;  // [TM][LDX]: x | message
  // one region for the MLP hidden [TM][LDX] and, before it, the message
  // [TM][LDA] beside elu(q)+1 [TM][LQ]: the hidden is written only after
  // every block of the cluster has read its message (the barrier in the
  // merge's LayerNorm), the message only after every block has read the
  // hidden of the tile before (the barrier in LN2)
  static constexpr int kA = kXm + 2 * TM * LDX;
  static constexpr int kQ = kA + 2 * TM * LDA;
  static constexpr int kRegion = 2 * TM * LDX > 2 * TM * LDA + 4 * TM * LQ
                                     ? 2 * TM * LDX : 2 * TM * LDA + 4 * TM * LQ;
  static constexpr int kStat = kA + kRegion;    // [TM][SLOTS] float2
  static constexpr int kSmem = 1024 + kStat + 8 * TM * LN::SLOTS;
  // as many blocks an SM as their shared memory allows, up to three
  // (registers then 80 a thread, or 128 at two)
  static constexpr int kMinBlocks = 3 * (kSmem + kSmemReserved) <= kSmemPerSm   ? 3
                                    : 2 * (kSmem + kSmemReserved) <= kSmemPerSm ? 2
                                                                                : 1;
  static_assert(OC % D == 0, "a block's columns hold whole heads");
  static_assert(kSmem + 4 * sizeof(uint64_t) <= kSmemPerBlock, "shared memory of a block");
  static_assert(TM % 16 == 0 && (TM * OC / 4) % kThreads == 0 && (TM * C / 4) % kThreads == 0,
                "loop trips");
};

// grid: CL * units (units <= row tiles), in clusters of CL. x, out: [N*L, C]
// bf16; kv from the summary pass. Weights by tensor maps over their [out,
// in] bf16 storage (Slab boxes by the block's rows): wq, wm [C, C]; w0 [2C,
// 2C]; w1 [C, 2C]. g*, b* [C] bf16.
template <int C, int D, int TM, int CL>
__global__ void __launch_bounds__(kThreads, RowCfg<C, D, TM, CL>::kMinBlocks)
bf16_rows_kernel(const bf16* __restrict__ x, const float* kv,
                 const __grid_constant__ CUtensorMap tm_wq,
                 const __grid_constant__ CUtensorMap tm_wm,
                 const __grid_constant__ CUtensorMap tm_w0,
                 const __grid_constant__ CUtensorMap tm_w1, const bf16* __restrict__ g1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ g2,
                 const bf16* __restrict__ b2, bf16* __restrict__ out, int NL, int L, int S,
                 float eps) {
  using K = RowCfg<C, D, TM, CL>;
  constexpr int OC = K::OC, OH = K::OH, HB = K::HB, LDX = K::LDX, LDA = K::LDA, LQ = K::LQ;
  constexpr int E = Slab<C>::E;  // columns a box of Wq and Wm (W0, W1: 64)
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[4];  // one a weight: Wq, Wm, W0, W1
  char* sm = aligned_smem(smem4);
  const uint32_t s_wq = cfp::smem_addr(sm + K::kWq), s_wm = cfp::smem_addr(sm + K::kWm);
  const uint32_t s_w0 = cfp::smem_addr(sm + K::kW0), s_w1 = cfp::smem_addr(sm + K::kW1);
  bf16* s_xm = reinterpret_cast<bf16*>(sm + K::kXm);
  bf16* s_h = reinterpret_cast<bf16*>(sm + K::kA);
  bf16* s_a = reinterpret_cast<bf16*>(sm + K::kA);
  float* s_q = reinterpret_cast<float*>(sm + K::kQ);
  float2* s_stat = reinterpret_cast<float2*>(sm + K::kStat);

  int rank = 0;
  if constexpr (CL > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int col0 = rank * OC;  // the block's columns of q, the merge and mlp_1

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) cfp::mbar_init(&bars[i], 1);
    cfp::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    cfp::mbar_expect_bytes(&bars[0], 2 * OC * C);
    cfp::mbar_expect_bytes(&bars[1], 2 * OC * C);
    cfp::mbar_expect_bytes(&bars[2], 2 * OH * 2 * C);
    cfp::mbar_expect_bytes(&bars[3], 2 * OC * 2 * C);
    for (int s = 0; s < C / E; ++s)
      cfp::tma_load_2d(sm + K::kWq + s * OC * 2 * E, &tm_wq, E * s, col0, &bars[0]);
    for (int s = 0; s < C / E; ++s)
      cfp::tma_load_2d(sm + K::kWm + s * OC * 2 * E, &tm_wm, E * s, col0, &bars[1]);
    for (int s = 0; s < 2 * C / 64; ++s)
      cfp::tma_load_2d(sm + K::kW0 + s * OH * 128, &tm_w0, 64 * s, rank * OH, &bars[2]);
    for (int s = 0; s < 2 * C / 64; ++s)
      cfp::tma_load_2d(sm + K::kW1 + s * OC * 128, &tm_w1, 64 * s, col0, &bars[3]);
  }
  auto wait_weight = [&](int i) { cfp::mbar_wait(&bars[i], 0); };
  // bf16 pair of v to columns c, c + 1 of the same tile of every block
  auto put2 = [](bf16* local, float2 v) {
    put<CL>(reinterpret_cast<uint32_t*>(local), cfp::pack2(v.x, v.y));
  };
  // every block of the cluster has started before any writes into its shared memory
  cluster_sync<CL>();

  const int unit = blockIdx.x / CL, units = gridDim.x / CL;
  const int last_group = (NL - 1) / L;
  const float s_len = static_cast<float>(S);
  for (int tile = unit; tile * TM < NL; tile += units) {
    const int row0 = tile * TM;
    const int rows = min(TM, NL - row0);

    // the x tile, 8-byte copies; rows past the end are zero (computed,
    // never written)
#pragma unroll
    for (int it = 0; it < TM * C / 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (C / 4), c4 = i % (C / 4);
      uint2 v = make_uint2(0u, 0u);
      if (r < rows)
        v = __ldg(reinterpret_cast<const uint2*>(x + static_cast<size_t>(row0 + r) * C + 4 * c4));
      *reinterpret_cast<uint2*>(s_xm + r * LDX + 4 * c4) = v;
    }
    __syncthreads();

    wait_weight(0);
    product<TM, C, OC, 4>(s_xm, LDX, s_wq, [&](int r, int c, float2 v) {
      *reinterpret_cast<float2*>(s_q + r * LQ + c) = make_float2(elu1(v.x), elu1(v.y));
    });
    __syncthreads();

    // attention of the block's heads against the row's group summary, four
    // output columns a thread (one 16-byte load of KV and one of ksum's
    // element a d); kv is read only after the summary pass has ended
    cfp::wait_for_primary();
#pragma unroll 1  // each step's D loads of kv in flight at once; more would cost registers
    for (int it = 0; it < TM * OC / 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (OC / 4), c = 4 * (i % (OC / 4));
      const int hb = c / D, e = c % D;
      const int g = min((row0 + r) / L, last_group);
      const float* kvh = kv + (static_cast<size_t>(g) * K::H + rank * HB + hb) * K::P;
      const float* qr = s_q + r * LQ + hb * D;
      float den = 0.f;
      float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16  // at D = 32 all 32 loads at once would spill
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d];
        const float4 m = *reinterpret_cast<const float4*>(kvh + d * D + e);
        den = fmaf(qd, kvh[D * D + d], den);
        n.x = fmaf(qd, m.x, n.x);
        n.y = fmaf(qd, m.y, n.y);
        n.z = fmaf(qd, m.z, n.z);
        n.w = fmaf(qd, m.w, n.w);
      }
      const float z = 1.f / (den + eps);
      put<CL>(reinterpret_cast<uint2*>(s_a + r * LDA + col0 + c),
              make_uint2(cfp::pack2(n.x * z * s_len, n.y * z * s_len),
                         cfp::pack2(n.z * z * s_len, n.w * z * s_len)));
    }
    cluster_sync<CL>();

    // merge and LN1: the rounded message half of [x, m], in every block
    wait_weight(1);
    ln_product<TM, C, C, CL>(s_a, LDA, s_wm, g1, b1, s_stat, rank, [&](int r, int c, float2 v) {
      put2(s_xm + r * LDX + C + col0 + c, v);
    });
    cluster_sync<CL>();

    // MLP: relu([x, m] W0^T), rounded, into every block; then W1^T and LN2
    wait_weight(2);
    product<TM, 2 * C, OH, 4>(s_xm, LDX, s_w0, [&](int r, int c, float2 v) {
      put2(s_h + r * LDX + rank * OH + c, make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f)));
    });
    cluster_sync<CL>();
    wait_weight(3);
    ln_product<TM, 2 * C, C, CL>(s_h, LDX, s_w1, g2, b2, s_stat, rank,
                                 [&](int r, int c, float2 v) {
      if (r < rows) {
        const float2 xr = unpack2(*reinterpret_cast<const uint32_t*>(s_xm + r * LDX + col0 + c));
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row0 + r) * C + col0 + c) =
            cfp::pack2(v.x + xr.x, v.y + xr.y);
      }
    });
    __syncthreads();  // before the next x tile overwrites s_xm
  }
}

// The row-pass variants built: (C, D, rows a tile, blocks a cluster).
// kernels/fused_loftr.py::ROW_VARIANTS_BF16 lists the same.
#define CFP_BF16_ROW_VARIANTS(X)                                                                 \
  X(32, 8, 64, 1) X(32, 8, 128, 1) X(32, 4, 64, 1) X(32, 4, 128, 1)                              \
  X(64, 16, 32, 1) X(64, 16, 64, 1) X(64, 8, 32, 1) X(64, 8, 64, 1)                              \
  X(128, 32, 32, 2) X(128, 32, 64, 2) X(128, 16, 32, 2) X(128, 16, 64, 2)

// sets `kernel`'s dynamic shared-memory limit once per device
template <class Kernel>
int smem_limit(Kernel kernel, int bytes, bool (&done)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64 && done[device]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64) done[device] = true;
  return 0;
}

template <int C, int D>
int launch_summary(const bf16* src, const bf16* wk, const bf16* wv, float* kv, int N, int S,
                   int split, int blocks, cudaStream_t stream) {
  using Q = SumCfg<C, D>;
  static bool done[64] = {};
  if (int rc = smem_limit(bf16_summary_kernel<C, D>, Q::kSmem, done)) return rc;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  if (blocks % (Q::HG * split) || (split > 1 && blocks != N * Q::HG * split))
    return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Q::kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, bf16_summary_kernel<C, D>, src, wk, wv, kv, N, S, split));
}

// the row pass started early (programmatic dependent launch), `units`
// clusters (blocks at CL = 1) walking over the row tiles
template <int C, int D, int TM, int CL>
int launch_rows(const bf16* x, const float* kv, const CUtensorMap (&maps)[4], const bf16* g1,
                const bf16* b1, const bf16* g2, const bf16* b2, bf16* out, int NL, int L, int S,
                float eps, int units, cudaStream_t stream) {
  using R = RowCfg<C, D, TM, CL>;
  static bool done[64] = {};
  if (int rc = smem_limit(bf16_rows_kernel<C, D, TM, CL>, R::kSmem, done)) return rc;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = CL;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * units);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = CL > 1 ? 2 : 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, bf16_rows_kernel<C, D, TM, CL>, x, kv,
                                             maps[0], maps[1], maps[2], maps[3], g1, b1, g2, b2,
                                             out, NL, L, S, eps));
}

// resident clusters (blocks at CL = 1) of a row-pass variant on this device
template <int C, int D, int TM, int CL>
int resident(int& units) {
  using R = RowCfg<C, D, TM, CL>;
  static bool done[64] = {};
  if (int rc = smem_limit(bf16_rows_kernel<C, D, TM, CL>, R::kSmem, done)) return rc;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (CL > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL * sms);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = R::kSmem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&units, bf16_rows_kernel<C, D, TM, CL>, &cfg);
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bf16_rows_kernel<C, D, TM, CL>,
                                                        kThreads, R::kSmem);
    units = per_sm * sms;
  }
  return static_cast<int>(err);
}

}  // namespace

// x, out: [N, L, C]; src: [N, S, C]; wq, wk, wv, wm: [C, C]; w0: [2C, 2C];
// w1: [C, 2C] (weights as [out, in], row-major); g1, b1, g2, b2: [C]; all
// bf16, contiguous; x, src, out 8-byte aligned, the weights 16-byte aligned
// (the TMA's and the summary's 16-byte loads). kv: N*(C/D)*(D*D + D) floats
// of scratch. The plan (kernels/fused_loftr.py::launch_plan): row tiles of
// tm rows, clusters of cl blocks, `units` clusters (blocks at cl = 1) in the
// row pass, the summary's source rows split over `split` blocks, `sum_blocks`
// summary blocks (N * C / max(D, 16) * split where split > 1). Returns the
// cudaError_t of the launches (0 = success; cudaErrorInvalidValue for a
// shape or plan no variant takes).
extern "C" int cfp_fused_loftr_bf16(const bf16* x, const bf16* src, const bf16* wq,
                                    const bf16* wk, const bf16* wv, const bf16* wm,
                                    const bf16* g1, const bf16* b1, const bf16* w0,
                                    const bf16* w1, const bf16* g2, const bf16* b2, bf16* out,
                                    float* kv, int N, int L, int S, int C, int D, int tm, int cl,
                                    int units, int split, int sum_blocks, float eps,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (units < 1 || split < 1 || split > 8) return static_cast<int>(cudaErrorInvalidValue);
  int rc = static_cast<int>(cudaErrorInvalidValue);
#define CFP_BF16_SUMMARY(CC, DD) \
  if (C == CC && D == DD)         \
    rc = launch_summary<CC, DD>(src, wk, wv, kv, N, S, split, sum_blocks, st);
  CFP_BF16_SUMMARY(32, 8)
  CFP_BF16_SUMMARY(32, 4)
  CFP_BF16_SUMMARY(64, 16)
  CFP_BF16_SUMMARY(64, 8)
  CFP_BF16_SUMMARY(128, 32)
  CFP_BF16_SUMMARY(128, 16)
#undef CFP_BF16_SUMMARY
  if (rc) return rc;

  // Wq, Wm: boxes of min(C, 64) columns; W0, W1: 64 columns; by the block's rows
  const int e = C < 64 ? C : 64, oc = C / cl;
  const CUtensorMapSwizzle sw = e == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  auto map = [](CUtensorMap* m, const bf16* w, int rows, int k, int box_k, int box_rows,
                CUtensorMapSwizzle swizzle) {
    return cfp::weight_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), w, rows, k, box_k,
                           box_rows, swizzle);
  };
  CUtensorMap maps[4] = {};
  if ((rc = map(&maps[0], wq, C, C, e, oc, sw))) return rc;
  if ((rc = map(&maps[1], wm, C, C, e, oc, sw))) return rc;
  if ((rc = map(&maps[2], w0, 2 * C, 2 * C, 64, 2 * oc, CU_TENSOR_MAP_SWIZZLE_128B))) return rc;
  if ((rc = map(&maps[3], w1, C, 2 * C, 64, oc, CU_TENSOR_MAP_SWIZZLE_128B))) return rc;
#define CFP_BF16_ROWS(CC, DD, TM, CL)                                                            \
  if (C == CC && D == DD && tm == TM && cl == CL)                                                \
    return launch_rows<CC, DD, TM, CL>(x, kv, maps, g1, b1, g2, b2, out, N * L, L, S, eps, units, \
                                       st);
  CFP_BF16_ROW_VARIANTS(CFP_BF16_ROWS)
#undef CFP_BF16_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident clusters (blocks at cl = 1) of the row-pass variant (C, D, tm, cl)
// on the current device, into *units (cudaOccupancyMaxActiveClusters, or
// blocks an SM times the SMs); the check of launch_plan's residency.
extern "C" int cfp_fused_loftr_bf16_resident(int C, int D, int tm, int cl, int* units) {
#define CFP_BF16_RESIDENT(CC, DD, TM, CL) \
  if (C == CC && D == DD && tm == TM && cl == CL) return resident<CC, DD, TM, CL>(*units);
  CFP_BF16_ROW_VARIANTS(CFP_BF16_RESIDENT)
#undef CFP_BF16_RESIDENT
  return static_cast<int>(cudaErrorInvalidValue);
}
