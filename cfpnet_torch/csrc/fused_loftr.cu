// A whole LoFTR encoder layer, f32 in and out, for sm_90a.
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
// row pass's four products (and a source row 2 C^2 in the summary's two)
// against 8 C bytes of input and output. The nine calls of the production
// forward need 4.8-6.4 us in f32 on the CUDA cores (67 TFLOP/s) and 1.3-2.6
// us as 3xTF32 on the tensor cores (495 / 3 TFLOP/s of counted work); in
// practice each call is a few small grids whose phases wait on one another
// (chip_smoke.py phase 3 records both bounds beside the time).
//
// Design: two launches, the summary pass and the row pass, the second
// started early by programmatic dependent launch. Every product (q, k, v,
// merge, mlp_0, mlp_1) runs on the tensor cores in 3xTF32; the attention's
// sums, the LayerNorms and the activations run in f32 on the CUDA cores.
//
// 1. Summary pass (per group n: KV and ksum of every head). One block per
//    (group, head group of OW = max(D, 16) columns): the block stages its OW
//    rows of Wk and of Wv in the layout the products read, and up to 8192/C
//    source rows at once (160 at C = 32; all of S on the main path),
//    projects them 64 rows at a time (32 for a last 32 or fewer) with the
//    row pass's product, and sums its heads' D*D + D products over the rows
//    in f32, four outputs a thread (KV[d][e..e+3], ksum[d..d+3]) with the
//    rows split over several threads where there are fewer such items than
//    threads, the partial sums added in a fixed order. Where there are few
//    groups (GSA's N = 1) the source rows are split over a cluster of up to
//    8 blocks, whose partial sums block 0 adds in rank order through
//    distributed shared memory: no atomics. It lets the row pass start as
//    soon as it has begun (griddepcontrol.launch_dependents).
// 2. Row pass: persistent, weights resident in shared memory.
//    - Each block loads the rows of Wq, Wm, W0 and W1 it needs once, by TMA
//      (2-D tensor maps over the [out, in] storage, boxes of 32 columns by
//      the block's rows, 128-byte swizzle: 6, 12 or 24 copies a block at
//      C = 32, 64, 128), one mbarrier per matrix: the Q product starts as
//      soon as Wq has landed while the others still arrive. The grid is the
//      number of blocks (C = 32, 64) or 4-block clusters (C = 128) that fit
//      on the card at once (264, 132 and 30 on the H100), and walks over row
//      tiles of TM rows: 48 at C = 128, 64 at C = 32, and at C = 64 32 where
//      all tiles fit one round of the grid, else 64, since a nearly empty
//      second round costs a whole tile's latency again. The taller tiles fit
//      because the MLP hidden shares its shared memory with the attention
//      output and elu(q)+1, which are spent before any block writes it.
//    - C = 128: the 8 C^2 floats (512 KiB) do not fit a block, so a cluster
//      of 4 blocks works on each tile, each block holding the output rows of
//      Wq, Wm, W0 and W1 for its quarter of the output columns (128 KiB).
//      After each product a block writes its column quarter into all four
//      blocks' activation tiles through distributed shared memory, then the
//      cluster syncs, so every block has whole rows for the LayerNorms and
//      the next product. Its quarter of q is whole heads (D = 16, 32), so
//      the attention needs no exchange before its output.
//    - 3xTF32: mma.sync m16n8k8 (wgmma would need 64-row tiles and both
//      halves of the weights in shared memory, which do not fit); each
//      operand is split into TF32 hi + lo as it is read from shared memory
//      (four integer and float instructions an element; ptxas lowers
//      cvt.rna.tf32.f32 to four on sm_90, so a split by cvt costs seven),
//      and hi*hi + (lo*hi + hi*lo) is summed in f32 in three accumulators.
//      One pass of TF32 would leave the 1e-4 tolerance (the CPU emulation in
//      tests/test_torch_port_loftr.py measures both). The lo parts of the
//      weights are not kept: with them the weights would not fit at C = 64
//      or 128. A warp tile is 16 rows by 2-4 8-column tiles; the k slots of
//      a fragment carry adjacent k, so each operand pair is one 8-byte read,
//      free of bank conflicts in the swizzled weights and in activations
//      padded to 4 mod 32 floats.
//    - Before griddepcontrol.wait the row pass loads its weights and x tile
//      and computes the Q product; it reads kv and writes global memory only
//      after the wait.
//    - Attention per row against the row's group summary on the CUDA cores
//      (C*D multiply-adds a row, the denominator in the same loop);
//      LayerNorms a warp per TM/8 rows with their shuffle reductions
//      interleaved, every block of a cluster over whole rows; each block
//      writes its own columns of the output.
//
// Shared memory a block (bytes; TM rows a tile):
//                      row pass: C = 128 (a quarter)   C = 64          C = 32
//   TM                                      48        32 | 64           64
//   weights resident                   131,072        131,072        32,768
//   x | message [TM][2C + 4]            49,920  16,896 | 33,792      17,408
//   MLP hidden [TM][2C + 4], or
//   attention out [TM][C + 4] and
//   elu(q)+1 [TM][C/CL]                 49,920  16,896 | 33,792      17,408
//   1024-byte alignment, mbarriers       1,056          1,056         1,056
//   total (of 232,448)                 231,968  165,920 | 199,712    68,640
// so one block an SM at C = 64 and 128 and two at C = 32 (the registers
// allow no more). The summary pass: 91,392 (C = 128, D = 32), 51,776-64,000
// otherwise.
//
// The bf16 variant (cfp_fused_loftr_bf16) is a design of its own, for the
// bf16 tensor cores: fused_loftr_bf16.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "elem.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

// ---------------------------------------------------------------- row pass

template <int C, int D, int TM_>
struct RowCfg {
  static constexpr int H = C / D;
  static constexpr int P = D * D + D;
  static constexpr int CL = C == 128 ? 4 : 1;   // blocks a cluster
  static constexpr int TM = TM_;                // rows a tile
  static constexpr int OC = C / CL;             // the block's columns of q, the merge and mlp_1
  static constexpr int OH = 2 * C / CL;         // its columns of the MLP hidden
  static constexpr int HB = OC / D;             // its heads
  static constexpr int LDC = C + 4;             // activation row strides, 4 mod 32 floats
  static constexpr int LD2 = 2 * C + 4;
  static constexpr int LQ = OC;
  // weights as the TMA writes them: 32-column slabs of 128-byte rows, swizzled
  static constexpr int kWq = 0;                  // [C/32][OC][32]
  static constexpr int kWm = kWq + OC * C;       // [C/32][OC][32]
  static constexpr int kW0 = kWm + OC * C;       // [2C/32][OH][32]
  static constexpr int kW1 = kW0 + OH * 2 * C;   // [2C/32][OC][32]
  static constexpr int kXm = kW1 + OC * 2 * C;   // [TM][LD2]: x | message
  // one region for the MLP hidden [TM][LD2] and, before it, the attention
  // output [TM][LDC] beside elu(q)+1 [TM][LQ] (the block's columns): the
  // hidden is written only after every block of the cluster has read the
  // attention output, and the attention output only after every block has
  // read the hidden of the tile before
  static constexpr int kH = kXm + TM * LD2;
  static constexpr int kA = kH;
  static constexpr int kQ = kA + TM * LDC;
  static constexpr int kScratch = TM * (LD2 > LDC + LQ ? LD2 : LDC + LQ);
  static constexpr size_t kSmem = 1024 + sizeof(float) * (kH + kScratch);  // 1024: alignment
  static_assert(OC % D == 0, "a block's columns hold whole heads");
  static_assert(kSmem + 4 * sizeof(uint64_t) <= 232448, "shared memory of a block");
  static_assert(TM % 16 == 0 && (TM * OC / 2) % kThreads == 0 && (TM * C / 4) % kThreads == 0,
                "loop trips");
};

// acc[j] = A W^T for the warp's 16 rows of A and its 8-column tiles j of W,
// K deep, in 3xTF32. A: shared, row stride lda (4 mod 32 floats), at the
// warp's first row. W: the O rows of a weight as the TMA lays them out (32-
// column slabs of 128-byte rows, 16-byte chunk c of row n at c ^ (n % 8)),
// at the warp's first row. The k slots t and t + 4 of lane (g, t) carry the
// adjacent k 2(t%2), 2(t%2) + 1 of chunk c + 4 (t/2) of the slab, c = 0..3
// over a slab's four steps: one 8-byte read an operand pair, free of bank
// conflicts in both layouts.
template <int K, int O, int NT>
__device__ __forceinline__ void mma_3xtf32(const float* A, int lda, const float* W,
                                           float (&acc)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int odd = 2 * (t % 2);
  const float* a0 = A + g * lda + 16 * (t / 2) + odd;
  const float* a8 = a0 + 8 * lda;
  const float* w0 = W + g * 32 + odd;
  const int x = g ^ (4 * (t / 2));  // chunk (c + 4 (t/2)) ^ g = c ^ x
  float big[NT][4], lo_hi[NT][4], hi_lo[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) big[j][i] = lo_hi[j][i] = hi_lo[j][i] = 0.f;
#pragma unroll 2
  for (int s = 0; s < K / 32; ++s) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 p = *reinterpret_cast<const float2*>(a0 + 32 * s + 4 * c);
      const float2 q = *reinterpret_cast<const float2*>(a8 + 32 * s + 4 * c);
      uint32_t ah[4], al[4];
      cfp::split_tf32(p.x, ah[0], al[0]);
      cfp::split_tf32(q.x, ah[1], al[1]);
      cfp::split_tf32(p.y, ah[2], al[2]);
      cfp::split_tf32(q.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 w =
            *reinterpret_cast<const float2*>(w0 + 32 * (s * O + 8 * j) + 4 * (c ^ x));
        uint32_t bh[2], bl[2];
        cfp::split_tf32(w.x, bh[0], bl[0]);
        cfp::split_tf32(w.y, bh[1], bl[1]);
        cfp::mma_tf32(lo_hi[j], al, bh);
        cfp::mma_tf32(hi_lo[j], ah, bl);
        cfp::mma_tf32(big[j], ah, bh);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = big[j][i] + (lo_hi[j][i] + hi_lo[j][i]);
}

// The fewest 8-column tiles a warp tile (2, 4, ... up to NTMAX, dividing
// NTT) that leave no more warp tiles than warps, else NTMAX.
template <int MT, int NTT, int NTMAX>
__host__ __device__ constexpr int warp_tile_width() {
  for (int nt = 2; nt < NTMAX; nt *= 2)
    if (NTT % nt == 0 && MT * (NTT / nt) <= kWarps) return nt;
  return NTMAX;
}

// The TM x O product of A (TM rows, K deep) and the block's O rows of a
// weight (TMA layout); store(r, c, v) takes columns c, c + 1 of row r. A warp
// tile is a 16-row slice by NT 8-column tiles, 2 <= NT <= NTMAX: where the
// block's product has few tiles (C = 128: 32 x 32) some warps sit it out,
// since splitting each A fragment for one tile only costs more issue slots
// than the idle warps would fill; where there are more tiles than warps
// (two blocks an SM, with registers short) a warp takes several.
template <int TM, int K, int O, int NTMAX, class Store>
__device__ __forceinline__ void product(const float* A, int lda, const float* W, Store store) {
  constexpr int MT = TM / 16, NTT = O / 8;
  constexpr int NT = warp_tile_width<MT, NTT, NTMAX>();
  constexpr int WPM = NTT / NT, WT = MT * WPM;  // warp tiles an m-tile, warp tiles
  static_assert(NT * WPM == NTT, "warp tiling");
  const int lane = threadIdx.x % 32;
  for (int wt = threadIdx.x / 32; wt < WT; wt += kWarps) {
    const int m0 = (wt / WPM) * 16, n0 = (wt % WPM) * NT * 8;
    float acc[NT][4];
    mma_3xtf32<K, O, NT>(A + m0 * lda, lda, W + n0 * 32, acc);
    const int r = m0 + lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      store(r, c, make_float2(acc[j][0], acc[j][1]));
      store(r + 8, c, make_float2(acc[j][2], acc[j][3]));
    }
  }
}

// Mean and 1/sqrt(var + eps), with flax's fast variance, of the R rows
// v + i * kWarps * ld (C floats each) of one warp, the R shuffle reductions
// interleaved.
template <int C, int R>
__device__ __forceinline__ void row_stats(const float* v, int ld, float (&mean)[R],
                                          float (&rstd)[R]) {
  const int lane = threadIdx.x % 32;
  float s[R], s2[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = s2[i] = 0.f;
#pragma unroll
    for (int c = lane; c < C; c += 32) {
      const float t = v[i * kWarps * ld + c];
      s[i] += t;
      s2[i] = fmaf(t, t, s2[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    mean[i] = s[i] / C;
    const float var = fmaxf(0.f, s2[i] / C - mean[i] * mean[i]);
    rstd[i] = rsqrtf(var + kLnEps);
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
  static constexpr int LDS = C + 4;              // 4 mod 32 floats, as the products read A
  // the sums as items of four: KV[d][e..e+3], then ksum[d..d+3], per head
  static constexpr int ITEMS = HB * D * (D + 1) / 4;
  static constexpr int R = ITEMS >= kThreads ? 1 : kThreads / ITEMS;  // row slices an item
  static constexpr int NI = (ITEMS + kThreads - 1) / kThreads;        // items a thread
  static constexpr int kW = 0;                   // [C/32][2 OW][32]: Wk rows then Wv rows, swizzled
  static constexpr int kSrc = kW + 2 * OW * C;   // [TS][LDS]
  static constexpr int kK = kSrc + TS * LDS;     // [TS][OW], elu'd
  static constexpr int kV = kK + TS * OW;        // [TS][OW], divided by S
  static constexpr int kRed = kV + TS * OW;      // [R][ITEMS] float4: the row slices' partial sums
  static constexpr int kPart = kRed + 4 * R * ITEMS;  // [HB * P], partial sums for the cluster
  static constexpr size_t kSmem = sizeof(float) * (kPart + HB * P);
  static_assert((2 * OW * C / 4) % kThreads == 0 && (TS * C / 4) % kThreads == 0, "loop trips");
};

// grid (N * HG * split), clusters of `split` blocks when split > 1. kv:
// [N, H, D*D + D] f32 (KV row-major, then ksum). wk, wv: [C, C] as [out,
// in].
template <int C, int D>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const float* __restrict__ src, const float* __restrict__ wk,
               const float* __restrict__ wv, float* __restrict__ kv, int S, int split) {
  using K = SumCfg<C, D>;
  cfp::launch_dependents();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* s_w = sm + K::kW;
  float* s_src = sm + K::kSrc;
  float* s_k = sm + K::kK;
  float* s_v = sm + K::kV;
  const int rank = blockIdx.x % split, unit = blockIdx.x / split;
  const int n = unit / K::HG, hg = unit % K::HG;

  // the block's OW rows of Wk and of Wv, in the layout the products read
  // (as the TMA lays out the row pass's weights)
#pragma unroll
  for (int it = 0; it < 2 * K::OW * C / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int o = i / (C / 4), k = 4 * (i % (C / 4));
    const float* w = o < K::OW ? wk + static_cast<size_t>(hg * K::OW + o) * C
                               : wv + static_cast<size_t>(hg * K::OW + o - K::OW) * C;
    *reinterpret_cast<float4*>(s_w + (k / 32) * 2 * K::OW * 32 + o * 32 +
                               4 * (((k % 32) / 4) ^ (o % 8))) = cfp::load4(w + k);
  }
  const int per_rank = (S + split - 1) / split;
  const int s_begin = rank * per_rank, s_end = min(S, s_begin + per_rank);
  const float s_len = static_cast<float>(S);
  const float* sn = src + static_cast<size_t>(n) * S * C;

  float4 part[K::NI];
#pragma unroll
  for (int j = 0; j < K::NI; ++j) part[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int slice = K::R > 1 ? threadIdx.x / K::ITEMS : 0;  // the thread's rows: slice + R j

  // the sync after the staging covers the weights too; the last step's
  // readers of s_src are past the sync after the last product
  for (int s0 = s_begin; s0 < s_end; s0 += K::TS) {
    const int rows = min(K::TS, s_end - s0);
#pragma unroll
    for (int it = 0; it < K::TS * C / 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (C / 4), c4 = i % (C / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows)
        v = cfp::load4(sn + static_cast<size_t>(s0 + r) * C + 4 * c4);
      *reinterpret_cast<float4*>(s_src + r * K::LDS + 4 * c4) = v;
    }
    __syncthreads();
    // k and v of the chunk's rows in 3xTF32, 64 rows a product (32 for the
    // last 32 or fewer, so that a 16-row group does not pay for 64)
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

  // add the row slices in order, into the block's [HB][P] sums
  float* s_part = sm + K::kPart;
  float4* s_red = reinterpret_cast<float4*>(sm + K::kRed);
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
    const int hb = item / (D * (D + 1) / 4), q = item % (D * (D + 1) / 4);
    const int p = hb * K::P + (q < D * D / 4 ? 4 * q : D * D + 4 * (q - D * D / 4));
    s_part[p] = t.x;
    s_part[p + 1] = t.y;
    s_part[p + 2] = t.z;
    s_part[p + 3] = t.w;
  }
  __syncthreads();

  // the block's heads hg * HB .. are contiguous in kv
  float* out = kv + (static_cast<size_t>(n) * K::H + hg * K::HB) * K::P;
  if (split == 1) {
    for (int p = threadIdx.x; p < K::HB * K::P; p += kThreads) out[p] = s_part[p];
    return;
  }
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

// grid: CL * (resident clusters, or fewer when there are fewer tiles), in
// clusters of CL. x, out: [N*L, C]; kv from the summary pass. Weights, of
// their [out, in] storage, by tensor maps (boxes of 32 columns by the block's
// rows, 128-byte swizzle): wq, wm [C, C]; w0 [2C, 2C]; w1 [C, 2C]. g*, b* [C].
template <int C, int D, int TM_>
__global__ void __launch_bounds__(kThreads, C == 32 ? 2 : 1)
rows_kernel(const float* __restrict__ x, const float* kv,
            const __grid_constant__ CUtensorMap tm_wq, const __grid_constant__ CUtensorMap tm_wm,
            const __grid_constant__ CUtensorMap tm_w0, const __grid_constant__ CUtensorMap tm_w1,
            const float* __restrict__ g1, const float* __restrict__ b1,
            const float* __restrict__ g2, const float* __restrict__ b2, float* __restrict__ out,
            int NL, int L, int S, float eps) {
  using K = RowCfg<C, D, TM_>;
  constexpr int CL = K::CL, TM = K::TM, OC = K::OC, OH = K::OH, HB = K::HB;
  constexpr int NTMAX = C == 32 ? 2 : 4;  // two blocks an SM at C = 32: 128 registers
  constexpr int RB = TM / kWarps < 8 ? TM / kWarps : 8;  // rows a warp a LayerNorm batch
  constexpr int LDC = K::LDC, LD2 = K::LD2, LQ = K::LQ;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[4];  // one a weight: Wq, Wm, W0, W1
  // the 128-byte swizzle repeats every 1024 bytes, from a 1024-byte boundary
  float* sm = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem4) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  float* s_wq = sm + K::kWq;
  float* s_wm = sm + K::kWm;
  float* s_w0 = sm + K::kW0;
  float* s_w1 = sm + K::kW1;
  float* s_xm = sm + K::kXm;
  float* s_a = sm + K::kA;
  float* s_h = sm + K::kH;
  float* s_q = sm + K::kQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  int rank = 0;
  if constexpr (CL > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int col0 = rank * OC;  // the block's columns of q, the merge and mlp_1

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) cfp::mbar_init(&bars[i], 1);
    cfp::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    cfp::mbar_expect_bytes(&bars[0], OC * C * sizeof(float));
    cfp::mbar_expect_bytes(&bars[1], OC * C * sizeof(float));
    cfp::mbar_expect_bytes(&bars[2], OH * 2 * C * sizeof(float));
    cfp::mbar_expect_bytes(&bars[3], OC * 2 * C * sizeof(float));
    for (int s = 0; s < C / 32; ++s)
      cfp::tma_load_2d(s_wq + s * OC * 32, &tm_wq, 32 * s, col0, &bars[0]);
    for (int s = 0; s < C / 32; ++s)
      cfp::tma_load_2d(s_wm + s * OC * 32, &tm_wm, 32 * s, col0, &bars[1]);
    for (int s = 0; s < 2 * C / 32; ++s)
      cfp::tma_load_2d(s_w0 + s * OH * 32, &tm_w0, 32 * s, rank * OH, &bars[2]);
    for (int s = 0; s < 2 * C / 32; ++s)
      cfp::tma_load_2d(s_w1 + s * OC * 32, &tm_w1, 32 * s, col0, &bars[3]);
  }

  auto wait_weight = [&](int i) { cfp::mbar_wait(&bars[i], 0); };
  // v to columns c, c + 1 of the same tile of every block of the cluster
  auto put = [&](float* local, float2 v) {
    if constexpr (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int q = 0; q < CL; ++q)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(local, q)) = v;
    } else {
      *reinterpret_cast<float2*>(local) = v;
    }
  };
  auto cluster_sync = [] {
    if constexpr (CL > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  // every block of the cluster has started before any writes into its shared memory
  cluster_sync();

  const int unit = blockIdx.x / CL, units = gridDim.x / CL;
  const int last_group = (NL - 1) / L;
  const float s_len = static_cast<float>(S);
  for (int tile = unit; tile * TM < NL; tile += units) {
    const int row0 = tile * TM;
    const int rows = min(TM, NL - row0);

    // the x tile; rows past the end are zero (computed, never written)
#pragma unroll
    for (int it = 0; it < TM * C / 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (C / 4), c4 = i % (C / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) v = cfp::load4(x + static_cast<size_t>(row0 + r) * C + 4 * c4);
      *reinterpret_cast<float4*>(s_xm + r * LD2 + 4 * c4) = v;
    }
    __syncthreads();

    wait_weight(0);
    product<TM, C, OC, NTMAX>(s_xm, LD2, s_wq, [&](int r, int c, float2 v) {
      *reinterpret_cast<float2*>(s_q + r * LQ + c) = make_float2(elu1(v.x), elu1(v.y));
    });
    __syncthreads();

    // attention of the block's heads against the row's group summary; kv is
    // read only after the summary pass has ended
    cfp::wait_for_primary();
#pragma unroll
    for (int it = 0; it < TM * OC / 2 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (OC / 2), c = 2 * (i % (OC / 2));
      const int hb = c / D, e = c % D;
      const int g = min((row0 + r) / L, last_group);
      const float* kvh = kv + (static_cast<size_t>(g) * K::H + rank * HB + hb) * K::P;
      const float* qr = s_q + r * LQ + hb * D;
      float den = 0.f, n0 = 0.f, n1 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d];
        const float2 m = *reinterpret_cast<const float2*>(kvh + d * D + e);
        den = fmaf(qd, kvh[D * D + d], den);
        n0 = fmaf(qd, m.x, n0);
        n1 = fmaf(qd, m.y, n1);
      }
      const float z = 1.f / (den + eps);
      put(s_a + r * LDC + col0 + c, make_float2(n0 * z * s_len, n1 * z * s_len));
    }
    cluster_sync();

    // merge, then LN1 in place: the message half of the concat input
    wait_weight(1);
    product<TM, C, OC, NTMAX>(s_a, LDC, s_wm, [&](int r, int c, float2 v) {
      put(s_xm + r * LD2 + C + col0 + c, v);
    });
    cluster_sync();
#pragma unroll
    for (int i0 = 0; i0 < TM / kWarps; i0 += RB) {
      float mean[RB], rstd[RB];
      row_stats<C, RB>(s_xm + (warp + i0 * kWarps) * LD2 + C, LD2, mean, rstd);
#pragma unroll
      for (int c = lane; c < C; c += 32) {
        const float gc = g1[c], bc = b1[c];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          float* v = s_xm + (warp + (i0 + i) * kWarps) * LD2 + C;
          v[c] = (v[c] - mean[i]) * (rstd[i] * gc) + bc;
        }
      }
    }
    __syncthreads();

    // MLP: relu([x, m] W0^T) W1^T
    wait_weight(2);
    product<TM, 2 * C, OH, NTMAX>(s_xm, LD2, s_w0, [&](int r, int c, float2 v) {
      put(s_h + r * LD2 + rank * OH + c, make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f)));
    });
    cluster_sync();
    wait_weight(3);
    product<TM, 2 * C, OC, NTMAX>(s_h, LD2, s_w1, [&](int r, int c, float2 v) {
      put(s_xm + r * LD2 + C + col0 + c, v);
    });
    cluster_sync();

    // LN2 and the residual; the block writes its own columns
#pragma unroll
    for (int i0 = 0; i0 < TM / kWarps; i0 += RB) {
      float mean[RB], rstd[RB];
      row_stats<C, RB>(s_xm + (warp + i0 * kWarps) * LD2 + C, LD2, mean, rstd);
#pragma unroll
      for (int cc = lane; cc < OC; cc += 32) {
        const int c = col0 + cc;
        const float gc = g2[c], bc = b2[c];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int r = warp + (i0 + i) * kWarps;
          const float* v = s_xm + r * LD2;
          if (r < rows)
            out[static_cast<size_t>(row0 + r) * C + c] =
                (v[C + c] - mean[i]) * (rstd[i] * gc) + bc + v[c];
        }
      }
    }
    __syncthreads();  // before the next x tile overwrites s_xm
  }
}

// resident clusters (blocks at CL = 1) of rows_kernel<C, D, TM>, per
// device; the first call on a device also sets both passes' shared-memory
// limits
template <int C, int D, int TM>
int row_units(int device, int& units) {
  using K = RowCfg<C, D, TM>;
  static int cache[64] = {};
  if (device < 64 && cache[device] > 0) {
    units = cache[device];
    return 0;
  }
  cudaError_t err = cudaFuncSetAttribute(rows_kernel<C, D, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(K::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(summary_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SumCfg<C, D>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (K::CL > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(K::CL * sms);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = K::kSmem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = K::CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&units, rows_kernel<C, D, TM>, &cfg);
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<C, D, TM>,
                                                        kThreads, K::kSmem);
    units = per_sm * sms;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (units < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (device < 64) cache[device] = units;
  return 0;
}

// the row pass with TM-row tiles: started early (programmatic dependent
// launch), clusters of CL, one cluster or block for each tile up to `units`
template <int C, int D, int TM>
int launch_rows(const float* x, const float* kv, const CUtensorMap (&maps)[4], const float* g1,
                const float* b1, const float* g2, const float* b2, float* out, int NL, int L,
                int S, float eps, int units, cudaStream_t stream) {
  using R = RowCfg<C, D, TM>;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = R::CL;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R::CL * min(units, (NL + TM - 1) / TM));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = R::CL > 1 ? 2 : 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, rows_kernel<C, D, TM>, x, kv, maps[0],
                                             maps[1], maps[2], maps[3], g1, b1, g2, b2, out, NL,
                                             L, S, eps));
}

// Row tiles of TM_LO rows where they all fit in one round of resident
// clusters (blocks), else of TM_HI rows: a second round that is nearly
// empty costs a whole tile's latency again. At C = 64 the main path has
// calls on both sides (3136 rows: 98 tiles of 32 for 132 blocks; 4800 and
// 5103 rows: 75 and 80 tiles of 64). Every C = 128 call of the main path
// needs 48-row tiles (1024-1260 rows, 30 clusters), and at C = 32 (two
// blocks an SM) 128-row tiles were slower than two rounds of 64 rows, so
// those take one height.
template <int C>
struct RowTiles {
  static constexpr int LO = C == 128 ? 48 : C == 64 ? 32 : 64;
  static constexpr int HI = C == 128 ? 48 : 64;
};

template <int C, int D>
int launch(const float* x, const float* src, const float* wq, const float* wk, const float* wv,
           const float* wm, const float* g1, const float* b1, const float* w0, const float* w1,
           const float* g2, const float* b2, float* out, float* kv, int N, int L, int S,
           float eps, cudaStream_t stream) {
  using Q = SumCfg<C, D>;
  constexpr int TM_LO = RowTiles<C>::LO, TM_HI = RowTiles<C>::HI;
  constexpr int OC = RowCfg<C, D, TM_LO>::OC, OH = RowCfg<C, D, TM_LO>::OH;
  int device = 0, units_lo = 0, units_hi = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (int rc = row_units<C, D, TM_LO>(device, units_lo)) return rc;
  if (int rc = row_units<C, D, TM_HI>(device, units_hi)) return rc;
  // boxes of 32 columns (128 bytes) by the block's rows, 128-byte swizzle
  auto map = [](CUtensorMap* m, const float* w, int rows, int k, int box_rows) {
    return cfp::weight_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), w, rows, k, 32,
                           box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  CUtensorMap maps[4] = {};
  if (int rc = map(&maps[0], wq, C, C, OC)) return rc;
  if (int rc = map(&maps[1], wm, C, C, OC)) return rc;
  if (int rc = map(&maps[2], w0, 2 * C, 2 * C, OH)) return rc;
  if (int rc = map(&maps[3], w1, C, 2 * C, OC)) return rc;

  // summary: split the source rows over a cluster where there are few groups
  const int split = N * Q::HG < 64 ? max(1, min(8, (S + 15) / 16)) : 1;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * Q::HG * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Q::kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, summary_kernel<C, D>, src, wk, wv, kv, S, split);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int NL = N * L;
  if ((NL + TM_LO - 1) / TM_LO <= units_lo)
    return launch_rows<C, D, TM_LO>(x, kv, maps, g1, b1, g2, b2, out, NL, L, S, eps, units_lo,
                                    stream);
  return launch_rows<C, D, TM_HI>(x, kv, maps, g1, b1, g2, b2, out, NL, L, S, eps, units_hi,
                                  stream);
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
