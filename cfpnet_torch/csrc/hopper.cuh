// PTX helpers for sm_90a kernels: TF32 tensor-core products split in three
// for f32 accuracy (3xTF32), bf16 tensor-core products with their fragments
// loaded by ldmatrix, mbarriers fed by bulk asynchronous copies, and
// programmatic dependent launch.
#pragma once

#include <cstdint>

namespace cfp {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo as two TF32 operands (10 explicit mantissa bits), each rounded
// to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds. The tensor
// cores read only the top 19 bits of an operand, so adding half a TF32 unit
// to the bits rounds it; the low 13 bits are cleared only where the value is
// used (x - hi, exact in f32). Four instructions an element, where ptxas
// lowers each cvt.rna.tf32.f32 to four (sm_90 has no such instruction).
// Finite x only; hi + lo keeps 22 of x's 24 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// d += a b for one 16x8x8 tile, TF32 in, f32 accumulate. Fragments of lane
// (g, t) = (lane / 4, lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1] (k slots t and t+4 may stand for any two k).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b for one 16x8x16 tile, bf16 in, f32 accumulate. Fragments of lane
// (g, t) = (lane / 4, lane % 4), two bf16 a register, the lower k in the low
// half: a = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b =
// B[2t..][g], B[2t+8..][g]; d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 matrices of 16-bit elements from shared memory: lane i gives the
// address of row i % 8 of matrix i / 8 (16 bytes, 16-byte aligned); r[j] of
// lane (g, t) holds elements (g, 2t) and (g, 2t + 1) of matrix j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// asynchronous copies from global to shared memory that pass through no
// register: 8 bytes of which the first src_bytes are read and the rest are
// zero (cp_async8), or 16 bytes (cp_async16, both 16-byte aligned); complete
// after cp_async_wait_all()
__device__ __forceinline__ void cp_async8(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of a 2-D tensor map at (x, y) (x the inner coordinate) from global
// to this block's shared memory by the TMA; completion is counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tensor_map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// programmatic dependent launch: the primary lets its dependent grid start;
// the dependent waits for the primary's completion and memory
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

}  // namespace cfp
