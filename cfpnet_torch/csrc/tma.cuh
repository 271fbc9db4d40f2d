// Host side of the Tensor Memory Accelerator: 2-D tensor maps over row-major
// weights, encoded by cuTensorMapEncodeTiled from the driver the runtime has
// loaded (no -lcuda).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace cfp {

inline int tensor_map_encoder(PFN_cuTensorMapEncodeTiled_v12000& fn) {
  static PFN_cuTensorMapEncodeTiled_v12000 cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  fn = cached;
  return 0;
}

// a row-major [rows, k] matrix of `type` (`elem_bytes` an element), read in
// boxes of box_k columns by box_rows rows with `swizzle`; box_k * elem_bytes
// is the swizzle's span (128 or 64 bytes)
inline int weight_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* w,
                      int rows, int k, int box_k, int box_rows, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  if (int rc = tensor_map_encoder(encode)) return rc;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(w), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cfp
