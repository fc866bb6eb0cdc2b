// The TMA rings of kernels R (probes.cu), U (twodot.cu), Q, V and T
// (slab_gemv.cu): one producer thread fills a ring of shared-memory slots
// with tensor copies (cp.async.bulk.tensor: one request brings a whole box
// of a tiled tensor map, the elements outside the tensor as zeros, and
// completes the box's bytes, zeros included, on an mbarrier), each slot
// with a "full" mbarrier that the copies complete and an "empty" mbarrier
// that the consumer warps arrive at once they are done with the slot. Use u
// of slot d (the u-th time the ring comes round to it) completes phase u of
// both barriers; a wait on parity u & 1 returns once phase u has completed. Few large requests: with
// a bulk copy a row or a column both kernels were bound by the TMA unit's
// rate of requests (PERF.md, PR 17; an H100 SXM at 700 W).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

// host: a tiled tensor map of `rank` dims at `base` (dims and box innermost
// first; strides in bytes of dims 1 .. rank-1), zeros outside the tensor.
// cuTensorMapEncodeTiled is a driver call: found through the runtime, so the
// library links no driver. With CU_TENSOR_MAP_SWIZZLE_128B (a box row of at
// most 128 bytes) the 16-byte chunk c of the box's 128-byte row r lands at
// chunk c ^ (r % 8) of a destination aligned to 1024 bytes (swz128).
inline int encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                  const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  using Fn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                          const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Fn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorNotSupported;
    fn = reinterpret_cast<Fn>(p);
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
                        ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread sets up each barrier, then the CTA syncs before any use
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the producer's one arrival at a "full" barrier: the bytes its copies bring
__device__ __forceinline__ void arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// where byte `col` of row `row` of a 128-byte-swizzled box lies, relative to
// its 1024-byte-aligned destination
__host__ __device__ __forceinline__ uint32_t swz128(uint32_t row, uint32_t col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// the box of `map` at coordinates c (innermost first) into shared dst
// (128-byte aligned), completing its bytes on bar
__device__ __forceinline__ void copy2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

}  // namespace tma
