// Hopper building blocks shared by the attention kernels: mbarriers, TMA
// tile loads, and the host-side encoding of TMA tensor maps.
//
// The tensor-map encoder (cuTensorMapEncodeTiled) lives in the driver
// library.  It is fetched through the runtime's driver entry point, so the
// kernel libraries link against nothing beyond the CUDA runtime.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to `A` bytes (the 128-byte TMA
// swizzle needs its tiles on 1024-byte boundaries)
template <int A>
__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((A - (a % A)) % A);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier how many bytes its TMA loads bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase `parity` has completed.  A wait that
// lasts over ~10 s of SM clock (a barrier that never completes) traps, so
// that a fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// a TMA load of one box of a 4-D tensor map at coordinates (c0 innermost);
// completion is counted in bytes on `bar`.  Rows outside the tensor are
// filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- host ---------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    return (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a contiguous [n3, n2, n1, n0] tensor (n0 innermost) of
// bf16 or float32 whose box is [1, rows, 1, cols]: `cols` elements of dim 0
// of one index of dim 1, `rows` consecutive indices of dim 2.  False when
// the driver refuses it.
inline bool make_map_4d(CUtensorMap* map, const void* ptr, bool bf16,
                        uint64_t n0, uint64_t n1, uint64_t n2, uint64_t n3,
                        uint32_t cols, uint32_t rows, CUtensorMapSwizzle sw) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const uint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {n0, n1, n2, n3};
  const cuuint64_t strides[3] = {n0 * es, n0 * n1 * es, n0 * n1 * n2 * es};
  const cuuint32_t box[4] = {cols, 1, rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// registers and local (spill) bytes per thread of a compiled kernel, as
// the runtime reports them
template <typename K>
inline int kernel_attrs(K kernel, long long* regs, long long* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (long long)a.localSizeBytes;
  return 0;
}

}  // namespace hopper
