// EmbeddingBag: out[b, :] = sum over f of w[b, f] * table[ids[b, f], :],
// float32 accumulation, ids of -1 (any negative id) are padding.
//
// Replaces src/repro/kernels/segment_bag.py::segment_bag_pallas (the
// wrapper's mean and cast stay in Python: kernels/ops.py::segment_bag).
//
// Bound: device memory.  Per bag the kernel reads F int32 ids (and F
// weights when given), the table rows they name and writes D float32
// sums; one multiply-add per (b, f, d) is nothing beside it.  The rows are
// a gather: with Zipf-skewed ids most of them repeat and hit L2, so the
// bytes that must come from memory are the 32-byte sectors of the distinct
// rows plus the ids, weights and output (chip_smoke.py, `bag_bound`).
//
// Design (a simple kernel first): one thread per output element (b, d)
// over the flat index b * D + d, so a warp stays full at FM's D = 10 and
// at the linear term's D = 1; neighbouring threads read neighbouring
// columns of one row.  Each thread walks f = 0 .. F-1 in order with one
// float32 accumulator, as the Pallas grid's second axis does, and the
// multiply and the add are rounded separately (__fmul_rn / __fadd_rn: no
// contraction to an FMA), so the sums equal the plain version's
// (ops.segment_bag_plain) bit for bit, weighted or not.
//
// Semantics shared with the plain version:
//   a negative id is skipped (the Pallas kernel reads row 0 and multiplies
//   it by 0, which is the same on finite tables);
//   an id >= V reads row V - 1, as the reference's clamping gather does
//   (the Pallas BlockSpec would read past the table);
//   weights == nullptr means every weight is 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_bag_kernel(const T* __restrict__ table, long long V, long long D,
                   const int32_t* __restrict__ ids,
                   const T* __restrict__ weights, long long B, long long F,
                   float* __restrict__ out) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * D) return;
  long long b = i / D, d = i - b * D;
  const int32_t* bag = ids + b * F;
  float acc = 0.0f;
  for (long long f = 0; f < F; ++f) {
    long long id = bag[f];
    if (id < 0) continue;
    if (id >= V) id = V - 1;
    float x = to_float(table[id * D + d]);
    if (weights != nullptr) x = __fmul_rn(to_float(weights[b * F + f]), x);
    acc = __fadd_rn(acc, x);
  }
  out[i] = acc;
}

template <typename T>
int launch(const void* table, long long V, long long D, const void* ids,
           const void* weights, long long B, long long F, void* out,
           cudaStream_t stream) {
  long long n = B * D;
  long long grid = (n + kThreads - 1) / kThreads;
  segment_bag_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      (const T*)table, V, D, (const int32_t*)ids, (const T*)weights, B, F,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and weights alike).
extern "C" int segment_bag_launch(const void* table, long long V, long long D,
                                  const void* ids, const void* weights,
                                  long long B, long long F, void* out,
                                  long long dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(table, V, D, ids, weights, B, F, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, V, D, ids, weights, B, F, out, s);
  return (int)cudaErrorInvalidValue;
}
