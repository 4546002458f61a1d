// Banded sorted-set membership over a batch of rows:
//   found[n, i] = exists j: |a[n, i] - b[n, j]| <= bands[n]
// with b ascending within each row; a entries equal to INT32_MAX (the
// padding sentinel) never match.
//
// Replaces src/repro/kernels/intersect.py::banded_intersect_rows_pallas
// (_kernel_rows) and, with one row, banded_intersect_pallas.
//
// Bound: device memory, N * (5 * Pa + 4 * Pb) bytes (a read, found written,
// b read once); the arithmetic is a binary search per a element.  The TPU
// kernel compares dense tiles of a against every in-range tile of b,
// skipping tiles through scalar-prefetched bounds; that is a vector-unit
// design.  Here one thread owns one a element and runs a lower-bound search
// over its row of b for the first b >= a - band; it hits iff that b exists
// and b <= a + band.  The probes of a row land in the same few cache lines,
// so after the first warps the search runs out of L2.  Duplicate keys in b
// (including runs that straddle the TPU's 128-wide blocks) need no special
// case: a lower bound finds the first of them by construction.  The bounds
// are taken in 64 bits, because INT32_MAX + band wraps in 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
banded_intersect_rows_kernel(const int32_t* __restrict__ a,
                             const int32_t* __restrict__ b,
                             const int32_t* __restrict__ bands, long long pa,
                             long long pb, long long total,
                             uint8_t* __restrict__ found) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  long long row = i / pa;
  int32_t av = a[i];
  if (av == INT32_MAX) {
    found[i] = 0;
    return;
  }
  long long band = bands[row];
  long long lo_key = (long long)av - band;
  long long hi_key = (long long)av + band;
  const int32_t* br = b + row * pb;
  long long lo = 0, hi = pb;                   // first j with br[j] >= lo_key
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)br[mid] < lo_key) lo = mid + 1; else hi = mid;
  }
  found[i] = (lo < pb && (long long)br[lo] <= hi_key) ? 1 : 0;
}

}  // namespace

extern "C" int banded_intersect_rows_launch(const void* a, const void* b,
                                            const void* bands, long long n_rows,
                                            long long pa, long long pb,
                                            void* found, void* stream) {
  long long total = n_rows * pa;
  long long grid = (total + kThreads - 1) / kThreads;
  banded_intersect_rows_kernel<<<(unsigned)grid, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)bands, pa, pb,
      total, (uint8_t*)found);
  return (int)cudaGetLastError();
}
