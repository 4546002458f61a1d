// Banded minimum delta over a batch of rows (the proximity-scoring twin of
// the banded intersection):
//   out[n, i] = min over j with |a[n, i] - bk[n, j]| <= bands[n]
//               of |a[n, i] - bk[n, j]| + bd[n, j]
// and INT32_MAX when no such j exists or a[n, i] is the INT32_MAX padding
// sentinel.  bk is ascending within each row (the (key, delta) composite
// order of the batch executor) and bd >= 0; the order of bd inside a run of
// equal keys is not relied on.
//
// Replaces src/repro/kernels/intersect.py::banded_min_delta_rows_pallas
// (_kernel_rows_min_delta).  Like that kernel, and unlike the reference's
// two-probe `implementation="ref"` path, it computes the general minimum:
// rows with band > 0 may carry non-zero deltas.
//
// Bound: device memory, N * (8 * Pa + 8 * Pb) bytes (a read and out
// written, bk and bd read once); the arithmetic is a binary search and a
// short walk per a element.  The TPU kernel compares dense tiles of a
// against every in-range tile of (bk, bd) and min-reduces; here one thread
// owns one a element: a lower-bound search of a - band in its row of bk,
// then a forward walk while bk[j] <= a + band, keeping the minimum of
// |a - bk[j]| + bd[j].  Because bd >= 0, once bk[j] >= a the cost of every
// later entry is at least bk[j] - a, so the walk stops as soon as that
// reaches the current minimum.  Entries left of a are all walked (their
// key distance shrinks as j grows); runs of equal keys are walked entry by
// entry, which at the plan's bands (<= 15) and run lengths is a few loads.
// The bounds are taken in 64 bits, because INT32_MAX + band wraps in 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
banded_min_delta_rows_kernel(const int32_t* __restrict__ a,
                             const int32_t* __restrict__ bk,
                             const int32_t* __restrict__ bd,
                             const int32_t* __restrict__ bands, long long pa,
                             long long pb, long long total,
                             int32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  long long row = i / pa;
  int32_t av32 = a[i];
  if (av32 == INT32_MAX) {
    out[i] = INT32_MAX;
    return;
  }
  long long av = av32;
  long long band = bands[row];
  long long lo_key = av - band;
  long long hi_key = av + band;
  const int32_t* kr = bk + row * pb;
  const int32_t* dr = bd + row * pb;
  long long lo = 0, hi = pb;                   // first j with kr[j] >= lo_key
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)kr[mid] < lo_key) lo = mid + 1; else hi = mid;
  }
  long long best = INT32_MAX;
  for (long long j = lo; j < pb; ++j) {
    long long k = kr[j];
    if (k > hi_key) break;
    long long kd = k >= av ? k - av : av - k;
    if (k >= av && kd >= best) break;          // later entries cost >= kd
    long long c = kd + (long long)dr[j];
    if (c < best) best = c;
  }
  out[i] = (int32_t)best;
}

}  // namespace

extern "C" int banded_min_delta_rows_launch(const void* a, const void* bk,
                                            const void* bd, const void* bands,
                                            long long n_rows, long long pa,
                                            long long pb, void* out,
                                            void* stream) {
  long long total = n_rows * pa;
  long long grid = (total + kThreads - 1) / kThreads;
  banded_min_delta_rows_kernel<<<(unsigned)grid, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)bk, (const int32_t*)bd,
      (const int32_t*)bands, pa, pb, total, (int32_t*)out);
  return (int)cudaGetLastError();
}
