// Signed-delta bitmask over a batch of rows (the K-word join twin of the
// banded intersection):
//   out[n, i] bit (d + bands[n]) is set iff some b[n, j] == a[n, i] + d,
//   for each d with |d| <= bands[n] and |d| <= 15,
// and out[n, i] = 0 where a[n, i] is the INT32_MAX padding sentinel.  b is
// ascending within each row.  The plan's bands are <= 15
// (KW_DEVICE_MAX_WINDOW), so bit indices stay <= 30; like the plain
// version, a wider band clips its bit index to 31 and still walks only
// |d| <= 15.
//
// Replaces src/repro/kernels/intersect.py::banded_delta_mask_rows_pallas
// (_kernel_rows_delta_mask).
//
// Bound: device memory, N * (8 * Pa + 4 * Pb) bytes (a read and out
// written, b read once); the arithmetic is a binary search and a short walk
// per a element.  The TPU kernel builds the mask from dense tile-pair
// compares and an OR-reduction; here one thread owns one a element: a
// lower-bound search of a - w (w = min(band, 15)) in its row of b, then a
// forward walk while b[j] <= a + w that ORs in one bit per entry.  Bits are
// built as `1u << k` on unsigned ints (a signed 1 << 31 is undefined).
// Runs of duplicate keys are walked entry by entry rather than skipped with
// a second binary search: the rebased keys of one row repeat only where
// several unioned fetches hold the same posting, so runs are short.  The
// bounds are taken in 64 bits, because INT32_MAX + band wraps in 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBand = 15;

__global__ void __launch_bounds__(kThreads)
banded_delta_mask_rows_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              const int32_t* __restrict__ bands, long long pa,
                              long long pb, long long total,
                              int32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  long long row = i / pa;
  int32_t av32 = a[i];
  if (av32 == INT32_MAX) {
    out[i] = 0;
    return;
  }
  long long av = av32;
  long long band = bands[row];
  long long w = band < kMaxBand ? band : kMaxBand;
  unsigned int mask = 0u;
  if (w >= 0) {
    long long lo_key = av - w;
    long long hi_key = av + w;
    const int32_t* br = b + row * pb;
    long long lo = 0, hi = pb;                 // first j with br[j] >= lo_key
    while (lo < hi) {
      long long mid = (lo + hi) >> 1;
      if ((long long)br[mid] < lo_key) lo = mid + 1; else hi = mid;
    }
    for (long long j = lo; j < pb; ++j) {
      long long k = br[j];
      if (k > hi_key) break;
      long long bit = k - av + band;
      bit = bit < 0 ? 0 : (bit > 31 ? 31 : bit);
      mask |= 1u << (unsigned int)bit;
    }
  }
  out[i] = (int32_t)mask;
}

}  // namespace

extern "C" int banded_delta_mask_rows_launch(const void* a, const void* b,
                                             const void* bands,
                                             long long n_rows, long long pa,
                                             long long pb, void* out,
                                             void* stream) {
  long long total = n_rows * pa;
  long long grid = (total + kThreads - 1) / kThreads;
  banded_delta_mask_rows_kernel<<<(unsigned)grid, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)bands, pa, pb,
      total, (int32_t*)out);
  return (int)cudaGetLastError();
}
