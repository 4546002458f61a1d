// Banded sorted-set membership over a batch of rows:
//   found[n, i] = exists j: |a[n, i] - b[n, j]| <= bands[n]
// with b ascending within each row; a entries equal to INT32_MAX (the
// padding sentinel) never match, and a negative band holds nothing.
//
// Replaces src/repro/kernels/intersect.py::banded_intersect_rows_pallas
// (_kernel_rows) and, with one row, banded_intersect_pallas.
//
// Bound: device memory, N * (5 * Pa + 4 * Pb) bytes at most (a read, found
// written, b read once); chip_smoke.py's `band_bound` counts only the
// sectors of b that the answers depend on.  That bound is far below what
// any launch takes: the kernel is latency, a chain of dependent trips to
// device memory per a element, and a launch.
//
// The TPU kernel compares dense tiles of a against every in-range tile of
// b.  Here a thread owns one a element and finds the first b >= a - band;
// it hits iff that b exists and b <= a + band.  The first kernel ran that
// lower-bound search over its row in device memory, one thread per a and
// 256 to a CTA: log2(Pb) dependent loads (7 at the recorded Pb = 128, 14
// at 16384), of which only the first few are shared by a CTA's threads,
// so a slice with few live a pays most of them as trips to device memory.
//
// Design: a CTA of 128 threads covers one slice of 128 a elements of one
// row (grid: rows x slices, flat).  The wrapper picks one of two regimes
// from Pb alone (kernels/intersect.py::row_plan); both copy by cp.async
// (csrc/row_search.cuh), every copy in flight beside each thread's load of
// its a and the band, with one wait:
//   * row staged, Pb <= ROW_STAGE_KEYS (512 keys, 2 KB): the CTA copies
//     its whole row of b into shared memory, by 16-byte copies where the
//     row sits on 16 bytes, and each thread's lower bound of a - band runs
//     there.  One dependent trip per a element.
//   * fenced, above: each warp copies min delta's 16-key fence of the row
//     (fence_stride) into its own shared memory, one key a lane, and waits
//     for its own copies alone; each thread counts the fence keys below
//     a - band, answers at once where the next fence key lies in the band
//     (a hit) or the row's first key lies above it (a miss), and otherwise
//     searches the one segment of Pb / 16 entries in device memory:
//     log2(Pb) - 4 dependent loads after the first trip.
// Why these, and 512: per Pb class of the main path's calls (the largest
// call of each class, both engines; `chip_smoke.py --ab-kernels`, PERF.md)
// the staged row was the fastest way at every class up to 512 keys, and
// from 1024 up it lost where the ordinary engine's 1792 to 3584 slices
// copy 7 to 15 MB of rows.  Min delta's sub-fence and 64-entry window,
// tried above the threshold, cost more than the device-memory steps they
// save (a window per live a, and their 45 KB of shared memory cut the CTAs
// an SM holds to five).  A fence shared by the CTA made every warp wait
// for the slowest one's copies: on the ordinary engine's widest, densest
// calls (Pb 8192 to 32768, up to 845,000 live a) that cost 10-15% against
// the first kernel, whose top probes are L1 hits shared by all threads;
// the warp's own fence does not wait for other warps.
// Duplicate keys need no care: the counts and the lower bounds are strict
// (keys < a - band), so a run across the staged row's end, fence keys or
// segment edges is found from its first entry.  A slice whose a entries
// are all sentinels writes zeros.  The bounds are taken in 64 bits,
// because INT32_MAX + band wraps in 32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_search.cuh"

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxStaged = 12288;   // 48 KB: no shared-memory opt-in

constexpr int kMaxWarpFence = 32;         // a warp's lanes

// shared memory: the staged row (rounded up to 16 bytes), or each warp's
// fence
long long smem_bytes(long long pb, long long stride) {
  return stride == 0 ? (pb + 3) / 4 * 16 : kThreads / 32 * kMaxWarpFence * 4;
}

template <bool STAGED, bool VEC4>
__global__ void __launch_bounds__(kThreads)
banded_intersect_rows_kernel(const int32_t* __restrict__ a,
                             const int32_t* __restrict__ b,
                             const int32_t* __restrict__ bands, long long pa,
                             long long pb, long long stride,
                             long long slices, uint8_t* __restrict__ found) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long row = blockIdx.x / slices;
  const long long i = (blockIdx.x - row * slices) * kThreads + threadIdx.x;
  const int32_t* br = b + row * pb;
  const bool in = i < pa;
  // a, the band and the row (or its fence), all in flight together
  const int32_t av32 = in ? __ldg(a + row * pa + i) : INT32_MAX;
  const int32_t band32 = __ldg(bands + row);
  int32_t* keys = reinterpret_cast<int32_t*>(smem);   // the row or fence
  const int nf = STAGED ? 0 : rowsearch::fence_keys(pb, stride);
  if constexpr (STAGED) {
    rowsearch::copy_row<VEC4, kThreads>(keys, br, pb);
    rowsearch::cp_async_wait_all();
    __syncthreads();
  } else {
    keys += threadIdx.x / 32 * 32;         // the warp's own fence
    rowsearch::copy_warp_fence(keys, br, nf, stride);
    rowsearch::cp_async_wait_all();
    __syncwarp();
  }
  if (!in) return;
  const long long o = row * pa + i;
  if (av32 == INT32_MAX || band32 < 0) {
    found[o] = 0;
    return;
  }
  const long long lo_key = (long long)av32 - band32;
  const long long hi_key = (long long)av32 + band32;
  if constexpr (STAGED) {
    const int j = rowsearch::lower_bound(keys, (int)pb, lo_key);
    found[o] = j < pb && (long long)keys[j] <= hi_key;
    return;
  }

  // the fence: the first entry >= lo_key is in [L, R]
  const int c = rowsearch::fence_count(keys, nf, lo_key);
  if (c < nf && (long long)keys[c] <= hi_key) {
    found[o] = 1;                          // a fence key in the band
    return;
  }
  if (c == 0 && nf > 0) {
    found[o] = 0;                          // every key lies above the band
    return;
  }
  long long L, R;
  rowsearch::fence_segment(c, nf, stride, pb, L, R);
  // the rest of the search in device memory, inside the segment
  rowsearch::binary_steps(br, lo_key, L, R, 1);
  found[o] = L < pb && (long long)__ldg(br + L) <= hi_key;
}

template <bool STAGED, bool VEC4>
int launch_kernel(const int32_t* a, const int32_t* b, const int32_t* bands,
                  long long n_rows, long long pa, long long pb,
                  long long stride, uint8_t* found, cudaStream_t stream) {
  const long long slices = (pa + kThreads - 1) / kThreads;
  const long long smem = smem_bytes(pb, stride);
  banded_intersect_rows_kernel<STAGED, VEC4>
      <<<(unsigned)(n_rows * slices), kThreads, (size_t)smem, stream>>>(
          a, b, bands, pa, pb, stride, slices, found);
  return (int)cudaGetLastError();
}

// 0 when the plan is one the kernel takes: stride 0 (the staged row) with
// pb <= kMaxStaged, or a power of two >= 32 with at most kMaxWarpFence
// fence keys
bool plan_ok(long long n_rows, long long pa, long long pb, long long stride) {
  const long long slices = (pa + kThreads - 1) / kThreads;
  if (n_rows < 1 || pa < 1 || pb < 0 || n_rows * slices > 0x7fffffffLL)
    return false;
  if (stride == 0) return pb <= kMaxStaged;
  return stride >= 32 && (stride & (stride - 1)) == 0 &&
         (pb + stride - 1) / stride <= kMaxWarpFence;
}

}  // namespace

// stride: 0 stages the whole row in shared memory, else the fence stride
// (kernels/intersect.py::row_plan).  A plan the kernel does not take
// returns cudaErrorInvalidValue without a launch.
extern "C" int banded_intersect_rows_launch(const void* a, const void* b,
                                            const void* bands, long long n_rows,
                                            long long pa, long long pb,
                                            long long stride, void* found,
                                            void* stream) {
  if (!plan_ok(n_rows, pa, pb, stride)) return (int)cudaErrorInvalidValue;
  const int32_t *ai = (const int32_t*)a, *bi = (const int32_t*)b,
                *wi = (const int32_t*)bands;
  uint8_t* f = (uint8_t*)found;
  cudaStream_t s = (cudaStream_t)stream;
  if (stride == 0)
    return rowsearch::rows_vec4(b, pb)
               ? launch_kernel<true, true>(ai, bi, wi, n_rows, pa, pb, 0, f, s)
               : launch_kernel<true, false>(ai, bi, wi, n_rows, pa, pb, 0, f, s);
  return launch_kernel<false, false>(ai, bi, wi, n_rows, pa, pb, stride, f, s);
}

// The design facts of the kernel that rows of width pb launch with the
// plan's stride (0: the staged row): out[0] threads per CTA, out[1]
// registers per thread, out[2] local (spill) bytes per thread, out[3]
// dynamic shared memory bytes, out[4] 1 where the row is copied in 16-byte
// chunks (staged, pb a multiple of 4 and rows on 16 bytes, as the
// executor's tensors are).
extern "C" int banded_intersect_rows_info(long long pb, long long stride,
                                          long long* out) {
  if (!plan_ok(1, 1, pb, stride)) return (int)cudaErrorInvalidValue;
  const bool staged = stride == 0;
  out[0] = kThreads;
  out[3] = smem_bytes(pb, stride);
  out[4] = staged && pb % 4 == 0;
  if (staged)
    return out[4] ? hopper::kernel_attrs(banded_intersect_rows_kernel<true, true>,
                                         out + 1, out + 2)
                  : hopper::kernel_attrs(banded_intersect_rows_kernel<true, false>,
                                         out + 1, out + 2);
  return hopper::kernel_attrs(banded_intersect_rows_kernel<false, false>,
                              out + 1, out + 2);
}
