// Signed-delta bitmask over a batch of rows (the K-word join twin of the
// banded intersection), and its window scan, in one launch:
//   mask[n, i] bit (d + bands[n]) is set iff some b[n, j] == a[n, i] + d,
//     for each d with |d| <= bands[n] and |d| <= 15,
//   t_bits[n, i] bit t is set iff ((mask[n, i] >> t) & low(W + 1)) != 0
//     for t <= W = windows[n] (t <= 15),
// and both are 0 where a[n, i] is the INT32_MAX padding sentinel.  b is
// ascending within each row.  The plan's bands are <= 15
// (KW_DEVICE_MAX_WINDOW), so bit indices stay <= 30; like the plain
// version, a wider band clips its bit index to 31 and still walks only
// |d| <= 15, and a negative band holds nothing.
//
// Replaces src/repro/kernels/intersect.py::banded_delta_mask_rows_pallas
// (_kernel_rows_delta_mask), and with its epilogue the reference's
// `ops.delta_mask_t_bits`, which XLA fuses into the K-word bucket's one
// program (eager PyTorch ran it as ~8 launches for each of 16 shifts per
// constraint group).
//
// Bound: device memory, N * (12 * Pa + 4 * Pb) bytes at most (a read, mask
// and t_bits written, b read once); chip_smoke.py's `band_bound` counts
// only the sectors of b that the answers depend on.  The kernel is
// latency: a chain of dependent trips to device memory per a element.
//
// The TPU kernel builds the mask from dense tile-pair compares and an
// OR-reduction.  Here a thread owns one a element: it finds the first
// b >= a - w (w = min(band, 15)), then walks forward while b <= a + w,
// ORing in one bit per entry (`1u << k`: a signed 1 << 31 is undefined).
// The first kernel did both in device memory, one thread per a and 256 to
// a CTA: log2(Pb) dependent loads of its lower-bound search (14 at the
// recorded Pb = 16384), then the walk.
//
// Design: a CTA of 128 threads covers one slice of 128 a elements of one
// row (grid: rows x slices, flat), with intersect.cu's two regimes (the
// wrapper picks one from Pb alone, kernels/intersect.py::row_plan), every
// copy by cp.async (csrc/row_search.cuh) in flight beside each thread's
// load of its a, the band and the window, with one wait:
//   * row staged, Pb <= ROW_STAGE_KEYS (512 keys): the whole row of b in
//     shared memory; the search and the walk run there.  One dependent
//     trip per a element.
//   * fenced, above: each warp's own copy of min delta's 16-key fence in
//     shared memory (intersect.cu's); a row whose first key lies above
//     the band holds nothing, and otherwise the search of the fence's one
//     segment and the walk run in device memory (the walk's entries share
//     the search's last lines).  At the recorded Pb = 16384: the fence's
//     trip, then 10 dependent loads where the first kernel took 14.
// Why: per Pb class of the main path's calls (`chip_smoke.py
// --ab-kernels`, PERF.md) the staged row was the fastest way up to 1024
// keys, and the threshold is intersect.cu's: one plan for the two kernels,
// whose launches intersect's outnumber three to one and where staging lost
// from 1024 up.  Min delta's sub-fence and 64-entry window were tried
// above it (one-off builds on the card, not kept): copying the window and
// scanning it in 64-bit compares took longer than the device-memory steps
// it saved, and the sub-fence cost the dense rows more than it saved the
// sparse ones.
// The epilogue takes the mask from registers: one load of the row's window
// W beside its band, sixteen shifts where the mask is not 0 (most a are
// sentinels or hold nothing in the band), and a second int32 store.  Runs of
// duplicate keys are walked entry by entry (the rebased keys of a row
// repeat only where several unioned fetches hold the same posting); the
// counts of the search are strict, so a run across the staged row's end,
// fence keys or segment edges needs no care.  The bounds are taken in 64
// bits, because INT32_MAX + band wraps in 32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_search.cuh"

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxBand = 15;
constexpr long long kMaxStaged = 12288;   // 48 KB: no shared-memory opt-in

constexpr int kMaxWarpFence = 32;         // a warp's lanes

// shared memory: the staged row (rounded up to 16 bytes), or each warp's
// fence
long long smem_bytes(long long pb, long long stride) {
  return stride == 0 ? (pb + 3) / 4 * 16 : kThreads / 32 * kMaxWarpFence * 4;
}

// the bit of key k for anchor av: k - av + band, clipped to [0, 31]
__device__ __forceinline__ uint32_t bit_of(long long k, long long av,
                                           long long band) {
  long long bit = k - av + band;
  bit = bit < 0 ? 0 : (bit > 31 ? 31 : bit);
  return 1u << (unsigned int)bit;
}

// the reference's delta_mask_t_bits for one element: bit t (t <= 15) set
// iff t <= w and ((mask >> t) & low(w + 1)) != 0, the shift arithmetic on
// int32 and low() all ones from w = 31 up
__device__ __forceinline__ int32_t t_bits(uint32_t mask, int32_t w) {
  if (mask == 0u || w < 0) return 0;      // most a: sentinels and misses
  const int32_t low = w >= 31 ? -1 : (int32_t)((1u << (w + 1)) - 1u);
  int32_t bits = 0;
#pragma unroll
  for (int t = 0; t <= (int)kMaxBand; ++t)
    bits |= (t <= w && ((((int32_t)mask) >> t) & low) != 0) ? (1 << t) : 0;
  return bits;
}

template <bool STAGED, bool VEC4>
__global__ void __launch_bounds__(kThreads)
banded_delta_mask_rows_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              const int32_t* __restrict__ bands,
                              const int32_t* __restrict__ windows,
                              long long pa, long long pb, long long stride,
                              long long slices, int32_t* __restrict__ out,
                              int32_t* __restrict__ out_t) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long row = blockIdx.x / slices;
  const long long i = (blockIdx.x - row * slices) * kThreads + threadIdx.x;
  const int32_t* br = b + row * pb;
  const bool in = i < pa;
  // a, the band, the window and the row (or its fence), all in flight
  const int32_t av32 = in ? __ldg(a + row * pa + i) : INT32_MAX;
  const int32_t band32 = __ldg(bands + row);
  const int32_t win32 = __ldg(windows + row);
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
  const long long band = band32;
  const long long w = band < kMaxBand ? band : kMaxBand;
  uint32_t mask = 0u;
  if (av32 != INT32_MAX && w >= 0) {
    const long long av = av32;
    const long long lo_key = av - w;
    const long long hi_key = av + w;
    if constexpr (STAGED) {
      for (int j = rowsearch::lower_bound(keys, (int)pb, lo_key);
           j < pb && (long long)keys[j] <= hi_key; ++j)
        mask |= bit_of(keys[j], av, band);
    } else {
      const int c = rowsearch::fence_count(keys, nf, lo_key);
      // a row whose every key lies above the band holds nothing
      if (!(c == 0 && nf > 0 && (long long)keys[0] > hi_key)) {
        long long L, R;
        rowsearch::fence_segment(c, nf, stride, pb, L, R);
        // the rest of the search and the walk in device memory
        rowsearch::binary_steps(br, lo_key, L, R, 1);
        for (long long j = L; j < pb; ++j) {
          const long long k = __ldg(br + j);
          if (k > hi_key) break;
          mask |= bit_of(k, av, band);
        }
      }
    }
  }
  out[o] = (int32_t)mask;
  out_t[o] = t_bits(mask, win32);
}

template <bool STAGED, bool VEC4>
int launch_kernel(const int32_t* a, const int32_t* b, const int32_t* bands,
                  const int32_t* windows, long long n_rows, long long pa,
                  long long pb, long long stride, int32_t* out,
                  int32_t* out_t, cudaStream_t stream) {
  const long long slices = (pa + kThreads - 1) / kThreads;
  const long long smem = smem_bytes(pb, stride);
  banded_delta_mask_rows_kernel<STAGED, VEC4>
      <<<(unsigned)(n_rows * slices), kThreads, (size_t)smem, stream>>>(
          a, b, bands, windows, pa, pb, stride, slices, out, out_t);
  return (int)cudaGetLastError();
}

// the plans the kernel takes: intersect.cu's
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
extern "C" int banded_delta_mask_rows_launch(const void* a, const void* b,
                                             const void* bands,
                                             const void* windows,
                                             long long n_rows, long long pa,
                                             long long pb, long long stride,
                                             void* out, void* out_t,
                                             void* stream) {
  if (!plan_ok(n_rows, pa, pb, stride)) return (int)cudaErrorInvalidValue;
  const int32_t *ai = (const int32_t*)a, *bi = (const int32_t*)b,
                *di = (const int32_t*)bands, *wi = (const int32_t*)windows;
  int32_t *m = (int32_t*)out, *t = (int32_t*)out_t;
  cudaStream_t s = (cudaStream_t)stream;
  if (stride == 0)
    return rowsearch::rows_vec4(b, pb)
               ? launch_kernel<true, true>(ai, bi, di, wi, n_rows, pa, pb, 0,
                                           m, t, s)
               : launch_kernel<true, false>(ai, bi, di, wi, n_rows, pa, pb,
                                            0, m, t, s);
  return launch_kernel<false, false>(ai, bi, di, wi, n_rows, pa, pb, stride,
                                     m, t, s);
}

// The design facts of the kernel that rows of width pb launch with the
// plan's stride (0: the staged row), as banded_intersect_rows_info gives
// them: out[0] threads per CTA, out[1] registers per thread, out[2] local
// (spill) bytes per thread, out[3] dynamic shared memory bytes, out[4] 1
// where the row is copied in 16-byte chunks.
extern "C" int banded_delta_mask_rows_info(long long pb, long long stride,
                                           long long* out) {
  if (!plan_ok(1, 1, pb, stride)) return (int)cudaErrorInvalidValue;
  const bool staged = stride == 0;
  out[0] = kThreads;
  out[3] = smem_bytes(pb, stride);
  out[4] = staged && pb % 4 == 0;
  if (staged)
    return out[4]
               ? hopper::kernel_attrs(banded_delta_mask_rows_kernel<true, true>,
                                      out + 1, out + 2)
               : hopper::kernel_attrs(banded_delta_mask_rows_kernel<true, false>,
                                      out + 1, out + 2);
  return hopper::kernel_attrs(banded_delta_mask_rows_kernel<false, false>,
                              out + 1, out + 2);
}
