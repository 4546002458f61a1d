// Banded minimum delta over a batch of rows (the proximity-scoring twin of
// the banded intersection):
//   out[n, i] = min over j with |a[n, i] - bk[n, j]| <= bands[n]
//               of |a[n, i] - bk[n, j]| + bd[n, j]
// and INT32_MAX when no such j exists or a[n, i] is the INT32_MAX padding
// sentinel.  bk is ascending within each row (the (key, delta) composite
// order of the batch executor), with runs of equal keys, and bd >= 0; the
// order of bd inside a run of equal keys is not relied on, and neither is
// any order of a along its row (the executor's a rows are doc-shard
// segments of keys with sentinels between them).
//
// Replaces src/repro/kernels/intersect.py::banded_min_delta_rows_pallas
// (_kernel_rows_min_delta).  Like that kernel, and unlike the reference's
// two-probe `implementation="ref"` path, it computes the general minimum:
// rows with band > 0 may carry non-zero deltas.
//
// Bound: device memory, N * (8 * Pa + 8 * Pb) bytes at most (a read and
// out written, bk and bd read once); chip_smoke.py's `band_bound` counts
// only the sectors of b that the answers depend on.  That bound is far
// below what any launch takes: the kernel is latency, a chain of dependent
// trips to device memory per a element.
//
// What held the first kernel back: a lower-bound binary search of
// a - band over its row of bk in device memory, ~14 dependent loads at
// Pb = 16384 (only the first few mids shared by a row's threads), then a
// walk that loaded bd.
//
// Design: a CTA of 128 threads covers one slice of 128 a elements of one
// row (grid: rows x slices, flat).  Every load of the search goes by
// cp.async into shared memory: a copy has no register to wait on, so all
// the copies of a round are in flight before the one wait (register loads
// of a round were scheduled one or two at a time, each beside the compare
// that used it).  Steps 1-3's search is csrc/row_search.cuh's, shared
// with intersect.cu and delta_mask.cu.
//   1. The fence.  The CTA copies every s-th key of its row,
//      fence[k] = bk[k * s], into shared memory, all in flight beside each
//      thread's load of its a and band (and a prefetch of bd's page).  s
//      comes from kernels/intersect.py::fence_stride: 16 keys a row (s =
//      1024 at Pb = 16384), because each fence key is a sector of its own
//      and a denser fence cost more than the trip it saves.  No fence when
//      Pb <= s.
//   2. The search.  Each thread counts the fence keys below a - band in
//      shared memory; the first entry >= a - band then lies in one
//      s-entry segment.  When every key lies above the band, the answer
//      is known here.  A segment longer than the window is cut by a
//      sub-fence: each thread copies up to kSub = 16 keys of its segment at
//      stride s2 = s / 16 (at least W) in one round; a longer one (Pb over
//      2^14 * 16) then takes binary steps in device memory down to W.
//   3. The window.  W = 64 entries of bk and of bd from the segment's
//      start (aligned down to 16 bytes, 16-byte copies where the rows
//      allow it) come in one round into this thread's column of shared
//      memory, and the minimum over the in-band entries among them is
//      taken there.  Entries before the window lie below a - band.
//   4. The walk.  Only when the window's last key is still in band does
//      the first kernel's walk go on past it, with its early stop: once
//      bk[j] >= a and bk[j] - a >= the minimum, no later entry can win
//      (bd >= 0).
// Dependent trips to device memory per a element at the main path's
// Pb = 16384: three (the fence beside a, the sub-fence, the window),
// where the first kernel took ~15; a live a element that the fence
// already answers takes one.  Equal-key runs across fence keys and
// segment edges need no care: the counts are strict (keys < a - band),
// entries before the window are all below the band, and the window's
// minimum takes every in-band entry whatever its place in a run.
// The bounds are taken in 64 bits, because INT32_MAX + band wraps in 32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_search.cuh"

namespace {

using rowsearch::kMaxFence;
using rowsearch::kSub;
using rowsearch::W;
constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

// |a - k| + d into best when |a - k| <= band, branch-free in 32 bits:
// the key distance is exact as an unsigned difference, at most band <=
// INT32_MAX, and with d in [0, INT32_MAX] the cost cannot wrap; best
// starts at INT32_MAX, so it never leaves the int32 range
__device__ __forceinline__ void take(bool ok, int32_t k, int32_t d, int32_t av,
                                     uint32_t band, uint32_t& best) {
  const uint32_t kd = k >= av ? (uint32_t)k - (uint32_t)av
                              : (uint32_t)av - (uint32_t)k;
  const uint32_t c = kd + (uint32_t)d;
  best = ok && kd <= band && c < best ? c : best;
}

// shared memory: the fence; each thread's sub-fence as [kSub][kThreads]
// int32; each thread's window of bk and of bd as [W / 4][kThreads] int4
// (entry 4q + e of thread t at [q][t].e), so that a warp's reads of one
// k or q touch consecutive words
constexpr int smem_bytes() {
  return kMaxFence * 4 + kSub * kThreads * 4 + 2 * (W / 4) * kThreads * 16;
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
banded_min_delta_rows_kernel(const int32_t* __restrict__ a,
                             const int32_t* __restrict__ bk,
                             const int32_t* __restrict__ bd,
                             const int32_t* __restrict__ bands, long long pa,
                             long long pb, long long stride,
                             long long slices, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* fence = reinterpret_cast<int32_t*>(smem);
  int32_t* sub = reinterpret_cast<int32_t*>(smem + kMaxFence * 4);
  int4* win_k = reinterpret_cast<int4*>(smem + kMaxFence * 4 +
                                         kSub * kThreads * 4);
  int4* win_d = win_k + (W / 4) * kThreads;
  const long long row = blockIdx.x / slices;
  const long long i = (blockIdx.x - row * slices) * kThreads + threadIdx.x;
  const int32_t* kr = bk + row * pb;
  const int32_t* dr = bd + row * pb;
  const bool in = i < pa;
  // 1. a, the band and the fence keys, all in flight together
  const int32_t av32 = in ? __ldg(a + row * pa + i) : INT32_MAX;
  const int32_t band32 = __ldg(bands + row);
  // bd's page, so that the window's copies of it find its translation
  if (threadIdx.x == 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(dr));
  const int nf = rowsearch::fence_keys(pb, stride);
  rowsearch::copy_fence<kThreads>(fence, kr, nf, stride);
  rowsearch::cp_async_wait_all();
  __syncthreads();
  if (!in) return;
  if (av32 == INT32_MAX || band32 < 0) {    // a negative band holds nothing
    out[row * pa + i] = INT32_MAX;
    return;
  }
  const long long av = av32;
  const long long band = band32;
  const long long lo_key = av - band;
  const long long hi_key = av + band;

  // 2. the fence: c = fence keys < lo_key; the first entry >= lo_key is
  // in [L, R] (bk[L - 1] < lo_key, and R == pb or bk[R] >= lo_key)
  const int c = rowsearch::fence_count(fence, nf, lo_key);
  if (c == 0 && nf > 0 && (long long)fence[0] > hi_key) {
    out[row * pa + i] = INT32_MAX;         // every key lies above the band
    return;
  }
  long long L, R;
  rowsearch::fence_segment(c, nf, stride, pb, L, R);
  // the sub-fence, then binary steps only where s2 > W
  rowsearch::sub_fence<kThreads>(sub, kr, stride, lo_key, L, R);
  rowsearch::binary_steps(kr, lo_key, L, R, W);

  // 3. the window [ws, ws + W): one round of copies into this thread's
  // column of shared memory (bk and bd interleaved: two loops of copies
  // read 4% slower), then the in-band minimum over it
  const long long ws = VEC4 ? (L & ~3LL) : L;
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    int4* kq = win_k + q * kThreads + threadIdx.x;
    int4* dq = win_d + q * kThreads + threadIdx.x;
    if constexpr (VEC4) {
      if (ws + 4 * q < pb) {
        rowsearch::cp_async16(kq, kr + ws + 4 * q);
        rowsearch::cp_async16(dq, dr + ws + 4 * q);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ws + 4 * q + e < pb) {
          rowsearch::cp_async4(reinterpret_cast<int32_t*>(kq) + e,
                               kr + ws + 4 * q + e);
          rowsearch::cp_async4(reinterpret_cast<int32_t*>(dq) + e,
                               dr + ws + 4 * q + e);
        }
      }
    }
  }
  rowsearch::cp_async_wait_all();          // this thread's own copies
  uint32_t best32 = INT32_MAX;
  long long last = 0;                      // bk[ws + W - 1] when it exists
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const int4 k4 = win_k[q * kThreads + threadIdx.x];
    const int4 d4 = win_d[q * kThreads + threadIdx.x];
    const long long j = ws + 4 * q;
    take(j < pb, k4.x, d4.x, av32, band32, best32);
    take(j + 1 < pb, k4.y, d4.y, av32, band32, best32);
    take(j + 2 < pb, k4.z, d4.z, av32, band32, best32);
    take(j + 3 < pb, k4.w, d4.w, av32, band32, best32);
    if (q == W / 4 - 1) last = k4.w;
  }
  long long best = best32;

  // 4. the walk past the window, while keys stay in band
  if (ws + W < pb && last <= hi_key && !(last >= av && last - av >= best)) {
    for (long long j = ws + W; j < pb; ++j) {
      const long long k = __ldg(kr + j);
      if (k > hi_key) break;
      if (k < lo_key) continue;            // up to 3: the window is aligned
      const long long kd = k >= av ? k - av : av - k;
      if (k >= av && kd >= best) break;    // later entries cost >= kd
      best = min(best, kd + (long long)__ldg(dr + j));
    }
  }
  out[row * pa + i] = (int32_t)best;
}

template <bool VEC4>
int launch_kernel(const int32_t* a, const int32_t* bk, const int32_t* bd,
                  const int32_t* bands, long long n_rows, long long pa,
                  long long pb, long long stride, int32_t* out,
                  cudaStream_t stream) {
  auto kernel = banded_min_delta_rows_kernel<VEC4>;
  constexpr int smem = smem_bytes();
  // the shared-memory opt-in, once per device (a runtime call per launch
  // would cost the main path's 400-odd launches a batch)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const long long slices = (pa + kThreads - 1) / kThreads;
  kernel<<<(unsigned)(n_rows * slices), kThreads, smem, stream>>>(
      a, bk, bd, bands, pa, pb, stride, slices, out);
  return (int)cudaGetLastError();
}

}  // namespace

// stride: the fence stride, a power of two >= 32 with at most kMaxFence
// fence keys (kernels/intersect.py::fence_stride).  Anything else returns
// cudaErrorInvalidValue without a launch.
extern "C" int banded_min_delta_rows_launch(const void* a, const void* bk,
                                            const void* bd, const void* bands,
                                            long long n_rows, long long pa,
                                            long long pb, long long stride,
                                            void* out, void* stream) {
  const long long slices = (pa + kThreads - 1) / kThreads;
  if (n_rows < 1 || pa < 1 || pb < 0 || stride < 32 ||
      (stride & (stride - 1)) != 0 || (pb + stride - 1) / stride > kMaxFence ||
      n_rows * slices > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int32_t *ai = (const int32_t*)a, *ki = (const int32_t*)bk,
                *di = (const int32_t*)bd, *bi = (const int32_t*)bands;
  cudaStream_t s = (cudaStream_t)stream;
  if (rowsearch::rows_vec4(bk, pb) && rowsearch::rows_vec4(bd, pb))
    return launch_kernel<true>(ai, ki, di, bi, n_rows, pa, pb, stride,
                               (int32_t*)out, s);
  return launch_kernel<false>(ai, ki, di, bi, n_rows, pa, pb, stride,
                              (int32_t*)out, s);
}

// The design facts of the kernel that rows of width pb launch: out[0]
// threads per CTA, out[1] registers per thread, out[2] local (spill)
// bytes per thread, out[3] dynamic shared memory bytes (the fence, the
// sub-fences and the windows), out[4] window entries W, out[5] sub-fence
// keys per thread at most, out[6] 1 where the window is copied in 16-byte
// chunks (pb a multiple of 4 and rows on 16 bytes, as the executor's
// tensors are).
extern "C" int banded_min_delta_rows_info(long long pb, long long* out) {
  out[0] = kThreads;
  out[3] = smem_bytes();
  out[4] = W;
  out[5] = kSub;
  out[6] = pb % 4 == 0;
  return out[6] ? hopper::kernel_attrs(banded_min_delta_rows_kernel<true>,
                                       out + 1, out + 2)
                : hopper::kernel_attrs(banded_min_delta_rows_kernel<false>,
                                       out + 1, out + 2);
}
