// The search of one ascending int32 row for its first entry >= a key,
// shared by the banded row kernels (intersect.cu, min_delta.cu,
// delta_mask.cu).  Its rounds of loads go by cp.async into shared memory:
// a copy has no register to wait on, so all the copies of a round are in
// flight before its one wait (register loads of a round were scheduled one
// or two at a time, each beside the compare that used it).
//
// The pieces:
//   * the staged row (`copy_row`, `lower_bound`; intersect and delta mask
//     at Pb <= ROW_STAGE_KEYS, kernels/intersect.py::row_plan): the CTA
//     copies its whole row into shared memory in one round and each
//     thread searches it there;
//   * the fence (`copy_fence` for the CTA in min delta, `copy_warp_fence`
//     for each warp in intersect and delta mask, `fence_count`,
//     `fence_segment`): every s-th key of the row (fence[k] = row[k * s],
//     kernels/intersect.py::fence_stride) in shared memory; each thread
//     counts the fence keys below its key, which leaves one s-entry
//     segment;
//   * in that segment `binary_steps` in device memory, to the entry
//     (intersect, delta mask) or, in min delta, after its `sub_fence` (up
//     to kSub keys of a segment of W entries or more, at stride s2 =
//     max(s / kSub, W), copied by the thread in one round) down to W
//     entries, which min delta copies into shared memory as its window.
// The counts are strict (keys < the searched key), so runs of equal keys
// across fence keys, sub-fence keys and segment edges need no care.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rowsearch {

constexpr int kMaxFence = 1024;   // fence keys a row at most
constexpr int kSub = 16;          // sub-fence keys a thread loads at most
constexpr int W = 64;             // min delta's window entries

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the fence keys of a row of pb keys at stride s (none when pb <= s)
__host__ __device__ __forceinline__ int fence_keys(long long pb,
                                                   long long stride) {
  return pb > stride ? (int)((pb + stride - 1) / stride) : 0;
}

// thread t copies fence keys t, t + kThreads, ... of the row kr
template <int kThreads>
__device__ __forceinline__ void copy_fence(int32_t* fence, const int32_t* kr,
                                           int nf, long long stride) {
#pragma unroll
  for (int q = 0; q < kMaxFence / kThreads; ++q) {
    const int k = threadIdx.x + q * kThreads;
    if (k < nf) cp_async4(fence + k, kr + k * stride);
  }
}

// the warp's own copy of a fence of at most 32 keys: lane l copies fence
// key l, so the warp waits for its own copies alone (`__syncwarp`), where
// a fence shared by the CTA waits for its slowest warp (`__syncthreads`)
__device__ __forceinline__ void copy_warp_fence(int32_t* fence,
                                                const int32_t* kr, int nf,
                                                long long stride) {
  const int l = threadIdx.x % 32;
  if (l < nf) cp_async4(fence + l, kr + l * stride);
}

// the fence keys < key: a lower bound over the fence in shared memory
__device__ __forceinline__ int fence_count(const int32_t* fence, int nf,
                                           long long key) {
  int c = 0, hi = nf;
  while (c < hi) {
    const int mid = (c + hi) >> 1;
    if ((long long)fence[mid] < key) c = mid + 1; else hi = mid;
  }
  return c;
}

// the segment [L, R] that holds the row's first entry >= key, from the
// fence count c: row[L - 1] < key, and R == pb or row[R] >= key
__device__ __forceinline__ void fence_segment(int c, int nf, long long stride,
                                              long long pb, long long& L,
                                              long long& R) {
  L = c == 0 ? 0 : (long long)(c - 1) * stride + 1;
  R = c == nf ? pb : (long long)c * stride;
}

// cuts a segment of W entries or more with up to kSub keys of it at
// stride s2 inside (L - 1, R), copied in one round into this thread's
// column of sub ([kSub][kThreads] int32): those below key move L up, the
// first at or above it moves R down
template <int kThreads>
__device__ __forceinline__ void sub_fence(int32_t* sub, const int32_t* kr,
                                          long long stride, long long key,
                                          long long& L, long long& R) {
  const long long s2 = stride / kSub > W ? stride / kSub : W;
  if (R - L < W) return;
  int n_sub = 0;
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    const long long q = L - 1 + (k + 1) * s2;
    if (q < R) {
      cp_async4(sub + k * kThreads + threadIdx.x, kr + q);
      n_sub = k + 1;
    }
  }
  cp_async_wait_all();
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kSub; ++k)
    cnt += k < n_sub && (long long)sub[k * kThreads + threadIdx.x] < key;
  const long long L0 = L;
  if (cnt > 0) L = L0 - 1 + cnt * s2 + 1;
  if (cnt < n_sub) R = L0 - 1 + (cnt + 1) * s2;
}

// binary steps in device memory while the segment [L, R] holds `until`
// entries or more: until = W leaves it to a window, until = 1 ends at the
// first entry >= key (L == R)
__device__ __forceinline__ void binary_steps(const int32_t* kr, long long key,
                                             long long& L, long long& R,
                                             long long until) {
  while (R - L >= until) {
    const long long mid = (L + R) >> 1;
    if ((long long)__ldg(kr + mid) < key) L = mid + 1; else R = mid;
  }
}

// the whole row kr of pb keys into dst, one round of copies shared by the
// CTA's threads: 16-byte ones with VEC4 (the row on 16 bytes, pb a
// multiple of 4), else 4-byte ones
template <bool VEC4, int kThreads>
__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* kr,
                                         long long pb) {
  if constexpr (VEC4) {
    for (long long q = threadIdx.x; q < pb / 4; q += kThreads)
      cp_async16(dst + 4 * q, kr + 4 * q);
  } else {
    for (long long q = threadIdx.x; q < pb; q += kThreads)
      cp_async4(dst + q, kr + q);
  }
}

// the first j in [0, n) with row[j] >= key (n when none), row in shared
// memory
__device__ __forceinline__ int lower_bound(const int32_t* row, int n,
                                           long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)row[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// rows of pb keys starting at p take 16-byte copies
inline bool rows_vec4(const void* p, long long pb) {
  return pb % 4 == 0 && (uintptr_t)p % 16 == 0;
}

}  // namespace rowsearch
