// EmbeddingBag: out[b, :] = sum over f of w[b, f] * table[ids[b, f], :],
// float32 accumulation, ids of -1 (any negative id) are padding.
//
// Replaces src/repro/kernels/segment_bag.py::segment_bag_pallas (the
// wrapper's mean and cast stay in Python: kernels/ops.py::segment_bag).
//
// Bound: device memory.  Per bag the kernel reads F int32 ids (and F
// weights when given), the table rows they name and writes D float32
// sums; one multiply-add per (b, f, d) is nothing beside it.  The rows are
// a gather: with Zipf-skewed ids most of them repeat and hit L1 / L2, so
// the bytes that must come from memory are the 32-byte sectors of the
// distinct rows plus the ids, weights and output (chip_smoke.py,
// `bag_bound`).  At FM's serve_bulk shape the ids are 40.9 MB of the
// bound's 66 MB.
//
// What held the first kernel back, at 18% of its bound: one
// thread per output element, so all D threads of a bag loaded all F of
// its ids from device memory, and each field was an id load followed by
// a table load that depended on it, one pair in flight per thread.
//
// Design:
//   * A CTA owns a tile of `bags` consecutive bags (kernels/segment_bag.py
//     ::bag_tile plans it).  Their ids are one contiguous run of bags * F
//     int32 values, and so are their weights: all threads stage them into
//     shared memory with 16-byte cp.async copies (the run's unaligned head
//     and tail by plain loads; the run keeps its offset mod 16 in shared
//     memory, so a view whose pointer is not 16-byte aligned works).  Each
//     id comes from device memory once per bag, not once per column.
//     Where bags * F would pass the shared-memory budget, the fields go in
//     stages of `fields` (a rectangle copied element by element).
//   * Threads over (bag, column group): a thread owns VEC neighbouring
//     columns of one bag (VEC 1, 2 or 4, one load of the row each),
//     neighbouring threads own neighbouring groups, so a row's sectors are
//     read together; grid.y covers D beyond `groups` groups.  For each run
//     of kU = 8 fields a thread reads 8 ids from shared memory, clamps
//     them, issues the 8 independent row loads (a pad loads nothing) and
//     only then multiplies and adds them in field order: 8 row loads in
//     flight per thread where the first kernel had one dependent pair.  A
//     row's address is the clamped id times the row's bytes (both 32-bit)
//     widened onto the thread's first column (a 64-bit pointer), so tables
//     of any size work.  64-bit index arithmetic on long long ids and
//     columns took ~18 SASS instructions per field and thread; 32-bit
//     offsets from the table's base would limit tables to 4 GiB for ~5%
//     on the instruction-bound shapes and nothing measurable at FM's
//     serve_bulk (PERF.md).
//   * L2 policies: the ids are copied with evict-first (read once), the
//     rows loaded with evict-last (hot rows are read again by later bags).
//   * The multiply and the add are rounded apart (__fmul_rn / __fadd_rn: no
//     contraction to an FMA), and each column's sum runs f = 0 .. F-1, so
//     the sums equal the plain version's (ops.segment_bag_plain) bit for
//     bit, weighted or not.
//   * D = 1 (FM's linear term) is the same kernel with one thread per bag.
//
// What holds it back (PERF.md): at FM's serve_bulk shape, staging the
// ids and writing the sums alone take about half of the kernel's time on
// chip_smoke.py's timer (which flushes L2 with writes), and the Zipf tail
// (~20% of the 10.2 M row reads miss L1) is served from L2 at 64 B a 40-B
// row.  More loads in flight (kU = 16), a thread per row, a persistent
// double-buffered tile walk and a larger L1 carveout measured no faster.
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

#include "hopper.cuh"

namespace {

constexpr int kU = 8;              // table loads in flight per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// L2 policies: the staged ids are read once (evict first), the table's
// rows are what later bags read again (evict last)
__device__ __forceinline__ uint64_t l2_policy_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// 4, 8 or 16 bytes of a row through the read-only path with L2 policy pol
__device__ __forceinline__ uint32_t ld_row(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm volatile("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint2 ld_row(const uint2* p, uint64_t pol) {
  uint2 v;
  asm volatile("ld.global.nc.L2::cache_hint.v2.b32 {%0, %1}, [%2], %3;"
               : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint4 ld_row(const uint4* p, uint64_t pol) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint16_t ld_row(const uint16_t* p, uint64_t pol) {
  uint16_t v;
  asm volatile("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
               : "=h"(v) : "l"(p), "l"(pol));
  return v;
}

// row + a * b, the 32-bit product widened to 64 bits (ptxas: a wide
// multiply and a 64-bit add; C's product of the zero-extended operands
// compiled to an add of a zero high half and register copies as well)
__device__ __forceinline__ const char* mad_wide(uint32_t a, uint32_t b,
                                                const char* row) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;"
      : "=l"(r) : "r"(a), "r"(b), "l"(reinterpret_cast<uint64_t>(row)));
  return reinterpret_cast<const char*>(r);
}

__device__ __forceinline__ float2 bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// VEC neighbouring elements of a row as float32, one load
template <int VEC>
__device__ __forceinline__ void load_cols(const float* p, uint64_t pol,
                                          float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __uint_as_float(ld_row(reinterpret_cast<const uint32_t*>(p), pol));
  } else if constexpr (VEC == 2) {
    const uint2 v = ld_row(reinterpret_cast<const uint2*>(p), pol);
    x[0] = __uint_as_float(v.x), x[1] = __uint_as_float(v.y);
  } else {
    const uint4 v = ld_row(reinterpret_cast<const uint4*>(p), pol);
    x[0] = __uint_as_float(v.x), x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z), x[3] = __uint_as_float(v.w);
  }
}

template <int VEC>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, uint64_t pol,
                                          float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __uint_as_float((uint32_t)ld_row(reinterpret_cast<const uint16_t*>(p),
                                            pol) << 16);
  } else if constexpr (VEC == 2) {
    const float2 v = bf16x2(ld_row(reinterpret_cast<const uint32_t*>(p), pol));
    x[0] = v.x, x[1] = v.y;
  } else {
    const uint2 u = ld_row(reinterpret_cast<const uint2*>(p), pol);
    const float2 lo = bf16x2(u.x), hi = bf16x2(u.y);
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          hopper::smem_addr(smem)),
      "l"(gmem), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages the contiguous run src[0 .. n) into shared memory at the same
// offset mod 16 bytes as in device memory, so that its 16-byte aligned
// body goes by cp.async; the head before the first 16-byte boundary and
// the tail after the last go by plain loads.  `sm` is 16-byte aligned
// with room for n + 16 / sizeof(E) elements; returns where src[0] went.
// The caller waits (cp_async_wait_all) and syncs before reading.
template <typename E>
__device__ __forceinline__ const E* stage_run(E* sm, const E* src, int n) {
  constexpr int kPer = 16 / sizeof(E);
  const int pad = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(E));
  E* dst = sm + pad;
  const int head = min(n, (kPer - pad) % kPer);
  const int chunks = (n - head) / kPer;
  const int body_end = head + chunks * kPer;
  const uint64_t pol = l2_policy_first();
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(dst + head + c * kPer, src + head + c * kPer, pol);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = body_end + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  return dst;
}

// Stages fields [f0, f0 + fn) of `nb` bags whose rows are `F` apart into
// sm[b * fn + f], element by element (the tile's fields in more than one
// stage: no longer one run)
template <typename E>
__device__ __forceinline__ const E* stage_rect(E* sm, const E* src,
                                               long long F, int nb, int fn) {
  for (int i = threadIdx.x; i < nb * fn; i += blockDim.x) {
    const int b = i / fn, f = i - b * fn;
    sm[i] = src[(long long)b * F + f];
  }
  return sm;
}

// bytes of one staged plane of `bags * fields` elements of E, with the
// 16 bytes that stage_run's alignment may take, rounded to 16
template <typename E>
__host__ __device__ constexpr long long plane_bytes(long long bags,
                                                    long long fields) {
  return ((bags * fields * (long long)sizeof(E) + 16) + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ constexpr long long smem_bytes(long long bags,
                                                   long long fields,
                                                   bool weighted) {
  return plane_bytes<int32_t>(bags, fields) +
         (weighted ? plane_bytes<T>(bags, fields) : 0);
}

// One run of U fields of one bag for this thread's VEC columns: U ids
// from shared memory, U independent row loads (a pad loads nothing), then
// the products and the adds in field order.  A row's address is the
// clamped id times the row's bytes, 32 by 32 bits into 64 (one wide
// multiply-add), onto `tcol`, this thread's first column of row 0.
// FULL runs skip the check that a field lies inside the stage.
template <typename T, int VEC, int U, bool WEIGHTED, bool FULL>
__device__ __forceinline__ void bag_run(const char* tcol, uint32_t row_bytes,
                                        int vmax, uint64_t pol,
                                        const int32_t* my_ids, const T* my_w,
                                        int n, float (&acc)[VEC]) {
  float x[U][VEC];
  bool ok[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int id = FULL || u < n ? my_ids[u] : -1;
    ok[u] = id >= 0;
    if (ok[u])
      load_cols<VEC>(reinterpret_cast<const T*>(mad_wide(
                         (uint32_t)min(id, vmax), row_bytes, tcol)),
                     pol, x[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!ok[u]) continue;
    if constexpr (WEIGHTED) {
      const float w = to_float(my_w[u]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[u][v] = __fmul_rn(w, x[u][v]);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], x[u][v]);
  }
}

template <typename T, int VEC, bool WEIGHTED>
__global__ void __launch_bounds__(256)
segment_bag_kernel(const T* __restrict__ table, long long V, long long D,
                   const int32_t* __restrict__ ids,
                   const T* __restrict__ weights, long long B, long long F,
                   int bags, int fields, int groups,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem);
  T* s_w = reinterpret_cast<T*>(smem + plane_bytes<int32_t>(bags, fields));

  const long long b0 = (long long)blockIdx.x * bags;
  const int nb = (int)min((long long)bags, B - b0);
  const int bag = threadIdx.x / groups;
  const long long g = (long long)blockIdx.y * groups + threadIdx.x % groups;
  const bool active = bag < nb && g * VEC < D;
  const long long col = g * VEC;
  // row addresses: an id clamped to vmax times the row's bytes onto this
  // thread's first column of row 0
  const char* tcol = reinterpret_cast<const char*>(table + col);
  const uint32_t row_bytes = (uint32_t)(D * sizeof(T));
  const int vmax = (int)min(V - 1, (long long)INT32_MAX);
  const uint64_t pol = l2_policy_last();

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

  for (long long f0 = 0; f0 < F; f0 += fields) {
    const int fn = (int)min((long long)fields, F - f0);
    __syncthreads();                  // the previous stage's reads are done
    const int32_t* sid;
    const T* sw = nullptr;
    if (fn == F) {                    // the whole tile: one contiguous run
      sid = stage_run(s_ids, ids + b0 * F, nb * fn);
      if constexpr (WEIGHTED) sw = stage_run(s_w, weights + b0 * F, nb * fn);
    } else {
      sid = stage_rect(s_ids, ids + b0 * F + f0, F, nb, fn);
      if constexpr (WEIGHTED)
        sw = stage_rect(s_w, weights + b0 * F + f0, F, nb, fn);
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    const int32_t* my_ids = sid + bag * fn;
    const T* my_w = WEIGHTED ? sw + bag * fn : nullptr;
    int f = 0;
    for (; f + kU <= fn; f += kU)
      bag_run<T, VEC, kU, WEIGHTED, true>(tcol, row_bytes, vmax, pol,
                                          my_ids + f,
                                          WEIGHTED ? my_w + f : nullptr, kU,
                                          acc);
    if (f < fn)
      bag_run<T, VEC, kU, WEIGHTED, false>(tcol, row_bytes, vmax, pol,
                                           my_ids + f,
                                           WEIGHTED ? my_w + f : nullptr,
                                           fn - f, acc);
  }
  if (!active) return;
  float* o = out + (b0 + bag) * D + col;
  if constexpr (VEC == 1) {
    o[0] = acc[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <typename T, int VEC, bool WEIGHTED>
int launch_kernel(const void* table, long long V, long long D, const void* ids,
                  const void* weights, long long B, long long F, void* out,
                  int bags, int fields, int groups, int threads,
                  cudaStream_t stream) {
  auto kernel = segment_bag_kernel<T, VEC, WEIGHTED>;
  const long long smem = smem_bytes<T>(bags, fields, WEIGHTED);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_groups = D / VEC;
  const dim3 grid((unsigned)((B + bags - 1) / bags),
                  (unsigned)((n_groups + groups - 1) / groups));
  kernel<<<grid, threads, (size_t)smem, stream>>>(
      (const T*)table, V, D, (const int32_t*)ids, (const T*)weights, B, F,
      bags, fields, groups, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_vec(const void* table, long long V, long long D, const void* ids,
               const void* weights, long long B, long long F, void* out,
               int bags, int fields, int groups, int threads,
               cudaStream_t stream) {
  if (weights != nullptr)
    return launch_kernel<T, VEC, true>(table, V, D, ids, weights, B, F, out,
                                       bags, fields, groups, threads, stream);
  return launch_kernel<T, VEC, false>(table, V, D, ids, weights, B, F, out,
                                      bags, fields, groups, threads, stream);
}

template <typename T>
int launch_typed(const void* table, long long V, long long D, const void* ids,
                 const void* weights, long long B, long long F, void* out,
                 int bags, int fields, int groups, int threads, int vec,
                 cudaStream_t stream) {
  if ((uintptr_t)table % (vec * sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 1: return launch_vec<T, 1>(table, V, D, ids, weights, B, F, out, bags,
                                    fields, groups, threads, stream);
    case 2: return launch_vec<T, 2>(table, V, D, ids, weights, B, F, out, bags,
                                    fields, groups, threads, stream);
    case 4: return launch_vec<T, 4>(table, V, D, ids, weights, B, F, out, bags,
                                    fields, groups, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
int info_vec(bool weighted, long long* out) {
  return weighted
             ? hopper::kernel_attrs(segment_bag_kernel<T, VEC, true>, out, out + 1)
             : hopper::kernel_attrs(segment_bag_kernel<T, VEC, false>, out, out + 1);
}

template <typename T>
int info_typed(long long vec, bool weighted, long long bags, long long fields,
               long long* out) {
  out[2] = smem_bytes<T>(bags, fields, weighted);
  out[3] = kU;
  switch (vec) {
    case 1: return info_vec<T, 1>(weighted, out);
    case 2: return info_vec<T, 2>(weighted, out);
    case 4: return info_vec<T, 4>(weighted, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and weights alike).  The tile
// (kernels/segment_bag.py::bag_tile): `bags` bags per CTA, ids staged
// `fields` at a time, `groups` column groups of `vec` columns per bag,
// `threads` >= bags * groups per CTA (at most 256); vec in {1, 2, 4}
// divides D and the table is aligned to vec elements.  Anything else
// returns cudaErrorInvalidValue without a launch.
extern "C" int segment_bag_launch(const void* table, long long V, long long D,
                                  const void* ids, const void* weights,
                                  long long B, long long F, void* out,
                                  long long dtype, long long bags,
                                  long long fields, long long groups,
                                  long long threads, long long vec,
                                  void* stream) {
  if (V < 1 || D < 1 || B < 1 || F < 0 || bags < 1 || fields < 1 ||
      groups < 1 || threads < bags * groups || threads > 256 ||
      D * (dtype == 0 ? 4 : 2) > 0xffffffffLL ||
      threads % 32 != 0 || (vec != 1 && vec != 2 && vec != 4) || D % vec != 0 ||
      groups > D / vec || bags * fields > (1LL << 24) ||
      (B + bags - 1) / bags > 0x7fffffffLL ||
      (D / vec + groups - 1) / groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_typed<float>(table, V, D, ids, weights, B, F, out, (int)bags,
                               (int)fields, (int)groups, (int)threads, (int)vec,
                               s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(table, V, D, ids, weights, B, F, out,
                                       (int)bags, (int)fields, (int)groups,
                                       (int)threads, (int)vec, s);
  return (int)cudaErrorInvalidValue;
}

// The design facts of the kernel that a launch with (dtype, vec, weights
// given or not) and a tile of `bags` x `fields` runs: out[0] registers
// per thread, out[1] local (spill) bytes per thread, out[2] dynamic shared
// memory bytes, out[3] table loads in flight per thread.
extern "C" int segment_bag_info(long long dtype, long long vec,
                                long long weighted, long long bags,
                                long long fields, long long* out) {
  if (dtype == 0) return info_typed<float>(vec, weighted != 0, bags, fields, out);
  if (dtype == 1)
    return info_typed<__nv_bfloat16>(vec, weighted != 0, bags, fields, out);
  return (int)cudaErrorInvalidValue;
}
