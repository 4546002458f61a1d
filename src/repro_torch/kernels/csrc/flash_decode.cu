// Flash-decode attention: one new token per batch row against a KV cache.
//   out[b, h*G + g, :] = softmax_s( q[b, h*G + g, :] . k[b, s, h, :] * scale )
//                        . v[b, s, h, :]          over s < min(kv_len[b], S)
// with scale = 1/sqrt(D) applied after the dot, float32 scores, softmax
// state and p.v sums, and the output cast to q's type.  kv_len[b] <= 0
// gives a zero row (the TPU kernel's running sums stay 0 and it divides by
// max(l, 1e-30)); kv_len[b] > S reads all S rows.
//
// Replaces src/repro/kernels/flash_decode.py::flash_decode_pallas.  There a
// sequential grid walks the cache in 512-row blocks and carries (m, l, acc)
// in VMEM from one step to the next.
//
// Bound: device memory.  Per call the kernel must read the k and v rows
// below kv_len (2 * kv_len * Hkv * D * sizeof(T) per batch row) plus q and
// write out; the arithmetic is ~4 * G * D flops per row, far below the
// card's rate.  To reach the card's bandwidth the design
//   - splits each (b, kv head)'s cache across CTAs: grid (n_split, Hkv, B),
//     each CTA owning `chunk` rows (a multiple of 64) for all G query heads
//     of its kv head.  The split is planned on the host from S, never from
//     kv_len (that would cost a host sync per call): decode_split in
//     kernels/flash_decode.py takes the longest chunk, up to 2048 rows,
//     that still gives two CTAs per SM (llama3-8b's B 4, Hkv 8, S 32768:
//     16 chunks, 512 CTAs).  A CTA whose chunk starts at or past kv_len[b]
//     writes an empty partial and exits.
//   - feeds each CTA through a ring of 2-4 shared-memory stages of 64-row k
//     and v tiles (about 96 KB in all, so two CTAs share an SM), loaded by
//     TMA (box [1, 64, 1, D] of the [B, S, Hkv, D] tensor; rows past S
//     come in as zeros) and counted on mbarriers: thread 0 keeps the ring
//     full, so several tiles are in flight per CTA while the threads
//     compute.
//   - reads shared memory as 16-byte vectors: thread (c, j) of a CTA owns
//     16-byte column slice c of rows j, j + NJ, ... of every tile, the lanes
//     of one row reading one contiguous row (no bank conflicts).
//   - finishes the dot products of a whole batch of rows and heads at once
//     with a transposing butterfly across the NL lanes of a row: N partial
//     sums per lane cost N - 1 shuffles in all (for llama's D 128, G 4 in
//     bf16: 15 shuffles per 4 rows x 4 heads, where one reduction per row
//     and head costs 4 each).  The online softmax then runs once per tile
//     and head (one warp per head), and p.v accumulates in registers.
// Each CTA writes its float32 partial (m, l, acc[D]) per head to a
// workspace [B, Hkv, n_split, G, D + 2]; a second small kernel, launched by
// the same C entry point, merges the partials of each (b, kv head, head)
// in a fixed order, one CTA of D threads each:
//   M = max m,  L = sum l e^(m - M),  out = sum acc e^(m - M) / max(L, 1e-30)
// which gives the zero row at kv_len <= 0.  No atomics: repeated calls are
// bit-identical.  Each call is therefore two CUDA launches.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // cache rows per TMA tile
constexpr int kMaxG = 8;
constexpr int kMergeMaxSplit = 4096;   // splits the merge kernel takes
constexpr float kNegInf = -1e30f;

// ring stages: about 96 KB of tiles (two CTAs per SM), 2 to 4 stages
constexpr int stages_for(int tile_bytes) {
  return 98304 / (2 * tile_bytes) < 2
             ? 2
             : (98304 / (2 * tile_bytes) > 4 ? 4 : 98304 / (2 * tile_bytes));
}

template <typename T, int D>
struct DecodeCfg {
  static constexpr int VEC = 16 / (int)sizeof(T);     // elements per 16 bytes
  static constexpr int NL = D / VEC;                  // lanes per row
  static constexpr int NJ = kThreads / NL;            // rows read at once
  static constexpr int RPT = kTile / NJ;              // rows per thread per tile
  static constexpr int TILE = kTile * D * (int)sizeof(T);
  static constexpr int STAGES = stages_for(TILE);
};

template <typename T, int D, int GP>
constexpr int decode_smem_bytes() {
  using C = DecodeCfg<T, D>;
  // alignment slack, ring, scores / p [64][GP], alpha [8], barriers
  return 128 + C::STAGES * 2 * C::TILE + kTile * GP * 4 + kMaxG * 4 +
         C::STAGES * 8;
}

__device__ __forceinline__ void unpack16(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {      // bf16 pairs, the lower element first
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// Sums v[0..N) of every lane over the lanes that differ in bits O, O/2, ..,
// 1 of the lane index, and hands out the N sums: while a lane holds more
// than one value it keeps the half that its bit O selects and adds its
// partner's copy of that half.  Afterwards lane c (its index below 2 O)
// holds sum number c * N / (2 O) + i in v[i] when N >= 2 O, else sum
// number c / (2 O / N) in v[0].
template <int N, int O>
__device__ __forceinline__ void transpose_sum(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      transpose_sum<N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      transpose_sum<1, O / 2>(v, lane);
    }
  }
}

// One CTA: rows [split * chunk, split * chunk + chunk) of (b, kv head h),
// all G query heads (GP = G rounded up to a power of two; heads >= G are
// computed on zeros and dropped).
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const T* __restrict__ q, const int32_t* __restrict__ kv_len,
                    float* __restrict__ ws, int S, int Hkv, int G, int chunk) {
  using C = DecodeCfg<T, D>;
  constexpr int VEC = C::VEC, NL = C::NL, NJ = C::NJ, RPT = C::RPT;
  constexpr int RB = RPT < 32 / GP ? RPT : 32 / GP;  // rows per butterfly
  constexpr int N = RB * GP;                          // sums per butterfly
  constexpr int CNT = N >= NL ? N / NL : 1;           // sums a lane ends with
  constexpr int TILE = C::TILE, STAGES = C::STAGES;
  constexpr int ROW_BYTES = D * (int)sizeof(T);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid % NL, j = tid / NL;
  float* part = ws + (((long long)b * Hkv + h) * gridDim.x + split) * G * (D + 2);
  int n = kv_len[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int row0 = split * chunk;
  const int rows = n - row0 < chunk ? n - row0 : chunk;
  if (rows <= 0) {                       // an empty partial
    for (int i = tid; i < G * (D + 2); i += kThreads)
      part[i] = i % (D + 2) == 0 ? kNegInf : 0.f;
    return;
  }
  const int n_tiles = (rows + kTile - 1) / kTile;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_smem<128>(smem_raw);   // [STAGES][k, v][TILE]
  float* sp = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);  // [64][GP]
  float* salpha = sp + kTile * GP;                                 // [kMaxG]
  uint64_t* full = reinterpret_cast<uint64_t*>(salpha + kMaxG);    // [STAGES]

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int t) {
    const int s = t % STAGES;
    uint8_t* dst = ring + s * 2 * TILE;
    hopper::mbar_expect_tx(&full[s], 2 * TILE);
    hopper::tma_load_4d(dst, &kmap, &full[s], 0, h, row0 + t * kTile, b);
    hopper::tma_load_4d(dst + TILE, &vmap, &full[s], 0, h, row0 + t * kTile, b);
  };
  if (tid == 0)
    for (int t = 0; t < STAGES && t < n_tiles; ++t) issue(t);

  const float scale = 1.f / sqrtf((float)D);
  float qr[GP][VEC], acc[GP][VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[g][e] = 0.f;
      acc[g][e] = 0.f;
    }
    if (g < G) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + (((long long)b * Hkv + h) * G + g) * D + c * VEC);
      unpack16(u, qr[g]);
    }
  }
  float m_run = kNegInf, l_run = 0.f;   // head `warp`'s state (warps < GP)

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    hopper::mbar_wait(&full[st], (t / STAGES) & 1);
    const uint8_t* kt = ring + st * 2 * TILE;
    const uint8_t* vt = kt + TILE;
    const int valid = rows - t * kTile < kTile ? rows - t * kTile : kTile;

    // scores of the tile's rows for every head -> sp[row][g]
#pragma unroll
    for (int rb = 0; rb < RPT / RB; ++rb) {
      float ps[N];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int row = j + NJ * (rb * RB + rr);
        float kf[VEC];
        unpack16(*reinterpret_cast<const uint4*>(kt + row * ROW_BYTES + c * 16),
                 kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
          ps[rr * GP + g] = d;
        }
      }
      transpose_sum<N, NL / 2>(ps, lane);
#pragma unroll
      for (int i = 0; i < CNT; ++i) {
        const int idx = N >= NL ? c * CNT + i : c / (NL / N);
        if (N >= NL || c % (NL / N) == 0) {
          const int rr = idx / GP, g = idx % GP;
          sp[(j + NJ * (rb * RB + rr)) * GP + g] = ps[i] * scale;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per head: p -> sp, rescale factor -> salpha
    if (warp < GP) {
      const int g = warp;
      const bool v0 = g < G && lane < valid, v1 = g < G && lane + 32 < valid;
      const float s0 = v0 ? sp[lane * GP + g] : kNegInf;
      const float s1 = v1 ? sp[(lane + 32) * GP + g] : kNegInf;
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run, mt);
      const float alpha = expf(m_run - m_new);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      float psum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      sp[lane * GP + g] = p0;
      sp[(lane + 32) * GP + g] = p1;
      if (lane == 0) salpha[g] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p . v over the thread's rows (rows past kv_len
    // are skipped: their v may hold anything)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float a = salpha[g];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int row = j + NJ * rr;
      if (row < valid) {
        float vf[VEC];
        unpack16(*reinterpret_cast<const uint4*>(vt + row * ROW_BYTES + c * 16),
                 vf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float p = sp[row * GP + g];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();                   // stage st and sp are free again
    if (tid == 0 && t + STAGES < n_tiles) issue(t + STAGES);
  }

  // the CTA's partial: acc summed over the rows' owners, in a fixed order
  // (first the lanes of a warp that share column slice c, then the warps)
#pragma unroll
  for (int o = NL; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  float* red = reinterpret_cast<float*>(ring);   // [kWarps][GP][D], ring idle
  if (lane < NL)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[(warp * GP + g) * D + c * VEC + e] = acc[g][e];
  if (warp < G && lane == 0) {
    part[warp * (D + 2)] = m_run;
    part[warp * (D + 2) + 1] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * GP + g) * D + d];
    part[g * (D + 2) + 2 + d] = a;
  }
}

// out[b, h*G + g, :] from the n_split partials of (b, h, g); one CTA of D
// threads per (g, h, b).  Warp 0 finds M and L and leaves each split's
// weight e^(m - M) in shared memory; thread d then sums acc[.., d].
template <typename T>
__global__ void __launch_bounds__(128)
decode_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                    int n_split, int G, int D) {
  __shared__ float w[kMergeMaxSplit];
  __shared__ float inv_l;
  const int g = blockIdx.x;
  const long long bh = blockIdx.y;
  const long long stride = (long long)G * (D + 2);   // from split to split
  const float* base = ws + bh * n_split * stride + (long long)g * (D + 2);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    float M = kNegInf;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, base[s * stride]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float x = expf(base[s * stride] - M);
      w[s] = x;
      L += base[s * stride + 1] * x;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) inv_l = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < D) {
    float A = 0.f;
    for (int s = 0; s < n_split; ++s) A = fmaf(base[s * stride + 2 + d], w[s], A);
    from_f32(A * inv_l, out + (bh * G + g) * D + d);
  }
}

template <typename T, int D, int GP>
int launch_split(const void* q, const void* k, const void* v,
                 const void* kv_len, void* out, float* ws, long long B,
                 long long S, long long Hkv, long long G, long long chunk,
                 long long n_split, cudaStream_t st) {
  constexpr bool bf16 = sizeof(T) == 2;
  CUtensorMap km, vm;
  if (!hopper::make_map_4d(&km, k, bf16, D, Hkv, S, B, D, kTile,
                           CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::make_map_4d(&vm, v, bf16, D, Hkv, S, B, D, kTile,
                           CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = decode_smem_bytes<T, D, GP>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T, D, GP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  decode_split_kernel<T, D, GP>
      <<<dim3((unsigned)n_split, (unsigned)Hkv, (unsigned)B), kThreads, bytes,
         st>>>(km, vm, (const T*)q, (const int32_t*)kv_len, ws, (int)S,
               (int)Hkv, (int)G, (int)chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<T><<<dim3((unsigned)G, (unsigned)(B * Hkv)), D, 0, st>>>(
      ws, (T*)out, (int)n_split, (int)G, D);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, float* ws, long long B, long long S, long long Hkv,
             long long G, long long chunk, long long n_split, cudaStream_t st) {
  if (G == 1)
    return launch_split<T, D, 1>(q, k, v, kv_len, out, ws, B, S, Hkv, G,
                                 chunk, n_split, st);
  if (G == 2)
    return launch_split<T, D, 2>(q, k, v, kv_len, out, ws, B, S, Hkv, G,
                                 chunk, n_split, st);
  if (G <= 4)
    return launch_split<T, D, 4>(q, k, v, kv_len, out, ws, B, S, Hkv, G,
                                 chunk, n_split, st);
  return launch_split<T, D, 8>(q, k, v, kv_len, out, ws, B, S, Hkv, G, chunk,
                               n_split, st);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* kv_len, void* out, float* ws, long long B,
                 long long S, long long Hkv, long long G, long long D,
                 long long chunk, long long n_split, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, kv_len, out, ws, B, S, Hkv, G, chunk,
                             n_split, st);
    case 64:
      return launch_d<T, 64>(q, k, v, kv_len, out, ws, B, S, Hkv, G, chunk,
                             n_split, st);
    case 128:
      return launch_d<T, 128>(q, k, v, kv_len, out, ws, B, S, Hkv, G, chunk,
                              n_split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D>
int info_d(long long G, long long* out) {
  using C = DecodeCfg<T, D>;
  out[0] = kThreads;
  out[3] = C::STAGES;
  out[4] = kTile;
  if (G == 1) {
    out[2] = decode_smem_bytes<T, D, 1>();
    return hopper::kernel_attrs(decode_split_kernel<T, D, 1>, out + 1, out + 5);
  }
  if (G == 2) {
    out[2] = decode_smem_bytes<T, D, 2>();
    return hopper::kernel_attrs(decode_split_kernel<T, D, 2>, out + 1, out + 5);
  }
  if (G <= 4) {
    out[2] = decode_smem_bytes<T, D, 4>();
    return hopper::kernel_attrs(decode_split_kernel<T, D, 4>, out + 1, out + 5);
  }
  out[2] = decode_smem_bytes<T, D, 8>();
  return hopper::kernel_attrs(decode_split_kernel<T, D, 8>, out + 1, out + 5);
}

template <typename T>
int info_typed(long long D, long long G, long long* out) {
  switch (D) {
    case 32: return info_d<T, 32>(G, out);
    case 64: return info_d<T, 64>(G, out);
    case 128: return info_d<T, 128>(G, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {32, 64, 128}, 1 <= G <= 8, S >= 1,
// chunk a positive multiple of 64 with n_split * chunk >= S; ws holds
// B * Hkv * n_split * G * (D + 2) floats.  Anything else returns
// cudaErrorInvalidValue without a launch.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* out, void* ws,
                                   long long B, long long S, long long Hkv,
                                   long long G, long long D, long long dtype,
                                   long long chunk, long long n_split,
                                   void* stream) {
  if (G < 1 || G > kMaxG || B < 1 || Hkv < 1 || B > 65535 || Hkv > 65535 ||
      B * Hkv > 65535 || S < 1 || chunk < kTile ||
      chunk % kTile != 0 || n_split < 1 || n_split > kMergeMaxSplit ||
      n_split * chunk < S ||
      (n_split - 1) * chunk >= S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (dtype == 0)
    return launch_typed<float>(q, k, v, kv_len, out, w, B, S, Hkv, G, D,
                               chunk, n_split, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, kv_len, out, w, B, S, Hkv, G,
                                       D, chunk, n_split, st);
  return (int)cudaErrorInvalidValue;
}

// The design facts of the split kernel that a call with (D, dtype, G)
// launches: out[0] threads per CTA, out[1] registers per thread, out[2]
// dynamic shared memory bytes, out[3] ring stages, out[4] rows per tile,
// out[5] local (spill) bytes per thread.
extern "C" int flash_decode_info(long long D, long long dtype, long long G,
                                 long long* out) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return info_typed<float>(D, G, out);
  if (dtype == 1) return info_typed<__nv_bfloat16>(D, G, out);
  return (int)cudaErrorInvalidValue;
}
