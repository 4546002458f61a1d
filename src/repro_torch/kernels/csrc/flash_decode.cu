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
// in VMEM from one step to the next.  Here one CTA owns one (b, kv head):
// its eight warps stride over the cache in runs of kRows rows, each warp
// keeping its own (m, l, acc) for the G query heads of the group in
// registers; at the end the warps merge their states through shared
// memory.  Each lane holds D/32 consecutive elements of q, of every k and
// v row it reads, and of acc; a row's G dot products are finished with
// xor shuffles, so every lane holds every score.
//
// Bound: device memory.  Per call the kernel must read the k and v rows
// below kv_len (2 * kv_len * Hkv * D * sizeof(T) per batch row) plus q and
// write out; the arithmetic is ~4 * G * D flops per row, far below the
// card's rate.  With one CTA per (b, kv head) a decode of B = 4, Hkv = 8
// runs 32 CTAs on 132 SMs, so the card's bandwidth is not reached: each
// warp keeps kRows rows of k and v in flight to hide what latency it can.
// Splitting S across CTAs (a second merge pass) is the redesign that
// fills the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;         // cache rows per warp per step, loads in flight
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// EPL consecutive elements of one lane, loaded as one vector
template <typename T, int EPL>
struct alignas(sizeof(T) * EPL) Vec {
  T v[EPL];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ kv_len,
                    T* __restrict__ out, int S, int Hkv, int G) {
  constexpr int EPL = D / 32;
  using V = Vec<T, EPL>;
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = 1.f / sqrtf((float)D);
  long long n = kv_len[b];
  n = n < 0 ? 0 : (n > S ? S : n);

  float qr[kMaxG][EPL], acc[kMaxG][EPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = 0.f;
    }
    if (g < G) {
      V qv = *reinterpret_cast<const V*>(q + ((long long)bh * G + g) * D +
                                         lane * EPL);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = to_f32(qv.v[e]);
    }
  }

  const long long row_stride = (long long)Hkv * D;   // elements between s
  const T* kb = k + ((long long)b * S * Hkv + h) * D + lane * EPL;
  const T* vb = v + ((long long)b * S * Hkv + h) * D + lane * EPL;

  for (long long s0 = (long long)warp * kRows; s0 < n;
       s0 += (long long)kWarps * kRows) {
    V kr[kRows], vr[kRows];    // rows past n stay 0: p * 0, never p * NaN
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[r].v[e] = T(0.f);
        vr[r].v[e] = T(0.f);
      }
      if (s0 + r < n) {
        kr[r] = *reinterpret_cast<const V*>(kb + (s0 + r) * row_stride);
        vr[r] = *reinterpret_cast<const V*>(vb + (s0 + r) * row_stride);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float sc[kRows];
      float mb = kNegInf;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qr[g][e] * to_f32(kr[r].v[e]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[r] = (s0 + r < n) ? d * scale : kNegInf;
        mb = fmaxf(mb, sc[r]);
      }
      const float m_new = fmaxf(m[g], mb);
      const float alpha = expf(m[g] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = (s0 + r < n) ? expf(sc[r] - m_new) : 0.f;
        ps += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * to_f32(vr[r].v[e]);
      }
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
    }
  }

  // merge the warps' states: M = max m_w, L = sum l_w e^(m_w - M),
  // A = sum acc_w e^(m_w - M), out = A / max(L, 1e-30)
  __shared__ float sm[kWarps][kMaxG], sl[kWarps][kMaxG];
  __shared__ float sacc[kWarps][kMaxG][D];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sacc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm[w][g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm[w][g] - M);
      L += sl[w][g] * c;
      A += sacc[w][g][d] * c;
    }
    from_f32(A / fmaxf(L, 1e-30f), out + ((long long)bh * G + g) * D + d);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* kv_len, void* out, long long B, long long S,
                 long long Hkv, long long G, long long D, cudaStream_t st) {
  const dim3 grid((unsigned)(B * Hkv));
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  const int32_t* lt = (const int32_t*)kv_len;
  T* ot = (T*)out;
  switch (D) {
    case 32:
      flash_decode_kernel<T, 32><<<grid, kThreads, 0, st>>>(
          qt, kt, vt, lt, ot, (int)S, (int)Hkv, (int)G);
      break;
    case 64:
      flash_decode_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          qt, kt, vt, lt, ot, (int)S, (int)Hkv, (int)G);
      break;
    case 128:
      flash_decode_kernel<T, 128><<<grid, kThreads, 0, st>>>(
          qt, kt, vt, lt, ot, (int)S, (int)Hkv, (int)G);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {32, 64, 128}, 1 <= G <= 8;
// anything else returns cudaErrorInvalidValue without a launch.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* out, long long B,
                                   long long S, long long Hkv, long long G,
                                   long long D, long long dtype, void* stream) {
  if (G < 1 || G > kMaxG || B * Hkv == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_typed<float>(q, k, v, kv_len, out, B, S, Hkv, G, D, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, kv_len, out, B, S, Hkv, G, D,
                                       st);
  return (int)cudaErrorInvalidValue;
}
