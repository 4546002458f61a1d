// Flash-prefill attention: causal GQA attention over a whole prompt.
//   out[b, i, hq, :] = softmax_{j <= i}( q[b, i, hq, :] . k[b, j, hq/G, :]
//                                        * scale ) . v[b, j, hq/G, :]
// with q [B, S, Hq, D], k and v [B, S, Hkv, D], G = Hq / Hkv (query head
// hq = h * G + g reads kv head h), scale = 1/sqrt(D) applied after the dot,
// masked scores -1e30, float32 scores, softmax state and p.v sums, and the
// output cast to q's type.  Any S; the ragged last tile is masked.
//
// Replaces src/repro/kernels/flash_prefill.py::flash_prefill_pallas.  That
// kernel takes q reordered into (q block, g, q) rows per kv head and walks
// kv blocks on a sequential grid axis, carrying (m, l, acc) in VMEM and
// skipping blocks above the diagonal.  Here q is read in its own layout: a
// CTA owns one 64-row q tile of one query head, held in shared memory, and
// loops over the 64-row kv tiles up to the diagonal (the only masked tile),
// keeping the online softmax in registers.  Tiles run heaviest first.
//
// Per tile the 256 threads form a 16 x 16 grid: thread (r, c) computes the
// scores of q rows 16i + r against kv rows 16j + c (i, j < 4) from float4
// reads of the padded shared tiles (the kv reads of eight neighbouring
// lanes fall in distinct bank groups), reduces rows over its 16-lane half
// warp with shuffles, writes p to shared memory, and accumulates output
// columns c + 16k (k < D/16) of its four rows.
//
// Bound: arithmetic, 4 * D flops per (q, kv) pair below the diagonal,
// B * Hq * S (S + 1) / 2 pairs; the bytes (q, k, v read, out written) are
// far less.  This first version runs on the CUDA cores in float32, well
// below the tensor cores' bf16 rate that bounds it; wgmma tiles fed by TMA
// are the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // q rows and kv rows per tile
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

template <int D>
constexpr int smem_bytes() {
  // Qs, Ks [64][D + 4]; Vs [64][D]; Ps [64][64]
  return (2 * kTile * (D + 4) + kTile * D + kTile * kTile) * 4;
}

// rows [row0, row0 + 64) of head `head` of a [B, S, H, D] tensor into a
// float32 tile with row stride `ld`; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int row0, int S, int H, int head) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int row = e / D, d = e % D;
    const int s = row0 + row;
    float x = 0.f;
    if (s < S) x = to_f32(src[(((long long)b * S + s) * H + head) * D + d]);
    dst[row * ld + d] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int Hq, int Hkv) {
  constexpr int LD = D + 4;          // padded row stride of Qs, Ks
  constexpr int CPT = D / 16;        // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * D;

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / (Hq / Hkv);
  const int r = threadIdx.x / 16, c = threadIdx.x % 16;
  const float scale = 1.f / sqrtf((float)D);

  load_tile<T, D>(Qs, LD, q, b, qt * kTile, S, Hq, hq);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CPT; ++kk) acc[i][kk] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();                 // the last tile's p.v reads are done
    load_tile<T, D>(Ks, LD, k, b, kt * kTile, S, Hkv, h);
    load_tile<T, D>(Vs, D, v, b, kt * kTile, S, Hkv, h);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (16 * i + r) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (16 * j + c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qt * kTile + 16 * i + r;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt * kTile + 16 * j + c;
        s[i][j] = (kpos <= qpos && kpos < S) ? s[i][j] * scale : kNegInf;
        mb = fmaxf(mb, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_new = fmaxf(m[i], mb);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(16 * i + r) * kTile + 16 * j + c] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < CPT; ++kk) acc[i][kk] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float p[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(16 * i + r) * kTile + j];
#pragma unroll
      for (int kk = 0; kk < CPT; ++kk) vv[kk] = Vs[j * D + c + 16 * kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < CPT; ++kk) acc[i][kk] += p[i] * vv[kk];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = qt * kTile + 16 * i + r;
    if (qpos >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * S + qpos) * Hq + hq) * D;
#pragma unroll
    for (int kk = 0; kk < CPT; ++kk) from_f32(acc[i][kk] * inv_l, o + c + 16 * kk);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             long long B, long long S, long long Hq, long long Hkv,
             cudaStream_t st) {
  constexpr int bytes = smem_bytes<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)Hq,
                  (unsigned)B);
  flash_prefill_kernel<T, D><<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (int)S, (int)Hq,
      (int)Hkv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 long long B, long long S, long long Hq, long long Hkv,
                 long long D, cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<T, 32>(q, k, v, out, B, S, Hq, Hkv, st);
    case 64: return launch_d<T, 64>(q, k, v, out, B, S, Hq, Hkv, st);
    case 128: return launch_d<T, 128>(q, k, v, out, B, S, Hq, Hkv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {32, 64, 128}, Hq a multiple of
// Hkv; anything else returns cudaErrorInvalidValue without a launch.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* out, long long B, long long S,
                                    long long Hq, long long Hkv, long long D,
                                    long long dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_typed<float>(q, k, v, out, B, S, Hq, Hkv, D, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D, st);
  return (int)cudaErrorInvalidValue;
}
