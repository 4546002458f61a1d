// Flash-prefill attention: causal GQA attention over a whole prompt.
//   out[b, i, hq, :] = softmax_{j <= i}( q[b, i, hq, :] . k[b, j, hq/G, :]
//                                        * scale ) . v[b, j, hq/G, :]
// with q [B, S, Hq, D], k and v [B, S, Hkv, D], G = Hq / Hkv (query head
// hq = h * G + g reads kv head h), scale = 1/sqrt(D) applied after the dot,
// masked scores -1e30, float32 scores and softmax state, and the output
// cast to q's type.  Any S; the ragged last tile is masked.
//
// Replaces src/repro/kernels/flash_prefill.py::flash_prefill_pallas.  That
// kernel takes q reordered into (q block, g, q) rows per kv head and walks
// kv blocks on a sequential grid axis, carrying (m, l, acc) in VMEM and
// skipping blocks above the diagonal.  Here q is read in its own layout.
//
// Bound: arithmetic, 4 * D flops per (q, kv) pair below the diagonal,
// B * Hq * S (S + 1) / 2 pairs, at the tensor cores' bf16 rate; the bytes
// (q, k, v read, out written) are far less.  Two routes, chosen by dtype:
//
// bfloat16 -- the tensor cores, fed by TMA.  One CTA per (128-row q tile,
// query head, b), heaviest tiles first (grid z), of two consumer
// warpgroups that own 64 q rows each:
//   - thread 0 loads the CTA's Q tile once and the first 128-row K and V
//     tiles into a 3-stage shared-memory ring, by TMA with the 128-byte
//     swizzle (64-byte at D 32), counted on mbarriers.  A swizzled TMA box
//     is at most 128 bytes wide, so a D-128 row comes in as two 64-column
//     boxes: each tile is D / 64 column blocks of rows x 128 bytes, and
//     the wgmma descriptors step through them.  Rows past S come in as
//     zeros.  The second warpgroup to finish with a stage refills it with
//     the tile three ahead (a counter per stage in shared memory), so no
//     thread is set aside to produce and each of the 256 threads may hold
//     up to 255 registers (a 288-thread CTA gets 168, too few for what
//     follows).
//   - S = Q K^T is wgmma.m64n128k16 with both operands K-major in shared
//     memory (D is contiguous in q and k); the online softmax runs on the
//     accumulator fragments in registers (row max and sum over the 4
//     threads that share a row; the max taken on the raw scores, then one
//     FFMA and one ex2 per score); P, rounded to bf16, is repacked in
//     registers as the A operand of O += P V, wgmma.m64n64k16 (n32 at D
//     32) with V read from shared memory MN-major (V's D is contiguous:
//     the transpose bit).  Only the tile that holds the diagonal is
//     masked; tiles above it are never loaded.  The stores of the last
//     tile are masked at S.
//   - the softmax is overlapped with the tensor cores twice over: a
//     warpgroup issues tile t's Q K^T together with tile t - 1's P V and
//     runs tile t's softmax while P V runs; and the two warpgroups take
//     turns at issuing (named barriers), so that one's softmax runs while
//     the other's products run.
// P is rounded to bf16 before the product with V, the usual flash-
// attention choice (the TPU kernel keeps it in float32): each p moves by
// at most 2^-9 of itself, and the card check holds the output to one bf16
// ulp of each row's largest value all the same (PERF.md gives the
// measured error).
//
// float32 -- the CUDA cores (wgmma on float32 is TF32, 10 mantissa bits,
// too coarse for the float32 check).  A CTA owns one 64-row q tile of one
// query head, held in shared memory, and loops over the 64-row kv tiles up
// to the diagonal, keeping the online softmax in registers.  Per tile the
// 256 threads form a 16 x 16 grid: thread (r, c) computes the scores of q
// rows 16i + r against kv rows 16j + c (i, j < 4) from float4 reads of the
// padded shared tiles, reduces rows over its 16-lane half warp with
// shuffles, writes p to shared memory, and accumulates output columns
// c + 16k (k < D/16) of its four rows.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;            // q rows and kv rows per tile
constexpr int kThreads = 256;        // 16 x 16 threads

template <int D>
constexpr int smem_bytes() {
  // Qs, Ks [64][D + 4]; Vs [64][D]; Ps [64][64]
  return (2 * kTile * (D + 4) + kTile * D + kTile * kTile) * 4;
}

// rows [row0, row0 + 64) of head `head` of a [B, S, H, D] tensor into a
// tile with row stride `ld`; rows past S are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src, int b,
                                          int row0, int S, int H, int head) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int row = e / D, d = e % D;
    const int s = row0 + row;
    float x = 0.f;
    if (s < S) x = src[(((long long)b * S + s) * H + head) * D + d];
    dst[row * ld + d] = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int S, int Hq, int Hkv) {
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

  load_tile<D>(Qs, LD, q, b, qt * kTile, S, Hq, hq);

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
    load_tile<D>(Ks, LD, k, b, kt * kTile, S, Hkv, h);
    load_tile<D>(Vs, D, v, b, kt * kTile, S, Hkv, h);
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
    float* o = out + (((long long)b * S + qpos) * Hq + hq) * D;
#pragma unroll
    for (int kk = 0; kk < CPT; ++kk) o[c + 16 * kk] = acc[i][kk] * inv_l;
  }
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;             // q rows per CTA: two warpgroups of 64
constexpr int kBN = 128;             // kv rows per tile
constexpr int kStages = 3;           // K / V ring
constexpr int kWgThreads = 256;      // two warpgroups

template <int D>
struct WgCfg {
  static constexpr int SWB = D * 2 >= 128 ? 128 : D * 2;  // swizzle span, B
  static constexpr int CB = SWB / 2;         // columns per column block
  static constexpr int NCB = D / CB;         // column blocks per row
  static constexpr int KPB = SWB / 32;       // k16 steps per column block
  static constexpr int QBLK = 64 * SWB;      // a column block of 64 q rows, B
  static constexpr int QTILE = NCB * QBLK;   // 64 q rows (64 * D * 2), B
  static constexpr int KBLK = kBN * SWB;     // a column block of a kv tile
  static constexpr int KTILE = NCB * KBLK;   // a kv tile (kBN * D * 2), B
  static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 2;   // descriptor code
  static constexpr int SMEM = 1024 + 2 * QTILE + 2 * kStages * KTILE +
                              (1 + kStages) * 8 + kStages * 4;
};

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (the distance between 8-row groups of the swizzle
// atom), swizzle mode
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the SFU, denormal results flushed to zero
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv) {
  using C = WgCfg<D>;
  const int qt = gridDim.z - 1 - blockIdx.z;       // heaviest tiles first
  const int hq = blockIdx.x, b = blockIdx.y;
  const int h = hq / (Hq / Hkv);
  const int q0 = qt * kBM;
  const int last = (q0 + kBM - 1 < S - 1 ? q0 + kBM - 1 : S - 1);
  const int n_kv = last / kBN + 1;                 // kv tiles up to the diagonal

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = hopper::align_smem<1024>(smem_raw);   // [2][QTILE]
  uint8_t* sk = sq + 2 * C::QTILE;                    // [kStages][KTILE]
  uint8_t* sv = sk + kStages * C::KTILE;              // [kStages][KTILE]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sv + kStages * C::KTILE);
  uint64_t* full = qbar + 1;                          // [kStages]
  int* released = reinterpret_cast<int*>(full + kStages);   // [kStages]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // kv tile t into stage t % kStages, by TMA
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    hopper::mbar_expect_tx(&full[s], 2 * C::KTILE);
    for (int cb = 0; cb < C::NCB; ++cb) {
      hopper::tma_load_4d(sk + s * C::KTILE + cb * C::KBLK, &kmap, &full[s],
                          cb * C::CB, h, t * kBN, b);
      hopper::tma_load_4d(sv + s * C::KTILE + cb * C::KBLK, &vmap, &full[s],
                          cb * C::CB, h, t * kBN, b);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(qbar, 2 * C::QTILE);
    for (int rh = 0; rh < 2; ++rh)
      for (int cb = 0; cb < C::NCB; ++cb)
        hopper::tma_load_4d(sq + rh * C::QTILE + cb * C::QBLK, &qmap, qbar,
                            cb * C::CB, hq, q0 + rh * 64, b);
    for (int t = 0; t < kStages && t < n_kv; ++t) load_kv(t);
  }
  __syncthreads();

  // a consumer warpgroup: q rows [row_base, row_base + 64); this thread's
  // accumulator rows r0 and r0 + 8, columns 8 j + 2 (lane % 4) + {0, 1}
  const int wg = warp / 4;
  const int row_base = q0 + wg * 64;
  const int r0 = row_base + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = 1.4426950408889634f / sqrtf((float)D);  // scale * log2 e
  constexpr int OREG = C::CB / 2;                  // O registers per column block
  float o[C::NCB * OREG];
#pragma unroll
  for (int i = 0; i < C::NCB * OREG; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // log2 units
  const uint32_t qa = hopper::smem_addr(sq + wg * C::QTILE);

  // S = Q K_t^T into sc, issued and committed, not waited for
  auto issue_qk = [&](int t, float* sc) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    const uint32_t ka = hopper::smem_addr(sk + (t % kStages) * C::KTILE);
    fence_regs<kBN / 2>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t kq = (kk / C::KPB) * C::QBLK + (kk % C::KPB) * 32;
      const uint32_t kb = (kk / C::KPB) * C::KBLK + (kk % C::KPB) * 32;
      mma_ss_n128(sc, smem_desc(qa + kq, 16, 8 * C::SWB, C::LAYOUT),
                  smem_desc(ka + kb, 16, 8 * C::SWB, C::LAYOUT), kk > 0);
    }
    wg_commit();
  };
  // O += P V_t with P in the A fragments pa, issued and committed
  auto issue_pv = [&](int t, uint32_t (*pa)[4]) {
    const uint32_t va = hopper::smem_addr(sv + (t % kStages) * C::KTILE);
    fence_regs<C::NCB * OREG>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < C::NCB; ++nb) {
        const uint64_t dv = smem_desc(va + nb * C::KBLK + kk * 16 * C::SWB,
                                      8 * C::SWB, 8 * C::SWB, C::LAYOUT);
        if constexpr (C::CB == 64)
          mma_rs_n64(o + nb * OREG, pa[kk], dv);
        else
          mma_rs_n32(o + nb * OREG, pa[kk], dv);
      }
    wg_commit();
  };
  // tile t's online softmax in place: the row max of the raw scores (only
  // the tile that holds the diagonal is masked), then sc = P =
  // 2^(s * scale * log2 e - m) with m kept in log2 units; O's rescale
  // factors go to a0, a1
  auto softmax = [&](int t, float* sc, float& a0, float& a1) {
    const int k0 = t * kBN;
    const bool diag = k0 + kBN - 1 > row_base;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (diag) {
          const int col = k0 + 8 * jn + cq + e;
          if (col > r0) sc[4 * jn + e] = kNegInf;
          if (col > r0 + 8) sc[4 * jn + 2 + e] = kNegInf;
        }
        mx0 = fmaxf(mx0, sc[4 * jn + e]);
        mx1 = fmaxf(mx1, sc[4 * jn + 2 + e]);
      }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    mx0 = fmaxf(m0, mx0 * sl2);
    mx1 = fmaxf(m1, mx1 * sl2);
    a0 = fast_exp2(m0 - mx0);
    a1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * jn + e] = fast_exp2(fmaf(sc[4 * jn + e], sl2, -mx0));
        sc[4 * jn + 2 + e] = fast_exp2(fmaf(sc[4 * jn + 2 + e], sl2, -mx1));
        ps0 += sc[4 * jn + e];
        ps1 += sc[4 * jn + 2 + e];
      }
    l0 = l0 * a0 + ps0;      // this thread's share; the quad sums at the end
    l1 = l1 * a1 + ps1;
  };
  // P (rounded to bf16) as the A operand: k16 step kk holds kv columns
  // 16 kk .. 16 kk + 15
  auto pack_p = [&](const float* sc, uint32_t (*pa)[4]) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // The warpgroup is done with tile t's stage (its products waited for):
  // the second warpgroup to say so refills the stage with tile t + kStages.
  auto release = [&](int t) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
    if (tid % 128 == 0) {
      const int s = t % kStages;
      if (atomicAdd(&released[s], 1) == 1) {
        released[s] = 0;
        if (t + kStages < n_kv) load_kv(t + kStages);
      }
    }
  };
  // The two warpgroups take turns at issuing their products (named
  // barriers 1 and 2), so that one's softmax runs while the other's
  // products run; warpgroup 0 takes the first turn.  Each has n_kv + 1
  // turns; the last arrival of warpgroup 1 is not given, as no turn
  // follows it.
  const int my_bar = 1 + wg, other_bar = 2 - wg;
  auto turn_begin = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(my_bar), "n"(kWgThreads)
                 : "memory");
  };
  auto turn_end = [&] {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(other_bar), "n"(kWgThreads)
                 : "memory");
  };
  if (wg == 1) turn_end();

  // Tile t's Q K^T is issued with tile t - 1's P V, so the softmax of tile
  // t runs while the tensor cores do P V.
  float sc[kBN / 2];
  uint32_t pa[kBN / 16][4];
  float a0, a1;
  hopper::mbar_wait(qbar, 0);
  hopper::mbar_wait(&full[0], 0);
  turn_begin();
  issue_qk(0, sc);
  turn_end();
  wg_wait_all();
  fence_regs<kBN / 2>(sc);
  softmax(0, sc, a0, a1);              // O is zero: nothing to rescale
  pack_p(sc, pa);
  for (int t = 1; t < n_kv; ++t) {
    hopper::mbar_wait(&full[t % kStages], (t / kStages) & 1);
    turn_begin();
    issue_qk(t, sc);
    issue_pv(t - 1, pa);
    turn_end();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs<kBN / 2>(sc);
    softmax(t, sc, a0, a1);
    wg_wait_all();
    fence_regs<C::NCB * OREG>(o);
    release(t - 1);
#pragma unroll
    for (int i = 0; i < C::NCB * OREG; i += 4) {
      o[i] *= a0;
      o[i + 1] *= a0;
      o[i + 2] *= a1;
      o[i + 3] *= a1;
    }
    pack_p(sc, pa);
  }
  turn_begin();
  issue_pv(n_kv - 1, pa);
  if (wg == 0) turn_end();
  wg_wait_all();
  fence_regs<C::NCB * OREG>(o);

  // out = O / l, rows past S not stored
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nb = 0; nb < C::NCB; ++nb)
#pragma unroll
    for (int jn = 0; jn < C::CB / 8; ++jn) {
      const int col = nb * C::CB + 8 * jn + cq;
      const float* f = o + nb * OREG + 4 * jn;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((long long)b * S + r0) * Hq + hq) * D + col) =
            __floats2bfloat162_rn(f[0] * inv0, f[1] * inv0);
      if (r0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((long long)b * S + r0 + 8) * Hq + hq) * D + col) =
            __floats2bfloat162_rn(f[2] * inv1, f[3] * inv1);
    }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 long long B, long long S, long long Hq, long long Hkv,
                 cudaStream_t st) {
  using C = WgCfg<D>;
  const CUtensorMapSwizzle sw =
      C::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qm, km, vm;
  if (!hopper::make_map_4d(&qm, q, true, D, Hq, S, B, C::CB, 64, sw) ||
      !hopper::make_map_4d(&km, k, true, D, Hkv, S, B, C::CB, kBN, sw) ||
      !hopper::make_map_4d(&vm, v, true, D, Hkv, S, B, C::CB, kBN, sw))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      prefill_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)Hq, (unsigned)B, (unsigned)((S + kBM - 1) / kBM));
  prefill_wgmma_kernel<D><<<grid, kWgThreads, C::SMEM, st>>>(
      qm, km, vm, (__nv_bfloat16*)out, (int)S, (int)Hq, (int)Hkv);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             long long B, long long S, long long Hq, long long Hkv,
             long long dtype, cudaStream_t st) {
  if (dtype == 1) return launch_wgmma<D>(q, k, v, out, B, S, Hq, Hkv, st);
  constexpr int bytes = smem_bytes<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)Hq,
                  (unsigned)B);
  flash_prefill_f32_kernel<D><<<grid, kThreads, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (int)S,
      (int)Hq, (int)Hkv);
  return (int)cudaGetLastError();
}

template <int D>
int info_d(long long dtype, long long* out) {
  out[3] = kStages;
  if (dtype == 1) {
    out[0] = kWgThreads;
    out[2] = WgCfg<D>::SMEM;
    out[4] = kBM;
    out[5] = kBN;
    return hopper::kernel_attrs(prefill_wgmma_kernel<D>, out + 1, out + 6);
  }
  out[0] = kThreads;
  out[2] = smem_bytes<D>();
  out[3] = 1;
  out[4] = kTile;
  out[5] = kTile;
  return hopper::kernel_attrs(flash_prefill_f32_kernel<D>, out + 1, out + 6);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma).  D in {32, 64,
// 128}, Hq a multiple of Hkv; anything else returns cudaErrorInvalidValue
// without a launch.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* out, long long B, long long S,
                                    long long Hq, long long Hkv, long long D,
                                    long long dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_d<32>(q, k, v, out, B, S, Hq, Hkv, dtype, st);
    case 64: return launch_d<64>(q, k, v, out, B, S, Hq, Hkv, dtype, st);
    case 128: return launch_d<128>(q, k, v, out, B, S, Hq, Hkv, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The design facts of the kernel that a call with (D, dtype) launches:
// out[0] threads per CTA, out[1] registers per thread, out[2] dynamic
// shared memory bytes, out[3] K / V ring stages, out[4] q rows and out[5]
// kv rows per tile, out[6] local (spill) bytes per thread.
extern "C" int flash_prefill_info(long long D, long long dtype,
                                  long long* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return info_d<32>(dtype, out);
    case 64: return info_d<64>(dtype, out);
    case 128: return info_d<128>(dtype, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
