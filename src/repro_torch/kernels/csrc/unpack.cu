// Packed-postings unpack: posting ordinals -> (doc, pos, dist) int32 planes.
//
// Replaces src/repro/kernels/unpack.py::unpack_fields_pallas together with
// the XLA gathers around it in src/repro/kernels/ops.py::unpack_postings
// (one blk_meta row gather plus one lane gather per field).
//
// Bound: device memory.  Per posting the kernel reads 4 B of ordinal and
// three 4 B lane words and writes three 4 B outputs; the 20 B metadata row
// is shared by the 128 postings of a block and mostly hits L1/L2.  There is
// no arithmetic to speak of, so the design is a plain fused gather: one
// thread per ordinal, so the four [3, ...] int32 planes (words, shifts,
// widths, anchors) that the TPU path materializes never touch device
// memory.  Neighbouring threads read neighbouring ordinals, which for the
// executor's contiguous slices means neighbouring lane words.
//
// Semantics (bit-exact with the reference):
//   blk = idx >> 7, off = idx & 127, meta row = blk_meta[blk] (5 int32:
//   base lane word, packed widths (6-bit slot per field), 3 anchors);
//   for field f with width w and first lane word fb:
//     bit = off * w; word = lanes[fb + (bit >> 5)]; shift = bit & 31
//     value = anchor + ((word >> shift) & mask(w)),  mask(32) = all ones
// Out-of-range reads are clamped as the reference's gathers clamp: the
// block index to [0, n_blocks - 1] and the lane word to [0, n_lanes - 1]
// (a width-0 tail block points one word past the end; its mask is 0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockLog2 = 7;
constexpr int kWidthBits = 6;
constexpr int kMetaCols = 5;
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t extract(const int32_t* __restrict__ lanes,
                                           long long n_lanes, long long word,
                                           int off, int w, int32_t anchor) {
  int bit = off * w;
  long long at = word + (bit >> 5);
  at = at < 0 ? 0 : (at >= n_lanes ? n_lanes - 1 : at);
  int32_t raw = lanes[at] >> (bit & 31);          // arithmetic, as on the TPU
  uint32_t mask = w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
  return (int32_t)((uint32_t)anchor + ((uint32_t)raw & mask));
}

__global__ void __launch_bounds__(kThreads)
unpack_postings_kernel(const int32_t* __restrict__ lanes, long long n_lanes,
                       const int32_t* __restrict__ meta, long long n_blocks,
                       const int32_t* __restrict__ idx, long long n,
                       int32_t* __restrict__ doc, int32_t* __restrict__ pos,
                       int32_t* __restrict__ dist) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int32_t id = idx[i];
  long long blk = id >> kBlockLog2;
  blk = blk < 0 ? 0 : (blk >= n_blocks ? n_blocks - 1 : blk);
  int off = id & ((1 << kBlockLog2) - 1);
  const int32_t* m = meta + blk * kMetaCols;
  int32_t base = m[0], bw = m[1];
  int wmask = (1 << kWidthBits) - 1;
  int w0 = bw & wmask, w1 = (bw >> kWidthBits) & wmask,
      w2 = (bw >> (2 * kWidthBits)) & wmask;
  long long fb0 = base;
  long long fb1 = fb0 + ((long long)w0 << 2);
  long long fb2 = fb1 + ((long long)w1 << 2);
  doc[i] = extract(lanes, n_lanes, fb0, off, w0, m[2]);
  pos[i] = extract(lanes, n_lanes, fb1, off, w1, m[3]);
  dist[i] = extract(lanes, n_lanes, fb2, off, w2, m[4]);
}

}  // namespace

extern "C" int unpack_postings_launch(const void* lanes, long long n_lanes,
                                      const void* meta, long long n_blocks,
                                      const void* idx, long long n, void* doc,
                                      void* pos, void* dist, void* stream) {
  long long grid = (n + kThreads - 1) / kThreads;
  unpack_postings_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)lanes, n_lanes, (const int32_t*)meta, n_blocks,
      (const int32_t*)idx, n, (int32_t*)doc, (int32_t*)pos, (int32_t*)dist);
  return (int)cudaGetLastError();
}
