// PSXU bitmap, patch XOR and popcount (paper §III-B) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/patch_bitmap/kernel.py
// (patch_bitmap_kernel, body _kernel).  Same function, bit for bit: for
// each row of an (R, Tk) score slab,
//   bits   = s >= threshold                        (one bit per key)
//   delta  = bits XOR the same bits one patch to the left, the first
//            patch of the row kept as it is
//   packed = delta, 32 keys per uint32 word, key 32w + i at bit i
//   counts = popcount of delta over each patch     (R, Tk/patch) int32
//
// What bounds it on an H100: memory.  It reads 4 bytes a key and writes
// 1/8 + 4/patch bits' worth back; the res-64 slab of one cond row
// (8 heads x 4096 queries x 4096 keys) reads 537 MB, about 0.16 ms at
// 3.35 TB/s.  The work per key is one compare.
// Design: one warp per row, 8 rows a block (the caller may ask for 2, 4,
// 16 or 32 instead, the autotuner's ``bitmap_block_rows``; rows are
// independent, so every choice gives the same bits).  The warp walks the
// row in chunks of 32 words
// (1024 keys): it issues the chunk's 32 coalesced loads (lane i reads key
// 32w + i) before any compare, so 4 KB per warp are in flight, and
// __ballot_sync(s >= tau) over the warp IS packed word w, with lane 0 as
// the LSB, as the JAX packing has it.  Lane j keeps word j of the chunk.
// The XOR partner comes by shuffle: for a patch of 32 * sw keys it is the
// word sw before (from the previous chunk for the first sw lanes); for a
// patch p dividing 32 it is the word shifted left by p with the previous
// word's top p bits carried in.  Counts are popcounts of p-bit fields, or
// sums of sw word popcounts by shuffle.  Packed words and counts are
// stored one word per lane, coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEFAULT_WARPS = 8;        // rows a block by default
constexpr unsigned FULL = 0xffffffffu;

// WARPS rows a block, one warp each
template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
patch_bitmap_kernel(const float* __restrict__ sas,
                    unsigned* __restrict__ packed, int* __restrict__ counts,
                    int rows, int tk, int patch, float threshold) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;                 // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int nwords = tk >> 5;
  const int npatch = tk / patch;
  const float* s = sas + (size_t)row * tk;
  unsigned* pk = packed + (size_t)row * nwords;
  int* ct = counts + (size_t)row * npatch;

  unsigned prev_raw = 0u;                  // lane j: word j of last chunk
  for (int c0 = 0; c0 < nwords; c0 += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j)
      v[j] = c0 + j < nwords ? __ldg(s + (size_t)(c0 + j) * 32 + lane)
                             : 0.f;
    unsigned raw = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned bits =
          __ballot_sync(FULL, c0 + j < nwords && v[j] >= threshold);
      if (lane == j) raw = bits;
    }

    unsigned d;
    if (patch < 32) {
      const unsigned up = __shfl_up_sync(FULL, raw, 1);
      const unsigned last = __shfl_sync(FULL, prev_raw, 31);
      const unsigned prev_word = lane == 0 ? last : up;
      d = raw ^ ((raw << patch) | (prev_word >> (32 - patch)));
    } else {
      const int sw = patch >> 5;
      const unsigned here = __shfl_sync(FULL, raw, (lane - sw) & 31);
      const unsigned before = __shfl_sync(FULL, prev_raw, (lane - sw) & 31);
      d = raw ^ (lane >= sw ? here : before);
    }
    prev_raw = raw;

    const int word = c0 + lane;
    if (word < nwords) pk[word] = d;
    if (patch < 32) {
      const int per = 32 / patch;
      const unsigned mask = (1u << patch) - 1u;
      if (word < nwords)
        for (int k = 0; k < per; ++k)
          ct[word * per + k] = __popc((d >> (k * patch)) & mask);
    } else {
      const int sw = patch >> 5;
      int cnt = __popc(d);
      for (int off = sw >> 1; off > 0; off >>= 1)
        cnt += __shfl_down_sync(FULL, cnt, off);
      if (word < nwords && lane % sw == 0) ct[word / sw] = cnt;
    }
  }
}

template <int WARPS>
cudaError_t launch(const float* sas, unsigned* packed, int* counts, int rows,
                   int tk, int patch, float threshold, cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  patch_bitmap_kernel<WARPS><<<blocks, 32 * WARPS, 0, stream>>>(
      sas, packed, counts, rows, tk, patch, threshold);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The wrapper has
// checked: tk % 32 == 0, tk % patch == 0, and patch divides 32 or is 32
// times a power of two up to 1024.  block_rows: rows a block, 2, 4, 8, 16
// or 32; 0 takes 8; any other value is refused.
extern "C" int launch_patch_bitmap(const void* sas, void* packed,
                                   void* counts, int rows, int tk, int patch,
                                   float threshold, int block_rows,
                                   void* stream) {
  const float* s = static_cast<const float*>(sas);
  unsigned* pk = static_cast<unsigned*>(packed);
  int* ct = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_rows == 0) block_rows = DEFAULT_WARPS;
  if (block_rows != 2 && block_rows != 4 && block_rows != 8 &&
      block_rows != 16 && block_rows != 32)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
#define BITMAP_CASE(W) \
  if (block_rows == W) \
    return (int)launch<W>(s, pk, ct, rows, tk, patch, threshold, st);
  BITMAP_CASE(2) BITMAP_CASE(4) BITMAP_CASE(8) BITMAP_CASE(16)
  BITMAP_CASE(32)
#undef BITMAP_CASE
  return (int)cudaErrorInvalidValue;
}
