// Per-patch max |x - ref| for temporal patch reuse, on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/patch_reuse/kernel.py
// (patch_delta_kernel, body _kernel).  Same function, bit for bit:
//   out[b, p] = max over w of |xf[b, p, w] - rf[b, p, w]|      (float32)
// on (B, P, W) operands whose trailing axis holds one patch's tokens and
// channels (W = patch * C).  Max commutes, so any order gives the same
// value; NaN propagates as in jnp.max (see below).
//
// What bounds it on an H100: memory.  It reads 8 bytes for every 3 cheap
// operations; at full width W = 20480 for every block, and two rows at
// res 64 read 21.0 MB (6.3 us at 3.35 TB/s).
// Design: one block per (row, 2048-value chunk), so each patch is split
// over ceil(W / 2048) blocks (10 at full width) and even the 32 patch rows
// of res 16 give 320 blocks for the 132 SMs.  The caller may set the chunk
// to 2, 4, 16 or 32 slices of 256 values instead of 8 (the autotuner's
// ``reuse_block_patches``); max is order-free, so every chunk gives the
// same bits.  Loads are float4 when W is a
// multiple of 4 (every full-width shape), scalar otherwise.  Blocks
// combine with atomicMax on the float's bits read as unsigned: |d| >= 0,
// so the bit order is the float order, and a NaN (sign cleared by fabsf)
// sits above +inf, so it propagates.  fmaxf would drop it.  The wrapper
// zeroes the output first (+0.0 has bits 0, below every |d|).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLICE = 256;          // values of a chunk come in slices
constexpr int DEFAULT_SLICES = 8;   // 2048 values of one patch row a block

__device__ __forceinline__ unsigned abs_bits(float a, float b) {
  return __float_as_uint(fabsf(a - b));
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
patch_delta_kernel(const float* __restrict__ x, const float* __restrict__ r,
                   unsigned* __restrict__ out, int w, int splits,
                   int chunk) {
  const int row = blockIdx.x / splits;
  const int c0 = (blockIdx.x - row * splits) * chunk;
  const int c1 = min(c0 + chunk, w);
  const float* xr = x + (size_t)row * w;
  const float* rr = r + (size_t)row * w;
  unsigned m = 0u;
  if (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* r4 = reinterpret_cast<const float4*>(rr);
    for (int i = c0 / 4 + threadIdx.x; i < c1 / 4; i += THREADS) {
      const float4 a = __ldg(x4 + i);
      const float4 b = __ldg(r4 + i);
      m = max(m, max(max(abs_bits(a.x, b.x), abs_bits(a.y, b.y)),
                     max(abs_bits(a.z, b.z), abs_bits(a.w, b.w))));
    }
  } else {
    for (int i = c0 + threadIdx.x; i < c1; i += THREADS)
      m = max(m, abs_bits(__ldg(xr + i), __ldg(rr + i)));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < THREADS / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(out + row, m);
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The wrapper has
// checked shapes and zeroed out; vec4 means W % 4 == 0 and both operands
// are 16-byte aligned.  slices: the chunk a block takes, in slices of 256
// values, 2, 4, 8, 16 or 32; 0 takes 8; any other value is refused.
extern "C" int launch_patch_delta(const void* x, const void* r, void* out,
                                  int rows, int w, int vec4, int slices,
                                  void* stream) {
  if (slices == 0) slices = DEFAULT_SLICES;
  if (slices != 2 && slices != 4 && slices != 8 && slices != 16 &&
      slices != 32)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || w <= 0) return (int)cudaSuccess;
  const int chunk = SLICE * slices;
  const int splits = (w + chunk - 1) / chunk;
  const long long blocks = (long long)rows * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(r);
  unsigned* o = static_cast<unsigned*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    patch_delta_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        xf, rf, o, w, splits, chunk);
  else
    patch_delta_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        xf, rf, o, w, splits, chunk);
  return (int)cudaGetLastError();
}
