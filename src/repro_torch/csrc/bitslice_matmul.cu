// DBSC bit-slice integer matmul for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bitslice_matmul/kernel.py
// (bitslice_matmul_kernel, body _kernel).  Same function, bit for bit:
//   out = ((hi @ w) << 6) + (lo * prec) @ w          (int32, wrapping)
// where hi, lo are the 6-bit activation planes, w the INT8 weights and
// prec the per-row INT12 (1) / INT6 (0) flag that skips the low slice.
// All arithmetic is done in uint32 so it wraps mod 2^32 exactly as XLA's
// int32 does (signed overflow is undefined in C++); at K=5120 the shifted
// high accumulator can pass 2^31.
//
// What bounds it on an H100: memory.  The operands fit int8, so the card
// could do the ~27 G integer ops of the largest call (M=8192, K=320,
// N=2560) at its int8 tensor rate in ~14 us, while the int32 planes and
// the int32 output the JAX interface fixes are ~108 MB (~32 us).  This
// first kernel is a plain shared-memory tiled int32 GEMM on the CUDA
// cores, so arithmetic, not memory, is what it actually waits on; narrowing
// the planes to int8 and moving to the tensor cores is later work.
// Design: 64x64 output tiles, 256 threads with 4x4 outputs each, K in
// slabs of 16; one pass over K feeds both accumulators (hi and lo share
// every weight load), and prec is applied to lo as the slab is loaded.
// The two DBSC dataflows share this kernel: they only differ in which
// grid axis walks fastest (weight_stationary sweeps M tiles under a fixed
// weight stripe, input_stationary sweeps N tiles under a fixed activation
// stripe), which on Hopper decides what the L2 keeps hot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bitslice_matmul_kernel(const int32_t* __restrict__ hi,
                       const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ w,
                       const int32_t* __restrict__ prec,
                       int32_t* __restrict__ out, int m, int k, int n,
                       int dataflow) {
  __shared__ uint32_t Hs[TK][TM + 1];
  __shared__ uint32_t Ls[TK][TM + 1];
  __shared__ uint32_t Ws[TK][TN];
  __shared__ uint32_t Ps[TM];

  const int mt = dataflow == 0 ? blockIdx.x : blockIdx.y;
  const int nt = dataflow == 0 ? blockIdx.y : blockIdx.x;
  const int m0 = mt * TM, n0 = nt * TN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  if (tid < TM) Ps[tid] = m0 + tid < m ? (uint32_t)prec[m0 + tid] : 0u;

  uint32_t acc_hi[4][4], acc_lo[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc_hi[i][j] = 0u; acc_lo[i][j] = 0u; }

  for (int k0 = 0; k0 < k; k0 += TK) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < (TM * TK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / TK, kk = idx % TK;
      const int row = m0 + r, col = k0 + kk;
      const bool in = row < m && col < k;
      const size_t g = (size_t)row * k + col;
      Hs[kk][r] = in ? (uint32_t)hi[g] : 0u;
      Ls[kk][r] = in ? (uint32_t)lo[g] * Ps[r] : 0u;
    }
#pragma unroll
    for (int e = 0; e < (TK * TN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / TN, c = idx % TN;
      const int row = k0 + kk, col = n0 + c;
      Ws[kk][c] = (row < k && col < n) ? (uint32_t)w[(size_t)row * n + col]
                                       : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      uint32_t a[4], b[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Hs[kk][ty + 16 * i];
        b[i] = Ls[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_hi[i][j] += a[i] * wv[j];
          acc_lo[i][j] += b[i] * wv[j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n)
        out[(size_t)row * n + col] =
            (int32_t)((acc_hi[i][j] << 6) + acc_lo[i][j]);
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  dataflow: 0 =
// weight_stationary, 1 = input_stationary.
extern "C" int launch_bitslice_matmul(const void* hi, const void* lo,
                                      const void* w, const void* prec,
                                      void* out, int m, int k, int n,
                                      int dataflow, void* stream) {
  const int mtiles = (m + TM - 1) / TM, ntiles = (n + TN - 1) / TN;
  const dim3 grid = dataflow == 0 ? dim3(mtiles, ntiles)
                                  : dim3(ntiles, mtiles);
  bitslice_matmul_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(prec),
      static_cast<int32_t*>(out), m, k, n, dataflow);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
