// PSSA self-attention for Hopper: blocked two-pass softmax with pruning and
// the two PSSA counters, the score matrix never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/pssa_attention/kernel.py
// (pssa_attention_kernel, body _kernel).  It computes the same function:
//   pass 1: running row max m and sum l of exp(s - m) over key tiles;
//   pass 2: p = exp(s - m) / l, keep p >= threshold (and key < kv_len),
//           out += p_kept @ V, nnz = popcount(keep), and the popcount of the
//           patch-XOR'd keep bitmap (each patch XOR'd with its left
//           neighbour, the first patch kept, the last patch of a tile
//           carried into the next tile, padded patches masked).
// q is scaled by sm_scale before the dot, as the TPU kernel does.
//
// What bounds it on an H100: arithmetic.  At T=4096, d=40 the two passes do
// 2 * 2*T*T*d flops per head on fp32 CUDA cores (the f32 interface rules
// out the tensor cores without changing the numbers), against ~42 MB of
// q/k/v/out traffic -- far above the card's ops-per-byte balance.
// Design: one block of 256 threads per (batch*head, 64 query rows); the
// 64-row Q tile stays in shared memory for both passes while 64-key K (and
// V) tiles stream through it, so device traffic is one read of Q and
// 2 reads of K (+1 of V) per query tile.  Each thread owns a 4x4 block of
// the 64x64 score tile (rows ty+16i, keys tx+16j); the 16 threads of a row
// reduce max/sum with half-warp shuffles.  Padded shared rows (d+1) keep
// the K reads free of bank conflicts.  The keep bitmap of a tile row is a
// 64-bit word, so nnz and the patch XOR are two popcounts per row and
// tile.  A later PR can move both products to the tensor cores (wgmma).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// MAXC = ceil(d / 16): output columns each thread accumulates.
template <int MAXC>
__global__ void __launch_bounds__(THREADS)
pssa_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int* __restrict__ nnz_out, int* __restrict__ xor_out,
                      int tq, int tk, int kv_len, int d, int patch,
                      float sm_scale, float threshold) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Qs = smem;                         // BQ x ld, pre-scaled
  float* Ks = Qs + BQ * ld;                 // BK x ld
  float* Vs = Ks + BK * ld;                 // BK x d
  float* Ps = Vs + BK * d;                  // BQ x (BK + 1), pruned probs
  unsigned char* keep =
      reinterpret_cast<unsigned char*>(Ps + BQ * (BK + 1));  // BQ x BK

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* qb = q + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    const int row = q0 + r;
    Qs[r * ld + c] = row < tq ? qb[(size_t)row * d + c] * sm_scale : 0.f;
  }

  float s[4][4];
  auto load_k = [&](int k0) {
    for (int i = tid; i < BK * d; i += THREADS) {
      const int r = i / d, c = i - r * d;
      const int key = k0 + r;
      Ks[r * ld + c] = key < tk ? kb[(size_t)key * d + c] : 0.f;
    }
  };
  auto load_v = [&](int k0) {
    for (int i = tid; i < BK * d; i += THREADS) {
      const int r = i / d;
      const int key = k0 + r;
      Vs[i] = key < tk ? vb[(size_t)k0 * d + i] : 0.f;
    }
  };
  auto scores = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j >= kv_len)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;
  };

  // ---- pass 1: row max and normaliser ----
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = NEG_INF; l[i] = 0.f; }
  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = fmaxf(l[i], 1e-30f);

  // ---- pass 2: prune, p @ V, counters ----
  float acc[4][MAXC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;
  uint64_t prev_bits = 0;           // keep bits of the row's previous tile
  int nnz = 0, xor_ones = 0;        // owned by threads 0..BQ-1 (one row each)
  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();
    load_k(k0);
    load_v(k0);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(s[i][j] - m[i]) / l[i];
        const bool kp = (p >= threshold) && (k0 + c < kv_len);
        Ps[r * (BK + 1) + c] = kp ? p : 0.f;
        keep[r * BK + c] = kp ? 1 : 0;
      }
    }
    __syncthreads();
    if (tid < BQ) {
      uint64_t bits = 0;
      for (int c = 0; c < BK; ++c)
        bits |= (uint64_t)keep[tid * BK + c] << c;
      nnz += __popcll(bits);
      // left neighbour of every patch: the patch before it in this tile,
      // or for the first patch the last patch of the previous tile
      const uint64_t carried = prev_bits >> (BK - patch);
      const uint64_t left =
          patch == BK ? carried : ((bits << patch) | carried);
      const int valid = kv_len - k0;
      const uint64_t valid_mask =
          valid >= BK ? ~0ull : ((1ull << valid) - 1ull);
      xor_ones += __popcll((bits ^ left) & valid_mask);
      prev_bits = bits;
    }
    for (int jj = 0; jj < BK; ++jj) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + jj];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float vv = Vs[jj * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < tq) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) out[((size_t)bh * tq + row) * d + col] = acc[i][c];
      }
    }
  }
  if (tid < BQ && q0 + tid < tq) {
    nnz_out[(size_t)bh * tq + q0 + tid] = nnz;
    xor_out[(size_t)bh * tq + q0 + tid] = xor_ones;
  }
}

template <int MAXC>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int* nnz, int* xr, int bh, int tq, int tk, int kv_len,
                   int d, int patch, float sm_scale, float threshold,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (d + 1) +
                                       (size_t)BK * (d + 1) + (size_t)BK * d +
                                       (size_t)BQ * (BK + 1)) +
                      (size_t)BQ * BK;
  cudaError_t err = cudaFuncSetAttribute(
      pssa_attention_kernel<MAXC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  pssa_attention_kernel<MAXC><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, nnz, xr, tq, tk, kv_len, d, patch, sm_scale, threshold);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The wrapper has
// checked shapes: d in [1, 160], patch divides 64 and kv_len, kv_len <= tk.
extern "C" int launch_pssa_attention(const void* q, const void* k,
                                     const void* v, void* out, void* nnz,
                                     void* xr, int bh, int tq, int tk,
                                     int kv_len, int d, int patch,
                                     float sm_scale, float threshold,
                                     void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  int* ni = static_cast<int*>(nnz);
  int* xi = static_cast<int*>(xr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PSSA_CASE(C)                                                      \
  case C:                                                                 \
    return launch<C>(qf, kf, vf, of, ni, xi, bh, tq, tk, kv_len, d, patch, \
                     sm_scale, threshold, st);
  switch ((d + 15) / 16) {
    PSSA_CASE(1) PSSA_CASE(2) PSSA_CASE(3) PSSA_CASE(4) PSSA_CASE(5)
    PSSA_CASE(6) PSSA_CASE(7) PSSA_CASE(8) PSSA_CASE(9) PSSA_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PSSA_CASE
}
