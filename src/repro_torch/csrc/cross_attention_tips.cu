// Cross-attention with the TIPS CLS score for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/cross_attention_tips/kernel.py
// (cross_attention_tips_kernel, body _kernel).  Same function: for every
// pixel query, scores against the whole text-key stripe, divided by sqrt(d)
// AFTER the dot (as the TPU kernel orders it), keys >= tk masked, a
// single-pass softmax (row max, exp, sum, divide), out = P @ V, and the
// per-head CLS attention score cas = p[cls_index].  The (Tq, Tk)
// probability matrix exists only in shared memory.
//
// What bounds it on an H100: at res 64 (16 heads, Tq=4096, Tk=77, d=40)
// the two small products are ~0.8 GFLOP of fp32 on CUDA cores against
// ~21 MB of q/out traffic, so arithmetic and memory are within a factor of
// two of each other; the text stripe is reused by every query tile.
// Design: one block of 256 threads per (batch*head, 64 query rows); the
// whole K/V text stripe (up to 128 keys) and the Q tile sit in shared
// memory, one pass computes everything.  Thread (ty, tx) owns rows
// ty+16i and keys tx+16j; row max and sum are half-warp shuffles.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int THREADS = 256;
constexpr int MAXJ = 8;            // keys per thread: tk <= 16 * MAXJ
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

template <int MAXC>
__global__ void __launch_bounds__(THREADS)
cross_attention_tips_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, float* __restrict__ cas,
                            int tq, int tk, int d, int cls_index,
                            float sm_denom) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int tkp = ((tk + 15) / 16) * 16;   // keys rounded to 16 lanes
  float* Qs = smem;                        // BQ x ld
  float* Ks = Qs + BQ * ld;                // tkp x ld
  float* Vs = Ks + tkp * ld;               // tkp x d
  float* Ps = Vs + tkp * d;                // BQ x (tkp + 1)

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
    Qs[r * ld + c] = row < tq ? qb[(size_t)row * d + c] : 0.f;
  }
  for (int i = tid; i < tkp * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    const bool in = r < tk;
    Ks[r * ld + c] = in ? kb[i] : 0.f;
    Vs[i] = in ? vb[i] : 0.f;
  }
  __syncthreads();

  const int nj = tkp / 16;
  float s[4][MAXJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) s[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + c];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < nj) {
        const float kv = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < nj) {
        s[i][j] = (tx + 16 * j < tk) ? s[i][j] / sm_denom : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
    }
    mx = half_warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < nj) {
        s[i][j] = expf(s[i][j] - mx);       // masked keys: exactly 0
        sum += s[i][j];
      }
    }
    sum = half_warp_sum(sum);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < nj) {
        const int key = tx + 16 * j;
        const float p = s[i][j] / sum;
        Ps[r * (tkp + 1) + key] = p;
        if (key == cls_index && q0 + r < tq)
          cas[(size_t)bh * tq + q0 + r] = p;
      }
    }
  }
  __syncthreads();

  float acc[4][MAXC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;
  for (int jj = 0; jj < tk; ++jj) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (tkp + 1) + jj];
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
}

template <int MAXC>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* cas, int bh, int tq, int tk, int d, int cls_index,
                   float sm_denom, cudaStream_t stream) {
  const size_t tkp = ((tk + 15) / 16) * 16;
  const size_t smem = sizeof(float) * ((size_t)BQ * (d + 1) +
                                       tkp * (d + 1) + tkp * d +
                                       (size_t)BQ * (tkp + 1));
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_tips_kernel<MAXC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  cross_attention_tips_kernel<MAXC><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, cas, tq, tk, d, cls_index, sm_denom);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The wrapper has
// checked shapes: d in [1, 160], tk in [1, 128], cls_index < tk.
extern "C" int launch_cross_attention_tips(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* cas, int bh, int tq, int tk,
                                           int d, int cls_index,
                                           float sm_denom, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* cf = static_cast<float*>(cas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tk < 1 || tk > 16 * MAXJ) return (int)cudaErrorInvalidValue;
#define CROSS_CASE(C)                                                    \
  case C:                                                                \
    return launch<C>(qf, kf, vf, of, cf, bh, tq, tk, d, cls_index,       \
                     sm_denom, st);
  switch ((d + 15) / 16) {
    CROSS_CASE(1) CROSS_CASE(2) CROSS_CASE(3) CROSS_CASE(4) CROSS_CASE(5)
    CROSS_CASE(6) CROSS_CASE(7) CROSS_CASE(8) CROSS_CASE(9) CROSS_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CROSS_CASE
}
