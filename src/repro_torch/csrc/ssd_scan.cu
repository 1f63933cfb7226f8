// Chunked Mamba-2 SSD scan (state-space duality) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_kernel, body _kernel).  Same function, in float32:
//   x (BH, T, p) pre-multiplied by dt, dA (BH, T), B/C rows (BH/heads, T, n)
//   -> y (BH, T, p) and the final state (BH, p, n), the state zeroed at
//   the start of each row.  Row bh reads B and C row bh / heads in place.
// Per chunk of l steps, with dAc = cumsum(dA) over the chunk:
//   y     = ((C B^T) o L) x + exp(dAc) o (C state^T),
//           L[i, j] = exp(dAc_i - dAc_j) for j <= i, else 0
//   state = exp(dAc_last) state + x^T (B o exp(dAc_last - dAc))
// L is a select, never exp(...) * mask: above the diagonal dAc_i - dAc_j
// is positive and its exp can be inf, and inf * 0 is NaN.
//
// What bounds it on an H100: operations.  The chunked form needs
// (l + 1)(n + p) + 4pn flops per step, the two (l, l) products on their
// causal half only (57,536 at l = 128, p = 64, n = 128; 22.6 GFLOP at the
// serve shape BH = 96, T = 4096) against ~0.22 GB of operands when B and
// C are read in place: 0.34 ms at the 67 TFLOP/s float32 rate off the
// tensor cores, 0.07 ms of bytes.
// Design: the TPU kernel walks the chunks in a sequential grid axis with
// the state in VMEM; here one block of 256 threads per (batch*head) row
// walks the chunks in a loop and keeps the (p, n) state in shared memory
// for the whole row (96 blocks on 132 SMs at the serve shape: one wave).
// A chunk's x, B and C tiles, its decays, the state and one 32-row slab
// of (C B^T) o L take 216 KB at l = 128, p = 64, n = 128; the whole
// (l, l) tile would not fit beside them, so the query rows go 32 at a
// time, and a slab only computes the keys at or below its last row.
// Each product keeps a small register tile per thread and reads shared
// memory in broadcast or conflict-free patterns (rows padded to n + 1).
// Any chunk works: l < 32 and l not a multiple of 32 are masked, and a
// chunk above 128 runs as tiles of gcd(chunk, 128), which are chunk
// boundaries too (the chunked form is exact in any tiling; only float
// rounding moves).  The cumsum is one thread's serial loop (l <= 128
// adds), the order of jnp.cumsum.  float32 on the CUDA cores throughout;
// wgmma, TMA and a chunk-parallel split are later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;    // 8 warps
constexpr int QB = 32;          // query rows of one (C B^T) o L slab
constexpr int LMAX = 128;       // longest tile
constexpr int PMAX = 64;        // head dim p
constexpr int NMAX = 128;       // state size n

// Shared-memory layout, in floats.  lr: tile rows rounded up to 32 (the
// padding rows stay zero); bs: row stride of B, C and the state (n + 1,
// so rows that differ by one sit in different banks); ss: row stride of
// the slab.
struct Layout {
  int lr, pr, bs, ss;
  int x, b, c, st, s, da, dac, edac, wdec, total;
};

__host__ __device__ inline Layout layout(int l, int p, int n) {
  Layout o;
  o.lr = (l + 31) / 32 * 32;
  o.pr = (p + 31) / 32 * 32;
  o.bs = n + 1;
  o.ss = o.lr + 1;
  o.x = 0;                          // (lr, p)    x tile
  o.b = o.x + o.lr * p;             // (lr, bs)   B tile
  o.c = o.b + o.lr * o.bs;          // (lr, bs)   C tile
  o.st = o.c + o.lr * o.bs;         // (pr, bs)   state
  o.s = o.st + o.pr * o.bs;         // (QB, ss)   slab of (C B^T) o L
  o.da = o.s + QB * o.ss;           // (lr,)      dA
  o.dac = o.da + o.lr;              // (lr,)      cumsum dA
  o.edac = o.dac + o.lr;            // (lr,)      exp(dAc)
  o.wdec = o.edac + o.lr;           // (lr,)      exp(dAc_last - dAc)
  o.total = o.wdec + o.lr;
  return o;
}

__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ xg, const float* __restrict__ dag,
                const float* __restrict__ bg, const float* __restrict__ cg,
                float* __restrict__ yg, float* __restrict__ stg,
                int t, int p, int n, int l, int heads) {
  extern __shared__ float smem[];
  const Layout L = layout(l, p, n);
  float* xs = smem + L.x;
  float* bsm = smem + L.b;
  float* csm = smem + L.c;
  float* st = smem + L.st;
  float* sl = smem + L.s;
  float* da = smem + L.da;
  float* dac = smem + L.dac;
  float* edac = smem + L.edac;
  float* wdec = smem + L.wdec;
  const int bs = L.bs, ss = L.ss;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x;
  const int grow = row / heads;
  for (int i = tid; i < L.total; i += THREADS) smem[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < t; t0 += l) {
    // 1. the chunk's tiles
    const float* xc = xg + ((size_t)row * t + t0) * p;
    for (int i = tid; i < l * p; i += THREADS) xs[i] = xc[i];
    const float* bc = bg + ((size_t)grow * t + t0) * n;
    const float* cc = cg + ((size_t)grow * t + t0) * n;
    for (int i = tid; i < l * n; i += THREADS) {
      const int j = i / n, k = i - j * n;
      bsm[j * bs + k] = bc[i];
      csm[j * bs + k] = cc[i];
    }
    for (int j = tid; j < l; j += THREADS)
      da[j] = dag[(size_t)row * t + t0 + j];
    __syncthreads();

    // 2. cumsum and decays
    if (tid == 0) {
      float acc = 0.f;
      for (int j = 0; j < l; ++j) {
        acc += da[j];
        dac[j] = acc;
      }
    }
    __syncthreads();
    const float last = dac[l - 1];
    for (int j = tid; j < l; j += THREADS) {
      edac[j] = expf(dac[j]);
      wdec[j] = expf(last - dac[j]);
    }
    __syncthreads();

    // 3. y, 32 query rows at a time
    for (int i0 = 0; i0 < l; i0 += QB) {
      const int jl = min(i0 + QB, l);     // keys at or below the slab
      const int nc = (jl + 15) / 16;
      // (a) slab[il, j] = (C_i . B_j) exp(dAc_i - dAc_j), j <= i:
      //     thread rows il0, il0 + 1; keys tj + 16 c
      {
        const int il0 = 2 * (tid / 16), tj = tid % 16;
        if (i0 + il0 < l) {
          float acc[2][8];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[0][c] = acc[1][c] = 0.f;
          const float* c0 = csm + (i0 + il0) * bs;
          const float* c1 = c0 + bs;
          for (int k = 0; k < n; ++k) {
            const float a0 = c0[k], a1 = c1[k];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              if (c < nc) {
                const float bv = bsm[(tj + 16 * c) * bs + k];
                acc[0][c] += a0 * bv;
                acc[1][c] += a1 * bv;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + il0 + e;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              if (c < nc) {
                const int j = tj + 16 * c;
                sl[(il0 + e) * ss + j] =
                    (i < l && j <= i) ? acc[e][c] * expf(dac[i] - dac[j])
                                      : 0.f;
              }
            }
          }
        }
      }
      __syncthreads();
      // (b) + (c) y[i, q] = sum_j slab[i, j] x[j, q]
      //                   + exp(dAc_i) sum_k C[i, k] state[q, k]:
      //     thread rows warp + 8 r, columns lane + 32 u
      {
        const int nu = (p + 31) / 32;
        float yd[4][2], yo[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) yd[r][0] = yd[r][1] = yo[r][0] =
            yo[r][1] = 0.f;
        for (int j = 0; j < jl; ++j) {
          float xv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int q = lane + 32 * u;
            xv[u] = (u < nu && q < p) ? xs[j * p + q] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float s = sl[(warp + 8 * r) * ss + j];
            yd[r][0] += s * xv[0];
            yd[r][1] += s * xv[1];
          }
        }
        for (int k = 0; k < n; ++k) {
          float sv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u)
            sv[u] = u < nu ? st[(lane + 32 * u) * bs + k] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float cv = csm[(i0 + warp + 8 * r) * bs + k];
            yo[r][0] += cv * sv[0];
            yo[r][1] += cv * sv[1];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + warp + 8 * r;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int q = lane + 32 * u;
            if (i < l && q < p)
              yg[((size_t)row * t + t0 + i) * p + q] =
                  yd[r][u] + edac[i] * yo[r][u];
          }
        }
      }
      __syncthreads();
    }

    // 4. state = exp(dAc_last) state + x^T (B o exp(dAc_last - dAc)):
    //    thread state rows warp + 8 r, columns lane + 32 v
    {
      const int nr = (p + 7) / 8, nv = (n + 31) / 32;
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[r][v] = 0.f;
      for (int j = 0; j < l; ++j) {
        const float w = wdec[j];
        float bv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = lane + 32 * v;
          bv[v] = (v < nv && k < n) ? bsm[j * bs + k] * w : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int q = warp + 8 * r;
          const float xv = (r < nr && q < p) ? xs[j * p + q] : 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[r][v] += xv * bv[v];
        }
      }
      const float decay = edac[l - 1];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int q = warp + 8 * r;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = lane + 32 * v;
          if (r < nr && q < p && v < nv && k < n)
            st[q * bs + k] = decay * st[q * bs + k] + acc[r][v];
        }
      }
    }
    __syncthreads();
  }

  // 5. the final state
  for (int i = tid; i < p * n; i += THREADS) {
    const int q = i / n, k = i - q * n;
    stg[(size_t)row * p * n + i] = st[q * bs + k];
  }
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The wrapper has
// checked dtypes, shapes and contiguity; the limits are checked again here.
extern "C" int launch_ssd_scan(const void* x, const void* dA, const void* B,
                               const void* C, void* y, void* state, int bh,
                               int t, int p, int n, int chunk, int heads,
                               void* stream) {
  if (bh <= 0) return (int)cudaSuccess;
  if (p < 1 || p > PMAX || n < 1 || n > NMAX || chunk < 1 || heads < 1 ||
      bh % heads || t < 0 || t % chunk)
    return (int)cudaErrorInvalidValue;
  const int l = chunk <= LMAX ? chunk : gcd(chunk, LMAX);
  const size_t bytes = (size_t)layout(l, p, n).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<bh, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(state), t, p, n, l, heads);
  return (int)cudaGetLastError();
}
