// Chunked Mamba-2 SSD scan (state-space duality) for Hopper, chunk-parallel
// on the TF32 tensor cores.
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
// What bounds it on an H100: operations.  C B^T is shared by the heads of
// a batch row, so the function needs b T (l + 1) n + BH T ((l + 1) p +
// 4 p n) flops, the (l, l) products on their causal half (16.4 GFLOP at
// the serve shape BH = 96, b = 4, T = 4096, p = 64, n = 128, l = 128)
// against ~0.22 GB of operands: 0.099 ms as three TF32 products at 495
// TFLOP/s, 0.067 ms of bytes.  mma.sync issues the 3xTF32 products far
// below the TF32 peak, and they take most of the time (PERF.md, ablation
// by scripts/ssd_ablation.py).
//
// Design: the chunked algorithm of Mamba-2 (Dao & Gu 2024, section 6), in
// four launches; only the (p, n) state crosses chunks.
// * Phase A, grid (chunks x BH): each chunk's own state contribution
//   S_c = x^T (B o exp(dAc_last - dAc)) (p, n) and its decay
//   exp(dAc_last), into a workspace of (BH, chunks, p, n) floats.
// * Phase B: the state pass, state_in[c] = exp(dAc_last[c-1]) state_in[c-1]
//   + S[c-1], serial over chunks and parallel over (BH, p, n); it writes
//   state_in over S in place, and the final state.
// * Phase G, grid (chunks x BH / heads): C B^T of each chunk, once for the
//   heads that share B and C, on and below the diagonal 16 x 16 tiles, into
//   a workspace of (BH / heads, chunks, l, l) floats that stays in the L2.
// * Phase C, grid (chunks x BH): y = ((C B^T) o L) x + exp(dAc) o
//   (C state_in^T), each y tile written once.
// Block indices run over rows fastest, so the heads of one batch row read
// the same B, C and C B^T chunk back to back, from the L2.
// Tensor cores: every product runs on mma.sync.m16n8k8 TF32 in the 3xTF32
// scheme (CUTLASS's "fast accurate f32"): x = big + small, big = x rounded
// to TF32 to nearest (ties away), small = x - big, and a product is
// small*big + big*small + big*big.  The tensor core reads a TF32 operand's
// upper 19 bits, so small is cut to TF32 toward zero; small's sign is
// either way, so the cut carries no bias, and the pair is within 2^-21 |x|
// of x.  A single TF32 product (2^-11) is not enough:
// tests/test_torch_ssd_chunked.py emulates both on the CPU.
// Phase C: 8 warps, one 16-row tile of the chunk each (a chunk of fewer
// than 8 row tiles shares each one's head-dim tiles out among 2, 4 or 8
// warps), 71 KB of shared memory (x and state_in), so 3 blocks share an
// SM.  A warp reads its rows
// of C (A operand of C state_in^T) and of C B^T from the L2, keeps its y
// tile in registers, and feeds C B^T o L to the second product in a
// permuted k order (k column t <-> key 2t, t + 4 <-> key 2t + 1, x read
// from the same permuted rows).  Warps w and w + 4 run on the same SM
// sub-partition; they take tiles w and 7 - w, so each sub-partition does
// the same work.  Phase A: 8 warps, 16 columns of S each, read of B
// from the L2 as the A operand of S^T = (B o w)^T x, x in shared memory
// (36 KB).  Phase G: 8 warps, one 16-row tile of C B^T each.  Tiles
// arrive by cp.async, zero-padded to 16 rows and 8 columns (exact); row
// strides keep every fragment read free of bank conflicts.
// dAc is a warp scan in float64 (4 steps in order per lane, a Kogge-Stone
// scan of the lanes' sums, each lane's exclusive prefix added), and every
// exponent dAc_i - dAc_j is taken in float64 before it is rounded: at
// large dt dAc reaches ~1e3 within a chunk, where a float32 difference
// would lose ~1e-4 of the decay.
// Tiling: the chunked form is exact in any tiling (only float rounding
// moves), so the kernel does not follow the caller's chunk.  It runs tiles
// of l = min(T, 128) steps, the last one ragged, padded to 16 rows (zeros,
// exact; rows past it masked), for any T and any chunk: the workspace
// (ssd_scan_workspace_floats) stays at most BH ceil(T / 128) (p n + 1) +
// (BH / heads) ceil(T / 128) 128^2 floats, and an odd T, whose chunk is 1,
// runs the same 128-step tiles as the serve prompt.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LMAX = 128;       // the tile, or T when shorter
constexpr int PMAX = 64;        // head dim p
constexpr int NMAX = 128;       // state size n
constexpr int AHEAD = 16;       // phase B: chunks loaded ahead of the chain
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// big = x rounded to TF32 (10 mantissa bits) to nearest, ties away from
// zero; small = x - big, which the tensor core cuts to TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small terms first, then big * big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(d, as, bb[0], bb[1]);
  mma(d, ab, bs[0], bs[1]);
  mma(d, ab, bb[0], bb[1]);
}

// the A fragment of a 16 x 8 step from four floats, split
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split(a0, ab[0], as[0]);
  split(a1, ab[1], as[1]);
  split(a2, ab[2], as[2]);
  split(a3, ab[3], as[3]);
}

__device__ __forceinline__ void split2(float b0, float b1, uint32_t (&bb)[2],
                                       uint32_t (&bs)[2]) {
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes; zero-fills the destination where !v
__device__ __forceinline__ void cp16(void* dst, const void* src, bool v) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(v ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool v) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(v ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [0, rows) x columns [0, cpad) of shared memory (row stride ld) from a
// row-major global tile of nr rows and cols columns; zeros outside it.  vec:
// cols % 4 == 0 and src 16-byte aligned, so rows go in 16-byte pieces.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int nr, int cols, int rows, int cpad,
                                          bool vec) {
  if (vec) {
    const int c4 = cpad / 4;
    for (int i = threadIdx.x; i < rows * c4; i += THREADS) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const bool v = r < nr && c < cols;
      cp16(dst + r * ld + c, v ? src + (size_t)r * cols + c : src, v);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cpad; i += THREADS) {
      const int r = i / cpad, c = i - r * cpad;
      const bool v = r < nr && c < cols;
      cp4(dst + r * ld + c, v ? src + (size_t)r * cols + c : src, v);
    }
  }
}

// dac[0 .. LMAX) = cumsum(da[0 .. l)) in float64, constant past l; one
// warp.  Lane k sums steps 4k .. 4k + 3 in order, the lanes' sums are
// scanned by Kogge-Stone, and each lane adds its exclusive prefix.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ da,
                                             int l, double* dac, int lane) {
  double v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    v[k] = j < l ? (double)da[j] : 0.0;
  }
#pragma unroll
  for (int k = 1; k < 4; ++k) v[k] += v[k - 1];
  double tot = v[3];
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double u = __shfl_up_sync(FULL, tot, off);
    if (lane >= off) tot += u;
  }
  double ex = __shfl_up_sync(FULL, tot, 1);
  if (lane == 0) ex = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) dac[4 * lane + k] = ex + v[k];
}

// Shared layout, in floats.  lr: tile rows rounded up to 16; p8, n8:
// the padded widths the fragments read; sx, sb: row strides of x and of B
// and C, 4 mod 32 (conflict-free scalar fragment reads); ss: row stride of
// the state, 8 mod 32 (conflict-free float2 reads).
struct Dims {
  int lr, p8, n8, sx, sb, ss;
};

__host__ __device__ inline Dims dims(int l, int p, int n) {
  Dims d;
  d.lr = (l + 15) / 16 * 16;
  d.p8 = (p + 7) / 8 * 8;
  d.n8 = (n + 7) / 8 * 8;
  d.sx = (p + 31) / 32 * 32 + 4;
  d.sb = (n + 31) / 32 * 32 + 4;
  d.ss = (n + 31) / 32 * 32 + 8;
  return d;
}

__host__ __device__ inline int smem_a(const Dims& d) {   // dAc, w, x
  return 2 * LMAX + LMAX + d.lr * d.sx;
}

__host__ __device__ inline int smem_g(const Dims& d) {   // B, C
  return 2 * d.lr * d.sb;
}

__host__ __device__ inline int smem_c(const Dims& d) {   // dAc, e, x, st
  return 2 * LMAX + LMAX + d.lr * d.sx + d.p8 * d.ss;
}

// Phase A: S_c = x^T (B o w), w = exp(dAc_last - dAc), and exp(dAc_last),
// taken as S_c^T = (B o w)^T x: warp w owns state columns 16w .. 16w + 15,
// reads them of B from the L2 as its A operand (k column t <-> step k0 +
// 2t, t + 4 <-> k0 + 2t + 1) and x from shared memory.
__global__ void __launch_bounds__(THREADS, 3)
ssd_scan_kernel_state(const float* __restrict__ xg,
                      const float* __restrict__ dag,
                      const float* __restrict__ bg, float* __restrict__ ws,
                      float* __restrict__ dec, int bh, int t, int p, int n,
                      int tl, int heads, int nchunks, int vx) {
  extern __shared__ float4 smem4[];
  const Dims D = dims(tl, p, n);
  double* dac = reinterpret_cast<double*>(smem4);
  float* w = reinterpret_cast<float*>(dac + LMAX);
  float* xs = w + LMAX;
  const int sx = D.sx;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c = blockIdx.x / bh, row = blockIdx.x - c * bh;
  const int t0 = c * tl, grow = row / heads;
  const int l = min(tl, t - t0), lrc = (l + 15) / 16 * 16;   // ragged last

  load_tile(xs, sx, xg + ((size_t)row * t + t0) * p, l, p, D.lr, D.p8, vx);
  cp_commit();
  if (warp == 0) chunk_cumsum(dag + (size_t)row * t + t0, l, dac, lane);
  cp_wait_all();
  __syncthreads();
  const double last = dac[l - 1];
  if (tid < LMAX) w[tid] = tid < l ? expf((float)(last - dac[tid])) : 0.f;
  if (tid == 0) dec[(size_t)row * nchunks + c] = expf((float)last);
  __syncthreads();

  const int np8 = D.p8 / 8;
  const float* b0 = bg + ((size_t)grow * t + t0) * n;
  float* wsc = ws + ((size_t)row * nchunks + c) * p * n;
  for (int n0 = 16 * warp; n0 < n; n0 += 16 * WARPS) {
    const int ka = n0 + g, kb = ka + 8;
    float acc[PMAX / 8][4];
#pragma unroll
    for (int q = 0; q < PMAX / 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < lrc; k0 += 8) {
      const int j0 = k0 + 2 * t4, j1 = j0 + 1;
      const float* r0 = b0 + (size_t)j0 * n;
      const float* r1 = r0 + n;
      const float w0 = w[j0], w1 = w[j1];     // zero past l
      uint32_t ab[4], as[4];
      split4(j0 < l && ka < n ? __ldg(r0 + ka) * w0 : 0.f,
             j0 < l && kb < n ? __ldg(r0 + kb) * w0 : 0.f,
             j1 < l && ka < n ? __ldg(r1 + ka) * w1 : 0.f,
             j1 < l && kb < n ? __ldg(r1 + kb) * w1 : 0.f, ab, as);
      const float* x0 = xs + j0 * sx + g;
#pragma unroll
      for (int q = 0; q < PMAX / 8; ++q) {
        if (q < np8) {
          uint32_t bb[2], bsm[2];
          split2(x0[8 * q], x0[8 * q + sx], bb, bsm);
          mma3(acc[q], ab, as, bb, bsm);
        }
      }
    }
    // acc rows are state columns, its columns head-dim rows: S[q][k]
#pragma unroll
    for (int q = 0; q < PMAX / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = e < 2 ? ka : kb, qq = 8 * q + 2 * t4 + (e & 1);
        if (q < np8 && k < n && qq < p) wsc[(size_t)qq * n + k] = acc[q][e];
      }
    }
  }
}

// Phase B: state_in[c] = dec[c - 1] state_in[c - 1] + S[c - 1] over the
// workspace in place, the final state after the last chunk.  One thread
// per (row, 4 state elements) when p n % 4 == 0, else per element; loads
// go ahead of the chain AHEAD chunks at a time (16 read 7 % faster than 8
// at the serve shape, scripts/ssd_ablation.py).
__device__ __forceinline__ float4 fma4(float d, float4 a, float4 b) {
  return make_float4(d * a.x + b.x, d * a.y + b.y, d * a.z + b.z,
                     d * a.w + b.w);
}

__device__ __forceinline__ float fma4(float d, float a, float b) {
  return d * a + b;
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel_pass(V* __restrict__ ws, const float* __restrict__ dec,
               V* __restrict__ state, int bh, int pnv, int nchunks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)bh * pnv) return;
  const size_t row = i / pnv, e = i - row * pnv;
  V* s = ws + row * nchunks * pnv + e;
  const float* dc = dec + row * nchunks;
  V run{};
  for (int c0 = 0; c0 < nchunks; c0 += AHEAD) {
    V v[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < nchunks) v[k] = s[(size_t)(c0 + k) * pnv];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k < nchunks) {
        s[(size_t)(c0 + k) * pnv] = run;
        run = fma4(dc[c0 + k], run, v[k]);
      }
    }
  }
  state[i] = run;
}

// Phase G: C B^T of one chunk for the rows that share B and C, on and
// below the diagonal 16 x 16 tiles: G[i][j] for j < 16 (i / 16 + 1).
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel_cbt(const float* __restrict__ bg, const float* __restrict__ cg,
              float* __restrict__ gw, int groups, int t, int n, int tl,
              int nchunks, int vb) {
  extern __shared__ float4 smem4[];
  const Dims D = dims(tl, 1, n);
  float* bs = reinterpret_cast<float*>(smem4);
  float* cs = bs + D.lr * D.sb;
  const int sb = D.sb, lr = D.lr;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c = blockIdx.x / groups, grow = blockIdx.x - c * groups;
  const int t0 = c * tl, l = min(tl, t - t0), lrc = (l + 15) / 16 * 16;

  load_tile(bs, sb, bg + ((size_t)grow * t + t0) * n, l, n, lr, D.n8, vb);
  load_tile(cs, sb, cg + ((size_t)grow * t + t0) * n, l, n, lr, D.n8, vb);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  const int rt = warp < 4 ? warp : 11 - warp;
  if (16 * rt >= lrc) return;
  const int i0 = 16 * rt, nkt = 2 * (rt + 1);
  float sacc[LMAX / 8][4];
#pragma unroll
  for (int j = 0; j < LMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
  const float* c0 = cs + (i0 + g) * sb + t4;
  for (int k0 = 0; k0 < D.n8; k0 += 8) {
    uint32_t ab[4], as[4];
    split4(c0[k0], c0[k0 + 8 * sb], c0[k0 + 4], c0[k0 + 8 * sb + 4], ab, as);
    const float* b0 = bs + g * sb + k0 + t4;
#pragma unroll
    for (int j = 0; j < LMAX / 8; ++j) {
      if (j < nkt) {
        uint32_t bb[2], bsm[2];
        split2(b0[8 * j * sb], b0[8 * j * sb + 4], bb, bsm);
        mma3(sacc[j], ab, as, bb, bsm);
      }
    }
  }
  float* g0 = gw + ((size_t)grow * nchunks + c) * lr * lr;
#pragma unroll
  for (int j = 0; j < LMAX / 8; ++j) {
    if (j < nkt) {
      const int k = 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(g0 + (i0 + g) * lr + k) =
          make_float2(sacc[j][0], sacc[j][1]);
      *reinterpret_cast<float2*>(g0 + (i0 + g + 8) * lr + k) =
          make_float2(sacc[j][2], sacc[j][3]);
    }
  }
}

// two consecutive floats of a global row, zero past n or for a padded row
__device__ __forceinline__ float2 ld2(const float* __restrict__ r, int k,
                                      int n, bool valid, bool vec) {
  if (vec)
    return valid && k < n ? __ldg(reinterpret_cast<const float2*>(r + k))
                          : make_float2(0.f, 0.f);
  return make_float2(valid && k < n ? __ldg(r + k) : 0.f,
                     valid && k + 1 < n ? __ldg(r + k + 1) : 0.f);
}

// Phase C: y = ((C B^T) o L) x + exp(dAc) o (C state_in^T).
__global__ void __launch_bounds__(THREADS, 3)
ssd_scan_kernel_out(const float* __restrict__ xg,
                    const float* __restrict__ dag,
                    const float* __restrict__ cg, const float* __restrict__ ws,
                    const float* __restrict__ gw, float* __restrict__ yg,
                    int bh, int t, int p, int n, int tl, int heads,
                    int nchunks, int vx, int vb) {
  extern __shared__ float4 smem4[];
  const Dims D = dims(tl, p, n);
  double* dac = reinterpret_cast<double*>(smem4);
  float* edac = reinterpret_cast<float*>(dac + LMAX);
  float* xs = edac + LMAX;
  float* st = xs + D.lr * D.sx;
  const int sx = D.sx, ss = D.ss, lr = D.lr;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c = blockIdx.x / bh, row = blockIdx.x - c * bh;
  const int t0 = c * tl, grow = row / heads;
  const int l = min(tl, t - t0);     // the last tile may be ragged
  const bool carry = c > 0;          // state_in of the first chunk is zero

  load_tile(xs, sx, xg + ((size_t)row * t + t0) * p, l, p, lr, D.p8, vx);
  if (carry)
    load_tile(st, ss, ws + ((size_t)row * nchunks + c) * p * n, p, n, D.p8,
              D.n8, n % 4 == 0);
  cp_commit();
  if (warp == 0) chunk_cumsum(dag + (size_t)row * t + t0, l, dac, lane);
  cp_wait_all();
  __syncthreads();
  if (tid < LMAX) edac[tid] = expf((float)dac[tid]);
  __syncthreads();

  // 8 row tiles: sub-partition k runs warps k and k + 4, row tiles k and
  // 7 - k.  Fewer tiles (a short or ragged tile): qs warps share a row
  // tile, warp w taking its head-dim tiles q with q % qs == w % qs.
  const int ntile = (l + 15) / 16;
  int qs = 1;
  while (2 * qs * ntile <= WARPS) qs *= 2;
  const int rt = qs > 1 ? warp / qs : warp < 4 ? warp : 11 - warp;
  const int qp = warp & (qs - 1);
  if (rt >= ntile) return;
  const int i0 = 16 * rt;
  const int nkt = 2 * (rt + 1);      // key tiles of 8 at or below row i0+15
  const int np8 = D.p8 / 8;
  const auto mine = [&](int q) { return q < np8 && (q & (qs - 1)) == qp; };
  const int r0 = i0 + g, r1 = r0 + 8;
  float yacc[PMAX / 8][4];
#pragma unroll
  for (int q = 0; q < PMAX / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[q][e] = 0.f;

  // C state_in^T, k column t <-> state column 2t, t + 4 <-> 2t + 1
  if (carry) {
    const float* cr0 = cg + ((size_t)grow * t + t0 + r0) * n;
    const float* cr1 = cr0 + 8 * (size_t)n;
    const bool vc = vb && n % 2 == 0;
#pragma unroll 2
    for (int k0 = 0; k0 < D.n8; k0 += 8) {
      const int k = k0 + 2 * t4;
      const float2 a0 = ld2(cr0, k, n, r0 < l, vc);
      const float2 a1 = ld2(cr1, k, n, r1 < l, vc);
      uint32_t ab[4], as[4];
      split4(a0.x, a1.x, a0.y, a1.y, ab, as);
      const float* s0 = st + g * ss + k;
#pragma unroll
      for (int q = 0; q < PMAX / 8; ++q) {
        if (mine(q)) {
          const float2 b = *reinterpret_cast<const float2*>(s0 + 8 * q * ss);
          uint32_t bb[2], bsm[2];
          split2(b.x, b.y, bb, bsm);
          mma3(yacc[q], ab, as, bb, bsm);
        }
      }
    }
    // the carried part decays by exp(dAc_i)
    const float e0 = edac[r0], e1 = edac[r1];
#pragma unroll
    for (int q = 0; q < PMAX / 8; ++q) {
      yacc[q][0] *= e0;
      yacc[q][1] *= e0;
      yacc[q][2] *= e1;
      yacc[q][3] *= e1;
    }
  }

  // y += (C B^T o L) x, L a select, its exponents taken in float64; the
  // C B^T fragments come from the L2 in the C layout, which is the A
  // layout for k column t <-> key 8j + 2t, t + 4 <-> key 8j + 2t + 1
  const float* g0 = gw + ((size_t)grow * nchunks + c) * lr * lr + r0 * lr;
  const double d0 = dac[r0], d1 = dac[r1];
#pragma unroll 4
  for (int j = 0; j < nkt; ++j) {
    const int k = 8 * j + 2 * t4;
    const float2 ga = __ldg(reinterpret_cast<const float2*>(g0 + k));
    const float2 gb = __ldg(reinterpret_cast<const float2*>(g0 + 8 * lr + k));
    const double da = dac[k], db = dac[k + 1];
    const float m0 = k <= r0 ? ga.x * ex2_approx((float)(d0 - da) * LOG2E)
                             : 0.f;
    const float m1 = k + 1 <= r0 ? ga.y * ex2_approx((float)(d0 - db) * LOG2E)
                                 : 0.f;
    const float m2 = k <= r1 ? gb.x * ex2_approx((float)(d1 - da) * LOG2E)
                             : 0.f;
    const float m3 = k + 1 <= r1 ? gb.y * ex2_approx((float)(d1 - db) * LOG2E)
                                 : 0.f;
    uint32_t ab[4], as[4];
    split4(m0, m2, m1, m3, ab, as);
    const float* x0 = xs + k * sx + g;
#pragma unroll
    for (int q = 0; q < PMAX / 8; ++q) {
      if (mine(q)) {
        uint32_t bb[2], bsm[2];
        split2(x0[8 * q], x0[8 * q + sx], bb, bsm);
        mma3(yacc[q], ab, as, bb, bsm);
      }
    }
  }

  float* y0 = yg + ((size_t)row * t + t0) * p;
#pragma unroll
  for (int q = 0; q < PMAX / 8; ++q) {
    const int col = 8 * q + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, cc = col + (e & 1);
      if (mine(q) && r < l && cc < p) y0[(size_t)r * p + cc] = yacc[q][e];
    }
  }
}

// The tiling and the workspace, in floats: C B^T of each shared B/C row
// and tile (BH / heads x tiles x lr x lr), then each row's per-tile states
// S and state_in (BH x tiles x p x n), then its per-tile decays (BH x
// tiles).  The wrapper sizes its buffer by ssd_scan_workspace_floats.
struct Plan {
  int tl, tiles;
  size_t states, decays, total;
};

Plan plan(int bh, int t, int p, int n, int heads) {
  Plan q;
  q.tl = t >= LMAX ? LMAX : t > 0 ? t : 1;
  q.tiles = (t + q.tl - 1) / q.tl;
  const int lr = dims(q.tl, p, n).lr;
  q.states = (size_t)(bh / heads) * q.tiles * lr * lr;
  q.decays = q.states + (size_t)bh * q.tiles * p * n;
  q.total = q.decays + (size_t)bh * q.tiles;
  return q;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Floats of the workspace that launch_ssd_scan needs (0 for a shape it
// refuses).
extern "C" long long ssd_scan_workspace_floats(int bh, int t, int p, int n,
                                               int heads) {
  if (bh <= 0 || heads < 1 || bh % heads || t < 0 || p < 1 || n < 1)
    return 0;
  return (long long)plan(bh, t, p, n, heads).total;
}

// Returns the CUDA error of the launches (0 on success).  The wrapper has
// checked dtypes, shapes and contiguity and allocated the workspace of
// ssd_scan_workspace_floats.  The limits are checked again here; chunk is
// the caller's, checked to divide T, and does not set the tiling.
extern "C" int launch_ssd_scan(const void* x, const void* dA, const void* B,
                               const void* C, void* y, void* state, void* ws,
                               int bh, int t, int p, int n, int chunk,
                               int heads, void* stream) {
  if (bh <= 0) return (int)cudaSuccess;
  if (p < 1 || p > PMAX || n < 1 || n > NMAX || chunk < 1 || heads < 1 ||
      bh % heads || t < 0 || t % chunk)
    return (int)cudaErrorInvalidValue;
  const Plan q = plan(bh, t, p, n, heads);
  const int l = q.tl, nchunks = q.tiles, groups = bh / heads;
  const Dims D = dims(l, p, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(dA);
  const float* bf = static_cast<const float*>(B);
  const float* cf = static_cast<const float*>(C);
  float* gw = static_cast<float*>(ws);
  float* wsf = gw + q.states;
  float* dec = gw + q.decays;
  const int vx = p % 4 == 0 && aligned16(x);
  const int vb = n % 4 == 0 && aligned16(B) && aligned16(C);
  cudaError_t err;
  if (nchunks > 0) {
    const size_t bytes = (size_t)smem_a(D) * sizeof(float);
    if ((err = set_smem(ssd_scan_kernel_state, bytes)) != cudaSuccess)
      return (int)err;
    ssd_scan_kernel_state<<<nchunks * bh, THREADS, bytes, s>>>(
        xf, af, bf, wsf, dec, bh, t, p, n, l, heads, nchunks, vx);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if ((p * n) % 4 == 0) {
    const size_t items = (size_t)bh * p * n / 4;
    ssd_scan_kernel_pass<float4><<<(unsigned)((items + THREADS - 1) / THREADS),
                             THREADS, 0, s>>>(
        reinterpret_cast<float4*>(wsf), dec, static_cast<float4*>(state), bh,
        p * n / 4, nchunks);
  } else {
    const size_t items = (size_t)bh * p * n;
    ssd_scan_kernel_pass<float><<<(unsigned)((items + THREADS - 1) / THREADS),
                            THREADS, 0, s>>>(
        wsf, dec, static_cast<float*>(state), bh, p * n, nchunks);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nchunks > 0) {
    const size_t gbytes = (size_t)smem_g(D) * sizeof(float);
    if ((err = set_smem(ssd_scan_kernel_cbt, gbytes)) != cudaSuccess)
      return (int)err;
    ssd_scan_kernel_cbt<<<nchunks * groups, THREADS, gbytes, s>>>(
        bf, cf, gw, groups, t, n, l, nchunks, vb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t bytes = (size_t)smem_c(D) * sizeof(float);
    if ((err = set_smem(ssd_scan_kernel_out, bytes)) != cudaSuccess)
      return (int)err;
    ssd_scan_kernel_out<<<nchunks * bh, THREADS, bytes, s>>>(
        xf, af, cf, wsf, gw, static_cast<float*>(y), bh, t, p, n, l, heads,
        nchunks, vx, vb);
  }
  return (int)cudaGetLastError();
}
