// PSSA self-attention for Hopper on the TF32 tensor cores: blocked two-pass
// softmax with pruning and the two PSSA counters, the score matrix never
// written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/pssa_attention/kernel.py
// (pssa_attention_kernel, body _kernel).  It computes the same function:
//   pass 1: row max m and sum l of exp(s - m) over key tiles;
//   pass 2: p = exp(s - m) / l, keep p >= threshold (and key < kv_len),
//           out += p_kept @ V, nnz = popcount(keep), and the popcount of
//           the patch-XOR'd keep bitmap (each patch XOR'd with its left
//           neighbour, the first patch against zeros, the last patch of a
//           tile carried into the next tile, padded keys masked),
// with s = (q sm_scale) k^T as the TPU kernel scales it.
//
// What bounds it on an H100: the tensor cores.  At (BH, T, d) = (16, 4096,
// 40) the two QK^T passes and the kept P.V take ~34 GFLOP against ~42 MB of
// q, k, v and out.  Both products run through
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 in the 3xTF32 scheme
// (CUTLASS's "fast accurate f32"): an f32 operand x is split into big and
// small TF32 halves and a product is small*big + big*small, then big*big.
// split() rounds both halves to nearest, ties away from zero (the rounding
// of cvt.rna.tf32.f32, done on the integer pipe); pass 2's QK^T uses the
// cheaper split_fast().  A single TF32 product (2^-11 relative) would move
// keys across tau = 1/8192; 3xTF32 is as accurate as fp32.  The bound counts each
// product as three TF32 MMAs at 495 TFLOP/s; mma.sync issues them at well
// under that rate, and they take most of the time (PERF.md, ablation).
//
// Exact counters.  The check holds nnz and the XOR popcount equal to the
// plain version's, which a key on the threshold decides by its rounding:
// * The tensor core truncates its f32 sums, so a score carried through its
//   accumulator drifts toward zero by about half an ulp per MMA, and l,
//   summed over such scores, comes out biased low.  Pass 1 therefore sums
//   each k-step's three MMAs from zero and adds the step on the CUDA cores
//   (rounded to nearest); l is summed in double and rescaled in double.
// * The row max is taken again in the plain version's order (the fp32 dot,
//   one fmaf per column, then times sm_scale) for the keys within a band of
//   the 3xTF32 max, and l moves to that max.
// * Guard band: pass 2 decides each key by a fast p, ex2.approx of
//   s log2e - (m log2e + log2 l); a key whose fast p lies within BAND_REL of
//   the threshold gets its score in the plain version's order and
//   p = expf(s - m) / l with an IEEE divide, as the plain version has it.
//   The band is far wider than the 3xTF32 and fast-p errors (~1e-5), and
//   holds ~1e-4 of the keys.  Pass 2's own scores only place keys against
//   the band, so they stay in the accumulator.
// * Pass 1's terms of l are ex2.approx of (s - m) log2e, summed in f32 per
//   tile: random errors of ~2^-22 a term, which the sum averages out.
// * The output feeds the next layers, where its error moves other keys
//   across tau: P.V splits by split() and sums each step apart as pass 1
//   does, so the output carries no bias toward zero.
//
// Design (FlashAttention-2's layout, on mma.sync):
// * A block of 4 warps takes 64 query rows (2 warps and 32 rows when
//   Tq <= 256, so that res 16 fills the card; the caller may ask for 16, 32
//   or 64 rows a block instead, the autotuner's ``attn_block_q``, and since
//   no row depends on its block every choice gives the same bits); each
//   warp owns 16 rows and
//   keeps the 16 x 64 scores of a key tile in its accumulators.  No row
//   reads another row's data, so a row's scores, m, l, keep bits and output
//   are the same in any block.
// * Q is loaded once per block, pre-scaled, into shared memory, zero-padded
//   to a multiple of 8 columns (exact); up to d = 80 each warp keeps its Q
//   fragments split in registers.  64-key K tiles (and V tiles in pass 2)
//   stream through a double buffer by cp.async, zero-padded the same way,
//   one barrier per tile.  In pass 1 the block splits each K tile once into
//   big and small halves (a second barrier); in pass 2 each warp splits
//   what it reads.  The d order of each QK^T k-step is permuted so that Q
//   and K fragments are read as float2, and the row strides keep every
//   fragment read free of bank conflicts.
// * Row max and sum come from quad shuffles: each thread keeps a partial l
//   for its two rows, summed over the quad once after pass 1.
// * P enters the P.V MMA as the A operand where it lies: the C fragment
//   holds keys 2t and 2t+1 of each 8-key n-tile, so the k order of each P.V
//   step is permuted (k-column t <-> key 2t, t+4 <-> key 2t+1) and the V
//   fragment is read from the same permuted rows.
// * Keep bits: each thread sets the bits of its columns in a 64-bit word per
//   row, OR'd over the quad by shuffles; nnz and the patch XOR are then two
//   popcounts per row and tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;            // keys per tile
constexpr int NT = BK / 8;        // 8-key n-tiles of a score tile
constexpr int MAX_THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
// Guard band: a key whose fast p lies within BAND_REL * threshold of the
// threshold is recomputed in fp32 on the CUDA cores (see pass 2).  The
// 3xTF32 scores are within ~1e-5 of fp32 even on peaky rows, and the fast
// exponential and reciprocal within ~1e-6 relative, so 1e-4 covers both.
constexpr float BAND_REL = 1e-4f;
// The row max: candidates within MAX_BAND_REL * (1 + |m|) of the 3xTF32
// max get their score in the plain version's order.
constexpr float MAX_BAND_REL = 1e-4f;

// scores the guard band recomputed since the last reset (for reporting)
__device__ unsigned long long band_recomputed = 0;

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero;
// the 13 low bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The cheaper split of pass 2, whose scores only place keys against the
// guard band and whose P.V is held to 1e-4: big = x truncated to TF32, small
// = x - big unrounded (the tensor core reads a TF32 operand's upper 19
// bits), within 2^-20 |x| of x against 2^-21 for split().
__device__ __forceinline__ void split_fast(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
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

// d += a b for one k-step of QK^T: the three MMAs accumulate from zero and
// the step's sum is added on the CUDA cores, rounded to nearest.  The tensor
// core truncates its f32 sums, so a score carried through its accumulator
// drifts toward zero by about half an ulp of the running score per MMA;
// here it is truncated at the scale of one step's sum instead.
__device__ __forceinline__ void mma3_step(float (&d)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// One score in the plain version's order: the fp32 dot, one fmaf per
// column in order, then the scale.
__device__ __forceinline__ float plain_score(const float* qr, const float* kr,
                                             int d, float sm_scale) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
  return acc * sm_scale;
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

// Shared row strides, floats.  Q and K fragments are read as float2 (see
// the d order below): a stride of 8 mod 16 keeps those reads free of bank
// conflicts.  V fragments are read as single floats from rows 2t and 2t+1:
// a stride of 4 mod 8 keeps those free of them.
template <int DP>
__host__ __device__ constexpr int ld_qk() { return DP % 16 == 8 ? DP : DP + 8; }
template <int DP>
__host__ __device__ constexpr int ld_v() { return DP + 4; }
// Q, two K tiles and two V tiles; in pass 1 the V tiles' room holds the
// current K tile split into big and small halves.
template <int KS>
constexpr size_t smem_bytes(int bq) {
  constexpr int LQ = ld_qk<8 * KS>(), LV = ld_v<8 * KS>();
  return sizeof(float) * ((size_t)(bq + 2 * BK) * LQ +
                          (size_t)2 * BK * (LQ > LV ? LQ : LV));
}

// keys [k0, k0 + BK) of a (tk, d) matrix into a BK x LD tile, columns
// [0, DP); keys past tk and columns past d are zero-filled, so the pad is
// exact.  ``vec``: 16-byte copies (d % 4 == 0 and 16-byte aligned rows).
template <int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int k0, int tk, int d, bool vec,
                                          int tid, int nthreads) {
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = tid; i < BK * CH; i += nthreads) {
      const int r = i / CH, c = (i - r * CH) * 4;
      const bool ok = k0 + r < tk && c < d;
      cp16(dst + r * LD + c, ok ? src + (size_t)(k0 + r) * d + c : src, ok);
    }
  } else {
    for (int i = tid; i < BK * DP; i += nthreads) {
      const int r = i / DP, c = i - r * DP;
      const bool ok = k0 + r < tk && c < d;
      cp4(dst + r * LD + c, ok ? src + (size_t)(k0 + r) * d + c : src, ok);
    }
  }
}

// KS = d_pad / 8: k-steps of QK^T and 8-column n-tiles of P.V
// Up to d = 40, 4 blocks of 4 warps share an SM (128 registers a thread).
template <int KS>
__global__ void __launch_bounds__(MAX_THREADS, KS <= 5 ? 4 : 1)
pssa_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int* __restrict__ nnz_out, int* __restrict__ xor_out,
                      int tq, int tk, int kv_len, int d, int patch,
                      float sm_scale, float threshold, int vec) {
  constexpr int DP = 8 * KS;              // d padded with zero columns
  constexpr int LQ = ld_qk<DP>(), LV = ld_v<DP>();
  constexpr bool Q_IN_REGS = KS <= 10;
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x;
  const int bq = nthreads / 2;            // 16 rows per warp
  float* Qs = smem;                       // bq x LQ, pre-scaled
  float* Ks = Qs + bq * LQ;               // 2 x BK x LQ
  float* Vs = Ks + 2 * BK * LQ;           // 2 x BK x LV
  uint32_t* Kbig = reinterpret_cast<uint32_t*>(Vs);   // pass 1: BK x LQ
  uint32_t* Ksmall = Kbig + BK * LQ;                  // pass 1: BK x LQ

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group, thread in group
  const int r0 = warp * 16;               // the warp's rows in the block
  const bool active = q0 + r0 < tq;       // warp-uniform
  const float* qb = q + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  const int ntiles = (kv_len + BK - 1) / BK;

  load_tile<DP, LQ>(Ks, kb, 0, tk, d, vec, tid, nthreads);
  cp_commit();
  for (int i = tid; i < bq * DP; i += nthreads) {
    const int r = i / DP, c = i - r * DP;
    const int row = q0 + r;
    Qs[r * LQ + c] =
        row < tq && c < d ? qb[(size_t)row * d + c] * sm_scale : 0.f;
  }
  __syncthreads();

  // The d order of a QK^T k-step is permuted, k-column t <-> column 2t and
  // t+4 <-> 2t+1 of the 8, for Q and K alike, so that each thread's two
  // values of a fragment row are adjacent.  A fragment of Q: a0 (g, 2t),
  // a1 (g+8, 2t), a2 (g, 2t+1), a3 (g+8, 2t+1).
  auto q_frag = [&](int ks, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    const float* p = Qs + (r0 + g) * LQ + 8 * ks + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(p);
    const float2 hi = *reinterpret_cast<const float2*>(p + 8 * LQ);
    split(lo.x, ab[0], as[0]);
    split(hi.x, ab[1], as[1]);
    split(lo.y, ab[2], as[2]);
    split(hi.y, ab[3], as[3]);
  };
  uint32_t qfb[Q_IN_REGS ? KS : 1][4], qfs[Q_IN_REGS ? KS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) q_frag(ks, qfb[ks], qfs[ks]);
  }

  // the warp's 16 x 64 scores of one key tile; C fragment of n-tile j:
  // s[j][0] (g, 8j+2t), s[j][1] (g, 8j+2t+1), s[j][2], s[j][3] row g+8.
  // ``unbiased`` (pass 1, whose scores make l): K's halves come split by
  // split() from Kbig/Ksmall, and each k-step is summed apart and added on
  // the CUDA cores; else (pass 2, whose scores only place keys against the
  // guard band) K is split by split_fast() from Kt and the sum is carried
  // in the accumulator.
  float s[NT][4];
  auto scores = [&](const float* Kt, int k0, auto unbiased) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ab[4], as[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qfb[ks][e];
          as[e] = qfs[ks][e];
        }
      } else {
        q_frag(ks, ab, as);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B fragment of K^T: b0 = K[8j+g][8ks+2t], b1 = K[8j+g][8ks+2t+1]
        const int at = (8 * j + g) * LQ + 8 * ks + 2 * t;
        uint32_t bb[2], bs[2];
        if constexpr (decltype(unbiased)::value) {
          const uint2 hb = *reinterpret_cast<const uint2*>(Kbig + at);
          const uint2 hs = *reinterpret_cast<const uint2*>(Ksmall + at);
          bb[0] = hb.x, bb[1] = hb.y, bs[0] = hs.x, bs[1] = hs.y;
          mma3_step(s[j], ab, as, bb, bs);
        } else {
          const float2 kv = *reinterpret_cast<const float2*>(Kt + at);
          split_fast(kv.x, bb[0], bs[0]);
          split_fast(kv.y, bb[1], bs[1]);
          mma3(s[j], ab, as, bb, bs);
        }
      }
    }
    if (k0 + BK > kv_len) {            // the last tile: mask its pad keys
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        if (key >= kv_len) s[j][0] = s[j][2] = NEG_INF;
        if (key + 1 >= kv_len) s[j][1] = s[j][3] = NEG_INF;
      }
    }
  };

  // ---- pass 1: row max and normaliser (rows g and g+8: h = 0, 1) ----
  // m: running max of the 3xTF32 scores; l: sum of exp(s - m) in double,
  // rescaled in double where m grows; cand/ckey: the thread's largest
  // score of the row and its key, a candidate for the plain-order max.
  float m[2] = {NEG_INF, NEG_INF}, cand[2] = {NEG_INF, NEG_INF};
  double l[2] = {0.0, 0.0};
  int ckey[2] = {0, 0};
  // Per tile: tile it has landed and every warp is done with tile it-1,
  // whose buffer then takes tile it+1; the block splits tile it once into
  // Kbig/Ksmall for all its warps.
  for (int it = 0; it < ntiles; ++it) {
    cp_wait_all();
    __syncthreads();
    if (it + 1 < ntiles)
      load_tile<DP, LQ>(Ks + ((it + 1) & 1) * BK * LQ, kb, (it + 1) * BK, tk,
                        d, vec, tid, nthreads);
    cp_commit();
    {
      const float* raw = Ks + (it & 1) * BK * LQ;
      for (int i = tid; i < BK * DP / 4; i += nthreads) {
        const int r = i / (DP / 4), at = r * LQ + (i - r * (DP / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(raw + at);
        uint4 hb, hs;
        split(x.x, hb.x, hs.x);
        split(x.y, hb.y, hs.y);
        split(x.z, hb.z, hs.z);
        split(x.w, hb.w, hs.w);
        *reinterpret_cast<uint4*>(Kbig + at) = hb;
        *reinterpret_cast<uint4*>(Ksmall + at) = hs;
      }
    }
    __syncthreads();
    if (active) {
      const int k0 = it * BK;
      scores(nullptr, k0, std::true_type{});
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        if (mx > cand[h]) {            // the thread's new largest score
          cand[h] = mx;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (s[j][2 * h + c] == mx) ckey[h] = k0 + 8 * j + 2 * t + c;
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        if (mx > m[h]) {
          l[h] *= exp((double)m[h] - (double)mx);
          m[h] = mx;
        }
        // exp by ex2.approx of (s - m) log2e: s - m is exact near the max,
        // where the terms that make l lie
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          sum += ex2_approx((s[j][2 * h] - m[h]) * LOG2E) +
                 ex2_approx((s[j][2 * h + 1] - m[h]) * LOG2E);
        l[h] += (double)sum;
      }
    }
  }
  __syncthreads();            // pass 1's buffers are free: pass 2's tile 0
  load_tile<DP, LQ>(Ks, kb, 0, tk, d, vec, tid, nthreads);
  load_tile<DP, LV>(Vs, vb, 0, tk, d, vec, tid, nthreads);
  cp_commit();
  // The row max in the plain version's order: the candidates within the
  // band of the 3xTF32 max get their score again, (sum_c q_c k_c, one fmaf
  // each) * sm_scale, and the quad keeps the largest; l moves to that max.
  float mb[2] = {0.f, 0.f}, lf[2] = {1.f, 1.f}, ml[2] = {0.f, 0.f};
  bool rowv[2] = {false, false};
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + g + 8 * h;
      rowv[h] = row < tq;
      l[h] += __shfl_xor_sync(FULL, l[h], 1);
      l[h] += __shfl_xor_sync(FULL, l[h], 2);
      float sb = NEG_INF;
      if (rowv[h] && cand[h] >= m[h] - MAX_BAND_REL * (1.f + fabsf(m[h])))
        sb = plain_score(qb + (size_t)row * d, kb + (size_t)ckey[h] * d, d,
                         sm_scale);
      sb = fmaxf(sb, __shfl_xor_sync(FULL, sb, 1));
      sb = fmaxf(sb, __shfl_xor_sync(FULL, sb, 2));
      mb[h] = sb;
      lf[h] = fmaxf((float)(l[h] * exp((double)m[h] - (double)sb)), 1e-30f);
      ml[h] = sb * LOG2E + log2f(lf[h]);     // p = 2^(s log2e - ml)
    }
  }
  const float band = BAND_REL * threshold;

  // ---- pass 2: prune, P.V, counters ----
  float o[KS][4];
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  uint64_t prev[2] = {0ull, 0ull};   // keep bits of the row's previous tile
  int nnz[2] = {0, 0}, xr[2] = {0, 0};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    cp_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      const int nb = (it + 1) & 1;
      load_tile<DP, LQ>(Ks + nb * BK * LQ, kb, k0 + BK, tk, d, vec, tid,
                        nthreads);
      load_tile<DP, LV>(Vs + nb * BK * LV, vb, k0 + BK, tk, d, vec, tid,
                        nthreads);
    }
    cp_commit();
    if (active) {
      const float* Kt = Ks + (it & 1) * BK * LQ;
      const float* Vt = Vs + (it & 1) * BK * LV;
      scores(Kt, k0, std::false_type{});
      // fast p (ex2.approx, l folded into the exponent); bit 4j + e of bmask marks
      // a key whose fast p lies in the guard band around the threshold.  A
      // masked key has p = 0, outside the band (which is empty at threshold
      // 0); rows past tq are dropped from the mask.
      uint32_t bmask = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2_approx(fmaf(s[j][e], LOG2E, -ml[e >> 1]));
          if (fabsf(p - threshold) < band) bmask |= 1u << (4 * j + e);
          s[j][e] = p;
        }
      bmask &= (rowv[0] ? 0x33333333u : 0u) | (rowv[1] ? 0xccccccccu : 0u);
      // the band: the key's score in the plain version's order and
      // p = expf(s - m) / l with an IEEE divide, as the plain version has it
      if (__any_sync(FULL, bmask != 0)) {
        for (uint32_t mm = bmask; mm; mm &= mm - 1) {
          const int idx = __ffs(mm) - 1;
          const int h = (idx >> 1) & 1;
          const int key = 8 * (idx >> 2) + 2 * t + (idx & 1);
          const float sb = plain_score(qb + (size_t)(q0 + r0 + g + 8 * h) * d,
                                       Kt + key * LQ, d, sm_scale);
          const float pe = expf(sb - mb[h]) / lf[h];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * j + e == idx) s[j][e] = pe;
        }
        int n = __popc(bmask);
        for (int off = 16; off > 0; off >>= 1)
          n += __shfl_xor_sync(FULL, n, off);
        if (lane == 0 && n) atomicAdd(&band_recomputed, (unsigned long long)n);
      }
      // prune in place (a masked key has p = 0); w[h]: keep bits of row h
      // at 8(j%4) + c, in the low (j < 4) or high word, before the thread's
      // 2t offset; masked keys leave the bits by valid_mask below
      uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kp = s[j][e] >= threshold;
          s[j][e] = kp ? s[j][e] : 0.f;
          if (kp) w[e >> 1][j >> 2] |= 1u << (8 * (j & 3) + (e & 1));
        }
      const int valid = kv_len - k0;
      const uint64_t valid_mask =
          valid >= BK ? ~0ull : ((1ull << valid) - 1ull);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t lo = w[h][0] << (2 * t), hi = w[h][1] << (2 * t);
        lo |= __shfl_xor_sync(FULL, lo, 1);
        hi |= __shfl_xor_sync(FULL, hi, 1);
        lo |= __shfl_xor_sync(FULL, lo, 2);
        hi |= __shfl_xor_sync(FULL, hi, 2);
        const uint64_t bits = (((uint64_t)hi << 32) | lo) & valid_mask;
        nnz[h] += __popcll(bits);
        // left neighbour of every patch: the patch before it in this tile,
        // or for the first patch the last patch of the previous tile
        const uint64_t carried = prev[h] >> (BK - patch);
        const uint64_t left =
            patch == BK ? carried : ((bits << patch) | carried);
        xr[h] += __popcll((bits ^ left) & valid_mask);
        prev[h] = bits;
      }
      // P.V: step j multiplies keys 8j..8j+7, k-column t <-> key 8j+2t and
      // t+4 <-> key 8j+2t+1, so the A fragment is P's C fragment reordered.
      // split() and mma3_step(): a carried sum, or split_fast()'s
      // truncation, would pull every output toward zero.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ab[4], as[4];
        split(s[j][0], ab[0], as[0]);
        split(s[j][2], ab[1], as[1]);
        split(s[j][1], ab[2], as[2]);
        split(s[j][3], ab[3], as[3]);
        // B fragment: b0 = V[8j+2t][8c+g], b1 = V[8j+2t+1][8c+g]
        const float* vp = Vt + (8 * j + 2 * t) * LV + g;
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          uint32_t bb[2], bs[2];
          split(vp[8 * c], bb[0], bs[0]);
          split(vp[8 * c + LV], bb[1], bs[1]);
          mma3_step(o[c], ab, as, bb, bs);
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + g + 8 * h;
      if (row < tq) {
        float* op = out + ((size_t)bh * tq + row) * d;
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          const int col = 8 * c + 2 * t;
          if (col < d) op[col] = o[c][2 * h];
          if (col + 1 < d) op[col + 1] = o[c][2 * h + 1];
        }
        if (t == 0) {
          nnz_out[(size_t)bh * tq + row] = nnz[h];
          xor_out[(size_t)bh * tq + row] = xr[h];
        }
      }
    }
  }
}

template <int KS>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int* nnz, int* xr, int bh, int tq, int tk, int kv_len,
                   int d, int patch, float sm_scale, float threshold,
                   int block_q, cudaStream_t stream) {
  // block_q query rows a block (16 a warp); 0: the launch rule
  const int threads =
      block_q > 0 ? 2 * block_q : (tq <= 256 ? 64 : MAX_THREADS);
  const int bq = threads / 2;
  const size_t smem = smem_bytes<KS>(bq);
  cudaError_t err = cudaFuncSetAttribute(
      pssa_attention_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid((tq + bq - 1) / bq, bh);
  pssa_attention_kernel<KS><<<grid, threads, smem, stream>>>(
      q, k, v, out, nnz, xr, tq, tk, kv_len, d, patch, sm_scale, threshold,
      vec);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  The wrapper has
// checked shapes: d in [1, 160], patch divides 64 and kv_len, kv_len <= tk.
// block_q: query rows a block, 16, 32 or 64; 0 takes the launch rule (32
// where tq <= 256, else 64); any other value is refused.
extern "C" int launch_pssa_attention(const void* q, const void* k,
                                     const void* v, void* out, void* nnz,
                                     void* xr, int bh, int tq, int tk,
                                     int kv_len, int d, int patch,
                                     float sm_scale, float threshold,
                                     int block_q, void* stream) {
  if (block_q != 0 && block_q != 16 && block_q != 32 && block_q != 64)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  int* ni = static_cast<int*>(nnz);
  int* xi = static_cast<int*>(xr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // d padded to the next instantiated multiple of 8 (zero columns)
#define PSSA_CASE(KS)                                                      \
  if ((d + 7) / 8 <= KS)                                                   \
    return (int)launch<KS>(qf, kf, vf, of, ni, xi, bh, tq, tk, kv_len, d,  \
                           patch, sm_scale, threshold, block_q, st);
  PSSA_CASE(1) PSSA_CASE(2) PSSA_CASE(3) PSSA_CASE(4) PSSA_CASE(5)
  PSSA_CASE(6) PSSA_CASE(8) PSSA_CASE(10) PSSA_CASE(12) PSSA_CASE(16)
  PSSA_CASE(20)
#undef PSSA_CASE
  return (int)cudaErrorInvalidValue;
}

// The guard band's count of recomputed scores since the last reset, read
// after the launches it covers have finished (0 on success).
extern "C" int pssa_attention_band_count(unsigned long long* count) {
  return (int)cudaMemcpyFromSymbol(count, band_recomputed, sizeof(*count));
}

extern "C" int pssa_attention_band_reset() {
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(band_recomputed, &zero, sizeof(zero));
}
