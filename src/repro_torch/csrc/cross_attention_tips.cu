// Cross-attention with the TIPS CLS score for Hopper, on the TF32 tensor
// cores.
//
// Replaces the TPU kernel src/repro/kernels/cross_attention_tips/kernel.py
// (cross_attention_tips_kernel, body _kernel).  Same function: for every
// pixel query, scores against the whole text-key stripe, scaled by
// 1/sqrt(d) AFTER the dot (as the TPU kernel orders it), keys >= tk masked
// to -1e30 before the row max, a single-pass softmax (row max, exp, sum,
// normalise), out = P @ V, and the per-head CLS attention score cas =
// p[cls_index].  The (Tq, Tk) probabilities live only in registers.
//
// What bounds it on an H100: memory.  At res 64 (16 heads, Tq = 4096,
// Tk = 77, d = 40) the call moves ~21 MB of q and out and does 0.8 GFLOP,
// which on the tensor cores (three TF32 products an operation, 495
// TFLOP/s) takes 5 us against 6.3 us for the bytes.  The kernel it replaced
// ran both products as fp32 FMAs on the CUDA cores, each FMA fed by a
// shared-memory load, at ~13 % of that bound.  Here:
// * Both products run through mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32
//   in the 3xTF32 scheme of csrc/pssa_attention.cu: an f32 operand x is
//   split into big = tf32(x) and small = tf32(x - big), rounded to nearest
//   with ties away from zero, and a product is small*big + big*small, then
//   big*big.  One TF32 product would move the CAS by ~1e-3 against the
//   1e-5 it is held to (tests/test_torch_cross_tf32x3.py).
// * The tensor core truncates its f32 sums toward zero.  Each k-step's
//   three MMAs sum from zero and the step is added on the CUDA cores with
//   half an ulp of it added away from zero (5-20 k-steps for QK^T, 10 for
//   P.V at 77 keys).  Carried in the accumulators, the output came out
//   biased toward zero by ~8e-7 of its mean magnitude; summed per step,
//   by 7.4e-8, 12x the plain version's; with the half ulp, at the plain
//   version's level.  The downstream PSSA counters tie on such biases.
// * A warp owns 16 query rows and holds their scores against the whole
//   stripe in its accumulators: text keys zero-padded to a multiple of 8
//   (77 -> 80: 10 n-tiles of QK^T, 10 k-steps of P.V) and masked.  The
//   row max and sum are quad shuffles; p = expf(s - m) * (1 / sum).  Both
//   the 1/sqrt(d) and the 1/sum are multiplies by an IEEE reciprocal,
//   within an ulp of the divides (which took a fifth of the first
//   version's time); the lane holding column cls_index writes the CAS.  P
//   enters P.V as the A operand where it lies: the C fragment holds keys 2t
//   and 2t+1 of each n-tile, so P.V's k order is permuted (k-column t <->
//   key 2t, t + 4 <-> key 2t + 1) and V is read from the same rows.  QK^T's
//   d order is permuted the same way, so each thread reads its two values
//   of a Q or K fragment row as one float2.
// * The K/V stripe of the block's (batch, head) comes into shared memory
//   once per block by cp.async, 16 bytes a piece where rows allow, zero-
//   padded to 8-key and 8-column multiples (exact).  Up to d = 80 the block
//   splits it once into big and small halves (54 KB at d = 40, 110 KB at
//   d = 80); above, it stays fp32 (106 KB at d = 160) and each warp splits
//   what it reads.  Q fragments come from global memory straight into
//   registers, all of a row's d at once, and are split there.
// * q, k, v and out are read and written through (batch, head, row)
//   strides with d contiguous, so the UNet's head-split views need no copy
//   on the way in and out is written as (B, Tq, H, d), whose (B, H, Tq, d)
//   view the caller's head merge reshapes for free.
// * Blocks of 8 warps (128 rows) per (batch*head, row block), so that a
//   stripe's copy and split serve 128 rows (at res 64 10 % faster than 4
//   warps); where that gives fewer blocks than the card has SMs, 4, 2 or 1
//   warps a block (res 32: 256 blocks of 4).  From d = 96 on, 4 warps a
//   block share one 16-row tile and each takes a quarter of d: its k-steps
//   of QK^T (the partial scores are summed through shared memory in a
//   fixed order) and its n-tiles of P.V.  At res 16 (16 heads, Tq = 256,
//   d = 160) that is 256 blocks, a warp doing the work of a res-64 warp:
//   2.6x faster than 256 blocks of 1 warp over all of d.  The caller may
//   fix the rows a block instead of the rule (the autotuner's
//   ``cross_block_q``): 16, 32, 64 or 128 below d = 81, 16 from it on.
//   Each warp owns its 16 rows, so every choice gives the same bits.
//
// What still holds it (scripts/cross_ablation.py, PERF.md): at res 64 the
// MMAs with their fragment reads (QK^T 32 %, P.V 26 %, of which the small
// terms 20 %), the stripe's copy and split (16 %), the half-ulp steps
// (12 %), the softmax (10 %) and the Q loads (5 %).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// x plus half an ulp of x away from zero (x for 0 and subnormals): x's
// sign and exponent alone are +-2^e, and 2^e * 2^-24 is half an ulp
__device__ __forceinline__ float plus_half_ulp(float x) {
  return fmaf(__uint_as_float(__float_as_uint(x) & 0xff800000u), 0x1p-24f,
              x);
}

// d += a b for one k-step: the three MMAs sum from zero and the step's sum
// is added on the CUDA cores with half an ulp of it away from zero.  The
// tensor core truncates its sums, so a step's sum comes out half an ulp
// short on average; the correction makes it unbiased (PERF.md).
__device__ __forceinline__ void mma3_step(float (&d)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += plus_half_ulp(t[e]);
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

// Element strides of a (batch, head, row, d) operand, d contiguous.
struct Layout {
  long long b, h, t;
};

// Shared row strides, floats.  K fragments are read as float2 (uint2) from
// rows 8j+g at column 8ks+2t: a stride of 8 mod 16 keeps those reads free of
// bank conflicts.  V fragments are read as single floats from rows 2t and
// 2t+1 at column 8c+g: a stride of 4 mod 8 keeps those free of them.
template <int DP>
__host__ __device__ constexpr int ld_k() { return DP % 16 == 8 ? DP : DP + 8; }
template <int DP>
__host__ __device__ constexpr int ld_v() { return DP + 4; }
// Up to d = 80 the stripe is split once per block (big and small halves of
// K and V); above, it stays fp32.
template <int KS>
__host__ __device__ constexpr bool split_in_smem() { return KS <= 10; }
template <int KS>
size_t smem_bytes(int tkp) {
  constexpr int DP = 8 * KS;
  return sizeof(float) * (split_in_smem<KS>() ? 2 : 1) * (size_t)tkp *
         (ld_k<DP>() + ld_v<DP>());
}

// rows [0, tkp) x columns [0, DP) of a (tk, d) matrix at ``src`` (row
// stride ``st``) into ``dst`` (row stride LD); rows past tk and columns past
// d are zero-filled.  ``vec``: 16-byte copies (d, st % 4 == 0, aligned).
template <int DP, int LD>
__device__ __forceinline__ void load_stripe(float* dst, const float* src,
                                            long long st, int tkp, int tk,
                                            int d, bool vec, int tid,
                                            int nthreads) {
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = tid; i < tkp * CH; i += nthreads) {
      const int r = i / CH, c = (i - r * CH) * 4;
      const bool ok = r < tk && c < d;
      cp16(dst + r * LD + c, ok ? src + r * st + c : src, ok);
    }
  } else {
    for (int i = tid; i < tkp * DP; i += nthreads) {
      const int r = i / DP, c = i - r * DP;
      const bool ok = r < tk && c < d;
      cp4(dst + r * LD + c, ok ? src + r * st + c : src, ok);
    }
  }
}

// In place: the fp32 values of ``x`` become their big halves; the small
// halves go to ``small`` at the same offsets.
template <int DP, int LD>
__device__ __forceinline__ void split_stripe(float* x, float* small, int tkp,
                                             int tid, int nthreads) {
  constexpr int CH = DP / 4;
  for (int i = tid; i < tkp * CH; i += nthreads) {
    const int r = i / CH, at = r * LD + (i - r * CH) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + at);
    uint4 hb, hs;
    split(v.x, hb.x, hs.x);
    split(v.y, hb.y, hs.y);
    split(v.z, hb.z, hs.z);
    split(v.w, hb.w, hs.w);
    *reinterpret_cast<uint4*>(x + at) = hb;
    *reinterpret_cast<uint4*>(small + at) = hs;
  }
}

// KS = d_pad / 8: k-steps of QK^T and 8-column n-tiles of P.V; NT = tk_pad
// / 8: n-tiles of QK^T and k-steps of P.V.  DS warps share one 16-row tile,
// each over KS / DS of the k-steps and n-tiles (its slice of d); with DS >
// 1 the block is DS warps, one tile.  Every loop has a compile-time trip
// count and no guard, so the MMAs of different n-tiles interleave.
template <int KS, int NT, int DS>
__global__ void __launch_bounds__(32 * MAX_WARPS)
cross_attention_tips_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, float* __restrict__ cas,
                            int heads, int tq, int tk, int d,
                            int cls_index, float sm_denom, Layout qs,
                            Layout ks_, Layout vs, Layout os, int kvec,
                            int qvec, int ovec) {
  static_assert(KS % DS == 0, "d's k-steps split evenly over DS warps");
  constexpr int DP = 8 * KS;              // d padded with zero columns
  constexpr int KW = KS / DS;             // the warp's k-steps / n-tiles
  constexpr int LK = ld_k<DP>(), LV = ld_v<DP>();
  constexpr bool SPLIT = split_in_smem<KS>();
  extern __shared__ __align__(16) float smem[];
  constexpr int TKP = 8 * NT;             // keys padded with zero rows
  float* Kt = smem;                       // TKP x LK (big halves if SPLIT)
  float* Vt = Kt + TKP * LK;              // TKP x LV (big halves if SPLIT)
  float* Ksm = Vt + TKP * LV;             // small halves (SPLIT only)
  float* Vsm = Ksm + TKP * LK;

  const int nthreads = blockDim.x;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh - bi * heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group, thread in group
  const int row0 = blockIdx.x * (nthreads / (2 * DS)) + warp / DS * 16;
  const int c0 = warp % DS * KW;          // the warp's first k-step of d
  const bool active = row0 < tq;          // warp-uniform; block-uniform
                                          // where DS > 1
  const float* kb = k + bi * ks_.b + hi * ks_.h;
  const float* vb = v + bi * vs.b + hi * vs.h;
  const float* qb = q + bi * qs.b + hi * qs.h;
  float* ob = out + bi * os.b + hi * os.h;

  load_stripe<DP, LK>(Kt, kb, ks_.t, TKP, tk, d, kvec, tid, nthreads);
  load_stripe<DP, LV>(Vt, vb, vs.t, TKP, tk, d, kvec, tid, nthreads);
  cp_commit();

  // The warp's Q rows row0 + g and row0 + g + 8 as raw fp32, k-step ks's
  // columns 8ks+2t and 8ks+2t+1 (the permuted d order): qr[ks] = (row g,
  // col 2t), (row g+8, col 2t), (row g, col 2t+1), (row g+8, col 2t+1),
  // which is the order of the A fragment's a0..a3.  Loaded while the
  // stripe's copies are in flight; rows past tq and columns past d are 0.
  float qr[KW][4];
  {
    const int ra = row0 + g, rb = ra + 8;
    const float* pa = qb + ra * qs.t;
    const float* pb = qb + rb * qs.t;
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const int c = 8 * (c0 + kk) + 2 * t;
      if (qvec) {                   // d even, 8-byte aligned rows
        const float2 z = make_float2(0.f, 0.f);
        const float2 lo = ra < tq && c < d
            ? __ldg(reinterpret_cast<const float2*>(pa + c)) : z;
        const float2 hi2 = rb < tq && c < d
            ? __ldg(reinterpret_cast<const float2*>(pb + c)) : z;
        qr[kk][0] = lo.x, qr[kk][1] = hi2.x;
        qr[kk][2] = lo.y, qr[kk][3] = hi2.y;
      } else {
        qr[kk][0] = ra < tq && c < d ? __ldg(pa + c) : 0.f;
        qr[kk][1] = rb < tq && c < d ? __ldg(pb + c) : 0.f;
        qr[kk][2] = ra < tq && c + 1 < d ? __ldg(pa + c + 1) : 0.f;
        qr[kk][3] = rb < tq && c + 1 < d ? __ldg(pb + c + 1) : 0.f;
      }
    }
  }

  cp_wait_all();
  __syncthreads();
  if constexpr (SPLIT) {
    split_stripe<DP, LK>(Kt, Ksm, TKP, tid, nthreads);
    split_stripe<DP, LV>(Vt, Vsm, TKP, tid, nthreads);
    __syncthreads();
  }
  if (!active) return;

  // ---- QK^T: the warp's 16 x TKP scores (over its slice of d); C
  // fragment of n-tile j: s[j][0] (g, 8j+2t), s[j][1] (g, 8j+2t+1), s[j][2],
  // s[j][3] row g+8 ----
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KW; ++kk) {
    uint32_t ab[4], as[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(qr[kk][e], ab[e], as[e]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // B fragment of K^T: b0 = K[8j+g][8kc+2t], b1 = K[8j+g][8kc+2t+1],
      // kc = c0 + kk
      const int at = (8 * j + g) * LK + 8 * (c0 + kk) + 2 * t;
      uint32_t bb[2], bs[2];
      if constexpr (SPLIT) {
        const uint2 hb = *reinterpret_cast<const uint2*>(Kt + at);
        const uint2 hs = *reinterpret_cast<const uint2*>(Ksm + at);
        bb[0] = hb.x, bb[1] = hb.y, bs[0] = hs.x, bs[1] = hs.y;
      } else {
        const float2 kv = *reinterpret_cast<const float2*>(Kt + at);
        split(kv.x, bb[0], bs[0]);
        split(kv.y, bb[1], bs[1]);
      }
      mma3_step(s[j], ab, as, bb, bs);
    }
  }

  if constexpr (DS > 1) {
    // the DS partial scores of the tile, summed in slice order by every
    // warp alike, through K's room (K is read no more)
    __syncthreads();
    float* red = Kt;                      // DS warps x NT x 4 x 32 lanes
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((warp * NT + j) * 4 + e) * 32 + lane] = s[j][e];
    __syncthreads();
    const int w0 = warp / DS * DS;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = red[((w0 * NT + j) * 4 + e) * 32 + lane];
#pragma unroll
        for (int w = 1; w < DS; ++w)
          x += red[(((w0 + w) * NT + j) * 4 + e) * 32 + lane];
        s[j][e] = x;
      }
  }

  // ---- softmax over each row's keys (rows g and g+8: h = 0, 1) ----
  const float inv_denom = 1.f / sm_denom;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = 8 * j + 2 * t + c < tk ? s[j][2 * h + c] * inv_denom
                                               : NEG_INF;
        s[j][2 * h + c] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = expf(s[j][2 * h + c] - mx);     // masked keys: 0
        s[j][2 * h + c] = e;
        sum += e;
      }
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    const float inv_sum = 1.f / sum;
    float cv = 0.f;
    bool mine = false;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = s[j][2 * h + c] * inv_sum;
        s[j][2 * h + c] = p;
        if (8 * j + 2 * t + c == cls_index) cv = p, mine = true;
      }
    }
    const int row = row0 + g + 8 * h;
    if (mine && c0 == 0 && row < tq) cas[(size_t)bh * tq + row] = cv;
  }

  // ---- P.V: step j multiplies keys 8j..8j+7, k-column t <-> key 8j+2t
  // and t+4 <-> key 8j+2t+1, so the A fragment is P's C fragment
  // reordered; B fragment b0 = V[8j+2t][8c+g], b1 = V[8j+2t+1][8c+g] ----
  float o[KW][4];
#pragma unroll
  for (int c = 0; c < KW; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ab[4], as[4];
    split(s[j][0], ab[0], as[0]);
    split(s[j][2], ab[1], as[1]);
    split(s[j][1], ab[2], as[2]);
    split(s[j][3], ab[3], as[3]);
    const int at = (8 * j + 2 * t) * LV + 8 * c0 + g;
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      uint32_t bb[2], bs[2];
      if constexpr (SPLIT) {
        bb[0] = __float_as_uint(Vt[at + 8 * c]);
        bb[1] = __float_as_uint(Vt[at + 8 * c + LV]);
        bs[0] = __float_as_uint(Vsm[at + 8 * c]);
        bs[1] = __float_as_uint(Vsm[at + 8 * c + LV]);
      } else {
        split(Vt[at + 8 * c], bb[0], bs[0]);
        split(Vt[at + 8 * c + LV], bb[1], bs[1]);
      }
      mma3_step(o[c], ab, as, bb, bs);
    }
  }

  // ---- out: rows g and g+8, columns 8(c0+c)+2t and 8(c0+c)+2t+1 ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < tq) {
      float* op = ob + row * os.t;
#pragma unroll
      for (int c = 0; c < KW; ++c) {
        const int col = 8 * (c0 + c) + 2 * t;
        if (ovec) {
          if (col < d)
            *reinterpret_cast<float2*>(op + col) =
                make_float2(o[c][2 * h], o[c][2 * h + 1]);
        } else {
          if (col < d) op[col] = o[c][2 * h];
          if (col + 1 < d) op[col + 1] = o[c][2 * h + 1];
        }
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

bool even(long long x) { return x % 2 == 0; }
bool quad(long long x) { return x % 4 == 0; }

template <int KS, int NT, int DS>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* cas, int b, int heads, int tq, int tk, int d,
                   int cls_index, float sm_denom, Layout qs, Layout ks,
                   Layout vs, Layout os, int rows, cudaStream_t stream) {
  // rows a block: 0 takes the rule below; else 16 a warp (DS warps on one
  // 16-row tile where DS > 1)
  if (rows != 0 && !(DS == 1 ? rows == 16 || rows == 32 || rows == 64 ||
                                   rows == 128
                             : rows == 16))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_attention_tips_kernel<KS, NT, DS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<KS>(8 * NT));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int bh = b * heads;
  // 4 warps a block, fewer where that leaves SMs without a block; with DS >
  // 1, DS warps on one 16-row tile
  int warps = DS > 1 ? DS : MAX_WARPS;
  while (rows == 0 && DS == 1 && warps > 1 &&
         (long long)((tq + 16 * warps - 1) / (16 * warps)) * bh < sm_count())
    warps /= 2;
  if (rows != 0) warps = rows * DS / 16;
  const int kvec = d % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                   (uintptr_t)v % 16 == 0 && quad(ks.b) && quad(ks.h) &&
                   quad(ks.t) && quad(vs.b) && quad(vs.h) && quad(vs.t);
  const int qvec = d % 2 == 0 && (uintptr_t)q % 8 == 0 && even(qs.b) &&
                   even(qs.h) && even(qs.t);
  const int ovec = d % 2 == 0 && (uintptr_t)out % 8 == 0 && even(os.b) &&
                   even(os.h) && even(os.t);
  const int block_rows = 16 * warps / DS;
  const dim3 grid((tq + block_rows - 1) / block_rows, bh);
  cross_attention_tips_kernel<KS, NT, DS>
      <<<grid, 32 * warps, smem_bytes<KS>(8 * NT), stream>>>(
          q, k, v, out, cas, heads, tq, tk, d, cls_index, sm_denom, qs,
          ks, vs, os, kvec, qvec, ovec);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  q (B, H, Tq, d),
// k and v (B, H, Tk, d) and out (B, H, Tq, d) are addressed through their
// (batch, head, row) element strides, d contiguous; cas is (B*H, Tq)
// contiguous.  The wrapper has checked shapes: d in [1, 160], tk in
// [1, 128], cls_index < tk, B*H <= 65535.  rows: query rows a block, 0 for
// the launch rule (see the design notes); a value the kernel does not take
// at this d is refused.
extern "C" int launch_cross_attention_tips(
    const void* q, const void* k, const void* v, void* out, void* cas, int b,
    int heads, int tq, int tk, int d, int cls_index, float sm_denom,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st,
    int rows, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* cf = static_cast<float*>(cas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tk < 1 || tk > 128 || d < 1 || d > 160 || cls_index < 0 ||
      cls_index >= tk || b < 1 || heads < 1 || (long long)b * heads > 65535)
    return (int)cudaErrorInvalidValue;
  if (tq < 1) return (int)cudaSuccess;
  const Layout qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  // d padded to the next instantiated multiple of 8 (zero columns); up to
  // 80 keys (10 n-tiles) or 128 (16); from d = 96 on, four warps split d
  // (res 16's d = 160: 64 blocks of 4 warps would leave half the SMs idle,
  // 256 of 1 warp each walk all of d)
#define CROSS_CASE(KS)                                                     \
  if ((d + 7) / 8 <= KS)                                                   \
    return tk <= 80                                                        \
        ? (int)launch<KS, 10, (KS >= 12 ? 4 : 1)>(qf, kf, vf, of, cf, b,     \
                                                heads, tq, tk, d,          \
                                                cls_index, sm_denom, qs,   \
                                                ks, vs, os, rows, st)      \
        : (int)launch<KS, 16, (KS >= 12 ? 4 : 1)>(qf, kf, vf, of, cf, b,     \
                                                heads, tq, tk, d,          \
                                                cls_index, sm_denom, qs,   \
                                                ks, vs, os, rows, st);
  CROSS_CASE(1) CROSS_CASE(2) CROSS_CASE(3) CROSS_CASE(4) CROSS_CASE(5)
  CROSS_CASE(6) CROSS_CASE(8) CROSS_CASE(10) CROSS_CASE(12) CROSS_CASE(16)
  CROSS_CASE(20)
#undef CROSS_CASE
  return (int)cudaErrorInvalidValue;
}
