// DBSC bit-slice integer matmul for Hopper, on the int8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/bitslice_matmul/kernel.py
// (bitslice_matmul_kernel, body _kernel).  Same function, bit for bit:
//   out = ((hi @ w) << 6) + (lo * prec) @ w          (int32, wrapping)
// where hi, lo are the 6-bit activation planes, w the INT8 weights and
// prec the per-row INT12 (1) / INT6 (0) flag that skips the low slice.
//
// Domain (the TPU kernel's contract, and all that ops.py feeds): hi, lo in
// [0, 63], w in [-128, 127], prec in {0, 1}.  Every operand then fits int8
// exactly, so the products run as mma.sync.m16n8k32.s8.s8.s32.  Each
// product is at most 63 * 128 = 8064 in size, so neither s32 accumulator
// can overflow for K <= 266305; the wrapper refuses a larger K.  The shift
// and the add happen in uint32 in the epilogue, so the result wraps mod
// 2^32 exactly as XLA's int32 does (at K = 5120 the shifted high
// accumulator passes 2^31).
//
// What bounds it on an H100: bytes.  The interface fixes int32 planes and
// an int32 output: at the main shape (M=8192, K=320, N=2560) up to 108 MB
// (the lo plane of an INT6 row is not read), of which the output is
// 84 MB, ~32 us at 3.35 TB/s, while the ~27 G integer ops take ~14 us at
// the int8 tensor rate.  The kernel reads ~0.146 ms there, ~4.7x that
// bound, and what holds it back is not measured yet.  Two candidates:
// each block stages its operands from L2 as int32, 4 bytes per int8
// value (up to 48 KB per 32-deep slab of a 128x128 tile), and every slab
// takes a narrowing pass through shared memory between two barriers.
//
// Design:
// * 128x128 output tile per block, 16 warps (4 along M x 4 along N), each
//   warp 32x32 = 2 m16 x 4 n8 fragments with two s32 accumulators each:
//   hi and lo.  Each B fragment feeds two MMAs, one against the hi tile
//   and one against the lo tile: the DBSC "shared weight, two slices"
//   datapath.  A warp skips the lo MMAs of a 16-row fragment whose rows are
//   all INT6 (a ballot over prec), and no block reads the lo plane of an
//   INT6 row: it is zero-filled, which is lo * prec for prec in {0, 1}.
// * K in slabs of 32 int8 values (one m16n8k32 step).  cp.async copies
//   each slab's raw int32 rows into a 4-stage ring in shared memory, 16
//   bytes at a time where rows are 16-byte aligned and 4 at a time on a
//   ragged or unaligned row (K = 77: a 308-byte stride), zero-filled past
//   M, K and N; three slabs are in flight while one is used.  Each slab is
//   then narrowed to int8 tiles (hi and lo as they are, w transposed to
//   (N, K) so that B sits K-contiguous per output column, as the row.col
//   int8 MMA needs) and read with ldmatrix.  Narrowing in registers on
//   the way from global memory held only one slab in flight beside the
//   accumulators and measured slower (PERF.md).
// * Where the output has too few 128x128 tiles to fill the card (the
//   ff_out shapes), K is split over up to 16 blocks per tile: the output
//   is zeroed and each split adds its (hi << 6) + lo into it with an
//   integer atomic add, which is exact mod 2^32 in any order.
// * The two DBSC dataflows are block rasterisations: weight_stationary
//   sweeps M tiles fastest under a fixed weight stripe, input_stationary
//   sweeps N tiles fastest under a fixed activation stripe, which on
//   Hopper decides what the L2 keeps hot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;                  // block tile rows
constexpr int TN = 128;                  // block tile columns
constexpr int TK = 32;                   // K slab, int8 values
constexpr int RW = TK / 4 + 4;           // words per int8 row: 8 + 4 pad
constexpr int THREADS = 512;
constexpr int STAGES = 4;                // raw int32 slabs in the ring
constexpr int MAX_SPLITS = 16;
constexpr int RAW_WORDS = TM * TK + TM * TK + TK * TN;   // hi, lo, w
constexpr int I8_WORDS = TM * RW + TM * RW + TN * RW;     // Ah, Al, Bs
constexpr size_t SMEM_BYTES =
    (size_t)(STAGES * RAW_WORDS + I8_WORDS + TM) * sizeof(int32_t);

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  // low bytes of a, b, c, d -> one word, a in the lowest byte
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
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

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 1)
bitslice_matmul_kernel(const int32_t* __restrict__ hi,
                       const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ w,
                       const int32_t* __restrict__ prec,
                       int32_t* __restrict__ out, int m, int k, int n,
                       int dataflow, int slabs_per_split, int vec_a,
                       int vec_w, int atomic) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* raw = smem;                                       // the ring
  uint32_t* Ah = reinterpret_cast<uint32_t*>(smem + STAGES * RAW_WORDS);
  uint32_t* Al = Ah + TM * RW;           // int8 (M, K) rows, hi and lo
  uint32_t* Bs = Al + TM * RW;           // int8 (N, K) rows, w transposed
  int* Ps = reinterpret_cast<int*>(Bs + TN * RW);

  const int mt = dataflow == 0 ? blockIdx.x : blockIdx.y;
  const int nt = dataflow == 0 ? blockIdx.y : blockIdx.x;
  const int m0 = mt * TM, n0 = nt * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;      // MMA group, thread in group
  const int wm = warp & 3, wn = warp >> 2;      // warp's 32x32 sub-tile
  const int slabs = (k + TK - 1) / TK;
  const int s_begin = blockIdx.z * slabs_per_split;
  const int s_end = min(s_begin + slabs_per_split, slabs);

  if (tid < TM) Ps[tid] = m0 + tid < m ? prec[m0 + tid] : 0;
  __syncthreads();

  unsigned lo_mask = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wm * 32 + i * 16 + g;
    if (__any_sync(0xffffffffu, Ps[r] != 0 || Ps[r + 8] != 0))
      lo_mask |= 1u << i;
  }

  int32_t acc_hi[2][4][4], acc_lo[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) { acc_hi[i][j][c] = 0; acc_lo[i][j][c] = 0; }

  // copy map: the planes are 128 rows x 8 chunks of 16 bytes per slab, the
  // weights 32 rows x 32 chunks; two chunks of each per thread
  int a_r[2], a_c[2], w_r[2], w_c[2];
  bool a_ok[2], l_ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int idx = tid + e * THREADS;
    a_r[e] = idx >> 3;
    a_c[e] = (idx & 7) * 4;
    a_ok[e] = m0 + a_r[e] < m;
    l_ok[e] = a_ok[e] && Ps[a_r[e]] != 0;
    w_r[e] = idx >> 5;
    w_c[e] = (idx & 31) * 4;
  }

  auto issue = [&](int s, int st) {
    int32_t* rh = raw + st * RAW_WORDS;
    int32_t* rl = rh + TM * TK;
    int32_t* rw = rl + TM * TK;
    const int k0 = s * TK;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + a_c[e];
      const size_t g0 = (size_t)(m0 + a_r[e]) * k + col;
      const int so = a_r[e] * TK + a_c[e];
      if (vec_a) {
        const bool v = a_ok[e] && col < k, vl = v && l_ok[e];
        cp16(rh + so, v ? hi + g0 : hi, v);
        cp16(rl + so, vl ? lo + g0 : lo, vl);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool v = a_ok[e] && col + q < k, vl = v && l_ok[e];
          cp4(rh + so + q, v ? hi + g0 + q : hi, v);
          cp4(rl + so + q, vl ? lo + g0 + q : lo, vl);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int krow = k0 + w_r[e], col = n0 + w_c[e];
      const size_t g0 = (size_t)krow * n + col;
      const int so = w_r[e] * TN + w_c[e];
      if (vec_w) {
        const bool v = krow < k && col < n;
        cp16(rw + so, v ? w + g0 : w, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool v = krow < k && col + q < n;
          cp4(rw + so + q, v ? w + g0 + q : w, v);
        }
      }
    }
  };

  // narrow map: two int4 of each plane per thread; the weights as one
  // 4 (k) x 2 (n) block per thread, transposed into two words
  const int nb2 = (tid & 15) + 16 * ((tid >> 5) & 3);
  const int kb = ((tid >> 4) & 1) + 2 * (tid >> 7);
  auto narrow = [&](int st) {
    const int32_t* rh = raw + st * RAW_WORDS;
    const int32_t* rl = rh + TM * TK;
    const int32_t* rw = rl + TM * TK;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx >> 3, cw = idx & 7;
      const int4 h = *reinterpret_cast<const int4*>(rh + r * TK + cw * 4);
      const int4 l = *reinterpret_cast<const int4*>(rl + r * TK + cw * 4);
      Ah[r * RW + cw] = pack4(h.x, h.y, h.z, h.w);
      Al[r * RW + cw] = pack4(l.x, l.y, l.z, l.w);
    }
    int2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const int2*>(rw + (kb * 4 + i) * TN + nb2 * 2);
    Bs[(nb2 * 2) * RW + kb] = pack4(v[0].x, v[1].x, v[2].x, v[3].x);
    Bs[(nb2 * 2 + 1) * RW + kb] = pack4(v[0].y, v[1].y, v[2].y, v[3].y);
  };

  // ldmatrix: lane gives row (lane & 7) of 8x16-byte matrix (lane >> 3).
  // A (PTX ISA, mma.m16n8k32 .s8): a0 rows 0-7 bytes 0-15, a1 rows 8-15,
  // a2 rows 0-7 bytes 16-31, a3 rows 8-15 bytes 16-31.  B: b0, b1 are
  // bytes 0-15 and 16-31 of columns 0-7; x4 loads two n8 blocks.
  const int lr = lane & 7, lm = lane >> 3;
  const int a_off = (wm * 32 + lr + 8 * (lm & 1)) * RW + 4 * (lm >> 1);
  const int b_off = (wn * 32 + lr + 8 * (lm >> 1)) * RW + 4 * (lm & 1);

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (s_begin + i < s_end) issue(s_begin + i, i);
    cp_commit();
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int it = s - s_begin;
    cp_wait<STAGES - 2>();     // this thread's copies of slab s landed
    __syncthreads();           // everyone's; the int8 tiles are free
    narrow(it % STAGES);
    __syncthreads();           // int8 tiles ready; the ring slot is free
    if (s + STAGES - 1 < s_end)
      issue(s + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_commit();
    uint32_t bf[2][4];
    ldsm4(bf[0], Bs + b_off);              // n8 blocks 0, 1
    ldsm4(bf[1], Bs + b_off + 16 * RW);    // n8 blocks 2, 3
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t af[4];
      ldsm4(af, Ah + a_off + 16 * i * RW);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_s8(acc_hi[i][j], af, bf[j >> 1][2 * (j & 1)],
               bf[j >> 1][2 * (j & 1) + 1]);
      if (lo_mask & (1u << i)) {
        ldsm4(af, Al + a_off + 16 * i * RW);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc_lo[i][j], af, bf[j >> 1][2 * (j & 1)],
                 bf[j >> 1][2 * (j & 1) + 1]);
      }
    }
  }
  cp_wait<0>();

  // D fragment: rows g (c0, c1) and g + 8 (c2, c3), columns 2 tig, +1
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + j * 8 + 2 * tig;
        if (row >= m) continue;
        const uint32_t v0 = ((uint32_t)acc_hi[i][j][2 * h] << 6) +
                            (uint32_t)acc_lo[i][j][2 * h];
        const uint32_t v1 = ((uint32_t)acc_hi[i][j][2 * h + 1] << 6) +
                            (uint32_t)acc_lo[i][j][2 * h + 1];
        uint32_t* o = reinterpret_cast<uint32_t*>(out) + (size_t)row * n + col;
        if (atomic) {
          if (col < n) atomicAdd(o, v0);
          if (col + 1 < n) atomicAdd(o + 1, v1);
        } else if (col + 1 < n && (n & 1) == 0) {
          *reinterpret_cast<uint2*>(o) = make_uint2(v0, v1);
        } else {
          if (col < n) o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

// Split K over the fewest blocks per tile that fill the card: the cost of
// a choice is its waves of one block per SM times the slabs each block
// walks, plus its epilogue (an atomic epilogue counts double).
int pick_splits(int tiles, int slabs) {
  const int sms = sm_count();
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= MAX_SPLITS && s <= slabs; ++s) {
    const long waves = ((long)tiles * s + sms - 1) / sms;
    const long cost = waves * ((slabs + s - 1) / s + (s > 1 ? 2 : 1));
    if (best_cost < 0 || cost < best_cost) { best_cost = cost; best = s; }
  }
  return best;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  dataflow: 0 =
// weight_stationary, 1 = input_stationary.
extern "C" int launch_bitslice_matmul(const void* hi, const void* lo,
                                      const void* w, const void* prec,
                                      void* out, int m, int k, int n,
                                      int dataflow, void* stream) {
  // above 48 KB of shared memory a kernel must opt in, once per device
  static bool opted_in[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && !opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitslice_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mtiles = (m + TM - 1) / TM, ntiles = (n + TN - 1) / TN;
  const int slabs = (k + TK - 1) / TK;
  int splits = pick_splits(mtiles * ntiles, slabs);
  const int per = slabs > 0 ? (slabs + splits - 1) / splits : 0;
  splits = per > 0 ? (slabs + per - 1) / per : 1;
  if (splits > 1) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, (size_t)m * n * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_a = k % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(hi) |
                     reinterpret_cast<uintptr_t>(lo)) % 16 == 0;
  const int vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid = dataflow == 0 ? dim3(mtiles, ntiles, splits)
                                  : dim3(ntiles, mtiles, splits);
  bitslice_matmul_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(prec),
      static_cast<int32_t*>(out), m, k, n, dataflow, per, vec_a, vec_w,
      splits > 1);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
