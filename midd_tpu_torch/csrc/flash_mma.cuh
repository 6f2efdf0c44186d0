// Warp-level tensor-core pieces shared by the flash-attention forward
// (flash_fwd.cu), the flash backward's dq and dk/dv kernels (flash_bwd.cu)
// and the fused NAFBlock FFN (naf_ffn.cu): asynchronous copies, ldmatrix,
// mma.sync, the TF32 split and the warp products that the kernels are made of
// (warp_gemm_nt_tf32x3 and split_tf32_fast serve naf_ffn.cu alone).
//
// One loop serves both element types:
//   bf16: mma.sync.m16n8k16 bf16 x bf16 -> fp32, one pass per product;
//   fp32: mma.sync.m16n8k8 tf32 x tf32 -> fp32, three passes per product,
//         a.b = hi(a).hi(b) + hi(a).lo(b) + lo(a).hi(b) with hi = tf32(x)
//         (cvt.rna) and lo = tf32(x - hi): 22 of fp32's 24 bits of each
//         operand, the way the TPU runs an fp32 dot (bf16 passes there).
// A k step is 32 bytes of a row in both types (16 bf16, 8 fp32), so the
// ldmatrix addressing of the A operand and of a B operand stored [n][k] is
// the same for both; ldmatrix moves 32-bit fp32 words as pairs of b16.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / k8"):
// g = lane / 4, t = lane % 4. C (16 x 8): c0, c1 at row g, columns 2t, 2t+1;
// c2, c3 at row g+8. bf16 A (16 x 16) is four 8x8 blocks (rows 0-7 / 8-15 x
// columns 0-7 / 8-15), so the C fragments of two 8-column tiles are, packed
// to bf16, the A fragment of the next product: P never leaves registers. The
// tf32 A (16 x 8) holds columns t and t+4; the fp32 path reads the B rows of
// the first product in the order nt_row (column 2t <- row t, column 2t+1 <-
// row t+4), so that its C fragment is the next product's A fragment too.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace midd_mma {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block can have
constexpr int MAX_D = 192;        // largest head dim the flash kernels take (Dp 192)

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy, global -> shared; zero-fills when !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

// 4-byte asynchronous copy; zero-fills when !full.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x (as fp32 bits) = hi + lo + O(2^-22 |x|), hi and lo both tf32, rounded
// to nearest. (Leaving lo = x - hi for the tensor core to truncate saves an
// instruction per operand, but at N = 1, where dk is rounding noise, it
// moved the card's dk off the plain version's.)
__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  const float x = __uint_as_float(bits);
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;       // depth of one mma
  static constexpr int C_PER_A = 2;  // 8-column C tiles that make one A tile
  static constexpr int PAD = 8;      // row padding (elements): rows of 16 B x odd
  struct A { uint32_t r[4]; };
  // the column, within an 8-column C tile, of element e (0 or 1) of quad lane t
  __device__ static int col(int t, int e) { return 2 * t + e; }
  // the row of a B tile stored [n][k] that ldmatrix row i reads
  __device__ static int nt_row(int i) { return i; }
  __device__ static void load_a(A& a, uint32_t addr) { ldsm_x4(a.r, addr); }
  __device__ static void mma(float (&c)[4], const A& a, uint32_t b0, uint32_t b1) {
    mma_bf16_16816(c, a.r, b0, b1);
  }
  // two C tiles -> one A tile, rounded to bf16
  __device__ static void a_from_c(A& a, const float (*c)[4]) {
    a.r[0] = pack_bf16(c[0][0], c[0][1]);
    a.r[1] = pack_bf16(c[0][2], c[0][3]);
    a.r[2] = pack_bf16(c[1][0], c[1][1]);
    a.r[3] = pack_bf16(c[1][2], c[1][3]);
  }
  // B fragments of two 8-column n tiles (n0, n0 + 8) over k rows k0..k0+15
  // of a tile stored [k][n]
  __device__ static void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int stride,
                                   int k0, int n0, int lane) {
    const int m = lane >> 3;
    ldsm_x4_trans(b, smem_addr(tile + (k0 + (m & 1) * 8 + (lane & 7)) * stride + n0 + (m >> 1) * 8));
  }
};

template <> struct Mma<float> {
  static constexpr int K = 8;
  static constexpr int C_PER_A = 1;
  static constexpr int PAD = 4;
  struct A { uint32_t hi[4], lo[4]; };
  __device__ static int col(int t, int e) { return t + 4 * e; }
  __device__ static int nt_row(int i) { return (i >> 1) + (i & 1) * 4; }
  __device__ static void split(A& a, const uint32_t (&raw)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(raw[i], a.hi[i], a.lo[i]);
  }
  __device__ static void load_a(A& a, uint32_t addr) {
    uint32_t raw[4];
    ldsm_x4(raw, addr);
    split(a, raw);
  }
  // Three tf32 passes, the small terms first, into a sum that starts at
  // zero and is then added to c on the CUDA cores. The tensor cores' fp32
  // accumulation rounds toward zero: a chain of thousands of accumulations
  // in one register drifts toward zero (dk at N 4096 was off by 1.1e-5 of
  // its largest entry on the H100), while one rounded to nearest per k step
  // errs in either direction.
  __device__ static void mma(float (&c)[4], const A& a, uint32_t b0, uint32_t b1) {
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32_1688(s, a.lo, h0, h1);
    mma_tf32_1688(s, a.hi, l0, l1);
    mma_tf32_1688(s, a.hi, h0, h1);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += s[i];
  }
  // one C tile (columns in nt_row order) -> one A tile: a0..a3 = (g, t),
  // (g+8, t), (g, t+4), (g+8, t+4) = c0, c2, c1, c3
  __device__ static void a_from_c(A& a, const float (*c)[4]) {
    const uint32_t raw[4] = {__float_as_uint(c[0][0]), __float_as_uint(c[0][2]),
                             __float_as_uint(c[0][1]), __float_as_uint(c[0][3])};
    split(a, raw);
  }
  // b0 = B[k0+t][n0+g], b1 = B[k0+t+4][n0+g]; ldmatrix cannot transpose
  // 32-bit words, so these are plain shared loads
  __device__ static void load_b_kn(uint32_t (&b)[4], const float* tile, int stride, int k0,
                                   int n0, int lane) {
    const float* p = tile + (k0 + (lane & 3)) * stride + n0 + (lane >> 2);
    b[0] = __float_as_uint(p[0]);
    b[1] = __float_as_uint(p[4 * stride]);
    b[2] = __float_as_uint(p[8]);
    b[3] = __float_as_uint(p[4 * stride + 8]);
  }
};

// c[16 x 8*NT] += A B over k in [0, DP): A is the 16 rows of the row-major
// shared tile `a` (row stride in elements), and B[k][n] = b[n][k] for NT*8
// rows of the row-major shared tile `b`.
template <typename T, int NT, int DP>
__device__ __forceinline__ void warp_gemm_nt(float (&c)[NT][4], const T* a, int a_stride,
                                             const T* b, int b_stride, int lane) {
  using M = Mma<T>;
  constexpr int CHUNK = 16 / sizeof(T);  // elements in 16 bytes
  const int m = lane >> 3;
  const uint32_t a_addr =
      smem_addr(a + ((lane & 7) + (m & 1) * 8) * a_stride + (m >> 1) * CHUNK);
  const uint32_t b_addr =
      smem_addr(b + ((m >> 1) * 8 + M::nt_row(lane & 7)) * b_stride + (m & 1) * CHUNK);
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += M::K) {
    typename M::A af;
    M::load_a(af, a_addr + k0 * sizeof(T));
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b_addr + (nt * 8 * b_stride + k0) * sizeof(T));
      M::mma(c[nt], af, bf[0], bf[1]);
      M::mma(c[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// c[16 x 8*ND] += P B: P (16 x 8*NK) in the C fragments warp_gemm_nt left
// (bf16: rounded to bf16 here), B[k][n] = b[k][n] for rows k of the
// row-major shared tile `b`.
template <typename T, int NK, int ND>
__device__ __forceinline__ void warp_gemm_pv(float (&c)[ND][4], const float (&p)[NK][4],
                                             const T* b, int b_stride, int lane) {
  using M = Mma<T>;
#pragma unroll
  for (int kk = 0; kk < NK; kk += M::C_PER_A) {
    typename M::A af;
    M::a_from_c(af, &p[kk]);
#pragma unroll
    for (int nt = 0; nt < ND; nt += 2) {
      uint32_t bf[4];
      M::load_b_kn(bf, b, b_stride, kk * 8, nt * 8, lane);
      M::mma(c[nt], af, bf[0], bf[1]);
      M::mma(c[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// x (as fp32 bits) = hi + lo with hi tf32, rounded to nearest (ties away, as
// cvt.rna) by integer operations, and lo = x - hi exact in fp32, which the
// tensor core truncates to tf32 (an error of at most 2^-21 |x|, against
// split_tf32's 2^-22): three full-rate instructions where split_tf32 takes
// two conversions, which run at a fraction of that rate.
__device__ __forceinline__ void split_tf32_fast(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  hi = (bits + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(bits) - __uint_as_float(hi));
}

// warp_gemm_nt<float>'s product, c[16 x 8*NT] += A B over k in [0, DP) on
// the same operands in three TF32 passes, issued for a warp that has no other
// work to interleave with it: the fragments of k step s + 1 are loaded before
// the products of step s are issued (two register buffers), and the passes
// are issued pass by pass over the NT tiles, so that no mma waits on the
// ldmatrix or the mma just before it (a warp issues in order, and both are
// volatile asm, kept in source order). Operands are split by split_tf32_fast,
// and the passes accumulate in c itself, by the tensor cores' truncating sum
// over DP / 8 steps (Mma<float> sums each step from zero and adds on the CUDA
// cores): callers keep DP short, sum from zero and add.
template <int NT, int DP>
__device__ __forceinline__ void warp_gemm_nt_tf32x3(float (&c)[NT][4], const float* a, int a_stride,
                                                    const float* b, int b_stride, int lane) {
  using M = Mma<float>;
  constexpr int CHUNK = 4, STEPS = DP / M::K;
  const int m = lane >> 3;
  const uint32_t a_addr =
      smem_addr(a + ((lane & 7) + (m & 1) * 8) * a_stride + (m >> 1) * CHUNK);
  const uint32_t b_addr =
      smem_addr(b + ((m >> 1) * 8 + M::nt_row(lane & 7)) * b_stride + (m & 1) * CHUNK);
  uint32_t ar[2][4], br[2][NT][2];  // raw fragments of two k steps
  auto load = [&](int s, int buf) {
    ldsm_x4(ar[buf], a_addr + s * M::K * 4);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t r[4];
      ldsm_x4(r, b_addr + (nt * 8 * b_stride + s * M::K) * 4);
      br[buf][nt][0] = r[0];
      br[buf][nt][1] = r[1];
      br[buf][nt + 1][0] = r[2];
      br[buf][nt + 1][1] = r[3];
    }
  };
  load(0, 0);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int cur = s & 1;
    if (s + 1 < STEPS) load(s + 1, cur ^ 1);
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32_fast(ar[cur][i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split_tf32_fast(br[cur][nt][0], bh[nt][0], bl[nt][0]);
      split_tf32_fast(br[cur][nt][1], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32_1688(c[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32_1688(c[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32_1688(c[nt], ah, bh[nt][0], bh[nt][1]);
  }
}

// Rows [row0, row0 + ROWS) x [0, d) of one (n, d) row-major matrix into a
// shared tile of DP columns and row stride `stride` (elements), zero in rows
// >= n and columns >= d. With `async` (d * sizeof(T) a multiple of 16, `src`
// 16-byte aligned) by 16-byte cp.async, which the caller commits and waits
// for; otherwise by plain loads and stores, visible after the next barrier.
template <typename T, int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int stride, const T* src, int row0, int n,
                                          int d, bool async) {
  if (async) {
    constexpr int CHUNK = 16 / sizeof(T);
    constexpr int PER_ROW = DP / CHUNK;
    for (int e = threadIdx.x; e < ROWS * PER_ROW; e += THREADS) {
      const int r = e / PER_ROW;
      const int c = (e - r * PER_ROW) * CHUNK;
      const int gr = row0 + r;
      const bool full = gr < n && c < d;
      cp_async16(smem_addr(dst + r * stride + c), full ? src + (size_t)gr * d + c : src, full);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
      const int r = e / DP;
      const int c = e - r * DP;
      const int gr = row0 + r;
      dst[r * stride + c] = (gr < n && c < d) ? src[(size_t)gr * d + c] : from_float<T>(0.f);
    }
  }
}

// Entry row0 + i, 0 <= i < ROWS, of an fp32 vector of length n into dst[i],
// by one 4-byte cp.async, zero past n; other i copy nothing.
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int n, int i) {
  if (0 <= i && i < ROWS) {
    const bool full = row0 + i < n;
    cp_async4(smem_addr(dst + i), full ? src + row0 + i : src, full);
  }
}

// A warp's 16 x 8*ND fragment tile, row r times mul[r / 8], into rows
// row0..row0+15 of an (n, d) row-major matrix; rows >= n and columns >= d
// are dropped.
template <typename T, int ND>
__device__ __forceinline__ void store_rows(T* dst, const float (&c)[ND][4], const float (&mul)[2],
                                           int row0, int n, int d, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + (e >> 1) * 8;
      const int col = nt * 8 + 2 * t + (e & 1);
      if (row < n && col < d) dst[(size_t)row * d + col] = from_float<T>(c[nt][e] * mul[e >> 1]);
    }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace midd_mma
