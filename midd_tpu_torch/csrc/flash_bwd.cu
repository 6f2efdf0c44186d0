// Flash-attention backward for Hopper (sm_90a): dq on the CUDA cores in
// fp32, dk/dv on the tensor cores.
//
// Replaces the two TPU kernels of midd_tpu/ops/flash_attention.py's
// custom_vjp (_flash_padded_bwd):
//   _flash_bwd_dq_kernel  -> flash_bwd_dq_kernel
//   _flash_bwd_dkv_kernel -> flash_bwd_dkv_kernel
// For q, k, v, dO of shape (BH, N, D), contiguous, bf16 or fp32, the per-row
// logsumexp lse (BH, N) of the forward and delta = rowsum(dO * O) (BH, N),
// both fp32, with s = scale q k^T and p = exp(s - lse):
//   dq = scale * sum_k ds k          ds = p * (dO v^T - delta)
//   dk = scale * sum_q ds^T q        dv = sum_q p^T dO
// Scores and dO v^T in fp32; for bf16 inputs ds and p^T are rounded to bf16
// before their products, as the TPU kernels cast them to the input dtype.
//
// Translation from the TPU form. The TPU kernels walk the other sequence
// along a sequential grid axis and carry the accumulators in VMEM scratch.
// Blocks on this card run in no order, so, as in the forward, one block owns
// a tile and loops over the other sequence itself with its accumulators in
// registers: the dq block owns 64 query rows and streams K/V; the dk/dv
// block owns 64 key rows and streams Q/dO. Every output element is written
// by exactly one block: no atomics. p is recomputed from lse, so no running
// max is needed. D is rounded up to a multiple of 16 in shared memory only
// (template NJ = Dp / 16). Any N >= 1: keys past N get p = 0, query rows
// past N get p = 0 (their lse and delta are never read) and are not stored.
//
// Bound on this card: operations. dq does 3 and dk/dv 4 matrix products of
// 2*BH*N^2*D operations each (dk/dv recomputes s and dO v^T); at the
// training shape (BH=2, N=4096, D=96) that is 19.3 and 25.8 GFLOP against
// ~7.9 and ~9.5 MB of inputs and outputs (~20 and ~26 us at the dense bf16
// tensor-core peak, twice that at the TF32 peak for fp32). The dq kernel
// runs its products on the CUDA cores in fp32: it keeps every operand in
// shared memory or registers (O(N) device-memory traffic per block) and
// gives each thread 4x4 score tiles and 4 x NJ accumulator tiles, so each
// shared-memory load feeds several FMAs. The dk/dv kernel runs all four
// products on the tensor cores (flash_mma.cuh: one bf16 pass, or three TF32
// passes for fp32), with P^T and dS^T kept in registers between products
// (its note is below). Left for later: wgmma fed by a TMA producer warp, a
// split of the queries across blocks (at BH 2, N 4096 the dk/dv grid is 128
// blocks of 4 warps, under one wave on 132 SMs), and dq on the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
using midd_mma::LOG2E;
using midd_mma::from_float;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// A product operand as the TPU kernel sees it: rounded to the input dtype.
template <typename T> __device__ __forceinline__ float round_in(float x);
template <> __device__ __forceinline__ float round_in<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_in<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Shared-memory layouts, in floats. Rows of the (tile, Dp) operands are
// padded by 4 floats, and so are the rows of the transposed p / ds tiles, so
// that 8 consecutive rows read or written with float4 fall in distinct banks.
template <int NJ> struct DqSmem {
  static constexpr int DP = NJ * 16;
  static constexpr int RS = DP + 4;  // Q, dO, K, V row stride
  static constexpr int TS = BQ + 4;  // ds^T row stride (one row per key)
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + BQ * RS;
  static constexpr int K_OFF = DO_OFF + BQ * RS;
  static constexpr int V_OFF = K_OFF + BK * RS;
  static constexpr int DS_OFF = V_OFF + BK * RS;
  static constexpr int FLOATS = DS_OFF + BK * TS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// Copy rows [row0, row0 + rows) x [0, d) of one (N, d) matrix into shared
// memory with row stride `stride`, zero-filling rows >= n and columns >= d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          int row0, int rows, int n, int d) {
  for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
    const int r = e / DP;
    const int c = e - r * DP;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < n && c < d) val = to_f(src[(size_t)gr * d + c]);
    dst[r * stride + c] = val;
  }
}

// out[r][c] = a[ty*4 + r] . b[tx + 16*c] over DP columns (row stride RS).
template <int DP, int RS>
__device__ __forceinline__ void dot_tile(float (&out)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < DP; dd += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (ty * 4 + r) * RS + dd);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * RS + dd);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        out[r][c] = fmaf(av[r].x, bv[c].x, out[r][c]);
        out[r][c] = fmaf(av[r].y, bv[c].y, out[r][c]);
        out[r][c] = fmaf(av[r].z, bv[c].z, out[r][c]);
        out[r][c] = fmaf(av[r].w, bv[c].w, out[r][c]);
      }
  }
}

// dq for BQ query rows of one (b, h); K/V tiles stream.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int n, int d, float scale) {
  using S = DqSmem<NJ>;
  constexpr int DP = S::DP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + S::Q_OFF;
  float* dos = smem + S::DO_OFF;
  float* ks = smem + S::K_OFF;
  float* vs = smem + S::V_OFF;
  float* dst = smem + S::DS_OFF;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys tx + 16*c; dq columns tx + 16*j
  const float scale_log2 = scale * LOG2E;

  const size_t base = (size_t)bh * n * d;
  load_tile<T, DP>(qs, S::RS, q + base, q0, BQ, n, d);
  load_tile<T, DP>(dos, S::RS, dout + base, q0, BQ, n, d);

  // This thread's rows: lse in the log2 domain and delta. Rows past n read
  // nothing; their results are never stored.
  float lse2[4], dl[4], acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    lse2[r] = row < n ? lse[(size_t)bh * n + row] * LOG2E : 0.f;
    dl[r] = row < n ? delta[(size_t)bh * n + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/dst
    load_tile<T, DP>(ks, S::RS, k + base, k0, BK, n, d);
    load_tile<T, DP>(vs, S::RS, v + base, k0, BK, n, d);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<DP, S::RS>(s, qs, ks, ty, tx);
    dot_tile<DP, S::RS>(dp, dos, vs, ty, tx);

    // ds^T into shared memory: key-major, this thread's 4 rows as one float4.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = k0 + tx + 16 * c < n;
      float dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = valid ? exp2f(fmaf(s[r][c], scale_log2, -lse2[r])) : 0.f;
        dsv[r] = round_in<T>(p * (dp[r][c] - dl[r]));
      }
      *reinterpret_cast<float4*>(dst + (tx + 16 * c) * S::TS + ty * 4) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();

    // acc += ds k for this thread's 4 rows x NJ columns.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 dv4 = *reinterpret_cast<const float4*>(dst + kk * S::TS + ty * 4);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[kk * S::RS + tx + 16 * j];
        acc[0][j] = fmaf(dv4.x, kv, acc[0][j]);
        acc[1][j] = fmaf(dv4.y, kv, acc[1][j]);
        acc[2][j] = fmaf(dv4.z, kv, acc[2][j]);
        acc[3][j] = fmaf(dv4.w, kv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dq[base + (size_t)row * d + col] = from_float<T>(scale * acc[r][j]);
    }
  }
}

// dk and dv for DKV_BK = 64 key rows of one (b, h), on the tensor cores
// (flash_mma.cuh); Q, dO, lse and delta tiles stream. Each warp owns 16 key
// rows; of the two groups of four warps, group g takes queries [32g, 32g +
// 32) of every 64-query tile, and per 32 (fp32: 16) queries computes, in
// registers:
//   S^T = K_w Q^T;  P^T = exp2(S^T scale log2e - lse log2e)  (0 past N);
//   dV_w += P^T dO  (P^T rounded to bf16 for bf16);
//   dP^T = V_w dO^T;  dS^T = P^T (dP^T - delta);
//   dK_w += dS^T Q  (dS^T rounded to bf16 for bf16).
// No reduction across warps in the loop: a warp's key rows are its own; at
// the end group 1 hands its sums to group 0 through shared memory. K and V
// arrive once; Q, dO, lse and delta come through a two-stage cp.async ring
// whose barrier is the only block-wide one in the loop. Q and dO are read
// both as B stored [n][k] (ldmatrix) and as B stored [k][n] (bf16:
// ldmatrix.trans; fp32: plain loads, two-way bank conflicts at the padding of
// 4 floats that ldmatrix needs). Budget at D 96 (nvcc -Xptxas -v, sm_90a):
// 256 threads; shared memory bf16 80,896 bytes, fp32 154,624 bytes;
// registers per thread bf16 174, fp32 202, no spills; fp32 spills a few
// words at D 17-32 (4 bytes) and at D > 96 (76-112 bytes, at the
// 255-register cap).
constexpr int DKV_BK = 64;      // key rows per block: 16 per warp of a group
constexpr int DKV_BQ = 64;      // queries per streamed tile
constexpr int DKV_GROUPS = 2;   // warp groups; group g takes queries [32g, 32g + 32) of a tile
constexpr int DKV_THREADS = 128 * DKV_GROUPS;

template <typename T, int NJ> struct DkvLayout {
  static constexpr int DP = NJ * 16;
  static constexpr int S = DP + midd_mma::Mma<T>::PAD;  // row stride of every tile, elements
  static constexpr int TILE = 64 * S * sizeof(T);
  static constexpr int STAGE = 2 * TILE + 2 * DKV_BQ * sizeof(float);  // Q, dO, lse, delta
  static constexpr int BYTES = 2 * TILE + 2 * STAGE;                   // K, V, two stages
  static constexpr int XCHG = DP;  // floats a lane hands over: its dK and dV fragments
  static_assert(128 * XCHG * 4 <= 2 * STAGE, "merge buffer does not fit the ring");
};

template <typename T, int NJ>
__global__ void __launch_bounds__(DKV_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int n, int d,
                     float scale, bool async) {
  namespace mm = midd_mma;
  using Lay = DkvLayout<T, NJ>;
  using M = mm::Mma<T>;
  constexpr int DP = Lay::DP, S = Lay::S;
  constexpr int ND = DP / 8;        // 8-column tiles of dK and dV
  // queries per register pass: fp32 carries hi and lo A fragments, so half
  constexpr int PASS = sizeof(T) == 2 ? 32 : 16;
  constexpr int NT = PASS / 8;  // 8-query tiles of one pass
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + Lay::TILE);
  auto stage = [&](int st) { return smem + 2 * Lay::TILE + st * Lay::STAGE; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int group = warp >> 2, wr = warp & 3;  // query group, 16-key-row group
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * DKV_BK;
  const float scale_log2 = scale * mm::LOG2E;
  const size_t base = (size_t)bh * n * d;
  const float* lse_bh = lse + (size_t)bh * n;
  const float* delta_bh = delta + (size_t)bh * n;
  const int tiles = (n + DKV_BQ - 1) / DKV_BQ;

  auto load_stage = [&](int st, int q0) {
    unsigned char* p = stage(st);
    mm::load_rows<T, DKV_BQ, DP, DKV_THREADS>(reinterpret_cast<T*>(p), S, q + base, q0, n, d, async);
    mm::load_rows<T, DKV_BQ, DP, DKV_THREADS>(reinterpret_cast<T*>(p + Lay::TILE), S, dout + base,
                                              q0, n, d, async);
    float* vec = reinterpret_cast<float*>(p + 2 * Lay::TILE);
    mm::load_vec<DKV_BQ>(vec, lse_bh, q0, n, (int)threadIdx.x);
    mm::load_vec<DKV_BQ>(vec + DKV_BQ, delta_bh, q0, n, (int)threadIdx.x - DKV_BQ);
  };
  mm::load_rows<T, DKV_BK, DP, DKV_THREADS>(ks, S, k + base, k0, n, d, async);
  mm::load_rows<T, DKV_BK, DP, DKV_THREADS>(vs, S, v + base, k0, n, d, async);
  load_stage(0, 0);
  mm::cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const T* kw = ks + wr * 16 * S;
  const T* vw = vs + wr * 16 * S;

  for (int j = 0; j < tiles; ++j) {
    mm::cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with stage (j + 1) & 1
    if (j + 1 < tiles) {
      load_stage((j + 1) & 1, (j + 1) * DKV_BQ);
      mm::cp_async_commit();
    }
    const unsigned char* p = stage(j & 1);
    const T* qt = reinterpret_cast<const T*>(p);
    const T* dot = reinterpret_cast<const T*>(p + Lay::TILE);
    const float* lt = reinterpret_cast<const float*>(p + 2 * Lay::TILE);
    const float* dlt = lt + DKV_BQ;
    const int q0 = j * DKV_BQ;

#pragma unroll 1
    for (int h = group * (DKV_BQ / DKV_GROUPS); h < (group + 1) * (DKV_BQ / DKV_GROUPS); h += PASS) {
      const T* qh = qt + h * S;
      const T* doh = dot + h * S;
      float pt[NT][4], dst[NT][4];
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[c][e] = dst[c][e] = 0.f;

      mm::warp_gemm_nt<T, NT, DP>(pt, kw, S, qh, S, lane);
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = h + c * 8 + M::col(t, e & 1);
          pt[c][e] = q0 + qi < n ? exp2f(fmaf(pt[c][e], scale_log2, -lt[qi] * mm::LOG2E)) : 0.f;
        }
      mm::warp_gemm_pv<T, NT, ND>(dva, pt, doh, S, lane);

      mm::warp_gemm_nt<T, NT, DP>(dst, vw, S, doh, S, lane);
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = h + c * 8 + M::col(t, e & 1);
          dst[c][e] = pt[c][e] * (dst[c][e] - dlt[qi]);
        }
      mm::warp_gemm_pv<T, NT, ND>(dka, dst, qh, S, lane);
    }
  }

  // Group 1 hands its dK and dV sums to the warp of group 0 with the same
  // key rows through the idle ring (same lane, same fragment layout); group
  // 0 adds them and stores.
  static_assert(DKV_GROUPS == 2, "the merge below takes one other group's sums");
  __syncthreads();  // the ring is idle: no copy is in flight after the last tile
  float* x = reinterpret_cast<float*>(stage(0)) + (wr * 32 + lane) * Lay::XCHG;
  if (group == 1) {
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[c * 4 + e] = dka[c][e];
        x[(ND + c) * 4 + e] = dva[c][e];
      }
  }
  __syncthreads();
  if (group != 0) return;
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[c][e] += x[c * 4 + e];
      dva[c][e] += x[(ND + c) * 4 + e];
    }
  const int row0 = k0 + wr * 16;
  const float mul_k[2] = {scale, scale}, one[2] = {1.f, 1.f};
  mm::store_rows<T, ND>(dk + base, dka, mul_k, row0, n, d, lane);
  mm::store_rows<T, ND>(dv + base, dva, one, row0, n, d, lane);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;  // dq, or dk
  void* out1;  // dv (dk/dv kernel only)
  int bh, n, d;
  cudaStream_t stream;
};

template <typename T, int NJ>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t bytes = DqSmem<NJ>::BYTES;
  auto kern = flash_bwd_dq_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + BQ - 1) / BQ, a.bh);
  kern<<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.out0), a.n, a.d, 1.0f / sqrtf((float)a.d));
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dkv(const Args& a) {
  constexpr int bytes = DkvLayout<T, NJ>::BYTES;
  auto kern = flash_bwd_dkv_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  using midd_mma::aligned16;
  const bool async = (a.d * sizeof(T)) % 16 == 0 && aligned16(a.q) && aligned16(a.k) &&
                     aligned16(a.v) && aligned16(a.dout);
  const dim3 grid((a.n + DKV_BK - 1) / DKV_BK, a.bh);
  kern<<<grid, DKV_THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.n, a.d,
      1.0f / sqrtf((float)a.d), async);
  return cudaGetLastError();
}

template <typename T, bool DQ>
cudaError_t dispatch(const Args& a) {
  switch ((a.d + 15) / 16) {
#define MIDD_CASE(NJ) \
    case NJ: return DQ ? launch_dq<T, NJ>(a) : launch_dkv<T, NJ>(a);
    MIDD_CASE(1) MIDD_CASE(2) MIDD_CASE(3) MIDD_CASE(4)
    MIDD_CASE(5) MIDD_CASE(6) MIDD_CASE(7) MIDD_CASE(8)
#undef MIDD_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(const Args& a, int is_bf16) {
  if (a.bh < 1 || a.bh > 65535 || a.n < 1 || a.d < 1 || a.d > 128)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16, DQ>(a) : dispatch<float, DQ>(a));
}

}  // namespace

// Plain C entry points for ctypes. q, k, v, dout and the outputs: (bh, n, d)
// contiguous, all of one dtype (is_bf16 ? bf16 : fp32); lse, delta: (bh, n)
// fp32. Each launches one kernel on `stream` without synchronising and
// returns the launch's cudaError_t (0 = success).
extern "C" int midd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int n,
                                 int d, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, bh, n, d,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, is_bf16);
}

extern "C" int midd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int bh,
                                  int n, int d, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, bh, n, d,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, is_bf16);
}

extern "C" const char* midd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
