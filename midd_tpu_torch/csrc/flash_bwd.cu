// Flash-attention backward for Hopper (sm_90a): dq and dk/dv, both on the
// tensor cores.
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
// (template NJ = Dp / 16; D 129-192 at Dp 192). Any N >= 1: keys past N get p = 0, query rows
// past N get p = 0 (their lse and delta are never read) and are not stored.
//
// Bound on this card: operations. dq does 3 and dk/dv 4 matrix products of
// 2*BH*N^2*D operations each (dk/dv recomputes s and dO v^T); at the
// training shape (BH=2, N=4096, D=96) that is 19.3 and 25.8 GFLOP against
// ~7.9 and ~9.5 MB of inputs and outputs (~20 and ~26 us at the dense bf16
// tensor-core peak, twice that at the TF32 peak for fp32). Both kernels run
// every product on the tensor cores (flash_mma.cuh: one bf16 pass, or three
// TF32 passes for fp32, each k step's sum added on the CUDA cores), with the
// score-shaped intermediates (P, dS, P^T, dS^T) kept in registers between
// products, the tile they own arriving once, the other sequence streaming
// through a two-stage cp.async ring whose barrier is the only block-wide one
// in the loop, and the other sequence split over warp groups whose sums
// meet in shared memory at the end (each kernel's note is above it). Left
// for later: wgmma fed by a TMA producer warp, and a split of the other
// sequence across blocks (at BH 2, N 4096 each grid is 128 blocks, under one
// wave on 132 SMs; at N 1024, 32 blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace midd_mma;

// dq for DQ_BQ = 64 query rows of one (b, h), on the tensor cores. Each warp
// owns 16 query rows; the block's warps form groups of four, and group g
// takes K/V tiles g, g + G, g + 2G, ... (G = 3 where three rings fit, else
// 2, else 1 (Dp 192), as in the forward). Per K/V tile a warp computes, in registers:
//   S = Q_w K^T;  dP = dO_w V^T;
//   P = exp2(S scale log2e - lse log2e)  (0 past N);  dS = P (dP - delta);
//   dQ_w += dS K  (dS rounded to bf16 for bf16),
// with lse and delta of the fragment's rows g and g + 8 in registers. Q and
// dO arrive once, in the input dtype; K and V stream through the ring. K is
// read both as B stored [n][k] (S, ldmatrix) and as B stored [k][n] (dS K;
// bf16: ldmatrix.trans; fp32: plain loads, two-way bank conflicts at the
// padding of 4 floats that ldmatrix needs), as the dk/dv kernel reads Q.
// In fp32, S's and dP's B rows are read in nt_row order, so dS's C fragment
// is the A fragment of dS K, whose K rows are then in plain key order. At
// the end groups 1.. hand their dQ sums to group 0 through the idle ring (a
// plain add: p comes from lse, so there is no state to rescale); dq is
// scaled by `scale` at the store.
// Budget at D 96 (nvcc -Xptxas -v, sm_90a): 384 threads (3 groups);
// shared memory bf16 186,368 bytes (64-key tiles), fp32 204,800 bytes
// (32-key tiles); registers per thread bf16 168 (the cap at 384 threads),
// fp32 143; no spills. Spills elsewhere: bf16 12 bytes at D 97-112 and 8 at
// D <= 16, fp32 112 bytes at D 17-32. At Dp 192 one group (128 threads):
// bf16 153,600 bytes, 252 registers; fp32 200,704 bytes, 227 registers; no
// spills.
constexpr int DQ_BQ = 64;  // query rows per block: 16 per warp of a group

template <typename T, int NJ> struct DqLayout {
  static constexpr int DP = NJ * 16;
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;  // keys per tile
  static constexpr int S = DP + Mma<T>::PAD;  // row stride of every tile, elements
  static constexpr int Q_BYTES = DQ_BQ * S * sizeof(T);  // Q, and again dO
  static constexpr int K_BYTES = BK * S * sizeof(T);     // K, and again V
  static constexpr int TILE = 2 * K_BYTES;
  static constexpr int GROUPS = 2 * Q_BYTES + 6 * TILE <= SMEM_MAX   ? 3
                                : 2 * Q_BYTES + 4 * TILE <= SMEM_MAX ? 2
                                                                     : 1;
  static constexpr int THREADS = 128 * GROUPS;
  static constexpr int STAGE = GROUPS * TILE;
  static constexpr int BYTES = 2 * Q_BYTES + 2 * STAGE;
  static constexpr int XCHG = DP / 2;  // floats a lane hands over: its dQ fragments
  static_assert(BYTES <= SMEM_MAX, "ring does not fit shared memory");
  static_assert((GROUPS - 1) * 128 * XCHG * 4 <= 2 * STAGE, "merge buffer does not fit the ring");
};

template <typename T, int NJ>
__global__ void __launch_bounds__((DqLayout<T, NJ>::THREADS))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int n, int d, float scale, bool async) {
  using Lay = DqLayout<T, NJ>;
  using M = Mma<T>;
  constexpr int DP = Lay::DP, S = Lay::S, BK = Lay::BK;
  constexpr int GROUPS = Lay::GROUPS, THREADS = Lay::THREADS;
  constexpr int ND = DP / 8;    // 8-column tiles of dQ
  constexpr int NT = BK / 8;    // 8-key tiles of one K/V tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + Lay::Q_BYTES);
  auto k_tile = [&](int st, int g) {
    return reinterpret_cast<T*>(smem + 2 * Lay::Q_BYTES + st * Lay::STAGE + g * Lay::TILE);
  };
  auto v_tile = [&](int st, int g) { return k_tile(st, g) + BK * S; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int group = warp >> 2, wr = warp & 3;  // K/V group, 16-row group
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * DQ_BQ;
  const float scale_log2 = scale * LOG2E;
  const size_t base = (size_t)bh * n * d;
  const int steps = ((n + BK - 1) / BK + GROUPS - 1) / GROUPS;
  auto load_stage = [&](int st, int step) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int k0 = (step * GROUPS + g) * BK;
      load_rows<T, BK, DP, THREADS>(k_tile(st, g), S, k + base, k0, n, d, async);
      load_rows<T, BK, DP, THREADS>(v_tile(st, g), S, v + base, k0, n, d, async);
    }
  };

  load_rows<T, DQ_BQ, DP, THREADS>(qs, S, q + base, q0, n, d, async);
  load_rows<T, DQ_BQ, DP, THREADS>(dos, S, dout + base, q0, n, d, async);
  load_stage(0, 0);
  cp_async_commit();

  // rows g and g + 8 of this warp's 16: lse in the log2 domain and delta.
  // Rows past n read nothing; their results are never stored.
  const int row0 = q0 + wr * 16;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    lse2[r] = row < n ? lse[(size_t)bh * n + row] * LOG2E : 0.f;
    dl[r] = row < n ? delta[(size_t)bh * n + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const T* qw = qs + wr * 16 * S;
  const T* dow = dos + wr * 16 * S;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // stage `step` is in; every warp is done with the other stage
    if (step + 1 < steps) {
      load_stage((step + 1) & 1, step + 1);
      cp_async_commit();
    }
    const int k0 = (step * GROUPS + group) * BK;
    if (k0 >= n) continue;  // this group's tile lies past the keys
    const T* kt = k_tile(step & 1, group);

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
    warp_gemm_nt<T, NT, DP>(s, qw, S, kt, S, lane);
    warp_gemm_nt<T, NT, DP>(dp, dow, S, v_tile(step & 1, group), S, lane);
    // dS on the C fragments: a lane holds keys col(t, 0) and col(t, 1) of
    // each 8-key tile for rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + c * 8 + M::col(t, e & 1) < n;
        const float p = valid ? exp2f(fmaf(s[c][e], scale_log2, -lse2[e >> 1])) : 0.f;
        s[c][e] = p * (dp[c][e] - dl[e >> 1]);
      }
    warp_gemm_pv<T, NT, ND>(acc, s, kt, S, lane);
  }

  // Groups 1.. hand their dQ sums to the warp of group 0 with the same rows
  // through the idle ring (same lane, same fragment layout); group 0 adds
  // them in group order and stores.
  __syncthreads();  // the ring is idle: no copy is in flight after the last step
  float* xchg = reinterpret_cast<float*>(smem + 2 * Lay::Q_BYTES) + (wr * 32 + lane) * Lay::XCHG;
  if (group > 0) {
    float* x = xchg + (group - 1) * 128 * Lay::XCHG;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[c * 4 + e] = acc[c][e];
  }
  __syncthreads();
  if (group != 0) return;
#pragma unroll
  for (int g = 1; g < GROUPS; ++g) {
    const float* x = xchg + (g - 1) * 128 * Lay::XCHG;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += x[c * 4 + e];
  }
  const float mul[2] = {scale, scale};
  store_rows<T, ND>(dq + base, acc, mul, row0, n, d, lane);
}

// dk and dv for DKV_BK = 64 key rows of one (b, h), on the tensor cores
// (flash_mma.cuh); Q, dO, lse and delta tiles stream. Each warp owns 16 key
// rows; of the two groups of four warps, group g takes the g-th half of
// every streamed query tile (64 queries; 32 for fp32 at Dp 192), and per 32
// (fp32: 16) queries computes, in registers:
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
// 255-register cap). At Dp 192 in fp32 two stages of 64 queries do not fit
// beside K and V: the streamed tiles hold 32 queries (16 a group, one pass),
// 201,216 bytes. dK and dV take 192 registers a lane alone there: at the
// 255-register cap fp32 spills 92 bytes and bf16 (154,624 bytes of 64-query
// tiles) 16.
constexpr int DKV_BK = 64;      // key rows per block: 16 per warp of a group
constexpr int DKV_GROUPS = 2;   // warp groups; group g takes the g-th half of each query tile
constexpr int DKV_THREADS = 128 * DKV_GROUPS;

template <typename T, int NJ> struct DkvLayout {
  static constexpr int DP = NJ * 16;
  static constexpr int S = DP + midd_mma::Mma<T>::PAD;  // row stride of every tile, elements
  static constexpr int TILE = DKV_BK * S * sizeof(T);   // K or V
  // queries per streamed tile: 64, or 32 where two stages of 64 do not fit
  static constexpr int BQ = 2 * TILE + 2 * (2 * 64 * S * sizeof(T) + 2 * 64 * 4) <= SMEM_MAX ? 64 : 32;
  static constexpr int QTILE = BQ * S * sizeof(T);                   // Q or dO
  static constexpr int STAGE = 2 * QTILE + 2 * BQ * sizeof(float);   // Q, dO, lse, delta
  static constexpr int BYTES = 2 * TILE + 2 * STAGE;                 // K, V, two stages
  static constexpr int XCHG = DP;  // floats a lane hands over: its dK and dV fragments
  static_assert(BYTES <= SMEM_MAX, "ring does not fit shared memory");
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
  static_assert((Lay::BQ / DKV_GROUPS) % PASS == 0, "a group's queries of a tile are whole passes");
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
  constexpr int BQ = Lay::BQ;
  const int tiles = (n + BQ - 1) / BQ;

  auto load_stage = [&](int st, int q0) {
    unsigned char* p = stage(st);
    mm::load_rows<T, BQ, DP, DKV_THREADS>(reinterpret_cast<T*>(p), S, q + base, q0, n, d, async);
    mm::load_rows<T, BQ, DP, DKV_THREADS>(reinterpret_cast<T*>(p + Lay::QTILE), S, dout + base,
                                          q0, n, d, async);
    float* vec = reinterpret_cast<float*>(p + 2 * Lay::QTILE);
    mm::load_vec<BQ>(vec, lse_bh, q0, n, (int)threadIdx.x);
    mm::load_vec<BQ>(vec + BQ, delta_bh, q0, n, (int)threadIdx.x - BQ);
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
      load_stage((j + 1) & 1, (j + 1) * BQ);
      mm::cp_async_commit();
    }
    const unsigned char* p = stage(j & 1);
    const T* qt = reinterpret_cast<const T*>(p);
    const T* dot = reinterpret_cast<const T*>(p + Lay::QTILE);
    const float* lt = reinterpret_cast<const float*>(p + 2 * Lay::QTILE);
    const float* dlt = lt + BQ;
    const int q0 = j * BQ;

#pragma unroll 1
    for (int h = group * (BQ / DKV_GROUPS); h < (group + 1) * (BQ / DKV_GROUPS); h += PASS) {
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

// Both kernels copy their tiles by 16-byte cp.async where every row is
// 16-byte aligned, else by plain loads.
template <typename T>
bool async_rows(const Args& a) {
  return (a.d * sizeof(T)) % 16 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout);
}

template <typename T, int NJ>
cudaError_t launch_dq(const Args& a) {
  using Lay = DqLayout<T, NJ>;
  constexpr int bytes = Lay::BYTES;
  auto kern = flash_bwd_dq_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + DQ_BQ - 1) / DQ_BQ, a.bh);
  kern<<<grid, Lay::THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.out0), a.n, a.d, 1.0f / sqrtf((float)a.d), async_rows<T>(a));
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dkv(const Args& a) {
  constexpr int bytes = DkvLayout<T, NJ>::BYTES;
  auto kern = flash_bwd_dkv_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + DKV_BK - 1) / DKV_BK, a.bh);
  kern<<<grid, DKV_THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.n, a.d,
      1.0f / sqrtf((float)a.d), async_rows<T>(a));
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
    case 9: case 10: case 11: case 12:  // Dp 192: one instance for D 129-192
      return DQ ? launch_dq<T, 12>(a) : launch_dkv<T, 12>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(const Args& a, int is_bf16) {
  if (a.bh < 1 || a.bh > 65535 || a.n < 1 || a.d < 1 || a.d > MAX_D)
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
