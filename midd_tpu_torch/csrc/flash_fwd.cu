// Flash-attention forward for Hopper (sm_90a) on the tensor cores.
//
// Replaces the TPU kernel midd_tpu/ops/flash_attention.py::_flash_fwd_kernel
// (pallas_call in _fwd_call). It computes the same function: for q, k, v of
// shape (BH, N, D), contiguous, bf16 or fp32,
//     O   = softmax(q k^T / sqrt(D)) v          (BH, N, D), input dtype
//     lse = logsumexp(q k^T / sqrt(D), axis=-1) (BH, N), fp32
// with the online-softmax state (running max, running sum, accumulator) in
// fp32 and, for bf16 inputs, p rounded to bf16 before the p.v product as the
// TPU kernel does.
//
// Translation from the TPU form. The TPU kernel walks K/V along a sequential
// grid axis and carries m/l/acc in VMEM scratch between grid steps. Blocks on
// this card run in no order, so one block owns BQ = 64 query rows of one
// (b, h) and loops over the K/V tiles itself, the state in registers. Its
// warps form groups of four (16 rows a warp); group g takes K/V tiles g,
// g + G, g + 2G, ..., and at the end groups 1.. hand their softmax state to
// group 0, which merges and stores. D is not padded to 128 lanes: it is
// rounded up to a multiple of 16 (template NJ = Dp / 16) with zeros in
// shared memory only. Any N >= 1: the ragged last K/V tile is masked to -inf
// and ragged query rows are not stored.
//
// Bound on this card: operations. Per call 4*BH*N^2*D operations against
// 2*BH*N*D*(3 + 1) bytes (bf16); at the served shape (BH=2, N=4096, D=96)
// that is ~12.9 GFLOP against ~6.3 MB, about 2000 operations per byte, far
// above the H100's ~295 ops/byte ridge (~13 us at the dense bf16 peak, ~26
// us at the TF32 peak for fp32). What the design does about it
// (FlashAttention-2's, on mma.sync; flash_mma.cuh has the pieces):
// - both products on the tensor cores: bf16 in one m16n8k16 pass, fp32 in
//   three m16n8k8 TF32 passes (hi.hi + hi.lo + lo.hi), fp32 accumulation;
// - operands stay in the input dtype in shared memory (rows padded to an odd
//   number of 16-byte units, so ldmatrix reads 8 rows on distinct banks);
// - S = Q K^T stays in registers: the online softmax works on its C
//   fragments (row max and sum over the 4 lanes of a quad), and P, rounded
//   to bf16 (bf16) or split to TF32 (fp32), is the A fragment of P V;
// - Q arrives once; K and V stream through a two-stage ring of 16-byte
//   cp.async copies, the next tiles' copies in flight during this tile's
//   products; the ring's barrier is the only block-wide one in the loop. D
//   with D * sizeof(T) not a multiple of 16 (or unaligned operands) load the
//   same tiles with plain loads;
// - the grid at the served shape is 128 blocks, under one wave on 132 SMs,
//   so a block splits the keys over G = 3 warp groups (2 where three rings
//   do not fit: fp32 at D > 112): 12 warps an SM, 3 a scheduler, to hide
//   the latency of mma.sync, ldmatrix and the softmax.
// Budget at D 96 (nvcc -Xptxas -v, sm_90a): 384 threads; shared memory bf16
// 173,056 bytes (64-key tiles), fp32 182,272 bytes (32-key tiles); registers
// per thread bf16 134, fp32 145; no spills at any D.
// Left for later: wgmma fed by a TMA producer warp; 32 rows a warp (two
// m16 tiles share each B fragment, as FlashAttention-2 does); and a split of
// the keys across blocks, which would fill the card at N 1024 (32 blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace midd_mma;

constexpr int BQ = 64;  // query rows per block: 16 per warp of a group

// Warp groups and shared memory, in bytes. Each group of four warps takes
// every GROUPS-th K/V tile: three groups where their ring fits, else two.
// Q, then two stages of one (K, V) tile per group. Q and K rows are read by
// ldmatrix (stride: Mma<T>::PAD); V rows by ldmatrix.trans (bf16) or by
// plain loads of rows t, t+4 x 8 columns (fp32), both conflict-free at a
// padding of 8 elements. fp32 tiles hold 32 keys, so that the ring fits.
// After the loop the stages hold groups 1.. 's state for group 0 to merge.
template <typename T, int NJ> struct Layout {
  static constexpr int DP = NJ * 16;
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;  // keys per tile
  static constexpr int QS = DP + Mma<T>::PAD;  // Q and K row stride, elements
  static constexpr int VS = DP + 8;            // V row stride, elements
  static constexpr int Q_BYTES = BQ * QS * sizeof(T);
  static constexpr int K_BYTES = BK * QS * sizeof(T);
  static constexpr int TILE = K_BYTES + BK * VS * sizeof(T);
  static constexpr int GROUPS = Q_BYTES + 6 * TILE <= SMEM_MAX ? 3 : 2;
  static constexpr int THREADS = 128 * GROUPS;
  static constexpr int STAGE = GROUPS * TILE;
  static constexpr int BYTES = Q_BYTES + 2 * STAGE;
  static constexpr int XCHG = (DP / 2 + 4);  // floats a lane hands over: acc, m, l
  static_assert(BYTES <= SMEM_MAX, "ring does not fit shared memory");
  static_assert((GROUPS - 1) * 128 * XCHG * 4 <= 2 * STAGE, "merge buffer does not fit the ring");
};

template <typename T, int NJ>
__global__ void __launch_bounds__((Layout<T, NJ>::THREADS))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n, int d, float scale_log2, bool async) {
  using Lay = Layout<T, NJ>;
  using M = Mma<T>;
  constexpr int DP = Lay::DP, BK = Lay::BK, GROUPS = Lay::GROUPS, THREADS = Lay::THREADS;
  constexpr int ND = DP / 8;  // 8-column tiles of the output
  constexpr int NT = BK / 8;  // 8-column tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  auto k_tile = [&](int st, int g) {
    return reinterpret_cast<T*>(smem + Lay::Q_BYTES + st * Lay::STAGE + g * Lay::TILE);
  };
  auto v_tile = [&](int st, int g) {
    return reinterpret_cast<T*>(smem + Lay::Q_BYTES + st * Lay::STAGE + g * Lay::TILE + Lay::K_BYTES);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int group = warp >> 2, wr = warp & 3;  // K/V group, 16-row group
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * n * d;
  const int steps = ((n + BK - 1) / BK + GROUPS - 1) / GROUPS;
  auto load_stage = [&](int st, int step) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int k0 = (step * GROUPS + g) * BK;
      load_rows<T, BK, DP, THREADS>(k_tile(st, g), Lay::QS, k + base, k0, n, d, async);
      load_rows<T, BK, DP, THREADS>(v_tile(st, g), Lay::VS, v + base, k0, n, d, async);
    }
  };

  load_rows<T, BQ, DP, THREADS>(qs, Lay::QS, q + base, q0, n, d, async);
  load_stage(0, 0);
  cp_async_commit();

  // rows g and g + 8 of this warp's 16: running max (log2 domain), this
  // lane's part of the running sum, and the output accumulator
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const T* qw = qs + wr * 16 * Lay::QS;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // stage `step` is in; every warp is done with the other stage
    if (step + 1 < steps) {
      load_stage((step + 1) & 1, step + 1);
      cp_async_commit();
    }
    const int k0 = (step * GROUPS + group) * BK;
    if (k0 >= n) continue;  // this group's tile lies past the keys

    float s[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
    warp_gemm_nt<T, NT, DP>(s, qw, Lay::QS, k_tile(step & 1, group), Lay::QS, lane);

    // Online softmax in the log2 domain on the C fragments: a lane holds two
    // keys of each 8-key tile for rows g (e = 0, 1) and g + 8 (e = 2, 3).
    const bool ragged = k0 + BK > n;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[c][e] * scale_log2;
        if (ragged && k0 + c * 8 + M::col(t, e & 1) >= n) x = -INFINITY;
        s[c][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));  // finite: key k0 is valid
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][e] = exp2f(s[c][e] - m[e >> 1]);
        rs[e >> 1] += s[c][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e >> 1];

    warp_gemm_pv<T, NT, ND>(acc, s, v_tile(step & 1, group), Lay::VS, lane);
  }

  // Groups 1.. hand their (m, l, acc) to the warp of group 0 with the same
  // rows through the idle ring (same lane, same fragment layout); group 0
  // merges the softmax states and stores. A group that saw no key has
  // m = -inf and weight 0.
  __syncthreads();  // the ring is idle: no copy is in flight after the last step
  float* xchg = reinterpret_cast<float*>(smem + Lay::Q_BYTES) + (wr * 32 + lane) * Lay::XCHG;
  if (group > 0) {
    float* x = xchg + (group - 1) * 128 * Lay::XCHG;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[c * 4 + e] = acc[c][e];
    x[4 * ND] = m[0], x[4 * ND + 1] = m[1], x[4 * ND + 2] = l[0], x[4 * ND + 3] = l[1];
  }
  __syncthreads();
  if (group != 0) return;
#pragma unroll
  for (int g = 1; g < GROUPS; ++g) {
    const float* x = xchg + (g - 1) * 128 * Lay::XCHG;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mg = x[4 * ND + r];
      const float mm = fmaxf(m[r], mg);
      a0[r] = exp2f(m[r] - mm);
      a1[r] = exp2f(mg - mm);
      m[r] = mm;
      l[r] = l[r] * a0[r] + x[4 * ND + 2 + r] * a1[r];
    }
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * a0[e >> 1] + x[c * 4 + e] * a1[e >> 1];
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }

  const int row0 = q0 + wr * 16;
  store_rows<T, ND>(o + base, acc, inv, row0, n, d, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < n) lse[(size_t)bh * n + row] = m[r] * LN2 + logf(l[r]);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int n, int d, cudaStream_t stream) {
  using Lay = Layout<T, NJ>;
  constexpr int bytes = Lay::BYTES;
  auto kern = flash_fwd_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool async = (d * sizeof(T)) % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid((n + BQ - 1) / BQ, bh);
  const float scale_log2 = LOG2E / sqrtf((float)d);
  kern<<<grid, Lay::THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n, d, scale_log2, async);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int n, int d, cudaStream_t stream) {
  switch ((d + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, o, lse, bh, n, d, stream);
    case 2: return launch<T, 2>(q, k, v, o, lse, bh, n, d, stream);
    case 3: return launch<T, 3>(q, k, v, o, lse, bh, n, d, stream);
    case 4: return launch<T, 4>(q, k, v, o, lse, bh, n, d, stream);
    case 5: return launch<T, 5>(q, k, v, o, lse, bh, n, d, stream);
    case 6: return launch<T, 6>(q, k, v, o, lse, bh, n, d, stream);
    case 7: return launch<T, 7>(q, k, v, o, lse, bh, n, d, stream);
    case 8: return launch<T, 8>(q, k, v, o, lse, bh, n, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. q, k, v, o: (bh, n, d) contiguous, all of
// one dtype (is_bf16 ? bf16 : fp32); lse: (bh, n) fp32. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 = success).
extern "C" int midd_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int n, int d,
                              int is_bf16, void* stream) {
  if (bh < 1 || bh > 65535 || n < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, n, d, s)
              : dispatch<float>(q, k, v, o, lse, bh, n, d, s);
  return (int)err;
}

extern "C" const char* midd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
