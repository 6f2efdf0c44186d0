// Flash-attention backward for Hopper (sm_90a), CUDA-core fp32 math.
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
// Bound on this card. dq does 3 and dk/dv 4 matrix products of 2*BH*N^2*D
// operations each (dk/dv recomputes s and dO v^T); at the training shape
// (BH=2, N=4096, D=96) that is 19.3 and 25.8 GFLOP against ~7.9 and ~9.5 MB
// of inputs and outputs: bound by operations (~20 and ~26 us at the dense
// bf16 tensor-core peak). Like the forward, this first version runs its
// products on the CUDA cores in fp32, so it cannot come near that bound;
// what the design does about the operation bound is keep every operand in
// shared memory or registers (O(N) device-memory traffic per block) and give
// each thread 4x4 score tiles and 4 x NJ accumulator tiles, so each
// shared-memory load feeds several FMAs. Tensor cores come next.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <int NJ> struct DkvSmem {
  static constexpr int DP = NJ * 16;
  static constexpr int RS = DP + 4;  // K, V, Q, dO row stride
  static constexpr int TS = BK + 4;  // p and ds row stride (one row per query)
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + BK * RS;
  static constexpr int Q_OFF = V_OFF + BK * RS;
  static constexpr int DO_OFF = Q_OFF + BQ * RS;
  static constexpr int P_OFF = DO_OFF + BQ * RS;
  static constexpr int DS_OFF = P_OFF + BQ * TS;
  static constexpr int L_OFF = DS_OFF + BQ * TS;  // lse * log2(e) per query
  static constexpr int D_OFF = L_OFF + BQ;        // delta per query
  static constexpr int FLOATS = D_OFF + BQ;
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
      if (col < d) dq[base + (size_t)row * d + col] = from_f<T>(scale * acc[r][j]);
    }
  }
}

// dk and dv for BK key rows of one (b, h); Q/dO tiles stream.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int n, int d,
                     float scale) {
  using S = DkvSmem<NJ>;
  constexpr int DP = S::DP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem + S::K_OFF;
  float* vs = smem + S::V_OFF;
  float* qs = smem + S::Q_OFF;
  float* dos = smem + S::DO_OFF;
  float* ps = smem + S::P_OFF;
  float* dss = smem + S::DS_OFF;
  float* ls = smem + S::L_OFF;
  float* dls = smem + S::D_OFF;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // key rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // queries tx + 16*c; dk/dv columns tx + 16*j
  const float scale_log2 = scale * LOG2E;

  const size_t base = (size_t)bh * n * d;
  load_tile<T, DP>(ks, S::RS, k + base, k0, BK, n, d);
  load_tile<T, DP>(vs, S::RS, v + base, k0, BK, n, d);

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[r][j] = acc_v[r][j] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done with qs/dos/ps/dss
    load_tile<T, DP>(qs, S::RS, q + base, q0, BQ, n, d);
    load_tile<T, DP>(dos, S::RS, dout + base, q0, BQ, n, d);
    for (int i = tid; i < BQ; i += THREADS) {
      const int row = q0 + i;
      ls[i] = row < n ? lse[(size_t)bh * n + row] * LOG2E : 0.f;
      dls[i] = row < n ? delta[(size_t)bh * n + row] : 0.f;
    }
    __syncthreads();

    // s^T and (dO v^T)^T for this thread's 4 keys x 4 queries.
    float s[4][4], dp[4][4];
    dot_tile<DP, S::RS>(s, ks, qs, ty, tx);
    dot_tile<DP, S::RS>(dp, vs, dos, ty, tx);

    // p and ds into shared memory, query-major: this thread's 4 keys of one
    // query as one float4. Queries past n contribute nothing.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = tx + 16 * c;
      const bool valid = q0 + qi < n;
      const float l2 = ls[qi];
      const float dl = dls[qi];
      float pv[4], dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = valid ? exp2f(fmaf(s[r][c], scale_log2, -l2)) : 0.f;
        pv[r] = round_in<T>(p);
        dsv[r] = round_in<T>(p * (dp[r][c] - dl));
      }
      *reinterpret_cast<float4*>(ps + qi * S::TS + ty * 4) =
          make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(dss + qi * S::TS + ty * 4) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T q for this thread's 4 keys x NJ columns.
#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + qq * S::TS + ty * 4);
      const float4 d4 = *reinterpret_cast<const float4*>(dss + qq * S::TS + ty * 4);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float ov = dos[qq * S::RS + tx + 16 * j];
        const float qv = qs[qq * S::RS + tx + 16 * j];
        acc_v[0][j] = fmaf(p4.x, ov, acc_v[0][j]);
        acc_v[1][j] = fmaf(p4.y, ov, acc_v[1][j]);
        acc_v[2][j] = fmaf(p4.z, ov, acc_v[2][j]);
        acc_v[3][j] = fmaf(p4.w, ov, acc_v[3][j]);
        acc_k[0][j] = fmaf(d4.x, qv, acc_k[0][j]);
        acc_k[1][j] = fmaf(d4.y, qv, acc_k[1][j]);
        acc_k[2][j] = fmaf(d4.z, qv, acc_k[2][j]);
        acc_k[3][j] = fmaf(d4.w, qv, acc_k[3][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty * 4 + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        dk[base + (size_t)row * d + col] = from_f<T>(scale * acc_k[r][j]);
        dv[base + (size_t)row * d + col] = from_f<T>(acc_v[r][j]);
      }
    }
  }
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
  constexpr size_t bytes = DkvSmem<NJ>::BYTES;
  auto kern = flash_bwd_dkv_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + BK - 1) / BK, a.bh);
  kern<<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.n, a.d,
      1.0f / sqrtf((float)a.d));
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
