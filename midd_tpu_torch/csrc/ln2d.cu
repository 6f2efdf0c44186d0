// LayerNorm2d over the channels of an NCHW tensor, for Hopper (sm_90a).
//
// Replaces both TPU kernels of midd_tpu/ops/ln2d.py: _kernel_native (C < 128,
// in-lane reductions) and _kernel (C % 128 == 0, segment sums as indicator
// matmuls). That split was an artifact of the TPU's 128 lanes; this one
// kernel takes any C >= 1. For x of shape (B, C, H, W), contiguous, fp32 or
// bf16, and scale, bias of shape (C,) fp32, per pixel:
//     u   = mean_c x
//     var = max(mean_c x^2 - u^2, 0)          (one pass, clamped, as JAX)
//     y   = (x - u) / sqrt(var + eps) * scale + bias
// statistics and affine in fp32, y in x's dtype. The sums of x and x^2 are
// taken in one pass on purpose: it is the JAX package's formula (its
// LayerNorm2d module and both TPU kernels), and a centred or Welford
// variance, though more accurate, differs from it where the mean is large
// against the spread, because this formula then cancels most of its bits
// and its result depends on the order of the sums. So the order is fixed:
// channel by channel within chunks of 32 (x^2 fused into the accumulation),
// then the chunks' sums in order, every step rounded as written (no
// contraction into FMAs). That is XLA's CPU order at C <= 32 and the order
// of the plain version (ops/ln2d.py::ln2d_plain).
//
// Layout. The TPU kernels read channel-minor rows; the port's tensors are
// NCHW, so one pixel's C values lie H*W elements apart. A block owns 32
// neighbouring pixels, one per lane, and up to 8 warps share out the chunks
// (warp w takes chunks w, w+W, ...): each warp load reads 32 neighbouring
// pixels of one channel, coalesced. The chunks' partial sums meet in shared
// memory; then each warp normalises the channels of its chunks. No permute:
// that would add two full passes over device memory. The same code takes a
// channels-last tensor (the layout cuDNN keeps when a network's input is a
// permuted NHWC image, as the engine's and the trainer's are), through the
// strides: a lane then reads its own pixel's channels, one 4-byte word of
// another line per lane, and the lines' other words come from L1 on the
// lane's next channels. y has x's strides.
//
// Bound on this card. The kernel reads x once and writes y once (the second
// read of x for the normalise pass is served from L1/L2: a block's slice is
// at most 32 * C * 4 bytes), 2 * P * C * bytes per call with P = B*H*W, and
// does ~8 operations per element: bound by bytes. At C 32, 512^2, fp32 that
// is 67.1 MB, 20 us at 3.35 TB/s. The design moves each byte once from
// device memory, coalesced, and splits a pixel's channels over warps so that
// the narrowest-P stage (C 512 at 32^2, 1024 pixels) still has 32 blocks of
// 8 warps in flight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int PIX = 32;     // pixels per block, one per lane
constexpr int CHUNK = 32;   // channels summed in sequence
constexpr int MAX_WARPS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// blockDim = (32, W); dynamic shared memory: 2 * ceil(C / 32) * 32 floats.
template <typename T>
__global__ void __launch_bounds__(PIX * MAX_WARPS)
ln2d_kernel(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ y, long long n_pix,
            int c_dim, long long hw, long long sb, long long sc, long long sp,
            float eps) {
  extern __shared__ float part[];  // [2][chunks][PIX]: sums of x, then of x^2
  const int chunks = (c_dim + CHUNK - 1) / CHUNK;
  float* s_part = part;
  float* q_part = part + chunks * PIX;
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int warps = blockDim.y;
  const long long p = (long long)blockIdx.x * PIX + lane;
  const bool valid = p < n_pix;
  long long base = 0;  // offset of (b, channel 0, pixel)
  if (valid) {
    const long long b = p / hw;
    base = b * sb + (p - b * hw) * sp;
  }

  for (int k = w; k < chunks; k += warps) {
    float s = 0.f, q = 0.f;
    if (valid) {
      const int end = min(c_dim, (k + 1) * CHUNK);
      for (int c = k * CHUNK; c < end; ++c) {
        const float v = to_f(x[base + c * sc]);
        s = __fadd_rn(s, v);
        q = __fmaf_rn(v, v, q);
      }
    }
    s_part[k * PIX + lane] = s;
    q_part[k * PIX + lane] = q;
  }
  __syncthreads();
  if (!valid) return;

  float ts = s_part[lane], tq = q_part[lane];
  for (int k = 1; k < chunks; ++k) {
    ts = __fadd_rn(ts, s_part[k * PIX + lane]);
    tq = __fadd_rn(tq, q_part[k * PIX + lane]);
  }
  const float n = (float)c_dim;
  const float u = __fdiv_rn(ts, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(tq, n), __fmul_rn(u, u)), 0.f);
  const float sd = __fsqrt_rn(__fadd_rn(var, eps));
  for (int k = w; k < chunks; k += warps) {
    const int end = min(c_dim, (k + 1) * CHUNK);
    for (int c = k * CHUNK; c < end; ++c) {
      const long long i = base + c * sc;
      const float xn = __fdiv_rn(__fsub_rn(to_f(x[i]), u), sd);
      y[i] = from_f<T>(__fadd_rn(__fmul_rn(xn, scale[c]), bias[c]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   int b, int c, int hw, long long sb, long long sc, long long sp,
                   float eps, cudaStream_t stream) {
  const long long n_pix = (long long)b * hw;
  const long long blocks = (n_pix + PIX - 1) / PIX;
  const int chunks = (c + CHUNK - 1) / CHUNK;
  const size_t bytes = (size_t)2 * chunks * PIX * sizeof(float);
  if (blocks > 0x7fffffffLL || bytes > 48 * 1024) return cudaErrorInvalidValue;
  const int warps = chunks < MAX_WARPS ? chunks : MAX_WARPS;
  ln2d_kernel<T><<<dim3((unsigned)blocks), dim3(PIX, warps), bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), n_pix, c,
      (long long)hw, sb, sc, sp, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x, y: (b, c, hw) dense, one dtype
// (is_bf16 ? bf16 : fp32), element (b, c, p) at b * sb + c * sc + p * sp
// in both (NCHW: sc = hw, sp = 1; channels-last: sc = 1, sp = c); scale,
// bias: (c,) fp32; c <= 6144 (the chunks' partial sums fill at most 48 KB
// of shared memory). Launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 = success).
extern "C" int midd_ln2d(const void* x, const void* scale, const void* bias,
                         void* y, int b, int c, int hw, long long sb, long long sc,
                         long long sp, float eps, int is_bf16, void* stream) {
  if (b < 1 || c < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, scale, bias, y, b, c, hw, sb, sc, sp, eps, s)
              : launch<float>(x, scale, bias, y, b, c, hw, sb, sc, sp, eps, s);
  return (int)err;
}

extern "C" const char* midd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
