// LayerNorm2d over the channels of a (B, C, H, W) tensor, NCHW or
// channels-last, for Hopper (sm_90a).
//
// Replaces both TPU kernels of midd_tpu/ops/ln2d.py: _kernel_native (C < 128,
// in-lane reductions) and _kernel (C % 128 == 0, segment sums as indicator
// matmuls). That split was an artifact of the TPU's 128 lanes; these two
// kernels, one per layout, take any C >= 1. For x of shape (B, C, H, W),
// contiguous in NCHW or channels-last order, fp32 or bf16, and scale, bias
// of shape (C,) fp32, per pixel:
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
// Layout. The TPU kernels read channel-minor rows; the port's tensors come
// in two layouts, and the kernel takes each in its own way, with no permute
// (that would add two full passes over device memory):
// - NCHW (ln2d_kernel): one pixel's C values lie H*W elements apart. A
//   block owns 32 neighbouring pixels, one per lane, and up to 8 warps share
//   out the chunks (warp w takes chunks w, w+W, ...): each warp load reads
//   32 neighbouring pixels of one channel, coalesced. The chunks' partial
//   sums meet in shared memory; then each warp normalises the channels of
//   its chunks. The same code takes any other (b, c, pixel) strides.
// - Dense channels-last (ln2d_cl_kernel), the layout cuDNN keeps when a
//   network's input is a permuted NHWC image, as the engine's and the
//   trainer's are: PIX pixels' channels are one contiguous run of PIX * C
//   elements. The block reads the run once, with 16-byte loads (8 in
//   flight a thread: the whole tile in one round trip), into an fp32 tile
//   in shared memory, and writes y back as one run with 16-byte
//   stores (4- or 2-byte where the run or C * itemsize is not 16-byte
//   aligned). Thread i sums chunk i / PIX of pixel i % PIX from the tile, in
//   the order above; the chunks' sums meet as in the NCHW kernel. A pixel's
//   row of the tile is C floats with its 16-byte units XOR-swizzled by the
//   pixel's low 3 bits (where C % 32 == 0), so that 8 lanes reading the same
//   16 bytes of 8 pixels, or 8 consecutive units of one pixel, fall on
//   distinct banks. PIX = 4096 / C (a power of 2, 1 to 128): every block
//   stages ~16 KB, and the narrowest stage (C 512 at 32^2, 1024 pixels)
//   still runs 128 blocks.
// y has x's strides.
//
// Bound on this card. The kernel reads x once and writes y once (the NCHW
// kernel's second read of x for the normalise pass is served from L1/L2: a
// block's slice is at most 32 * C * 4 bytes), 2 * P * C * bytes per call
// with P = B*H*W, and does ~8 operations per element: bound by bytes. At C
// 32, 512^2, fp32 that is 67.1 MB, 20 us at 3.35 TB/s. Both kernels move
// each byte once from device memory, coalesced.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

constexpr int CL_THREADS = 128;
constexpr int CL_TILE = 4096;  // elements a channels-last block stages, at most (PIX >= 1)
constexpr int CL_MAX_PIX = 128;
constexpr int CL_UNROLL = 8;  // 16-byte loads a thread has in flight: a 16 KB fp32 tile in one round trip

// Offset in the channels-last tile of channel c of pixel pp: rows of `rs`
// floats (C rounded up to 4), 16-byte units XOR-swizzled by `swz`.
__device__ __forceinline__ int cl_idx(int pp, int c, int rs, int swz) {
  return pp * rs + ((((c >> 2) ^ (pp & swz)) << 2) | (c & 3));
}

__device__ __forceinline__ void unpack(float (&f)[4], uint2 raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

// blockDim = CL_THREADS; pixels [blockIdx.x * pix, + pix) of a dense
// channels-last x (pixel p's channel c at p * C + c over the whole batch).
// Dynamic shared memory: pix * rs + 2 * pix * chunks + 2 * pix floats.
template <typename T>
__global__ void __launch_bounds__(CL_THREADS)
ln2d_cl_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, long long n_pix,
               int c_dim, int pix, bool vec, float eps) {
  extern __shared__ __align__(16) float tile[];
  const int chunks = (c_dim + CHUNK - 1) / CHUNK;
  const int rs = (c_dim + 3) & ~3;
  const int swz = c_dim % 32 == 0 ? 7 : 0;
  float* s_part = tile + pix * rs;       // [chunks][pix]: sums of x
  float* q_part = s_part + pix * chunks;  // and of x^2
  float* mean = q_part + pix * chunks;
  float* sdev = mean + pix;
  const long long p0 = (long long)blockIdx.x * pix;
  const int np = (int)min((long long)pix, n_pix - p0);
  const int count = np * c_dim;
  const T* src = x + p0 * c_dim;
  T* dst = y + p0 * c_dim;
  // 16-byte units: 4 fp32 or 8 bf16 channels of one pixel (C * itemsize % 16 == 0)
  constexpr int V = 16 / sizeof(T);

  if (vec) {
    const int units = count / V;
    for (int u0 = threadIdx.x; u0 < units; u0 += CL_UNROLL * CL_THREADS) {
      uint4 raw[CL_UNROLL];
#pragma unroll
      for (int j = 0; j < CL_UNROLL; ++j) {
        const int u = u0 + j * CL_THREADS;
        if (u < units) raw[j] = reinterpret_cast<const uint4*>(src)[u];
      }
#pragma unroll
      for (int j = 0; j < CL_UNROLL; ++j) {
        const int u = u0 + j * CL_THREADS;
        if (u >= units) break;
        const int e = u * V, pp = e / c_dim, c = e - pp * c_dim;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<uint4*>(tile + cl_idx(pp, c, rs, swz)) = raw[j];
        } else {
          float f[4];
          unpack(f, make_uint2(raw[j].x, raw[j].y));
          *reinterpret_cast<float4*>(tile + cl_idx(pp, c, rs, swz)) = make_float4(f[0], f[1], f[2], f[3]);
          unpack(f, make_uint2(raw[j].z, raw[j].w));
          *reinterpret_cast<float4*>(tile + cl_idx(pp, c + 4, rs, swz)) = make_float4(f[0], f[1], f[2], f[3]);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < count; e += CL_THREADS) {
      const int pp = e / c_dim, c = e - pp * c_dim;
      tile[cl_idx(pp, c, rs, swz)] = to_f(src[e]);
    }
  }
  __syncthreads();

  // chunk k of pixel pp, channel by channel (x^2 fused), as the NCHW kernel
  for (int i = threadIdx.x; i < pix * chunks; i += CL_THREADS) {
    const int k = i / pix, pp = i - k * pix;
    float s = 0.f, q = 0.f;
    if (pp < np) {
      const int end = min(c_dim, (k + 1) * CHUNK);
      if (c_dim % 4 == 0) {
        for (int c = k * CHUNK; c < end; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(tile + cl_idx(pp, c, rs, swz));
          s = __fadd_rn(s, v.x);
          q = __fmaf_rn(v.x, v.x, q);
          s = __fadd_rn(s, v.y);
          q = __fmaf_rn(v.y, v.y, q);
          s = __fadd_rn(s, v.z);
          q = __fmaf_rn(v.z, v.z, q);
          s = __fadd_rn(s, v.w);
          q = __fmaf_rn(v.w, v.w, q);
        }
      } else {
        for (int c = k * CHUNK; c < end; ++c) {
          const float v = tile[cl_idx(pp, c, rs, swz)];
          s = __fadd_rn(s, v);
          q = __fmaf_rn(v, v, q);
        }
      }
    }
    s_part[i] = s;
    q_part[i] = q;
  }
  __syncthreads();
  for (int pp = threadIdx.x; pp < np; pp += CL_THREADS) {
    float ts = s_part[pp], tq = q_part[pp];
    for (int k = 1; k < chunks; ++k) {
      ts = __fadd_rn(ts, s_part[k * pix + pp]);
      tq = __fadd_rn(tq, q_part[k * pix + pp]);
    }
    const float n = (float)c_dim;
    const float u = __fdiv_rn(ts, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(tq, n), __fmul_rn(u, u)), 0.f);
    mean[pp] = u;
    sdev[pp] = __fsqrt_rn(__fadd_rn(var, eps));
  }
  __syncthreads();

  auto norm = [&](float v, int pp, int c) {
    const float xn = __fdiv_rn(__fsub_rn(v, mean[pp]), sdev[pp]);
    return __fadd_rn(__fmul_rn(xn, scale[c]), bias[c]);
  };
  if (vec) {
    for (int u = threadIdx.x; u < count / V; u += CL_THREADS) {
      const int e = u * V, pp = e / c_dim, c = e - pp * c_dim;
      uint4 raw;
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int h = 0; h < V; h += 4) {
        const float4 v = *reinterpret_cast<const float4*>(tile + cl_idx(pp, c + h, rs, swz));
        const float f[4] = {norm(v.x, pp, c + h), norm(v.y, pp, c + h + 1),
                            norm(v.z, pp, c + h + 2), norm(v.w, pp, c + h + 3)};
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) w[h + j] = __float_as_uint(f[j]);
        } else {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
          w[h / 2] = *reinterpret_cast<const uint32_t*>(&lo);
          w[h / 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
        }
      }
      reinterpret_cast<uint4*>(dst)[u] = raw;
    }
  } else {
    for (int e = threadIdx.x; e < count; e += CL_THREADS) {
      const int pp = e / c_dim, c = e - pp * c_dim;
      dst[e] = from_f<T>(norm(tile[cl_idx(pp, c, rs, swz)], pp, c));
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   int b, int c, int hw, long long sb, long long sc, long long sp,
                   float eps, cudaStream_t stream) {
  const long long n_pix = (long long)b * hw;
  const int chunks = (c + CHUNK - 1) / CHUNK;
  const bool dense_cl = sc == 1 && (hw == 1 || sp == c) && (b == 1 || sb == (long long)hw * c);
  if (dense_cl) {
    int pix = 1;
    while (pix < CL_MAX_PIX && 2 * pix * c <= CL_TILE) pix *= 2;
    const long long blocks = (n_pix + pix - 1) / pix;
    const size_t bytes = sizeof(float) * ((size_t)pix * ((c + 3) & ~3) + 2 * pix * chunks + 2 * pix);
    if (blocks > 0x7fffffffLL || bytes > 48 * 1024) return cudaErrorInvalidValue;
    const bool vec = (c * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(y);
    ln2d_cl_kernel<T><<<(unsigned)blocks, CL_THREADS, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y), n_pix, c, pix, vec, eps);
    return cudaGetLastError();
  }
  const long long blocks = (n_pix + PIX - 1) / PIX;
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
// bias: (c,) fp32; c <= 6144 (the NCHW kernel's partial sums fill at most
// 48 KB of shared memory). Dense channels-last x (sc = 1, sp = c, sb = hw *
// c or b = 1) takes the staged kernel, any other strides the NCHW one. Launches on `stream` without synchronising and
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
