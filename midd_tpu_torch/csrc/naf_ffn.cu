// The FFN half of a NAFBlock, fused, for Hopper (sm_90a). Forward only.
//
// Replaces the TPU kernel midd_tpu/ops/naf_ffn.py::_kernel (pallas_call in
// _ffn_rows). For y of shape (B, C, H, W), contiguous, fp32 or bf16, and
// fp32 parameters as the port's modules hold them (norm2 scale, bias (C,);
// conv4 weight (2C, C) and bias (2C,); conv5 weight (C, C) and bias (C,);
// gamma (C,)), per pixel with x = y[b, :, h, w]:
//     xn  = (x - mean x) / sqrt(var x + 1e-6) * scale + bias
//           (centred variance, as the TPU kernel; unlike LayerNorm2d's
//            one-pass variance in ln2d.cu, on purpose, as in JAX)
//     h   = W4 xn + b4                      (2C)
//     g   = h[:C] * h[C:]                   (SimpleGate)
//     out = x + (W5 g + b5) * gamma
// all in fp32, out in y's dtype.
//
// Translation from the TPU form. The TPU kernel kept w4 and w5 whole in VMEM
// and padded C to 128 lanes (at C 32 its products were 16x the true ones).
// Here C is not padded, and the weights do not fit in shared memory (w4 at
// C 512 is 2 MB in fp32), so a block owns a tile of 32 pixels, one per lane,
// and keeps xn (C x 32) and then g (C x 32) in shared memory while it
// streams 32-column x 32-deep tiles of W4 (both gate halves, rows j and
// C + j) and of W5 through a small shared buffer. Warp w computes columns
// 4w..4w+3 of each column tile for its lane's pixel, so a weight tile entry
// is a broadcast and an activation entry a conflict-free lane read. The
// products are CUDA-core fp32 FMAs. Rows (pixels) past B*H*W compute on
// zeros and are not stored. Like ln2d.cu it takes NCHW or channels-last y
// through its strides (out has y's strides); in channels-last a warp's
// loads and stores are no longer coalesced but its lines stay in L1.
//
// Bound on this card. 6 * P * C^2 operations (2*C*2C for the first product,
// 2*C*C for the second) with P = B*H*W: at every SERVE_NAFNET stage P * C^2
// is the same, 1.61 GFLOP per call at batch 1, 512^2, which takes 24 us at
// the 67 TFLOP/s fp32 CUDA-core rate; it reads y once and writes out once,
// 2 * P * C * bytes (67.1 MB fp32 at C 32: 20 us at 3.35 TB/s). So the
// bound is by operations at C >= 64 and close to balanced at C 32. What the
// design does: activations never leave the SM between the norm and the
// output (one read, one write of device memory per element), weight tiles
// are shared by all 32 pixels of a block, and each thread keeps 4 (or 8)
// accumulators so a shared-memory load feeds several FMAs. Not yet: tensor
// cores, and more blocks at the wide stages (C 512 at 32^2 has 32 blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int R = 32;          // pixels per block, one per lane
constexpr int WARPS = 8;
constexpr int THREADS = R * WARPS;
constexpr int TJ = 32;         // output columns per tile (4 per warp)
constexpr int KC = 32;         // depth of a weight tile
constexpr int WS = 2 * TJ + 4; // weight-tile row stride in floats (16-byte aligned)
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr size_t smem_bytes(int c) {
  return (size_t)2 * c * R * sizeof(float) + (size_t)KC * WS * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
naf_ffn_kernel(const T* __restrict__ y, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ w4,
               const float* __restrict__ b4, const float* __restrict__ w5,
               const float* __restrict__ b5, const float* __restrict__ gamma,
               T* __restrict__ out, long long n_pix, int C, long long hw,
               long long sb, long long sc, long long sp) {
  extern __shared__ float smem[];
  float* xn = smem;              // [C][R]
  float* g = xn + (size_t)C * R; // [C][R]
  float* wt = g + (size_t)C * R; // [KC][WS]
  __shared__ float s_part[WARPS][R];
  __shared__ float q_part[WARPS][R];

  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int tid = w * R + lane;
  const long long p = (long long)blockIdx.x * R + lane;
  const bool valid = p < n_pix;
  long long base = 0;  // offset of (b, channel 0, pixel)
  if (valid) {
    const long long b = p / hw;
    base = b * sb + (p - b * hw) * sp;
  }

  // -- LayerNorm of the tile (centred variance) into xn ----------------------
  float s = 0.f;
  for (int c = w; c < C; c += WARPS) {
    const float v = valid ? to_f(y[base + c * sc]) : 0.f;
    xn[c * R + lane] = v;
    s += v;
  }
  s_part[w][lane] = s;
  __syncthreads();
  float mean = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) mean += s_part[i][lane];
  mean /= (float)C;
  float q = 0.f;
  for (int c = w; c < C; c += WARPS) {
    const float d = xn[c * R + lane] - mean;
    q = fmaf(d, d, q);
  }
  q_part[w][lane] = q;
  __syncthreads();
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) var += q_part[i][lane];
  const float sd = sqrtf(var / (float)C + 1e-6f);
  for (int c = w; c < C; c += WARPS) {
    xn[c * R + lane] = (xn[c * R + lane] - mean) / sd * scale[c] + bias[c];
  }

  // -- g = (W4[:C] xn + b4[:C]) * (W4[C:] xn + b4[C:]), 32 columns a tile ----
  for (int j0 = 0; j0 < C; j0 += TJ) {
    float acc_a[4] = {0.f, 0.f, 0.f, 0.f};
    float acc_b[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // xn written / the previous weight tile consumed
      for (int idx = tid; idx < 2 * TJ * KC; idx += THREADS) {
        const int kk = idx % KC, col = idx / KC;  // col: [0, TJ) gate a, [TJ, 2TJ) gate b
        const int j = j0 + (col % TJ), k = k0 + kk;
        wt[kk * WS + col] =
            (j < C && k < C) ? w4[(size_t)((col / TJ) * C + j) * C + k] : 0.f;
      }
      __syncthreads();
      const int kn = min(KC, C - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float a = xn[(k0 + kk) * R + lane];
        const float4 wa = *reinterpret_cast<const float4*>(wt + kk * WS + 4 * w);
        const float4 wb = *reinterpret_cast<const float4*>(wt + kk * WS + TJ + 4 * w);
        acc_a[0] = fmaf(a, wa.x, acc_a[0]);
        acc_a[1] = fmaf(a, wa.y, acc_a[1]);
        acc_a[2] = fmaf(a, wa.z, acc_a[2]);
        acc_a[3] = fmaf(a, wa.w, acc_a[3]);
        acc_b[0] = fmaf(a, wb.x, acc_b[0]);
        acc_b[1] = fmaf(a, wb.y, acc_b[1]);
        acc_b[2] = fmaf(a, wb.z, acc_b[2]);
        acc_b[3] = fmaf(a, wb.w, acc_b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + 4 * w + i;
      if (j < C) g[j * R + lane] = (acc_a[i] + b4[j]) * (acc_b[i] + b4[C + j]);
    }
  }

  // -- out = y + (W5 g + b5) * gamma, 32 output channels a tile -------------
  for (int o0 = 0; o0 < C; o0 += TJ) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // g written / the previous weight tile consumed
      for (int idx = tid; idx < TJ * KC; idx += THREADS) {
        const int kk = idx % KC, col = idx / KC;
        const int o = o0 + col, k = k0 + kk;
        wt[kk * WS + col] = (o < C && k < C) ? w5[(size_t)o * C + k] : 0.f;
      }
      __syncthreads();
      const int kn = min(KC, C - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float a = g[(k0 + kk) * R + lane];
        const float4 wv = *reinterpret_cast<const float4*>(wt + kk * WS + 4 * w);
        acc[0] = fmaf(a, wv.x, acc[0]);
        acc[1] = fmaf(a, wv.y, acc[1]);
        acc[2] = fmaf(a, wv.z, acc[2]);
        acc[3] = fmaf(a, wv.w, acc[3]);
      }
    }
    if (valid) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = o0 + 4 * w + i;
        if (o < C) {
          const long long at = base + o * sc;
          out[at] = from_f<T>(to_f(y[at]) + (acc[i] + b5[o]) * gamma[o]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* scale, const void* bias,
                   const void* w4, const void* b4, const void* w5,
                   const void* b5, const void* gamma, void* out, int b, int c,
                   int hw, long long sb, long long sc, long long sp,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(c);
  auto kern = naf_ffn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long n_pix = (long long)b * hw;
  const long long blocks = (n_pix + R - 1) / R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)blocks), dim3(R, WARPS), bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(w4),
      static_cast<const float*>(b4), static_cast<const float*>(w5),
      static_cast<const float*>(b5), static_cast<const float*>(gamma),
      static_cast<T*>(out), n_pix, c, (long long)hw, sb, sc, sp);
  return cudaGetLastError();
}

}  // namespace

// The largest C whose tile fits in a block's shared memory (with the 2 KB of
// static partial sums).
extern "C" int midd_naf_ffn_max_channels() {
  int c = 1;
  while (smem_bytes(c + 1) + 2 * WARPS * R * sizeof(float) <= (size_t)MAX_SMEM) ++c;
  return c;
}

// Plain C entry point for ctypes. y, out: (b, c, hw) dense, one dtype
// (is_bf16 ? bf16 : fp32), element (b, c, p) at b * sb + c * sc + p * sp in
// both; scale, bias, b5, gamma: (c,), w4: (2c, c), b4: (2c,), w5: (c, c),
// all fp32 contiguous. Launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 = success).
extern "C" int midd_naf_ffn(const void* y, const void* scale, const void* bias,
                            const void* w4, const void* b4, const void* w5,
                            const void* b5, const void* gamma, void* out, int b,
                            int c, int hw, long long sb, long long sc,
                            long long sp, int is_bf16, void* stream) {
  if (b < 1 || c < 1 || hw < 1 || c > midd_naf_ffn_max_channels())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(y, scale, bias, w4, b4, w5, b5, gamma, out, b, c, hw, sb, sc, sp, s)
              : launch<float>(y, scale, bias, w4, b4, w5, b5, gamma, out, b, c, hw, sb, sc, sp, s);
  return (int)err;
}

extern "C" const char* midd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
