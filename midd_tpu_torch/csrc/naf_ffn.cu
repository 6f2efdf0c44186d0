// The FFN half of a NAFBlock, fused, for Hopper (sm_90a). Forward only.
//
// Replaces the TPU kernel midd_tpu/ops/naf_ffn.py::_kernel (pallas_call in
// _ffn_rows). For y of shape (B, C, H, W), fp32 or bf16, in NCHW or
// channels-last order, and the parameters as the port's modules hold them
// (norm2 scale, bias (C,); conv4 weight (2C, C) and bias (2C,); conv5 weight
// (C, C) and bias (C,); gamma (C,)), per pixel with x = y[b, :, h, w]:
//     xn  = (x - mean x) / sqrt(var x + 1e-6) * scale + bias
//           (centred variance, as the TPU kernel; unlike LayerNorm2d's
//            one-pass variance in ln2d.cu, on purpose, as in JAX)
//     h   = W4 xn + b4                      (2C)
//     g   = h[:C] * h[C:]                   (SimpleGate)
//     out = x + (W5 g + b5) * gamma
// with the norm's statistics, the sums, the gate and the epilogue in fp32 and
// out in y's dtype and strides.
//
// Bound on this card. 6 P C^2 + ~12 P C operations with P = B*H*W (2*C*2C for
// the first product, 2*C*C for the second). P C^2 is the same at every
// SERVE_NAFNET stage: 1.61 GFLOP per call at batch 1, 512^2, 3.3 us at the
// TF32 tensor-core rate (495 TFLOP/s; bf16: 989). The call reads y and
// writes out once, 2 P C elements (67.1 MB in fp32 at C 32, 20 us at
// 3.35 TB/s). So the bound is by bytes up to C 128 at 512^2 and by
// operations at C 256 and 512 (3.3 us fp32, 1.6 us bf16).
//
// Design. Both products are warp-level tensor-core products, mma.sync on
// ldmatrix fragments through flash_mma.cuh: bf16 y takes warp_gemm_nt's
// m16n8k16 in one pass on xn, g and weights rounded to bf16 (what the TPU
// kernel's default-precision fp32 dot does on the MXU); the wrapper passes W4
// and W5 cast to bf16 once per call. fp32 y takes m16n8k8 TF32 in three
// passes (hi.hi + hi.lo + lo.hi, as the flash kernels' fp32 path) through
// warp_gemm_nt_tf32x3, which splits by integer rounding (split_tf32_fast: the
// conversions of split_tf32 set the pace of the products on this card) and
// loads a k step's fragments before the one before it is multiplied; its sum
// over one 32-deep slice is added on the CUDA cores (see the note above
// to_f).
// A block owns M pixel rows (16 per warp row, the mma's M) and keeps them in
// shared memory from the first read of y to the last write of out: x in fp32,
// xn and then g as the mma's A operand (pixels x channels, row-major, K padded
// with zeros to the tile depth). The 8 warps are MR rows x WN columns of the
// output (MR * WN = 8, 16 columns a warp), so xn and g are shared by the
// block. Weights stream through a three-stage cp.async ring (two tiles in
// flight while the warps compute on the third) of tiles 128 bytes of a row
// deep (x 2 or 4 where shared memory allows) and, for the first product,
// 2 * 16 * WN rows: warp column wn gets rows j.. of W4 (gate half a) followed
// by rows C + j.. (half b), so one warp product gives both halves of its 16
// columns and SimpleGate is a product of two accumulator fragments, with b4
// added, whose result goes to g in shared memory and never to device memory.
// The second product's tiles have half the rows and, where C allows, twice
// the depth, so every stage carries about the same bytes. Output columns past
// C are dropped; rows past P compute on zeros and are not stored. The
// epilogue adds b5, multiplies by gamma and adds x in shared memory; then the
// block writes its rows, coalesced as it read them (16-byte accesses where
// the layout and alignment allow). The parameter vectors arrive in shared
// memory by cp.async with the first tiles.
//
// Rows per block. Every block streams all of W4 and W5 (3 C^2 elements) from
// L2, and P C^2 is constant, so the blocks' sum is 3 P C^2 / M elements: the
// host takes the largest M of 128 (C <= 32 only), 64, 32, 16 whose shared
// memory fits and that still gives 128 blocks (about one per SM of the 132),
// else 16. Launch shape per SERVE_NAFNET stage, batch 1, 512^2, fp32 (bf16:
// the same rows; 128 bytes of a row are 64 deep), 3 blocks an SM where shared
// memory allows:
//   C  32 at 512^2: M 128, 2048 blocks, MR x WN = 8 x 1 warps, 2 + 2 tiles
//   C  64 at 256^2: M  64, 1024 blocks, 4 x 2 warps, 2 + 2 tiles of 64 deep
//   C 128 at 128^2: M  64,  256 blocks, 4 x 2 warps, 4 + 4 tiles of 128 deep
//   C 256 at  64^2: M  32,  128 blocks, 2 x 4 warps, 16 + 8 tiles of 64 (128)
//   C 512 at  32^2: M  16,   64 blocks, 1 x 8 warps, 64 + 32 tiles of 32 (64)
// What holds it back (chip_smoke.py phase 6 against the bound): at C 512 and
// 256 each block streams all of W4 and W5 from L2 (3 MB at C 512, fp32) and
// the warps that issue those copies stall on them between their products; at
// C 32 and 64 each block's chain of read, norm, products and write. Not yet:
// wgmma, TMA, clusters (one weight tile for several blocks).
// Registers: 79 (fp32) and 80 (bf16), no spills (-Xptxas -v, the build phase
// of chip_smoke.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using namespace midd_mma;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_ROWS = 128;              // pixel rows of a block, at most (C <= 32)
constexpr int MIN_BLOCKS = 128;            // the rows per block shrink (to 16) to keep this many blocks
constexpr int STAGES = 3;                  // weight tiles: one computed on, two in flight
constexpr int LOADS = 8;                   // scalar loads of y in flight a thread
constexpr int VLOADS = 4;                  // 16-byte loads of y in flight a thread

// fp32 products sum their three TF32 passes in the tensor cores over one
// 32-deep slice (12 accumulations, warp_gemm_nt_tf32x3) from zero, and the
// kernel adds the slice's sum on the CUDA cores. Mma<float> does that for
// every k step (3 accumulations); one chain over all of C (up to 192
// accumulations at C 512) drifts under the tensor cores' truncating
// accumulation, as the flash kernels' long chains did, toward phase 6's 1e-5
// bound, while 12-long ones stay near Mma<float>'s error.

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes of T <-> 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// Shapes of a block, in elements of the operand type O: weight tiles of
// kc = KC0 * kmul columns (KC0: 128 bytes, the depth of one warp product
// call), K padded to kc, rows padded by Mma<O>::PAD so that ldmatrix's 8 row
// addresses fall in distinct banks.
template <typename O> struct Shape {
  static constexpr int KC0 = 128 / sizeof(O);
  int m, jt, kmul, kc, ts, ck, as, xs;  // rows, columns a tile, tile depth, its row stride,
                                        // padded C, xn/g and x row strides
  __host__ __device__ Shape(int c, int rows, int kmul_)
      : m(rows), jt(16 * (WARPS * 16 / rows)), kmul(kmul_), kc(KC0 * kmul_),
        ts(KC0 * kmul_ + Mma<O>::PAD), ck((c + kc - 1) / kc * kc), as(ck + Mma<O>::PAD),
        xs(c | 1) {}
  // ring (STAGES x 2 jt rows), xn, g (16-byte multiples), the fp32
  // parameters (6 C) and x (fp32)
  __host__ __device__ size_t smem(int c) const {
    return (size_t)STAGES * 2 * jt * ts * sizeof(O) + (size_t)2 * m * as * sizeof(O) +
           (size_t)6 * c * sizeof(float) + (size_t)m * xs * sizeof(float);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)  // 3 blocks an SM where shared memory allows
naf_ffn_kernel(const T* __restrict__ y, const float* __restrict__ scale,
               const float* __restrict__ bias, const T* __restrict__ w4,
               const float* __restrict__ b4, const T* __restrict__ w5,
               const float* __restrict__ b5, const float* __restrict__ gamma,
               T* __restrict__ out, long long n_pix, int C, long long hw,
               long long sb, long long sc, long long sp, int rows, int kmul, bool async_w,
               bool vec_io) {
  using O = T;  // the products' operands in shared memory
  using M = Mma<O>;
  using S = Shape<O>;
  constexpr int KC0 = S::KC0, CHUNK = 16 / sizeof(O), VEC = 16 / sizeof(T);
  const S sh(C, rows, kmul);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  O* ring = reinterpret_cast<O*>(smem_raw);           // [STAGES][2 jt][ts]
  O* xn = ring + STAGES * 2 * sh.jt * sh.ts;          // [m][as]
  O* gs = xn + sh.m * sh.as;                          // [m][as]
  float* prm = reinterpret_cast<float*>(gs + sh.m * sh.as);
  const float* s_scale = prm;                         // norm2 scale, bias, b4 (2C), b5, gamma
  const float* s_bias = prm + C;
  const float* s_b4 = prm + 2 * C;
  const float* s_b5 = prm + 4 * C;
  const float* s_gamma = prm + 5 * C;
  float* xs = prm + 6 * C;                            // [m][xs]
  __shared__ long long row_base[MAX_ROWS];            // offset of (pixel, channel 0) in y, or -1

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wn_count = sh.jt / 16;
  const int wr = w / wn_count, wn = w - wr * wn_count;
  const int gq = lane >> 2, tq = lane & 3;
  const int m_log = __ffs(sh.m) - 1, kc_log = __ffs(sh.kc) - 1;
  const long long p0 = (long long)blockIdx.x * sh.m;
  // the second product's tiles have half the rows: twice the depth where C allows
  const int kmul2 = C % (2 * sh.kc) == 0 ? 2 * sh.kmul : sh.kmul;
  const int kc2 = kmul2 * KC0;
  const int nk = sh.ck / sh.kc, nk2 = sh.ck / kc2, njt = (C + sh.jt - 1) / sh.jt;
  const int n1 = njt * nk, total = n1 + njt * nk2;  // tiles of the first product, then of the second
  // tile t -> (first product?, column tile, k tile)
  auto coords = [&](int t, bool& first, int& ct, int& kt) {
    first = t < n1;
    const int tt = first ? t : t - n1;
    const int n = first ? nk : nk2;
    ct = tt / n;
    kt = tt - ct * n;
  };

  // Tile t into ring stage `stage`: (column tile, k tile) of W4's gate rows
  // (t < n1) or of W5's rows, as one cp.async group (empty past the last
  // tile). Tile row q of the first product holds column j = n0 + 16 (q / 32)
  // + q % 16 of gate half (q / 16) % 2, i.e. W4 row j or C + j; of the second,
  // W5 row n0 + q. 16-byte cp.async where rows are 16-byte aligned, else
  // plain loads, visible after the next barrier. (Offsets fit in an int: 2 C^2
  // < 2^31.)
  auto load_tile = [&](int t, int stage) {
    if (t < total) {
      bool first;
      int ct, kt;
      coords(t, first, ct, kt);
      const int n0 = ct * sh.jt, k0 = kt * (first ? sh.kc : kc2);
      const int n_rows = first ? 2 * sh.jt : sh.jt;
      const int ts = first ? sh.ts : kc2 + M::PAD;
      const O* src = first ? w4 : w5;
      O* dst = ring + stage * 2 * sh.jt * sh.ts;
      const int row_log = first ? kc_log : kc_log + (kmul2 / sh.kmul - 1);
      const int elt_log = async_w ? row_log - (sizeof(O) == 4 ? 2 : 3) : row_log;  // log2 of a row's
      const int width = async_w ? CHUNK : 1;                                    // copies; their width
      for (int e = tid; e < n_rows << elt_log; e += THREADS) {
        const int q = e >> elt_log, k = (e & ((1 << elt_log) - 1)) * width;
        const int j = first ? n0 + ((q >> 5) << 4) + (q & 15) : n0 + q;
        const int r = first && (q & 16) ? C + j : j;
        const bool full = j < C && k0 + k < C;
        if (async_w)
          cp_async16(smem_addr(dst + q * ts + k), src + (full ? r * C + k0 + k : 0), full);
        else
          dst[q * ts + k] = full ? src[r * C + k0 + k] : from_float<O>(0.f);
      }
    }
    cp_async_commit();
  };

  // -- the parameters and the first weight tiles, in flight during the norm -
  for (int i = tid; i < 6 * C; i += THREADS) {
    const float* src = i < C ? scale + i : i < 2 * C ? bias + (i - C)
                     : i < 4 * C ? b4 + (i - 2 * C) : i < 5 * C ? b5 + (i - 4 * C) : gamma + (i - 5 * C);
    cp_async4(smem_addr(prm + i), src, true);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i, i);

  // -- x of the block's rows into shared memory -----------------------------
  for (int m = tid; m < sh.m; m += THREADS) {
    const long long p = p0 + m;
    long long base = -1;
    if (p < n_pix) {
      const long long b = p / hw;
      base = b * sb + (p - b * hw) * sp;
    }
    row_base[m] = base;
  }
  __syncthreads();
  const bool pix_fast = sp == 1;  // NCHW: neighbouring threads on neighbouring pixels
  const int n_el = sh.m * C;
  auto pixel = [&](int e) { return pix_fast ? e & (sh.m - 1) : e / C; };
  auto channel = [&](int e) { return pix_fast ? e >> m_log : e % C; };
  // vector v: VEC pixels of one channel (NCHW) or VEC channels of one pixel
  auto vpixel = [&](int v) { return pix_fast ? (v * VEC) & (sh.m - 1) : (v * VEC) / C; };
  auto vchannel = [&](int v) { return pix_fast ? (v * VEC) >> m_log : (v * VEC) % C; };
  auto vput = [&](int v, const float* f) {  // into xs
    const int m = vpixel(v), c = vchannel(v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) xs[(pix_fast ? (m + i) * sh.xs + c : m * sh.xs + c + i)] = f[i];
  };
  if (vec_io) {
    const int n_vec = n_el / VEC;
    for (int v0 = tid; v0 < n_vec; v0 += VLOADS * THREADS) {
      uint4 r[VLOADS];
#pragma unroll
      for (int u = 0; u < VLOADS; ++u) {
        const int v = v0 + u * THREADS;
        const long long base = v < n_vec ? row_base[vpixel(v)] : -1;
        r[u] = base >= 0 ? *reinterpret_cast<const uint4*>(y + base + vchannel(v) * sc) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < VLOADS; ++u) {
        const int v = v0 + u * THREADS;
        float f[VEC];
        unpack(r[u], f, T());
        if (v < n_vec) vput(v, f);
      }
    }
  } else {
    for (int e0 = tid; e0 < n_el; e0 += LOADS * THREADS) {
      float v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = e0 + u * THREADS;
        const long long base = e < n_el ? row_base[pixel(e)] : -1;
        v[u] = base >= 0 ? to_f(y[base + channel(e) * sc]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = e0 + u * THREADS;
        if (e < n_el) xs[pixel(e) * sh.xs + channel(e)] = v[u];
      }
    }
  }
  cp_async_wait<STAGES - 1>();  // this thread's parameter copies
  __syncthreads();              // x, the row bases and the parameters visible

  // -- LayerNorm (centred variance), every row at once: tpr neighbouring
  // threads a row, reduced by shuffles within their group
  {
    const int tpr = THREADS / sh.m;
    const int m = tid / tpr, sub = tid - m * tpr;
    const float* xr = xs + m * sh.xs;
    float s = 0.f;
#pragma unroll 4
    for (int c = sub; c < C; c += tpr) s += xr[c];
    for (int o = tpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / (float)C;
    float q = 0.f;
#pragma unroll 4
    for (int c = sub; c < C; c += tpr) {
      const float d = xr[c] - mean;
      q = fmaf(d, d, q);
    }
    for (int o = tpr / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float inv_sd = 1.f / sqrtf(q / (float)C + 1e-6f);
#pragma unroll 4
    for (int c = sub; c < C; c += tpr)
      xn[m * sh.as + c] = from_float<O>((xr[c] - mean) * inv_sd * s_scale[c] + s_bias[c]);
    for (int c = C + sub; c < sh.ck; c += tpr)  // K's padding, in xn and in g, is zero
      xn[m * sh.as + c] = gs[m * sh.as + c] = from_float<O>(0.f);
  }

  // -- the two products over the ring of weight tiles ------------------------
  // acc += A B over one KC0 slice: bf16 straight into acc; fp32 through a sum
  // from zero that is then added to acc
  auto zero = [](auto& acc) {
#pragma unroll
    for (auto& r : acc) r[0] = r[1] = r[2] = r[3] = 0.f;
  };
  auto gemm = [&](auto& acc, const O* a, const O* b, int ts) {
    constexpr int NT = sizeof(acc) / sizeof(acc[0]);
    if constexpr (sizeof(O) == 4) {
      float part[NT][4];
      zero(part);
      warp_gemm_nt_tf32x3<NT, KC0>(part, a, sh.as, b, ts, lane);
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
    } else {
      warp_gemm_nt<O, NT, KC0>(acc, a, sh.as, b, ts, lane);
    }
  };
  float acc1[4][4];  // first product: [0..1] gate half a, [2..3] half b, 16 columns
  float acc2[2][4];  // second product, 16 columns
  const O* a1 = xn + 16 * wr * sh.as;
  const O* a2 = gs + 16 * wr * sh.as;
  for (int t = 0; t < total; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t (this thread's copies)
    __syncthreads();  // tile t, xn (t = 0) and g (t = n1) visible; tile t - 1 consumed
    load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);  // into the stage tile t - 1 held
    const O* tile = ring + (t % STAGES) * 2 * sh.jt * sh.ts;
    bool first;
    int ct, kt;  // column tile, k tile
    coords(t, first, ct, kt);
    const int j0 = ct * sh.jt + 16 * wn;  // this warp's first column
    if (first) {
      if (kt == 0) zero(acc1);
      for (int kk = 0; kk < sh.kmul; ++kk)
        gemm(acc1, a1 + kt * sh.kc + kk * KC0, tile + 32 * wn * sh.ts + kk * KC0, sh.ts);
      if (kt == nk - 1) {  // SimpleGate into g
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 8 * nt + M::col(tq, e & 1);
            const int r = 16 * wr + gq + 8 * (e >> 1);
            if (j < C)
              gs[r * sh.as + j] = from_float<O>((acc1[nt][e] + s_b4[j]) * (acc1[nt + 2][e] + s_b4[C + j]));
          }
      }
    } else {
      if (kt == 0) zero(acc2);
      for (int kk = 0; kk < kmul2; ++kk)
        gemm(acc2, a2 + kt * kc2 + kk * KC0, tile + 16 * wn * (kc2 + M::PAD) + kk * KC0, kc2 + M::PAD);
      if (kt == nk2 - 1) {  // x + (W5 g + b5) * gamma, in place of x
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = j0 + 8 * nt + M::col(tq, e & 1);
            const int r = 16 * wr + gq + 8 * (e >> 1);
            if (o < C) xs[r * sh.xs + o] += (acc2[nt][e] + s_b5[o]) * s_gamma[o];
          }
      }
    }
  }
  __syncthreads();

  // -- the block's rows out, coalesced as they were read ----------------------
  if (vec_io) {
    for (int v = tid; v < n_el / VEC; v += THREADS) {
      const long long base = row_base[vpixel(v)];
      if (base < 0) continue;
      const int m = vpixel(v), c = vchannel(v);
      float f[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = xs[(pix_fast ? (m + i) * sh.xs + c : m * sh.xs + c + i)];
      *reinterpret_cast<uint4*>(out + base + c * sc) = pack(f, T());
    }
  } else {
    for (int e = tid; e < n_el; e += THREADS) {
      const long long base = row_base[pixel(e)];
      if (base >= 0) out[base + channel(e) * sc] = from_float<T>(xs[pixel(e) * sh.xs + channel(e)]);
    }
  }
}

constexpr size_t STATIC_SMEM = MAX_ROWS * sizeof(long long);

template <typename T> bool fits(int c, int rows, int kmul) {
  return Shape<T>(c, rows, kmul).smem(c) + STATIC_SMEM <= (size_t)SMEM_MAX;
}

// The rows per block: the largest of MAX_ROWS, ..., 32, 16 that fits and
// keeps MIN_BLOCKS blocks, else 16; then the deepest weight tile (4, 2 or 1 x
// 128 bytes a row, dividing C's 128-byte units) that fits.
template <typename T> void shape_for(int c, long long n_pix, int& rows, int& kmul) {
  const int units = (c + Shape<T>::KC0 - 1) / Shape<T>::KC0;
  for (rows = MAX_ROWS; rows > 16; rows /= 2)
    if ((rows <= 64 || c <= 32) && fits<T>(c, rows, 1) &&
        (n_pix + rows - 1) / rows >= MIN_BLOCKS) break;
  for (kmul = 4; kmul > 1; kmul /= 2)
    if (units % kmul == 0 && fits<T>(c, rows, kmul)) break;
}

template <typename T>
cudaError_t launch(const void* y, const void* scale, const void* bias,
                   const void* w4, const void* b4, const void* w5,
                   const void* b5, const void* gamma, void* out, int b, int c,
                   int hw, long long sb, long long sc, long long sp,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long n_pix = (long long)b * hw;
  int rows, kmul;
  shape_for<T>(c, n_pix, rows, kmul);
  const size_t bytes = Shape<T>(c, rows, kmul).smem(c);
  auto kern = naf_ffn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_pix + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool async_w = (c * sizeof(T)) % 16 == 0 && aligned16(w4) && aligned16(w5);
  // 16-byte loads and stores of y and out: VEC pixels of a channel (NCHW) or
  // VEC channels of a pixel (channels-last), never across an image
  const bool vec_io = aligned16(y) && aligned16(out) && sb % VEC == 0 &&
                      ((sp == 1 && hw % VEC == 0 && sc % VEC == 0) ||
                       (sc == 1 && c % VEC == 0 && sp % VEC == 0));
  kern<<<dim3((unsigned)blocks), dim3(THREADS), bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(w4),
      static_cast<const float*>(b4), static_cast<const T*>(w5),
      static_cast<const float*>(b5), static_cast<const float*>(gamma),
      static_cast<T*>(out), n_pix, c, (long long)hw, sb, sc, sp, rows, kmul, async_w, vec_io);
  return cudaGetLastError();
}

}  // namespace

// The largest C whose 16-row block fits in shared memory, in both dtypes.
extern "C" int midd_naf_ffn_max_channels() {
  int c = 1;
  while (fits<float>(c + 1, 16, 1) && fits<__nv_bfloat16>(c + 1, 16, 1)) ++c;
  return c;
}

// Plain C entry point for ctypes. y, out: (b, c, hw) dense, one dtype
// (is_bf16 ? bf16 : fp32), element (b, c, p) at b * sb + c * sc + p * sp in
// both; w4: (2c, c) and w5: (c, c) in y's dtype; scale, bias, b4 (2c,), b5,
// gamma: (c,) fp32; all contiguous. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 = success).
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
