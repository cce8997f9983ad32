// Fused GroupNorm-affine + SiLU + int8-quantize 3x3 SAME conv on NCHW tensors (kernel K3).
//
// Replaces the Pallas kernel use_tpu/ops/pallas_qconv.py::qconv3x3_fused (body
// `_kernel` at :42, the pallas_call at :239), the conv of the int8 serving path
// quant='int8_pallas' (use_tpu/models/ncsnpp/layers.py:124-149):
//
//   q[b, c, h, w] = clip(rint(act(x * a[b, c] + off[b, c]) * iu[c]), -127, 127)   (0 outside the image)
//   out[b, o, h, w] = float(sum_{c, dy, dx} q[b, c, h+dy-1, w+dx-1] * qw[o, c, dy, dx]) * sw[o] + bias[o]
//
// Bound on the H100: bytes and operations come close. At B 8, C 256, O 128,
// 512 x 192 the 4.6e11 int8 operations (2 * 9 * C * O an output pixel) take
// 0.23 ms at the dense int8 tensor-core peak (1,979 TOP/s); reading x once
// and writing out once takes 0.36 ms in fp32 and 0.18 ms in bf16 at 3.35 TB/s.
//
// Design: an implicit GEMM on the tensor cores, M = the block's output
// pixels, N = output channels, K = 9 taps x C, as mma.sync.m16n8k32 on s8
// operands with int32 sums (exact in any order, so bit-equal to the plain
// version).
// - A block owns one batch item, a window of TH x TW output pixels and BN
//   output channels. It walks the input channels in chunks of 32 (the k of
//   one mma), double-buffered in dynamic shared memory.
// - The producer (every thread) reads x, applies the affine and SiLU,
//   quantizes, and stages the window with its one-pixel halo pixel-major:
//   the 32 channels of a pixel in 32 bytes, its two 16-byte halves swapped
//   on every other group of 4 pixels, so that the 8 row addresses of one
//   ldmatrix fall in distinct banks. It writes quantized zeros outside the
//   image. x cannot go through cp.async, since it is computed on the way
//   in: its loads are issued into registers two chunks before the products
//   that read them, so they land while a whole chunk of products runs.
// - The weights arrive prepared ([C/32, 9, O, 32] int8, K-contiguous per
//   output channel: the col-major B operand) by cp.async, swizzled the same.
// - Each warp owns a WM x WN sub-tile. For each tap, ldmatrix.x4 reads the A
//   fragments as the staged window shifted by (dy, dx) pixels: the 3x3
//   shifts cost no copies.
// - The epilogue dequantizes in registers (acc * sw[o] + bias[o], rounded
//   step by step), stages the output tile in shared memory and writes rows
//   of the window with 16-byte stores.
// Three tiles, picked per launch by the wrapper (ops/fused_qconv.py
// pick_tile): 8 x 16 pixels x 128 channels (8 warps of 32 x 64, two blocks
// an SM), the same window x 256 channels for O > 128 (16 warps: the operand
// is produced once for all 256), and 8 x 8 pixels x 64 channels (4 warps of
// 32 x 32) for images at most 12 wide, where the wide window is mostly
// padding.
//
// Measurement builds (use_tpu_torch/tools/qconv_ablation.py) leave out one
// part with -DQC_SKIP_PRODUCE (quantized operand not computed),
// -DQC_SKIP_MMA (no products) or -DQC_SKIP_WLOAD (weights not loaded); the
// library is built without them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 32;  // input channels a chunk: the k of one mma (32 bytes)

template <int TH_, int TW_, int BN_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int HC = TW + 2;                 // staged columns with the halo
  static constexpr int NPIX = (TH + 2) * HC;        // staged pixels with the halo
  static constexpr int BM = TH * TW;                // output pixels a block
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;   // mma tiles a warp
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int A_BYTES = (NPIX * 32 + 127) / 128 * 128;
  static constexpr int W_BYTES = 9 * BN * 32;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int SMEM = 2 * STAGE;
  static_assert(TW % 8 == 0, "8 consecutive pixels of an ldmatrix lie in one row");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole m16 tiles and pairs of n8 tiles");
};
using WideTile = Tile<8, 16, 128, 4, 2, 2>;
using Wide256Tile = Tile<8, 16, 256, 4, 4, 1>;
using NarrowTile = Tile<8, 8, 64, 2, 2, 4>;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 1 / d for d in [1, 2^126): the approximate reciprocal and one Newton step
// with fused multiply-adds give the IEEE quotient at every such float
// (checked exhaustively on the card by qconv_rcp_check below), without the
// branch to a slow path that a division compiles to.
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.f), r);
}

// The producer of the operand for N consecutive channels of one pixel (N a
// multiple of 4; a, off, iu 16-byte aligned at the first channel), rounded
// step by step as the plain version: __fmul_rn / __fadd_rn (no FMA
// contraction), the sigmoid as 1 / (1 + exp(-y)), rintf (half to even).
// The reciprocals take rcp_newton unless some 1 + exp(-y) is 2^126 or more
// (or NaN): then IEEE divisions, so the result is the plain version's for
// every input, and the common case has no branch between the N channels.
template <int N>
__device__ __forceinline__ void quantize(const float (&v)[N], const float* __restrict__ a,
                                         const float* __restrict__ off,
                                         const float* __restrict__ iu, int act, int (&q)[N]) {
  float y[N];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 a4 = *reinterpret_cast<const float4*>(a + 4 * j);
    const float4 o4 = *reinterpret_cast<const float4*>(off + 4 * j);
    y[4 * j] = __fadd_rn(__fmul_rn(v[4 * j], a4.x), o4.x);
    y[4 * j + 1] = __fadd_rn(__fmul_rn(v[4 * j + 1], a4.y), o4.y);
    y[4 * j + 2] = __fadd_rn(__fmul_rn(v[4 * j + 2], a4.z), o4.z);
    y[4 * j + 3] = __fadd_rn(__fmul_rn(v[4 * j + 3], a4.w), o4.w);
  }
  if (act) {
    float d[N];
    bool rare = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      d[i] = 1.f + expf(-y[i]);
      rare |= !(d[i] < 0x1p126f);
    }
    if (rare) {
#pragma unroll
      for (int i = 0; i < N; ++i) y[i] = __fmul_rn(y[i], 1.f / d[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) y[i] = __fmul_rn(y[i], rcp_newton(d[i]));
    }
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 u4 = *reinterpret_cast<const float4*>(iu + 4 * j);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = rintf(__fmul_rn(y[4 * j + k], u[k]));
      q[4 * j + k] = (int)fminf(fmaxf(t, -127.f), 127.f);
    }
  }
}

// 16 raw values of x in registers: fp32 as they are, bf16 two to a register.
template <typename T> struct RawX;
template <> struct RawX<float> {
  float v[16];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ void load(int i, const float* p) { v[i] = *p; }
  __device__ __forceinline__ float get(int i) const { return v[i]; }
};
template <> struct RawX<__nv_bfloat16> {
  unsigned w[8];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void load(int i, const __nv_bfloat16* p) {
    w[i / 2] |= (unsigned)*reinterpret_cast<const unsigned short*>(p) << (16 * (i % 2));
  }
  // a bf16 is the high half of the float it widens to, exactly
  __device__ __forceinline__ float get(int i) const {
    return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
};

// Byte offset of 16-byte half `half` of 32-byte row `row` (a pixel of the
// staged window, or an output channel of one tap's weights): the halves swap
// on every other group of 4 rows, so 8 consecutive rows hit all 32 banks.
__device__ __forceinline__ int swz(int row, int half) {
  return row * 32 + 16 * (half ^ ((row >> 2) & 1));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; bytes = 0 writes 16 zeros.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// d += a (16 x 32 s8, row-major) * b (32 x 8 s8, col-major), int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (ceil(H / TH) * tiles_w, ceil(O / BN), B), K::kThreads threads, K::SMEM bytes.
template <class K, typename T, typename Tout>
__global__ void __launch_bounds__(K::kThreads, K::MIN_BLOCKS)
qconv_mma_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ off, const float* __restrict__ iu,
                 const int8_t* __restrict__ qw, const float* __restrict__ sw,
                 const float* __restrict__ bias, Tout* __restrict__ out, int C, int H, int W,
                 int O, int tiles_w, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % K::WARPS_M, wn = warp / K::WARPS_M;
  const int h0 = (blockIdx.x / tiles_w) * K::TH;
  const int w0 = (blockIdx.x % tiles_w) * K::TW;
  const int o0 = blockIdx.y * K::BN;
  const long long b = blockIdx.z;
  const long long HW = (long long)H * W;
  const T* xb = x + b * C * HW;
  const float* ab = a + b * C;
  const float* offb = off + b * C;
  const int nk = (C + CK - 1) / CK;

  // weights of chunk kc, all 9 taps, output channels o0 .. o0 + BN (zeros past O)
  auto load_weights = [&](int s, int kc) {
    unsigned char* ws = smem + s * K::STAGE + K::A_BYTES;
    const int8_t* src0 = qw + (long long)kc * 9 * O * CK;
#ifndef QC_SKIP_WLOAD
    for (int e = tid; e < 9 * K::BN * 2; e += K::kThreads) {
      const int half = e & 1, n = (e >> 1) % K::BN, tap = (e >> 1) / K::BN;
      const int o = o0 + n;
      const int8_t* src = o < O ? src0 + ((long long)tap * O + o) * CK + 16 * half : qw;
      cp_async16(smem_u32(ws + swz(tap * K::BN + n, half)), src, o < O ? 16 : 0);
    }
#endif
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // The producer. An item is the 16 channels of one half (16 bytes) of one
  // staged pixel; a thread owns ITEMS of them, the same in every chunk.
  // fetch() loads an item's raw values into registers two chunks ahead of
  // the products that use them, so the loads have a whole chunk of products
  // to land; convert() quantizes them and writes the window of a stage.
  constexpr int ITEMS = (2 * K::NPIX + K::kThreads - 1) / K::kThreads;
  int item_smem[ITEMS], item_x[ITEMS], item_half[ITEMS];
  bool item_in[ITEMS];  // a pixel of the image, else a quantized zero
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tid + it * K::kThreads;
    const int p = e % K::NPIX, half = e / K::NPIX;
    const int hh = h0 + p / K::HC - 1, ww = w0 + p % K::HC - 1;
    item_smem[it] = swz(p, half);
    item_x[it] = hh * W + ww;
    item_half[it] = half;
    item_in[it] = e < 2 * K::NPIX && hh >= 0 && hh < H && ww >= 0 && ww < W;
  }
  RawX<T> raw[ITEMS];
  auto fetch = [&](int kc) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int c0 = kc * CK + 16 * item_half[it];
      const T* xp = xb + (long long)c0 * HW + item_x[it];
      raw[it].clear();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (item_in[it] && c0 + i < C) raw[it].load(i, xp + i * HW);
      }
    }
  };
  auto convert = [&](int s, int kc) {
    unsigned char* as = smem + s * K::STAGE;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if (tid + it * K::kThreads >= 2 * K::NPIX) break;
      unsigned v[4] = {0u, 0u, 0u, 0u};
#ifndef QC_SKIP_PRODUCE
      if (item_in[it]) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // 8 channels at a time; C % 4 == 0
          const int cc = kc * CK + 16 * item_half[it] + 8 * j;
          float xv[8];
          int q[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) xv[i] = raw[it].get(8 * j + i);
          if (cc + 8 <= C) {
            quantize<8>(xv, ab + cc, offb + cc, iu + cc, act, q);
          } else if (cc < C) {  // a ragged last chunk: four channels
            float x4[4] = {xv[0], xv[1], xv[2], xv[3]};
            int q4[4];
            quantize<4>(x4, ab + cc, offb + cc, iu + cc, act, q4);
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i] = i < 4 ? q4[i] : 0;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i] = 0;
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            v[2 * j + k] = (unsigned)(q[4 * k] & 0xff) | (unsigned)(q[4 * k + 1] & 0xff) << 8 |
                           (unsigned)(q[4 * k + 2] & 0xff) << 16 |
                           (unsigned)(q[4 * k + 3] & 0xff) << 24;
          }
        }
      }
#endif
      *reinterpret_cast<uint4*>(as + item_smem[it]) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  // ldmatrix.x4 rows of this lane: A, matrix j = lane / 8 holds pixel rows
  // 8 (j % 2) .. +7 of an m16 tile, bytes 16 (j / 2) ..; B, channels
  // 8 (j / 2) .. +7 of a pair of n8 tiles, bytes 16 (j % 2) ..
  const int lr = lane & 7, lj = lane >> 3;
  int a_pix[K::MI];  // staged pixel this lane's A row reads at tap (0, 0)
#pragma unroll
  for (int mi = 0; mi < K::MI; ++mi) {
    const int m = wm * K::WM + mi * 16 + lr + 8 * (lj & 1);
    a_pix[mi] = (m / K::TW) * K::HC + m % K::TW;
  }
  const int a_half = lj >> 1, b_half = lj & 1;
  const int b_n = wn * K::WN + lr + 8 * (lj >> 1);

  int acc[K::MI][K::NI][4];
#pragma unroll
  for (int mi = 0; mi < K::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < K::NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  load_weights(0, 0);
  fetch(0);
  convert(0, 0);
  if (nk > 1) fetch(1);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) {
      load_weights(s ^ 1, kc + 1);
      convert(s ^ 1, kc + 1);
    }
    if (kc + 2 < nk) fetch(kc + 2);
    const unsigned as = smem_u32(smem + s * K::STAGE);
    const unsigned ws = as + K::A_BYTES;
#ifndef QC_SKIP_MMA
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * K::HC + tap % 3;
      unsigned af[K::MI][4];
#pragma unroll
      for (int mi = 0; mi < K::MI; ++mi) {
        ldmatrix_x4(as + swz(a_pix[mi] + shift, a_half), af[mi][0], af[mi][1], af[mi][2],
                    af[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < K::NI / 2; ++nj) {
        unsigned b0, b1, b2, b3;  // n8 tiles 2 nj and 2 nj + 1
        ldmatrix_x4(ws + swz(tap * K::BN + b_n + 16 * nj, b_half), b0, b1, b2, b3);
#pragma unroll
        for (int mi = 0; mi < K::MI; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], b0, b1);
          mma_s8(acc[mi][2 * nj + 1], af[mi], b2, b3);
        }
      }
    }
#endif
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  // The epilogue: dequantize into shared memory, [BN][BM] with a 16-byte
  // pad a channel, then write each row of TW pixels with 16-byte stores.
  // Accumulator r of an m16n8 tile: pixel g + 8 (r / 2), channel 2 t + r % 2.
  constexpr int ROW = K::BM * (int)sizeof(Tout) + 16;
  static_assert(K::BN * ROW <= K::SMEM, "the output tile fits the stages");
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < K::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < K::NI; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = wm * K::WM + mi * 16 + g + 8 * (r >> 1);
        const int ol = wn * K::WN + ni * 8 + 2 * t4 + (r & 1);
        const int o = o0 + ol;
        float v = 0.f;
        if (o < O) v = __fadd_rn(__fmul_rn((float)acc[mi][ni][r], sw[o]), bias[o]);
        *reinterpret_cast<Tout*>(smem + ol * ROW + m * (int)sizeof(Tout)) = from_f<Tout>(v);
      }
    }
  }
  __syncthreads();
  constexpr int VEC = 16 / (int)sizeof(Tout);  // outputs a 16-byte store
  constexpr int PARTS = K::TW / VEC;
  static_assert(K::TW % VEC == 0, "whole vectors a row of the window");
  const bool aligned = W % VEC == 0;  // then every row of the window starts 16-byte aligned
  for (int e = tid; e < K::BN * K::TH * PARTS; e += K::kThreads) {
    const int part = e % PARTS, r = (e / PARTS) % K::TH, ol = e / (PARTS * K::TH);
    const int o = o0 + ol, hh = h0 + r, ww = w0 + part * VEC;
    if (o >= O || hh >= H || ww >= W) continue;
    const unsigned char* src = smem + ol * ROW + (r * K::TW + part * VEC) * (int)sizeof(Tout);
    Tout* dst = out + (b * O + o) * HW + (long long)hh * W + ww;
    if (aligned) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < VEC && ww + k < W; ++k) dst[k] = reinterpret_cast<const Tout*>(src)[k];
    }
  }
}

template <class K, typename T, typename Tout>
cudaError_t launch_tile(const void* x, const float* a, const float* off, const float* iu,
                        const int8_t* qw, const float* sw, const float* bias, void* out, int B,
                        int C, int H, int W, int O, int act, cudaStream_t st) {
  auto kernel = qconv_mma_kernel<K, T, Tout>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + K::TW - 1) / K::TW;
  const dim3 grid((unsigned)(((H + K::TH - 1) / K::TH) * tiles_w),
                  (unsigned)((O + K::BN - 1) / K::BN), (unsigned)B);
  kernel<<<grid, K::kThreads, K::SMEM, st>>>((const T*)x, a, off, iu, qw, sw, bias, (Tout*)out,
                                             C, H, W, O, tiles_w, act);
  return cudaGetLastError();
}

template <class K, typename T>
cudaError_t launch_out(int out_dtype, const void* x, const float* a, const float* off,
                       const float* iu, const int8_t* qw, const float* sw, const float* bias,
                       void* out, int B, int C, int H, int W, int O, int act, cudaStream_t st) {
  if (out_dtype == 0) {
    return launch_tile<K, T, float>(x, a, off, iu, qw, sw, bias, out, B, C, H, W, O, act, st);
  }
  if (out_dtype == 1) {
    return launch_tile<K, T, __nv_bfloat16>(x, a, off, iu, qw, sw, bias, out, B, C, H, W, O, act,
                                            st);
  }
  return cudaErrorInvalidValue;
}

template <class K>
cudaError_t launch_in(int in_dtype, int out_dtype, const void* x, const float* a,
                      const float* off, const float* iu, const int8_t* qw, const float* sw,
                      const float* bias, void* out, int B, int C, int H, int W, int O, int act,
                      cudaStream_t st) {
  if (in_dtype == 0) {
    return launch_out<K, float>(out_dtype, x, a, off, iu, qw, sw, bias, out, B, C, H, W, O, act,
                                st);
  }
  if (in_dtype == 1) {
    return launch_out<K, __nv_bfloat16>(out_dtype, x, a, off, iu, qw, sw, bias, out, B, C, H, W,
                                        O, act, st);
  }
  return cudaErrorInvalidValue;
}

// Counts the floats d in [1, 2^126) at which rcp_newton(d) is not the IEEE 1 / d.
__global__ void rcp_check_kernel(unsigned long long* bad) {
  const unsigned lo = 0x3f800000u, n = 0x7e800000u - 0x3f800000u;  // [1, 2^126)
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(lo + i);
    if (__float_as_uint(rcp_newton(d)) != __float_as_uint(1.f / d)) atomicAdd(bad, 1ull);
  }
}

}  // namespace

// bad: one uint64 on the device, zero on entry; receives the count of
// mismatches of the producer's reciprocal. Returns the CUDA error of the launch.
extern "C" int qconv_rcp_check(void* bad, void* stream) {
  rcp_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>((unsigned long long*)bad);
  return (int)cudaGetLastError();
}

// dtype codes: 0 float32, 1 bfloat16. x [B, C, H, W]; a, off [B, C] fp32;
// iu [C] fp32 (1 / u); qw int8 [ceil(C / 32), 9, O, 32] (per 32-channel
// chunk and tap, the chunk's channels of each output channel, zeros past C);
// sw, bias [O] fp32; out [B, O, H, W]. C is a multiple of 4. tile: 0 the
// wide tile (8 x 16 pixels x 128 channels), 1 the narrow one (8 x 8 x 64),
// 2 the wide window with 256 channels.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int qconv3x3_fused(const void* x, int in_dtype, const void* a, const void* off,
                              const void* iu, const void* qw, const void* sw, const void* bias,
                              void* out, int out_dtype, int B, int C, int H, int W, int O, int act,
                              int tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 4 != 0) return (int)cudaErrorInvalidValue;
  const float* af = (const float*)a;
  const float* of = (const float*)off;
  const float* iuf = (const float*)iu;
  const int8_t* qwi = (const int8_t*)qw;
  const float* swf = (const float*)sw;
  const float* bf = (const float*)bias;
  if (tile == 0) {
    return (int)launch_in<WideTile>(in_dtype, out_dtype, x, af, of, iuf, qwi, swf, bf, out, B, C,
                                    H, W, O, act, st);
  }
  if (tile == 1) {
    return (int)launch_in<NarrowTile>(in_dtype, out_dtype, x, af, of, iuf, qwi, swf, bf, out, B,
                                      C, H, W, O, act, st);
  }
  if (tile == 2) {
    return (int)launch_in<Wide256Tile>(in_dtype, out_dtype, x, af, of, iuf, qwi, swf, bf, out, B,
                                       C, H, W, O, act, st);
  }
  return (int)cudaErrorInvalidValue;
}
