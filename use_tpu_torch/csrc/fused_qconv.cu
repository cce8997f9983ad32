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
// Besides, every staged value of x goes through the affine, an exp, a
// reciprocal and the quantize on the CUDA cores: two quarter-rate (MUFU)
// instructions and some twenty others a value, about as many instruction slots a
// chunk as the tensor cores take cycles for its products.
//
// Design: an implicit GEMM on the tensor cores, M = the tile's output pixels,
// N = output channels, K = 9 taps x C, as wgmma.m64nNk32.s32.s8.s8 with A and
// B in shared memory and int32 sums (exact in any order, so bit-equal to the
// plain version whatever the order of the chunks). A block is persistent: it
// walks work units blockIdx.x, + gridDim.x, ...; a unit is a tile (one
// sample, TH x TW pixels, BN output channels) and a range of its input
// channels in chunks of 32 (the k of one wgmma). Three warpgroups, each on
// its own ring of stages behind mbarriers, with setmaxnreg moving registers
// from the producer (40) and the transform (104) to the consumers (184):
// - The producer: one warp keeps the raw ring full, the raw window of x for
//   a chunk (32 channel planes of TH + 2 rows with the halo) by one TMA load
//   of a 3-D box over x as [W, H, B * C]. TMA takes a box only from a
//   16-byte boundary of a row, so the box starts 16 bytes left of the
//   window (TW + 32 bytes wide); it fills what lies outside the image with
//   zeros. Another warp keeps the weight ring full: a chunk's weights are
//   2 x 9 runs of BN x 16 bytes, 18 bulk copies. Where W * sizeof(x) is not
//   a multiple of 16 (bf16 at W 12, 6, 3), TMA cannot describe x, and the
//   transform reads x itself.
// - The transform warpgroup turns a raw window into the int8 operand of a
//   chunk, up to four stages ahead of the products: 16 channels of a staged
//   pixel a thread, rounded as the plain version (quantize below), with
//   quantized zeros outside the image: TMA's zeros are zeros of x, and
//   act(0 * a + off) is not 0. The operand is pixel-major in two planes, one
//   a 16-byte half of the 32 channels, so that an 8-pixel core matrix is 128
//   contiguous bytes and the tap (dy, dx) is the same descriptor with its
//   start moved by dy * (TW + 2) + dx pixels (no swizzle, no copies).
// - Two consumer warpgroups run the products: chunk kc's wgmmas are in
//   flight while they wait for chunk kc + 1's stages; a unit's first wgmma
//   overwrites the sums (scale-d 0), so no other instruction writes them
//   while products are in flight. The operand is made once for all BN
//   output channels of a tile: at O 256 the two warpgroups share one 8-row
//   window and take 128 channels each.
// - Split K: where the tiles are fewer than half the SMs (the U-Net's lowest
//   levels, a model rank's narrow slice), each tile's chunks are split over
//   several units. Each adds its int32 sums into a workspace with atomics
//   (exact, so still bit-equal), counts itself in on the tile's counter, and
//   the last one reads the whole sums back, puts zeros in their place, and
//   runs the epilogue. The workspace is all zeros again after every launch.
// - The epilogue dequantizes as the plain version rounds it, acc * sw[o],
//   then + bias[o], in fp32 (__fmul_rn / __fadd_rn), then one conversion to
//   the output type; it stages 8 output rows of a warpgroup through shared
//   memory and writes them to NCHW with 16-byte stores.
// Tiles (ops/fused_qconv.py TILES, picked by pick_tile): 16 x 16 pixels x 128
// channels, 8 x 16 x 256, 16 x 16 x 64 (a model rank's O 64) and 8 x 8 x 256
// (small images, split K).
// Measurement builds (use_tpu_torch/tools/qconv_ablation.py) leave out one
// part with -DQC_NO_X_LOAD (the raw windows are not loaded), -DQC_NO_TRANSFORM
// (the operand is not computed), -DQC_NO_MMA (no products), -DQC_NO_WEIGHT_LOAD
// (the weights are not loaded) or -DQC_NO_STORE (no output written); the
// library is built without them.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 32;                          // input channels a chunk: the k of one wgmma
constexpr int kConsumers = 2;                   // consumer warpgroups: warps 0-7
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kTransformWarp = 4 * kConsumers;  // the transform warpgroup: warps 8-11
constexpr int kTransformThreads = 128;
constexpr int kProducerWarp = kTransformWarp + 4;  // the producer warpgroup: warps 12-15
constexpr int kThreads = kConsumerThreads + kTransformThreads + 128;
constexpr int W_STAGES = 2;                     // the weight ring
constexpr int SMEM_LIMIT = 232448;              // a block's shared memory on the H100

constexpr int round128(int v) { return (v + 127) / 128 * 128; }

// WGM bands of 8 output rows (one a warpgroup where 2), MT m64 tiles of 8
// pixels a row, NW output channels a warpgroup's wgmma.
template <int WGM_, int MT_, int NW_>
struct Tile {
  static constexpr int WGM = WGM_, WGN = kConsumers / WGM_, MT = MT_, NW = NW_;
  static constexpr int TH = 8 * WGM, TW = 8 * MT, BN = NW * WGN;
  static constexpr int HR = TH + 2, HC = TW + 2, NPIX = HR * HC;  // staged, halo included
  static constexpr int A_HALF = round128(NPIX * 16);  // one 16-byte half of each pixel
  static constexpr int A_STAGE = 2 * A_HALF;
  static constexpr int B_HALF = 9 * BN * 16;  // one 16-byte half of each weight row
  static constexpr int W_STAGE = 2 * B_HALF;
  static constexpr int NACC = MT * NW / 2;  // accumulators a consumer thread
  static_assert(WGM * WGN == kConsumers && (NW == 64 || NW == 128), "a wgmma shape");
};
using WideTile = Tile<2, 2, 128>;    // 16 x 16 x 128
using Wide256Tile = Tile<1, 2, 128>; // 8 x 16 x 256
using Wide64Tile = Tile<2, 2, 64>;   // 16 x 16 x 64
using NarrowTile = Tile<1, 1, 128>;  // 8 x 8 x 256

// The shared memory of a tile for input T and output Tout: the operand ring
// (4 stages where they fit, else 3), the weight ring, the raw ring (3 stages
// where they fit beside a 32-channel epilogue, else 2: a narrower epilogue's
// extra barriers cost more than the third stage gains), the epilogue's
// staging (EPI_CH output channels of each consumer warpgroup's 8 rows, as
// many as fit) and the barriers.
template <class K, typename T, typename Tout>
struct Layout {
  static constexpr int VEC_IN = 16 / (int)sizeof(T);                 // inputs in 16 bytes
  static constexpr int CS = 8 * K::TW + (sizeof(Tout) == 4 ? 4 : 8);  // elements a staged channel
  static constexpr int BARS = 8 * 2 * (3 + 4 + W_STAGES) + 16;
  static constexpr int raw_bytes(int boxw) { return round128(CK * K::HR * boxw * (int)sizeof(T)); }
  static constexpr int need(int as, int raw, int rs, int ch) {
    return 128 + as * K::A_STAGE + W_STAGES * K::W_STAGE + rs * raw +
           kConsumers * ch * CS * (int)sizeof(Tout) + BARS;
  }
  // TMA's box starts on a 16-byte boundary of its row (TMA takes no other
  // start): at column w0 - VEC_IN, TW + 2 VEC_IN columns wide. Where that
  // ring does not fit (fp32 at 256 channels), the transform reads x directly.
  static constexpr int BOXW = K::TW + 2 * VEC_IN;
  static constexpr int XOFF = VEC_IN;  // the raw column of image column w0
  static constexpr bool TMA = need(3, raw_bytes(BOXW), 2, 8) <= SMEM_LIMIT;
  static constexpr unsigned RAW_TX = CK * K::HR * BOXW * sizeof(T);
  static constexpr int RAW = TMA ? raw_bytes(BOXW) : 0;
  static constexpr int AS = need(4, RAW, 2, 8) <= SMEM_LIMIT ? 4 : 3;
  static constexpr int RS = need(AS, RAW, 3, 32) <= SMEM_LIMIT ? 3 : 2;
  static constexpr int EPI_CH = need(AS, RAW, RS, 32) <= SMEM_LIMIT ? 32
                                : need(AS, RAW, RS, 16) <= SMEM_LIMIT ? 16 : 8;
  static constexpr int SMEM = need(AS, RAW, RS, EPI_CH);
  static constexpr int W_OFF = AS * K::A_STAGE;
  static constexpr int RAW_OFF = W_OFF + W_STAGES * K::W_STAGE;
  static constexpr int EPI_OFF = RAW_OFF + RS * RAW;
  static constexpr int BAR_OFF = EPI_OFF + kConsumers * EPI_CH * CS * (int)sizeof(Tout);
  static_assert(SMEM <= SMEM_LIMIT, "fits the H100's shared memory");
  static_assert(BAR_OFF % 16 == 0 && CS * sizeof(Tout) % 16 == 0, "aligned");
  static_assert(K::NW % EPI_CH == 0, "whole pieces");
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x as a float: fp32 as it is; a bf16 is the high half of the float it widens to, exactly.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __uint_as_float((unsigned)__bfloat16_as_ushort(v) << 16);
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

// 1 / d for d in [2^126, inf] and NaN, where the quotient is subnormal, 0
// or NaN: the approximate double reciprocal and two Newton steps in double
// come within 2^-50 of 1 / d, and a float quotient there is at least 2^-25
// of its subnormal quantum from a rounding tie, so the conversion to float
// rounds to the IEEE quotient (checked exhaustively on the card by
// qconv_rcp_check below). A float division would compile to a call, and a
// kernel that calls cannot move registers between warpgroups (setmaxnreg).
__device__ __forceinline__ float rcp_tiny(float d) {
  if (d == INFINITY) return 0.f;
  const double dd = (double)d;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(dd));
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  return (float)r;
}

// The operand for N consecutive channels of one pixel (N a multiple of 4;
// a, off, iu 16-byte aligned at the first channel), rounded step by step as
// the plain version: __fmul_rn / __fadd_rn (no FMA contraction), the sigmoid
// as 1 / (1 + exp(-y)), rintf (half to even). The reciprocals take
// rcp_newton unless some 1 + exp(-y) is 2^126 or more (or NaN): then
// rcp_tiny; both give the IEEE quotient, so the result is the plain
// version's for every input, and the common case has no branch between the
// N channels.
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
      for (int i = 0; i < N; ++i) {
        y[i] = __fmul_rn(y[i], d[i] < 0x1p126f ? rcp_newton(d[i]) : rcp_tiny(d[i]));
      }
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
      // clip(rint(t)) as the clip first, then rint by adding 1.5 * 2^23 (round
      // to nearest even, the integer in the low bits): the same integer for
      // every float t, a NaN's -127 included, with no conversion instruction
      const float c = fminf(fmaxf(__fmul_rn(y[4 * j + k], u[k]), -127.f), 127.f);
      q[4 * j + k] = __float_as_int(__fadd_rn(c, 0x1.8p23f)) - 0x4B400000;
    }
  }
}

__device__ __forceinline__ unsigned pack4(const int* q) {
  return (unsigned)(q[0] & 0xff) | (unsigned)(q[1] & 0xff) << 8 |
         (unsigned)(q[2] & 0xff) << 16 | (unsigned)(q[3] & 0xff) << 24;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A 3-D box of `map` at coordinates (c0, c1, c2) into shared memory at dst;
// the bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 256 consumer threads meet (named barrier 1); the 128 threads of
// consumer warpgroup wg meet (named barrier 2 + wg).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor without swizzle (K-major, core matrices
// of 8 rows x 16 bytes, each 128 contiguous bytes): start address, the
// leading offset (from one 16-byte half of K to the other) and the stride
// offset (from one 8-row core matrix to the next), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lead, unsigned stride) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (uint64_t)(lead >> 4) << 16 |
         (uint64_t)(stride >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products that own them.
template <int N> __device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(i)                                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),       \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x N s32, this thread's N / 2) = A (64 x 32 s8) * B (32 x N s8) + (add ? d : 0),
// A and B from shared memory.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(add));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(add));
}
#undef ACC8

// A work unit: tile t of the grid of tiles (output channels fastest, then
// columns, rows, samples), and the chunks [k0, k1) of its split.
struct Unit {
  int b, h0, w0, o0, tile, k0, k1;
};

struct Geometry {
  int tiles_h, tiles_w, tiles_o, tiles, splits, nk, units;
};

template <class K>
__device__ __forceinline__ Unit unit_of(int u, const Geometry& g) {
  Unit U;
  U.tile = u / g.splits;
  const int s = u - U.tile * g.splits;
  U.k0 = s * g.nk / g.splits;
  U.k1 = (s + 1) * g.nk / g.splits;
  int t = U.tile;
  U.o0 = (t % g.tiles_o) * K::BN;
  t /= g.tiles_o;
  U.w0 = (t % g.tiles_w) * K::TW;
  t /= g.tiles_w;
  U.h0 = (t % g.tiles_h) * K::TH;
  U.b = t / g.tiles_h;
  return U;
}

// Quantizes the window of chunk kc of unit U into an operand stage: an item
// is the 16 channels of one half of one staged pixel, read channel by
// channel and written as 16 bytes; quantized zeros outside the image and
// past C. The window comes from the raw ring (TMA) or, DIRECT, from x itself.
template <class K, class L, bool DIRECT, typename T>
__device__ __forceinline__ void transform(const T* __restrict__ raw, const T* __restrict__ x,
                                          unsigned char* dst, int ttid, const Unit& U, int kc,
                                          int H, int W, int C, const float* __restrict__ a,
                                          const float* __restrict__ off,
                                          const float* __restrict__ iu, int act) {
  constexpr int ITEMS = (2 * K::NPIX + kTransformThreads - 1) / kTransformThreads;
  const long long HW = (long long)H * W;
  const long long stride = DIRECT ? HW : K::HR * L::BOXW;  // from one channel to the next
  const float* ab = a + (long long)U.b * C;
  const float* offb = off + (long long)U.b * C;
#pragma unroll 2
  for (int it = 0; it < ITEMS; ++it) {
    const int e = ttid + it * kTransformThreads;
    if (e >= 2 * K::NPIX) break;
    const int half = e >= K::NPIX ? 1 : 0;
    const int p = e - half * K::NPIX;
    const int r = p / K::HC, col = p - r * K::HC;
    const int hh = U.h0 - 1 + r, ww = U.w0 - 1 + col;
    unsigned v[4] = {0u, 0u, 0u, 0u};
#ifndef QC_NO_TRANSFORM
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
      const int c0 = kc * CK + 16 * half;
      const T* src = DIRECT ? x + ((long long)U.b * C + c0) * HW + (long long)hh * W + ww
                            : raw + (16 * half * K::HR + r) * L::BOXW + col + L::XOFF - 1;
      if (c0 + 16 <= C) {  // 16 channels in one pass: 16 independent chains
        float xv[16];
        int q[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) xv[i] = to_f(src[i * stride]);
        quantize<16>(xv, ab + c0, offb + c0, iu + c0, act, q);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = pack4(q + 4 * k);
      } else {
#pragma unroll
        for (int g = 0; g < 2; ++g) {  // 8 channels at a time; C % 4 == 0
          const int cc = c0 + 8 * g;
          if (cc < C) {
            float xv[8];
            int q[8];
            if (cc + 8 <= C) {
#pragma unroll
              for (int i = 0; i < 8; ++i) xv[i] = to_f(src[(8 * g + i) * stride]);
              quantize<8>(xv, ab + cc, offb + cc, iu + cc, act, q);
            } else {  // a ragged last chunk: four channels
              float x4[4];
              int q4[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) x4[i] = to_f(src[(8 * g + i) * stride]);
              quantize<4>(x4, ab + cc, offb + cc, iu + cc, act, q4);
#pragma unroll
              for (int i = 0; i < 8; ++i) q[i] = i < 4 ? q4[i] : 0;
            }
            v[2 * g] = pack4(q);
            v[2 * g + 1] = pack4(q + 4);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + half * K::A_HALF + p * 16) = make_uint4(v[0], v[1], v[2], v[3]);
#endif
  }
}

// grid min(units, SMs), kThreads threads, Layout<K, T, Tout>::SMEM bytes of
// dynamic shared memory. xmap: x as [W, H, B * C] in boxes of
// (BOXW, TH + 2, 32) elements, where use_tma; x itself otherwise. qw: the
// prepared weights [ceil(C/32), 2, 9, O, 16]. ws: where splits > 1, int32
// sums of every tile in the accumulators' order, then a counter a tile, all
// zeros.
template <class K, typename T, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
qconv_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x, int use_tma,
             const float* __restrict__ a, const float* __restrict__ off,
             const float* __restrict__ iu, const int8_t* __restrict__ qw,
             const float* __restrict__ sw, const float* __restrict__ bias,
             Tout* __restrict__ out, int* __restrict__ ws, int C, int H, int W, int O, int act,
             Geometry g) {
  using L = Layout<K, T, Tout>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  unsigned char* wring = smem + L::W_OFF;
  unsigned char* rawring = smem + L::RAW_OFF;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* raw_empty = raw_full + 3;
  uint64_t* op_full = raw_empty + 3;
  uint64_t* op_empty = op_full + 4;
  uint64_t* w_full = op_empty + 4;
  uint64_t* w_empty = w_full + W_STAGES;
  int* last_flag = reinterpret_cast<int*>(w_empty + W_STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::RS; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], kTransformThreads / 32);  // one arrival a transform warp
    }
#pragma unroll
    for (int s = 0; s < L::AS; ++s) {
      mbar_init(&op_full[s], kTransformThreads / 32);
      mbar_init(&op_empty[s], 4 * kConsumers);  // one arrival a consumer warp
    }
#pragma unroll
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    // registers (128 a thread at launch) go from the producer (40) and the
    // transform (104) to the consumers (184)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // one warp keeps the raw ring full (where TMA reads x), another the
    // weight ring, each on its own: neither waits behind the other's ring
    if (lane != 0 || warp > kProducerWarp + 1 || (warp == kProducerWarp && !use_tma)) return;
    int j = 0;  // the block's chunk count: the stage and phase of the rings
    for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
      const Unit U = unit_of<K>(u, g);
      for (int kc = U.k0; kc < U.k1; ++kc, ++j) {
        if (warp == kProducerWarp) {
          const int rs = j % L::RS;
          mbar_wait(&raw_empty[rs], ((j / L::RS) & 1) ^ 1);
#ifndef QC_NO_X_LOAD
          mbar_expect_tx(&raw_full[rs], L::RAW_TX);
          tma_load_3d(rawring + rs * L::RAW, &xmap, &raw_full[rs], U.w0 - L::XOFF, U.h0 - 1,
                      U.b * C + kc * CK);
#else
          mbar_arrive(&raw_full[rs]);
#endif
        } else {
          const int wsg = j % W_STAGES;
          mbar_wait(&w_empty[wsg], ((j / W_STAGES) & 1) ^ 1);
          const int rows = min(K::BN, O - U.o0);
#ifndef QC_NO_WEIGHT_LOAD
          mbar_expect_tx(&w_full[wsg], 2u * 9u * (unsigned)rows * 16u);
          unsigned char* wdst = wring + wsg * K::W_STAGE;
          const int8_t* wsrc = qw + ((long long)kc * 18 * O + U.o0) * 16;
#pragma unroll 1
          for (int run = 0; run < 18; ++run) {  // (half, tap)
            bulk_load(wdst + run * K::BN * 16, wsrc + (long long)run * O * 16, rows * 16u,
                      &w_full[wsg]);
          }
#else
          mbar_arrive(&w_full[wsg]);
#endif
        }
      }
    }
  } else if (warp >= kTransformWarp) {
    // The transform: each chunk's window into an operand stage, as soon as
    // the stage is free, running ahead of the products by up to AS stages.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    const int ttid = threadIdx.x - 32 * kTransformWarp;
    int j = 0;
    for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
      const Unit U = unit_of<K>(u, g);
      for (int kc = U.k0; kc < U.k1; ++kc, ++j) {
        const int as = j % L::AS, rs = j % L::RS;
        unsigned char* dst = smem + as * K::A_STAGE;
        mbar_wait(&op_empty[as], ((j / L::AS) & 1) ^ 1);
        if (use_tma) {
          mbar_wait(&raw_full[rs], (j / L::RS) & 1);
          transform<K, L, false, T>(reinterpret_cast<const T*>(rawring + rs * L::RAW), x, dst,
                                    ttid, U, kc, H, W, C, a, off, iu, act);
        } else {
          transform<K, L, true, T>(nullptr, x, dst, ttid, U, kc, H, W, C, a, off, iu, act);
        }
        fence_proxy_async();  // the operand's generic writes, before wgmma reads them
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&op_full[as]);
          if (use_tma) mbar_arrive(&raw_empty[rs]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::: "memory");
    // The consumers. Accumulator register 4 j + r of an m64nN product: row
    // 16 wi + lane / 4 + 8 (r / 2), column 8 j + 2 (lane % 4) + r % 2; row m
    // of m64 tile mt is output row m / 8 of the warpgroup's band, pixel
    // 8 mt + m % 8 of it.
    const int wg = warp >> 2, wi = warp & 3, ctid = threadIdx.x, tid = threadIdx.x & 127;
    const int wm = K::WGM == 2 ? wg : 0, wn = K::WGM == 2 ? 0 : wg;
    const unsigned abase = smem_u32(smem), wbase = smem_u32(wring);
    Tout* stage_out = reinterpret_cast<Tout*>(smem + L::EPI_OFF) + wg * L::EPI_CH * L::CS;
    const long long HW = (long long)H * W;
    int acc[K::MT][K::NW / 2];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int i = 0; i < K::NW / 2; ++i) acc[mt][i] = 0;
    int j = 0;  // the block's chunk count: the stage and phase of the rings
    for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
      const Unit U = unit_of<K>(u, g);
      // A unit's chunks: the products of chunk kc run while the consumers
      // wait for chunk kc + 1's stages; the first tap of the first chunk
      // overwrites the sums (the wgmma's scale-d), so no instruction but a
      // wgmma writes them until the unit's last products are done.
      for (int kc = U.k0; kc < U.k1; ++kc, ++j) {
        const int as = j % L::AS, wsg = j % W_STAGES;
        mbar_wait(&op_full[as], (j / L::AS) & 1);
        mbar_wait(&w_full[wsg], (j / W_STAGES) & 1);
        __syncwarp();  // the warpgroup's wgmma instructions run converged
#ifndef QC_NO_MMA
        // descriptors of tap (0, 0); a tap moves the start (16-byte units,
        // the low field) by whole pixels of A and whole tap blocks of B
        const uint64_t da0 = smem_desc(abase + as * K::A_STAGE + 16 * (8 * wm * K::HC),
                                       K::A_HALF, 16 * K::HC);
        const uint64_t db0 = smem_desc(wbase + wsg * K::W_STAGE + wn * K::NW * 16, K::B_HALF,
                                       8 * 16);
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt) fence_regs(acc[mt]);
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap - 3 * dy;
          const uint64_t db = db0 + (uint64_t)(tap * K::BN);
          const uint64_t da = da0 + (uint64_t)(dy * K::HC + dx);
          const int add = kc != U.k0 || tap != 0;
#pragma unroll
          for (int mt = 0; mt < K::MT; ++mt) wgmma_s8(acc[mt], da + 8 * mt, db, add);
        }
        wgmma_commit();
        wgmma_wait<1>();  // chunk kc - 1's products are done
#endif
        if (kc > U.k0 && lane == 0) {
          mbar_arrive(&op_empty[(j - 1) % L::AS]);
          mbar_arrive(&w_empty[(j - 1) % W_STAGES]);
        }
      }
      __syncwarp();
#ifndef QC_NO_MMA
      wgmma_wait<0>();  // the unit's sums are whole
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt) fence_regs(acc[mt]);
#else
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
        for (int i = 0; i < K::NW / 2; ++i) acc[mt][i] = 0;
#endif
      if (lane == 0) {
        mbar_arrive(&op_empty[(j - 1) % L::AS]);
        mbar_arrive(&w_empty[(j - 1) % W_STAGES]);
      }
      const int hb = U.h0 + 8 * wm;         // the band's first row
      const int ob = U.o0 + wn * K::NW;     // the warpgroup's first channel
      bool finish = true;
      if (g.splits > 1) {
        // add this split's sums into the tile's, in the accumulators' order
        int* wt = ws + (long long)U.tile * (kConsumerThreads * K::NACC);
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt) {
          const int ww = U.w0 + 8 * mt + (lane >> 2);
#pragma unroll
          for (int i = 0; i < K::NW / 2; ++i) {
            const int hh = hb + 2 * wi + ((i >> 1) & 1);
            const int o = ob + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            if (hh < H && ww < W && o < O) {
              atomicAdd(wt + (mt * (K::NW / 2) + i) * kConsumerThreads + ctid, acc[mt][i]);
            }
          }
        }
        __threadfence();
        consumers_sync();
        int* counter = ws + (long long)g.tiles * (kConsumerThreads * K::NACC) + U.tile;
        if (ctid == 0) *last_flag = atomicAdd(counter, 1) == g.splits - 1;
        consumers_sync();
        finish = *last_flag != 0;
        if (finish) {  // the last split: the whole sums, and zeros in their place
          __threadfence();
#pragma unroll
          for (int mt = 0; mt < K::MT; ++mt) {
#pragma unroll
            for (int i = 0; i < K::NW / 2; ++i) {
              int* p = wt + (mt * (K::NW / 2) + i) * kConsumerThreads + ctid;
              acc[mt][i] = __ldcg(p);
              __stcg(p, 0);
            }
          }
          if (ctid == 0) *counter = 0;
        }
      }
      if (finish) {
        // The epilogue, EPI_CH channels at a time: dequantize and round as
        // the plain version into the staging buffer, then write rows of the
        // band with 16-byte stores.
        constexpr int VEC = 16 / (int)sizeof(Tout);  // outputs a 16-byte store
        constexpr int PARTS = K::TW / VEC;
        const bool aligned = (long long)W * sizeof(Tout) % 16 == 0;
#pragma unroll
        for (int piece = 0; piece < K::NW / L::EPI_CH; ++piece) {
#pragma unroll
          for (int jj = 0; jj < L::EPI_CH / 8; ++jj) {
            const int j8 = piece * (L::EPI_CH / 8) + jj;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 8 * jj + 2 * (lane & 3) + e;  // channel of the piece
              const int o = ob + 8 * j8 + 2 * (lane & 3) + e;
              const float s = o < O ? sw[o] : 0.f;
              const float bo = o < O && bias != nullptr ? bias[o] : 0.f;
#pragma unroll
              for (int mt = 0; mt < K::MT; ++mt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  float v = __fmul_rn((float)acc[mt][4 * j8 + 2 * half + e], s);
                  if (bias != nullptr) v = __fadd_rn(v, bo);
                  stage_out[cl * L::CS + (2 * wi + half) * K::TW + 8 * mt + (lane >> 2)] =
                      from_f<Tout>(v);
                }
              }
            }
          }
          warpgroup_sync(wg);
#ifndef QC_NO_STORE
          for (int i = tid; i < L::EPI_CH * 8 * PARTS; i += 128) {
            const int part = i % PARTS, r = (i / PARTS) % 8, cl = i / (PARTS * 8);
            const int o = ob + piece * L::EPI_CH + cl, hh = hb + r, ww = U.w0 + part * VEC;
            if (o >= O || hh >= H || ww >= W) continue;
            const Tout* src = stage_out + cl * L::CS + r * K::TW + part * VEC;
            Tout* dst = out + ((long long)U.b * O + o) * HW + (long long)hh * W + ww;
            if (aligned && ww + VEC <= W) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
              for (int k = 0; k < VEC && ww + k < W; ++k) dst[k] = src[k];
            }
          }
#endif
          warpgroup_sync(wg);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = (EncodeTiled)p;
  }
  return fn;
}

// x [B, C, H, W] as [W, H, B * C], read in boxes of (boxw, hr, 32) elements;
// zeros outside.
template <typename T>
bool encode_x(CUtensorMap* map, const void* ptr, int B, int C, int H, int W, int boxw, int hr) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B * C};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T), (cuuint64_t)W * H * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)boxw, (cuuint32_t)hr, (cuuint32_t)CK};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of the last few x buffers: a map depends only on the
// address, the shape, the box and the type, and its encoding costs the host
// more than the rest of a launch.
template <typename T>
bool cached_x_map(CUtensorMap* map, const void* ptr, int B, int C, int H, int W, int boxw,
                  int hr) {
  struct Entry {
    const void* ptr;
    int B, C, H, W, boxw, hr;
    CUtensorMap map;
  };
  static Entry cache[8] = {};
  static int next = 0;
  for (const Entry& e : cache) {
    if (e.ptr == ptr && e.B == B && e.C == C && e.H == H && e.W == W && e.boxw == boxw &&
        e.hr == hr) {
      *map = e.map;
      return true;
    }
  }
  if (!encode_x<T>(map, ptr, B, C, H, W, boxw, hr)) return false;
  cache[next] = Entry{ptr, B, C, H, W, boxw, hr, *map};
  next = (next + 1) % 8;
  return true;
}

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < 64 ? dev : 0;
}

int sm_count() {
  static int count[64] = {0};
  const int dev = current_device();
  if (count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 132;
  }
  return count[dev];
}

struct Args {
  const void* x;
  const float *a, *off, *iu, *sw, *bias;
  const int8_t* qw;
  void* out;
  int* ws;
  int B, C, H, W, O, act, splits;
};

template <class K, typename T, typename Tout>
cudaError_t launch(const Args& p, cudaStream_t st) {
  using L = Layout<K, T, Tout>;
  auto kernel = qconv_kernel<K, T, Tout>;
  static bool attr[64] = {false};  // the shared-memory size, set once a device
  const int dev = current_device();
  if (!attr[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    attr[dev] = true;
  }
  CUtensorMap xmap = {};
  const int use_tma = L::TMA && (long long)p.W * sizeof(T) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  if (use_tma && !cached_x_map<T>(&xmap, p.x, p.B, p.C, p.H, p.W, L::BOXW, K::HR)) {
    return cudaErrorInvalidValue;
  }
  Geometry g;
  g.tiles_h = (p.H + K::TH - 1) / K::TH;
  g.tiles_w = (p.W + K::TW - 1) / K::TW;
  g.tiles_o = (p.O + K::BN - 1) / K::BN;
  g.nk = (p.C + CK - 1) / CK;
  g.splits = p.splits < 1 ? 1 : p.splits > g.nk ? g.nk : p.splits;
  if (g.splits > 1 && p.ws == nullptr) return cudaErrorInvalidValue;
  const long long tiles = (long long)p.B * g.tiles_h * g.tiles_w * g.tiles_o;
  if (tiles * g.splits > 0x7fffffff) return cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  g.units = g.tiles * g.splits;
  if (g.units == 0) return cudaSuccess;
  const int grid = g.units < sm_count() ? g.units : sm_count();
  kernel<<<grid, kThreads, L::SMEM, st>>>(xmap, (const T*)p.x, use_tma, p.a, p.off, p.iu, p.qw,
                                          p.sw, p.bias, (Tout*)p.out, p.ws, p.C, p.H, p.W, p.O,
                                          p.act, g);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_types(int in_dtype, int out_dtype, const Args& p, cudaStream_t st) {
  if (in_dtype == 0 && out_dtype == 0) return launch<K, float, float>(p, st);
  if (in_dtype == 0 && out_dtype == 1) return launch<K, float, __nv_bfloat16>(p, st);
  if (in_dtype == 1 && out_dtype == 0) return launch<K, __nv_bfloat16, float>(p, st);
  if (in_dtype == 1 && out_dtype == 1) return launch<K, __nv_bfloat16, __nv_bfloat16>(p, st);
  return cudaErrorInvalidValue;
}

// Counts the floats d in [1, inf] and the NaNs at which the transform's
// reciprocal (rcp_newton below 2^126, rcp_tiny from there) is not the IEEE
// 1 / d (for a NaN: is not a NaN).
__global__ void rcp_check_kernel(unsigned long long* bad) {
  const unsigned lo = 0x3f800000u, n = 0x80000000u - 0x3f800000u;  // [1, inf] and the NaNs
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(lo + i);
    const float r = d < 0x1p126f ? rcp_newton(d) : rcp_tiny(d), want = 1.f / d;
    if (d != d ? r == r : __float_as_uint(r) != __float_as_uint(want)) atomicAdd(bad, 1ull);
  }
}

}  // namespace

// bad: one uint64 on the device, zero on entry; receives the count of
// mismatches of the transform's reciprocal. Returns the CUDA error of the launch.
extern "C" int qconv_rcp_check(void* bad, void* stream) {
  rcp_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>((unsigned long long*)bad);
  return (int)cudaGetLastError();
}

// dtype codes: 0 float32, 1 bfloat16. x [B, C, H, W]; a, off [B, C] fp32,
// 16-byte aligned; iu [C] fp32 (1 / u), 16-byte aligned; qw int8
// [ceil(C / 32), 2, 9, O, 16] (per 32-channel chunk, half of it and tap, the
// 16 channels of each output channel, zeros past C), 16-byte aligned; sw
// [O] fp32; bias [O] fp32 or NULL; out [B, O, H, W]. C is a multiple of 4.
// tile: 0 16 x 16 pixels x 128 channels, 1 8 x 16 x 256, 2 16 x 16 x 64,
// 3 8 x 8 x 256. splits: the parts each tile's chunks are split into (1: no
// split); ws, where splits > 1: int32 zeros, tiles * TH * TW * BN sums and
// tiles counters, left zero. Returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int qconv3x3_fused(const void* x, int in_dtype, const void* a, const void* off,
                              const void* iu, const void* qw, const void* sw, const void* bias,
                              void* out, int out_dtype, int B, int C, int H, int W, int O, int act,
                              int tile, int splits, void* ws, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 4 != 0) return (int)cudaErrorInvalidValue;
  Args p;
  p.x = x;
  p.a = (const float*)a;
  p.off = (const float*)off;
  p.iu = (const float*)iu;
  p.sw = (const float*)sw;
  p.bias = (const float*)bias;
  p.qw = (const int8_t*)qw;
  p.out = out;
  p.ws = (int*)ws;
  p.B = B;
  p.C = C;
  p.H = H;
  p.W = W;
  p.O = O;
  p.act = act;
  p.splits = splits;
  switch (tile) {
    case 0: return (int)launch_types<WideTile>(in_dtype, out_dtype, p, st);
    case 1: return (int)launch_types<Wide256Tile>(in_dtype, out_dtype, p, st);
    case 2: return (int)launch_types<Wide64Tile>(in_dtype, out_dtype, p, st);
    case 3: return (int)launch_types<NarrowTile>(in_dtype, out_dtype, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
