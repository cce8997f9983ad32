// The int8 3x3 SAME conv of quant='int8' serving (qconv3x3_s8), as a TMA +
// wgmma implicit GEMM over a pixel-major int8 operand.
//
// Replaces no Pallas kernel: use_tpu runs this conv as an XLA int8
// convolution (use_tpu/ops/qconv.py::qconv2d_prequant, :79), and torch has
// no int8 convolution on CUDA. It computes, bit-equal to the plain version
// (ops/qconv.py s8_conv_plain; int32 sums are exact in any order),
//
//   out[b, o, h, w] = Tout(Tout(float(acc) * scale[b, o]) + Tout(bias[o]))
//   acc = sum_{c, dy, dx} q[b, c, h+dy-1, w+dx-1] * qw[o, c, dy, dx]  (q 0 outside the image)
//
// with scale[b, o] = sw[o] * post[b] (sw[o] without a post-scale).
//
// The operand is "C32": int8 [B, ceil(C/32), 2, H, W, 16], each 32-channel
// chunk as two 16-channel halves, each half pixel-major (the 16 channels of
// a pixel in 16 contiguous bytes), zeros past C. K1's int8 apply writes it
// (csrc/gn_stats.cu gn_apply_q8). The weights are [ceil(O/128), ceil(C/32),
// 2, 9, 128, 16] (ops/qconv.py prepare_s8_weight): per block of 128 output
// channels and chunk, exactly the stage's shared-memory image, zeros past C
// and O.
//
// Bound on the H100: operations. At B 8, C 128, O 128, 512 x 192 the 2.3e11
// int8 operations take 0.117 ms at the dense int8 tensor-core peak (1,979
// TOP/s); the bytes (operand once, bf16 output once) 0.090 ms.
//
// Design. A block is persistent: it walks output tiles (one sample, TH x TW
// pixels, 128 output channels) blockIdx.x, + gridDim.x, ...; each tile walks
// the input channels in chunks of 32 (the k of one wgmma).
// - One producer thread keeps a ring of STAGES stages full: a chunk's
//   staged window, (TH + 2) x (TW + 2) pixels with the halo, by TMA, and its
//   weights, 9 taps x 128 output channels, by one bulk copy of 36,864 bytes.
//   The window's box starts at (h0 - 1, w0 - 1): TMA fills what lies
//   outside the image with zeros, which is the SAME padding of the quantized
//   operand, with no masks. Each stage has a full and an empty mbarrier;
//   the ring runs on across tiles, so the next tile's chunks load while the
//   consumers write the last one out.
// - Two consumer warpgroups run wgmma.m64n128k32.s32.s8.s8 with A and B read
//   from shared memory. A 64-row A tile is 8 output rows x 8 pixels: its
//   8-row core matrices are 8 consecutive staged pixels of one image row, so
//   the tap (dy, dx) is the same descriptor with its start moved by
//   dy * (TW + 2) + dx pixels, and the stride between core matrices one
//   staged row. The 3 x 3 shifts cost no copies.
// - No swizzle: the two 16-byte halves of the pixels are staged in two
//   regions, so a core matrix of 8 pixels is 128 contiguous bytes, read
//   without bank conflicts, and a tap's start, a whole number of 16-byte
//   pixels, needs no swizzle phase (the descriptor's leading offset steps
//   from one half to the other). A swizzled 32-byte row would make the
//   shifted starts depend on the pattern's phase; this layout has none.
// - Why the halves are planes of their own in device memory, and the
//   weights one copy: TMA moves a box row by row. With a box row of 16
//   bytes (one half of a 32-byte pixel) a chunk took 648 rows of window and
//   2,304 of weights, and the loads, not the products, set the pace (the
//   first version's ablation builds, PERF.md). A half plane makes a staged
//   row of the window one box row of (TW + 2) x 16 bytes (36 rows a chunk),
//   and the prepared weights need no box at all.
// - The consumers release a stage as soon as wgmma.wait_group says its
//   products are done (one chunk's products stay in flight). The epilogue
//   dequantizes from registers into shared memory, 32 output channels at a
//   time for each warpgroup, and writes whole rows of the window to NCHW
//   with 16-byte stores (scattered 2-byte stores straight from the
//   accumulators' layout cost more than the products did).
// Two tiles (ops/qconv.py TILES, picked by pick_tile): 16 x 16 pixels (two
// m64 tiles a warpgroup), for images whose width is a multiple of 16, and
// 16 x 8 (one a warpgroup) for the others (24, 12, 6, 3 wide), where a wide
// window is mostly padding. Both take 128 output channels a tile (O 256 is
// two tiles: the operand is read twice, the weights, the larger stream, once).
// Measurement builds (use_tpu_torch/tools/qconv_ablation.py) leave out one
// part with -DS8_NO_OPERAND_TMA (the window is not loaded), -DS8_NO_MMA (no
// products), -DS8_NO_WEIGHT_LOAD (the weights are not loaded) or
// -DS8_NO_STORE (no output written); the library is built without them.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;         // output channels a tile: the n of one wgmma
constexpr int STAGES = 4;       // the ring of chunks in shared memory
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp

template <int TH_, int TW_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_;
  static constexpr int HR = TH + 2, HC = TW + 2;  // staged rows and columns, halo included
  static constexpr int NPIX = HR * HC;
  static constexpr int MT = TW / 8;  // m64 tiles a warpgroup: its band of 8 rows, 8 pixels a tile
  static constexpr int A_HALF = (NPIX * 16 + 127) / 128 * 128;  // one 16-byte half of each pixel
  static constexpr int B_HALF = 9 * BN * 16;                 // one 16-byte half of each weight row
  static constexpr int STAGE = 2 * A_HALF + 2 * B_HALF;
#ifdef S8_NO_OPERAND_TMA
  static constexpr unsigned A_TX = 0;
#else
  static constexpr unsigned A_TX = 2 * NPIX * 16;
#endif
#ifdef S8_NO_WEIGHT_LOAD
  static constexpr unsigned B_TX = 0;
#else
  static constexpr unsigned B_TX = 2 * B_HALF;
#endif
  static constexpr int RING = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(TH == 8 * kConsumers && TW % 8 == 0, "a band of 8 rows a warpgroup");
  static_assert(STAGE % 128 == 0 && B_HALF % 128 == 0, "TMA destinations 128-byte aligned");
};

// The epilogue's staging of EPI_CH output channels of a warpgroup's band (8
// rows x 8 MT pixels) in Tout, channel after channel; the channel stride is
// padded so that the accumulators' writes (lanes 4 apart hold channels 2
// apart) fall in distinct banks and every row starts 16-byte aligned.
constexpr int EPI_CH = 32;
template <class K, typename Tout> struct Epi {
  static constexpr int PX = 8 * K::MT;                               // pixels a row of the band
  static constexpr int CS = 8 * PX + (sizeof(Tout) == 4 ? 4 : 8);    // elements a channel
  static constexpr int BYTES = kConsumers * EPI_CH * CS * (int)sizeof(Tout);
  static constexpr int SMEM = K::RING + BYTES;
  static_assert(SMEM <= 232448, "fits the H100's shared memory");
  static_assert(CS * sizeof(Tout) % 16 == 0 && PX * sizeof(Tout) % 16 == 0, "aligned rows");
};
using WideTile = Tile<16, 16>;
using NarrowTile = Tile<16, 8>;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened back, exactly.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

// The 128 threads of consumer warpgroup wg meet (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
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

// d (64 x 128 s32, this thread's 64) += A (64 x 32 s8) * B (32 x 128 s8), both
// from shared memory.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef ACC8

struct TileCoord {
  int b, h0, w0, o0;
};

template <class K>
__device__ __forceinline__ TileCoord tile_coord(int t, int tiles_h, int tiles_w, int tiles_o) {
  TileCoord c;
  c.o0 = (t % tiles_o) * BN;
  t /= tiles_o;
  c.w0 = (t % tiles_w) * K::TW;
  t /= tiles_w;
  c.h0 = (t % tiles_h) * K::TH;
  c.b = t / tiles_h;
  return c;
}

// grid min(tiles, SMs), kThreads threads, Epi<K, Tout>::SMEM bytes of
// dynamic shared memory. xmap: the operand's half planes as [2 B nk, H,
// 4 W] of 4-byte elements; qw: the prepared weights.
template <class K, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
qconv_s8_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ qw,
                const float* __restrict__ sw, const float* __restrict__ post, int post_bstride,
                const float* __restrict__ bias, Tout* __restrict__ out, int nk, int H, int W,
                int O, int tiles_h, int tiles_w, int tiles_o, int tiles) {
  using E = Epi<K, Tout>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * K::STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileCoord tc = tile_coord<K>(t, tiles_h, tiles_w, tiles_o);
        const int8_t* wsrc = qw + (long long)(tc.o0 / BN) * nk * (2 * K::B_HALF);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * K::STAGE;
          mbar_expect_tx(&full[stage], K::A_TX + K::B_TX);
#ifndef S8_NO_OPERAND_TMA
          const int plane = 2 * (tc.b * nk + kc);
          tma_load_3d(st, &xmap, &full[stage], 4 * (tc.w0 - 1), tc.h0 - 1, plane);
          tma_load_3d(st + K::A_HALF, &xmap, &full[stage], 4 * (tc.w0 - 1), tc.h0 - 1, plane + 1);
#endif
#ifndef S8_NO_WEIGHT_LOAD
          bulk_load(st + 2 * K::A_HALF, wsrc + (long long)kc * (2 * K::B_HALF), 2 * K::B_HALF,
                    &full[stage]);
#endif
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers. Accumulator register 4 j + r of an m64n128 product: row
  // 16 wi + lane / 4 + 8 (r / 2), column 8 j + 2 (lane % 4) + r % 2; row m of
  // m64 tile mt is output row m / 8 of the warpgroup's band, pixel
  // 8 mt + m % 8 of it.
  const int wg = warp >> 2, wi = warp & 3, tid = threadIdx.x & 127;
  const unsigned base = smem_u32(smem);
  Tout* stage_out = reinterpret_cast<Tout*>(smem + K::RING - 1024) + wg * EPI_CH * E::CS;
  int stage = 0, phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileCoord tc = tile_coord<K>(t, tiles_h, tiles_w, tiles_o);
    int acc[K::MT][64];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mt][i] = 0;
    int prev = -1;
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(&full[stage], phase);
#ifndef S8_NO_MMA
      const unsigned a0 = base + stage * K::STAGE;
      const unsigned b0 = a0 + 2 * K::A_HALF;
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt) fence_regs(acc[mt]);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint64_t db = smem_desc(b0 + tap * BN * 16, K::B_HALF, 8 * 16);
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt) {
          const int pix = (8 * wg + tap / 3) * K::HC + 8 * mt + tap % 3;
          wgmma_s8_n128(acc[mt], smem_desc(a0 + 16 * pix, K::A_HALF, 16 * K::HC), db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt) fence_regs(acc[mt]);
#endif
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
#ifndef S8_NO_MMA
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt) fence_regs(acc[mt]);
#endif
    if (lane == 0) mbar_arrive(&empty[prev]);

    // The epilogue, EPI_CH channels at a time: dequantize and round as
    // use_tpu does (the scaled sum in Tout, then the bias in Tout) into the
    // staging buffer, then write rows of the band with 16-byte stores.
    const float pb = post == nullptr ? 1.f : post[(long long)tc.b * post_bstride];
    const int hb = tc.h0 + 8 * wg;  // the band's first row
    const long long HW = (long long)H * W;
    constexpr int VEC = 16 / (int)sizeof(Tout);  // outputs a 16-byte store
    constexpr int PARTS = E::PX / VEC;
    const bool aligned = (long long)W * sizeof(Tout) % 16 == 0;
#pragma unroll
    for (int piece = 0; piece < BN / EPI_CH; ++piece) {
#pragma unroll
      for (int jj = 0; jj < EPI_CH / 8; ++jj) {
        const int j = piece * (EPI_CH / 8) + jj;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * jj + 2 * (lane & 3) + e;  // channel of the piece
          const int o = tc.o0 + 8 * j + 2 * (lane & 3) + e;
          const float scale = o >= O ? 0.f : post == nullptr ? sw[o] : __fmul_rn(pb, sw[o]);
          const float bo = o >= O || bias == nullptr ? 0.f : round_to<Tout>(bias[o]);
#pragma unroll
          for (int mt = 0; mt < K::MT; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float v = round_to<Tout>(__fmul_rn((float)acc[mt][4 * j + 2 * half + e], scale));
              if (bias != nullptr) v = __fadd_rn(v, bo);
              stage_out[cl * E::CS + (2 * wi + half) * E::PX + 8 * mt + (lane >> 2)] =
                  from_f<Tout>(v);
            }
          }
        }
      }
      warpgroup_sync(wg);
#ifndef S8_NO_STORE
      for (int i = tid; i < EPI_CH * 8 * PARTS; i += 128) {
        const int part = i % PARTS, r = (i / PARTS) % 8, cl = i / (PARTS * 8);
        const int o = tc.o0 + piece * EPI_CH + cl, hh = hb + r, ww = tc.w0 + part * VEC;
        if (o >= O || hh >= H || ww >= W) continue;
        const Tout* src = stage_out + cl * E::CS + r * E::PX + part * VEC;
        Tout* dst = out + ((long long)tc.b * O + o) * HW + (long long)hh * W + ww;
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no libcuda link).
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

// The operand's half planes, [planes, H, W x 16 bytes], as 4-byte elements
// (a pixel's half is 4), read in boxes of (4 hc, hr, 1) elements: a staged
// row is one box row; zeros outside.
bool encode_operand(CUtensorMap* map, const void* ptr, int H, int W, long long planes, int hc,
                    int hr) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {4ull * W, (cuuint64_t)H, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {16ull * W, 16ull * W * H};
  const cuuint32_t box[3] = {4u * hc, (cuuint32_t)hr, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 132;
  }
  return count[dev];
}

template <class K, typename Tout>
cudaError_t launch(const void* qx, const void* qw, const float* sw, const float* post,
                   int post_bstride, const float* bias, void* out, int B, int nk, int H, int W,
                   int O, cudaStream_t st) {
  auto kernel = qconv_s8_kernel<K, Tout>;
  constexpr int smem = Epi<K, Tout>::SMEM;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  CUtensorMap xmap;
  if (!encode_operand(&xmap, qx, H, W, 2ll * B * nk, K::HC, K::HR)) return cudaErrorInvalidValue;
  const int tiles_h = (H + K::TH - 1) / K::TH, tiles_w = (W + K::TW - 1) / K::TW;
  const int tiles_o = (O + BN - 1) / BN;
  const long long tiles = (long long)B * tiles_h * tiles_w * tiles_o;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, kThreads, smem, st>>>(xmap, (const int8_t*)qw, sw, post, post_bstride, bias,
                                       (Tout*)out, nk, H, W, O, tiles_h, tiles_w, tiles_o,
                                       (int)tiles);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_out(int out_dtype, const void* qx, const void* qw, const float* sw,
                       const float* post, int post_bstride, const float* bias, void* out, int B,
                       int nk, int H, int W, int O, cudaStream_t st) {
  if (out_dtype == 0) {
    return launch<K, float>(qx, qw, sw, post, post_bstride, bias, out, B, nk, H, W, O, st);
  }
  if (out_dtype == 1) {
    return launch<K, __nv_bfloat16>(qx, qw, sw, post, post_bstride, bias, out, B, nk, H, W, O,
                                    st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// qx int8 [B, ceil(C / 32), 2, H, W, 16] (C32), 16-byte aligned; qw int8
// [ceil(O / 128), ceil(C / 32), 2, 9, 128, 16], 16-byte aligned; sw fp32
// [O], the dequant scale of each output channel; post fp32, the per-sample
// post-scale post[b * post_bstride] (post_bstride 0: one for every sample),
// or NULL; bias fp32 [O] (rounded to the output dtype here) or NULL; out
// [B, O, H, W] in out_dtype (0 float32, 1 bfloat16). tile: 0 the 16 x 16
// window, 1 the 16 x 8 one. Returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int qconv3x3_s8(const void* qx, const void* qw, const void* sw, const void* post,
                           int post_bstride, const void* bias, void* out, int out_dtype, int B,
                           int C, int H, int W, int O, int tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = (C + 31) / 32;
  const float* swf = (const float*)sw;
  const float* pf = (const float*)post;
  const float* bf = (const float*)bias;
  if (tile == 0) {
    return (int)launch_out<WideTile>(out_dtype, qx, qw, swf, pf, post_bstride, bf, out, B, nk, H,
                                     W, O, st);
  }
  if (tile == 1) {
    return (int)launch_out<NarrowTile>(out_dtype, qx, qw, swf, pf, post_bstride, bf, out, B, nk,
                                       H, W, O, st);
  }
  return (int)cudaErrorInvalidValue;
}
