// Fused resblock shortcut: out = (h + W x + b) * scale on NCHW tensors (kernel K2).
//
// Replaces the Pallas kernel use_tpu/ops/pallas_skip.py::fused_skip_add (body
// `_kernel` at :33, the pallas_call at :64): the BigGAN resblock's 1x1
// `Conv_2` shortcut, the residual add and the skip_rescale factor in one pass
// (use_tpu/models/ncsnpp/layers.py:610-619).
//
// Per batch item this is a GEMM out[o, s] = sum_c W[o, c] x[c, s] with
// Co in {128, 256}, Ci in {128..512} and S up to 786,432 contiguous spatial
// positions, plus an epilogue that reads h once and writes out once.
//
// Bound on the H100, at Ci 256, Co 128, S 8 x 98,304:
// - bf16: the traffic. 2 Ci Co operations a position against 2 (Ci + 2 Co)
//   bytes is 64 operations a byte, far under the ~295 at which the tensor
//   cores would bound it: 0.24 ms for the 0.8 GB moved at 3.35 TB/s.
// - fp32 (TF32 off, so no tensor cores): the products, 2 Ci Co S operations
//   at 67 TFLOP/s, 0.77 ms, against 0.48 ms for its traffic.
//
// Design, bf16 (fused_skip_bf16_kernel): the tensor cores, mma.sync.m16n8k16
// with fp32 sums. A block computes 128 output channels x 128 positions of one
// batch item, so x is read from device memory once where Co = 128; where
// Co = 256 the two channel tiles of one x tile are neighbours in the grid and
// the second finds x in L2. W (row-major: the K-contiguous A operand) and x
// (S-contiguous: the B operand, read with ldmatrix.trans) stream through a
// ring of 4 stages of 32 input channels by cp.async, so the loads of the next
// three chunks are in flight while one chunk runs its products. The shared
// tiles are XOR-swizzled by 16-byte unit, so every 8-row ldmatrix phase hits
// all 32 banks. The epilogue stages the accumulators in shared memory (the
// ring, reused) and reads h and writes out 8 positions (16 bytes) a thread.
//
// Design, fp32 (fused_skip_f32_kernel): a register-blocked GEMM on the CUDA
// cores, 128 x 128 tiles, 8 x 8 accumulators a thread (two 4-row by two
// 4-column quads, so that every shared-memory read is a float4 that a warp
// broadcasts or reads without conflicts), a ring of 4 stages of 8 input
// channels by cp.async with one barrier a stage (faster on the H100 than 16
// channels double-buffered with two barriers a stage; PERF.md). The epilogue reads h and writes out as float4.
//
// Both mask ragged Ci, Co and S with zero-filled copies. Where S, Ci (bf16)
// or an address does not allow 16-byte accesses, a scalar path stages and
// writes element by element. Tiles are picked here, not by the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output channels a block
constexpr int BN = 128;  // positions a block
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Global -> shared, asynchronous; bytes = 0 writes zeros (src is not read).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BK16 = 32;     // input channels a stage
constexpr int STAGES16 = 4;  // ring depth
constexpr int A_BYTES = BM * BK16 * 2;           // W tile [128 o][32 c], 64-byte rows
constexpr int B_BYTES = BK16 * BN * 2;           // x tile [32 c][128 s], 256-byte rows
constexpr int STAGE16 = A_BYTES + B_BYTES;
constexpr int CS_LD = BN + 8;                    // fp32 staging row, padded
constexpr int SMEM16 = (STAGES16 * STAGE16 > BM * CS_LD * 4) ? STAGES16 * STAGE16 : BM * CS_LD * 4;

// Byte offsets of 16-byte unit `c` of a row in the swizzled tiles.
__device__ __forceinline__ int swz_a(int row, int c) { return row * 64 + 16 * (c ^ ((row >> 1) & 3)); }
__device__ __forceinline__ int swz_b(int row, int c) { return row * 256 + 16 * (c ^ (row & 7)); }

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, col-major), fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Stage input channels [k0, k0 + 32) of W's rows [o0, o0 + 128) and of x's
// positions [s0, s0 + 128) into ring slot `st`. VEC: 16-byte copies (S and
// Ci multiples of 8, 16-byte aligned tensors); else element by element.
template <bool VEC>
__device__ __forceinline__ void load_stage16(unsigned char* smem, int st, const __nv_bfloat16* w,
                                             const __nv_bfloat16* xb, int Ci, int Co, long long S,
                                             int o0, long long s0, int k0) {
  unsigned char* As = smem + st * STAGE16;
  unsigned char* Bs = As + A_BYTES;
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // W: 128 rows x 4 units
      const int e = tid + i * kThreads;
      const int r = e >> 2, c = e & 3;
      const int o = o0 + r, ch = k0 + 8 * c;
      const bool ok = o < Co && ch < Ci;
      cp_async16(smem_u32(As + swz_a(r, c)), ok ? (const void*)(w + (long long)o * Ci + ch) : w,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 32 rows x 16 units
      const int e = tid + i * kThreads;
      const int k = e >> 4, c = e & 15;
      const int ch = k0 + k;
      const long long s = s0 + 8 * c;
      const bool ok = ch < Ci && s < S;
      cp_async16(smem_u32(Bs + swz_b(k, c)), ok ? (const void*)(xb + (long long)ch * S + s) : xb,
                 ok ? 16 : 0);
    }
  } else {
    const unsigned short* wr = reinterpret_cast<const unsigned short*>(w);
    const unsigned short* xr = reinterpret_cast<const unsigned short*>(xb);
    for (int e = tid; e < BM * BK16; e += kThreads) {
      const int r = e / BK16, kk = e % BK16;
      const int o = o0 + r, ch = k0 + kk;
      const unsigned short v = (o < Co && ch < Ci) ? wr[(long long)o * Ci + ch] : 0;
      *reinterpret_cast<unsigned short*>(As + swz_a(r, kk >> 3) + 2 * (kk & 7)) = v;
    }
    for (int e = tid; e < BK16 * BN; e += kThreads) {
      const int k = e / BN, n = e % BN;
      const int ch = k0 + k;
      const long long s = s0 + n;
      const unsigned short v = (ch < Ci && s < S) ? xr[(long long)ch * S + s] : 0;
      *reinterpret_cast<unsigned short*>(Bs + swz_b(k, n >> 3) + 2 * (n & 7)) = v;
    }
  }
}

// grid (ceil(S / 128) * ceil(Co / 128), B): the channel tile varies fastest.
// 8 warps as 2 (channels) x 4 (positions), each 64 x 32: 4 x 4 mma tiles.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
fused_skip_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                       const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int Ci, int Co, long long S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_co = (Co + BM - 1) / BM;
  const int o0 = (blockIdx.x % n_co) * BM;
  const long long s0 = (long long)(blockIdx.x / n_co) * BN;
  const long long b = blockIdx.y;
  const __nv_bfloat16* xb = x + b * (long long)Ci * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile rows wm*64, columns wn*32

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (Ci + BK16 - 1) / BK16;
#pragma unroll
  for (int st = 0; st < STAGES16 - 1; ++st) {
    if (st < nk) load_stage16<VEC>(smem, st, w, xb, Ci, Co, S, o0, s0, st * BK16);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES16 - 2>();
    __syncthreads();  // chunk kt has landed; slot (kt - 1) % STAGES is free
    const int nxt = kt + STAGES16 - 1;
    if (nxt < nk) load_stage16<VEC>(smem, nxt % STAGES16, w, xb, Ci, Co, S, o0, s0, nxt * BK16);
    cp_commit();
    const unsigned char* As = smem + (kt % STAGES16) * STAGE16;
    const unsigned a_base = smem_u32(As);
    const unsigned b_base = a_base + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      unsigned a[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(a_base + swz_a(row, (kk >> 3) + (lane >> 4)), a[mi]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * 32 + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b_base + swz_b(k, n >> 3), bf[nj]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], bf[ni >> 1][2 * (ni & 1)], bf[ni >> 1][2 * (ni & 1) + 1]);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: stage the fp32 tile there

  float* cs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = wm * 64 + mi * 16 + g;
      const int col = wn * 32 + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(cs + row * CS_LD + col) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(cs + (row + 8) * CS_LD + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();

  if (VEC) {
#pragma unroll 2
    for (int e = tid; e < BM * (BN / 8); e += kThreads) {  // 8 positions a thread
      const int r = e >> 4, c = e & 15;
      const int o = o0 + r;
      const long long s = s0 + 8 * c;
      if (o >= Co || s >= S) continue;
      const long long at = (b * Co + o) * S + s;
      const uint4 hv = *reinterpret_cast<const uint4*>(h + at);
      const float4 c0 = *reinterpret_cast<const float4*>(cs + r * CS_LD + 8 * c);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + r * CS_LD + 8 * c + 4);
      const float bo = __bfloat162float(bias[o]);
      const unsigned hw[4] = {hv.x, hv.y, hv.z, hv.w};
      const float av[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      unsigned ow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = (bf_lo(hw[j]) + av[2 * j] + bo) * scale;
        const float hi = (bf_hi(hw[j]) + av[2 * j + 1] + bo) * scale;
        const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
        ow[j] = *reinterpret_cast<const unsigned*>(&p);
      }
      *reinterpret_cast<uint4*>(out + at) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    }
  } else {
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, n = e % BN;
      const int o = o0 + r;
      const long long s = s0 + n;
      if (o >= Co || s >= S) continue;
      const long long at = (b * Co + o) * S + s;
      out[at] = __float2bfloat16(
          (__bfloat162float(h[at]) + cs[r * CS_LD + n] + __bfloat162float(bias[o])) * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BK32 = 8;        // input channels a stage
constexpr int STAGES32 = 4;    // ring depth
constexpr int WS_LD = BM + 4;  // W tile row (one input channel), padded against bank conflicts

static_assert(BM * BK32 % kThreads == 0 && BK32 * BN / 4 % kThreads == 0,
              "every thread copies whole units of the W and x tiles");

struct F32Stage {
  float ws[BK32][WS_LD];  // ws[k][m] = W[o0 + m, k0 + k]
  float xs[BK32][BN];     // xs[k][n] = x[b, k0 + k, s0 + n]
};

// VEC: x by 16-byte copies (S a multiple of 4, 16-byte aligned x); else by 4.
template <bool VEC>
__device__ __forceinline__ void load_stage32(F32Stage& st, const float* w, const float* xb, int Ci,
                                             int Co, long long S, int o0, long long s0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BM * BK32 / kThreads; ++i) {  // W: a row's BK32 k from consecutive threads
    const int e = tid + i * kThreads;
    const int k = e % BK32, m = e / BK32;
    const int o = o0 + m, ch = k0 + k;
    const bool ok = o < Co && ch < Ci;
    cp_async4(smem_u32(&st.ws[k][m]), ok ? w + (long long)o * Ci + ch : w, ok ? 4 : 0);
  }
  if (VEC) {
#pragma unroll
    for (int i = 0; i < BK32 * BN / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / (BN / 4), c = e % (BN / 4);
      const int ch = k0 + k;
      const long long s = s0 + 4 * c;
      const bool ok = ch < Ci && s < S;
      cp_async16(smem_u32(&st.xs[k][4 * c]), ok ? xb + (long long)ch * S + s : xb, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BK32 * BN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / BN, n = e % BN;
      const int ch = k0 + k;
      const long long s = s0 + n;
      const bool ok = ch < Ci && s < S;
      cp_async4(smem_u32(&st.xs[k][n]), ok ? xb + (long long)ch * S + s : xb, ok ? 4 : 0);
    }
  }
}

// grid as the bf16 kernel. Thread (ty, tx) of 16 x 16 owns rows
// {ty*4, 64 + ty*4} + 0..3 and columns {tx*4, 64 + tx*4} + 0..3.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
fused_skip_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                      const float* __restrict__ w, const float* __restrict__ bias,
                      float* __restrict__ out, int Ci, int Co, long long S, float scale) {
  __shared__ __align__(16) F32Stage stage[STAGES32];
  const int n_co = (Co + BM - 1) / BM;
  const int o0 = (blockIdx.x % n_co) * BM;
  const long long s0 = (long long)(blockIdx.x / n_co) * BN;
  const long long b = blockIdx.y;
  const float* xb = x + b * (long long)Ci * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (Ci + BK32 - 1) / BK32;
#pragma unroll
  for (int st = 0; st < STAGES32 - 1; ++st) {
    if (st < nk) load_stage32<VEC>(stage[st], w, xb, Ci, Co, S, o0, s0, st * BK32);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES32 - 2>();
    __syncthreads();  // chunk kt has landed; slot (kt - 1) % STAGES is free
    const int nxt = kt + STAGES32 - 1;
    if (nxt < nk) load_stage32<VEC>(stage[nxt % STAGES32], w, xb, Ci, Co, S, o0, s0, nxt * BK32);
    cp_commit();
    const F32Stage& st = stage[kt % STAGES32];
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&st.ws[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&st.ws[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&st.xs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&st.xs[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = o0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (o >= Co) continue;
    const float bo = bias[o];
    const long long base = (b * Co + o) * S;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long s = s0 + half * 64 + tx * 4;
      const float* a = &acc[i][4 * half];
      if (VEC) {
        if (s >= S) continue;
        const float4 hv = *reinterpret_cast<const float4*>(h + base + s);
        *reinterpret_cast<float4*>(out + base + s) =
            make_float4((hv.x + a[0] + bo) * scale, (hv.y + a[1] + bo) * scale,
                        (hv.z + a[2] + bo) * scale, (hv.w + a[3] + bo) * scale);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s + j < S) out[base + s + j] = (h[base + s + j] + a[j] + bo) * scale;
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, h, w, bias and out share it).
// x [B, Ci, S], h and out [B, Co, S], w [Co, Ci], bias [Co], all contiguous.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int fused_skip_add(const void* x, const void* h, const void* w, const void* bias,
                              void* out, int dtype, int B, int Ci, int Co, long long S,
                              float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = ((S + BN - 1) / BN) * ((Co + BM - 1) / BM);
  if (tiles > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)B);
  const bool aligned = aligned16(x) && aligned16(h) && aligned16(out);
  if (dtype == 0) {
    const float *xf = (const float*)x, *hf = (const float*)h, *wf = (const float*)w,
                *bf = (const float*)bias;
    if (aligned && S % 4 == 0) {
      fused_skip_f32_kernel<true><<<grid, kThreads, 0, st>>>(xf, hf, wf, bf, (float*)out, Ci, Co,
                                                             S, scale);
    } else {
      fused_skip_f32_kernel<false><<<grid, kThreads, 0, st>>>(xf, hf, wf, bf, (float*)out, Ci, Co,
                                                              S, scale);
    }
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    const bool vec = aligned && aligned16(w) && S % 8 == 0 && Ci % 8 == 0;
    auto kernel = vec ? fused_skip_bf16_kernel<true> : fused_skip_bf16_kernel<false>;
    // the ring and staging need > 48 KB; the attribute holds per device, so
    // it is set at every launch (as K3 does), not once per process
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM16);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, SMEM16, st>>>((const bf*)x, (const bf*)h, (const bf*)w,
                                           (const bf*)bias, (bf*)out, Ci, Co, S, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
