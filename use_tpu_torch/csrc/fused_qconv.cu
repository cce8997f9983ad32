// Fused GroupNorm-affine + SiLU + int8-quantize 3x3 SAME conv on NCHW tensors (kernel K3).
//
// Replaces the Pallas kernel use_tpu/ops/pallas_qconv.py::qconv3x3_fused (body
// `_kernel`), the conv of the int8 serving path quant='int8_pallas'
// (use_tpu/models/ncsnpp/layers.py:124-149):
//
//   q[b, c, h, w] = clip(rint(act(x * a[b, c] + off[b, c]) * iu[c]), -127, 127)   (0 outside the image)
//   out[b, o, h, w] = float(sum_{c, dy, dx} q[b, c, h+dy-1, w+dx-1] * qw[o, c, dy, dx]) * sw[o] + bias[o]
//
// Bound on the H100: bytes and operations come close. At B 8, C 256, O 128,
// 512 x 192 the 4.6e11 int8 operations (2 * 9 * C * O an output pixel) take
// 0.23 ms at the dense int8 tensor-core peak; reading x once and writing out
// once takes 0.36 ms in fp32 and 0.18 ms in bf16. On the CUDA cores (dp4a,
// below) the products bound this kernel far above either.
//
// Design, simple first: a block owns one batch item, a tile of 4 rows x 32
// columns of output pixels and 128 output channels. For each chunk of 32
// input channels it stages the quantized operand of the tile and its
// one-pixel halo in shared memory, four channels of one pixel in one 32-bit
// word, each element read from x once and quantized once; the producer rounds
// like the plain version (__fmul_rn / __fadd_rn: no FMA contraction, the
// sigmoid as 1 / (1 + exp(-y)), rintf rounds half to even), and writes a
// quantized zero at image edges. It stages the chunk's int8 weights of all
// 9 taps for the block's 128 output channels beside it. All 9 taps read the
// one staged tile. Each of the 256 threads keeps 8 output channels x 8 pixels
// of int32 sums in registers and accumulates them with __dp4a on the CUDA
// cores; integer sums are exact in any order. The epilogue dequantizes and
// writes NCHW in the output dtype, 16 consecutive columns a half-warp.
// Tensor cores (mma.sync / wgmma on s8) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 4;           // output rows per block
constexpr int TW = 32;          // output columns per block
constexpr int HC = TW + 2;      // staged columns with the halo
constexpr int NPIX = (TH + 2) * HC;
constexpr int CK = 32;          // input channels per chunk
constexpr int CK4 = CK / 4;     // 32-bit words a pixel per chunk
constexpr int BO = 128;         // output channels per block
constexpr int kThreads = 256;
constexpr int PO = 8;           // output channels per thread: o0 + to + 16 i
constexpr int PP = 8;           // pixels per thread: row j / 2, column 16 (j % 2) + tp

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The producer of the operand, rounded step by step as the plain version.
__device__ __forceinline__ int quantize(float v, float a, float off, float iu, int act) {
  float y = __fadd_rn(__fmul_rn(v, a), off);
  if (act) y = __fmul_rn(y, 1.f / (1.f + expf(-y)));
  const float q = rintf(__fmul_rn(y, iu));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// grid (ceil(H / TH) * tiles_w, ceil(O / BO), B)
template <typename T, typename Tout>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ off,
             const float* __restrict__ iu, const int* __restrict__ qw, const float* __restrict__ sw,
             const float* __restrict__ bias, Tout* __restrict__ out, int C, int H, int W, int O,
             int tiles_w, int act) {
  __shared__ int qs[CK4][NPIX];    // quantized operand, 4 channels a word
  __shared__ int ws[9][CK4][BO];   // int8 weights, 4 input channels a word
  const int tid = threadIdx.x;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * BO;
  const long long b = blockIdx.z;
  const int tp = tid % 16;
  const int to = tid / 16;
  const int C4 = C / 4;
  const long long HW = (long long)H * W;
  const T* xb = x + b * C * HW;
  const float* ab = a + b * C;
  const float* offb = off + b * C;

  int acc[PO][PP];
#pragma unroll
  for (int i = 0; i < PO; ++i)
#pragma unroll
    for (int j = 0; j < PP; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < C; k0 += CK) {
    for (int e = tid; e < CK * NPIX; e += kThreads) {
      const int c = e / NPIX, p = e % NPIX;
      const int hh = h0 + p / HC - 1, ww = w0 + p % HC - 1;
      const int cc = k0 + c;
      int q = 0;
      if (cc < C && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        q = quantize(to_f(xb[cc * HW + (long long)hh * W + ww]), ab[cc], offb[cc], iu[cc], act);
      }
      reinterpret_cast<int8_t*>(&qs[c / 4][p])[c % 4] = (int8_t)q;
    }
    for (int e = tid; e < 9 * CK4 * BO; e += kThreads) {
      const int o = e % BO, c4 = (e / BO) % CK4, t = e / (BO * CK4);
      const int oo = o0 + o, cc4 = k0 / 4 + c4;
      ws[t][c4][o] = (oo < O && cc4 < C4) ? qw[((long long)t * C4 + cc4) * O + oo] : 0;
    }
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
#pragma unroll 2
      for (int c4 = 0; c4 < CK4; ++c4) {
        int wv[PO], xv[PP];
#pragma unroll
        for (int i = 0; i < PO; ++i) wv[i] = ws[t][c4][to + 16 * i];
#pragma unroll
        for (int j = 0; j < PP; ++j) xv[j] = qs[c4][(j / 2 + dy) * HC + 16 * (j % 2) + tp + dx];
#pragma unroll
        for (int i = 0; i < PO; ++i)
#pragma unroll
          for (int j = 0; j < PP; ++j) acc[i][j] = __dp4a(xv[j], wv[i], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PO; ++i) {
    const int o = o0 + to + 16 * i;
    if (o >= O) continue;
    const float s = sw[o], bo = bias[o];
    Tout* ob = out + (b * O + o) * HW;
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      const int hh = h0 + j / 2, ww = w0 + 16 * (j % 2) + tp;
      if (hh < H && ww < W) {
        ob[(long long)hh * W + ww] = from_f<Tout>(__fadd_rn(__fmul_rn((float)acc[i][j], s), bo));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* a, const float* off, const float* iu, const int* qw,
                   const float* sw, const float* bias, void* out, int out_dtype, int B, int C,
                   int H, int W, int O, int act, cudaStream_t st) {
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid((unsigned)(((H + TH - 1) / TH) * tiles_w), (unsigned)((O + BO - 1) / BO),
                  (unsigned)B);
  if (out_dtype == 0) {
    qconv_kernel<T, float><<<grid, kThreads, 0, st>>>((const T*)x, a, off, iu, qw, sw, bias,
                                                      (float*)out, C, H, W, O, tiles_w, act);
  } else if (out_dtype == 1) {
    qconv_kernel<T, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const T*)x, a, off, iu, qw, sw, bias, (__nv_bfloat16*)out, C, H, W, O, tiles_w, act);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. x [B, C, H, W]; a, off [B, C] fp32;
// iu [C] fp32 (1 / u); qw int8 [9, C/4, O, 4] (tap-major, 4 input channels
// of one output channel in a word); sw, bias [O] fp32; out [B, O, H, W].
// C is a multiple of 4. Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int qconv3x3_fused(const void* x, int in_dtype, const void* a, const void* off,
                              const void* iu, const void* qw, const void* sw, const void* bias,
                              void* out, int out_dtype, int B, int C, int H, int W, int O, int act,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 4 != 0) return (int)cudaErrorInvalidValue;
  const float* af = (const float*)a;
  const float* of = (const float*)off;
  const float* iuf = (const float*)iu;
  const int* qwi = (const int*)qw;
  const float* swf = (const float*)sw;
  const float* bf = (const float*)bias;
  if (in_dtype == 0) {
    return (int)launch<float>(x, af, of, iuf, qwi, swf, bf, out, out_dtype, B, C, H, W, O, act, st);
  }
  if (in_dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, af, of, iuf, qwi, swf, bf, out, out_dtype, B, C, H, W, O,
                                      act, st);
  }
  return (int)cudaErrorInvalidValue;
}
