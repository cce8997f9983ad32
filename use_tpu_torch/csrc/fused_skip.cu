// Fused resblock shortcut: out = (h + W x + b) * scale on NCHW tensors (kernel K2).
//
// Replaces the Pallas kernel use_tpu/ops/pallas_skip.py::fused_skip_add (body
// `_kernel`): the BigGAN resblock's 1x1 `Conv_2` shortcut, the residual add and
// the skip_rescale factor in one pass (use_tpu/models/ncsnpp/layers.py:610-619).
//
// Per batch item this is a GEMM out[o, s] = sum_c W[o, c] x[c, s] with
// Co in {128, 256}, Ci in {128..512} and S up to 786,432 spatial positions,
// plus an epilogue that reads h once and writes out once.
//
// Bound on the H100: in fp32 without tensor cores the products bound it
// (2 Ci Co S operations at 67 TFLOP/s: 0.77 ms at Ci 256, Co 128, S 786,432,
// against 0.48 ms for its 1.6 GB of traffic). In bf16 the traffic bounds it
// (0.24 ms at the same shape).
//
// Design: a classic tiled shared-memory GEMM on the CUDA cores with fp32
// accumulation, for fp32 and bf16 operands alike (bf16 is widened on its
// way into shared memory). A block computes a 64 (output channels) x 128
// (positions) tile; each of its 256 threads holds a 4 x 8 accumulator in
// registers. Each k step stages an 8-channel slice of W and of x in shared
// memory; x is read along s, so global loads are coalesced. Edges in Co, Ci
// and S are masked with zeros, so any shape is taken. The epilogue adds bias
// and h, scales, and writes in h's dtype. Tensor cores (wgmma) and TMA are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output channels per block
constexpr int BN = 128;  // spatial positions per block
constexpr int BK = 8;    // input channels per k step
constexpr int TM = 4;    // output channels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (ceil(S / BN), ceil(Co / BM), B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_skip_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out, int Ci, int Co, long long S,
                  float scale) {
  __shared__ __align__(16) float Ws[BK][BM];  // Ws[k][m] = W[o0 + m, k0 + k]
  __shared__ __align__(16) float Xs[BK][BN];  // Xs[k][n] = x[b, k0 + k, s0 + n]
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // this thread's columns: tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid / 16;  // this thread's rows: ty*4 + {0..3}
  const long long s0 = (long long)blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const long long b = blockIdx.z;
  const T* xb = x + b * (long long)Ci * S;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int m = e / BK, k = e % BK;
      const int o = o0 + m, c = k0 + k;
      Ws[k][m] = (o < Co && c < Ci) ? to_f(w[(long long)o * Ci + c]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int k = e / BN, n = e % BN;
      const int c = k0 + k;
      const long long s = s0 + n;
      Xs[k][n] = (c < Ci && s < S) ? to_f(xb[(long long)c * S + s]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Ws[k][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Xs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Xs[k][64 + tx * 4]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int o = o0 + ty * TM + i;
    if (o >= Co) continue;
    const float bo = to_f(bias[o]);
    const long long base = (b * Co + o) * S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long s = s0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (s < S) {
        out[base + s] = from_f<T>((to_f(h[base + s]) + acc[i][j] + bo) * scale);
      }
    }
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, h, w, bias and out share it).
// x [B, Ci, S], h and out [B, Co, S], w [Co, Ci], bias [Co], all contiguous.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int fused_skip_add(const void* x, const void* h, const void* w, const void* bias,
                              void* out, int dtype, int B, int Ci, int Co, long long S,
                              float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((S + BN - 1) / BN), (unsigned)((Co + BM - 1) / BM), (unsigned)B);
  if (dtype == 0) {
    fused_skip_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)h, (const float*)w, (const float*)bias, (float*)out, Ci,
        Co, S, scale);
  } else if (dtype == 1) {
    fused_skip_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (const __nv_bfloat16*)w,
        (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, Ci, Co, S, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
