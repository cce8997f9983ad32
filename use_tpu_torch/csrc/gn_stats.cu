// GroupNorm for NCHW activations as two hand-written passes (kernel K1).
//
// Replaces the Pallas kernel use_tpu/ops/gn_stats.py::_channel_sums_impl
// (body `_kernel`): per-(batch, channel) sum and sum of squares over the
// spatial axis in one read with fp32 accumulators. The apply pass replaces the
// XLA elementwise `x * a + off` (+ activation) of
// use_tpu/models/ncsnpp/layers.py::GroupNormAct (layers.py:228-256), with the
// fold of the statistics and the affine done per block from the [B, C] sums.
//
// Bound on the H100: both passes are memory-bound (a few operations per
// element against 4 or 2 bytes read). Stats reads x once (3.35 TB/s ->
// 0.12 ms for the 403 MB full-resolution fp32 tensor); apply reads x and
// writes y once.
//
// Design: in NCHW a channel's S elements are contiguous, so a block owns one
// slice of one (b, c) row and streams it with 16-byte loads (4 fp32 or 4 bf16
// elements a thread, four loads in flight). The TPU kernel carried its sums
// across a sequential grid; blocks here run in no order on 132 SMs, so a row
// is cut into `splits` slices to fill the card, each block writes its own
// partial, and a second small kernel adds the partials of a row in a fixed
// order (deterministic, no atomics). The apply kernel folds mean, clamped
// variance E[x^2]-E[x]^2, eps and the affine into one scale and one offset
// per block, then streams its slice once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive elements at a 4-element-aligned address.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// Sum of a and b over the block; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.f;
    b = lane < kThreads / 32 ? sb[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

__device__ __forceinline__ void accumulate4(const float v[4], float& s, float& ss) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s += v[k];
    ss = fmaf(v[k], v[k], ss);
  }
}

// grid (rows, splits): block (r, j) sums x[r, j*chunk : min(S, (j+1)*chunk)].
// part holds [2, rows, splits]: sums, then sums of squares.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part, long long S,
                     long long chunk, int vec) {
  const long long row = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const long long begin = (long long)split * chunk;
  const long long end = min(S, begin + chunk);
  const T* xr = x + row * S;
  float s = 0.f, ss = 0.f;
  if (vec) {  // S and chunk are multiples of 4, x is 16-byte aligned
    const long long stride = 4LL * kThreads;
    long long i = begin + 4LL * threadIdx.x;
    for (; i + 3 * stride < end; i += 4 * stride) {
      float v0[4], v1[4], v2[4], v3[4];
      load4(xr + i, v0);
      load4(xr + i + stride, v1);
      load4(xr + i + 2 * stride, v2);
      load4(xr + i + 3 * stride, v3);
      accumulate4(v0, s, ss);
      accumulate4(v1, s, ss);
      accumulate4(v2, s, ss);
      accumulate4(v3, s, ss);
    }
    for (; i < end; i += stride) {
      float v[4];
      load4(xr + i, v);
      accumulate4(v, s, ss);
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      const float v = to_f(xr[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  block_sum2(s, ss);
  if (threadIdx.x == 0) {
    const long long rows = gridDim.x;
    part[row * splits + split] = s;
    part[rows * splits + row * splits + split] = ss;
  }
}

// One thread a row: add the row's partials in order.
__global__ void stats_finalize_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                      float* __restrict__ sumsq, long long rows, int splits) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.f, ss = 0.f;
  for (int k = 0; k < splits; ++k) {
    s += part[r * splits + k];
    ss += part[rows * splits + r * splits + k];
  }
  sums[r] = s;
  sumsq[r] = ss;
}

// act: 0 none, 1 silu, 2 relu, 3 leaky relu (0.2), 4 elu
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v / (1.f + expf(-v));
    case 2: return fmaxf(v, 0.f);
    case 3: return v >= 0.f ? v : 0.2f * v;
    case 4: return v > 0.f ? v : expm1f(v);
    default: return v;
  }
}

// grid (B*C, splits): block (r, j) normalizes x[r, j*chunk : ...] into y.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, const float* __restrict__ sums,
             const float* __restrict__ sumsq, const float* __restrict__ weight,
             const float* __restrict__ bias, int C, int groups, long long S, long long chunk,
             float eps, int act, int vec) {
  __shared__ float s_scale, s_shift;
  const long long row = blockIdx.x;
  const int c = (int)(row % C);
  const long long bC = row - c;  // b * C
  if (threadIdx.x == 0) {
    const int cg = C / groups;
    const int g0 = (c / cg) * cg;
    float gs = 0.f, gss = 0.f;
    for (int k = 0; k < cg; ++k) {
      gs += sums[bC + g0 + k];
      gss += sumsq[bC + g0 + k];
    }
    const float n = (float)((double)S * cg);
    const float mean = gs / n;
    const float meansq = gss / n;
    const float var = fmaxf(meansq - mean * mean, 0.f);
    const float a = rsqrtf(var + eps) * weight[c];
    s_scale = a;
    s_shift = bias[c] - mean * a;
  }
  __syncthreads();
  const float a = s_scale;
  const float off = s_shift;
  const long long begin = (long long)blockIdx.y * chunk;
  const long long end = min(S, begin + chunk);
  const Tin* xr = x + row * S;
  Tout* yr = y + row * S;
  if (vec) {
    for (long long i = begin + 4LL * threadIdx.x; i < end; i += 4LL * kThreads) {
      float v[4];
      load4(xr + i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = activate(__fadd_rn(__fmul_rn(v[k], a), off), act);
      store4(yr + i, v);
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      yr[i] = from_f<Tout>(activate(__fadd_rn(__fmul_rn(to_f(xr[i]), a), off), act));
    }
  }
}

template <typename Tin>
cudaError_t launch_apply(const void* x, void* y, int out_dtype, const float* sums,
                         const float* sumsq, const float* weight, const float* bias,
                         long long rows, int C, int groups, long long S, int splits,
                         long long chunk, float eps, int act, int vec, cudaStream_t st) {
  const dim3 grid((unsigned)rows, (unsigned)splits);
  if (out_dtype == 0) {
    apply_kernel<Tin, float><<<grid, kThreads, 0, st>>>(
        (const Tin*)x, (float*)y, sums, sumsq, weight, bias, C, groups, S, chunk, eps, act, vec);
  } else if (out_dtype == 1) {
    apply_kernel<Tin, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const Tin*)x, (__nv_bfloat16*)y, sums, sumsq, weight, bias, C, groups, S, chunk, eps,
        act, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Every function returns the CUDA error
// of its launches (0 when they were accepted).

// x [rows, S] -> sums[rows], sumsq[rows] (fp32); part is scratch of
// 2 * rows * splits floats.
extern "C" int gn_channel_sums(const void* x, int dtype, long long rows, long long S, int splits,
                               long long chunk, int vec, void* part, void* sums, void* sumsq,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)rows, (unsigned)splits);
  if (dtype == 0) {
    stats_partial_kernel<float><<<grid, kThreads, 0, st>>>((const float*)x, (float*)part, S,
                                                           chunk, vec);
  } else if (dtype == 1) {
    stats_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (float*)part, S, chunk, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((rows + 255) / 256);
  stats_finalize_kernel<<<blocks, 256, 0, st>>>((const float*)part, (float*)sums,
                                                (float*)sumsq, rows, splits);
  return (int)cudaGetLastError();
}

// y[b, c, :] = act(x[b, c, :] * a[b, c] + off[b, c]), with a and off folded
// from the channel sums of x, the GroupNorm affine and eps.
extern "C" int gn_apply(const void* x, int in_dtype, void* y, int out_dtype, const void* sums,
                        const void* sumsq, const void* weight, const void* bias, long long rows,
                        int C, int groups, long long S, int splits, long long chunk, float eps,
                        int act, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == 0) {
    return (int)launch_apply<float>(x, y, out_dtype, (const float*)sums, (const float*)sumsq,
                                    (const float*)weight, (const float*)bias, rows, C, groups, S,
                                    splits, chunk, eps, act, vec, st);
  }
  if (in_dtype == 1) {
    return (int)launch_apply<__nv_bfloat16>(x, y, out_dtype, (const float*)sums,
                                            (const float*)sumsq, (const float*)weight,
                                            (const float*)bias, rows, C, groups, S, splits, chunk,
                                            eps, act, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}
