// GroupNorm for NCHW activations as two hand-written passes (kernel K1).
//
// Replaces the Pallas kernel use_tpu/ops/gn_stats.py::_channel_sums_impl
// (body `_kernel` at :43, the pallas_call at :92): per-(batch, channel) sum
// and sum of squares over the spatial axis in one read with fp32
// accumulators. The same pass can fold the statistics into the GroupNorm's
// per-(batch, channel) scale and shift, as use_tpu's GroupNorm does for int8
// serving (use_tpu/models/ncsnpp/layers.py:231-250). The apply pass replaces
// the XLA elementwise `x * a + off` (+ activation) of
// use_tpu/models/ncsnpp/layers.py::GroupNormAct (layers.py:251-256), with the
// fold done per block from the [B, C] sums.
//
// Bound on the H100: both passes are memory-bound (a few operations per
// element against 4 or 2 bytes read). Stats reads x once (3.35 TB/s ->
// 0.12 ms for the 403 MB full-resolution fp32 tensor); apply reads x and
// writes y once. At the U-Net's low levels a call moves a few hundred KB:
// there the bound is under a microsecond and the launch itself is the cost.
//
// Design of the statistics. In NCHW a channel's S elements are contiguous,
// and the TPU kernel carried its sums across a sequential grid; blocks here
// run in no order on 132 SMs. The wrapper (ops/gn_stats.py split_rows)
// cuts rows into slices only when there are too few rows to fill the card:
// - Short rows (one slice: every batch-8 level from 128 x 48 down): one warp
//   owns a row, reads it with 16-byte loads (4 fp32 or 8 bf16 elements, four
//   loads in flight a lane) and reduces with shuffles; a block owns whole
//   GroupNorm groups. It writes the sums straight to the output: one launch,
//   no shared memory, no barrier. Folding, the block's warps leave their row
//   sums in shared memory and, after one barrier, each thread folds one
//   channel of its group.
// - Long rows: a 256-thread block streams one slice with eight 16-byte loads
//   in flight a thread and writes its partial; a second small kernel adds a
//   row's partials in a fixed order (deterministic, no atomics), and folds
//   per (batch, group) when asked.
// The fold: mean = sum / n, var = max(E[x^2] - E[x]^2, 0),
// a = rsqrt(var + eps) * weight, off = bias - mean * a, each step rounded
// as the plain version's (no contraction, round-to-nearest rsqrt).
//
// The apply pass has an int8 epilogue, gn_apply_q8: GroupNormAct(quant=
// 'out') of quant='int8' serving (use_tpu/models/ncsnpp/layers.py:257-272,
// XLA there), whose only consumer is the int8 conv (ops/qconv.py). From the
// fold (a, off) of the statistics pass it writes
//   q = clip(rint(Tmid(act(x * a + off)) / u[c]), -127, 127)   as int8,
// y rounded to the serving dtype Tmid before the IEEE division by the
// k-sigma scale u, as use_tpu divides; every step rounded as the plain
// version's, so that the two are bit-equal. Bound: bytes, x read once and
// one byte an element written (a third less than the bf16 apply).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Elements in one 16-byte load.
template <typename T> constexpr int kVec = 16 / sizeof(T);

__device__ __forceinline__ void add(float v, float& s, float& ss) {
  s += v;
  ss = fmaf(v, v, ss);
}
__device__ __forceinline__ void accumulate16(const uint4& q, float, float& s, float& ss) {
  add(__uint_as_float(q.x), s, ss);
  add(__uint_as_float(q.y), s, ss);
  add(__uint_as_float(q.z), s, ss);
  add(__uint_as_float(q.w), s, ss);
}
// a bf16 is the high half of the float it widens to, exactly
__device__ __forceinline__ void accumulate16(const uint4& q, __nv_bfloat16, float& s, float& ss) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    add(__uint_as_float(w[j] << 16), s, ss);
    add(__uint_as_float(w[j] & 0xffff0000u), s, ss);
  }
}

// Thread t of n sums xr[begin, end) into s, ss. VEC: begin, end and xr are
// 16-byte aligned element counts/addresses, U loads in flight a thread.
template <typename T, int U>
__device__ __forceinline__ void sum_range(const T* __restrict__ xr, long long begin,
                                          long long end, int t, int n, bool vec, float& s,
                                          float& ss) {
  if (vec) {
    constexpr int V = kVec<T>;
    const long long stride = (long long)V * n;
    long long i = begin + (long long)V * t;
    for (; i + (U - 1) * stride < end; i += U * stride) {
      uint4 q[U];
#pragma unroll
      for (int u = 0; u < U; ++u) q[u] = __ldg(reinterpret_cast<const uint4*>(xr + i + u * stride));
#pragma unroll
      for (int u = 0; u < U; ++u) accumulate16(q[u], T(), s, ss);
    }
    for (; i < end; i += stride) accumulate16(__ldg(reinterpret_cast<const uint4*>(xr + i)), T(), s, ss);
  } else {
    for (long long i = begin + t; i < end; i += n) add(to_f(xr[i]), s, ss);
  }
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Sum of a and b over the block; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  warp_sum2(a, b);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.f;
    b = lane < kWarps ? sb[lane] : 0.f;
    warp_sum2(a, b);
  }
}

// The GroupNorm fold of one channel from its group's sums gs, gss over n elements.
__device__ __forceinline__ void fold(float gs, float gss, float n, float gamma, float beta,
                                     float eps, float& a, float& off) {
  const float mean = __fdiv_rn(gs, n);
  const float meansq = __fdiv_rn(gss, n);
  const float var = fmaxf(__fsub_rn(meansq, __fmul_rn(mean, mean)), 0.f);
  a = __fmul_rn(__frsqrt_rn(__fadd_rn(var, eps)), gamma);
  off = __fsub_rn(beta, __fmul_rn(mean, a));
}

// Short rows. grid ceil(rows / R), kThreads: the block owns rows
// [blockIdx.x * R, + R), whole groups of cg rows; warp w sums rows w, w + 8, ...
// out [2, rows]: without weight the sums and sums of squares; with weight
// (and R * 2 floats of dynamic shared memory) the folded a and off.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_rows_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows, long long S,
                  int R, int vec, const float* __restrict__ weight, const float* __restrict__ bias,
                  int C, int cg, float eps) {
  extern __shared__ float row_sums[];  // [2][R], folding only
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * R;
  for (int k = warp; k < R && r0 + k < rows; k += kWarps) {
    const long long row = r0 + k;
    float s = 0.f, ss = 0.f;
    sum_range<T, 4>(x + row * S, 0, S, lane, 32, vec, s, ss);
    warp_sum2(s, ss);
    if (lane == 0) {
      if (weight == nullptr) {
        out[row] = s;
        out[rows + row] = ss;
      } else {
        row_sums[k] = s;
        row_sums[R + k] = ss;
      }
    }
  }
  if (weight == nullptr) return;
  __syncthreads();
  const float n = (float)((double)S * cg);
  for (int k = threadIdx.x; k < R && r0 + k < rows; k += kThreads) {
    const int g0 = k - k % cg;
    float gs = 0.f, gss = 0.f;
    for (int j = 0; j < cg; ++j) {
      gs += row_sums[g0 + j];
      gss += row_sums[R + g0 + j];
    }
    const long long row = r0 + k;
    const int c = (int)(row % C);
    fold(gs, gss, n, weight[c], bias[c], eps, out[row], out[rows + row]);
  }
}

// Long rows. grid (rows, splits): block (r, j) sums x[r, j*chunk : min(S, (j+1)*chunk)].
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
  float s = 0.f, ss = 0.f;
  sum_range<T, 8>(x + row * S, begin, end, threadIdx.x, kThreads, vec, s, ss);
  block_sum2(s, ss);
  if (threadIdx.x == 0) {
    const long long rows = gridDim.x;
    part[row * splits + split] = s;
    part[rows * splits + row * splits + split] = ss;
  }
}

// One thread a group of cg rows (cg = 1 without weight): add each row's
// partials in order; write the sums, or fold the group into a and off.
__global__ void stats_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      long long rows, int splits, long long S,
                                      const float* __restrict__ weight,
                                      const float* __restrict__ bias, int C, int cg, float eps) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g * cg >= rows) return;
  float gs = 0.f, gss = 0.f;
  for (int j = 0; j < cg; ++j) {
    const long long r = g * cg + j;
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < splits; ++k) {
      s += part[r * splits + k];
      ss += part[rows * splits + r * splits + k];
    }
    if (weight == nullptr) {
      out[r] = s;
      out[rows + r] = ss;
    }
    gs += s;
    gss += ss;
  }
  if (weight == nullptr) return;
  const float n = (float)((double)S * cg);
  for (int j = 0; j < cg; ++j) {
    const long long r = g * cg + j;
    const int c = (int)(r % C);
    fold(gs, gss, n, weight[c], bias[c], eps, out[r], out[rows + r]);
  }
}

template <typename T>
cudaError_t launch_stats(const T* x, long long rows, long long S, int splits, long long chunk,
                         int rows_per_block, int vec, float* part, float* out, const float* weight,
                         const float* bias, int C, int cg, float eps, cudaStream_t st) {
  if (splits == 1) {
    const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
    const size_t smem = weight == nullptr ? 0 : 2 * rows_per_block * sizeof(float);
    stats_rows_kernel<T><<<blocks, kThreads, smem, st>>>(x, out, rows, S, rows_per_block, vec,
                                                         weight, bias, C, cg, eps);
    return cudaGetLastError();
  }
  stats_partial_kernel<T><<<dim3((unsigned)rows, (unsigned)splits), kThreads, 0, st>>>(
      x, part, S, chunk, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int group = weight == nullptr ? 1 : cg;
  const long long threads = rows / group;
  stats_finalize_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      part, out, rows, splits, S, weight, bias, C, group, eps);
  return cudaGetLastError();
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

// v rounded to T and widened back, exactly.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename Tmid>
__device__ __forceinline__ int quantize_q8(float x, float a, float off, float u, int act) {
  const float y = round_to<Tmid>(activate(__fadd_rn(__fmul_rn(x, a), off), act));
  return (int)fminf(fmaxf(rintf(__fdiv_rn(y, u)), -127.f), 127.f);
}

// grid (B*C, splits): block (r, j) quantizes x[r, j*chunk : ...] into q with
// the fold a[r], off[r] and channel r % C's scale u.
template <typename Tin, typename Tmid>
__global__ void __launch_bounds__(kThreads)
apply_q8_kernel(const Tin* __restrict__ x, int8_t* __restrict__ q, const float* __restrict__ a,
                const float* __restrict__ off, const float* __restrict__ u, int C, long long S,
                long long chunk, int act, int vec) {
  const long long row = blockIdx.x;
  const float ra = a[row], roff = off[row], ru = u[row % C];
  const long long begin = (long long)blockIdx.y * chunk;
  const long long end = min(S, begin + chunk);
  const Tin* xr = x + row * S;
  int8_t* qr = q + row * S;
  if (vec) {
    for (long long i = begin + 4LL * threadIdx.x; i < end; i += 4LL * kThreads) {
      float v[4];
      load4(xr + i, v);
      unsigned packed = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        packed |= (unsigned)(quantize_q8<Tmid>(v[k], ra, roff, ru, act) & 0xff)
                  << (8 * k);
      }
      *reinterpret_cast<unsigned*>(qr + i) = packed;
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      qr[i] = (int8_t)quantize_q8<Tmid>(to_f(xr[i]), ra, roff, ru, act);
    }
  }
}

template <typename Tin>
cudaError_t launch_apply_q8(const void* x, int mid_dtype, void* q, const float* a,
                            const float* off, const float* u, long long rows, int C, long long S,
                            int splits, long long chunk, int act, int vec, cudaStream_t st) {
  const dim3 grid((unsigned)rows, (unsigned)splits);
  if (mid_dtype == 0) {
    apply_q8_kernel<Tin, float><<<grid, kThreads, 0, st>>>((const Tin*)x, (int8_t*)q, a, off, u,
                                                           C, S, chunk, act, vec);
  } else if (mid_dtype == 1) {
    apply_q8_kernel<Tin, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const Tin*)x, (int8_t*)q, a, off, u, C, S, chunk, act, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

// x [rows, S] (rows = B * C) -> out [2, rows] fp32: with weight == NULL the
// sums and sums of squares of each row; else the GroupNorm fold a and off of
// each channel (groups of cg consecutive rows, weight and bias [C]). splits
// == 1: one launch, rows_per_block rows (whole groups) a block; else part is
// scratch of 2 * rows * splits floats and a finalize launch follows.
extern "C" int gn_channel_sums(const void* x, int dtype, long long rows, long long S, int splits,
                               long long chunk, int rows_per_block, int vec, void* part, void* out,
                               const void* weight, const void* bias, int C, int cg, float eps,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* w = (const float*)weight;
  const float* b = (const float*)bias;
  if (dtype == 0) {
    return (int)launch_stats((const float*)x, rows, S, splits, chunk, rows_per_block, vec,
                             (float*)part, (float*)out, w, b, C, cg, eps, st);
  }
  if (dtype == 1) {
    return (int)launch_stats((const __nv_bfloat16*)x, rows, S, splits, chunk, rows_per_block, vec,
                             (float*)part, (float*)out, w, b, C, cg, eps, st);
  }
  return (int)cudaErrorInvalidValue;
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

// q[b, c, :] = clip(rint(mid(act(x[b, c, :] * a[b, c] + off[b, c])) / u[c]), -127, 127) as
// int8, mid the rounding to mid_dtype (0 float32, 1 bfloat16); a, off [B, C]
// and u [C] fp32. vec: S and chunk multiples of 4, x and q 16-byte aligned.
extern "C" int gn_apply_q8(const void* x, int in_dtype, int mid_dtype, void* q, const void* a,
                           const void* off, const void* u, long long rows, int C, long long S,
                           int splits, long long chunk, int act, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* af = (const float*)a;
  const float* of = (const float*)off;
  const float* uf = (const float*)u;
  if (in_dtype == 0) {
    return (int)launch_apply_q8<float>(x, mid_dtype, q, af, of, uf, rows, C, S, splits, chunk,
                                       act, vec, st);
  }
  if (in_dtype == 1) {
    return (int)launch_apply_q8<__nv_bfloat16>(x, mid_dtype, q, af, of, uf, rows, C, S, splits,
                                               chunk, act, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}
