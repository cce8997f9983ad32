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
// XLA there), whose only consumer is the int8 conv (csrc/qconv_s8.cu). From
// the fold (a, off) of the statistics pass it writes
//   q = clip(rint(Tmid(act(x * a + off)) / u[c]), -127, 127)   as int8,
// y rounded to the serving dtype Tmid before the division by the k-sigma
// scale u, as use_tpu divides; bit-equal to the plain version (its IEEE
// division, torch's SiLU x / (1 + exp(-x))), for every finite input. It
// writes the conv's operand layout, C32 ([B, ceil(C/32), 2, S, 16]: the 32
// channels of a chunk of one pixel as two 16-byte halves in two pixel-major
// planes), which lets the conv load its windows with TMA a row at a time;
// the transpose from the NCHW input happens here, where it costs no bytes:
// a warp reads 512 contiguous bytes of one channel's row, and a pixel's 32
// channels meet in shared memory. A block takes 32 channels x 256 pixels
// of the flattened (batch, position) axis, so the low levels (8 x 3,
// 32 x 12) are a few blocks, not one a (b, c) row. Both divisions are
// correctly rounded without dividing (a reciprocal and one fused residual
// correction, checked on the card at every input they take: SiLU's at
// every float, the quantize's at every bf16 y for the served nets' scales),
// rint is a float add and the clip integer. Bound: bytes, x read once and
// one byte an element written; on the card it reaches about half of that
// in bf16 (PERF.md): SiLU's exact arithmetic (expf, the reciprocal, the
// correction) is a third of its time, and the rest each block's
// load-compute-store latency, which neither prefetching the next tile, nor
// other warp-to-channel mappings, nor register caps moved.
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

// 1 / d for d in [1, 2^126): the approximate reciprocal and one Newton step
// with fused multiply-adds give the IEEE quotient at every such float (K3's
// reciprocal, csrc/fused_qconv.cu, checked there over all of them).
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.f), r);
}

// SiLU as the plain version computes it, v / (1 + exp(-v)) with an IEEE
// division, without the division's slow path: q = v * (1 / d), then one
// fused correction by the residual v - q d, which is exact, gives the
// correctly rounded quotient where nothing under- or overflows (Markstein).
// silu_fast_ok says where that holds, 2^-100 <= |v| <= 64; elsewhere (and
// for NaN) silu_q8 takes the IEEE division. gn_q8_silu_check holds silu_q8
// against v / d at every float.
__device__ __forceinline__ bool silu_fast_ok(float v) {
  return fabsf(v) >= 0x1p-100f && fabsf(v) <= 64.f;
}
__device__ __forceinline__ float silu_fast(float v) {
  const float d = 1.f + expf(-v);
  const float r = rcp_newton(d);
  const float q = __fmul_rn(v, r);
  return __fmaf_rn(__fmaf_rn(-q, d, v), r, q);
}
__device__ __forceinline__ float silu_q8(float v) {
  return silu_fast_ok(v) ? silu_fast(v) : v / (1.f + expf(-v));
}

// The quantize of one channel: clip(rint(y / u), -127, 127) with the
// quotient correctly rounded but no division: r = 1 / u (rounded to
// nearest: rcp_newton of u's significand, scaled by u's power of two; once
// a channel), q = y * r and one fused residual correction. y is clamped to
// +-128 u first (exact: a power of two times u), beyond which every quotient
// clips, so nothing overflows; where y / u underflows, the quotient rounds
// to 0 either way. rint is an add of 1.5 * 2^23 (round half to even) read
// back as an integer. A u outside [2^-60, 2^60] takes the IEEE division.
// gn_q8_div_check holds it against the plain version's division.
struct QScale {
  float u, r, lim;
  bool fast;
};

__device__ __forceinline__ QScale qscale(float u) {
  const bool fast = u >= 0x1p-60f && u <= 0x1p60f;
  const unsigned bits = __float_as_uint(u);
  const float rm = rcp_newton(__uint_as_float((bits & 0x007fffffu) | 0x3f800000u));
  const unsigned e = (bits >> 23) - 127u;  // u = m 2^e, 1 / u = rm 2^-e, exactly
  return QScale{u, fast ? __uint_as_float(__float_as_uint(rm) - (e << 23)) : 0.f, 128.f * u, fast};
}

// rint(q) for |q| < 2^22, clipped to [-127, 127].
__device__ __forceinline__ int rint_clip(float q) {
  const int i = __float_as_int(__fadd_rn(q, 12582912.f)) - 0x4b400000;
  return min(max(i, -127), 127);
}
__device__ __forceinline__ int quantize_fast(float y, const QScale& s) {
  const float yc = fminf(fmaxf(y, -s.lim), s.lim);
  const float q0 = __fmul_rn(yc, s.r);
  return rint_clip(__fmaf_rn(__fmaf_rn(-q0, s.u, yc), s.r, q0));
}
__device__ __forceinline__ int quantize_slow(float y, const QScale& s) {
  return rint_clip(fminf(fmaxf(__fdiv_rn(y, s.u), -256.f), 256.f));
}
__device__ __forceinline__ int quantize_q8(float y, const QScale& s) {
  return s.fast ? quantize_fast(y, s) : quantize_slow(y, s);
}

// Eight consecutive elements at a 16-byte-aligned address, as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// a bf16 is the high half of the float it widens to, exactly
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// grid (ceil(N / 256), ceil(C / 32)), N = B * S pixels: block (p, k) writes
// channels 32 k .. 32 k + 31 of pixels 256 p .. 256 p + 255 of the flattened
// (b, s) axis into q, C32 ([B, ceil(C / 32), 2, S, 16] int8: two half planes
// of 16 channels a chunk, zeros past C). Warp w takes channels 32 k + 4 w ..
// + 3, lane l the 8 pixels from n0 = 256 p + 8 l: a warp's load is 512
// contiguous bytes of one channel's row (VEC: S a multiple of 8 and x
// 16-byte aligned, so 8 pixels lie in one sample; else one element at a
// time). A thread packs a pixel's 4 channels in a word and leaves its 8
// words in shared memory (a row of 256 words a warp, 16-byte chunks
// XOR-swizzled so that the writes hit distinct banks); after a barrier
// thread t gathers pixel 256 p + t's 8 words (32 channels) and stores a
// 16-byte half to each half plane (a warp's store, 32 pixels, is 512
// contiguous bytes).
template <typename Tin, typename Tmid, bool VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
apply_q8_kernel(const Tin* __restrict__ x, int8_t* __restrict__ q, const float* __restrict__ a,
                const float* __restrict__ off, const float* __restrict__ u, int C, unsigned S,
                unsigned N, int act) {
  __shared__ __align__(16) unsigned words[kWarps][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = blockIdx.y, nk = gridDim.y;
  const unsigned n0 = blockIdx.x * 256u + 8u * lane;
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = 0u;
  unsigned pb[8], ps[8];  // each pixel's sample and position
  if (VEC) {
    const unsigned b = n0 < N ? n0 / S : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pb[k] = b;
      ps[k] = n0 - b * S + k;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // positions past N read as the last one's sample
      const unsigned n = min(n0 + k, N - 1);
      pb[k] = n / S;
      ps[k] = n - pb[k] * S;
    }
  }
  // Every load first, the parameters' too, so that a thread waits for one
  // round trip to memory, not one a channel.
  float v[4][8], ra[4], ro[4], uc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = min(32 * kc + 4 * warp + i, C - 1);  // past C: computed, then dropped
    const long long bc = (long long)pb[0] * C + c;
    ra[i] = a[bc];
    ro[i] = off[bc];
    uc[i] = u[c];
    if (VEC) {
      if (n0 < N) load8(x + bc * S + ps[0], v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[i][k] = n0 + k < N ? to_f(x[((long long)pb[k] * C + c) * S + ps[k]]) : 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 32 * kc + 4 * warp + i;
    if (c >= C || n0 >= N) continue;
    const QScale qs = qscale(uc[i]);
    float y[8];
    bool slow = false;  // some value off SiLU's fast path
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float sa = ra[i], so = ro[i];
      if (!VEC && k > 0 && pb[k] != pb[0]) {  // a row of fewer than 8 positions
        const long long bc = (long long)pb[k] * C + c;
        sa = n0 + k < N ? a[bc] : 0.f;
        so = n0 + k < N ? off[bc] : 0.f;
      }
      y[k] = __fadd_rn(__fmul_rn(v[i][k], sa), so);
      if (SILU) slow |= !silu_fast_ok(y[k]);
    }
    // straight-line over the 8 values (they interleave), then, rarely, all
    // 8 again on the exact path: a choice per value would serialize them
    float z[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) z[k] = SILU ? silu_fast(y[k]) : activate(y[k], act);
    if (SILU && slow) {
#pragma unroll
      for (int k = 0; k < 8; ++k) z[k] = silu_q8(y[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = round_to<Tmid>(z[k]);
    int qv[8];
    if (qs.fast) {
#pragma unroll
      for (int k = 0; k < 8; ++k) qv[k] = quantize_fast(y[k], qs);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) qv[k] = quantize_slow(y[k], qs);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] |= (unsigned)(qv[k] & 0xff) << (8 * i);
  }
  // word of pixel p in 16-byte chunk (p / 4) ^ ((p / 32) % 2) of the row: a
  // quarter warp's 16-byte writes (lanes 8 apart in pixels) fall in 8
  // distinct chunks of 4 banks
  const int sw = (lane >> 2) & 1;
  *reinterpret_cast<uint4*>(&words[warp][4 * ((2 * lane) ^ sw)]) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(&words[warp][4 * ((2 * lane + 1) ^ sw)]) =
      make_uint4(w[4], w[5], w[6], w[7]);
  __syncthreads();
  const int p = threadIdx.x;
  const int at = 4 * ((p >> 2) ^ ((p >> 5) & 1)) + (p & 3);
  const unsigned n = blockIdx.x * 256u + p;
  if (n < N) {  // the pixel's two halves, each in its half plane
    const unsigned b = n / S;
    int8_t* dst = q + ((2ll * ((long long)b * nk + kc)) * S + (n - b * S)) * 16;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(words[0][at], words[1][at], words[2][at], words[3][at]);
    *reinterpret_cast<uint4*>(dst + 16ll * S) =
        make_uint4(words[4][at], words[5][at], words[6][at], words[7][at]);
  }
}

template <typename Tin, typename Tmid, bool VEC>
cudaError_t launch_apply_q8(const void* x, void* q, const float* a, const float* off,
                            const float* u, int B, int C, unsigned S, int act, cudaStream_t st) {
  const unsigned N = (unsigned)B * S;
  const dim3 grid((N + 255) / 256, (unsigned)((C + 31) / 32));
  if (act == 1) {
    apply_q8_kernel<Tin, Tmid, VEC, true><<<grid, kThreads, 0, st>>>(
        (const Tin*)x, (int8_t*)q, a, off, u, C, S, N, act);
  } else {
    apply_q8_kernel<Tin, Tmid, VEC, false><<<grid, kThreads, 0, st>>>(
        (const Tin*)x, (int8_t*)q, a, off, u, C, S, N, act);
  }
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_apply_q8_mid(int mid_dtype, int vec, const void* x, void* q, const float* a,
                                const float* off, const float* u, int B, int C, unsigned S,
                                int act, cudaStream_t st) {
  if (mid_dtype == 0) {
    return vec ? launch_apply_q8<Tin, float, true>(x, q, a, off, u, B, C, S, act, st)
               : launch_apply_q8<Tin, float, false>(x, q, a, off, u, B, C, S, act, st);
  }
  if (mid_dtype == 1) {
    return vec ? launch_apply_q8<Tin, __nv_bfloat16, true>(x, q, a, off, u, B, C, S, act, st)
               : launch_apply_q8<Tin, __nv_bfloat16, false>(x, q, a, off, u, B, C, S, act, st);
  }
  return cudaErrorInvalidValue;
}

// Counts the floats v at which silu_q8(v) is not v / (1 + exp(-v)) bit for
// bit (two NaNs count as equal).
__global__ void silu_check_kernel(unsigned long long* bad) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float v = __uint_as_float((unsigned)i);
    const float got = silu_q8(v), want = v / (1.f + expf(-v));
    if (__float_as_uint(got) != __float_as_uint(want) && !(got != got && want != want)) {
      atomicAdd(bad, 1ull);
    }
  }
}

// Counts, for u[blockIdx.y], the y at which quantize_q8 differs from the
// plain version's clip(rint(y / u), -127, 127) with an IEEE division: bf16,
// all 65,536 bf16 values of y; else every float y with |y| <= 128 u.
__global__ void div_check_kernel(const float* __restrict__ u, int bf16, unsigned long long* bad) {
  const float uj = u[blockIdx.y];
  const QScale qs = qscale(uj);
  const unsigned long long n =
      bf16 ? 65536ull : 2ull * ((unsigned long long)__float_as_uint(128.f * uj) + 1);
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float y = bf16 ? __uint_as_float((unsigned)i << 16)
                         : __uint_as_float((unsigned)(i >> 1) | (unsigned)(i & 1) << 31);
    const int want = (int)fminf(fmaxf(rintf(__fdiv_rn(y, uj)), -127.f), 127.f);
    if (quantize_q8(y, qs) != want) atomicAdd(bad, 1ull);
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

// q = clip(rint(mid(act(x[b, c, s] * a[b, c] + off[b, c])) / u[c]), -127, 127)
// as int8 in C32, q [B, ceil(C / 32), 2, S, 16] (zeros past C), mid the
// rounding to mid_dtype (0 float32, 1 bfloat16); x [B, C, S]; a, off [B, C]
// and u [C] fp32; B * S < 2^31. vec: S a multiple of 8, x 16-byte aligned.
extern "C" int gn_apply_q8(const void* x, int in_dtype, int mid_dtype, void* q, const void* a,
                           const void* off, const void* u, int B, int C, long long S, int act,
                           int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* af = (const float*)a;
  const float* of = (const float*)off;
  const float* uf = (const float*)u;
  if (S <= 0 || (long long)B * S >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (in_dtype == 0) {
    return (int)launch_apply_q8_mid<float>(mid_dtype, vec, x, q, af, of, uf, B, C, (unsigned)S,
                                           act, st);
  }
  if (in_dtype == 1) {
    return (int)launch_apply_q8_mid<__nv_bfloat16>(mid_dtype, vec, x, q, af, of, uf, B, C,
                                                   (unsigned)S, act, st);
  }
  return (int)cudaErrorInvalidValue;
}

// bad: one uint64 on the device, zero on entry; receives the count of the
// floats at which the int8 apply's SiLU differs from the IEEE quotient.
extern "C" int gn_q8_silu_check(void* bad, void* stream) {
  silu_check_kernel<<<4096, 256, 0, (cudaStream_t)stream>>>((unsigned long long*)bad);
  return (int)cudaGetLastError();
}

// u: nu fp32 scales on the device (nu <= 65535); bad as above, the count of
// (u, y) at which the int8 apply's quantize differs from the plain
// version's (bf16: every bf16 y; else every float y with |y| <= 128 u).
extern "C" int gn_q8_div_check(const void* u, int nu, int bf16, void* bad, void* stream) {
  if (nu <= 0 || nu > 65535) return (int)cudaErrorInvalidValue;
  div_check_kernel<<<dim3(bf16 ? 64 : 1024, (unsigned)nu), 256, 0, (cudaStream_t)stream>>>(
      (const float*)u, bf16, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
