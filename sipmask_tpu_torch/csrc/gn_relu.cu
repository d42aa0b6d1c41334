// GroupNorm (+ ReLU) forward and backward for the SipMask head towers.
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/group_norm.py reached by
// _fwd_impl (:124): _stats_kernel (:62) and _apply_kernel (:76). Written in
// CUDA C++ rather than Triton so that both kernels of the port build the same
// way (nvcc into a plain-C library, no Triton at run time).
//
// The backward (K4b) replaces _vjp_bwd (:174): _bwd_reduce_kernel (:84),
// the (B, C) coefficient algebra between its kernels, and
// _bwd_apply_kernel (:105); see the note above block_sum2.
//
// Semantics: layers._gn_fwd_impl (sipmask_tpu/models/layers.py:138-153):
// per-(image, group) sums of x and x*x in f32, mean = s1/n, the single-pass
// variance s2/n - mean^2, rstd = rsqrt(var + eps), then one per-channel
// affine y = x*sc + bi with sc = rstd*gamma and bi = beta - mean*rstd*gamma
// (group_norm.py:_affine), and an optional ReLU.
//
// Element types: f32, or bf16 x, y, dy and dx (gn_relu_bf16,
// gn_relu_bwd_bf16: the JAX package's compute_dtype="bfloat16" graph, whose
// group_norm.py:81,154 and :112,221-225 keep f32 sums and statistics and
// return x's dtype). Every sum, statistic, affine and coefficient is f32
// either way, and d weight and d bias stay f32; bf16 values are widened as
// they are loaded and rounded to nearest even once as they are stored, and
// the backward's ReLU mask is taken from the bf16 x through the f32 affine.
// The kernels are templates on the element type; a bf16 vector is 8 bytes.
//
// Layout: x and y (B, C, H, W) contiguous. In NCHW the Cg*H*W elements
// of one (image, group) are contiguous, so a group is a flat slab and the
// TPU's lane tiling (C % 128, whole groups per 128-lane block) has no
// counterpart here.
//
// What bounds it on an H100: bytes: two reads of x and one write of y, with
// a few flops per element. The design keeps every pass streaming and the
// card full, and a call costs the host one C call:
//   - pass 1 cuts each slab into chunks of kChunk elements, one block each
//     with all its loads in flight at once, and writes one (s1, s2) partial
//     per chunk: thousands of blocks at the tower shapes instead of one per
//     group;
//   - pass 2 runs on the same chunks; each block first folds its group's
//     partials in a fixed order (no atomics, so the result is the same on
//     every run), then applies the affine and the ReLU; each thread loads
//     its elements of the chunk before the fold, so the two round trips
//     overlap, and forms the channel and its (sc, bi) only where its
//     elements cross into the next channel, not once an element;
//   - pass 2 walks the slabs in the reverse of pass 1's order, so that its
//     first reads find what pass 1 read last still in L2 (a P3 call's x,
//     69 MB at batch 4, is larger than the 50 MB L2);
//   - both passes read 16-byte vectors where Cg*hw % 4 == 0 (every tower
//     level), and pass 2 splits the rare vector that straddles two
//     channels;
//   - the partials and the statistics share one scratch that the caller
//     allocates (gn_relu_f32 checks its size).
// The backward's work is bound by bytes too: pass 1 reads x and dy, pass 2
// reads them again and writes dx (20 bytes an element against the bound's
// 12). A call of it was bound by the host instead: the (B, C) coefficient
// algebra between the two kernels took about 15 small PyTorch launches. Now
// a call is two launches with nothing between them:
//   - pass 1 gives each (image, channel) slab one block (a channel, not a
//     group, is the unit the coefficients need), so its sums need no second
//     fold;
//   - pass 2 streams chunks like the forward; each block first forms its
//     channel's coefficients from its group's Cg sums (a few dozen flops),
//     and designated blocks write d weight and d bias;
//   - both passes read 16-byte vectors where hw % 4 == 0 (P3, P4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 16;  // elements of a slab per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The per-channel affine of a group's (mean, rstd): y = fmaf(x, sc, bi).
// Spelled with explicit roundings so that the backward recomputes the
// forward's pre-ReLU values bit for bit.
__device__ __forceinline__ void affine(float mean, float rstd, float gamma,
                                       float beta, float& sc, float& bi) {
  sc = __fmul_rn(rstd, gamma);
  bi = __fsub_rn(beta, __fmul_rn(__fmul_rn(mean, rstd), gamma));
}

// A load of VEC (1 or 4) consecutive elements of type E (f32 or bf16):
// its register type T (float, float4, bf16, or uint2 holding four bf16),
// unpacked to f32 and packed from f32 (bf16 rounds to nearest even).
template <typename E, int VEC>
struct Pack;
template <>
struct Pack<float, 1> {
  using T = float;
  __device__ static void get(const T& v, float (&f)[1]) { f[0] = v; }
  __device__ static T put(const float (&f)[1]) { return f[0]; }
};
template <>
struct Pack<float, 4> {
  using T = float4;
  __device__ static void get(const T& v, float (&f)[4]) {
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static T put(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using T = __nv_bfloat16;
  __device__ static void get(const T& v, float (&f)[1]) {
    f[0] = __bfloat162float(v);
  }
  __device__ static T put(const float (&f)[1]) {
    return __float2bfloat16_rn(f[0]);
  }
};
template <>
struct Pack<__nv_bfloat16, 4> {   // 8 bytes: elements 2i, 2i+1 in word i
  using T = uint2;
  __device__ static void get(const T& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xFFFF0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
  __device__ static T put(const float (&f)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
  }
};
template <int VEC>
constexpr int kLoads = kChunk / kThreads / VEC;   // vectors a thread

// Thread t's vectors of chunk [lo, hi) of a slab, lo / VEC + t + i*kThreads
// for i < N, loaded at once (zero past hi).
template <typename T, int N>
__device__ __forceinline__ void load_chunk(const T* xs, int64_t e0,
                                           int64_t e_end, T (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = e0 + i * kThreads < e_end ? xs[e0 + i * kThreads] : T{};
}

// grid (S, B*G): block s sums elements [s*kChunk, (s+1)*kChunk) of slab bg.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(
    const E* __restrict__ x, float* __restrict__ partial, int64_t slab,
    int S) {
  using L = Pack<E, VEC>;
  const int64_t bg = blockIdx.y;
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < slab ? lo + kChunk : slab;
  typename L::T v[kLoads<VEC>];
  load_chunk(reinterpret_cast<const typename L::T*>(x + bg * slab),
             lo / VEC + threadIdx.x, hi / VEC, v);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kLoads<VEC>; ++i) {
    float f[VEC];
    L::get(v[i], f);
    if constexpr (VEC == 4) {
      s1 += (f[0] + f[1]) + (f[2] + f[3]);
      s2 += (f[0] * f[0] + f[1] * f[1]) + (f[2] * f[2] + f[3] * f[3]);
    } else {
      s1 += f[0];
      s2 += f[0] * f[0];
    }
  }
  __shared__ float sh1[kThreads / 32], sh2[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh1[warp] = s1;
    sh2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kThreads / 32 ? sh1[lane] : 0.f;
    s2 = lane < kThreads / 32 ? sh2[lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      partial[(bg * S + blockIdx.x) * 2] = s1;
      partial[(bg * S + blockIdx.x) * 2 + 1] = s2;
    }
  }
}

// The channel of slab element q and its (sc, bi): formed only where a
// thread's elements cross into the next channel, not once an element.
struct Channel {
  int64_t next = 0;   // first element past the current channel
  float sc = 0.f, bi = 0.f;
  __device__ __forceinline__ void at(int64_t q, int64_t hw, int c0,
                                     float mean, float rstd,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta) {
    if (q < next) return;
    const int64_t j = q / hw;
    next = (j + 1) * hw;
    affine(mean, rstd, gamma[c0 + j], beta[c0 + j], sc, bi);
  }
};

// grid (S, B*G), the chunks of gn_stats_kernel in the reverse order. Each
// thread loads its elements of the chunk before it waits for the group's
// statistics, so that the loads overlap the fold of the partials.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(
    const E* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ partial,
    E* __restrict__ y, float* __restrict__ stats, int64_t slab, int64_t hw,
    int S, int G, int Cg, float eps, int act) {
  using L = Pack<E, VEC>;
  using T = typename L::T;
  __shared__ float stat[2];
  const int64_t bg = gridDim.y - 1 - blockIdx.y;
  const int s = S - 1 - (int)blockIdx.x;
  const int64_t lo = (int64_t)s * kChunk;
  const int64_t hi = lo + kChunk < slab ? lo + kChunk : slab;
  const int64_t e0 = lo / VEC + threadIdx.x, e_end = hi / VEC;
  T v[kLoads<VEC>];
  load_chunk(reinterpret_cast<const T*>(x + bg * slab), e0, e_end, v);
  if (threadIdx.x < 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = threadIdx.x; k < S; k += 32) {
      s1 += partial[(bg * S + k) * 2];
      s2 += partial[(bg * S + k) * 2 + 1];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (threadIdx.x == 0) {
      const float n = (float)slab;
      const float mean = s1 / n;
      const float var = s2 / n - mean * mean;
      stat[0] = mean;
      stat[1] = rsqrtf(var + eps);
      if (stats != nullptr && s == 0) {  // for the backward
        stats[bg * 2] = stat[0];
        stats[bg * 2 + 1] = stat[1];
      }
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const int c0 = (int)(bg % G) * Cg;
  T* ys = reinterpret_cast<T*>(y + bg * slab);
  Channel ch;
#pragma unroll
  for (int i = 0; i < kLoads<VEC>; ++i) {
    const int64_t e = e0 + i * kThreads;
    if (e >= e_end) break;
    const int64_t q = e * VEC;   // its first element
    ch.at(q, hw, c0, mean, rstd, gamma, beta);
    float in[VEC], o[VEC];
    L::get(v[i], in);
    if (q + VEC - 1 < ch.next) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = fmaf(in[k], ch.sc, ch.bi);
    } else {   // the vector straddles channels (hw % 4 != 0)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ch.at(q + k, hw, c0, mean, rstd, gamma, beta);
        o[k] = fmaf(in[k], ch.sc, ch.bi);
      }
    }
    if (act) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = fmaxf(o[k], 0.f);
    }
    ys[e] = L::put(o);
  }
}

// ---- backward (K4b)
//
// dx = a*dy_eff + b2*x + c2 per (image, channel), with dy_eff = dy where the
// forward's pre-ReLU value fmaf(x, sc, bi), recomputed with the forward's own
// arithmetic (affine above), is positive, and 0 elsewhere (with act). The
// coefficients come from r = (sum dy_eff, sum dy_eff*x) of every channel of
// the group and the group's (mean, rstd), as group_norm._vjp_bwd forms them
// between its two kernels. Here pass 2 forms them itself, so one call is
// two launches and nothing else.

// Sums of kThreads per-thread partials (r1, r2) of a block, in a fixed
// order; the totals land in thread 0.
__device__ __forceinline__ void block_sum2(float& r1, float& r2) {
  __shared__ float sh1[kThreads / 32], sh2[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r1 = warp_sum(r1);
  r2 = warp_sum(r2);
  if (lane == 0) {
    sh1[warp] = r1;
    sh2[warp] = r2;
  }
  __syncthreads();
  if (warp == 0) {
    r1 = lane < kThreads / 32 ? sh1[lane] : 0.f;
    r2 = lane < kThreads / 32 ? sh2[lane] : 0.f;
    r1 = warp_sum(r1);
    r2 = warp_sum(r2);
  }
}

// The ReLU gate on dy (with act): 0 where the forward's pre-ReLU value is
// not positive.
__device__ __forceinline__ float gate(float d, float v, float sc, float bi,
                                      int act) {
  return act && !(fmaf(v, sc, bi) > 0.f) ? 0.f : d;
}

// Pass 1, grid (B*C): one block per (image, channel) slab of hw elements,
// summed in a fixed order. VEC = 4 reads vectors of 4 elements
// (hw % 4 == 0).
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) gn_bwd_reduce_kernel(
    const E* __restrict__ x, const E* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ r, int64_t hw, int C,
    int G, int act) {
  using L = Pack<E, VEC>;
  using T = typename L::T;
  const int64_t bc = blockIdx.x;
  const int c = (int)(bc % C);
  const int64_t bg = (bc / C) * G + c / (C / G);
  float sc, bi;
  affine(stats[bg * 2], stats[bg * 2 + 1], gamma[c], beta[c], sc, bi);
  float r1 = 0.f, r2 = 0.f;
  const T* xs = reinterpret_cast<const T*>(x + bc * hw);
  const T* ds = reinterpret_cast<const T*>(dy + bc * hw);
  for (int64_t e = threadIdx.x; e < hw / VEC; e += kThreads) {
    float v[VEC], d[VEC];
    L::get(xs[e], v);
    L::get(ds[e], d);
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = gate(d[k], v[k], sc, bi, act);
    if constexpr (VEC == 4) {
      r1 += (d[0] + d[1]) + (d[2] + d[3]);
      r2 += (d[0] * v[0] + d[1] * v[1]) + (d[2] * v[2] + d[3] * v[3]);
    } else {
      r1 += d[0];
      r2 += d[0] * v[0];
    }
  }
  block_sum2(r1, r2);
  if (threadIdx.x == 0) {
    r[bc * 2] = r1;
    r[bc * 2 + 1] = r2;
  }
}

// sum dy_eff * xhat of one (image, channel): (r2 - mean*r1)*rstd.
__device__ __forceinline__ float sdx_of(const float* r, int64_t bc,
                                        float mean, float rstd) {
  return __fmul_rn(__fsub_rn(r[bc * 2 + 1], __fmul_rn(mean, r[bc * 2])),
                   rstd);
}

// Pass 2, grid (max(1, ceil(hw / kChunk)), B*C). Thread 0 of each block forms
// its channel's (a, b2, c2) from the r of its group's Cg channels, in the
// order of ops/gn_relu.py:_bwd_coefficients and with every rounding spelled
// out (no FMA contraction), so the coefficients are the plain version's bits
// for the same r. Block x = 0 of image 0 also writes the channel's
// d weight = sum_b sdx and d bias = sum_b r1, summed over the images in
// order. Then the block streams its chunk of the slab.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) gn_bwd_apply_kernel(
    const E* __restrict__ x, const E* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ r,
    E* __restrict__ dx, float* __restrict__ dweight,
    float* __restrict__ dbias, int64_t hw, int B, int C, int G, int act) {
  using L = Pack<E, VEC>;
  using T = typename L::T;
  __shared__ float co[3];
  const int64_t bc = blockIdx.y;
  const int b = (int)(bc / C), c = (int)(bc % C);
  const int Cg = C / G;
  const int c0 = c - c % Cg;                  // first channel of the group
  const int64_t bg = (int64_t)b * G + c / Cg;
  const float mean = stats[bg * 2], rstd = stats[bg * 2 + 1];
  if (threadIdx.x == 0) {
    const float n = (float)(hw * Cg);
    float m1 = 0.f, m2 = 0.f;
    for (int j = 0; j < Cg; ++j) {
      const int64_t bj = (int64_t)b * C + c0 + j;
      m1 = __fadd_rn(m1, __fmul_rn(gamma[c0 + j], r[bj * 2]));
      m2 = __fadd_rn(m2, __fmul_rn(gamma[c0 + j], sdx_of(r, bj, mean, rstd)));
    }
    m1 = __fdiv_rn(m1, n);
    m2 = __fdiv_rn(m2, n);
    co[0] = __fmul_rn(rstd, gamma[c]);
    co[1] = __fmul_rn(-__fmul_rn(rstd, rstd), m2);
    co[2] = __fmul_rn(rstd, __fsub_rn(__fmul_rn(__fmul_rn(mean, rstd), m2),
                                      m1));
    if (blockIdx.x == 0 && b == 0) {
      float dw = 0.f, db = 0.f;
      for (int i = 0; i < B; ++i) {
        const int64_t ic = (int64_t)i * C + c;
        const int64_t ig = (int64_t)i * G + c / Cg;
        dw = __fadd_rn(dw, sdx_of(r, ic, stats[ig * 2], stats[ig * 2 + 1]));
        db = __fadd_rn(db, r[ic * 2]);
      }
      dweight[c] = dw;
      dbias[c] = db;
    }
  }
  __syncthreads();
  const float a = co[0], b2 = co[1], c2 = co[2];
  float sc, bi;
  affine(mean, rstd, gamma[c], beta[c], sc, bi);
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < hw ? lo + kChunk : hw;
  const T* xs = reinterpret_cast<const T*>(x + bc * hw);
  const T* ds = reinterpret_cast<const T*>(dy + bc * hw);
  T* out = reinterpret_cast<T*>(dx + bc * hw);
  for (int64_t e = lo / VEC + threadIdx.x; e < hi / VEC; e += kThreads) {
    float v[VEC], d[VEC], o[VEC];
    L::get(xs[e], v);
    L::get(ds[e], d);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o[k] = a * gate(d[k], v[k], sc, bi, act) + b2 * v[k] + c2;
    out[e] = L::put(o);
  }
}

template <typename E>
int gn_forward(const E* x, const float* gamma, const float* beta,
               float* scratch, long long scratch_floats, E* y, int B, int C,
               long long hw, int G, float eps, int act, int keep_stats,
               cudaStream_t st) {
  const int Cg = C / G;
  const long long slab = (long long)Cg * hw;
  const int S = (int)((slab + kChunk - 1) / kChunk);
  const long long n_stats = keep_stats ? (long long)B * G * 2 : 0;
  if (scratch_floats < n_stats + (long long)B * G * S * 2)
    return (int)cudaErrorInvalidValue;
  float* stats = keep_stats ? scratch : nullptr;
  float* partial = scratch + n_stats;
  const dim3 grid(S, B * G);
  // vectors of 4 elements when every slab starts on a vector boundary
  const bool vec = slab % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)y) % (4 * sizeof(E)) == 0;
  if (vec)
    gn_stats_kernel<E, 4><<<grid, kThreads, 0, st>>>(x, partial, slab, S);
  else
    gn_stats_kernel<E, 1><<<grid, kThreads, 0, st>>>(x, partial, slab, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec)
    gn_apply_kernel<E, 4><<<grid, kThreads, 0, st>>>(
        x, gamma, beta, partial, y, stats, slab, hw, S, G, Cg, eps, act);
  else
    gn_apply_kernel<E, 1><<<grid, kThreads, 0, st>>>(
        x, gamma, beta, partial, y, stats, slab, hw, S, G, Cg, eps, act);
  return (int)cudaGetLastError();
}

template <typename E>
int gn_backward(const E* x, const E* dy, const float* stats,
                const float* gamma, const float* beta, float* r, E* dx,
                float* dweight, float* dbias, int B, int C, long long hw,
                int G, int act, cudaStream_t st) {
  // vectors of 4 elements when every slab starts on a vector boundary
  const bool vec = hw % 4 == 0 && ((uintptr_t)x | (uintptr_t)dy |
                                   (uintptr_t)dx) % (4 * sizeof(E)) == 0;
  if (vec)
    gn_bwd_reduce_kernel<E, 4><<<B * C, kThreads, 0, st>>>(
        x, dy, stats, gamma, beta, r, hw, C, G, act);
  else
    gn_bwd_reduce_kernel<E, 1><<<B * C, kThreads, 0, st>>>(
        x, dy, stats, gamma, beta, r, hw, C, G, act);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (hw + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)(chunks > 0 ? chunks : 1), B * C);
  if (vec)
    gn_bwd_apply_kernel<E, 4><<<grid, kThreads, 0, st>>>(
        x, dy, stats, gamma, beta, r, dx, dweight, dbias, hw, B, C, G, act);
  else
    gn_bwd_apply_kernel<E, 1><<<grid, kThreads, 0, st>>>(
        x, dy, stats, gamma, beta, r, dx, dweight, dbias, hw, B, C, G, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4a: y (B, C, H, W) from x in two launches. scratch (scratch_floats
// floats) holds each group's (mean, rstd) in its first B*G*2 floats when
// keep_stats, then B*G*S*2 (s1, s2) partials, S = ceil(Cg*hw / kChunk).
// Returns the cudaError_t of the first launch that failed (0 on success;
// cudaErrorInvalidValue for a scratch too small).
int gn_relu_f32(const void* x, const void* gamma, const void* beta,
                void* scratch, long long scratch_floats, void* y, int B,
                int C, long long hw, int G, float eps, int act,
                int keep_stats, void* stream) {
  return gn_forward<float>((const float*)x, (const float*)gamma,
                           (const float*)beta, (float*)scratch,
                           scratch_floats, (float*)y, B, C, hw, G, eps, act,
                           keep_stats, (cudaStream_t)stream);
}

// The same with x and y bf16 (gamma, beta, the statistics and the sums
// f32).
int gn_relu_bf16(const void* x, const void* gamma, const void* beta,
                 void* scratch, long long scratch_floats, void* y, int B,
                 int C, long long hw, int G, float eps, int act,
                 int keep_stats, void* stream) {
  using bf16 = __nv_bfloat16;
  return gn_forward<bf16>((const bf16*)x, (const float*)gamma,
                          (const float*)beta, (float*)scratch,
                          scratch_floats, (bf16*)y, B, C, hw, G, eps, act,
                          keep_stats, (cudaStream_t)stream);
}

// K4b: dx (B, C, H, W), dweight and dbias (C) of the forward's (mean,
// rstd) per group (stats, B*G*2 floats), in two launches; r (B*C*2 floats)
// is the caller's scratch for the per-(image, channel) sums. Returns the
// cudaError_t of the first launch that failed (0 on success).
int gn_relu_bwd_f32(const void* x, const void* dy, const void* stats,
                    const void* gamma, const void* beta, void* r, void* dx,
                    void* dweight, void* dbias, int B, int C, long long hw,
                    int G, int act, void* stream) {
  return gn_backward<float>((const float*)x, (const float*)dy,
                            (const float*)stats, (const float*)gamma,
                            (const float*)beta, (float*)r, (float*)dx,
                            (float*)dweight, (float*)dbias, B, C, hw, G, act,
                            (cudaStream_t)stream);
}

// The same with x, dy and dx bf16 (stats, gamma, beta, r, dweight and
// dbias f32).
int gn_relu_bwd_bf16(const void* x, const void* dy, const void* stats,
                     const void* gamma, const void* beta, void* r, void* dx,
                     void* dweight, void* dbias, int B, int C, long long hw,
                     int G, int act, void* stream) {
  using bf16 = __nv_bfloat16;
  return gn_backward<bf16>((const bf16*)x, (const bf16*)dy,
                           (const float*)stats, (const float*)gamma,
                           (const float*)beta, (float*)r, (bf16*)dx,
                           (float*)dweight, (float*)dbias, B, C, hw, G, act,
                           (cudaStream_t)stream);
}

const char* gn_relu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
