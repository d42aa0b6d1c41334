// GroupNorm (+ ReLU) forward and backward for the SipMask head towers.
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/group_norm.py reached by
// _fwd_impl (:124): _stats_kernel (:62) and _apply_kernel (:76); and, for
// the backward (K4b), _vjp_bwd (:174): _bwd_reduce_kernel (:84), the (B, C)
// coefficient algebra between its kernels, and _bwd_apply_kernel (:105).
// Written in CUDA C++ rather than Triton so that every kernel of the port
// builds the same way (nvcc into a plain-C library, no Triton at run time).
//
// Semantics: layers._gn_fwd_impl (sipmask_tpu/models/layers.py:138-153):
// per-(image, group) sums of x and x*x in f32, mean = s1/n, the single-pass
// variance s2/n - mean^2, rstd = rsqrt(var + eps), then one per-channel
// affine y = fmaf(x, sc, bi) with sc = rstd*gamma and bi = beta -
// mean*rstd*gamma (group_norm.py:_affine), and an optional ReLU whose mask
// is that fmaf's sign. The backward: dx = a*dy_eff + b2*x + c2 per (image,
// channel), dy_eff = dy where the recomputed pre-ReLU value is positive,
// with (a, b2, c2) from r = (sum dy_eff, sum dy_eff*x) of the group's
// channels in the rounding-spelled order of ops/gn_relu.py:
// _bwd_coefficients; d weight and d bias sum over the images in order.
// Every sum runs in a fixed order (no float atomics), so a call gives the
// same bits twice.
//
// Element types: f32, or bf16 x, y, dy and dx (gn_relu_bf16,
// gn_relu_bwd_bf16: the JAX package's compute_dtype="bfloat16" graph, whose
// group_norm.py:81,154 and :112,221-225 keep f32 sums and statistics and
// return x's dtype). Every sum, statistic, affine and coefficient is f32
// either way, and d weight and d bias stay f32; bf16 values are widened as
// they are loaded and rounded to nearest even once as they are stored.
//
// Layout: x and y (B, C, H, W) contiguous. In NCHW the Cg*H*W elements
// of one (image, group) are contiguous, so a group is a flat slab and the
// TPU's lane tiling (C % 128, whole groups per 128-lane block) has no
// counterpart here.
//
// What bounds it on an H100: bytes. The forward must read x once and write
// y once (4 bytes an element in bf16), the backward read x and dy once and
// write dx once (6), with a few flops an element; and at the small FPN
// levels (P5-P7: 0.3-4 MB a call) a launch and one round trip to memory.
//
// bf16, one pass a call (gn_fwd_cluster_kernel, gn_bwd_cluster_kernel):
// a thread-block cluster of K CTAs holds one (image, group) slab on chip,
// so that nothing is read twice and a call is one launch:
//   - K (1, 2, 4 or 8: portable) and the threads a CTA follow from the
//     slab's size and the call's slab count (one_plan): the smallest K at
//     which CTAs of at most kTarget threads hold the share and the call
//     has kMinCtas CTAs (two an SM); a thread holds 4 vectors while
//     kTarget threads suffice, else up to kHeld (8): the small levels are
//     bound by each CTA's chain of round trips, so they take more, smaller
//     CTAs and threads;
//   - each CTA loads its contiguous share of the slab at once, 16-byte
//     vectors of 8 bf16 (8-byte or single elements where the slab or a
//     pointer is not aligned for them): the forward into registers, the
//     backward (x and dy, which spilled from registers) into shared memory
//     with TMA bulk copies on one mbarrier; a vector that straddles two
//     channels is split where the affine changes;
//   - the forward sums (s1, s2), each CTA writes its pair to its shared
//     memory, and after a cluster barrier warp 0 reads the K pairs through
//     distributed shared memory (a lane a rank, summed in rank order),
//     forms (mean, rstd) as the two-pass kernel does and every channel's
//     affine from gamma and beta staged at the start; every CTA applies it
//     and the ReLU to the values it holds; rank 0 writes the statistics;
//   - the backward sums (r1, r2) of each channel the share touches (one
//     warp reduction a channel, then the warps in order), folds them
//     across the cluster the same way, forms (a, b2, c2) of every channel
//     of the group with the two-pass kernel's rounding-spelled code and
//     writes dx from the values it holds; rank 0 writes r, and the last
//     cluster of a group to arrive (a per-group arrival counter, which
//     that cluster resets to 0, so no zeroing launch is needed) folds d
//     weight and d bias over the images in order before its apply;
//   - a cluster barrier split into arrive and wait keeps a CTA's shared
//     memory alive until its peers have read it, without stalling the
//     apply.
// HBM traffic is then the bound's: 4 bytes an element forward, 6 backward.
// Budget: a thread holds at most kHeld 16-byte vectors of each tensor it
// holds, a CTA at most kFwdMaxThreads / kBwdMaxThreads threads: 128 KB of
// held data a CTA (the forward's registers: 32 of a thread's 64; the
// backward's dynamic shared memory). A slab past that (over 8 * 1024 * 8
// vectors forward, 8 * 512 * 8 backward, or Cg > kMaxOneCg) takes the
// two-pass kernels below, by a rule on the shape (ops/gn_relu.py:
// gn_schedule mirrors it). kFwdSmem and kBwdSmem choose where a CTA holds
// its shares (tools/k4a_probe.py times both).
//
// f32, and bf16 slabs past a cluster's capacity: two passes, two launches.
// The forward:
//   - pass 1 cuts each slab into chunks of kChunk elements, one block each
//     with all its loads in flight at once, and writes one (s1, s2) partial
//     per chunk: thousands of blocks at the tower shapes instead of one per
//     group;
//   - pass 2 runs on the same chunks; each block first folds its group's
//     partials in a fixed order, then applies the affine and the ReLU; each
//     thread loads its elements of the chunk before the fold, so the two
//     round trips overlap, and forms the channel and its (sc, bi) only
//     where its elements cross into the next channel, not once an element;
//   - pass 2 walks the slabs in the reverse of pass 1's order, so that its
//     first reads find what pass 1 read last still in L2;
//   - both passes read 16-byte vectors (f32) or 8-byte ones (bf16) where
//     Cg*hw % 4 == 0, and pass 2 splits the rare vector that straddles two
//     channels;
//   - the partials and the statistics share one scratch that the caller
//     allocates (the entry checks its size).
// The backward (20 bytes an element in f32 against the bound's 12):
//   - pass 1 gives each (image, channel) slab one block (a channel, not a
//     group, is the unit the coefficients need), so its sums need no second
//     fold;
//   - pass 2 streams chunks like the forward; each block first forms its
//     channel's coefficients from its group's Cg sums (a few dozen flops),
//     and designated blocks write d weight and d bias;
//   - both passes read vectors of 4 elements where hw % 4 == 0 (P3, P4).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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
template <>
struct Pack<__nv_bfloat16, 8> {   // 16 bytes: elements 2i, 2i+1 in word i
  using T = uint4;
  __device__ static void get(const T& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static T put(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
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
__device__ __forceinline__ float sdx_of(float r1, float r2, float mean,
                                        float rstd) {
  return __fmul_rn(__fsub_rn(r2, __fmul_rn(mean, r1)), rstd);
}
__device__ __forceinline__ float sdx_of(const float* r, int64_t bc,
                                        float mean, float rstd) {
  return sdx_of(r[bc * 2], r[bc * 2 + 1], mean, rstd);
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

// ---- bf16, one pass: a cluster of K CTAs per (image, group) slab

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kHeld = 8;             // vectors a thread holds of a tensor
constexpr int kTarget = 256;         // threads a CTA that K aims at
constexpr int kMinThreads = 128;
constexpr int kMinCtas = 256;        // two CTAs for each of the 132 SMs
constexpr int kMaxCluster = 8;       // portable cluster sizes only
constexpr int kFwdMaxThreads = 1024;
constexpr int kBwdMaxThreads = 512;
constexpr int kMaxOneCg = 64;        // channels a group (per-channel sums)
// Where a CTA holds its shares of 16-byte vectors: in registers (false),
// or in shared memory filled by TMA bulk copies (true). The backward holds
// x and dy, which in registers spilled (tools/k4a_probe.py: `smem` flips
// the forward, `regs` the backward).
constexpr bool kFwdSmem = false;
constexpr bool kBwdSmem = true;
constexpr uint32_t kBulkBytes = 32768;   // bytes a bulk copy
// staged bytes at most (128 KB), and each warp's sums of up to
// kMaxOneCg channels
constexpr int kMaxStaged = kBwdMaxThreads * kHeld * 16 * 2 +
                           kBwdMaxThreads / 32 * kMaxOneCg * 8;

// How a one-pass call cuts `slabs` slabs of nvec vectors each: one (may it
// take the cluster kernels), K CTAs a cluster, T threads a CTA, per vectors
// a CTA (the last CTA's share may be shorter). K is the smallest that
// holds a share in kTarget threads and gives the card kMinCtas CTAs; a
// thread holds half of kHeld while the share allows (more threads at the
// small levels, where a CTA's chain of round trips bounds the call).
// ops/gn_relu.py:_one_plan is the same rule.
struct OnePlan {
  bool one;
  int K, T;
  long long per;
};

OnePlan one_plan(long long nvec, long long slabs, int Cg, bool backward) {
  const long long cap = (long long)kHeld * kTarget;
  int K = 1;
  while (K < kMaxCluster &&
         ((nvec + K - 1) / K > cap || slabs * K < kMinCtas))
    K *= 2;
  const long long per = (nvec + K - 1) / K;
  // kHeld / 2 vectors a thread where kTarget threads then suffice, else up
  // to kHeld
  long long t = ((per + kHeld / 2 - 1) / (kHeld / 2) + 31) / 32 * 32;
  if (t > kTarget) t = ((per + kHeld - 1) / kHeld + 31) / 32 * 32;
  if (t < kMinThreads) t = kMinThreads;
  const bool one = nvec > 0 && Cg <= kMaxOneCg &&
                   t <= (backward ? kBwdMaxThreads : kFwdMaxThreads);
  return {one, K, (int)t, per};
}

// The elements of a one-pass vector: 8 (16 bytes) where the slab and every
// pointer allow it, else 4 (8 bytes), else 1.
int one_vec(long long slab, uintptr_t ptrs) {
  if (slab % 8 == 0 && ptrs % 16 == 0) return 8;
  if (slab % 4 == 0 && ptrs % 8 == 0) return 4;
  return 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A thread's kHeld vectors of one tensor's share (those at t + i*T): in
// registers, or (S) read from the share staged in shared memory.
template <typename T, bool S>
struct Held {
  T v[kHeld];
  const T* sm;
  __device__ __forceinline__ T operator[](int i) const {
    if constexpr (S)
      return sm[threadIdx.x + i * blockDim.x];
    else
      return v[i];
  }
  // the share src[0, n), every load at once (S: already staged at staged)
  __device__ __forceinline__ void hold(const T* __restrict__ src, int n,
                                      const T* staged) {
    if constexpr (S) {
      sm = staged;
    } else {
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int e = threadIdx.x + i * blockDim.x;
        v[i] = e < n ? src[e] : T{};
      }
    }
  }
};

// S only: thread 0 copies N shares of `bytes` each (srcs) into shared
// memory at dst, one after another, with bulk copies that complete on one
// mbarrier; every thread waits for them.
template <int N>
__device__ __forceinline__ void stage(uint4* dst,
                                      const void* const (&srcs)[N],
                                      uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(N * bytes)
        : "memory");
    const uint32_t d = smem_u32(dst);
    for (int k = 0; k < N; ++k)
      for (uint32_t o = 0; o < bytes; o += kBulkBytes)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(d + k * bytes + o),
            "l"(static_cast<const char*>(srcs[k]) + o),
            "r"(bytes - o < kBulkBytes ? bytes - o : kBulkBytes), "r"(b)
            : "memory");
  }
  __syncthreads();
  uint32_t done = 0, polls = 0;
  while (!done) {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// Once per process: let a kernel that stages take kMaxStaged bytes of
// dynamic shared memory.
template <typename K>
cudaError_t allow_staging(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStaged);
  done = err == cudaSuccess;
  return err;
}

// (a, b) summed over the block in a fixed order (warps of 32, then the
// warps in order); the totals land in thread 0. sh: 32 pairs.
__device__ __forceinline__ void block_sum_pair(float& a, float& b,
                                               float2* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) sh[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (int)(blockDim.x >> 5);
    a = warp_sum(live ? sh[lane].x : 0.f);
    b = warp_sum(live ? sh[lane].y : 0.f);
  }
}

// In warp 0: the K ranks' pairs at the same offset of `own` (this CTA's
// shared memory) summed in rank order; the totals land in lane 0. Each
// lane k < K reads rank k's pair, so the K reads overlap.
__device__ __forceinline__ float2 cluster_sum(const cg::cluster_group& cl,
                                              float2* own, int K) {
  const int lane = threadIdx.x & 31;
  float2 p = make_float2(0.f, 0.f);
  if (lane < K) p = *cl.map_shared_rank(own, lane);
  float a = 0.f, b = 0.f;
  for (int k = 0; k < K; ++k) {
    a += __shfl_sync(0xffffffffu, p.x, k);
    b += __shfl_sync(0xffffffffu, p.y, k);
  }
  return make_float2(a, b);
}

// The per-channel values of a thread's vectors, read from shared memory
// (channel j's at [j]) only where its vectors cross into the next channel.
struct ChannelOf {
  int next = 0, j = -1;
  __device__ __forceinline__ bool at(int q, int hw) {
    if (q < next) return false;
    j = q / hw;
    next = (j + 1) * hw;
    return true;
  }
};

// grid (K * B * G), clusters of K: CTA rank of cluster bg holds vectors
// [rank * per, (rank + 1) * per) of slab bg (VEC elements each).
template <int VEC>
__global__ void __launch_bounds__(kFwdMaxThreads) gn_fwd_cluster_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ y,
    float* __restrict__ stats, int K, int slab, int hw, int G, int Cg,
    int per, float eps, int act) {
  using L = Pack<bf16, VEC>;
  using T = typename L::T;
  constexpr bool S = kFwdSmem && VEC == 8;
  extern __shared__ uint4 staged[];
  __shared__ float2 part, sh[32], gb[kMaxOneCg], aff[kMaxOneCg];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int64_t bg = blockIdx.x / K;
  const int c0 = (int)(bg % G) * Cg;
  const int nvec = slab / VEC;
  const int lo = rank * per;
  const int n = lo < nvec ? min(per, nvec - lo) : 0;
  const T* xs = reinterpret_cast<const T*>(x + bg * slab) + lo;
  if (t < Cg) gb[t] = make_float2(gamma[c0 + t], beta[c0 + t]);
  if constexpr (S) {
    const void* const srcs[1] = {xs};
    if (n > 0) stage<1>(staged, srcs, (uint32_t)n * 16, &bar);
  }
  Held<T, S> v;
  v.hold(xs, n, reinterpret_cast<const T*>(staged));
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    if (t + i * (int)blockDim.x >= n) break;
    float f[VEC];
    L::get(v[i], f);
    if constexpr (VEC == 1) {
      s1 += f[0];
      s2 += f[0] * f[0];
    } else {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        a += (f[k] + f[k + 1]) + (f[k + 2] + f[k + 3]);
        b += (f[k] * f[k] + f[k + 1] * f[k + 1]) +
             (f[k + 2] * f[k + 2] + f[k + 3] * f[k + 3]);
      }
      s1 += a;
      s2 += b;
    }
  }
  block_sum_pair(s1, s2, sh);
  if (t == 0) part = make_float2(s1, s2);
  cluster.sync();
  if (t < 32) {
    const float2 tot = cluster_sum(cluster, &part, K);
    if (t == 0) {
      const float nf = (float)slab;
      const float mean = tot.x / nf;
      const float var = tot.y / nf - mean * mean;
      const float rstd = rsqrtf(var + eps);
      if (stats != nullptr && rank == 0) {   // for the backward
        stats[bg * 2] = mean;
        stats[bg * 2 + 1] = rstd;
      }
      for (int j = 0; j < Cg; ++j) {
        float sc, bi;
        affine(mean, rstd, gb[j].x, gb[j].y, sc, bi);
        aff[j] = make_float2(sc, bi);
      }
    }
  }
  __syncthreads();
  cluster_arrive();   // this CTA reads no peer's shared memory any more
  T* ys = reinterpret_cast<T*>(y + bg * slab) + lo;
  ChannelOf ch;
  float sc = 0.f, bi = 0.f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int e = t + i * blockDim.x;
    if (e >= n) break;
    const int q = (lo + e) * VEC;   // its first element
    if (ch.at(q, hw)) sc = aff[ch.j].x, bi = aff[ch.j].y;
    float in[VEC], o[VEC];
    L::get(v[i], in);
    if (q + VEC - 1 < ch.next) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = fmaf(in[k], sc, bi);
    } else {   // the vector straddles channels (hw % VEC != 0)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (ch.at(q + k, hw)) sc = aff[ch.j].x, bi = aff[ch.j].y;
        o[k] = fmaf(in[k], sc, bi);
      }
    }
    if (act) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = fmaxf(o[k], 0.f);
    }
    ys[e] = L::put(o);
  }
  __syncwarp();
  cluster_wait();     // no peer reads this CTA's shared memory any more
}

// grid (K * B * G), clusters of K, as gn_fwd_cluster_kernel. arrivals: G
// counters, 0 at the launch and again at its end.
template <int VEC>
__global__ void __launch_bounds__(kBwdMaxThreads) gn_bwd_cluster_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ r,
    bf16* __restrict__ dx, float* __restrict__ dweight,
    float* __restrict__ dbias, unsigned* __restrict__ arrivals, int K, int hw,
    int B, int C, int G, int per, int nchmax, int act) {
  using L = Pack<bf16, VEC>;
  using T = typename L::T;
  constexpr bool S = kBwdSmem && VEC == 8;
  // dynamic: the staged shares (S), then each warp's sums of the nchmax
  // channels a share touches at most
  extern __shared__ uint4 staged[];
  __shared__ float2 part[kMaxOneCg], rsum[kMaxOneCg], aff[kMaxOneCg];
  __shared__ float4 co[kMaxOneCg];
  __shared__ float gam[kMaxOneCg], mm[2];
  __shared__ int last;
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t bg = blockIdx.x / K;
  const int b = (int)(bg / G), g = (int)(bg % G);
  const int Cg = C / G, c0 = g * Cg, slab = Cg * hw;
  const int nvec = slab / VEC;
  const int lo = rank * per;
  const int n = lo < nvec ? min(per, nvec - lo) : 0;
  const T* xs = reinterpret_cast<const T*>(x + bg * slab) + lo;
  const T* ds = reinterpret_cast<const T*>(dy + bg * slab) + lo;
  const float mean = stats[bg * 2], rstd = stats[bg * 2 + 1];
  if (t < Cg) {
    float sc, bi;
    gam[t] = gamma[c0 + t];
    affine(mean, rstd, gam[t], beta[c0 + t], sc, bi);
    aff[t] = make_float2(sc, bi);
  }
  if constexpr (S) {
    const void* const srcs[2] = {xs, ds};
    if (n > 0) stage<2>(staged, srcs, (uint32_t)n * 16, &bar);
  }
  Held<T, S> v, d;
  v.hold(xs, n, reinterpret_cast<const T*>(staged));
  d.hold(ds, n, reinterpret_cast<const T*>(staged) + n);
  float2* wsum = reinterpret_cast<float2*>(staged + (S ? 2 * per : 0));
  __syncthreads();
  // (r1, r2) of each channel the share touches: each warp's sums
  const int j_lo = n > 0 ? lo * VEC / hw : 0;
  const int nch = n > 0 ? ((lo + n) * VEC - 1) / hw - j_lo + 1 : 0;
  for (int jj = 0; jj < nch; ++jj) {
    const int cb = (j_lo + jj) * hw, ce = cb + hw;
    const float sc = aff[j_lo + jj].x, bi = aff[j_lo + jj].y;
    float r1 = 0.f, r2 = 0.f;
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int e = t + i * blockDim.x;
      if (e >= n) break;
      const int q = (lo + e) * VEC;
      if (q + VEC <= cb || q >= ce) continue;
      float xv[VEC], dv[VEC];
      L::get(v[i], xv);
      L::get(d[i], dv);
      if (VEC > 1 && q >= cb && q + VEC <= ce) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          dv[k] = gate(dv[k], xv[k], sc, bi, act);
        float a = 0.f, p = 0.f;
#pragma unroll
        for (int k = 0; k + 3 < VEC; k += 4) {
          a += (dv[k] + dv[k + 1]) + (dv[k + 2] + dv[k + 3]);
          p += (dv[k] * xv[k] + dv[k + 1] * xv[k + 1]) +
               (dv[k + 2] * xv[k + 2] + dv[k + 3] * xv[k + 3]);
        }
        r1 += a;
        r2 += p;
      } else {   // a scalar, or a vector that straddles channels
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (q + k < cb || q + k >= ce) continue;
          const float g1 = gate(dv[k], xv[k], sc, bi, act);
          r1 += g1;
          r2 += g1 * xv[k];
        }
      }
    }
    r1 = warp_sum(r1);
    r2 = warp_sum(r2);
    if (lane == 0) wsum[warp * nchmax + jj] = make_float2(r1, r2);
  }
  __syncthreads();
  if (t < Cg) {   // this CTA's sums of channel t, warps in order (0: none)
    float r1 = 0.f, r2 = 0.f;
    if (t >= j_lo && t < j_lo + nch) {
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        r1 += wsum[w * nchmax + t - j_lo].x;
        r2 += wsum[w * nchmax + t - j_lo].y;
      }
    }
    part[t] = make_float2(r1, r2);
  }
  cluster.sync();
  if (t < Cg) {   // the cluster's sums of channel t, in rank order
    float2 p[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < K) p[k] = cluster.map_shared_rank(part, k)[t];
    float r1 = 0.f, r2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < K) r1 += p[k].x, r2 += p[k].y;
    }
    rsum[t] = make_float2(r1, r2);
  }
  __syncthreads();
  cluster_arrive();   // this CTA reads no peer's shared memory any more
  if (t == 0) {   // gn_bwd_apply_kernel's order and roundings
    const float nf = (float)slab;
    float m1 = 0.f, m2 = 0.f;
    for (int j = 0; j < Cg; ++j) {
      m1 = __fadd_rn(m1, __fmul_rn(gam[j], rsum[j].x));
      m2 = __fadd_rn(m2, __fmul_rn(gam[j],
                                   sdx_of(rsum[j].x, rsum[j].y, mean, rstd)));
    }
    mm[0] = __fdiv_rn(m1, nf);
    mm[1] = __fdiv_rn(m2, nf);
  }
  __syncthreads();
  if (t < Cg) {
    const float m1 = mm[0], m2 = mm[1];
    co[t] = make_float4(
        __fmul_rn(rstd, gam[t]), __fmul_rn(-__fmul_rn(rstd, rstd), m2),
        __fmul_rn(rstd, __fsub_rn(__fmul_rn(__fmul_rn(mean, rstd), m2), m1)),
        0.f);
    if (rank == 0) {   // r, for the fold of d weight and d bias
      r[((int64_t)b * C + c0 + t) * 2] = rsum[t].x;
      r[((int64_t)b * C + c0 + t) * 2 + 1] = rsum[t].y;
      __threadfence();
    }
  }
  __syncthreads();
  if (rank == 0) {
    if (t == 0) last = atomicAdd(arrivals + g, 1u) == (unsigned)(B - 1);
    __syncthreads();
    if (last) {   // every cluster of group g has written its r
      if (t < Cg) {
        __threadfence();
        float dw = 0.f, db = 0.f;
#pragma unroll 4
        for (int i = 0; i < B; ++i) {
          const int64_t ic = (int64_t)i * C + c0 + t;
          const int64_t ig = (int64_t)i * G + g;
          const float r1 = __ldcg(r + ic * 2), r2 = __ldcg(r + ic * 2 + 1);
          dw = __fadd_rn(dw,
                         sdx_of(r1, r2, stats[ig * 2], stats[ig * 2 + 1]));
          db = __fadd_rn(db, r1);
        }
        dweight[c0 + t] = dw;
        dbias[c0 + t] = db;
      }
      if (t == 0) arrivals[g] = 0u;   // for the next call
    }
  }
  T* out = reinterpret_cast<T*>(dx + bg * slab) + lo;
  ChannelOf ch;
  float a = 0.f, b2 = 0.f, c2 = 0.f, sc = 0.f, bi = 0.f;
  auto coefs = [&]() {
    a = co[ch.j].x, b2 = co[ch.j].y, c2 = co[ch.j].z;
    sc = aff[ch.j].x, bi = aff[ch.j].y;
  };
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int e = t + i * blockDim.x;
    if (e >= n) break;
    const int q = (lo + e) * VEC;
    if (ch.at(q, hw)) coefs();
    float xv[VEC], dv[VEC], o[VEC];
    L::get(v[i], xv);
    L::get(d[i], dv);
    if (q + VEC - 1 < ch.next) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o[k] = a * gate(dv[k], xv[k], sc, bi, act) + b2 * xv[k] + c2;
    } else {   // the vector straddles channels (hw % VEC != 0)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (ch.at(q + k, hw)) coefs();
        o[k] = a * gate(dv[k], xv[k], sc, bi, act) + b2 * xv[k] + c2;
      }
    }
    out[e] = L::put(o);
  }
  __syncwarp();
  cluster_wait();     // no peer reads this CTA's shared memory any more
}

// A launch of kernel on grid (K * slabs) in clusters of K, T threads a CTA.
template <typename... P, typename... A>
cudaError_t launch_cluster(void (*kernel)(P...), int K, long long slabs,
                           int T, size_t smem, cudaStream_t st, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K * slabs));
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

int gn_forward_one(const bf16* x, const float* gamma, const float* beta,
                   float* stats, bf16* y, int B, int C, long long hw, int G,
                   float eps, int act, int vec, const OnePlan& p,
                   cudaStream_t st) {
  const int Cg = C / G, slab = (int)(Cg * hw), per = (int)p.per;
  const bool staged = kFwdSmem && vec == 8;
  auto kernel = vec == 8   ? gn_fwd_cluster_kernel<8>
                : vec == 4 ? gn_fwd_cluster_kernel<4>
                           : gn_fwd_cluster_kernel<1>;
  static bool allowed = false;
  if (staged) {
    const cudaError_t err = allow_staging(kernel, allowed);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_cluster(kernel, p.K, (long long)B * G, p.T,
                             staged ? (size_t)p.per * 16 : 0, st, x, gamma,
                             beta, y, stats, p.K, slab, (int)hw, G, Cg, per,
                             eps, act);
}

int gn_backward_one(const bf16* x, const bf16* dy, const float* stats,
                    const float* gamma, const float* beta, float* r,
                    bf16* dx, float* dweight, float* dbias,
                    unsigned* arrivals, int B, int C, long long hw, int G,
                    int act, int vec, const OnePlan& p, cudaStream_t st) {
  const bool staged = kBwdSmem && vec == 8;
  // the channels a share of per vectors touches at most
  const int nchmax = (int)std::min<long long>(
      C / G, (p.per * vec + hw - 1) / hw + 1);
  const size_t smem = (staged ? (size_t)p.per * 16 * 2 : 0) +
                      (size_t)(p.T / 32) * nchmax * sizeof(float2);
  auto kernel = vec == 8   ? gn_bwd_cluster_kernel<8>
                : vec == 4 ? gn_bwd_cluster_kernel<4>
                           : gn_bwd_cluster_kernel<1>;
  static bool allowed = false;
  if (staged) {
    const cudaError_t err = allow_staging(kernel, allowed);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_cluster(kernel, p.K, (long long)B * G, p.T, smem, st, x,
                             dy, stats, gamma, beta, r, dx, dweight, dbias,
                             arrivals, p.K, (int)hw, B, C, G, (int)p.per,
                             nchmax, act);
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
// f32): one launch of the cluster kernel where one_plan allows it, and then
// scratch holds only the statistics (none without keep_stats); else the
// two launches above.
int gn_relu_bf16(const void* x, const void* gamma, const void* beta,
                 void* scratch, long long scratch_floats, void* y, int B,
                 int C, long long hw, int G, float eps, int act,
                 int keep_stats, void* stream) {
  const long long slab = (long long)(C / G) * hw;
  const int vec = one_vec(slab, (uintptr_t)x | (uintptr_t)y);
  const OnePlan p = one_plan(slab / vec, (long long)B * G, C / G, false);
  if (!p.one)
    return gn_forward<bf16>((const bf16*)x, (const float*)gamma,
                            (const float*)beta, (float*)scratch,
                            scratch_floats, (bf16*)y, B, C, hw, G, eps, act,
                            keep_stats, (cudaStream_t)stream);
  if (keep_stats && scratch_floats < (long long)B * G * 2)
    return (int)cudaErrorInvalidValue;
  return gn_forward_one((const bf16*)x, (const float*)gamma,
                        (const float*)beta,
                        keep_stats ? (float*)scratch : nullptr, (bf16*)y, B,
                        C, hw, G, eps, act, vec, p, (cudaStream_t)stream);
}

// The cluster kernels' plan of a call: {one, K, T, per, vec}, for the
// probe (ops/gn_relu.py:gn_schedule mirrors it).
void gn_relu_bf16_plan(long long slab, long long slabs, int Cg,
                       long long ptrs, int backward, long long* out) {
  const int vec = one_vec(slab, (uintptr_t)ptrs);
  const OnePlan p = one_plan(slab / vec, slabs, Cg, backward != 0);
  out[0] = p.one, out[1] = p.K, out[2] = p.T, out[3] = p.per, out[4] = vec;
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
// dbias f32): one launch of the cluster kernel where one_plan allows it,
// else the two launches above. arrivals: G unsigned counters, all 0, which
// the cluster kernel leaves 0 (the caller keeps them from call to call; a
// stream's calls must not overlap).
int gn_relu_bwd_bf16(const void* x, const void* dy, const void* stats,
                     const void* gamma, const void* beta, void* r, void* dx,
                     void* dweight, void* dbias, void* arrivals, int B, int C,
                     long long hw, int G, int act, void* stream) {
  const long long slab = (long long)(C / G) * hw;
  const int vec =
      one_vec(slab, (uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx);
  const OnePlan p = one_plan(slab / vec, (long long)B * G, C / G, true);
  if (!p.one)
    return gn_backward<bf16>((const bf16*)x, (const bf16*)dy,
                             (const float*)stats, (const float*)gamma,
                             (const float*)beta, (float*)r, (bf16*)dx,
                             (float*)dweight, (float*)dbias, B, C, hw, G,
                             act, (cudaStream_t)stream);
  return gn_backward_one((const bf16*)x, (const bf16*)dy, (const float*)stats,
                         (const float*)gamma, (const float*)beta, (float*)r,
                         (bf16*)dx, (float*)dweight, (float*)dbias,
                         (unsigned*)arrivals, B, C, hw, G, act, vec, p,
                         (cudaStream_t)stream);
}

const char* gn_relu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
