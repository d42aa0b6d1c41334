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
// Layout: x and y (B, C, H, W) contiguous f32. In NCHW the Cg*H*W elements
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

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// Vectors of VEC floats: float4 when every slab starts on a 16-byte
// boundary and holds whole vectors (Cg*hw % 4 == 0), else float.
template <int VEC>
using VecT = typename std::conditional<VEC == 4, float4, float>::type;
template <int VEC>
constexpr int kLoads = kChunk / kThreads / VEC;   // vectors a thread

// Thread t's vectors of chunk [lo, hi) of a slab, lo / VEC + t + i*kThreads
// for i < N, loaded at once (zero past hi).
template <int VEC, int N>
__device__ __forceinline__ void load_chunk(const VecT<VEC>* xs, int64_t e0,
                                           int64_t e_end,
                                           VecT<VEC> (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = e0 + i * kThreads < e_end ? xs[e0 + i * kThreads] : VecT<VEC>{};
}

// grid (S, B*G): block s sums elements [s*kChunk, (s+1)*kChunk) of slab bg.
template <int VEC>
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(
    const float* __restrict__ x, float* __restrict__ partial, int64_t slab,
    int S) {
  const int64_t bg = blockIdx.y;
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < slab ? lo + kChunk : slab;
  VecT<VEC> v[kLoads<VEC>];
  load_chunk<VEC>(reinterpret_cast<const VecT<VEC>*>(x + bg * slab),
                  lo / VEC + threadIdx.x, hi / VEC, v);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kLoads<VEC>; ++i) {
    if constexpr (VEC == 4) {
      s1 += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      s2 += (v[i].x * v[i].x + v[i].y * v[i].y) +
            (v[i].z * v[i].z + v[i].w * v[i].w);
    } else {
      s1 += v[i];
      s2 += v[i] * v[i];
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
template <int VEC>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ partial,
    float* __restrict__ y, float* __restrict__ stats, int64_t slab,
    int64_t hw, int S, int G, int Cg, float eps, int act) {
  __shared__ float stat[2];
  const int64_t bg = gridDim.y - 1 - blockIdx.y;
  const int s = S - 1 - (int)blockIdx.x;
  const int64_t lo = (int64_t)s * kChunk;
  const int64_t hi = lo + kChunk < slab ? lo + kChunk : slab;
  const int64_t e0 = lo / VEC + threadIdx.x, e_end = hi / VEC;
  VecT<VEC> v[kLoads<VEC>];
  load_chunk<VEC>(reinterpret_cast<const VecT<VEC>*>(x + bg * slab), e0,
                  e_end, v);
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
  VecT<VEC>* ys = reinterpret_cast<VecT<VEC>*>(y + bg * slab);
  Channel ch;
#pragma unroll
  for (int i = 0; i < kLoads<VEC>; ++i) {
    const int64_t e = e0 + i * kThreads;
    if (e >= e_end) break;
    const int64_t q = e * VEC;   // its first element
    ch.at(q, hw, c0, mean, rstd, gamma, beta);
    if constexpr (VEC == 4) {
      float in[4] = {v[i].x, v[i].y, v[i].z, v[i].w}, o[4];
      if (q + 3 < ch.next) {
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = fmaf(in[k], ch.sc, ch.bi);
      } else {   // the vector straddles channels (hw % 4 != 0)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ch.at(q + k, hw, c0, mean, rstd, gamma, beta);
          o[k] = fmaf(in[k], ch.sc, ch.bi);
        }
      }
      if (act) {
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = fmaxf(o[k], 0.f);
      }
      ys[e] = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      const float o = fmaf(v[i], ch.sc, ch.bi);
      ys[e] = act ? fmaxf(o, 0.f) : o;
    }
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
// summed in a fixed order. VEC = 4 reads 16-byte vectors (hw % 4 == 0).
template <int VEC>
__global__ void __launch_bounds__(kThreads) gn_bwd_reduce_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ r, int64_t hw, int C,
    int G, int act) {
  const int64_t bc = blockIdx.x;
  const int c = (int)(bc % C);
  const int64_t bg = (bc / C) * G + c / (C / G);
  float sc, bi;
  affine(stats[bg * 2], stats[bg * 2 + 1], gamma[c], beta[c], sc, bi);
  float r1 = 0.f, r2 = 0.f;
  if (VEC == 4) {
    const float4* xs = reinterpret_cast<const float4*>(x + bc * hw);
    const float4* ds = reinterpret_cast<const float4*>(dy + bc * hw);
    for (int64_t e = threadIdx.x; e < hw / 4; e += kThreads) {
      const float4 v = xs[e], d = ds[e];
      const float d0 = gate(d.x, v.x, sc, bi, act);
      const float d1 = gate(d.y, v.y, sc, bi, act);
      const float d2 = gate(d.z, v.z, sc, bi, act);
      const float d3 = gate(d.w, v.w, sc, bi, act);
      r1 += (d0 + d1) + (d2 + d3);
      r2 += (d0 * v.x + d1 * v.y) + (d2 * v.z + d3 * v.w);
    }
  } else {
    const float* xs = x + bc * hw;
    const float* ds = dy + bc * hw;
    for (int64_t e = threadIdx.x; e < hw; e += kThreads) {
      const float v = xs[e];
      const float d = gate(ds[e], v, sc, bi, act);
      r1 += d;
      r2 += d * v;
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
template <int VEC>
__global__ void __launch_bounds__(kThreads) gn_bwd_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ r,
    float* __restrict__ dx, float* __restrict__ dweight,
    float* __restrict__ dbias, int64_t hw, int B, int C, int G, int act) {
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
  if (VEC == 4) {
    const float4* xs = reinterpret_cast<const float4*>(x + bc * hw);
    const float4* ds = reinterpret_cast<const float4*>(dy + bc * hw);
    float4* out = reinterpret_cast<float4*>(dx + bc * hw);
    for (int64_t e = lo / 4 + threadIdx.x; e < hi / 4; e += kThreads) {
      const float4 v = xs[e], d = ds[e];
      float4 o;
      o.x = a * gate(d.x, v.x, sc, bi, act) + b2 * v.x + c2;
      o.y = a * gate(d.y, v.y, sc, bi, act) + b2 * v.y + c2;
      o.z = a * gate(d.z, v.z, sc, bi, act) + b2 * v.z + c2;
      o.w = a * gate(d.w, v.w, sc, bi, act) + b2 * v.w + c2;
      out[e] = o;
    }
  } else {
    const float* xs = x + bc * hw;
    const float* ds = dy + bc * hw;
    float* out = dx + bc * hw;
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
      const float v = xs[e];
      out[e] = a * gate(ds[e], v, sc, bi, act) + b2 * v + c2;
    }
  }
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
  const int Cg = C / G;
  const long long slab = (long long)Cg * hw;
  const int S = (int)((slab + kChunk - 1) / kChunk);
  const long long n_stats = keep_stats ? (long long)B * G * 2 : 0;
  if (scratch_floats < n_stats + (long long)B * G * S * 2)
    return (int)cudaErrorInvalidValue;
  float* stats = keep_stats ? (float*)scratch : nullptr;
  float* partial = (float*)scratch + n_stats;
  const dim3 grid(S, B * G);
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float *gf = (const float*)gamma, *bf = (const float*)beta;
  // 16-byte vectors when every slab starts on a 16-byte boundary
  const bool vec = slab % 4 == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  if (vec)
    gn_stats_kernel<4><<<grid, kThreads, 0, st>>>(xf, partial, slab, S);
  else
    gn_stats_kernel<1><<<grid, kThreads, 0, st>>>(xf, partial, slab, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec)
    gn_apply_kernel<4><<<grid, kThreads, 0, st>>>(
        xf, gf, bf, partial, (float*)y, stats, slab, hw, S, G, Cg, eps, act);
  else
    gn_apply_kernel<1><<<grid, kThreads, 0, st>>>(
        xf, gf, bf, partial, (float*)y, stats, slab, hw, S, G, Cg, eps, act);
  return (int)cudaGetLastError();
}

// K4b: dx (B, C, H, W), dweight and dbias (C) of the forward's (mean,
// rstd) per group (stats, B*G*2 floats), in two launches; r (B*C*2 floats)
// is the caller's scratch for the per-(image, channel) sums. Returns the
// cudaError_t of the first launch that failed (0 on success).
int gn_relu_bwd_f32(const void* x, const void* dy, const void* stats,
                    const void* gamma, const void* beta, void* r, void* dx,
                    void* dweight, void* dbias, int B, int C, long long hw,
                    int G, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *xf = (const float*)x, *dyf = (const float*)dy;
  const float *sf = (const float*)stats, *gf = (const float*)gamma;
  const float* bf = (const float*)beta;
  // 16-byte vectors when every slab starts on a 16-byte boundary
  const bool vec = hw % 4 == 0 && ((uintptr_t)x | (uintptr_t)dy |
                                   (uintptr_t)dx) % 16 == 0;
  if (vec)
    gn_bwd_reduce_kernel<4><<<B * C, kThreads, 0, st>>>(
        xf, dyf, sf, gf, bf, (float*)r, hw, C, G, act);
  else
    gn_bwd_reduce_kernel<1><<<B * C, kThreads, 0, st>>>(
        xf, dyf, sf, gf, bf, (float*)r, hw, C, G, act);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (hw + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)(chunks > 0 ? chunks : 1), B * C);
  if (vec)
    gn_bwd_apply_kernel<4><<<grid, kThreads, 0, st>>>(
        xf, dyf, sf, gf, bf, (const float*)r, (float*)dx, (float*)dweight,
        (float*)dbias, hw, B, C, G, act);
  else
    gn_bwd_apply_kernel<1><<<grid, kThreads, 0, st>>>(
        xf, dyf, sf, gf, bf, (const float*)r, (float*)dx, (float*)dweight,
        (float*)dbias, hw, B, C, G, act);
  return (int)cudaGetLastError();
}

const char* gn_relu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
