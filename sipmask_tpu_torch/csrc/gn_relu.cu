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
// card full:
//   - pass 1 cuts each slab into chunks of kChunk elements, one block each,
//     and writes one (s1, s2) partial per chunk: thousands of blocks at the
//     tower shapes instead of one per group;
//   - pass 2 runs on the same chunks; each block first folds its group's
//     partials in a fixed order (no atomics, so the result is the same on
//     every run), then applies the affine and the ReLU.
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

// grid (S, B*G): block s sums elements [s*kChunk, (s+1)*kChunk) of slab bg.
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(
    const float* __restrict__ x, float* __restrict__ partial, int64_t slab,
    int S) {
  const int64_t bg = blockIdx.y;
  const float* xs = x + bg * slab;
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < slab ? lo + kChunk : slab;
  float s1 = 0.f, s2 = 0.f;
  for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
    const float v = xs[e];
    s1 += v;
    s2 += v * v;
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

// grid (S, B*G), same chunks as gn_stats_kernel.
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ partial,
    float* __restrict__ y, float* __restrict__ stats, int64_t slab,
    int64_t hw, int S, int G, int Cg, float eps, int act) {
  __shared__ float stat[2];
  const int64_t bg = blockIdx.y;
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
      if (stats != nullptr && blockIdx.x == 0) {  // for the backward
        stats[bg * 2] = stat[0];
        stats[bg * 2 + 1] = stat[1];
      }
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const int c0 = (int)(bg % G) * Cg;
  const float* xs = x + bg * slab;
  float* ys = y + bg * slab;
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < slab ? lo + kChunk : slab;
  for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
    const int c = c0 + (int)(e / hw);
    float sc, bi;
    affine(mean, rstd, gamma[c], beta[c], sc, bi);
    float v = fmaf(xs[e], sc, bi);
    if (act) v = fmaxf(v, 0.f);
    ys[e] = v;
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

// Number of (s1, s2) partials per (image, group): the caller allocates
// B*G*S*2 floats of scratch for them.
int gn_relu_num_partials(long long slab) {
  return (int)((slab + kChunk - 1) / kChunk);
}

// Returns the cudaError_t of the first launch that failed (0 on success).
// stats (B*G*2 floats) receives each group's (mean, rstd) unless it is null.
int gn_relu_f32(const void* x, const void* gamma, const void* beta,
                void* partial, void* y, void* stats, int B, int C,
                long long hw, int G, float eps, int act, void* stream) {
  const int Cg = C / G;
  const long long slab = (long long)Cg * hw;
  const int S = gn_relu_num_partials(slab);
  const dim3 grid(S, B * G);
  cudaStream_t st = (cudaStream_t)stream;
  gn_stats_kernel<<<grid, kThreads, 0, st>>>((const float*)x, (float*)partial,
                                             slab, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)gamma, (const float*)beta,
      (const float*)partial, (float*)y, (float*)stats, slab, hw, S, G, Cg,
      eps, act);
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
