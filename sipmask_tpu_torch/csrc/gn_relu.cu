// GroupNorm (+ ReLU) forward and backward for the SipMask head towers.
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/group_norm.py reached by
// _fwd_impl (:124): _stats_kernel (:62) and _apply_kernel (:76). Written in
// CUDA C++ rather than Triton so that both kernels of the port build the same
// way (nvcc into a plain-C library, no Triton at run time).
//
// The backward (K4b) replaces _vjp_bwd (:174): _bwd_reduce_kernel (:84) and
// _bwd_apply_kernel (:105); see the note above gn_bwd_reduce_kernel.
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
// The backward is bound by bytes too: pass 1 reads x and dy, pass 2 reads
// them again and writes dx. Pass 1 gives each (image, channel) slab one
// block (a channel, not a group, is the unit the coefficients need), so
// its sums need no second fold; pass 2 streams chunks like the forward.

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
// The (B, C) coefficients a, b2, c2 of dx = a*dy_eff + b2*x + c2 come from
// r = (sum dy_eff, sum dy_eff*x) per (image, channel) through a few (B, C)
// tensor ops in the caller, as group_norm._vjp_bwd computes them outside its
// kernels. With act, dy_eff is dy where the forward's pre-ReLU value
// fmaf(x, sc, bi), recomputed here with the forward's own arithmetic, is
// positive, and 0 elsewhere.

// grid (B*C): one block per (image, channel) slab of hw elements, summed in
// a fixed order.
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
  const float* xs = x + bc * hw;
  const float* ds = dy + bc * hw;
  float r1 = 0.f, r2 = 0.f;
  for (int64_t e = threadIdx.x; e < hw; e += kThreads) {
    const float v = xs[e];
    float d = ds[e];
    if (act && !(fmaf(v, sc, bi) > 0.f)) d = 0.f;
    r1 += d;
    r2 += d * v;
  }
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
    if (lane == 0) {
      r[bc * 2] = r1;
      r[bc * 2 + 1] = r2;
    }
  }
}

// grid (ceil(hw / kChunk), B*C): dx = a*dy_eff + b2*x + c2 with co[bc] =
// (a, b2, c2).
__global__ void __launch_bounds__(kThreads) gn_bwd_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ co,
    float* __restrict__ dx, int64_t hw, int C, int G, int act) {
  const int64_t bc = blockIdx.y;
  const int c = (int)(bc % C);
  const int64_t bg = (bc / C) * G + c / (C / G);
  float sc, bi;
  affine(stats[bg * 2], stats[bg * 2 + 1], gamma[c], beta[c], sc, bi);
  const float a = co[bc * 3], b2 = co[bc * 3 + 1], c2 = co[bc * 3 + 2];
  const float* xs = x + bc * hw;
  const float* ds = dy + bc * hw;
  float* out = dx + bc * hw;
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < hw ? lo + kChunk : hw;
  for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
    const float v = xs[e];
    float d = ds[e];
    if (act && !(fmaf(v, sc, bi) > 0.f)) d = 0.f;
    out[e] = a * d + b2 * v + c2;
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

// K4b pass 1: r (B*C*2 floats) = per-(image, channel) (sum dy_eff,
// sum dy_eff*x). stats is the forward's (mean, rstd) per group.
int gn_relu_bwd_reduce_f32(const void* x, const void* dy, const void* stats,
                           const void* gamma, const void* beta, void* r,
                           int B, int C, long long hw, int G, int act,
                           void* stream) {
  gn_bwd_reduce_kernel<<<B * C, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dy, (const float*)stats,
      (const float*)gamma, (const float*)beta, (float*)r, hw, C, G, act);
  return (int)cudaGetLastError();
}

// K4b pass 2: dx (B, C, H, W) from the (B*C*3) coefficients co.
int gn_relu_bwd_apply_f32(const void* x, const void* dy, const void* stats,
                          const void* gamma, const void* beta, const void* co,
                          void* dx, int B, int C, long long hw, int G,
                          int act, void* stream) {
  const dim3 grid((unsigned)((hw + kChunk - 1) / kChunk), B * C);
  gn_bwd_apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dy, (const float*)stats,
      (const float*)gamma, (const float*)beta, (const float*)co, (float*)dx,
      hw, C, G, act);
  return (int)cudaGetLastError();
}

const char* gn_relu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
