// GroupNorm (+ ReLU) forward for the SipMask head towers.
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/group_norm.py reached by
// _fwd_impl (:124): _stats_kernel (:62) and _apply_kernel (:76). Written in
// CUDA C++ rather than Triton so that both kernels of the port build the same
// way (nvcc into a plain-C library, no Triton at run time).
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 16;  // elements of a slab per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
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
    float* __restrict__ y, int64_t slab, int64_t hw, int S, int G, int Cg,
    float eps, int act) {
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
    const float sc = rstd * gamma[c];
    const float bi = beta[c] - (mean * rstd) * gamma[c];
    float v = xs[e] * sc + bi;
    if (act) v = fmaxf(v, 0.f);
    ys[e] = v;
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
int gn_relu_f32(const void* x, const void* gamma, const void* beta,
                void* partial, void* y, int B, int C, long long hw, int G,
                float eps, int act, void* stream) {
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
      (const float*)partial, (float*)y, slab, hw, S, G, Cg, eps, act);
  return (int)cudaGetLastError();
}

const char* gn_relu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
