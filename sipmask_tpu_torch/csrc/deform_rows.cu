// Deformable bilinear row sampling (p-major) and its backward, for the
// SipMask++ backbone's deformable convolutions (DeformConvPack).
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/deform_gather.py that
// sample_bilinear_rows (:994) dispatches to:
//   forward   _sample_pallas_sep (:288, body _fwd_sep_kernel) and
//             _sample_pallas (:381, body _fwd_kernel), and the dense XLA
//             tiers beside them (sample_dense, _sample_dense_pbwd);
//   backward  _sample_pallas_bwd (:724, bodies _bwd_fused_kernel, or
//             _bwd_dpyx_kernel + _bwd_dx_kernel).
// The TPU built the bilinear gather as banded one-hot (tent) matmuls because
// its gathers are slow; Hopper gathers natively, so one kernel reads the four
// corners and one kernel scatters them back.
//
// Semantics: sample_ref (deform_gather.py:99-130) and its autodiff. Corners
// are floor(p) and floor(p)+1; a corner outside [0, H-1] x [0, W-1] adds 0;
// weights are f32 products of (1 - frac) and frac. The position derivative is
// the one-sided, floor-based one of _dtent (:164-167): the floor corner gets
// -1 and the other +1 (times the other axis's weight), so integer positions
// (every position at zero offsets, conv_offset's init) still get gradients.
//
// Layouts (all contiguous f32), N = B*G images-by-group, Q = H*W:
//   x_rows   (N, Q, Cg)     channels-last rows
//   pyx      (N, K, P, 2)   absolute (py, px) per tap and output pixel
//   sampled  (N, P, K, Cg)  p-major: row (n, p) is the (K*Cg) im2col row that
//                           one (B*P, K*C) x (K*C, O) matmul contracts
//   dx       like x_rows (zeroed by the caller); dpyx like pyx.
//
// What bounds it on an H100. The forward: bytes. It writes sampled, K = 9
// times the size of x (at the SipMask++ layer2 DCN at 544x544, batch 8:
// 170 MB, about 0.05 ms at 3.35 TB/s), and reads four corners per element,
// mostly L2 hits since neighbouring pixels share corners. One warp per
// (n, p, tap) item, lanes along the Cg contiguous channels, so every corner
// read and sampled write of a warp touches one contiguous run of channels
// (16-byte vectors when Cg % 4 == 0); the corners, weights and bounds of an
// item are worked out once per warp and reused over its channels; each
// corner's bounds are tested on the float position before any address is
// formed, so offsets hundreds of pixels out never read outside x.
//
// The backward reads sampled's cotangent and x and scatters four adds an
// element into dx. Taps of neighbouring output pixels land on the same x
// pixels (about 36 contributions an x element at small offsets), so the
// scatter is bound by the L2's atomic throughput, not by bytes. One warp per
// (n, p, tap) item, lanes along the channels, as the forward; each corner's
// contribution is one 16-byte vector reduction a lane (atomicAdd on float4,
// sm_90: 512 contiguous bytes a warp instruction) when Cg % 4 == 0, scalar
// atomics otherwise; a corner whose bilinear weight is exactly 0 (integer
// positions, every position at zero offsets) adds nothing and is skipped.
// d position is reduced over the channels in registers and across the warp
// with shuffles, in a fixed order: dpyx gives the same bits on every call,
// and only dx's sums change order from run to run. A tile design that
// accumulates dx in shared memory (tools/k5c_tiles.cu) ran 3x slower on an
// H100: its shared float atomics are compare-and-swap loops, and a warp
// item of 32 channels pays the corner math that this kernel spreads over
// Cg.

#include <cuda_runtime.h>

#include <cstdint>

#include "deform_corners.cuh"

namespace {

constexpr int kThreads = 256;               // 8 warps, one item each
constexpr int kWarps = kThreads / 32;

using dcn::Corners;
using dcn::corners;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void set(T& v, int, float a) { v = a; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static void set(T& v, int i, float a) {
    if (i == 0) v.x = a;
    else if (i == 1) v.y = a;
    else if (i == 2) v.z = a;
    else v.w = a;
  }
};

// Item (n, p, k) of warp w: the output row order of sampled.
__device__ __forceinline__ void item_of(int64_t item, int P, int K, int& n,
                                        int& p, int& k) {
  k = (int)(item % K);
  const int64_t np = item / K;
  p = (int)(np % P);
  n = (int)(np / P);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) deform_rows_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ pyx,
    float* __restrict__ out, int64_t n_items, int H, int W, int Cg, int K,
    int P) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  int n, p, k;
  item_of(item, P, K, n, p, k);
  const float* pos = pyx + (((int64_t)n * K + k) * P + p) * 2;
  const Corners c = corners(pos[0], pos[1], H, W);
  const T* xn = reinterpret_cast<const T*>(x + (int64_t)n * H * W * Cg);
  T* o = reinterpret_cast<T*>(out + item * Cg);
  const int cv = Cg / VEC;   // vectors per row
  const T zero{};
  for (int v = lane; v < cv; v += 32) {
    const T a00 = c.v00 ? xn[c.q00 * cv + v] : zero;
    const T a01 = c.v01 ? xn[c.q01 * cv + v] : zero;
    const T a10 = c.v10 ? xn[c.q10 * cv + v] : zero;
    const T a11 = c.v11 ? xn[c.q11 * cv + v] : zero;
    T r;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      V::set(r, i, V::get(a00, i) * c.w00 + V::get(a01, i) * c.w01 +
                       V::get(a10, i) * c.w10 + V::get(a11, i) * c.w11);
    o[v] = r;
  }
}

// d*w into dx: one scalar atomic, or one 16-byte vector reduction.
__device__ __forceinline__ void scatter(float* dst, float d, float w) {
  atomicAdd(dst, d * w);
}
__device__ __forceinline__ void scatter(float4* dst, const float4& d,
                                        float w) {
  atomicAdd(dst, make_float4(d.x * w, d.y * w, d.z * w, d.w * w));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) deform_rows_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ pyx,
    const float* __restrict__ dsampled, float* __restrict__ dx,
    float* __restrict__ dpyx, int64_t n_items, int H, int W, int Cg, int K,
    int P) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  int n, p, k;
  item_of(item, P, K, n, p, k);
  const int64_t pos_off = (((int64_t)n * K + k) * P + p) * 2;
  const Corners c = corners(pyx[pos_off], pyx[pos_off + 1], H, W);
  const int64_t base = (int64_t)n * H * W * Cg;
  const T* xn = reinterpret_cast<const T*>(x + base);
  T* dxn = reinterpret_cast<T*>(dx + base);
  const T* g = reinterpret_cast<const T*>(dsampled + item * Cg);
  const int cv = Cg / VEC;
  const T zero{};
  // warp-uniform: which corners add anything
  const bool s00 = c.v00 && c.w00 != 0.f, s01 = c.v01 && c.w01 != 0.f;
  const bool s10 = c.v10 && c.w10 != 0.f, s11 = c.v11 && c.w11 != 0.f;
  float gy = 0.f, gx = 0.f;
  for (int v = lane; v < cv; v += 32) {
    const T d = g[v];
    const T a00 = c.v00 ? xn[c.q00 * cv + v] : zero;
    const T a01 = c.v01 ? xn[c.q01 * cv + v] : zero;
    const T a10 = c.v10 ? xn[c.q10 * cv + v] : zero;
    const T a11 = c.v11 ? xn[c.q11 * cv + v] : zero;
    if (s00) scatter(dxn + c.q00 * cv + v, d, c.w00);
    if (s01) scatter(dxn + c.q01 * cv + v, d, c.w01);
    if (s10) scatter(dxn + c.q10 * cv + v, d, c.w10);
    if (s11) scatter(dxn + c.q11 * cv + v, d, c.w11);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float di = V::get(d, i);
      const float b00 = V::get(a00, i), b01 = V::get(a01, i);
      const float b10 = V::get(a10, i), b11 = V::get(a11, i);
      gy += di * ((b10 - b00) * c.hx + (b11 - b01) * c.lx);
      gx += di * ((b01 - b00) * c.hy + (b11 - b10) * c.ly);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    gy += __shfl_xor_sync(0xffffffffu, gy, s);
    gx += __shfl_xor_sync(0xffffffffu, gx, s);
  }
  if (lane == 0) {
    dpyx[pos_off] = gy;
    dpyx[pos_off + 1] = gx;
  }
}

}  // namespace

extern "C" {

// x_rows (N, H*W, Cg), pyx (N, K, P, 2) -> sampled (N, P, K, Cg), all
// contiguous f32. vec4 != 0 takes 16-byte vectors: the caller guarantees
// Cg % 4 == 0 and 16-byte-aligned pointers. Returns the cudaError_t of the
// launch (0 on success).
int deform_rows_fwd_f32(const void* x, const void* pyx, void* out, int N,
                        int H, int W, int Cg, int K, int P, int vec4,
                        void* stream) {
  const int64_t n_items = (int64_t)N * P * K;
  if (n_items == 0) return 0;
  const int64_t blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4)
    deform_rows_fwd_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, (const float*)pyx, (float*)out, n_items, H, W, Cg,
        K, P);
  else
    deform_rows_fwd_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, (const float*)pyx, (float*)out, n_items, H, W, Cg,
        K, P);
  return (int)cudaGetLastError();
}

// Backward of deform_rows_fwd_f32 for the cotangent dsampled (N, P, K, Cg):
// dx (N, H*W, Cg; zeroed by the caller) and dpyx (N, K, P, 2). vec4 as for
// the forward.
int deform_rows_bwd_f32(const void* x, const void* pyx, const void* dsampled,
                        void* dx, void* dpyx, int N, int H, int W, int Cg,
                        int K, int P, int vec4, void* stream) {
  const int64_t n_items = (int64_t)N * P * K;
  if (n_items == 0) return 0;
  const int64_t blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4)
    deform_rows_bwd_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, (const float*)pyx, (const float*)dsampled,
        (float*)dx, (float*)dpyx, n_items, H, W, Cg, K, P);
  else
    deform_rows_bwd_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const float*)x, (const float*)pyx, (const float*)dsampled,
        (float*)dx, (float*)dpyx, n_items, H, W, Cg, K, P);
  return (int)cudaGetLastError();
}

const char* deform_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
