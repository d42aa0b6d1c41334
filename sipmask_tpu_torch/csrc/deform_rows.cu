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
// Layouts (all contiguous), N = B*G images-by-group, Q = H*W:
//   x_rows   (N, Q, Cg)     channels-last rows
//   pyx      (N, K, P, 2)   absolute (py, px) per tap and output pixel, f32
//   sampled  (N, P, K, Cg)  p-major: row (n, p) is the (K*Cg) im2col row that
//                           one (B*P, K*C) x (K*C, O) matmul contracts
//   dx       like x_rows, f32 (zeroed by the caller); dpyx like pyx.
//
// Element types: f32 throughout (deform_rows_{fwd,bwd}_f32), or bf16
// x_rows, sampled and dsampled with f32 positions (deform_rows_{fwd,bwd}
// _bf16), the JAX package's compute_dtype="bfloat16" graph. The kernels
// are templates on the element type: corners are read in bf16 (16-byte
// vectors of 8 channels where Cg % 8 == 0 and the pointers are aligned,
// else scalars), weights and the interpolation are f32, and each sampled
// value is rounded once to bf16 as it is written. The bf16 backward
// scatters into an f32 dx scratch (float4 reductions, as in f32; there are
// no bf16 vector atomics to sum in) and a last kernel rounds dx once to
// bf16; d positions are reduced in f32 in the same fixed order as in f32.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "deform_corners.cuh"

namespace {

constexpr int kThreads = 256;               // 8 warps, one item each
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;
using dcn::Corners;
using dcn::corners;

// A load of VEC channels of element type E: its register type T, channel i
// of it in f32, and the store of VEC f32 values as one T (bf16 rounded to
// nearest even).
template <typename E, int VEC>
struct Vec;
template <>
struct Vec<float, 1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static T pack(const float (&r)[1]) { return r[0]; }
};
template <>
struct Vec<float, 4> {
  using T = float4;
  __device__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static T pack(const float (&r)[4]) {
    return make_float4(r[0], r[1], r[2], r[3]);
  }
};
template <>
struct Vec<bf16, 1> {
  using T = bf16;
  __device__ static float get(const T& v, int) { return __bfloat162float(v); }
  __device__ static T pack(const float (&r)[1]) {
    return __float2bfloat16_rn(r[0]);
  }
};
template <>
struct Vec<bf16, 8> {   // 16 bytes: channel i in half i % 2 of word i / 2
  using T = uint4;      // (little-endian pairs)
  __device__ static float get(const T& v, int i) {
    const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
    return __uint_as_float(i & 1 ? w & 0xFFFF0000u : w << 16);
  }
  __device__ static uint32_t pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static T pack(const float (&r)[8]) {
    return make_uint4(pair(r[0], r[1]), pair(r[2], r[3]), pair(r[4], r[5]),
                      pair(r[6], r[7]));
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

template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) deform_rows_fwd_kernel(
    const E* __restrict__ x, const float* __restrict__ pyx,
    E* __restrict__ out, int64_t n_items, int H, int W, int Cg, int K,
    int P) {
  using V = Vec<E, VEC>;
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
    float r[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      r[i] = V::get(a00, i) * c.w00 + V::get(a01, i) * c.w01 +
             V::get(a10, i) * c.w10 + V::get(a11, i) * c.w11;
    o[v] = V::pack(r);
  }
}

// d*w of VEC channels into an f32 row of dx: scalar atomics, or 16-byte
// vector reductions (one for 4 channels, two for 8).
template <int VEC>
__device__ __forceinline__ void scatter(float* dst, const float (&d)[VEC],
                                        float w) {
  if constexpr (VEC == 1) {
    atomicAdd(dst, d[0] * w);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(d[i] * w, d[i + 1] * w, d[i + 2] * w,
                            d[i + 3] * w));
  }
}

template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) deform_rows_bwd_kernel(
    const E* __restrict__ x, const float* __restrict__ pyx,
    const E* __restrict__ dsampled, float* __restrict__ dx,
    float* __restrict__ dpyx, int64_t n_items, int H, int W, int Cg, int K,
    int P) {
  using V = Vec<E, VEC>;
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
  float* dxn = dx + base;
  const T* g = reinterpret_cast<const T*>(dsampled + item * Cg);
  const int cv = Cg / VEC;
  const T zero{};
  // warp-uniform: which corners add anything
  const bool s00 = c.v00 && c.w00 != 0.f, s01 = c.v01 && c.w01 != 0.f;
  const bool s10 = c.v10 && c.w10 != 0.f, s11 = c.v11 && c.w11 != 0.f;
  float gy = 0.f, gx = 0.f;
  for (int v = lane; v < cv; v += 32) {
    const T dv = g[v];
    float d[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) d[i] = V::get(dv, i);
    const T a00 = c.v00 ? xn[c.q00 * cv + v] : zero;
    const T a01 = c.v01 ? xn[c.q01 * cv + v] : zero;
    const T a10 = c.v10 ? xn[c.q10 * cv + v] : zero;
    const T a11 = c.v11 ? xn[c.q11 * cv + v] : zero;
    const int64_t ch = (int64_t)v * VEC;
    if (s00) scatter<VEC>(dxn + c.q00 * Cg + ch, d, c.w00);
    if (s01) scatter<VEC>(dxn + c.q01 * Cg + ch, d, c.w01);
    if (s10) scatter<VEC>(dxn + c.q10 * Cg + ch, d, c.w10);
    if (s11) scatter<VEC>(dxn + c.q11 * Cg + ch, d, c.w11);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float b00 = V::get(a00, i), b01 = V::get(a01, i);
      const float b10 = V::get(a10, i), b11 = V::get(a11, i);
      gy += d[i] * ((b10 - b00) * c.hx + (b11 - b01) * c.lx);
      gx += d[i] * ((b01 - b00) * c.hy + (b11 - b10) * c.ly);
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

// The bf16 backward's last kernel: dx rounded once from its f32 sums, 8
// elements a thread where n % 8 == 0 and the pointers are aligned.
template <int VEC>
__global__ void __launch_bounds__(kThreads) round_bf16_kernel(
    const float* __restrict__ in, bf16* __restrict__ out, int64_t n) {
  using V = Vec<bf16, VEC>;
  const int64_t nv = n / VEC;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nv;
       i += (int64_t)gridDim.x * kThreads) {
    float r[VEC];
    if constexpr (VEC == 8) {
      const float4 a = reinterpret_cast<const float4*>(in)[2 * i];
      const float4 b = reinterpret_cast<const float4*>(in)[2 * i + 1];
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
      r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
    } else {
      r[0] = in[i];
    }
    reinterpret_cast<typename V::T*>(out)[i] = V::pack(r);
  }
}

int64_t blocks_of(int64_t n_items) {
  return (n_items + kWarps - 1) / kWarps;
}

template <typename E, int VEC>
int fwd(const void* x, const void* pyx, void* out, int N, int H, int W,
        int Cg, int K, int P, cudaStream_t st) {
  const int64_t n_items = (int64_t)N * P * K;
  if (n_items == 0) return 0;
  const int64_t blocks = blocks_of(n_items);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  deform_rows_fwd_kernel<E, VEC><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const E*)x, (const float*)pyx, (E*)out, n_items, H, W, Cg, K, P);
  return (int)cudaGetLastError();
}

template <typename E, int VEC>
int bwd(const void* x, const void* pyx, const void* dsampled, void* dx,
        void* dpyx, int N, int H, int W, int Cg, int K, int P,
        cudaStream_t st) {
  const int64_t n_items = (int64_t)N * P * K;
  if (n_items == 0) return 0;
  const int64_t blocks = blocks_of(n_items);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  deform_rows_bwd_kernel<E, VEC><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const E*)x, (const float*)pyx, (const E*)dsampled, (float*)dx,
      (float*)dpyx, n_items, H, W, Cg, K, P);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  return vec4 ? fwd<float, 4>(x, pyx, out, N, H, W, Cg, K, P, st)
              : fwd<float, 1>(x, pyx, out, N, H, W, Cg, K, P, st);
}

// The same with x_rows and sampled bf16 (pyx f32). vec8 != 0 takes 16-byte
// vectors of 8 channels: Cg % 8 == 0 and 16-byte-aligned pointers.
int deform_rows_fwd_bf16(const void* x, const void* pyx, void* out, int N,
                         int H, int W, int Cg, int K, int P, int vec8,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return vec8 ? fwd<bf16, 8>(x, pyx, out, N, H, W, Cg, K, P, st)
              : fwd<bf16, 1>(x, pyx, out, N, H, W, Cg, K, P, st);
}

// Backward of deform_rows_fwd_f32 for the cotangent dsampled (N, P, K, Cg):
// dx (N, H*W, Cg; zeroed by the caller) and dpyx (N, K, P, 2). vec4 as for
// the forward.
int deform_rows_bwd_f32(const void* x, const void* pyx, const void* dsampled,
                        void* dx, void* dpyx, int N, int H, int W, int Cg,
                        int K, int P, int vec4, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return vec4 ? bwd<float, 4>(x, pyx, dsampled, dx, dpyx, N, H, W, Cg, K, P,
                              st)
              : bwd<float, 1>(x, pyx, dsampled, dx, dpyx, N, H, W, Cg, K, P,
                              st);
}

// Backward of deform_rows_fwd_bf16: x_rows and dsampled bf16, pyx f32. dx
// is summed into dx_f32 (N, H*W, Cg) f32, zeroed by the caller, then
// rounded once into dx (bf16); dpyx (N, K, P, 2) f32. vec8 as for the
// forward (dx_f32 16-byte aligned too).
int deform_rows_bwd_bf16(const void* x, const void* pyx,
                         const void* dsampled, void* dx_f32, void* dx,
                         void* dpyx, int N, int H, int W, int Cg, int K,
                         int P, int vec8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      vec8 ? bwd<bf16, 8>(x, pyx, dsampled, dx_f32, dpyx, N, H, W, Cg, K, P,
                          st)
           : bwd<bf16, 1>(x, pyx, dsampled, dx_f32, dpyx, N, H, W, Cg, K, P,
                          st);
  if (err != 0) return err;
  const int64_t n = (int64_t)N * H * W * Cg;
  if (n == 0) return 0;
  const int vec = vec8 ? 8 : 1;
  const int64_t blocks = (n / vec + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 65535 * 8 ? blocks : 65535 * 8);
  if (vec8)
    round_bf16_kernel<8><<<grid, kThreads, 0, st>>>((const float*)dx_f32,
                                                    (bf16*)dx, n);
  else
    round_bf16_kernel<1><<<grid, kThreads, 0, st>>>((const float*)dx_f32,
                                                    (bf16*)dx, n);
  return (int)cudaGetLastError();
}

const char* deform_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
