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
//   dx       like x_rows, f32 (zeroed by the caller; in bf16 a scratch
//            that the C entry zeroes); dpyx like pyx.
//
// Element types: f32 throughout (deform_rows_{fwd,bwd}_f32), or bf16
// x_rows, sampled and dsampled with f32 positions (deform_rows_{fwd,bwd}
// _bf16), the JAX package's compute_dtype="bfloat16" graph. Weights and the
// interpolation are f32, and each sampled value is rounded once to bf16 as
// it is written. The bf16 backward scatters into an f32 dx scratch, which
// its C entry zeroes (cudaMemsetAsync), with float4 reductions (there are
// no bf16 vector atomics to sum in), and a last kernel rounds dx once to
// bf16; d positions are f32, summed in a fixed order.
//
// What bounds it on an H100. The forward: bytes. It writes sampled, K = 9
// times the size of x (at the SipMask++ layer2 DCN at 544x544, batch 8:
// 170 MB in f32, about 0.05 ms at 3.35 TB/s), and reads four corners per
// element, mostly L2 hits since neighbouring pixels share corners. The f32
// kernel: one warp per (n, p, tap) item, lanes along the Cg contiguous
// channels, so every corner read and sampled write of a warp touches one
// contiguous run of channels (16-byte vectors when Cg % 4 == 0); the
// corners, weights and bounds of an item are worked out once per warp and
// reused over its channels; each corner's bounds are tested on the float
// position before any address is formed, so offsets hundreds of pixels out
// never read outside x.
//
// The bf16 forward with Cg % 4 == 0 (deform_rows_fwd_bf16x4_kernel): lanes
// of four channels (8-byte loads and stores), 8, 16 or 32 lanes an item by
// Cg (four passes a lane from Cg = 128 up; no lane idles at Cg = 128,
// where 16-byte lanes left half a warp idle), so that a warp holds several
// items side by side. A block takes up to 16 output pixels of one image
// with all their taps, one contiguous run of sampled rows; it first loads
// their positions into shared memory tap by tap (runs of consecutive
// pixels, coalesced), and smaller tiles keep small maps on enough blocks.
// What bounds it on an H100 (tools/k5c_probe.py --bf16): at Cg = 128 a
// warp an item with 16-byte lanes took 0.139 ms, these lanes 0.058 ms
// against a 0.034 ms floor of the same kernel storing sampled without
// reading x; the rest is the L2's corner reads (four a sampled element).
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
// Cg. The bf16 backward with Cg % 4 == 0 (deform_rows_bwd_bf16x4_kernel)
// takes K2's bf16 scatter (dcn::scatter_bf16x4): four channels a lane,
// 8-byte loads of dsampled and x, one float4 reduction a corner, a
// half-warp an item (kBwdLanes), so that an item's lanes reduce into one
// contiguous run of dx (16-byte lanes of 8 channels issued two reductions
// 16 bytes apart, touching twice the L2 lines, and left half a warp idle
// at Cg = 128); its lane groups loop over the items on a grid of the
// blocks the card holds at once, loading the next item's position while
// one is scattered. Measured on an H100 (tools/k5c_probe.py --bf16): the
// reductions cost 15% of it (plain stores in their place), so what bounds
// it is the latency of its loads, not the L2's atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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

// Rounds of items a lane group of the bf16 forward has in flight: their
// corner loads are all issued before any interpolation (tools/k5c_probe.py
// --bf16: items1, items2, items4).
constexpr int kFwdItems = 1;

// Output pixels of a bf16 forward block (with all their taps): at most
// kFwdPixels, halved while the grid would hold fewer than kFwdBlocks
// blocks, 16 for each of an H100's 132 SMs (SipMask++ at 544x544, batch 8:
// 16 at layer2, 4 at layer3, 1 at layer4).
constexpr int kFwdPixels = 16;
constexpr int64_t kFwdBlocks = 16 * 132;

// Lanes of a bf16 item on the vector path (tools/k5c_probe.py --bf16): the
// forward 8, 16 or 32 by Cg, so that a lane takes 16 channels of an item
// in four passes from Cg = 128 up (several items a warp side by side), the
// backward a half-warp at every Cg.
constexpr int fwd_bf16_lanes(int Cg) {
  return Cg >= 512 ? 32 : Cg >= 256 ? 16 : 8;
}
constexpr int kBwdLanes = 16;

// A corner's four bf16 channels (8 bytes).
__device__ __forceinline__ uint2 corner_load(const uint2* p) { return *p; }

// Four f32 values rounded to bf16 (to nearest even) as 8 bytes.
__device__ __forceinline__ uint2 pack_bf16x4(float a, float b, float c,
                                             float d) {
  return make_uint2(Vec<bf16, 8>::pair(a, b), Vec<bf16, 8>::pair(c, d));
}

// The bf16 forward for Cg % 4 == 0. grid (N * ceil(P / pixels)): a block
// takes ``pixels`` output pixels of one image with all K taps, the items
// (p, tap) of one contiguous run of sampled rows. Its positions are loaded
// first, tap by tap (coalesced runs of pixels), into shared memory; then
// lane group g of LANES lanes takes items g, g + groups, ..., kFwdItems
// of them a round with their corner loads in flight. x_rows (N, H*W, Cg)
// and sampled (N, P, K, Cg) bf16 with 8-byte aligned rows, pyx
// (N, K, P, 2) f32; dynamic shared memory K * pixels float2.
template <int LANES>
__global__ void __launch_bounds__(kThreads) deform_rows_fwd_bf16x4_kernel(
    const bf16* __restrict__ x, const float* __restrict__ pyx,
    bf16* __restrict__ out, int H, int W, int Cg, int K, int P,
    int pixels) {
  extern __shared__ float2 tile_pos[];   // [K][pixels]
  constexpr int kGroups = kThreads / LANES;
  const int tiles = (P + pixels - 1) / pixels;
  const int n = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - n * tiles) * pixels;
  const int np = min(pixels, P - p0);
  const float2* pos = reinterpret_cast<const float2*>(pyx) +
                      (int64_t)n * K * P + p0;
  for (int i = threadIdx.x; i < K * pixels; i += kThreads) {
    const int k = i / pixels, t = i - k * pixels;
    tile_pos[i] = t < np ? pos[(int64_t)k * P + t] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const int grp = threadIdx.x / LANES, sub = threadIdx.x % LANES;
  const int cv = Cg / 4;   // vectors of 4 per row
  const int items = np * K;
  const uint2* xn =
      reinterpret_cast<const uint2*>(x) + (int64_t)n * H * W * cv;
  uint2* o = reinterpret_cast<uint2*>(out) + ((int64_t)n * P + p0) * K * cv;
  const uint2 zero = make_uint2(0u, 0u);
  for (int base = grp; base < items; base += kGroups * kFwdItems) {
    float w[kFwdItems][4];
    int64_t q[kFwdItems][4];   // vector offset of a corner in xn, or -1
    bool live[kFwdItems];
#pragma unroll
    for (int i = 0; i < kFwdItems; ++i) {
      const int item = base + i * kGroups;   // (p - p0) * K + tap
      live[i] = item < items;
      const int t = item / K;
      const float2 py_px =
          live[i] ? tile_pos[(item - t * K) * pixels + t]
                  : make_float2(0.f, 0.f);
      const Corners c = corners(py_px.x, py_px.y, H, W);
      w[i][0] = c.w00; w[i][1] = c.w01; w[i][2] = c.w10; w[i][3] = c.w11;
      q[i][0] = live[i] && c.v00 ? c.q00 * cv : -1;
      q[i][1] = live[i] && c.v01 ? c.q01 * cv : -1;
      q[i][2] = live[i] && c.v10 ? c.q10 * cv : -1;
      q[i][3] = live[i] && c.v11 ? c.q11 * cv : -1;
    }
    for (int v = sub; v < cv; v += LANES) {
      uint2 a[kFwdItems][4];
#pragma unroll
      for (int i = 0; i < kFwdItems; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[i][j] = q[i][j] >= 0 ? corner_load(xn + q[i][j] + v) : zero;
#pragma unroll
      for (int i = 0; i < kFwdItems; ++i) {
        if (!live[i]) continue;
        const float4 b00 = dcn::bf16x4(a[i][0]), b01 = dcn::bf16x4(a[i][1]);
        const float4 b10 = dcn::bf16x4(a[i][2]), b11 = dcn::bf16x4(a[i][3]);
        const float* wi = w[i];
        o[(int64_t)(base + i * kGroups) * cv + v] = pack_bf16x4(
            b00.x * wi[0] + b01.x * wi[1] + b10.x * wi[2] + b11.x * wi[3],
            b00.y * wi[0] + b01.y * wi[1] + b10.y * wi[2] + b11.y * wi[3],
            b00.z * wi[0] + b01.z * wi[1] + b10.z * wi[2] + b11.z * wi[3],
            b00.w * wi[0] + b01.w * wi[1] + b10.w * wi[2] + b11.w * wi[3]);
      }
    }
  }
}

// The bf16 backward for Cg % 4 == 0. LANES lanes per (n, p, tap) item, in
// that order; lane group g takes items g, g + groups, ... (a grid of at
// most the blocks the card holds at once), the next item's position loaded
// while this one is scattered. x_rows and dsampled bf16 with 8-byte
// aligned rows, dx (N, H*W, Cg) f32 16-byte aligned, zeroed.
template <int LANES>
__global__ void __launch_bounds__(kThreads) deform_rows_bwd_bf16x4_kernel(
    const bf16* __restrict__ x, const float* __restrict__ pyx,
    const bf16* __restrict__ dsampled, float* __restrict__ dx,
    float* __restrict__ dpyx, int64_t n_items, int H, int W, int Cg, int K,
    int P) {
  const int sub = threadIdx.x % LANES;
  const int cv = Cg / 4;
  const int64_t stride = (int64_t)gridDim.x * (kThreads / LANES);
  int64_t item = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / LANES;
  int n, p, k;
  float2 next = make_float2(0.f, 0.f);
  if (item < n_items) {
    item_of(item, P, K, n, p, k);
    next = reinterpret_cast<const float2*>(pyx)[((int64_t)n * K + k) * P + p];
  }
  for (; item < n_items; item += stride) {
    const float2 cur = next;
    item_of(item, P, K, n, p, k);
    const int64_t pos_off = (((int64_t)n * K + k) * P + p) * 2;
    if (item + stride < n_items) {
      int n2, p2, k2;
      item_of(item + stride, P, K, n2, p2, k2);
      next = reinterpret_cast<const float2*>(pyx)[((int64_t)n2 * K + k2) * P +
                                                  p2];
    }
    const Corners c = corners(cur.x, cur.y, H, W);
    const int64_t rows = (int64_t)n * H * W * cv;
    const float2 g = dcn::scatter_bf16x4<LANES>(
        reinterpret_cast<const uint2*>(x) + rows,
        reinterpret_cast<float4*>(dx) + rows,
        reinterpret_cast<const uint2*>(dsampled) + item * cv, c, cv, sub);
    if (sub == 0) {
      dpyx[pos_off] = g.x;
      dpyx[pos_off + 1] = g.y;
    }
  }
}

// Blocks of kThreads of ``kernel`` the card holds at once (its SMs times
// the blocks an SM holds), worked out once per kernel: the grid of the
// bf16 vector kernels, whose warps loop over their items.
template <typename Kernel>
int64_t resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0))
    return 0;
  return (int64_t)sms * per_sm;
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

// Output pixels a bf16 forward block takes (kFwdPixels).
int fwd_pixels(int N, int P) {
  int pixels = kFwdPixels;
  while (pixels > 1 &&
         (int64_t)N * ((P + pixels - 1) / pixels) < kFwdBlocks)
    pixels /= 2;
  return pixels;
}

template <int LANES>
int fwd_bf16x4(const void* x, const void* pyx, void* out, int N, int H,
               int W, int Cg, int K, int P, cudaStream_t st) {
  const int pixels = fwd_pixels(N, P);
  const int64_t blocks = (int64_t)N * ((P + pixels - 1) / pixels);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  deform_rows_fwd_bf16x4_kernel<LANES>
      <<<(unsigned)blocks, kThreads, sizeof(float2) * K * pixels, st>>>(
          (const bf16*)x, (const float*)pyx, (bf16*)out, H, W, Cg, K, P,
          pixels);
  return (int)cudaGetLastError();
}

template <int LANES>
int bwd_bf16x4(const void* x, const void* pyx, const void* dsampled,
               void* dx, void* dpyx, int64_t n_items, int H, int W, int Cg,
               int K, int P, cudaStream_t st) {
  static const int64_t cap =
      resident_blocks(deform_rows_bwd_bf16x4_kernel<LANES>);
  if (cap == 0) return (int)cudaGetLastError();
  const int64_t blocks =
      std::min(cap, (n_items * LANES + kThreads - 1) / kThreads);
  deform_rows_bwd_bf16x4_kernel<LANES>
      <<<(unsigned)blocks, kThreads, 0, st>>>(
          (const bf16*)x, (const float*)pyx, (const bf16*)dsampled,
          (float*)dx, (float*)dpyx, n_items, H, W, Cg, K, P);
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

// The same with x_rows and sampled bf16 (pyx f32). vec != 0 takes lanes of
// four channels (8-byte loads): Cg % 4 == 0 and 8-byte-aligned pointers.
int deform_rows_fwd_bf16(const void* x, const void* pyx, void* out, int N,
                         int H, int W, int Cg, int K, int P, int vec,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_items = (int64_t)N * P * K;
  if (!vec) return fwd<bf16, 1>(x, pyx, out, N, H, W, Cg, K, P, st);
  if (n_items == 0) return 0;
  switch (fwd_bf16_lanes(Cg)) {
    case 8: return fwd_bf16x4<8>(x, pyx, out, N, H, W, Cg, K, P, st);
    case 32: return fwd_bf16x4<32>(x, pyx, out, N, H, W, Cg, K, P, st);
    default: return fwd_bf16x4<16>(x, pyx, out, N, H, W, Cg, K, P, st);
  }
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
// is summed into the scratch dx_f32 (N, H*W, Cg) f32, which this call
// zeroes, then rounded once into dx (bf16); dpyx (N, K, P, 2) f32. vec as
// for the forward (dx_f32 16-byte aligned too). Three device operations:
// the zeroing, the scatter and the rounding.
int deform_rows_bwd_bf16(const void* x, const void* pyx,
                         const void* dsampled, void* dx_f32, void* dx,
                         void* dpyx, int N, int H, int W, int Cg, int K,
                         int P, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n = (int64_t)N * H * W * Cg;
  const int64_t n_items = (int64_t)N * P * K;
  if (n == 0) return 0;
  int err = (int)cudaMemsetAsync(dx_f32, 0, n * sizeof(float), st);
  if (err != 0) return err;
  if (n_items > 0) {
    if (!vec)
      err = bwd<bf16, 1>(x, pyx, dsampled, dx_f32, dpyx, N, H, W, Cg, K, P,
                         st);
    else
      err = bwd_bf16x4<kBwdLanes>(x, pyx, dsampled, dx_f32, dpyx, n_items, H,
                                  W, Cg, K, P, st);
    if (err != 0) return err;
  }
  const int v8 = n % 8 == 0 && (uintptr_t)dx_f32 % 16 == 0 &&
                 (uintptr_t)dx % 16 == 0;
  const int vec_n = v8 ? 8 : 1;
  const int64_t blocks = (n / vec_n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 65535 * 8 ? blocks : 65535 * 8);
  if (v8)
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
