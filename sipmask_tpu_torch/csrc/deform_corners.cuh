// The four bilinear corners of a deformable sampling position, shared by the
// row sampling kernels (deform_rows.cu, K5 and K5c) and the deform-conv
// backward's scatter (deform_col2im.cu, K2); and the bf16 scatter of one
// sampled row's cotangent into its corners, shared by the bf16 K5c and K2.
//
// Semantics: sample_ref (sipmask_tpu/ops/pallas/deform_gather.py:99-130).
// Corners are floor(p) and floor(p)+1; a corner outside [0, H-1] x [0, W-1]
// adds 0; weights are f32 products of (1 - frac) and frac. Each corner's
// bounds are tested on the float position before any address is formed, so
// offsets hundreds of pixels out never index outside the map.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dcn {

struct Corners {
  float w00, w01, w10, w11;   // bilinear weights
  float hy, hx, ly, lx;       // 1 - frac and frac per axis
  bool v00, v01, v10, v11;    // corner inside the map
  int64_t q00, q01, q10, q11; // row index (y*W + x) of each valid corner
};

__device__ __forceinline__ Corners corners(float py, float px, int H, int W) {
  Corners c;
  const float y0 = floorf(py);
  const float x0 = floorf(px);
  c.ly = py - y0;
  c.lx = px - x0;
  c.hy = 1.f - c.ly;
  c.hx = 1.f - c.lx;
  c.w00 = c.hy * c.hx;
  c.w01 = c.hy * c.lx;
  c.w10 = c.ly * c.hx;
  c.w11 = c.ly * c.lx;
  const float ymax = (float)(H - 1), xmax = (float)(W - 1);
  const bool vy0 = y0 >= 0.f && y0 <= ymax;
  const bool vy1 = y0 + 1.f >= 0.f && y0 + 1.f <= ymax;
  const bool vx0 = x0 >= 0.f && x0 <= xmax;
  const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f <= xmax;
  c.v00 = vy0 && vx0;
  c.v01 = vy0 && vx1;
  c.v10 = vy1 && vx0;
  c.v11 = vy1 && vx1;
  // float -> int only for positions already known to lie in the map
  c.q00 = c.v00 ? (int64_t)y0 * W + (int64_t)x0 : 0;
  c.q01 = c.v01 ? (int64_t)y0 * W + (int64_t)x0 + 1 : 0;
  c.q10 = c.v10 ? ((int64_t)y0 + 1) * W + (int64_t)x0 : 0;
  c.q11 = c.v11 ? ((int64_t)y0 + 1) * W + (int64_t)x0 + 1 : 0;
  return c;
}

// Four bf16 (8 bytes) as f32.
__device__ __forceinline__ float4 bf16x4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}

__device__ __forceinline__ float4 scaled(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

// A corner adds to dX when it lies in the map and its weight is not 0.
__device__ __forceinline__ bool adds(bool valid, float w) {
  return valid && w != 0.f;
}

// One sampled row's cotangent scattered into its four corners, in bf16
// with Cg % 4 == 0: the LANES lanes of an item (LANES = 16, a half-warp, or
// 32, aligned in the warp; sub = lane % LANES) take four channels each, an
// 8-byte load of the cotangent row drow and of each corner's x row, and one
// float4 reduction into each corner's f32 dX row that adds (in the map,
// weight not 0: at integer positions 3 of 4 are skipped, their x still
// enters d position), so that the item's lanes reduce into one contiguous
// run of 16 * LANES bytes an instruction. xn and dxn point at the image's
// rows in vectors of 4 channels, cv = Cg / 4 a row. Returns the item's d
// position (d py, d px) in every lane of the item, summed over its lanes by
// a fixed shuffle tree: the same bits on every call.
template <int LANES>
__device__ __forceinline__ float2 scatter_bf16x4(const uint2* xn,
                                                 float4* dxn,
                                                 const uint2* drow,
                                                 const Corners& c, int cv,
                                                 int sub) {
  static_assert(LANES == 16 || LANES == 32, "a half-warp or a warp");
  const unsigned mask =
      LANES == 32 ? 0xFFFFFFFFu : 0xFFFFu << (threadIdx.x & 16);
  const bool a00 = adds(c.v00, c.w00), a01 = adds(c.v01, c.w01);
  const bool a10 = adds(c.v10, c.w10), a11 = adds(c.v11, c.w11);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float gy = 0.f, gx = 0.f;
  for (int v = sub; v < cv; v += LANES) {
    const float4 d = bf16x4(drow[v]);
    const float4 b00 = c.v00 ? bf16x4(xn[c.q00 * cv + v]) : zero;
    const float4 b01 = c.v01 ? bf16x4(xn[c.q01 * cv + v]) : zero;
    const float4 b10 = c.v10 ? bf16x4(xn[c.q10 * cv + v]) : zero;
    const float4 b11 = c.v11 ? bf16x4(xn[c.q11 * cv + v]) : zero;
    if (a00) atomicAdd(dxn + c.q00 * cv + v, scaled(d, c.w00));
    if (a01) atomicAdd(dxn + c.q01 * cv + v, scaled(d, c.w01));
    if (a10) atomicAdd(dxn + c.q10 * cv + v, scaled(d, c.w10));
    if (a11) atomicAdd(dxn + c.q11 * cv + v, scaled(d, c.w11));
    gy += d.x * ((b10.x - b00.x) * c.hx + (b11.x - b01.x) * c.lx);
    gx += d.x * ((b01.x - b00.x) * c.hy + (b11.x - b10.x) * c.ly);
    gy += d.y * ((b10.y - b00.y) * c.hx + (b11.y - b01.y) * c.lx);
    gx += d.y * ((b01.y - b00.y) * c.hy + (b11.y - b10.y) * c.ly);
    gy += d.z * ((b10.z - b00.z) * c.hx + (b11.z - b01.z) * c.lx);
    gx += d.z * ((b01.z - b00.z) * c.hy + (b11.z - b10.z) * c.ly);
    gy += d.w * ((b10.w - b00.w) * c.hx + (b11.w - b01.w) * c.lx);
    gx += d.w * ((b01.w - b00.w) * c.hy + (b11.w - b10.w) * c.ly);
  }
#pragma unroll
  for (int s = LANES / 2; s > 0; s >>= 1) {
    gy += __shfl_xor_sync(mask, gy, s);
    gx += __shfl_xor_sync(mask, gx, s);
  }
  return make_float2(gy, gx);
}

}  // namespace dcn
