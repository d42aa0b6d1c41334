// The four bilinear corners of a deformable sampling position, shared by the
// row sampling kernels (deform_rows.cu, K5 and K5c) and the deform-conv
// backward's scatter (deform_col2im.cu, K2).
//
// Semantics: sample_ref (sipmask_tpu/ops/pallas/deform_gather.py:99-130).
// Corners are floor(p) and floor(p)+1; a corner outside [0, H-1] x [0, W-1]
// adds 0; weights are f32 products of (1 - frac) and frac. Each corner's
// bounds are tested on the float position before any address is formed, so
// offsets hundreds of pixels out never index outside the map.

#pragma once

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

}  // namespace dcn
