// Deformable im2col (forward) for FeatureAlign's deformable convolution.
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/deform_gather.py that
// sample_bilinear_rows_t (:592) dispatches to: _sample_pallas_sep_t (:465,
// body _fwd_sep_t_kernel) and _sample_pallas_t (:546, body _fwd_t_kernel),
// and the dense XLA tier sample_dense_t beside them. The TPU turned the
// bilinear gather into a banded one-hot matmul because its gathers are slow;
// Hopper gathers natively, so this one kernel reads the four corners.
//
// Semantics: sample_ref (deform_gather.py:99-130) on the positions of
// _sample_positions (sipmask_tpu/ops/deform_conv.py:45-69). Corners are
// floor(p) and floor(p)+1; a corner outside [0, H-1] x [0, W-1] contributes
// 0; weights are f32 products of (1 - frac) and frac.
//
// Layouts (all contiguous f32):
//   x        (B, C, H, W)           C = G * Cg, group g owns channels g*Cg..
//   offsets  (B, G*K*2, Ho, Wo)     channel g*2K + 2*(i*kw + j) + {0: dy, 1: dx}
//   cols     (B, G*K*Cg, Ho*Wo)     row g*K*Cg + (i*kw + j)*Cg + c
// so out (B, O, Ho*Wo) = W2 (O, G*K*Cg) @ cols, one torch.matmul.
//
// What bounds it on an H100: bytes. Each output element is four corner reads
// (mostly L2 hits, since neighbouring pixels share corners) and one 4-byte
// write, and cols is K = 9 times the size of x: the write stream dominates
// (batch 4 at the P3 level of an 800x1344 image: 155M floats, 620 MB, about
// 0.19 ms at 3.35 TB/s). The design follows from that:
//   - threads run along output pixels, so the offset reads and the cols
//     writes of a warp are coalesced and its corner reads share lines;
//   - a thread works out its tap's corners and weights once and reuses them
//     over a chunk of channels;
//   - each corner's bounds are tested on the float position before any
//     address is formed, so offsets hundreds of pixels out (common early in
//     training, when they come from raw box predictions) never read outside x.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // output pixels per block
constexpr int kChanChunk = 16;  // channels per thread

__global__ void __launch_bounds__(kThreads) deform_im2col_kernel(
    const float* __restrict__ x, const float* __restrict__ offsets,
    float* __restrict__ cols, int C, int H, int W, int G, int Ho, int Wo,
    int kh, int kw, int stride, int pad, int dil, int n_chunks) {
  const int P = Ho * Wo;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int K = kh * kw;
  const int Cg = C / G;
  const int t = blockIdx.y / n_chunks;                 // tap i*kw + j
  const int c_lo = (blockIdx.y - t * n_chunks) * kChanChunk;
  const int c_hi = min(c_lo + kChanChunk, Cg);
  const int bg = blockIdx.z;                           // b*G + g
  const int b = bg / G;
  const int g = bg - b * G;
  const int ho = p / Wo;
  const int wo = p - ho * Wo;
  const int i = t / kw;
  const int j = t - i * kw;

  const float* off = offsets + ((int64_t)bg * K * 2 + 2 * t) * P + p;
  // the integer base is exact in f32, so this is the same sum as the
  // reference's (base + tap) + offset
  const float py = (float)(ho * stride - pad + i * dil) + off[0];
  const float px = (float)(wo * stride - pad + j * dil) + off[P];

  const float y0 = floorf(py);
  const float x0 = floorf(px);
  const float ly = py - y0;
  const float lx = px - x0;
  const float hy = 1.f - ly;
  const float hx = 1.f - lx;
  const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;

  const float ymax = (float)(H - 1), xmax = (float)(W - 1);
  const bool vy0 = y0 >= 0.f && y0 <= ymax;
  const bool vy1 = y0 + 1.f >= 0.f && y0 + 1.f <= ymax;
  const bool vx0 = x0 >= 0.f && x0 <= xmax;
  const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f <= xmax;
  const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
  const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
  // float -> int only for positions already known to lie in the map
  const int64_t q00 = v00 ? (int64_t)y0 * W + (int64_t)x0 : 0;
  const int64_t q01 = v01 ? (int64_t)y0 * W + (int64_t)x0 + 1 : 0;
  const int64_t q10 = v10 ? ((int64_t)y0 + 1) * W + (int64_t)x0 : 0;
  const int64_t q11 = v11 ? ((int64_t)y0 + 1) * W + (int64_t)x0 + 1 : 0;

  const int64_t HW = (int64_t)H * W;
  const float* xg = x + ((int64_t)b * C + (int64_t)g * Cg) * HW;
  float* out = cols + ((int64_t)bg * K * Cg + (int64_t)t * Cg) * P + p;
  for (int c = c_lo; c < c_hi; ++c) {
    const float* xc = xg + c * HW;
    const float a00 = v00 ? __ldg(xc + q00) : 0.f;
    const float a01 = v01 ? __ldg(xc + q01) : 0.f;
    const float a10 = v10 ? __ldg(xc + q10) : 0.f;
    const float a11 = v11 ? __ldg(xc + q11) : 0.f;
    out[(int64_t)c * P] = a00 * w00 + a01 * w01 + a10 * w10 + a11 * w11;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). The caller checks
// shapes, dtypes and contiguity, and allocates cols.
int deform_im2col_f32(const void* x, const void* offsets, void* cols, int B,
                      int C, int H, int W, int G, int Ho, int Wo, int kh,
                      int kw, int stride, int pad, int dil, void* stream) {
  const int P = Ho * Wo;
  const int n_chunks = (C / G + kChanChunk - 1) / kChanChunk;
  const dim3 grid((P + kThreads - 1) / kThreads, kh * kw * n_chunks, B * G);
  deform_im2col_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)offsets, (float*)cols, C, H, W, G, Ho,
      Wo, kh, kw, stride, pad, dil, n_chunks);
  return (int)cudaGetLastError();
}

const char* deform_im2col_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
