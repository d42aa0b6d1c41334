// SP mask loss (forward and backward) for SipMask training.
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/mask_loss.py:
// _fused_fwd_call (:248, body _fwd_kernel :98) and _fused_bwd_call (:282,
// body _bwd_kernel :132). Semantics: crop_split.mask_bce_loss_indexed
// (sipmask_tpu/ops/crop_split.py:159-189) per image. For image b and
// positive k with box (x1, y1, x2, y2) in mask coordinates:
//
//   pre[b, k] = sum over pixels p inside the box of
//               max(s, 0) - s*y + log(1 + exp(-|s|)),
//   s = sum_n basis[b, n, p] * cofs[b, k, q(p)*NB + n],
//   y = gt[b, gt_idx[b, k], p],
//
// with CropSplit's rules: p = (ph, pw) is inside iff pw >= x1, pw < x2,
// ph >= y1, ph < y2 (float compares); it is right of the half-split iff
// pw >= x1 + (x2 - x1 + 0.1)/2 and below it iff ph >= y1 + (y2 - y1 + 0.1)/2;
// q = 2*below + right. Pixels outside the box contribute exactly 0. The
// backward gives d basis and d cofs for a cotangent g[b, k]; boxes and gt
// take no gradient.
//
// Layouts (contiguous): basis (B, NB, H, W) f32 (the head's NCHW output),
// cofs (B, K, 4*NB) f32 [q0 | q1 | q2 | q3], boxes (B, K, 4) f32, gt
// (B, G, H, W) uint8 in {0, 1}, gt_idx (B, K) int64, valid (B, K) uint8,
// g (B, K) f32.
//
// What bounds it on an H100: the (pixel, positive) pairs inside the boxes,
// a 32-term dot and a BCE each (~76 flops). FCOS positives of one gt predict
// nearly the same box, so the boxes of an image overlap heavily and a pixel
// lies in ~100 of them; a kernel that visits the pairs positive by positive
// reads each pixel's 32 basis values once per pair (13 GB at 400x672,
// K = 512, batch 4: HBM-bound at 3.9 ms). The TPU kernel ran every
// 128-positive chunk over dense 512-pixel tiles on its matrix unit, behind a
// y1 sort and chunk flags, because the TPU has no cheap gather. Here:
//   - forward: one block per 16x32 pixel tile, two rows a warp. Each thread
//     loads its two pixels' 32 basis values once, into registers, and (for
//     G <= 64 gt planes) their gt memberships as bits, so a (pixel,
//     positive) pair reads no memory but shared. The block walks the
//     positives in chunks of kFwdChunk, compacts the ones whose box touches
//     the tile into a list in shared memory with their coefficients, and
//     each warp skips, uniformly, a box that misses its rows; one read of a
//     quadrant's coefficients serves the warp's two rows (shared-memory
//     reads bound this loop: 8 float4 broadcasts a warp per positive). Each
//     (tile, positive) pair writes one partial: shuffles within a warp, the
//     8 warps in order. A fold kernel adds each positive's partials over the
//     tiles its box touches; both kernels decide "touches" by tile_span, so
//     the fold reads exactly the partials written (no memset, no atomics:
//     every run gives the same bits).
//   - d cofs: one block per (positive, row slice, image). It walks the four
//     quadrant rectangles of its box, clipped to the map, with the
//     quadrant's 32 coefficients in registers; rows are dealt to kSlices
//     blocks in turn so that a large box does not leave SMs idle while a
//     small one finishes. Each block writes one partial per coefficient; a
//     fold kernel adds the kSlices partials in a fixed order. Positives that
//     are invalid or whose cotangent is 0 write zeros and stop.
//   - d basis: one block per 8x32 pixel tile. Each thread keeps its pixel's
//     32 basis values and 32 gradient sums in registers and walks the
//     positives in order, skipping (uniformly, per block) those whose box
//     misses the tile. No atomics: every element of d basis is written once,
//     in a fixed order. Atomics from the per-positive blocks would be the
//     other choice; they scatter 32 values per (pixel, positive) and change
//     their order from run to run.
// The integer bounds are conservative (floor/ceil of the box, clipped to the
// map); the exact float tests above decide each pixel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NB = 32;           // basis masks (HeadConfig.num_bases)
constexpr int kThreads = 256;
constexpr int kSlices = 8;       // row slices of a box, one block each
constexpr int kTileH = 8, kTileW = 32;      // d basis: pixel tiles
constexpr int kChunk = 256;      // d basis: positives tested at once
constexpr int kFwdTileH = 16, kFwdTileW = 32;  // forward: pixel tiles
constexpr int kFwdChunk = 64;    // forward: positives staged at once
// forward: a staged positive's coefficients, each quadrant padded from NB to
// kQStride floats, so that the two quadrants a warp reads (left and right
// of the split) lie in different banks
constexpr int kQStride = NB + 4;
static_assert(kFwdChunk == 64, "the hit list is compacted by two warps");
static_assert(kTileH * kTileW == kThreads, "one thread per tile pixel");
static_assert(kFwdTileH * kFwdTileW == 2 * kThreads, "two pixels a thread");

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// floor(v) clipped to [lo, hi]; NaN gives lo
__device__ __forceinline__ int clip_floor(float v, int lo, int hi) {
  const float f = floorf(v);
  if (!(f > (float)lo)) return lo;
  if (f >= (float)hi) return hi;
  return (int)f;
}

// ceil(v) clipped to [lo, hi]; NaN gives lo
__device__ __forceinline__ int clip_ceil(float v, int lo, int hi) {
  const float f = ceilf(v);
  if (!(f > (float)lo)) return lo;
  if (f >= (float)hi) return hi;
  return (int)f;
}

struct Box {
  float x1, y1, x2, y2, xm, ym;  // xm, ym: the half-split thresholds
  int c_lo, c_hi, r_lo, r_hi;    // conservative integer bounds in the map
};

__device__ __forceinline__ Box load_box(const float* bx, int H, int W) {
  Box o;
  o.x1 = bx[0];
  o.y1 = bx[1];
  o.x2 = bx[2];
  o.y2 = bx[3];
  o.xm = o.x1 + (o.x2 - o.x1 + 0.1f) * 0.5f;
  o.ym = o.y1 + (o.y2 - o.y1 + 0.1f) * 0.5f;
  o.c_lo = clip_floor(o.x1, 0, W);
  o.c_hi = clip_ceil(o.x2, -1, W - 1);
  o.r_lo = clip_floor(o.y1, 0, H);
  o.r_hi = clip_ceil(o.y2, -1, H - 1);
  return o;
}

__device__ __forceinline__ bool inside(const Box& bx, float ph, float pw) {
  return pw >= bx.x1 && pw < bx.x2 && ph >= bx.y1 && ph < bx.y2;
}

__device__ __forceinline__ int quadrant(const Box& bx, float ph, float pw) {
  return (ph >= bx.ym ? 2 : 0) + (pw >= bx.xm ? 1 : 0);
}

// The kFwdTileH x kFwdTileW tiles a box may touch: tile rows [ty0, ty1],
// tile columns [tx0, tx1]. False when its integer bounds hold no pixel of the map
// (off the map, degenerate or NaN). The forward's tile kernel and its fold
// both decide by this function, so the fold reads exactly the partials the
// tile kernel wrote.
__device__ __forceinline__ bool tile_span(const Box& bx, int& ty0, int& ty1,
                                          int& tx0, int& tx1) {
  if (bx.c_lo > bx.c_hi || bx.r_lo > bx.r_hi) return false;
  ty0 = bx.r_lo / kFwdTileH;
  ty1 = bx.r_hi / kFwdTileH;
  tx0 = bx.c_lo / kFwdTileW;
  tx1 = bx.c_hi / kFwdTileW;
  return true;
}

// Conservative rectangle of quadrant q (rows [r0, r1], cols [c0, c1]).
__device__ __forceinline__ void quad_rect(const Box& bx, int q, int H, int W,
                                          int& r0, int& r1, int& c0,
                                          int& c1) {
  const int rm_lo = clip_floor(bx.ym, 0, H);      // first row that may be
  const int rm_hi = clip_ceil(bx.ym, -1, H - 1);  // below; last that may not
  const int cm_lo = clip_floor(bx.xm, 0, W);
  const int cm_hi = clip_ceil(bx.xm, -1, W - 1);
  r0 = (q & 2) ? max(bx.r_lo, rm_lo) : bx.r_lo;
  r1 = (q & 2) ? bx.r_hi : min(bx.r_hi, rm_hi);
  c0 = (q & 1) ? max(bx.c_lo, cm_lo) : bx.c_lo;
  c1 = (q & 1) ? bx.c_hi : min(bx.c_hi, cm_hi);
}

// A positive staged by the forward's tile kernel: its box, half-split
// thresholds and conservative row bounds (two 16-byte shared reads).
struct __align__(16) Staged {
  float x1, y1, x2, y2, xm, ym;
  int r_lo, r_hi;
};

__device__ __forceinline__ float bce_term(float s, float y) {
  return fmaxf(s, 0.f) - s * y + log1pf(expf(-fabsf(s)));
}

// s0 = v0 . c0 and s1 = v1 . c1 over NB terms, four partial sums each;
// kSame: c1 is c0, read once
template <bool kSame>
__device__ __forceinline__ void dot2(const float4* c0, const float4* c1,
                                     const float (&v0)[NB],
                                     const float (&v1)[NB], float& s0,
                                     float& s1) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
  for (int m = 0; m < NB / 4; ++m) {
    const float4 c = c0[m];
    const float4 d = kSame ? c : c1[m];
    a0 = fmaf(v0[4 * m], c.x, a0);
    a1 = fmaf(v0[4 * m + 1], c.y, a1);
    a2 = fmaf(v0[4 * m + 2], c.z, a2);
    a3 = fmaf(v0[4 * m + 3], c.w, a3);
    b0 = fmaf(v1[4 * m], d.x, b0);
    b1 = fmaf(v1[4 * m + 1], d.y, b1);
    b2 = fmaf(v1[4 * m + 2], d.z, b2);
    b3 = fmaf(v1[4 * m + 3], d.w, b3);
  }
  s0 = (a0 + a1) + (a2 + a3);
  s1 = (b0 + b1) + (b2 + b3);
}

// K3a, pixel tiles. grid (ceil(W/kFwdTileW), ceil(H/kFwdTileH), B), block
// 32 x 8: warp w holds tile rows 2w and 2w + 1, one pixel of each a lane.
// For each valid positive k whose tile_span holds this tile t (of
// T = gridDim.x * gridDim.y): partial[(b*K + k)*T + t] = the tile's BCE sum
// of k. Nothing else is written. kBits (G <= 64): each thread keeps its
// pixels' gt as bit masks over the G planes, read once; otherwise each
// (pixel, positive) reads its gt byte.
// 2 blocks an SM caps it at 128 registers (64 of them basis values):
// uncapped it takes ~170 and runs 1.6x slower at 1 block an SM.
template <bool kBits>
__global__ void __launch_bounds__(kThreads, 2) mask_bce_fwd_tiles_kernel(
    const float* __restrict__ basis, const float* __restrict__ cofs,
    const float* __restrict__ boxes, const uint8_t* __restrict__ gt,
    const int64_t* __restrict__ gt_idx, const uint8_t* __restrict__ valid,
    float* __restrict__ partial, int K, int G, int H, int W) {
  const int b = blockIdx.z;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int64_t tile = (int64_t)ty * gridDim.x + tx;
  const int64_t T = (int64_t)gridDim.x * gridDim.y;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int row0 = ty * kFwdTileH + 2 * warp, row1 = row0 + 1;
  const int col = tx * kFwdTileW + lane;
  const bool in0 = row0 < H && col < W, in1 = row1 < H && col < W;
  const int64_t HW = (int64_t)H * W;
  const int64_t p0 = in0 ? (int64_t)row0 * W + col : 0;
  const int64_t p1 = in1 ? (int64_t)row1 * W + col : 0;
  const float ph0 = (float)row0, ph1 = (float)row1, pw = (float)col;

  __shared__ __align__(16) float s_cofs[kFwdChunk * 4 * kQStride];
  __shared__ Staged s_box[kFwdChunk];
  __shared__ int64_t s_gt[kFwdChunk];  // gt plane (kBits) or its offset
  __shared__ int s_k[kFwdChunk];
  __shared__ float red[kThreads / 32][kFwdChunk];
  __shared__ unsigned s_ballot[2];

  const float* bb = basis + (int64_t)b * NB * HW;
  float v0[NB], v1[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    v0[n] = in0 ? __ldg(bb + n * HW + p0) : 0.f;
    v1[n] = in1 ? __ldg(bb + n * HW + p1) : 0.f;
  }
  // bit g of (hi:lo): the pixel lies in gt plane g
  uint32_t g0lo = 0u, g0hi = 0u, g1lo = 0u, g1hi = 0u;
  if (kBits) {
    const uint8_t* gb = gt + (int64_t)b * G * HW;
#pragma unroll 4
    for (int g = 0; g < G; ++g) {
      const uint32_t y0 = (in0 && gb[g * HW + p0]) ? 1u : 0u;
      const uint32_t y1 = (in1 && gb[g * HW + p1]) ? 1u : 0u;
      if (g < 32) {
        g0lo |= y0 << g;
        g1lo |= y1 << g;
      } else {
        g0hi |= y0 << (g - 32);
        g1hi |= y1 << (g - 32);
      }
    }
  }

  for (int k0 = 0; k0 < K; k0 += kFwdChunk) {
    const int kn = min(kFwdChunk, K - k0);
    __syncthreads();  // the previous chunk's staging is no longer read
    // 1. which positives of the chunk touch this tile, compacted in order
    bool hit = false;
    Box bx;
    if (tid < kn) {
      const int64_t bk = (int64_t)b * K + k0 + tid;
      if (valid[bk] != 0) {
        bx = load_box(boxes + bk * 4, H, W);
        int ty0, ty1, tx0, tx1;
        hit = tile_span(bx, ty0, ty1, tx0, tx1) && ty0 <= ty && ty <= ty1 &&
              tx0 <= tx && tx <= tx1;
      }
    }
    if (warp < 2) {
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_ballot[warp] = m;
    }
    __syncthreads();
    const unsigned m0 = s_ballot[0], m1 = s_ballot[1];
    const int nhit = __popc(m0) + __popc(m1);
    if (nhit == 0) continue;  // uniform over the block
    if (hit) {
      const unsigned below = (1u << lane) - 1u;
      const int slot = warp == 0 ? __popc(m0 & below)
                                 : __popc(m0) + __popc(m1 & below);
      const int64_t bk = (int64_t)b * K + k0 + tid;
      const int64_t gi = gt_idx[bk];
      s_k[slot] = k0 + tid;
      s_box[slot] = {bx.x1, bx.y1, bx.x2, bx.y2, bx.xm, bx.ym, bx.r_lo,
                     bx.r_hi};
      // a gt index outside [0, G) reads as an empty mask
      s_gt[slot] = !(gi >= 0 && gi < G) ? -1
                   : kBits             ? gi
                                       : ((int64_t)b * G + gi) * HW;
    }
    __syncthreads();
    // 2. the hits' coefficients, quadrant q of hit j at (j*4 + q)*kQStride
    for (int e = tid; e < nhit * 4 * NB; e += kThreads) {
      const int j = e / (4 * NB), c = e - j * 4 * NB;
      s_cofs[(j * 4 + c / NB) * kQStride + c % NB] =
          __ldg(cofs + ((int64_t)b * K + s_k[j]) * 4 * NB + c);
    }
    __syncthreads();
    // 3. each warp's sum of each hit over its 64 pixels. The two rows of a
    // warp are on one side of the box's half-split but where it passes
    // between them, so one read of the quadrant's coefficients serves both
    for (int j = 0; j < nhit; ++j) {
      const Staged sb = s_box[j];
      const bool r0 = row0 >= sb.r_lo && row0 <= sb.r_hi;  // uniform over
      const bool r1 = row1 >= sb.r_lo && row1 <= sb.r_hi;  // the warp
      float t = 0.f;
      if (r0 || r1) {
        const int right = pw >= sb.xm ? 1 : 0;
        const int q0 = (ph0 >= sb.ym ? 2 : 0) + right;
        const int q1 = (ph1 >= sb.ym ? 2 : 0) + right;
        const float4* c0 = reinterpret_cast<const float4*>(
            s_cofs + (j * 4 + q0) * kQStride);
        const float4* c1 = reinterpret_cast<const float4*>(
            s_cofs + (j * 4 + q1) * kQStride);
        float s0, s1;
        if (q0 == q1)  // uniform over the warp
          dot2<true>(c0, c1, v0, v1, s0, s1);
        else
          dot2<false>(c0, c1, v0, v1, s0, s1);
        const bool cin = pw >= sb.x1 && pw < sb.x2;
        const int64_t gj = s_gt[j];
        float y0 = 0.f, y1 = 0.f;
        if (gj >= 0) {
          if (kBits) {
            const bool hi = gj >= 32;
            const int sh = (int)gj & 31;
            y0 = (float)(((hi ? g0hi : g0lo) >> sh) & 1u);
            y1 = (float)(((hi ? g1hi : g1lo) >> sh) & 1u);
          } else {
            y0 = (float)gt[gj + p0];
            y1 = (float)gt[gj + p1];
          }
        }
        float e = 0.f;
        if (in0 && cin && ph0 >= sb.y1 && ph0 < sb.y2) e = bce_term(s0, y0);
        if (in1 && cin && ph1 >= sb.y1 && ph1 < sb.y2) e += bce_term(s1, y1);
        t = warp_sum(e);
      }
      if (lane == 0) red[warp][j] = t;
    }
    __syncthreads();
    // 4. the 8 warps' sums in order: one partial per hit
    for (int j = tid; j < nhit; j += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) t += red[w][j];
      partial[((int64_t)b * K + s_k[j]) * T + tile] = t;
    }
  }
}

// K3a, the fold: one warp per (image, positive). pre[bk] = the sum of
// partial[bk*T + t] over the tiles t of the box's tile_span (tile ty, tx is
// t = ty*TX + tx): lane i adds the span's tiles i, i + 32, ... in tile
// order, then the warp's shuffle tree adds the 32 lane sums. Invalid or
// empty positives give 0.
__global__ void mask_bce_fold_tiles_kernel(const float* __restrict__ boxes,
                                           const uint8_t* __restrict__ valid,
                                           const float* __restrict__ partial,
                                           float* __restrict__ pre,
                                           int64_t BK, int H, int W, int TX,
                                           int64_t T) {
  const int64_t bk = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bk >= BK) return;  // uniform over the warp
  float acc = 0.f;
  int ty0, ty1, tx0, tx1;
  if (valid[bk] != 0 &&
      tile_span(load_box(boxes + bk * 4, H, W), ty0, ty1, tx0, tx1)) {
    const int nx = tx1 - tx0 + 1, n = (ty1 - ty0 + 1) * nx;
    const float* pp = partial + bk * T;
    for (int e = lane; e < n; e += 32) {
      const int r = e / nx;
      acc += pp[(int64_t)(ty0 + r) * TX + tx0 + (e - r * nx)];
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) pre[bk] = acc;
}

// K3b, d cofs: partial[(bk*S + s)*4*NB + q*NB + n] = this slice's sum of
// g*(sigmoid(s) - y)*basis[n] over quadrant q. grid (kSlices, K, B)
__global__ void __launch_bounds__(kThreads) mask_bce_slices_kernel(
    const float* __restrict__ basis, const float* __restrict__ cofs,
    const float* __restrict__ boxes, const uint8_t* __restrict__ gt,
    const int64_t* __restrict__ gt_idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ gk, float* __restrict__ partial, int K, int G,
    int H, int W) {
  const int s = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int64_t bk = (int64_t)b * K + k;
  const int64_t HW = (int64_t)H * W;
  __shared__ float red32[kThreads / 32][NB];

  const float gval = gk[bk];
  const int64_t gi = gt_idx[bk];
  const bool live = valid[bk] != 0 && gval != 0.f;
  if (!live) {  // uniform over the block
    for (int i = threadIdx.x; i < 4 * NB; i += kThreads)
      partial[(bk * kSlices + s) * 4 * NB + i] = 0.f;
    return;
  }
  const Box bx = load_box(boxes + bk * 4, H, W);
  const float* bb = basis + (int64_t)b * NB * HW;
  // a gt index outside [0, G) reads as an empty mask
  const uint8_t* gm = (gi >= 0 && gi < G) ? gt + ((int64_t)b * G + gi) * HW
                                          : nullptr;
  for (int q = 0; q < 4; ++q) {
    float c[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) c[n] = __ldg(cofs + bk * 4 * NB + q * NB + n);
    float acc[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[n] = 0.f;

    int r0, r1, c0, c1;
    quad_rect(bx, q, H, W, r0, r1, c0, c1);
    const int wc = c1 - c0 + 1;
    // rows r0 + s, r0 + s + kSlices, ... of the rectangle are this block's
    const int nr = (r1 - r0 - s) >= 0 ? (r1 - r0 - s) / kSlices + 1 : 0;
    const int n_pix = wc > 0 ? nr * wc : 0;
    for (int e = threadIdx.x; e < n_pix; e += kThreads) {
      const int i = e / wc;
      const int col = c0 + (e - i * wc);
      const int row = r0 + s + i * kSlices;
      const float ph = (float)row, pw = (float)col;
      if (!inside(bx, ph, pw) || quadrant(bx, ph, pw) != q) continue;
      const int64_t p = (int64_t)row * W + col;
      float v[NB];
      float sl = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        v[n] = __ldg(bb + n * HW + p);
        sl += v[n] * c[n];
      }
      const float y = gm ? (float)gm[p] : 0.f;
      const float d = gval * (1.f / (1.f + expf(-sl)) - y);
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[n] += d * v[n];
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float t = warp_sum(acc[n]);
      if (lane == 0) red32[warp][n] = t;
    }
    __syncthreads();
    if (threadIdx.x < NB) {
      float t = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t += red32[w][threadIdx.x];
      partial[(bk * kSlices + s) * 4 * NB + q * NB + threadIdx.x] = t;
    }
    __syncthreads();  // red32 is reused by the next quadrant
  }
}

// out[i*L + j] = sum over s < kSlices of partial[(i*kSlices + s)*L + j],
// in order. grid-stride over n*L outputs.
__global__ void fold_slices_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int64_t n,
                                   int L) {
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n * L; t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = t / L, j = t - i * L;
    float acc = 0.f;
    for (int s = 0; s < kSlices; ++s) acc += partial[(i * kSlices + s) * L + j];
    out[t] = acc;
  }
}

// d basis, grid (ceil(W/kTileW), ceil(H/kTileH), B), block kTileW x kTileH.
__global__ void __launch_bounds__(kThreads) mask_bce_dbasis_kernel(
    const float* __restrict__ basis, const float* __restrict__ cofs,
    const float* __restrict__ boxes, const uint8_t* __restrict__ gt,
    const int64_t* __restrict__ gt_idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ gk, float* __restrict__ dbasis, int K, int G,
    int H, int W) {
  const int b = blockIdx.z;
  const int tr0 = blockIdx.y * kTileH, tc0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int row = tr0 + threadIdx.y, col = tc0 + threadIdx.x;
  const bool in_map = row < H && col < W;
  const int64_t HW = (int64_t)H * W;
  const int64_t p = in_map ? (int64_t)row * W + col : 0;
  const float ph = (float)row, pw = (float)col;
  const float* bb = basis + (int64_t)b * NB * HW;

  float v[NB], acc[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    v[n] = in_map ? __ldg(bb + n * HW + p) : 0.f;
    acc[n] = 0.f;
  }
  __shared__ unsigned char hit[kChunk];
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    __syncthreads();  // hit[] of the previous chunk is no longer read
    for (int i = tid; i < kn; i += kThreads) {
      const int64_t bk = (int64_t)b * K + k0 + i;
      bool h = valid[bk] != 0 && gk[bk] != 0.f;
      if (h) {
        const Box bx = load_box(boxes + bk * 4, H, W);
        h = bx.c_lo <= bx.c_hi && bx.r_lo <= bx.r_hi &&
            bx.c_lo <= tc0 + kTileW - 1 && bx.c_hi >= tc0 &&
            bx.r_lo <= tr0 + kTileH - 1 && bx.r_hi >= tr0;
      }
      hit[i] = h;
    }
    __syncthreads();
    for (int i = 0; i < kn; ++i) {
      if (!hit[i]) continue;  // uniform over the block
      const int64_t bk = (int64_t)b * K + k0 + i;
      const Box bx = load_box(boxes + bk * 4, H, W);
      if (!in_map || !inside(bx, ph, pw)) continue;
      const float* c = cofs + bk * 4 * NB + quadrant(bx, ph, pw) * NB;
      float sl = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) sl += v[n] * __ldg(c + n);
      const int64_t gi = gt_idx[bk];
      const float y = (gi >= 0 && gi < G)
                          ? (float)gt[((int64_t)b * G + gi) * HW + p]
                          : 0.f;
      const float d = gk[bk] * (1.f / (1.f + expf(-sl)) - y);
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[n] += d * __ldg(c + n);
    }
  }
  if (in_map) {
    float* db = dbasis + (int64_t)b * NB * HW + p;
#pragma unroll
    for (int n = 0; n < NB; ++n) db[n * HW] = acc[n];
  }
}

int64_t num_fwd_tiles(int H, int W) {
  return (int64_t)((H + kFwdTileH - 1) / kFwdTileH) *
         ((W + kFwdTileW - 1) / kFwdTileW);
}

}  // namespace

extern "C" {

int mask_bce_num_bases() { return NB; }
int mask_bce_num_slices() { return kSlices; }

// Floats of scratch mask_bce_fwd_f32 takes: one partial per (image,
// positive, pixel tile).
int64_t mask_bce_fwd_scratch(int B, int K, int H, int W) {
  return (int64_t)B * K * num_fwd_tiles(H, W);
}

// pre (B, K) f32; partial: mask_bce_fwd_scratch(B, K, H, W) floats of
// scratch. Two launches, the tile kernel and the fold. Returns the
// cudaError_t of the first failed launch (0 on success).
int mask_bce_fwd_f32(const void* basis, const void* cofs, const void* boxes,
                     const void* gt, const void* gt_idx, const void* valid,
                     void* partial, void* pre, int B, int K, int G, int H,
                     int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tx = (W + kFwdTileW - 1) / kFwdTileW;
  const dim3 grid(tx, (H + kFwdTileH - 1) / kFwdTileH, B);
  auto kernel = G <= 64 ? mask_bce_fwd_tiles_kernel<true>
                        : mask_bce_fwd_tiles_kernel<false>;
  kernel<<<grid, dim3(32, kThreads / 32), 0, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int64_t*)gt_idx, (const uint8_t*)valid,
      (float*)partial, K, G, H, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t bk = (int64_t)B * K;
  const int warps = kThreads / 32;
  mask_bce_fold_tiles_kernel<<<(unsigned)((bk + warps - 1) / warps), kThreads,
                               0, st>>>(
      (const float*)boxes, (const uint8_t*)valid, (const float*)partial,
      (float*)pre, bk, H, W, tx, num_fwd_tiles(H, W));
  return (int)cudaGetLastError();
}

// dbasis (B, NB, H, W), dcofs (B, K, 4*NB) f32; partial: B*K*kSlices*4*NB
// floats of scratch.
int mask_bce_bwd_f32(const void* basis, const void* cofs, const void* boxes,
                     const void* gt, const void* gt_idx, const void* valid,
                     const void* g, void* partial, void* dbasis, void* dcofs,
                     int B, int K, int G, int H, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(kSlices, K, B);
  mask_bce_slices_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int64_t*)gt_idx, (const uint8_t*)valid,
      (const float*)g, (float*)partial, K, G, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * K * 4 * NB;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 4096
                               ? (total + kThreads - 1) / kThreads
                               : 4096);
  if (total > 0)
    fold_slices_kernel<<<blocks, kThreads, 0, st>>>(
        (const float*)partial, (float*)dcofs, (int64_t)B * K, 4 * NB);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 tgrid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  mask_bce_dbasis_kernel<<<tgrid, dim3(kTileW, kTileH), 0, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int64_t*)gt_idx, (const uint8_t*)valid,
      (const float*)g, (float*)dbasis, K, G, H, W);
  return (int)cudaGetLastError();
}

const char* mask_bce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
