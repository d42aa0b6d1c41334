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
// backward gives, for a cotangent g[b, k] and d = g*(sigmoid(s) - y) at each
// in-box pixel, d basis[b, :, p] += d*cofs[b, k, q(p)*NB:] and
// d cofs[b, k, q(p)*NB:] += d*basis[b, :, p]; boxes and gt take no gradient.
//
// Layouts (contiguous): basis (B, NB, H, W) f32 (the head's NCHW output),
// cofs (B, K, 4*NB) f32 [q0 | q1 | q2 | q3], boxes (B, K, 4) f32, gt
// (B, G, H, W) uint8 in {0, 1}, gt_idx (B, K) int64, valid (B, K) uint8,
// g (B, K) f32.
//
// What bounds it on an H100: the (pixel, positive) pairs inside the boxes:
// a 32-term dot and a BCE each forward (~76 flops), the dot, a sigmoid and
// two 32-term updates backward (~200). FCOS positives of one gt predict
// nearly the same box, so the boxes of an image overlap heavily and a pixel
// lies in ~100 of them; a kernel that visits the pairs positive by positive
// reads each pixel's 32 basis values once per pair (13 GB at 400x672,
// K = 512, batch 4: HBM-bound at 3.9 ms). The TPU kernel ran every
// 128-positive chunk over dense 512-pixel tiles on its matrix unit, behind a
// y1 sort and chunk flags, because the TPU has no cheap gather. Here every
// kernel is tile-major over kTileH x kTileW pixel tiles, so the pairs read
// no memory but shared and HBM carries ~0.2 GB forward, ~0.5 GB backward.
// Each loop is bound by instruction issue and the latency of its chains
// (shared reads, FMAs, exp, shuffles) that its warps cannot hide:
//   - staging (every tile kernel; the backward's in stage_chunk): the
//     block walks the positives in chunks of kChunk, compacts the ones
//     whose box touches the tile into a list in shared memory with their
//     coefficients (each quadrant padded to kQStride floats; the backward
//     copies them with cp.async, all in flight at once), and each warp
//     skips, uniformly, a box that misses its rows. Each thread loads its
//     pixels' 32 basis values once, into registers, and (for G <= 64 gt
//     planes) their gt memberships as bits. The forward keeps its own
//     staging: through stage_chunk its tile kernel ran 3% slower.
//   - forward: two rows a warp; one float4 read of a quadrant's
//     coefficients serves both rows. Each (tile, positive) pair writes one
//     partial: shuffles within a warp, the 8 warps in order. A fold kernel
//     adds each positive's partials over the tiles its box touches; both
//     decide "touches" by tile_span, so the fold reads exactly the partials
//     written (no memset, no atomics: every run gives the same bits).
//   - d basis: one pixel a thread, one row a warp (two pixels would hold
//     128 values and spill), in blocks of a quarter tile (kDbRows rows),
//     so that four blocks share an SM and some compute while others stage.
//     Its 32 gradient sums stay in registers, each hit's quadrant
//     coefficients are read once for the dot and the update, the hits are
//     added in order and each element is written once.
//   - d cofs: two rows a warp, as the forward. Each lane forms its pixels'
//     32 products d*basis for a quadrant, and a warp reduce-scatter (31
//     shuffles, five latencies) leaves coefficient n's sum in lane n; the 8
//     warps' sums go through shared memory and are added in warp order.
//     Each (tile, positive, quadrant) whose conservative rectangle
//     (quad_tile_span) touches the tile writes one 32-float segment, and a
//     fold kernel adds each quadrant's segments in tile order, deciding by
//     the same predicate: no memset, no atomics.
// The integer bounds are conservative (floor/ceil of the box, clipped to the
// map); the exact float tests above decide each pixel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NB = 32;           // basis masks (HeadConfig.num_bases)
constexpr int kThreads = 256;    // forward and d cofs: 8 warps, 2 rows each
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16, kTileW = 32;  // pixel tiles of every tile kernel
constexpr int kDbRows = 4;       // d basis: tile rows a block, one a warp
constexpr int kDbThreads = 32 * kDbRows;  // d basis: a pixel a thread
constexpr int kChunk = 64;       // positives staged at once
constexpr int kSub = 8;          // d cofs: hits whose warp sums fold at once
// a staged positive's coefficients, each quadrant padded from NB to
// kQStride floats, so that the two quadrants a warp reads (left and right
// of the split) lie in different banks
constexpr int kQStride = NB + 4;
constexpr unsigned kFull = 0xffffffffu;
// floats of shared memory a Stage's arrays take: cofs, box (8 words), gt
// (2), k, g, quads (1 each) per staged positive, and the two ballot words
constexpr int kStageFloats = kChunk * (4 * kQStride + 8 + 2 + 3) + 2;
static_assert(kChunk == 64, "the hit list is compacted by two warps");
static_assert(kTileH * kTileW == 2 * kThreads, "two pixels a thread");
static_assert(kTileH % kDbRows == 0 && kTileW == 32, "d basis blocks");

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
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

// The tiles a box may touch: tile rows [ty0, ty1], tile columns [tx0, tx1].
// False when its integer bounds hold no pixel of the map (off the map,
// degenerate or NaN). The forward's tile kernel and its fold both decide by
// this function, so the fold reads exactly the partials the tile kernel
// wrote; the backward's tile kernels stage by it.
__device__ __forceinline__ bool tile_span(const Box& bx, int& ty0, int& ty1,
                                          int& tx0, int& tx1) {
  if (bx.c_lo > bx.c_hi || bx.r_lo > bx.r_hi) return false;
  ty0 = bx.r_lo / kTileH;
  ty1 = bx.r_hi / kTileH;
  tx0 = bx.c_lo / kTileW;
  tx1 = bx.c_hi / kTileW;
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

// The tiles quadrant q of a box may touch (its quad_rect's tiles); false
// when the rectangle holds no pixel of the map. A live positive (valid, its
// cotangent not 0) writes a d cofs segment for exactly these (tile, q) and
// the fold adds exactly these, so the scratch is neither cleared nor stale.
__device__ __forceinline__ bool quad_tile_span(const Box& bx, int q, int H,
                                               int W, int& ty0, int& ty1,
                                               int& tx0, int& tx1) {
  if (bx.c_lo > bx.c_hi || bx.r_lo > bx.r_hi) return false;
  int r0, r1, c0, c1;
  quad_rect(bx, q, H, W, r0, r1, c0, c1);
  if (r0 > r1 || c0 > c1) return false;
  ty0 = r0 / kTileH;
  ty1 = r1 / kTileH;
  tx0 = c0 / kTileW;
  tx1 = c1 / kTileW;
  return true;
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, cached in L2 only); both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A staged positive: its box, half-split thresholds and conservative row
// bounds (two 16-byte shared reads).
struct __align__(16) Staged {
  float x1, y1, x2, y2, xm, ym;
  int r_lo, r_hi;
};
static_assert(sizeof(Staged) == 8 * 4, "a staged box is 8 words");

// Where stage_chunk leaves the hits of one chunk (positives whose box
// touches the block's tile), hit j in chunk order, in shared arrays of
// kChunk entries (cofs: kChunk * 4 * kQStride floats, quadrant q of hit j
// at (j*4 + q)*kQStride; gt: the gt plane (kBits) or its offset, -1 for an
// empty mask; g: the cotangent; quads: bit q set when quadrant q's
// quad_tile_span holds the tile).
struct Stage {
  float* cofs;
  Staged* box;
  int64_t* gt;
  int* k;
  float* g;
  int* quads;
  unsigned* ballot;  // two words
};

// A Stage's arrays laid out from smem (16-byte aligned) on: kStageFloats
// floats.
__device__ __forceinline__ Stage stage_at(float* smem) {
  Stage st;
  st.cofs = smem;
  smem += kChunk * 4 * kQStride;
  st.box = reinterpret_cast<Staged*>(smem);
  smem += kChunk * 8;
  st.gt = reinterpret_cast<int64_t*>(smem);
  smem += kChunk * 2;
  st.k = reinterpret_cast<int*>(smem);
  smem += kChunk;
  st.g = smem;
  smem += kChunk;
  st.quads = reinterpret_cast<int*>(smem);
  smem += kChunk;
  st.ballot = reinterpret_cast<unsigned*>(smem);
  return st;
}

// The backward's staging. Stages the positives k0 .. k0 + kChunk - 1
// (below K) of image b that are valid and whose cotangent is not 0, whose
// tile_span holds tile (ty, tx) and whose rows meet [rlo, rhi] (the
// block's rows), in order; returns their count. Every thread
// of the block (kNT of them) calls it: it begins with a barrier, so the
// previous chunk's staging is no longer read, and ends with one unless it
// returns 0. Each step issues all of its global loads before it waits.
template <int kNT, bool kBits>
__device__ __forceinline__ int stage_chunk(
    const Stage& st, const float* __restrict__ cofs,
    const float* __restrict__ boxes, const int64_t* __restrict__ gt_idx,
    const uint8_t* __restrict__ valid, const float* __restrict__ gk, int b,
    int k0, int K, int G, int H, int W, int ty, int tx, int rlo, int rhi,
    int tid) {
  const int kn = min(kChunk, K - k0);
  const int lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  // 1. which positives of the chunk touch this tile, compacted in order
  bool hit = false;
  Box bx;
  float gv = 0.f;
  int64_t gi = -1;
  if (tid < kn) {
    const int64_t bk = (int64_t)b * K + k0 + tid;
    const bool live = valid[bk] != 0;
    gv = gk[bk];
    gi = gt_idx[bk];
    bx = load_box(boxes + bk * 4, H, W);
    int ty0, ty1, tx0, tx1;
    hit = live && gv != 0.f &&
          tile_span(bx, ty0, ty1, tx0, tx1) && ty0 <= ty && ty <= ty1 &&
          tx0 <= tx && tx <= tx1 && bx.r_lo <= rhi && bx.r_hi >= rlo;
  }
  if (warp < 2) {
    const unsigned m = __ballot_sync(kFull, hit);
    if (lane == 0) st.ballot[warp] = m;
  }
  __syncthreads();
  const unsigned m0 = st.ballot[0], m1 = st.ballot[1];
  const int nhit = __popc(m0) + __popc(m1);
  if (nhit == 0) return 0;  // uniform over the block
  if (hit) {
    const unsigned below = (1u << lane) - 1u;
    const int slot = warp == 0 ? __popc(m0 & below)
                               : __popc(m0) + __popc(m1 & below);
    st.k[slot] = k0 + tid;
    st.box[slot] = {bx.x1, bx.y1, bx.x2, bx.y2, bx.xm, bx.ym, bx.r_lo,
                    bx.r_hi};
    // a gt index outside [0, G) reads as an empty mask
    st.gt[slot] = !(gi >= 0 && gi < G) ? -1
                  : kBits             ? gi
                                      : ((int64_t)b * G + gi) * H * W;
    st.g[slot] = gv;
    int quads = 0;
    for (int q = 0; q < 4; ++q) {
      int ty0, ty1, tx0, tx1;
      if (quad_tile_span(bx, q, H, W, ty0, ty1, tx0, tx1) && ty0 <= ty &&
          ty <= ty1 && tx0 <= tx && tx <= tx1)
        quads |= 1 << q;
    }
    st.quads[slot] = quads;
  }
  __syncthreads();
  // 2. the hits' coefficients: float4 c of hit j to quadrant c / kQ4,
  // copied without registers (cp.async), so all of them are in flight
  constexpr int kQ4 = NB / 4;
  const float* src = cofs + (int64_t)b * K * 4 * NB;
  for (int e = tid; e < nhit * 4 * kQ4; e += kNT) {
    const int j = e / (4 * kQ4), c = e % (4 * kQ4);
    cp_async16(st.cofs + (j * 4 + c / kQ4) * kQStride + (c % kQ4) * 4,
               src + (int64_t)st.k[j] * 4 * NB + c * 4);
  }
  cp_async_wait_all();
  __syncthreads();
  return nhit;
}

// bit g of (hi0:lo0), (hi1:lo1): pixel p0, p1 (when in the map) lies in gt
// plane g; G <= 64
__device__ __forceinline__ void gt_bits(const uint8_t* gb, int G, int64_t HW,
                                        bool in0, int64_t p0, bool in1,
                                        int64_t p1, uint32_t& lo0,
                                        uint32_t& hi0, uint32_t& lo1,
                                        uint32_t& hi1) {
#pragma unroll 4
  for (int g = 0; g < G; ++g) {
    const uint32_t y0 = (in0 && gb[g * HW + p0]) ? 1u : 0u;
    const uint32_t y1 = (in1 && gb[g * HW + p1]) ? 1u : 0u;
    if (g < 32) {
      lo0 |= y0 << g;
      lo1 |= y1 << g;
    } else {
      hi0 |= y0 << (g - 32);
      hi1 |= y1 << (g - 32);
    }
  }
}

// pixel p's gt value in a staged hit's mask (gj: Stage::gt)
template <bool kBits>
__device__ __forceinline__ float gt_at(int64_t gj, const uint8_t* gt,
                                       int64_t p, uint32_t lo, uint32_t hi) {
  if (gj < 0) return 0.f;
  if (kBits) return (float)((((gj >= 32) ? hi : lo) >> ((int)gj & 31)) & 1u);
  return (float)gt[gj + p];
}

__device__ __forceinline__ float bce_term(float s, float y) {
  return fmaxf(s, 0.f) - s * y + log1pf(expf(-fabsf(s)));
}

__device__ __forceinline__ float sigmoid(float s) {
  return __fdividef(1.f, 1.f + __expf(-s));
}

// s0 = v0 . c0 and s1 = v1 . c1 over NB terms, four partial sums each;
// kSame: c1 is c0, read once. perm: slot 4m + i of v pairs with float4
// m ^ perm of c (d cofs' lane-permuted basis; 0 elsewhere)
template <bool kSame>
__device__ __forceinline__ void dot2(const float4* c0, const float4* c1,
                                     const float (&v0)[NB],
                                     const float (&v1)[NB], float& s0,
                                     float& s1, int perm = 0) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
  for (int m = 0; m < NB / 4; ++m) {
    const float4 c = c0[m ^ perm];
    const float4 d = kSame ? c : c1[m ^ perm];
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

// v . c over NB terms, four partial sums
__device__ __forceinline__ float dot(const float4* c, const float (&v)[NB]) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int m = 0; m < NB / 4; ++m) {
    const float4 cm = c[m];
    a0 = fmaf(v[4 * m], cm.x, a0);
    a1 = fmaf(v[4 * m + 1], cm.y, a1);
    a2 = fmaf(v[4 * m + 2], cm.z, a2);
    a3 = fmaf(v[4 * m + 3], cm.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// One halving of reduce_scatter over lane bit H (H = 2 or 1): the lane keeps
// the half of t[0, 2H) whose coefficients have its bit H, adds the
// partner's copy of it and sends the other half.
template <int H>
__device__ __forceinline__ void rs_select_step(float (&t)[4], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = t[i], hi = t[i + H];
    t[i] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, H);
  }
}

// The warp's sum over its lanes of a*va[] + b*vb[], scattered: lane n
// returns coefficient n's sum. va and vb are lane-permuted: slot 4m + i of
// lane l holds coefficient 4*(m ^ (l >> 2)) + i, so that in the halvings
// over lane bits 4, 3 and 2 every lane keeps slots [0, h) and sends
// [h, 2h) (no selects); bits 1 and 0 select. 31 shuffles and 31 adds, each
// halving's shuffles issued together (five shuffle latencies a call).
__device__ __forceinline__ float reduce_scatter(float a, const float (&va)[NB],
                                                float b, const float (&vb)[NB],
                                                int lane) {
  float t[16];
#pragma unroll
  for (int s = 0; s < 16; ++s)
    t[s] = fmaf(a, va[s], b * vb[s]) +
           __shfl_xor_sync(kFull, fmaf(a, va[s + 16], b * vb[s + 16]), 16);
#pragma unroll
  for (int s = 0; s < 8; ++s) t[s] += __shfl_xor_sync(kFull, t[s + 8], 8);
  float t4[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    t4[s] = t[s] + __shfl_xor_sync(kFull, t[s + 4], 4);
  rs_select_step<2>(t4, lane);
  rs_select_step<1>(t4, lane);
  return t4[0];
}

// K3a, pixel tiles. grid (ceil(W/kTileW), ceil(H/kTileH), B), block
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
  const int row0 = ty * kTileH + 2 * warp, row1 = row0 + 1;
  const int col = tx * kTileW + lane;
  const bool in0 = row0 < H && col < W, in1 = row1 < H && col < W;
  const int64_t HW = (int64_t)H * W;
  const int64_t p0 = in0 ? (int64_t)row0 * W + col : 0;
  const int64_t p1 = in1 ? (int64_t)row1 * W + col : 0;
  const float ph0 = (float)row0, ph1 = (float)row1, pw = (float)col;

  __shared__ __align__(16) float s_cofs[kChunk * 4 * kQStride];
  __shared__ Staged s_box[kChunk];
  __shared__ int64_t s_gt[kChunk];  // gt plane (kBits) or its offset
  __shared__ int s_k[kChunk];
  __shared__ float red[kThreads / 32][kChunk];
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

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
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
      const unsigned m = __ballot_sync(kFull, hit);
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

// K3b, d basis. grid (ceil(W/kTileW), ceil(H/kTileH) * kTileH/kDbRows, B),
// block 32 x kDbRows: block y holds rows [y*kDbRows, (y + 1)*kDbRows) of
// tile row y*kDbRows/kTileH, warp w one row of them, one pixel a lane with
// its 32 basis values and 32 gradient sums in registers. The hits of each
// staged chunk (valid, g not 0, meeting the block's rows) are added in
// order; every element of d basis is written once. Capped at 128 registers
// (512 threads an SM).
template <bool kBits>
__global__ void __launch_bounds__(kDbThreads, 512 / kDbThreads)
    mask_bce_dbasis_tiles_kernel(
        const float* __restrict__ basis, const float* __restrict__ cofs,
        const float* __restrict__ boxes, const uint8_t* __restrict__ gt,
        const int64_t* __restrict__ gt_idx, const uint8_t* __restrict__ valid,
        const float* __restrict__ gk, float* __restrict__ dbasis, int K,
        int G, int H, int W) {
  const int b = blockIdx.z;
  const int tx = blockIdx.x, ty = blockIdx.y / (kTileH / kDbRows);
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int rlo = blockIdx.y * kDbRows;
  const int row = rlo + warp, col = tx * kTileW + lane;
  const bool in = row < H && col < W;
  const int64_t HW = (int64_t)H * W;
  const int64_t p = in ? (int64_t)row * W + col : 0;
  const float ph = (float)row, pw = (float)col;

  // separate arrays: through stage_at's one buffer it ran 19% slower
  __shared__ __align__(16) float s_cofs[kChunk * 4 * kQStride];
  __shared__ Staged s_box[kChunk];
  __shared__ int64_t s_gt[kChunk];
  __shared__ int s_k[kChunk];
  __shared__ float s_g[kChunk];
  __shared__ int s_quads[kChunk];
  __shared__ unsigned s_ballot[2];
  const Stage st{s_cofs, s_box, s_gt, s_k, s_g, s_quads, s_ballot};

  const float* bb = basis + (int64_t)b * NB * HW;
  float v[NB], acc[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    v[n] = in ? __ldg(bb + n * HW + p) : 0.f;
    acc[n] = 0.f;
  }
  uint32_t glo = 0u, ghi = 0u, unused_lo = 0u, unused_hi = 0u;
  if (kBits)
    gt_bits(gt + (int64_t)b * G * HW, G, HW, in, p, false, 0, glo, ghi,
            unused_lo, unused_hi);

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int nhit = stage_chunk<kDbThreads, kBits>(
        st, cofs, boxes, gt_idx, valid, gk, b, k0, K, G, H, W, ty, tx, rlo,
        rlo + kDbRows - 1, tid);
    for (int j = 0; j < nhit; ++j) {
      const Staged sb = st.box[j];
      if (row < sb.r_lo || row > sb.r_hi) continue;  // uniform over the warp
      const int q = (ph >= sb.ym ? 2 : 0) + (pw >= sb.xm ? 1 : 0);
      // the quadrant's coefficients, read once for the dot and the update
      const float4* cs = reinterpret_cast<const float4*>(
          st.cofs + (j * 4 + q) * kQStride);
      float4 c[NB / 4];
#pragma unroll
      for (int m = 0; m < NB / 4; ++m) c[m] = cs[m];
      float d = 0.f;
      if (in && pw >= sb.x1 && pw < sb.x2 && ph >= sb.y1 && ph < sb.y2)
        d = st.g[j] * (sigmoid(dot(c, v)) -
                       gt_at<kBits>(st.gt[j], gt, p, glo, ghi));
#pragma unroll
      for (int m = 0; m < NB / 4; ++m) {
        const float4 cm = c[m];
        acc[4 * m] = fmaf(d, cm.x, acc[4 * m]);
        acc[4 * m + 1] = fmaf(d, cm.y, acc[4 * m + 1]);
        acc[4 * m + 2] = fmaf(d, cm.z, acc[4 * m + 2]);
        acc[4 * m + 3] = fmaf(d, cm.w, acc[4 * m + 3]);
      }
    }
  }
  if (in) {
    float* db = dbasis + (int64_t)b * NB * HW + p;
#pragma unroll
    for (int n = 0; n < NB; ++n) db[n * HW] = acc[n];
  }
}

// K3b, d cofs, pixel tiles. grid and block as K3a's tile kernel (warp w:
// tile rows 2w and 2w + 1). For each staged hit k (valid, g not 0) and each
// quadrant q whose quad_tile_span holds this tile t:
// partial[((b*K + k)*T + t)*4*NB + q*NB + n] = the tile's sum of
// d*basis[n] over its pixels of quadrant q. Nothing else is written.
// Each lane keeps its two pixels' basis lane-permuted for reduce_scatter.
// Dynamic shared memory: the Stage's arrays (kStageFloats), then
// red[kSub][kWarps][4][NB], each warp's sums of kSub hits, added in warp
// order one thread an element.
template <bool kBits>
__global__ void __launch_bounds__(kThreads, 2) mask_bce_dcofs_tiles_kernel(
    const float* __restrict__ basis, const float* __restrict__ cofs,
    const float* __restrict__ boxes, const uint8_t* __restrict__ gt,
    const int64_t* __restrict__ gt_idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ gk, float* __restrict__ partial, int K, int G,
    int H, int W) {
  const int b = blockIdx.z;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int64_t tile = (int64_t)ty * gridDim.x + tx;
  const int64_t T = (int64_t)gridDim.x * gridDim.y;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int row0 = ty * kTileH + 2 * warp, row1 = row0 + 1;
  const int col = tx * kTileW + lane;
  const bool in0 = row0 < H && col < W, in1 = row1 < H && col < W;
  const int64_t HW = (int64_t)H * W;
  const int64_t p0 = in0 ? (int64_t)row0 * W + col : 0;
  const int64_t p1 = in1 ? (int64_t)row1 * W + col : 0;
  const float ph0 = (float)row0, ph1 = (float)row1, pw = (float)col;

  extern __shared__ __align__(16) float smem[];
  const Stage st = stage_at(smem);
  float* red = smem + kStageFloats;  // [kSub][kWarps][4][NB]

  const float* bb = basis + (int64_t)b * NB * HW;
  const int perm = lane >> 2;
  float v0[NB], v1[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int64_t plane = (((n >> 2) ^ perm) * 4 + (n & 3)) * HW;
    v0[n] = in0 ? __ldg(bb + plane + p0) : 0.f;
    v1[n] = in1 ? __ldg(bb + plane + p1) : 0.f;
  }
  uint32_t g0lo = 0u, g0hi = 0u, g1lo = 0u, g1hi = 0u;
  if (kBits)
    gt_bits(gt + (int64_t)b * G * HW, G, HW, in0, p0, in1, p1, g0lo, g0hi,
            g1lo, g1hi);

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int nhit = stage_chunk<kThreads, kBits>(
        st, cofs, boxes, gt_idx, valid, gk, b, k0, K, G, H, W, ty, tx,
        ty * kTileH, ty * kTileH + kTileH - 1, tid);
    for (int j0 = 0; j0 < nhit; j0 += kSub) {
      const int jn = min(kSub, nhit - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const int j = j0 + jj;
        const Staged sb = st.box[j];
        const bool r0 = row0 >= sb.r_lo && row0 <= sb.r_hi;  // uniform over
        const bool r1 = row1 >= sb.r_lo && row1 <= sb.r_hi;  // the warp
        float d0 = 0.f, d1 = 0.f;
        int q0 = -1, q1 = -1;  // the pixels' quadrants; -1: not in the box
        if (r0 || r1) {
          const int right = pw >= sb.xm ? 1 : 0;
          const int qa = (ph0 >= sb.ym ? 2 : 0) + right;
          const int qb = (ph1 >= sb.ym ? 2 : 0) + right;
          const float4* c0 = reinterpret_cast<const float4*>(
              st.cofs + (j * 4 + qa) * kQStride);
          const float4* c1 = reinterpret_cast<const float4*>(
              st.cofs + (j * 4 + qb) * kQStride);
          float s0, s1;
          if (qa == qb)  // uniform over the warp
            dot2<true>(c0, c1, v0, v1, s0, s1, perm);
          else
            dot2<false>(c0, c1, v0, v1, s0, s1, perm);
          const bool cin = pw >= sb.x1 && pw < sb.x2;
          const float gj = st.g[j];
          const int64_t gtj = st.gt[j];
          if (in0 && cin && ph0 >= sb.y1 && ph0 < sb.y2) {
            d0 = gj * (sigmoid(s0) - gt_at<kBits>(gtj, gt, p0, g0lo, g0hi));
            q0 = qa;
          }
          if (in1 && cin && ph1 >= sb.y1 && ph1 < sb.y2) {
            d1 = gj * (sigmoid(s1) - gt_at<kBits>(gtj, gt, p1, g1lo, g1hi));
            q1 = qb;
          }
        }
        // one reduce-scatter per quadrant present in the warp, the other
        // quadrants' d masked to 0; absent quadrants write zeros
        const unsigned present = __reduce_or_sync(
            kFull, (q0 >= 0 ? 1u << q0 : 0u) | (q1 >= 0 ? 1u << q1 : 0u));
        float* rd = red + (jj * kWarps + warp) * 4 * NB + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float t = 0.f;
          if ((present >> q) & 1u)  // uniform over the warp
            t = reduce_scatter(q0 == q ? d0 : 0.f, v0, q1 == q ? d1 : 0.f,
                               v1, lane);
          rd[q * NB] = t;
        }
      }
      __syncthreads();
      // the 8 warps' sums in order: one segment per (hit, quadrant) of
      // this tile's quad_tile_span
      for (int e = tid; e < jn * 4 * NB; e += kThreads) {
        const int jj = e / (4 * NB), qn = e - jj * 4 * NB;
        const int j = j0 + jj;
        if ((st.quads[j] >> (qn / NB)) & 1) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            t += red[(jj * kWarps + w) * 4 * NB + qn];
          partial[(((int64_t)b * K + st.k[j]) * T + tile) * 4 * NB + qn] = t;
        }
      }
      __syncthreads();  // red is written again
    }
  }
}

// K3b, the d cofs fold: one warp per (image, positive, quadrant), lane n
// for coefficient n. dcofs[bk*4*NB + q*NB + n] = the sum, in tile order, of
// partial[(bk*T + t)*4*NB + q*NB + n] over the tiles t (= ty*TX + tx) of
// quadrant q's quad_tile_span: exactly the segments the tile kernel wrote.
// Invalid positives and those whose cotangent is 0 get zeros.
__global__ void mask_bce_fold_dcofs_kernel(const float* __restrict__ boxes,
                                           const uint8_t* __restrict__ valid,
                                           const float* __restrict__ gk,
                                           const float* __restrict__ partial,
                                           float* __restrict__ dcofs,
                                           int64_t BK, int H, int W, int TX,
                                           int64_t T) {
  const int64_t wq = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wq >= BK * 4) return;  // uniform over the warp
  const int64_t bk = wq >> 2;
  const int q = (int)(wq & 3);
  float acc = 0.f;
  int ty0, ty1, tx0, tx1;
  if (valid[bk] != 0 && gk[bk] != 0.f &&
      quad_tile_span(load_box(boxes + bk * 4, H, W), q, H, W, ty0, ty1, tx0,
                     tx1)) {
    const float* pp = partial + bk * T * 4 * NB + q * NB + lane;
    for (int r = ty0; r <= ty1; ++r) {
#pragma unroll 4
      for (int c = tx0; c <= tx1; ++c)
        acc += pp[((int64_t)r * TX + c) * 4 * NB];
    }
  }
  dcofs[wq * NB + lane] = acc;
}

int64_t num_tiles(int H, int W) {
  return (int64_t)((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
}

}  // namespace

extern "C" {

int mask_bce_num_bases() { return NB; }

// Floats of scratch mask_bce_fwd_f32 takes: one partial per (image,
// positive, pixel tile).
int64_t mask_bce_fwd_scratch(int B, int K, int H, int W) {
  return (int64_t)B * K * num_tiles(H, W);
}

// Floats of scratch mask_bce_bwd_f32 takes: a 4*NB-float d cofs partial per
// (image, positive, pixel tile), one NB-float segment a quadrant.
int64_t mask_bce_bwd_scratch(int B, int K, int H, int W) {
  return (int64_t)B * K * num_tiles(H, W) * 4 * NB;
}

// pre (B, K) f32; partial: mask_bce_fwd_scratch(B, K, H, W) floats of
// scratch. Two launches, the tile kernel and the fold. Returns the
// cudaError_t of the first failed launch (0 on success).
int mask_bce_fwd_f32(const void* basis, const void* cofs, const void* boxes,
                     const void* gt, const void* gt_idx, const void* valid,
                     void* partial, void* pre, int B, int K, int G, int H,
                     int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tx = (W + kTileW - 1) / kTileW;
  const dim3 grid(tx, (H + kTileH - 1) / kTileH, B);
  auto kernel = G <= 64 ? mask_bce_fwd_tiles_kernel<true>
                        : mask_bce_fwd_tiles_kernel<false>;
  kernel<<<grid, dim3(32, kWarps), 0, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int64_t*)gt_idx, (const uint8_t*)valid,
      (float*)partial, K, G, H, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t bk = (int64_t)B * K;
  mask_bce_fold_tiles_kernel<<<(unsigned)((bk + kWarps - 1) / kWarps),
                               kThreads, 0, st>>>(
      (const float*)boxes, (const uint8_t*)valid, (const float*)partial,
      (float*)pre, bk, H, W, tx, num_tiles(H, W));
  return (int)cudaGetLastError();
}

// dbasis (B, NB, H, W), dcofs (B, K, 4*NB) f32; partial:
// mask_bce_bwd_scratch(B, K, H, W) floats of scratch. Three launches: the
// d basis tile kernel, the d cofs tile kernel and its fold. Returns the
// cudaError_t of the first failure (0 on success).
int mask_bce_bwd_f32(const void* basis, const void* cofs, const void* boxes,
                     const void* gt, const void* gt_idx, const void* valid,
                     const void* g, void* partial, void* dbasis, void* dcofs,
                     int B, int K, int G, int H, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tx = (W + kTileW - 1) / kTileW;
  const dim3 grid(tx, (H + kTileH - 1) / kTileH, B);
  auto db_kernel = G <= 64 ? mask_bce_dbasis_tiles_kernel<true>
                           : mask_bce_dbasis_tiles_kernel<false>;
  db_kernel<<<dim3(tx, grid.y * (kTileH / kDbRows), B), dim3(32, kDbRows), 0,
              st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int64_t*)gt_idx, (const uint8_t*)valid,
      (const float*)g, (float*)dbasis, K, G, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto dc_kernel = G <= 64 ? mask_bce_dcofs_tiles_kernel<true>
                           : mask_bce_dcofs_tiles_kernel<false>;
  const int smem = (kStageFloats + kSub * kWarps * 4 * NB) * 4;
  err = cudaFuncSetAttribute(dc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  dc_kernel<<<grid, dim3(32, kWarps), smem, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int64_t*)gt_idx, (const uint8_t*)valid,
      (const float*)g, (float*)partial, K, G, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t warps = (int64_t)B * K * 4;
  mask_bce_fold_dcofs_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps),
                               kThreads, 0, st>>>(
      (const float*)boxes, (const uint8_t*)valid, (const float*)g,
      (const float*)partial, (float*)dcofs, (int64_t)B * K, H, W, tx,
      num_tiles(H, W));
  return (int)cudaGetLastError();
}

const char* mask_bce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
