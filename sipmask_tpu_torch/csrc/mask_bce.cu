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
// (B, G, H, W) uint8, gt_idx (B, K) int32, valid (B, K) uint8, g (B, K) f32.
//
// What bounds it on an H100: the pixels a box covers, times 32 multiply-adds
// and 32 reads of basis each (L2 hits: one image's basis is 34 MB). The TPU
// kernel ran every 128-positive chunk over dense 512-pixel tiles on its
// matrix unit, behind a y1 sort and chunk flags, because the TPU has no
// cheap gather; here each block visits only the pixels it needs:
//   - forward and d cofs: one block per (positive, row slice, image). It
//     walks the four quadrant rectangles of its box, clipped to the map,
//     with the quadrant's 32 coefficients in registers; rows are dealt to
//     kSlices blocks in turn so that a large box does not leave SMs idle
//     while a small one finishes. Each block writes one partial; a fold
//     kernel adds the kSlices partials in a fixed order (no atomics, so
//     every run gives the same bits). Invalid positives, and in the
//     backward positives whose cotangent is 0, write zeros and stop.
//   - d basis: one block per 8x32 pixel tile. Each thread keeps its pixel's
//     32 basis values and 32 gradient sums in registers and walks the
//     positives in order, skipping (uniformly, per block) those whose box
//     misses the tile. No atomics: every element of d basis is written once,
//     in a fixed order. Atomics from the per-positive blocks would be the
//     other choice; they scatter 32 values per (pixel, positive) and change
//     their order from run to run.
// The integer loop bounds are conservative (floor/ceil of the box, clipped
// to the map); the exact float tests above decide each pixel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NB = 32;           // basis masks (HeadConfig.num_bases)
constexpr int kThreads = 256;
constexpr int kSlices = 8;       // row slices of a box, one block each
constexpr int kTileH = 8, kTileW = 32;
constexpr int kChunk = 256;      // positives staged in shared memory at once

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

// Block-wide sum of v; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
    v = warp_sum(v);
  }
  return v;
}

// FWD = true: partial[(bk*S + s)] = this slice's BCE sum.
// FWD = false: partial[(bk*S + s)*4*NB + q*NB + n] = this slice's
//              sum of g*(sigmoid(s) - y)*basis[n] over quadrant q.
// grid (kSlices, K, B)
template <bool FWD>
__global__ void __launch_bounds__(kThreads) mask_bce_slices_kernel(
    const float* __restrict__ basis, const float* __restrict__ cofs,
    const float* __restrict__ boxes, const uint8_t* __restrict__ gt,
    const int* __restrict__ gt_idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ gk, float* __restrict__ partial, int K, int G,
    int H, int W) {
  const int s = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int64_t bk = (int64_t)b * K + k;
  const int64_t HW = (int64_t)H * W;
  __shared__ float red[kThreads / 32];
  __shared__ float red32[kThreads / 32][NB];

  const float gval = FWD ? 1.f : gk[bk];
  const int gi = gt_idx[bk];
  const bool live = valid[bk] != 0 && gval != 0.f;
  if (!live) {  // uniform over the block
    if (FWD) {
      if (threadIdx.x == 0) partial[bk * kSlices + s] = 0.f;
    } else {
      for (int i = threadIdx.x; i < 4 * NB; i += kThreads)
        partial[(bk * kSlices + s) * 4 * NB + i] = 0.f;
    }
    return;
  }
  const Box bx = load_box(boxes + bk * 4, H, W);
  const float* bb = basis + (int64_t)b * NB * HW;
  // a gt index outside [0, G) reads as an empty mask
  const uint8_t* gm = (gi >= 0 && gi < G) ? gt + ((int64_t)b * G + gi) * HW
                                          : nullptr;
  float fwd_acc = 0.f;
  for (int q = 0; q < 4; ++q) {
    float c[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) c[n] = __ldg(cofs + bk * 4 * NB + q * NB + n);
    float acc[FWD ? 1 : NB];
#pragma unroll
    for (int n = 0; n < (FWD ? 1 : NB); ++n) acc[n] = 0.f;

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
      if (FWD) {
        fwd_acc += fmaxf(sl, 0.f) - sl * y + log1pf(expf(-fabsf(sl)));
      } else {
        const float d = gval * (1.f / (1.f + expf(-sl)) - y);
#pragma unroll
        for (int n = 0; n < NB; ++n) acc[n] += d * v[n];
      }
    }
    if (!FWD) {
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
  if (FWD) {
    const float t = block_sum(fwd_acc, red);
    if (threadIdx.x == 0) partial[bk * kSlices + s] = t;
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
    const int* __restrict__ gt_idx, const uint8_t* __restrict__ valid,
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
      const int gi = gt_idx[bk];
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

int fold(const float* partial, float* out, int64_t n, int L,
         cudaStream_t st) {
  const int64_t total = n * L;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 4096
                               ? (total + kThreads - 1) / kThreads
                               : 4096);
  if (total == 0) return 0;
  fold_slices_kernel<<<blocks, kThreads, 0, st>>>(partial, out, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mask_bce_num_bases() { return NB; }
int mask_bce_num_slices() { return kSlices; }

// pre (B, K) f32; partial: B*K*kSlices floats of scratch. Returns the
// cudaError_t of the first failed launch (0 on success).
int mask_bce_fwd_f32(const void* basis, const void* cofs, const void* boxes,
                     const void* gt, const void* gt_idx, const void* valid,
                     void* partial, void* pre, int B, int K, int G, int H,
                     int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(kSlices, K, B);
  mask_bce_slices_kernel<true><<<grid, kThreads, 0, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int*)gt_idx, (const uint8_t*)valid, nullptr,
      (float*)partial, K, G, H, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return fold((const float*)partial, (float*)pre, (int64_t)B * K, 1, st);
}

// dbasis (B, NB, H, W), dcofs (B, K, 4*NB) f32; partial: B*K*kSlices*4*NB
// floats of scratch.
int mask_bce_bwd_f32(const void* basis, const void* cofs, const void* boxes,
                     const void* gt, const void* gt_idx, const void* valid,
                     const void* g, void* partial, void* dbasis, void* dcofs,
                     int B, int K, int G, int H, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(kSlices, K, B);
  mask_bce_slices_kernel<false><<<grid, kThreads, 0, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int*)gt_idx, (const uint8_t*)valid,
      (const float*)g, (float*)partial, K, G, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int code = fold((const float*)partial, (float*)dcofs, (int64_t)B * K,
                        4 * NB, st);
  if (code != 0) return code;
  const dim3 tgrid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  mask_bce_dbasis_kernel<<<tgrid, dim3(kTileW, kTileH), 0, st>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (const uint8_t*)gt, (const int*)gt_idx, (const uint8_t*)valid,
      (const float*)g, (float*)dbasis, K, G, H, W);
  return (int)cudaGetLastError();
}

const char* mask_bce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
