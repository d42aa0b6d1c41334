// SP mask assembly: each detection's mask from the basis and its quadrant
// coefficients, cropped to its box, as probabilities.
//
// Replaces the TPU kernel sipmask_tpu/ops/pallas/mask_assembly.py:
// assemble_masks_pallas (:66, body _kernel :39), which runs one
// (tile, nb) x (nb, 4*N) matmul over all four quadrants per pixel tile and
// selects the pixel's quadrant in the epilogue. Semantics, per image b,
// pixel (row, col) and detection n:
//   in_box  = col >= x1 && col < x2 && row >= y1 && row < y2
//   q       = 2 * (row >= by) + (col >= rx)     (TL, TR, BL, BR)
//   out     = in_box ? sigmoid(sum_k basis[k, pixel] * cofs[n, q*nb + k]) : 0
// with rx = x1 + (x2 - x1 + 0.1)/2 and by = y1 + (y2 - y1 + 0.1)/2 in the
// f32 expressions of ops/mask_assembly.py:_quadrant_bounds, so the compares
// here give the plain version's bits.
//
// Layouts (contiguous f32), NB = 32 bases:
//   basis    (B, NB, H*W)     the head's NCHW basis masks, read in place
//   cofs     (B, N, 4*NB)     coefficients by detection, [TL|TR|BL|BR]
//   boxes    (B, N, 4)        x1, y1, x2, y2 in mask coordinates
//   out      (B, N, H*W)      detection-major: the caller's (B, N, h, w)
//                             masks, and the (B, h, w, N) of the JAX layout
//                             as a permuted view
//
// What bounds it on an H100: bytes. The output (B*H*W*N floats; 237 MB for
// a decode of 100 detections on the 272x272 grid at batch 8) is written
// once, about 0.07 ms at 3.35 TB/s; the dot is 2*NB = 64 flops per in-box
// (pixel, detection). The design keeps the write stream dense and spends
// no instructions on pairs outside the boxes:
//   - one pixel a thread, and a warp on a segment of 32 consecutive pixels
//     of the flattened h*w plane (no lane idles where w is not a multiple
//     of 32), so each store of a warp is one contiguous 128-byte run of one
//     detection's plane. A thread reads its pixel's NB basis values once,
//     coalesced, and keeps them in registers;
//   - detections run in the same order in every warp, kChunk at a time: a
//     block stages their coefficients (each quadrant row padded from NB to
//     kQStride floats, so that the quadrants a warp reads lie in different
//     banks: 8 float4 broadcast loads a dot) and their boxes in shared
//     memory, with each box's exact integer pixel bounds;
//   - warp-uniform cull: after staging, each warp decides for the chunk's
//     detections at once (lane l for detections l and l + 32, then two
//     ballots) which of them hold a pixel of its segment, on the integer
//     bounds, which pick the same pixels as the float rule. A detection
//     whose bit is clear costs the warp a bit test and a store of zeros;
//     where it is set, each lane applies the float compares of the rule
//     above, so the zeros are the plain version's. (Deciding the segment
//     test detection by detection in every lane cost more than it saved.)
//   - the sigmoid as __frcp_rn(1 + __expf(-s)): within 2e-7 of the plain
//     version's, and 0 only where its exp overflows as the plain version's
//     does (__fdividef would flush results below 2^-126 to 0); streaming
//     stores, since nothing reads the masks back before they leave the L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NB = 32;             // basis masks (HeadConfig.num_bases)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSegs = 1;           // 32-pixel segments a warp
constexpr int kChunk = 64;         // detections staged at once
static_assert(kChunk == 64, "a warp's cull is two 32-bit ballots");
constexpr int kQStride = NB + 4;   // a staged quadrant row, padded
constexpr int kDetFloats = 4 * kQStride;
constexpr unsigned kFull = 0xffffffffu;

// ceil(v) clipped to [0, n]; NaN gives if_nan
__device__ __forceinline__ int ceil_clip(float v, int n, int if_nan) {
  const float f = ceilf(v);
  if (f != f) return if_nan;
  return f <= 0.f ? 0 : f < (float)n ? (int)f : n;
}

// Does the segment of flattened pixels from (ra, ca) to (rb, cb) hold a
// pixel of the rectangle rows [r.z, r.w] x cols [r.x, r.y]?
__device__ __forceinline__ bool segment_hit(int ra, int ca, int rb, int cb,
                                            int4 r) {
  if (r.x > r.y || r.z > r.w) return false;
  if (ra == rb)
    return ra >= r.z && ra <= r.w && max(ca, r.x) <= min(cb, r.y);
  // the first row from ca to the end, the last from 0 to cb, full rows
  // between
  if (ra >= r.z && ra <= r.w && r.y >= ca) return true;
  if (rb >= r.z && rb <= r.w && r.x <= cb) return true;
  return max(ra + 1, r.z) <= min(rb - 1, r.w);
}

// 4 blocks an SM (registers capped at 64): faster on an H100 than 3
__global__ void __launch_bounds__(kThreads, 4) assemble_masks_kernel(
    const float* __restrict__ basis, const float* __restrict__ cofs,
    const float* __restrict__ boxes, float* __restrict__ out, int H, int W,
    int N) {
  __shared__ __align__(16) float cs[kChunk * kDetFloats];
  __shared__ float4 bx[kChunk];     // x1, y1, x2, y2
  __shared__ float2 sp[kChunk];     // rx, by: the half-split thresholds
  __shared__ int4 rc[kChunk];       // first col, last col, first row, last
  const int HW = H * W;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this warp's segments: the pixel of each lane, its basis values and the
  // segment's first and last pixel (row, col), the same in every lane
  float v[kSegs][NB];
  int p[kSegs], ra[kSegs], ca[kSegs], rb[kSegs], cb[kSegs];
  float fr[kSegs], fc[kSegs];
  const float* bb = basis + (int64_t)b * NB * HW;
#pragma unroll
  for (int s = 0; s < kSegs; ++s) {
    const int start = ((blockIdx.x * kWarps + warp) * kSegs + s) * 32;
    const int last = min(start + 31, HW - 1);
    ra[s] = start / W;
    ca[s] = start - ra[s] * W;
    rb[s] = last / W;
    cb[s] = last - rb[s] * W;
    p[s] = start + lane;
    const int r = p[s] / W;
    fr[s] = (float)r;
    fc[s] = (float)(p[s] - r * W);
#pragma unroll
    for (int k = 0; k < NB; ++k)
      v[s][k] = p[s] < HW ? __ldg(bb + (int64_t)k * HW + p[s]) : 0.f;
  }

  const float4* cb4 =
      reinterpret_cast<const float4*>(cofs + (int64_t)b * N * 4 * NB);
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int cn = min(kChunk, N - n0);
    __syncthreads();   // the last chunk is used up
    for (int i = threadIdx.x; i < cn * NB; i += kThreads) {
      const int j = i / NB, f = i - j * NB;   // f: float4 f of 4*NB/4
      const int q = f / (NB / 4), m = f - q * (NB / 4);
      *reinterpret_cast<float4*>(cs + j * kDetFloats + q * kQStride +
                                 4 * m) = cb4[(int64_t)n0 * NB + i];
    }
    for (int j = threadIdx.x; j < cn; j += kThreads) {
      const float* bo = boxes + ((int64_t)b * N + n0 + j) * 4;
      const float x1 = bo[0], y1 = bo[1], x2 = bo[2], y2 = bo[3];
      bx[j] = make_float4(x1, y1, x2, y2);
      sp[j] = make_float2(
          __fadd_rn(x1, __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 0.1f), 0.5f)),
          __fadd_rn(y1, __fmul_rn(__fadd_rn(__fsub_rn(y2, y1), 0.1f), 0.5f)));
      // integer col c is in the box iff ceil(x1) <= c <= ceil(x2) - 1
      rc[j] = make_int4(ceil_clip(x1, W, W), ceil_clip(x2, W, 0) - 1,
                        ceil_clip(y1, H, H), ceil_clip(y2, H, 0) - 1);
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      if (p[s] - lane >= HW) continue;   // the segment lies past the plane
      // bit j: detection n0 + j holds a pixel of this warp's segment
      const uint64_t hits =
          (uint64_t)__ballot_sync(
              kFull, lane < cn &&
                         segment_hit(ra[s], ca[s], rb[s], cb[s], rc[lane])) |
          (uint64_t)__ballot_sync(
              kFull, lane + 32 < cn &&
                         segment_hit(ra[s], ca[s], rb[s], cb[s],
                                     rc[lane + 32]))
              << 32;
      float* o = out + ((int64_t)b * N + n0) * HW + p[s];
      const bool live = p[s] < HW;
      for (int j = 0; j < cn; ++j, o += HW) {
        float val = 0.f;
        if ((hits >> j) & 1) {
          const float4 bj = bx[j];
          if (fc[s] >= bj.x && fc[s] < bj.z && fr[s] >= bj.y &&
              fr[s] < bj.w) {
            const float2 sj = sp[j];
            const int q = (fr[s] >= sj.y ? 2 : 0) + (fc[s] >= sj.x ? 1 : 0);
            const float4* c = reinterpret_cast<const float4*>(
                cs + j * kDetFloats + q * kQStride);
            float acc = 0.f;
#pragma unroll
            for (int m = 0; m < NB / 4; ++m) {
              const float4 cm = c[m];
              acc = fmaf(v[s][4 * m], cm.x, acc);
              acc = fmaf(v[s][4 * m + 1], cm.y, acc);
              acc = fmaf(v[s][4 * m + 2], cm.z, acc);
              acc = fmaf(v[s][4 * m + 3], cm.w, acc);
            }
            val = __frcp_rn(1.f + __expf(-acc));
          }
        }
        if (live) __stcs(o, val);
      }
    }
  }
}

}  // namespace

extern "C" {

int assemble_masks_num_bases() { return NB; }

// basis (B, NB, H*W), cofs (B, N, 4*NB) 16-byte aligned, boxes (B, N, 4)
// -> out (B, N, H*W), all contiguous f32. Returns the cudaError_t of the
// launch.
int assemble_masks_f32(const void* basis, const void* cofs, const void* boxes,
                       void* out, int B, int H, int W, int N, void* stream) {
  const int HW = H * W;
  if (B == 0 || HW == 0 || N == 0) return 0;
  const int per_block = kWarps * kSegs * 32;
  const dim3 grid((HW + per_block - 1) / per_block, B);
  assemble_masks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)basis, (const float*)cofs, (const float*)boxes,
      (float*)out, H, W, N);
  return (int)cudaGetLastError();
}

const char* mask_assembly_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
