// K1's second design for Hopper, kept beside the package's kernel
// (csrc/deform_im2col.cu) for tools/k1k6_probe.py, which builds it and its
// edited copies as the variants "k1:tiles...": one block per (tile of
// kPix = 128 output pixels, tap, chunk of kCh = 32 channels) of one (image,
// group), the pixel tile fastest in the grid, so that the blocks in flight
// stream the same rows of cols in 512-byte runs. Each block works out its
// pixels' corners for its tap once, gathers 16-byte channel vectors into a
// (pixel, channel) tile whose 16-byte chunks are permuted by the pixel
// (one 16-byte shared store a vector, conflict-free reads), and writes its
// 32 rows of cols. Its transpose of x stores 16-byte vectors, channel tiles
// fastest in the grid. Its C entry takes the package's arguments and gives
// the same cols.
//
// On an H100 it ran 0.546-0.549 ms a five-level FeatureAlign sweep at
// batch 4, against the package kernel's 0.487-0.491 in the same calls: a
// block of one tap shares no corner rows with the taps around it, so each
// x line comes from the L2 once per tap.

#include <cuda_runtime.h>

#include <cstdint>

#include "deform_corners.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 128;        // output pixels a gather block
constexpr int kCh = 32;          // channels a gather block (a chunk of Cg)
constexpr int kT = 32;           // transpose tile: channels x pixels
constexpr int kUnroll = 1;       // gather items a thread loads at once

// x (BG, Cg, HW) -> x_rows (BG, HW, Cg), a block per 32 channels x 32
// pixels, the channel tile fastest in the grid so that the blocks in flight
// write whole rows. V4 (Cg % 4 == 0): a warp stores four pixels' 32
// channels as 16-byte vectors.
template <bool V4>
__global__ void __launch_bounds__(kThreads) deform_im2col_rows_kernel(
    const float* __restrict__ x, float* __restrict__ x_rows, int Cg,
    int HW) {
  __shared__ float tile[kT][kT + 1];
  const int64_t bg = blockIdx.z;
  const int c0 = blockIdx.x * kT, p0 = blockIdx.y * kT;
  const float* src = x + bg * Cg * HW;
  float* dst = x_rows + bg * HW * Cg;
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  for (int r = ty; r < kT; r += kThreads / kT) {
    const int c = c0 + r, p = p0 + tx;
    if (c < Cg && p < HW) tile[r][tx] = src[(int64_t)c * HW + p];
  }
  __syncthreads();
  if constexpr (V4) {   // thread: pixel threadIdx.x / 8, channels 4 * (% 8)
    const int c4 = threadIdx.x % (kT / 4), pr = threadIdx.x / (kT / 4);
    const int p = p0 + pr, c = c0 + 4 * c4;
    if (c < Cg && p < HW)
      *reinterpret_cast<float4*>(dst + (int64_t)p * Cg + c) =
          make_float4(tile[4 * c4][pr], tile[4 * c4 + 1][pr],
                      tile[4 * c4 + 2][pr], tile[4 * c4 + 3][pr]);
  } else {
    for (int r = ty; r < kT; r += kThreads / kT) {
      const int p = p0 + r, c = c0 + tx;
      if (c < Cg && p < HW) dst[(int64_t)p * Cg + c] = tile[tx][r];
    }
  }
}
static_assert(kThreads == kT * kT / 4, "the V4 transpose: a vector a thread");

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};

// The (pixel, channel) tile. SWZ (whole 32-channel chunks of float4): rows
// of kCh floats whose 16-byte chunks are permuted by the pixel, so that a
// gather thread stores a vector with one 16-byte store and the write-out's
// lanes (pixels 4l + e of a 32-pixel run, l = 0..7, four channels) read 32
// different banks; else rows padded to an odd stride, stored and read as
// scalars.
constexpr int kRowFloats = kCh + 1;
template <bool SWZ>
__device__ __forceinline__ int tile_at(int j, int c) {
  if constexpr (SWZ)
    return j * kCh + ((((c >> 2) ^ ((j ^ (j >> 2)) & 7)) << 2) | (c & 3));
  else
    return j * kRowFloats + c;
}

// The bilinear sum of four corner values, in the plain version's order.
__device__ __forceinline__ float blend(float a00, float a01, float a10,
                                       float a11, const float4& w) {
  return a00 * w.x + a01 * w.y + a10 * w.z + a11 * w.w;
}

// VEC: channels a gather load reads; SWZ: the swizzled tile (VEC == 4,
// Cg % 32 == 0); VOUT: pixels a thread writes at once (P % 4 == 0).
template <int VEC, bool SWZ, int VOUT>
__global__ void __launch_bounds__(kThreads) deform_im2col_kernel(
    const float* __restrict__ x_rows, const float* __restrict__ offsets,
    float* __restrict__ cols, int H, int W, int Cg, int Ho, int Wo, int kh,
    int kw, int stride, int pad, int dil) {
  using V = Vec<VEC>;
  using T = typename V::T;
  static_assert(!SWZ || VEC == 4, "the swizzled tile takes float4");
  __shared__ float4 cw[kPix];   // each pixel's corner weights
  __shared__ int4 cq[kPix];     // and corner rows, -1 outside the map
  __shared__ __align__(16) float tile[kPix * kRowFloats];
  const int K = kh * kw, P = Ho * Wo;
  const int n_chunks = (Cg + kCh - 1) / kCh;
  const int t = blockIdx.y / n_chunks;             // tap i*kw + j
  const int c0 = (blockIdx.y - t * n_chunks) * kCh;
  const int cn = min(kCh, Cg - c0);                // channels of the chunk
  const int64_t bg = blockIdx.z;
  const int p0 = blockIdx.x * kPix;

  for (int j = threadIdx.x; j < kPix; j += kThreads) {
    const int p = p0 + j;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 q = make_int4(-1, -1, -1, -1);
    if (p < P) {
      const int ho = p / Wo, wo = p - ho * Wo;
      const int ti = t / kw, tj = t - ti * kw;
      const float* off = offsets + (bg * K * 2 + 2 * t) * P + p;
      // the integer base is exact in f32, so this is the same sum as the
      // reference's (base + tap) + offset
      const float py = (float)(ho * stride - pad + ti * dil) + off[0];
      const float px = (float)(wo * stride - pad + tj * dil) + off[P];
      const dcn::Corners c = dcn::corners(py, px, H, W);
      w = make_float4(c.w00, c.w01, c.w10, c.w11);
      q = make_int4(c.v00 ? (int)c.q00 : -1, c.v01 ? (int)c.q01 : -1,
                    c.v10 ? (int)c.q10 : -1, c.v11 ? (int)c.q11 : -1);
    }
    cw[j] = w;
    cq[j] = q;
  }
  __syncthreads();

  // gather: item i -> pixel i / nv, vector i % nv of the chunk; a thread
  // issues the corner loads of kUnroll items before it uses any of them
  const int cv = Cg / VEC, nv = cn / VEC, n_items = kPix * nv;
  const T* xb =
      reinterpret_cast<const T*>(x_rows + bg * H * W * Cg + c0);
  const T zero{};
  for (int i0 = threadIdx.x; i0 < n_items; i0 += kUnroll * kThreads) {
    T a[kUnroll][4];
    float4 w[kUnroll];
    int jj[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      jj[u] = i < n_items ? i / nv : 0;
      vv[u] = i - jj[u] * nv;
      const int4 q = i < n_items ? cq[jj[u]] : make_int4(-1, -1, -1, -1);
      w[u] = cw[jj[u]];
      const int v = vv[u];
      a[u][0] = q.x >= 0 ? xb[(int64_t)q.x * cv + v] : zero;
      a[u][1] = q.y >= 0 ? xb[(int64_t)q.y * cv + v] : zero;
      a[u][2] = q.z >= 0 ? xb[(int64_t)q.z * cv + v] : zero;
      a[u][3] = q.w >= 0 ? xb[(int64_t)q.w * cv + v] : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads >= n_items) break;
      float r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        r[e] = blend(V::get(a[u][0], e), V::get(a[u][1], e),
                     V::get(a[u][2], e), V::get(a[u][3], e), w[u]);
      if constexpr (SWZ) {
        *reinterpret_cast<float4*>(tile + tile_at<true>(jj[u], 4 * vv[u])) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          tile[tile_at<false>(jj[u], vv[u] * VEC + e)] = r[e];
      }
    }
  }
  __syncthreads();

  // write-out: rows c0 .. c0 + cn - 1 of tap t
  float* ob = cols + ((bg * K + t) * Cg + c0) * (int64_t)P + p0;
  if constexpr (VOUT == 4) {
    // item i -> channel 4g + (i & 3), pixels 32 * pb + 4 * ((i >> 2) & 7)
    // and the three after them; a warp: four rows, 128 bytes each
    constexpr int kRuns = kPix / 32;
    const int n_items = (cn + 3) / 4 * 4 * (kPix / 4);
    for (int i = threadIdx.x; i < n_items; i += kThreads) {
      const int r = i & 3, l = (i >> 2) & 7, rest = i >> 5;
      const int g = rest / kRuns, pb = rest - g * kRuns;
      const int c = 4 * g + r, j = 32 * pb + 4 * l;
      if (c >= cn || p0 + j >= P) continue;   // P % 4 == 0: all 4 or none
      *reinterpret_cast<float4*>(ob + (int64_t)c * P + j) = make_float4(
          tile[tile_at<SWZ>(j, c)], tile[tile_at<SWZ>(j + 1, c)],
          tile[tile_at<SWZ>(j + 2, c)], tile[tile_at<SWZ>(j + 3, c)]);
    }
  } else {
    for (int i = threadIdx.x; i < cn * kPix; i += kThreads) {
      const int c = i / kPix, j = i - c * kPix;
      if (p0 + j < P) ob[(int64_t)c * P + j] = tile[tile_at<SWZ>(j, c)];
    }
  }
}

template <int VEC, bool SWZ>
void launch_gather(bool out4, dim3 grid, cudaStream_t s, const float* x_rows,
                   const float* offsets, float* cols, int H, int W, int Cg,
                   int Ho, int Wo, int kh, int kw, int stride, int pad,
                   int dil) {
  if (out4)
    deform_im2col_kernel<VEC, SWZ, 4><<<grid, kThreads, 0, s>>>(
        x_rows, offsets, cols, H, W, Cg, Ho, Wo, kh, kw, stride, pad, dil);
  else
    deform_im2col_kernel<VEC, SWZ, 1><<<grid, kThreads, 0, s>>>(
        x_rows, offsets, cols, H, W, Cg, Ho, Wo, kh, kw, stride, pad, dil);
}

}  // namespace

extern "C" {

// x (B, C, H, W), offsets (B, G*K*2, Ho, Wo) -> x_rows (B*G, H*W, Cg)
// scratch, then cols (B, G*K*Cg, Ho*Wo); all contiguous f32, x_rows and
// cols 16-byte aligned. vec4: Cg % 4 == 0. Returns the cudaError_t of the
// launches (0 on success). The caller checks shapes, dtypes, contiguity
// and the grid's limits, and allocates x_rows and cols.
int deform_im2col_f32(const void* x, const void* offsets, void* x_rows,
                      void* cols, int B, int C, int H, int W, int G, int Ho,
                      int Wo, int kh, int kw, int stride, int pad, int dil,
                      int vec4, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int Cg = C / G, HW = H * W, BG = B * G;
  const bool vec = vec4 && Cg % 4 == 0;
  const dim3 tgrid((Cg + kT - 1) / kT, (HW + kT - 1) / kT, BG);
  if (vec)
    deform_im2col_rows_kernel<true><<<tgrid, kThreads, 0, s>>>(
        (const float*)x, (float*)x_rows, Cg, HW);
  else
    deform_im2col_rows_kernel<false><<<tgrid, kThreads, 0, s>>>(
        (const float*)x, (float*)x_rows, Cg, HW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool out4 = (Ho * Wo) % 4 == 0;
  const dim3 grid((Ho * Wo + kPix - 1) / kPix,
                  kh * kw * ((Cg + kCh - 1) / kCh), BG);
  const float* xr = (const float*)x_rows;
  const float* off = (const float*)offsets;
  float* out = (float*)cols;
  if (vec && Cg % kCh == 0)
    launch_gather<4, true>(out4, grid, s, xr, off, out, H, W, Cg, Ho, Wo, kh,
                           kw, stride, pad, dil);
  else if (vec)
    launch_gather<4, false>(out4, grid, s, xr, off, out, H, W, Cg, Ho, Wo,
                            kh, kw, stride, pad, dil);
  else
    launch_gather<1, false>(out4, grid, s, xr, off, out, H, W, Cg, Ho, Wo,
                            kh, kw, stride, pad, dil);
  return (int)cudaGetLastError();
}

const char* deform_im2col_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
