// Deformable im2col (forward) for FeatureAlign's deformable convolution.
//
// Replaces the TPU kernels of sipmask_tpu/ops/pallas/deform_gather.py that
// sample_bilinear_rows_t (:592) dispatches to: _sample_pallas_sep_t (:465,
// body _fwd_sep_t_kernel) and _sample_pallas_t (:546, body _fwd_t_kernel),
// and the dense XLA tier sample_dense_t beside them. The TPU turned the
// bilinear gather into a banded one-hot matmul because its gathers are slow;
// Hopper gathers natively, so this kernel reads the four corners.
//
// Semantics: sample_ref (deform_gather.py:99-130) on the positions of
// _sample_positions (sipmask_tpu/ops/deform_conv.py:45-69). Corners are
// floor(p) and floor(p)+1; a corner outside [0, H-1] x [0, W-1] contributes
// 0; weights are f32 products of (1 - frac) and frac (deform_corners.cuh).
//
// Element types: f32 throughout (deform_im2col_f32), or bf16 x, x_rows and
// cols with f32 offsets (deform_im2col_bf16), the JAX package's
// compute_dtype="bfloat16" graph: corners read in bf16, positions, weights
// and the interpolation in f32, each value rounded once to bf16 as it is
// written. The kernels are templates on the element type; a bf16 gather
// vector is 16 bytes, 8 channels.
//
// Layouts (all contiguous):
//   x        (B, C, H, W)           C = G * Cg, group g owns channels g*Cg..
//   offsets  (B, G*K*2, Ho, Wo)     channel g*2K + 2*(i*kw + j) + {0: dy, 1: dx}
//   x_rows   (B*G, H*W, Cg)         scratch: x channels-last, as the TPU
//                                   kernel reads it (x_rows at :465)
//   cols     (B, G*K*Cg, Ho*Wo)     row g*K*Cg + (i*kw + j)*Cg + c
// so out (B, O, Ho*Wo) = W2 (O, G*K*Cg) @ cols, one torch.matmul.
//
// What bounds it on an H100: bytes. cols is K = 9 times the size of x (826
// MB over the five FeatureAlign levels of an 800x1344 batch of 4, about
// 0.25 ms at 3.35 TB/s), and each of its elements is four corner reads,
// mostly L1 and L2 hits since neighbouring pixels and taps share corners.
// A call is two kernels:
//   1. deform_im2col_rows_kernel transposes x into x_rows through 32x32
//      tiles of shared memory (x read and x_rows written once: 2/9 of the
//      cols bytes more), so that a corner's Cg channels are one contiguous
//      row;
//   2. deform_im2col_kernel: one block per tile of kTile output pixels of
//      one (image, group), all K taps, so that corner rows shared by
//      neighbouring taps are L1 hits. The block works out each (pixel,
//      tap)'s corners and weights once, into shared memory, with each
//      corner's bounds tested on the float position before any address is
//      formed (offsets hundreds of pixels out never read outside x). Then,
//      tap by tap, threads with consecutive indices take consecutive 16-byte
//      vectors of one pixel's corner rows (Cg % 4 == 0; scalars otherwise),
//      so a warp's gathers read whole rows; the values go into a (pixel,
//      channel) tile in shared memory (rows padded to an odd stride, so the
//      write-out reads 32 banks), and the block writes the tap's Cg rows of
//      cols with lanes along the pixels (float4 where P % 4 == 0). A thread
//      issues the corner loads of its next kIt items (the next tap's, where
//      a tap is one round) before it fills and writes out the current tile,
//      so those loads are in flight across the barrier and the write-out;
//      registers are capped for 4 blocks an SM. Cg = 64, FeatureAlign's,
//      is a compile-time constant: the index arithmetic is then shifts and
//      masks.
// A design with one tap and 32 channels a block of 128 pixels, which writes
// longer runs of each row (tools/k1_tiles.cu), ran slower: its blocks share
// no corner rows across taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "deform_corners.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;        // output pixels a gather block
constexpr int kT = 32;           // transpose tile: channels x pixels
constexpr int kIt = 2;           // gather items a thread has in flight

template <typename T>
__global__ void __launch_bounds__(kThreads) deform_im2col_rows_kernel(
    const T* __restrict__ x, T* __restrict__ x_rows, int Cg, int HW) {
  __shared__ T tile[kT][kT + 1];
  const int64_t bg = blockIdx.z;
  const int p0 = blockIdx.x * kT, c0 = blockIdx.y * kT;
  const T* src = x + bg * Cg * HW;
  T* dst = x_rows + bg * HW * Cg;
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  for (int r = ty; r < kT; r += kThreads / kT) {
    const int c = c0 + r, p = p0 + tx;
    if (c < Cg && p < HW) tile[r][tx] = src[(int64_t)c * HW + p];
  }
  __syncthreads();
  for (int r = ty; r < kT; r += kThreads / kT) {
    const int p = p0 + r, c = c0 + tx;
    if (c < Cg && p < HW) dst[(int64_t)p * Cg + c] = tile[tx][r];
  }
}

// A gather load of VEC channels of element type E: its register type T and
// channel i of it in f32.
template <typename E, int VEC>
struct Vec;
template <>
struct Vec<float, 1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
};
template <>
struct Vec<float, 4> {
  using T = float4;
  __device__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using T = __nv_bfloat16;
  __device__ static float get(const T& v, int) { return __bfloat162float(v); }
};
template <>
struct Vec<__nv_bfloat16, 8> {   // 16 bytes: channel i in half i % 2 of word
  using T = uint4;               // i / 2 (little-endian pairs)
  __device__ static float get(const T& v, int i) {
    const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
    return __uint_as_float(i & 1 ? w & 0xFFFF0000u : w << 16);
  }
};

// Stores of f32 values as elements of type E: one, or four consecutive
// (16 bytes of f32, 8 of bf16); bf16 rounds to nearest even.
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// Shared memory of a gather block: each (tap, pixel)'s weights (float4) and
// corner rows (int4, -1 outside the map), and two (pixel, channel) tiles
// with rows of Cg | 1 floats.
__host__ __device__ __forceinline__ int gather_smem_floats(int K, int Cg) {
  return 8 * K * kTile + 2 * kTile * (Cg | 1);
}

// E: the element type of x_rows and cols; VEC: channels a gather load
// reads; VOUT: pixels a thread writes at once; CG: Cg when it is known at
// compile time, else 0. The (pixel, channel) tiles hold f32 values, rounded
// to E only as they are written out.
template <typename E, int VEC, int VOUT, int CG>
__global__ void __launch_bounds__(kThreads, 4) deform_im2col_kernel(
    const E* __restrict__ x_rows, const float* __restrict__ offsets,
    E* __restrict__ cols, int H, int W, int Cg_, int Ho, int Wo, int kh,
    int kw, int stride, int pad, int dil) {
  using V = Vec<E, VEC>;
  using T = typename V::T;
  extern __shared__ __align__(16) float smem[];
  const int Cg = CG ? CG : Cg_;
  const int K = kh * kw, P = Ho * Wo;
  const int RS = Cg | 1;     // an odd row stride: conflict-free write-out
  float4* cw = reinterpret_cast<float4*>(smem);
  int4* cq = reinterpret_cast<int4*>(smem + 4 * K * kTile);
  float* tiles = smem + 8 * K * kTile;
  const int64_t bg = blockIdx.y;
  const int p0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < K * kTile; i += kThreads) {
    const int t = i / kTile, j = i - t * kTile;
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
    cw[i] = w;
    cq[i] = q;
  }
  __syncthreads();

  const int cv = Cg / VEC;   // vectors a row
  const int items = kTile * cv;
  // a tap's items in rounds of kIt a thread: item r * kIt * kThreads +
  // u * kThreads + threadIdx.x is pixel i / cv, vector i % cv
  const int rounds = (items + kIt * kThreads - 1) / (kIt * kThreads);
  const T* xb = reinterpret_cast<const T*>(x_rows + bg * H * W * Cg);
  const T zero{};
  T a[kIt][4];   // the corner vectors of the items in flight
  auto issue = [&](int t, int r) {
#pragma unroll
    for (int u = 0; u < kIt; ++u) {
      const int i = (r * kIt + u) * kThreads + threadIdx.x;
      const int j = i / cv, v = i - j * cv;
      const int4 q = i < items ? cq[t * kTile + j]
                               : make_int4(-1, -1, -1, -1);
      a[u][0] = q.x >= 0 ? xb[(int64_t)q.x * cv + v] : zero;
      a[u][1] = q.y >= 0 ? xb[(int64_t)q.y * cv + v] : zero;
      a[u][2] = q.z >= 0 ? xb[(int64_t)q.z * cv + v] : zero;
      a[u][3] = q.w >= 0 ? xb[(int64_t)q.w * cv + v] : zero;
    }
  };
  issue(0, 0);
  for (int t = 0; t < K; ++t) {
    float* tile = tiles + (t & 1) * kTile * RS;
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int u = 0; u < kIt; ++u) {
        const int i = (r * kIt + u) * kThreads + threadIdx.x;
        if (i >= items) break;
        const int j = i / cv, v = i - j * cv;
        const float4 w = cw[t * kTile + j];
        float* row = tile + j * RS + v * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          row[e] = V::get(a[u][0], e) * w.x + V::get(a[u][1], e) * w.y +
                   V::get(a[u][2], e) * w.z + V::get(a[u][3], e) * w.w;
      }
      if (r + 1 < rounds)
        issue(t, r + 1);
      else if (t + 1 < K)
        issue(t + 1, 0);
    }
    // one barrier a tap: the tile written above is read below, and the
    // other tile, read in the last tap, is written in the next
    __syncthreads();
    E* ob = cols + (bg * K + t) * Cg * P + p0;
    constexpr int kLanes = kTile / VOUT;   // threads a row of the tile
    for (int i = threadIdx.x; i < Cg * kLanes; i += kThreads) {
      const int c = i / kLanes, j = (i - c * kLanes) * VOUT;
      if (p0 + j >= P) continue;
      if constexpr (VOUT == 4) {   // P % 4 == 0: the vector lies in the row
        store4(ob + (int64_t)c * P + j, tile[j * RS + c],
               tile[(j + 1) * RS + c], tile[(j + 2) * RS + c],
               tile[(j + 3) * RS + c]);
      } else {
        store1(ob + (int64_t)c * P + j, tile[j * RS + c]);
      }
    }
  }
}

template <typename E, int VEC, int VOUT, int CG>
cudaError_t launch_gather(const E* x_rows, const float* offsets, E* cols,
                          int BG, int H, int W, int Cg, int Ho, int Wo,
                          int kh, int kw, int stride, int pad, int dil,
                          cudaStream_t stream) {
  const int smem = gather_smem_floats(kh * kw, Cg) * (int)sizeof(float);
  auto kernel = deform_im2col_kernel<E, VEC, VOUT, CG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Ho * Wo + kTile - 1) / kTile, BG);
  kernel<<<grid, kThreads, smem, stream>>>(x_rows, offsets, cols, H, W, Cg,
                                           Ho, Wo, kh, kw, stride, pad, dil);
  return cudaGetLastError();
}

template <typename E, int VEC, int CG>
cudaError_t launch_gather(bool out4, const E* x_rows, const float* offsets,
                          E* cols, int BG, int H, int W, int Cg, int Ho,
                          int Wo, int kh, int kw, int stride, int pad,
                          int dil, cudaStream_t s) {
  return out4 ? launch_gather<E, VEC, 4, CG>(x_rows, offsets, cols, BG, H,
                                             W, Cg, Ho, Wo, kh, kw, stride,
                                             pad, dil, s)
              : launch_gather<E, VEC, 1, CG>(x_rows, offsets, cols, BG, H,
                                             W, Cg, Ho, Wo, kh, kw, stride,
                                             pad, dil, s);
}

// Both kernels of a call; vec: 16-byte gathers (Cg a multiple of 16 bytes'
// elements: 4 f32 or 8 bf16).
template <typename E>
int im2col(const E* x, const float* off, E* x_rows, E* cols, int B, int C,
           int H, int W, int G, int Ho, int Wo, int kh, int kw, int stride,
           int pad, int dil, int vec, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(E);
  const int Cg = C / G, HW = H * W, BG = B * G;
  const dim3 tgrid((HW + kT - 1) / kT, (Cg + kT - 1) / kT, BG);
  deform_im2col_rows_kernel<E><<<tgrid, kThreads, 0, s>>>(x, x_rows, Cg, HW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool out4 = (Ho * Wo) % 4 == 0;
  if (vec && Cg == 64)
    err = launch_gather<E, kVec, 64>(out4, x_rows, off, cols, BG, H, W, Cg,
                                     Ho, Wo, kh, kw, stride, pad, dil, s);
  else if (vec && Cg % kVec == 0)
    err = launch_gather<E, kVec, 0>(out4, x_rows, off, cols, BG, H, W, Cg,
                                    Ho, Wo, kh, kw, stride, pad, dil, s);
  else
    err = launch_gather<E, 1, 0>(out4, x_rows, off, cols, BG, H, W, Cg, Ho,
                                 Wo, kh, kw, stride, pad, dil, s);
  return (int)err;
}

}  // namespace

extern "C" {

// Bytes of shared memory a gather block takes.
int deform_im2col_smem_bytes(int K, int Cg) {
  return gather_smem_floats(K, Cg) * (int)sizeof(float);
}

// x (B, C, H, W), offsets (B, G*K*2, Ho, Wo) -> x_rows (B*G, H*W, Cg)
// scratch, then cols (B, G*K*Cg, Ho*Wo); all contiguous f32, x_rows and
// cols 16-byte aligned. vec4: Cg % 4 == 0. Returns the cudaError_t of the
// launches (0 on success). The caller checks shapes, dtypes, contiguity
// and the grid's limits, and allocates x_rows and cols.
int deform_im2col_f32(const void* x, const void* offsets, void* x_rows,
                      void* cols, int B, int C, int H, int W, int G, int Ho,
                      int Wo, int kh, int kw, int stride, int pad, int dil,
                      int vec4, void* stream) {
  return im2col<float>((const float*)x, (const float*)offsets,
                       (float*)x_rows, (float*)cols, B, C, H, W, G, Ho, Wo,
                       kh, kw, stride, pad, dil, vec4, (cudaStream_t)stream);
}

// The same with x, x_rows and cols bf16 (offsets f32). vec8: Cg % 8 == 0.
int deform_im2col_bf16(const void* x, const void* offsets, void* x_rows,
                       void* cols, int B, int C, int H, int W, int G, int Ho,
                       int Wo, int kh, int kw, int stride, int pad, int dil,
                       int vec8, void* stream) {
  using bf16 = __nv_bfloat16;
  return im2col<bf16>((const bf16*)x, (const float*)offsets, (bf16*)x_rows,
                      (bf16*)cols, B, C, H, W, G, Ho, Wo, kh, kw, stride, pad,
                      dil, vec8, (cudaStream_t)stream);
}

const char* deform_im2col_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
