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
// written.
//
// Layouts (all contiguous):
//   x        (B, C, H, W)           C = G * Cg, group g owns channels g*Cg..
//   offsets  (B, G*K*2, Ho, Wo)     channel g*2K + 2*(i*kw + j) + {0: dy, 1: dx}
//   x_rows   (B*G, H*W, Cg)         scratch: x channels-last, as the TPU
//                                   kernel reads it (x_rows at :465); the
//                                   bf16 design permutes each row's
//                                   channels (below)
//   cols     (B, G*K*Cg, Ho*Wo)     row g*K*Cg + (i*kw + j)*Cg + c
// so out (B, O, Ho*Wo) = W2 (O, G*K*Cg) @ cols, one torch.matmul.
//
// What bounds it on an H100: bytes. cols is K = 9 times the size of x (826
// MB in f32 over the five FeatureAlign levels of an 800x1344 batch of 4,
// about 0.25 ms at 3.35 TB/s), and each of its elements is four corner
// reads, mostly L1 and L2 hits since neighbouring pixels and taps share
// corners. A call is two kernels, a transpose of x into x_rows, so that a
// corner's Cg channels are one contiguous row, then the gather.
//
// f32 (and bf16 where Cg % 8 != 0, Cg > 256 or a pointer is not 16-byte
// aligned, with scalar gathers):
//   1. deform_im2col_rows_kernel transposes x into x_rows through 32x32
//      tiles of shared memory (x read and x_rows written once: 2/9 of the
//      cols bytes more);
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
//
// bf16 with Cg % 8 == 0, Cg <= 256 and 16-byte aligned x, x_rows and cols
// (FeatureAlign's Cg = 64): the f32 design templated on the element type
// moved 1.22 TB/s, against 2.96 for a fill of the same cols, because a bf16
// row is half the bytes for the same fixed costs: a thread's second
// gather slot idled at Cg = 64, a tile was f32 and a barrier moved 4 KB.
// Designed for bf16:
//   1. deform_im2col_rows_bf16_kernel: 16-byte loads along H*W (elements
//      where H*W % 8 != 0) into a (Cg, 64 pixels) bf16 tile, and 16-byte
//      stores of x_rows, each 8 channels of one pixel. Row position 8v + e
//      holds channel e*cv + v (cv = Cg / 8): the 16-byte vector v a gather
//      thread reads then fills tile rows v, cv + v, ..., 7cv + v, which the
//      swizzle below puts in 8 different banks. The tile's 16-byte chunks
//      are XOR-swizzled by row, so the loads' 16-byte stores and the
//      stores' 2-byte reads are free of bank conflicts. It releases the
//      gather (programmatic dependent launch: griddepcontrol) as it
//      starts, so the gather's blocks, whose prologue reads only the
//      offsets, start as its last blocks run.
//   2. deform_im2col_bf16_kernel: one block per kPix = 64 output pixels of
//      one (image, group) and all K taps, as above, so that a tap's
//      (pixel pair, vector) items are two 16-byte items a thread at
//      Cg = 64: 8 corner loads in flight a thread, issued for the next tap
//      before the current one is written. A level with too few such
//      blocks to keep the card busy (P5-P7 of an 800x1344 batch of 4)
//      spreads its taps over more blocks (gather_bf16_taps): there a
//      block's chain of K taps, each waiting on its loads, was the time. The tap's tile is bf16 in cols'
//      orientation, Cg rows of the block's 64 pixels (128 bytes), double-
//      buffered by tap and swizzled as the TMA engine's 128-byte swizzle
//      lays out a box; a thread packs its two pixels of one channel into
//      one 4-byte store, each value rounded once from the f32 sum that the
//      f32 kernel forms (the same bits as before). Where P % 8 == 0 (rows
//      16-byte strided: P3 and P4 of an 800x1344 image, ~94% of the cols
//      bytes) one thread stores the tap's (Cg x 64) box with one
//      cp.async.bulk.tensor (clipped at P) after fence.proxy.async and the
//      tap's barrier, and waits for it to have read the tile only before
//      the barrier after which that tile is written again, two taps later;
//      else the block's threads store the tile with the widest stores P's
//      alignment allows. The tensor map over cols, viewed as (B*G*K*Cg, P),
//      is encoded on the host for each call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "deform_corners.cuh"
#include "tma.cuh"

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
// elements: 4 f32 or 8 bf16). f32, and bf16 on the scalar route (vec 0).
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
  if constexpr (std::is_same_v<E, float>) {
    if (vec && Cg == 64)
      return (int)launch_gather<E, kVec, 64>(out4, x_rows, off, cols, BG, H,
                                             W, Cg, Ho, Wo, kh, kw, stride,
                                             pad, dil, s);
    if (vec && Cg % kVec == 0)
      return (int)launch_gather<E, kVec, 0>(out4, x_rows, off, cols, BG, H,
                                            W, Cg, Ho, Wo, kh, kw, stride,
                                            pad, dil, s);
  }
  return (int)launch_gather<E, 1, 0>(out4, x_rows, off, cols, BG, H, W, Cg,
                                     Ho, Wo, kh, kw, stride, pad, dil, s);
}

// ---- bf16, Cg % 8 == 0 (the design in the note at the top)

using bf16 = __nv_bfloat16;
using tma::smem_u32;

constexpr int kPix = 64;          // output pixels a bf16 gather block
constexpr int kRowB = 2 * kPix;   // bytes of a tile row (kPix bf16)
constexpr int kMaxCg = 256;       // a TMA box's rows at most
constexpr bool kPdl = true;       // the gather a programmatic dependent
// blocks of a gather grid that keep an H100 busy (four waves of 4 blocks
// on each of its 132 SMs): a level whose (tile, image·group) blocks are
// fewer splits its taps over that many blocks or fewer (below)
constexpr int kFillBlocks = 16 * 132;

// The byte offset `off` (row * kRowB + 2 * pixel) of a tile as the TMA
// engine lays out a box in shared memory with the swizzle of kRowB-byte
// rows (128: CU_TENSOR_MAP_SWIZZLE_128B): the 16-byte chunk index XOR bits
// 7.. of the offset, i.e. the row modulo 8, from a 1024-byte aligned base.
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t mask = kRowB / 16 - 1;
  return off ^ (((off >> 7) & mask) << 4);
}

// Shared memory of a bf16 gather block of `taps` taps: 1024 bytes of
// alignment slack, two tiles of Cg rows of kRowB bytes, and each (tap,
// pixel)'s weights (float4) and corner rows (int4).
__host__ __device__ __forceinline__ int gather_bf16_smem(int taps, int Cg) {
  return 1024 + 2 * Cg * kRowB + 32 * taps * kPix;
}

// Taps a bf16 gather block takes: all K where the grid of (pixel tile,
// image·group) blocks fills the card; else as few as spread the taps over
// up to kFillBlocks blocks, so that a small level's blocks do not each run
// K taps' chain of load latencies one after another.
__host__ __device__ __forceinline__ int gather_bf16_taps(int K, int P,
                                                         int BG) {
  const int blocks = (P + kPix - 1) / kPix * BG;
  int groups = (kFillBlocks + blocks - 1) / blocks;
  groups = groups < 1 ? 1 : groups > K ? K : groups;
  return (K + groups - 1) / groups;
}

// x (B*G, Cg, HW) -> x_rows (B*G, HW, Cg), row position 8v + e holding
// channel e*cv + v (cv = Cg / 8). Block: kPix pixels of one (image, group);
// its tile is Cg rows of kPix bf16, swizzled by swz. VIN: elements a load
// (8: 16 bytes, HW % 8 == 0; else 1), all of a thread's in flight at
// Cg = 64 (kBatch: 2 or 16).
template <int VIN>
__global__ void __launch_bounds__(kThreads) deform_im2col_rows_bf16_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ x_rows, int Cg, int HW) {
  using L = std::conditional_t<VIN == 8, uint4, uint16_t>;
  extern __shared__ __align__(16) uint8_t tile[];
  // the gather may start once every block of this grid has got here
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int64_t bg = blockIdx.y;
  const int p0 = blockIdx.x * kPix;
  const bf16* src = x + bg * Cg * HW + p0;
  const int n = min(kPix, HW - p0);
  constexpr int kPer = kPix / VIN;   // loads a tile row
  constexpr int kBatch = 16 / VIN;
  for (int i0 = 0; i0 < Cg * kPer; i0 += kBatch * kThreads) {
    L v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads + threadIdx.x;
      const int c = i / kPer, p = (i - c * kPer) * VIN;
      v[k] = L{};
      if (i < Cg * kPer && p < n)
        v[k] = *reinterpret_cast<const L*>(src + (int64_t)c * HW + p);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads + threadIdx.x;
      const int c = i / kPer, p = (i - c * kPer) * VIN;
      if (i < Cg * kPer)
        *reinterpret_cast<L*>(tile + swz(c * kRowB + 2 * p)) = v[k];
    }
  }
  __syncthreads();
  const int cv = Cg / 8;
  uint4* dst = reinterpret_cast<uint4*>(x_rows + (bg * HW + p0) * Cg);
  for (int i = threadIdx.x; i < n * cv; i += kThreads) {
    const int p = i / cv, v = i - p * cv;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = *reinterpret_cast<const uint16_t*>(
          tile + swz((2 * e * cv + v) * kRowB + 2 * p));
      const uint32_t hi = *reinterpret_cast<const uint16_t*>(
          tile + swz(((2 * e + 1) * cv + v) * kRowB + 2 * p));
      w[e] = lo | (hi << 16);
    }
    dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The gather. CG: Cg when known at compile time (64), else 0. STORE: 0 =
// each tap's tile stored by the TMA engine (P % 8 == 0); else the block's
// threads store STORE pixels at a time (8, 4, 2 or 1, as P's alignment
// allows). Block (pixel tile, image·group, tap group): taps tpb * z on, tpb
// of them or what is left of K. A tap's items are (pixel pair, vector):
// item i is pixels 2 * (i / cv) and the next, vector i % cv, in rounds of
// one item a thread.
template <int CG, int STORE>
__global__ void __launch_bounds__(kThreads, 4) deform_im2col_bf16_kernel(
    const bf16* __restrict__ x_rows, const float* __restrict__ offsets,
    bf16* __restrict__ cols, const __grid_constant__ CUtensorMap tm_cols,
    int H, int W, int Cg_, int Ho, int Wo, int kh, int kw, int stride,
    int pad, int dil, int tpb) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int Cg = CG ? CG : Cg_;
  const int K = kh * kw, P = Ho * Wo;
  const int t0 = blockIdx.z * tpb, nt = min(tpb, K - t0);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // the swizzle's period
  uint8_t* tiles = smem_raw + (base - raw);
  float4* cw = reinterpret_cast<float4*>(tiles + 2 * Cg * kRowB);
  int4* cq = reinterpret_cast<int4*>(cw + nt * kPix);
  const int64_t bg = blockIdx.y;
  const int p0 = blockIdx.x * kPix;

  for (int i = threadIdx.x; i < nt * kPix; i += kThreads) {
    const int t = t0 + i / kPix, j = i - (t - t0) * kPix;
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
  // x_rows is the transpose's output: read only once that grid is done
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();

  const int cv = Cg / 8;                 // 16-byte vectors a row
  const int items = (kPix / 2) * cv;     // a tap's (pixel pair, vector)s
  const int rounds = (items + kThreads - 1) / kThreads;
  const uint4* xb = reinterpret_cast<const uint4*>(x_rows + bg * H * W * Cg);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  using V = Vec<bf16, 8>;
  uint4 a[2][4];   // the corner vectors of the item in flight: 2 pixels
  auto issue = [&](int t, int r) {
    const int i = r * kThreads + threadIdx.x;
    const int j = 2 * (i / cv), v = i - (i / cv) * cv;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int4 q = i < items ? cq[t * kPix + j + u]
                               : make_int4(-1, -1, -1, -1);
      a[u][0] = q.x >= 0 ? xb[(int64_t)q.x * cv + v] : zero;
      a[u][1] = q.y >= 0 ? xb[(int64_t)q.y * cv + v] : zero;
      a[u][2] = q.z >= 0 ? xb[(int64_t)q.z * cv + v] : zero;
      a[u][3] = q.w >= 0 ? xb[(int64_t)q.w * cv + v] : zero;
    }
  };
  issue(0, 0);
  for (int t = 0; t < nt; ++t) {   // the block's taps, t0 + t of K
    uint8_t* tile = tiles + (t & 1) * Cg * kRowB;
    for (int r = 0; r < rounds; ++r) {
      const int i = r * kThreads + threadIdx.x;
      if (i < items) {
        const int j = 2 * (i / cv), v = i - (i / cv) * cv;
        const float4 w0 = cw[t * kPix + j], w1 = cw[t * kPix + j + 1];
        // where cv % 8 == 0 the rows e*cv + v share their row % 8, so
        // their swizzled offsets are one offset e*cv rows apart
        const uint32_t at = swz(v * kRowB + 2 * j);
        // channel e*cv + v of both pixels, rounded once: one 4-byte store
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float s0 = V::get(a[0][0], e) * w0.x +
                           V::get(a[0][1], e) * w0.y +
                           V::get(a[0][2], e) * w0.z +
                           V::get(a[0][3], e) * w0.w;
          const float s1 = V::get(a[1][0], e) * w1.x +
                           V::get(a[1][1], e) * w1.y +
                           V::get(a[1][2], e) * w1.z +
                           V::get(a[1][3], e) * w1.w;
          const uint32_t o = cv % 8 == 0
                                 ? at + e * cv * kRowB
                                 : swz((e * cv + v) * kRowB + 2 * j);
          *reinterpret_cast<__nv_bfloat162*>(tile + o) =
              __floats2bfloat162_rn(s0, s1);
        }
      }
      if (r + 1 < rounds)
        issue(t, r + 1);
      else if (t + 1 < nt)
        issue(t + 1, 0);
    }
    const int64_t row0 = (bg * K + t0 + t) * Cg;   // the tap's first row
    if constexpr (STORE == 0) {
      // this thread's tile writes, seen by the TMA engine; and the store
      // of the previous tap has read the other tile, which the next tap
      // writes after this barrier
      tma::fence_proxy_async();
      if (threadIdx.x == 0) tma::bulk_wait_read();
      __syncthreads();
      if (threadIdx.x == 0) {
        tma::tma_store_2d(&tm_cols, base + (t & 1) * Cg * kRowB, p0,
                          (int)row0);
        tma::bulk_commit();
      }
    } else {
      // the tile written above is read below, and the other tile, read in
      // the last tap, is written in the next
      __syncthreads();
      bf16* ob = cols + row0 * P + p0;
      constexpr int kLanes = kPix / STORE;   // threads a row of the tile
      for (int i = threadIdx.x; i < Cg * kLanes; i += kThreads) {
        const int c = i / kLanes, j = (i - c * kLanes) * STORE;
        if (p0 + j >= P) continue;
        const uint8_t* src = tile + swz(c * kRowB + 2 * j);
        bf16* dst = ob + (int64_t)c * P + j;
        if constexpr (STORE == 8)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else if constexpr (STORE == 4)
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        else if constexpr (STORE == 2)
          *reinterpret_cast<uint32_t*>(dst) =
              *reinterpret_cast<const uint32_t*>(src);
        else
          *reinterpret_cast<uint16_t*>(dst) =
              *reinterpret_cast<const uint16_t*>(src);
      }
    }
  }
  // the last stores have read the tiles before the block's shared memory
  // goes to another block
  if (STORE == 0 && threadIdx.x == 0) tma::bulk_wait_read();
}

// cols (rows of P bf16, P % 8 == 0) as the TMA store's map: (P, rows) in
// boxes of (kPix, Cg), swizzled as swz lays out the tile.
cudaError_t map_cols(CUtensorMap* m, void* cols, int P, int64_t rows,
                     int Cg) {
  const tma::EncodeTiled fn = tma::encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;   // no fallback
  const cuuint64_t dims[2] = {(cuuint64_t)P, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)P * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kPix, (cuuint32_t)Cg};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle sw = kRowB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : kRowB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cols, dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int CG, int STORE>
cudaError_t launch_gather_bf16(const bf16* x_rows, const float* off,
                               bf16* cols, const CUtensorMap& map, int BG,
                               int H, int W, int Cg, int Ho, int Wo, int kh,
                               int kw, int stride, int pad, int dil,
                               cudaStream_t s) {
  const int tpb = gather_bf16_taps(kh * kw, Ho * Wo, BG);
  const int smem = gather_bf16_smem(tpb, Cg);
  auto kernel = deform_im2col_bf16_kernel<CG, STORE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Ho * Wo + kPix - 1) / kPix, BG,
                     (kh * kw + tpb - 1) / tpb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = kPdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x_rows, off, cols, map, H, W, Cg,
                            Ho, Wo, kh, kw, stride, pad, dil, tpb);
}

template <int CG>
cudaError_t launch_gather_bf16(int store, const bf16* x_rows,
                               const float* off, bf16* cols,
                               const CUtensorMap& map, int BG, int H, int W,
                               int Cg, int Ho, int Wo, int kh, int kw,
                               int stride, int pad, int dil, cudaStream_t s) {
  switch (store) {
#define K1_GATHER(S)                                                        \
  case S:                                                                   \
    return launch_gather_bf16<CG, S>(x_rows, off, cols, map, BG, H, W, Cg,  \
                                     Ho, Wo, kh, kw, stride, pad, dil, s);
    K1_GATHER(0)
    K1_GATHER(8)
    K1_GATHER(4)
    K1_GATHER(2)
    K1_GATHER(1)
#undef K1_GATHER
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// The route of a bf16 call: 16-byte gathers on the bf16 design where Cg %
// 8 == 0, Cg <= kMaxCg and the pointers are 16-byte aligned; there, how a
// tap's tile is stored: 0 (the TMA engine, P % 8 == 0) or the widest
// register stores P's alignment allows (4, 2, 1 elements). -1: the scalar
// kernels.
int bf16_store(const void* x, const void* x_rows, const void* cols, int Cg,
               int P, int vec8) {
  if (!vec8 || Cg % 8 != 0 || Cg > kMaxCg || !aligned16(x) ||
      !aligned16(x_rows) || !aligned16(cols))
    return -1;
  return P % 8 == 0 ? 0 : P % 4 == 0 ? 4 : P % 2 == 0 ? 2 : 1;
}

int im2col_bf16(const bf16* x, const float* off, bf16* x_rows, bf16* cols,
                int B, int C, int H, int W, int G, int Ho, int Wo, int kh,
                int kw, int stride, int pad, int dil, int vec8,
                cudaStream_t s) {
  const int Cg = C / G, HW = H * W, BG = B * G, P = Ho * Wo;
  const int store = bf16_store(x, x_rows, cols, Cg, P, vec8);
  if (store < 0)
    return im2col<bf16>(x, off, x_rows, cols, B, C, H, W, G, Ho, Wo, kh, kw,
                        stride, pad, dil, 0, s);
  CUtensorMap map{};
  cudaError_t err;
  if (store == 0 &&
      (err = map_cols(&map, cols, P, (int64_t)BG * kh * kw * Cg, Cg)))
    return (int)err;
  const dim3 tgrid((HW + kPix - 1) / kPix, BG);
  const int tsmem = Cg * kRowB;
  if (HW % 8 == 0)
    deform_im2col_rows_bf16_kernel<8><<<tgrid, kThreads, tsmem, s>>>(
        x, x_rows, Cg, HW);
  else
    deform_im2col_rows_bf16_kernel<1><<<tgrid, kThreads, tsmem, s>>>(
        x, x_rows, Cg, HW);
  if ((err = cudaGetLastError())) return (int)err;
  return (int)(Cg == 64 ? launch_gather_bf16<64>(store, x_rows, off, cols,
                                                 map, BG, H, W, Cg, Ho, Wo,
                                                 kh, kw, stride, pad, dil, s)
                        : launch_gather_bf16<0>(store, x_rows, off, cols,
                                                map, BG, H, W, Cg, Ho, Wo,
                                                kh, kw, stride, pad, dil, s));
}

}  // namespace

extern "C" {

// Bytes of shared memory a gather block takes (bf16: on the bf16 design,
// the route of Cg % 8 == 0 and Cg <= 256).
int deform_im2col_smem_bytes(int K, int Cg, int bf16) {
  return bf16 && Cg % 8 == 0 && Cg <= kMaxCg
             ? gather_bf16_smem(K, Cg)
             : gather_smem_floats(K, Cg) * (int)sizeof(float);
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
// Where the TMA store takes cols (P % 8 == 0) and the driver has no
// cuTensorMapEncodeTiled, returns cudaErrorSymbolNotFound: no other route.
int deform_im2col_bf16(const void* x, const void* offsets, void* x_rows,
                       void* cols, int B, int C, int H, int W, int G, int Ho,
                       int Wo, int kh, int kw, int stride, int pad, int dil,
                       int vec8, void* stream) {
  return im2col_bf16((const bf16*)x, (const float*)offsets, (bf16*)x_rows,
                     (bf16*)cols, B, C, H, W, G, Ho, Wo, kh, kw, stride, pad,
                     dil, vec8, (cudaStream_t)stream);
}


const char* deform_im2col_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
