// Deformable convolution backward for FeatureAlign's deformable convolution.
//
// Replaces the TPU kernel sipmask_tpu/ops/pallas/deform_gather.py:
// _deform_bwd_pallas (:878, body _bwd_conv_kernel :807), which computes the
// whole backward of out = W2 @ cols in one banded pass: dsamp = dy·W^T,
// dW = samp^T·dy, dX by col2im, and d positions. Here the same four
// products, in these launches:
//
//   x_rows (B*G, H*W, Cg)  = x (B, G, Cg, H*W) transposed   transpose
//   dcols  (B*G, P, K*Cg)  = (dy_b^T (P, O) · W2 (O, KC))   GEMM, per image,
//                            written p-major per group
//   dW2    (O, KC)         = sum_b dy_b (O, P) · cols_b^T   GEMM, split over
//                            (image, 2048-pixel chunk) into
//                            partials, then a fold in order
//   dX rows, d offsets     from dcols                        scatter
//   dX (B, C, H, W)        = dX rows transposed              transpose
//
// with KC = G*K*Cg rows of cols in deform_im2col.cu's order (g*K*Cg +
// tap*Cg + c), O output channels, P = Ho*Wo.
//
// Two element types (conv_bwd): f32 (deform_conv_bwd_f32, 3xTF32 mma.sync
// GEMMs and a memset of the dX scratch: seven launches), and the JAX
// package's compute_dtype="bfloat16" graph (deform_conv_bwd_bf16), whose x,
// cols, W2 and dy are bf16 and whose offsets stay f32. In bf16, as
// _bwd_conv_kernel does: dsamp = dy·W^T is summed in f32 and rounded to
// bf16 (deform_gather.py:845); dW2 is summed in f32 and stays f32 (:842);
// dX is summed in f32 (an f32 scratch: no bf16 atomics) and rounded once to
// bf16 by the last transpose (:863, :931); d positions are f32. A bf16 call
// is six launches, seven where P % 8 != 0 (below): the first transpose also
// zeroes the dX scratch.
//
// Semantics of dX and d offsets: the autodiff of sample_ref
// (deform_gather.py:99-130), which the JAX package's CPU path takes
// (:1021-1026). Each of a sample's four corners (floor(p), floor(p)+1)
// contributes only when it lies in the map (deform_corners.cuh); the
// derivative of a corner's weight with respect to the position is the
// one-sided, floor-based one of _dtent (:164-167): the floor corner gets -1,
// the other +1 (times the other axis's weight). It is not sign(): at integer
// positions, which zero offsets give, sign() would zero every offset
// gradient and the zero-initialised conv_offset would never train.
//
// What bounds it on an H100, f32: operations. The two GEMMs are 2*KC*O*P
// flops per image each (79 GFLOP each at the P3 level of an 800x1344 image,
// batch 4), and must keep f32 accuracy. On the CUDA cores (67 TFLOP/s by
// the H100 SXM data sheet) they were the bound, and SIMT SGEMMs took 61% of
// the time at 22 TFLOP/s (NVIDIA H100 80GB HBM3, 700 W). The design moves
// them onto the tensor cores in 3xTF32: each operand is split into
// big = tf32(a) and small = tf32(a - big), and small·big + big·small
// + big·big is accumulated in f32 (three TF32 products per f32 product at
// the data sheet's 495 TFLOP/s: a bound 2.6x below the CUDA cores'):
//   - mma.sync m16n8k8 TF32 on 128x128 block tiles, 8 warps of 64x32;
//   - operand tiles in shared memory filled by 16-byte cp.async in a ring
//     of 3 stages (4-byte copies where P % 4 != 0), padded so that every
//     fragment load is free of bank conflicts (K-major rows of 32 + 4
//     floats: bank 4*row + k; M/N-major rows of 128 + 8: bank 8*k + row);
//   - the split is made as each fragment leaves shared memory, by two
//     integer operations per TF32 rounding;
//   - each 32-deep stage is summed by the tensor cores from zero and then
//     added to the f32 accumulator with round-to-nearest: the tensor cores'
//     own sums round toward zero, a bias that grows along the chain.
// What bounds the f32 GEMMs now is mma.sync itself: with a third of the
// products they run about twice as fast (tools/k2_gemm_probe.py), and
// mma.sync reaches about a third of the TF32 rate that wgmma can. wgmma
// takes B only from shared memory, and 3xTF32 reads it three times a k8
// step in each warpgroup: a stage's shared-memory traffic then matches its
// tensor time, and wgmma versions of this loop ran no faster.
//
// bf16: one product per output, so nothing holds the GEMMs off wgmma. The
// dcols and dW2 GEMMs (section "bf16 GEMMs on wgmma") are warp-specialised
// persistent kernels: one producer thread issues TMA loads of 128-byte
// swizzled tiles into a ring of stages guarded by mbarriers, and two
// consumer warpgroups run wgmma.mma_async m64nNk16 (bf16 -> f32) on them.
// dcols keeps its block's 192-column slice of W2 (all O rows) resident in
// shared memory and streams dy; its tile never straddles a deform group
// (192 divides K*Cg = 576), so the epilogue rounds to bf16 into a swizzled
// staging tile and TMA stores one contiguous (pixels x columns) block of
// the p-major dcols. dW2's operands are both K-major (pixels contiguous);
// each 64-deep stage is summed by the tensor cores from zero and added to
// the f32 accumulator with round-to-nearest, as the f32 GEMM flushes.
// TMA needs 16-byte row strides (P % 8 == 0). Levels with P % 8 != 0
// (800x1344: P5-P7, P = 1050, 273, 77; HRFPN's 12x21 and 6x10) first copy
// dy and cols into rows of P rounded up to 8 in the caller's scratch, one
// extra launch (pad_rows_kernel), and take the same wgmma GEMMs; shapes
// the wgmma kernels cannot take (K*Cg no multiple of 192, O > 256) keep
// the mma.sync m16n8k16 GEMMs (bf16 tiles by cp.async, 32-deep stages
// flushed the same way). The choice is by shape (wg::route).
//
// The scatter was the other 38% of the f32 call (same card): one thread per
// (image, group, tap, pixel) added each channel's value into NCHW dX with
// scalar atomics whose addresses lay a plane apart from channel to channel.
// Now dcols is p-major per group, x and dX are channels-last rows, and one
// warp takes one (image, group, pixel) and its K taps with its lanes along
// the Cg channels (two each, Cg even): every corner read and every atomic
// of a warp is one contiguous run of Cg floats (float2 atomics), and d
// position is reduced across the warp with shuffles (no atomics). In bf16
// with Cg % 4 == 0 a half-warp takes one (image, group, pixel, tap), four
// channels a lane: 8-byte loads of dcols and of each corner's x, one float4
// reduction a corner (half the vector reductions of float2), corners whose
// bilinear weight is exactly 0 skipped (3 of 4 at integer positions; their
// x still enters d position), d position reduced over the half-warp by a
// fixed shuffle tree. dX's atomics are the only sums whose order changes
// from run to run: dW2 and d offsets are the same bits from call to call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "deform_corners.cuh"
#include "tma.cuh"

namespace {

using dcn::Corners;
using dcn::corners;

// ---- 3xTF32 tensor-core GEMM

constexpr int kBM = 128, kBN = 128, kBK = 32;  // block tile, depth of a stage
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;              // 8 warps: 2 (M) x 4 (N)
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;  // mma tiles of a warp
constexpr int kLdK = kBK + 4;    // K-major tile row: 32 floats + 4 pad
constexpr int kLdMN = kBM + 8;   // M/N-major tile row: 128 floats + 8 pad
constexpr int kSplitK = 2048;    // pixels per dW2 partial
constexpr int kThreads = 256;

template <bool KMAJOR>
struct Tile {
  // floats of one operand tile in shared memory
  static constexpr int kFloats = KMAJOR ? kBM * kLdK : kBK * kLdMN;
  // element (r, k) of the tile, r along M (or N), k along the contraction
  __device__ static int at(int r, int k) {
    return KMAJOR ? r * kLdK + k : k * kLdMN + r;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy one operand tile (rows [r0, r0 + 128) of `rows`, k in [k0, k0 + 32)
// below k_end) into shared memory, zero outside. Element (r, k) of the
// operand is g[r*ld + k] (KMAJOR) or g[k*ld + r]. vec: 16-byte copies; the
// launcher guarantees 16-byte aligned rows and, along the contiguous axis,
// extents that are multiples of 4, so a chunk lies wholly in or out.
template <bool KMAJOR>
__device__ __forceinline__ void load_tile(float* sm, const float* g, int ld,
                                          int rows, int r0, int k0,
                                          int k_end, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kGemmThreads; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = KMAJOR ? c >> 3 : (c & 31) * 4;
      const int k = KMAJOR ? (c & 7) * 4 : c >> 5;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rows && gk < k_end;
      const float* src =
          ok ? g + (KMAJOR ? (int64_t)gr * ld + gk : (int64_t)gk * ld + gr)
             : g;
      cp_async16(sm + Tile<KMAJOR>::at(r, k), src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kGemmThreads; ++i) {
      const int e = tid + i * kGemmThreads;
      const int r = KMAJOR ? e >> 5 : e & 127;
      const int k = KMAJOR ? e & 31 : e >> 7;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rows && gk < k_end;
      const float* src =
          ok ? g + (KMAJOR ? (int64_t)gr * ld + gk : (int64_t)gk * ld + gr)
             : g;
      cp_async4(sm + Tile<KMAJOR>::at(r, k), src, ok ? 4 : 0);
    }
  }
}

// f32 -> the nearest TF32 value, ties away from zero: cvt.rna.tf32.f32's
// result, formed with two integer operations (add half a TF32 unit to the
// bits, clear the 13 low mantissa bits) that run at the full ALU rate where
// the conversion instruction does not.
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = big + small, both TF32
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(a);
  small = to_tf32(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename E, typename O>
struct GemmArgsT {   // operands of element type E, C of type O
  const E* A;
  const E* B;
  O* C;
  int M, N, K, lda, ldb;
  int64_t strideA, strideB;  // per image
  int splits, k_chunk;       // z = image * splits + split
  // C(m, n) of z lies at C[z*strideC + (n / n_group)*group_stride
  //                        + m*ldc + n % n_group]
  int64_t strideC, group_stride;
  int ldc, n_group;
  int vec;                   // 16-byte copies (see load_tile)
};
using GemmArgs = GemmArgsT<float, float>;

// C_z = A_z · B_z in 3xTF32 for k in [split*k_chunk, min(K, (split+1)*
// k_chunk)); A(m, k) = A[k*lda + m] unless A_KMAJOR (A[m*lda + k]), B(k, n)
// = B[k*ldb + n] unless B_KMAJOR (B[n*ldb + k]). grid (ceil(N/128),
// ceil(M/128), images*splits), dynamic shared memory gemm_smem_bytes().
template <bool A_KMAJOR, bool B_KMAJOR>
__global__ void __launch_bounds__(kGemmThreads, 1)
    deform_bwd_gemm_kernel(const GemmArgs p) {
  using TA = Tile<A_KMAJOR>;
  using TB = Tile<B_KMAJOR>;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kStages * TA::kFloats;
  const int z = blockIdx.z;
  const int image = z / p.splits, split = z - image * p.splits;
  const float* A = p.A + image * p.strideA;
  const float* B = p.B + image * p.strideB;
  const int k_begin = split * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const int tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * kWarpM, wn = (warp & 3) * kWarpN;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = p.vec != 0;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      const int k0 = k_begin + s * kBK;
      load_tile<A_KMAJOR>(As + s * TA::kFloats, A, p.lda, p.M, m0, k0, k_end,
                          vec, tid);
      load_tile<B_KMAJOR>(Bs + s * TB::kFloats, B, p.ldb, p.N, n0, k0, k_end,
                          vec, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed
    __syncthreads();                // and every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < tiles) {
      const int k0 = k_begin + next * kBK;
      const int st = next % kStages;
      load_tile<A_KMAJOR>(As + st * TA::kFloats, A, p.lda, p.M, m0, k0,
                          k_end, vec, tid);
      load_tile<B_KMAJOR>(Bs + st * TB::kFloats, B, p.ldb, p.N, n0, k0,
                          k_end, vec, tid);
    }
    cp_async_commit();
    const float* as = As + (kt % kStages) * TA::kFloats;
    const float* bs = Bs + (kt % kStages) * TB::kFloats;
    float part[kMT][kNT][4];   // this stage's products, in the tensor cores
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t b_big[kNT][2], b_small[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = wn + j * 8 + g;
        split_tf32(bs[TB::at(n, kk + t)], b_big[j][0], b_small[j][0]);
        split_tf32(bs[TB::at(n, kk + t + 4)], b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int m = wm + i * 16 + g;
        uint32_t a_big[4], a_small[4];
        split_tf32(as[TA::at(m, kk + t)], a_big[0], a_small[0]);
        split_tf32(as[TA::at(m + 8, kk + t)], a_big[1], a_small[1]);
        split_tf32(as[TA::at(m, kk + t + 4)], a_big[2], a_small[2]);
        split_tf32(as[TA::at(m + 8, kk + t + 4)], a_big[3], a_small[3]);
        // the three products of one output tile depend on each other
        // through its accumulator: issue them kNT independent mmas apart
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_tf32(part[i][j], a_small, b_big[j]);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_tf32(part[i][j], a_big, b_small[j]);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_tf32(part[i][j], a_big, b_big[j]);
      }
    }
    // The tensor cores round their f32 sums toward zero; over a long chain
    // (up to 3 x 256 steps into one accumulator for a 2048-pixel chunk)
    // that bias grows with the chain and put dW2 1.5e-5 of its max off.
    // Each stage starts from zero and is added with round-to-nearest.
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // epilogue: thread (g, t) holds rows m, m + 8 and columns n, n + 1
  float* C = p.C + z * p.strideC;
  const bool pairs = p.ldc % 2 == 0 && p.n_group % 2 == 0 && p.N % 2 == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t;
      if (n >= p.N) continue;
      const int64_t col = (int64_t)(n / p.n_group) * p.group_stride +
                          n % p.n_group;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        if (m >= p.M) continue;
        float* c = C + (int64_t)m * p.ldc + col;
        if (pairs) {
          *reinterpret_cast<float2*>(c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          c[0] = acc[i][j][2 * h];
          if (n + 1 < p.N) {
            const int n1 = n + 1;
            C[(int64_t)(n1 / p.n_group) * p.group_stride + (int64_t)m * p.ldc +
              n1 % p.n_group] = acc[i][j][2 * h + 1];
          }
        }
      }
    }
  }
}

template <bool A_KMAJOR, bool B_KMAJOR>
constexpr int gemm_smem_bytes() {
  return kStages * (Tile<A_KMAJOR>::kFloats + Tile<B_KMAJOR>::kFloats) *
         (int)sizeof(float);
}

template <bool A_KMAJOR, bool B_KMAJOR>
cudaError_t launch_gemm(const GemmArgs& p, int images, cudaStream_t st) {
  auto kernel = deform_bwd_gemm_kernel<A_KMAJOR, B_KMAJOR>;
  constexpr int smem = gemm_smem_bytes<A_KMAJOR, B_KMAJOR>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM,
                  images * p.splits);
  kernel<<<grid, kGemmThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// ---- bf16 tensor-core GEMM (the compute_dtype="bfloat16" backward)
//
// The same block tiles, warp tiles, ring of stages and epilogue as above,
// on bf16 operands: mma.sync m16n8k16 with f32 accumulation, one product
// per output (no split), each 32-deep stage summed from zero by the tensor
// cores and added to the f32 accumulator with round-to-nearest. Operand
// tiles hold the raw bf16 bits (uint16_t); rows padded by 8 elements
// (K-major rows of 40: 32-bit fragment loads hit banks 20*row + t, all
// distinct; M/N-major rows of 136: a fragment's pairs are two 16-bit loads,
// banks 8*t + row/2).

using bf16 = __nv_bfloat16;

template <bool KMAJOR>
struct TileH {
  static constexpr int kLdK = kBK + 8;
  static constexpr int kLdMN = kBM + 8;
  static constexpr int kElems = KMAJOR ? kBM * kLdK : kBK * kLdMN;
  __device__ static int at(int r, int k) {
    return KMAJOR ? r * kLdK + k : k * kLdMN + r;
  }
};

// One bf16 operand tile into shared memory, as load_tile: 16-byte chunks of
// 8 elements (cp.async) when vec, else element by element (plain loads and
// stores, seen by the block after the next barrier). The launcher
// guarantees, for vec, 16-byte aligned rows and extents along the
// contiguous axis that are multiples of 8.
template <bool KMAJOR>
__device__ __forceinline__ void load_tile_h(uint16_t* sm, const uint16_t* g,
                                            int ld, int rows, int r0, int k0,
                                            int k_end, bool vec, int tid) {
  using TT = TileH<KMAJOR>;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kGemmThreads; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = KMAJOR ? c >> 2 : (c & 15) * 8;
      const int k = KMAJOR ? (c & 3) * 8 : c >> 4;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rows && gk < k_end;
      const uint16_t* src =
          ok ? g + (KMAJOR ? (int64_t)gr * ld + gk : (int64_t)gk * ld + gr)
             : g;
      cp_async16(reinterpret_cast<float*>(sm + TT::at(r, k)),
                 reinterpret_cast<const float*>(src), ok ? 16 : 0);
    }
  } else {
    for (int i = 0; i < kBM * kBK / kGemmThreads; ++i) {
      const int e = tid + i * kGemmThreads;
      const int r = KMAJOR ? e >> 5 : e & 127;
      const int k = KMAJOR ? e & 31 : e >> 7;
      const int gr = r0 + r, gk = k0 + k;
      sm[TT::at(r, k)] =
          gr < rows && gk < k_end
              ? g[KMAJOR ? (int64_t)gr * ld + gk : (int64_t)gk * ld + gr]
              : (uint16_t)0;
    }
  }
}

// Elements (r, k) and (r, k + 1) of a tile, packed low and high: one
// fragment register of mma.sync's bf16 operands.
template <bool KMAJOR>
__device__ __forceinline__ uint32_t frag_pair(const uint16_t* sm, int r,
                                              int k) {
  using TT = TileH<KMAJOR>;
  if (KMAJOR) return *reinterpret_cast<const uint32_t*>(sm + TT::at(r, k));
  return (uint32_t)sm[TT::at(r, k)] | ((uint32_t)sm[TT::at(r, k + 1)] << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* c, float v) { *c = v; }
__device__ __forceinline__ void store_out(bf16* c, float v) {
  *c = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* c, float a, float b) {
  *reinterpret_cast<float2*>(c) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* c, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(a, b);
}

// C_z = A_z · B_z with bf16 operands (indexing as deform_bwd_gemm_kernel),
// f32 sums, C of type O (f32, or bf16 rounded to nearest even).
template <bool A_KMAJOR, bool B_KMAJOR, typename O>
__global__ void __launch_bounds__(kGemmThreads, 1)
    deform_bwd_gemm_bf16_kernel(const GemmArgsT<bf16, O> p) {
  using TA = TileH<A_KMAJOR>;
  using TB = TileH<B_KMAJOR>;
  extern __shared__ float4 smem4[];
  uint16_t* As = reinterpret_cast<uint16_t*>(smem4);
  uint16_t* Bs = As + kStages * TA::kElems;
  const int z = blockIdx.z;
  const int image = z / p.splits, split = z - image * p.splits;
  const uint16_t* A = reinterpret_cast<const uint16_t*>(p.A) +
                      image * p.strideA;
  const uint16_t* B = reinterpret_cast<const uint16_t*>(p.B) +
                      image * p.strideB;
  const int k_begin = split * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const int tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * kWarpM, wn = (warp & 3) * kWarpN;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = p.vec != 0;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      const int k0 = k_begin + s * kBK;
      load_tile_h<A_KMAJOR>(As + s * TA::kElems, A, p.lda, p.M, m0, k0,
                            k_end, vec, tid);
      load_tile_h<B_KMAJOR>(Bs + s * TB::kElems, B, p.ldb, p.N, n0, k0,
                            k_end, vec, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed
    __syncthreads();                // and every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < tiles) {
      const int k0 = k_begin + next * kBK;
      const int st = next % kStages;
      load_tile_h<A_KMAJOR>(As + st * TA::kElems, A, p.lda, p.M, m0, k0,
                            k_end, vec, tid);
      load_tile_h<B_KMAJOR>(Bs + st * TB::kElems, B, p.ldb, p.N, n0, k0,
                            k_end, vec, tid);
    }
    cp_async_commit();
    const uint16_t* as = As + (kt % kStages) * TA::kElems;
    const uint16_t* bs = Bs + (kt % kStages) * TB::kElems;
    float part[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = wn + j * 8 + g;
        b[j][0] = frag_pair<B_KMAJOR>(bs, n, kk + 2 * t);
        b[j][1] = frag_pair<B_KMAJOR>(bs, n, kk + 2 * t + 8);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int m = wm + i * 16 + g;
        const uint32_t a[4] = {frag_pair<A_KMAJOR>(as, m, kk + 2 * t),
                               frag_pair<A_KMAJOR>(as, m + 8, kk + 2 * t),
                               frag_pair<A_KMAJOR>(as, m, kk + 2 * t + 8),
                               frag_pair<A_KMAJOR>(as, m + 8, kk + 2 * t + 8)};
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(part[i][j], a, b[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // epilogue: thread (g, t) holds rows m, m + 8 and columns n, n + 1
  O* C = p.C + z * p.strideC;
  const bool pairs = p.ldc % 2 == 0 && p.n_group % 2 == 0 && p.N % 2 == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t;
      if (n >= p.N) continue;
      const int64_t col = (int64_t)(n / p.n_group) * p.group_stride +
                          n % p.n_group;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        if (m >= p.M) continue;
        O* c = C + (int64_t)m * p.ldc + col;
        if (pairs) {
          store_pair(c, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          store_out(c, acc[i][j][2 * h]);
          if (n + 1 < p.N) {
            const int n1 = n + 1;
            store_out(C + (int64_t)(n1 / p.n_group) * p.group_stride +
                          (int64_t)m * p.ldc + n1 % p.n_group,
                      acc[i][j][2 * h + 1]);
          }
        }
      }
    }
  }
}

template <bool A_KMAJOR, bool B_KMAJOR, typename O>
cudaError_t launch_gemm_bf16(const GemmArgsT<bf16, O>& p, int images,
                             cudaStream_t st) {
  auto kernel = deform_bwd_gemm_bf16_kernel<A_KMAJOR, B_KMAJOR, O>;
  constexpr int smem = kStages *
                       (TileH<A_KMAJOR>::kElems + TileH<B_KMAJOR>::kElems) *
                       (int)sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM,
                  images * p.splits);
  kernel<<<grid, kGemmThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// ---- bf16 GEMMs on wgmma, fed by TMA (Hopper)
//
// Both kernels: one producer thread issues every TMA load (dcols: in
// warpgroup 0 of 384 threads, whose registers setmaxnreg gives to the
// consumers; dW2: in a ninth warp of 288 threads), and two consumer
// warpgroups each compute 64 rows of the block's 128-row tile. Operand tiles are TMA boxes of 64 bf16 (128 bytes) along
// the contiguous axis, swizzled by 128 bytes, which is the layout the wgmma
// matrix descriptors below name: K-major (dW2: rows of 64 k, 8-row atoms
// 1024 bytes apart, a k16 step 32 bytes on) or M/N-major (dcols: rows of 64
// m or n along k, 8-k atoms 1024 bytes apart, 64-wide blocks `lbo` apart, a
// k16 step 2048 bytes on). Full barriers take the producer's expect_tx and
// the TMA bytes; empty barriers one arrival per consumer warp, made after
// the warp has waited for the wgmma group that read the stage.

namespace wg {

constexpr int kThreads = 384;                 // the dcols GEMM's block
constexpr int kBox = 64;                      // bf16 in a swizzled row
constexpr int kBox64 = kBox * kBox * 2;       // a 64 x 64 box, 8 KB

using namespace tma;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of `parity` has completed. A wait no launch needs
// (over 2**28 polls, tens of seconds) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a barrier over one warpgroup (ids 1, 2; 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma matrix descriptor of a 128-byte swizzled tile at shared address
// `addr`: `lbo` and `sbo` in bytes (the leading and stride byte offsets).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 128 f32, the accumulator layout) = A·B (+ d when scale_d), A and
// B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128_k(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 192 f32) = A·B (+ d when scale_d), A M-major and B N-major
// (both transposed) in shared memory
__device__ __forceinline__ void wgmma_m64n192_t(float (&d)[96], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- dcols (B*G, P, K*Cg) = dy_b^T · W2, rounded to bf16
//
// Block (x, y): the 192 columns [192*y, 192*y + 192) of KC (inside one
// deform group) for the pixel tiles x, x + gridDim.x, ... of 128 over all
// images. W2's slice (O x 192, O <= 256) is loaded once into shared memory
// as ks x 3 boxes of 64 o x 64 n; dy streams through a ring of kDcStages
// stages of 64 o x 128 p (a box of 64 p for each consumer). Consumer c
// accumulates pixels [m0 + 64c, m0 + 64c + 64) x 192 columns over the O
// rows (one wgmma group a stage, a group left in flight), then rounds to
// bf16 into its swizzled staging tile (3 boxes of 64 p x 64 n, the layout
// the TMA store reads: 16-byte chunk j of row r at chunk j ^ (r % 8), so
// the writes of a warp are free of bank conflicts) and TMA stores it.
constexpr int kDcN = 192;
constexpr int kDcStages = 4;
constexpr int kDcMaxKs = 4;                            // O <= 256
constexpr int kDcStageBytes = 2 * kBox64;              // 128 p x 64 o
constexpr int kDcBBytes = kDcMaxKs * 3 * kBox64;       // 96 KB of W2
constexpr int kDcCBytes = 2 * 3 * kBox64;              // 2 x 64 p x 192 n
constexpr int kDcSmem =
    1024 + kDcBBytes + kDcStages * kDcStageBytes + kDcCBytes;

struct DcolsArgs {
  int P, KCg, G, ks;   // pixels, K*Cg, groups, 64-deep blocks of O
  int tiles_per_image, tiles;
};

__device__ __forceinline__ void dcols_load_tile(
    const CUtensorMap* tm_dy, uint32_t ring, uint32_t full, uint32_t empty,
    int ks, int m0, int image, int& s, uint32_t& ph) {
  for (int k = 0; k < ks; ++k) {
    mbar_wait(empty + 8 * s, ph);
    mbar_expect_tx(full + 8 * s, kDcStageBytes);
    const uint32_t st = ring + s * kDcStageBytes;
    tma_load_3d(st, tm_dy, m0, k * kBox, image, full + 8 * s);
    tma_load_3d(st + kBox64, tm_dy, m0 + kBox, k * kBox, image, full + 8 * s);
    if (++s == kDcStages) s = 0, ph ^= 1;
  }
}

__device__ __forceinline__ void dcols_mainloop(float (&acc)[96], uint32_t ring,
                                               uint32_t bres, uint32_t full,
                                               uint32_t empty, int ks, int c,
                                               int lane, int& s,
                                               uint32_t& ph) {
  int prev = 0;
  for (int k = 0; k < ks; ++k) {
    mbar_wait(full + 8 * s, ph);
    const uint32_t a = ring + s * kDcStageBytes + c * kBox64;
    const uint32_t b = bres + k * 3 * kBox64;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n192_t(acc, desc_sw128(a + kk * 2048, kBox64, 1024),
                      desc_sw128(b + kk * 2048, kBox64, 1024), k | kk);
    wgmma_commit();
    if (k > 0) {   // the group before this one has read its stage
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      __syncwarp();
    }
    prev = s;
    if (++s == kDcStages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(empty + 8 * prev);
}

__global__ void __launch_bounds__(kThreads, 1) deform_bwd_gemm_wgmma_dcols(
    const __grid_constant__ CUtensorMap tm_dy,
    const __grid_constant__ CUtensorMap tm_w2,
    const __grid_constant__ CUtensorMap tm_dcols, const DcolsArgs p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kDcStages + 1];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bres = base, ring = base + kDcBBytes;
  const uint32_t stage_c = ring + kDcStages * kDcStageBytes;
  const uint32_t full = smem_u32(bars), empty = full + 8 * kDcStages;
  const uint32_t bfull = empty + 8 * kDcStages;
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.y * kDcN, g = n0 / p.KCg, r0 = n0 - g * p.KCg;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDcStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_init(bfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      mbar_expect_tx(bfull, p.ks * 3 * kBox64);
      for (int k = 0; k < p.ks; ++k)
        for (int j = 0; j < 3; ++j)
          tma_load_3d(bres + (k * 3 + j) * kBox64, &tm_w2, n0 + j * kBox,
                      k * kBox, 0, bfull);
      int s = 0;
      uint32_t ph = 1;   // a fresh empty barrier passes
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int image = tile / p.tiles_per_image;
        const int m0 = (tile - image * p.tiles_per_image) * 128;
        dcols_load_tile(&tm_dy, ring, full, empty, p.ks, m0, image, s, ph);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wgi - 1, warp = t / 32, lane = t % 32;
    const uint32_t stg = stage_c + c * 3 * kBox64;
    mbar_wait(bfull, 0);
    float acc[96];
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int image = tile / p.tiles_per_image;
      const int m0 = (tile - image * p.tiles_per_image) * 128 + c * kBox;
      dcols_mainloop(acc, ring, bres, full, empty, p.ks, c, lane, s, ph);
      // epilogue: the previous tile's stores have read the staging tile
      if (t == 0) bulk_wait_read();
      warpgroup_bar(1 + c);
#pragma unroll
      for (int j = 0; j < kDcN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          const uint32_t at = stg + (j / 8) * kBox64 + r * 128 +
                              (((j % 8) ^ (r % 8)) << 4) + (lane % 4) * 4;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at),
                       "r"(pack_bf16(acc[4 * j + 2 * h],
                                     acc[4 * j + 2 * h + 1]))
                       : "memory");
        }
      }
      fence_proxy_async();
      warpgroup_bar(1 + c);
      if (t == 0 && m0 < p.P) {
        for (int j = 0; j < 3; ++j)
          tma_store_3d(&tm_dcols, stg + j * kBox64, r0 + j * kBox, m0,
                       image * p.G + g);
        bulk_commit();
      }
      __syncwarp();   // whole warps into the next tile's wgmma
    }
    if (t == 0) bulk_wait();
  }
}

// -- dW2 partials (B*splits, O, KC) f32: partial[image*splits + split] =
// dy_b[:, chunk] · cols_b[:, chunk]^T over a chunk of kSplitK pixels
//
// Block tiles of 128 o x 128 n, walked persistently (tile = blockIdx.x,
// + gridDim.x, ...; o fastest, so the two o tiles of a cols tile run side
// by side and the second reads it from L2). A stage is 64 pixels deep: a
// box of 128 o x 64 p of dy and one of 128 n x 64 p of cols. Consumer c
// sums its 64 o rows x 128 n of a stage from zero (four m64n128k16), waits
// for the group and adds it into the f32 accumulator with round-to-nearest:
// the tensor cores round their sums toward zero, and along a 2048-pixel
// chain the bias grows (without this flush, every stage into the
// accumulator with a group in flight, dW2 lay up to 2.9x as far from an
// f32 product of the same operands; tools/k2_gemm_probe.py noflush). 288 threads: two consumer warpgroups
// and one producer warp (no setmaxnreg: the 64 accumulator and 64 partial
// registers a consumer thread needs fit in ptxas's 168).
constexpr int kW2Threads = 288;
constexpr int kW2M = 128;         // o rows of a block tile
constexpr int kW2N = 128;         // n columns of a block tile
constexpr int kW2Stages = 6;
constexpr int kW2ABytes = kW2M * kBox * 2;                    // 16 KB
constexpr int kW2StageBytes = kW2ABytes + kW2N * kBox * 2;
constexpr int kW2Smem = 1024 + kW2Stages * kW2StageBytes;

struct Dw2Args {
  float* partial;
  int O, KC, P, splits, k_chunk, tiles_m, tiles_n, tiles;
};

__global__ void __launch_bounds__(kW2Threads, 1) deform_bwd_gemm_wgmma_dw2(
    const __grid_constant__ CUtensorMap tm_dy,
    const __grid_constant__ CUtensorMap tm_cols, const Dw2Args p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kW2Stages];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * kW2Stages;
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kW2Stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wgi == 2) {   // the producer warp
    if (t == 0) {
      int s = 0;
      uint32_t ph = 1;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int mt = tile % p.tiles_m, rest = tile / p.tiles_m;
        const int nt = rest % p.tiles_n, z = rest / p.tiles_n;
        const int image = z / p.splits, k0 = (z % p.splits) * p.k_chunk;
        const int k1 = min(p.P, k0 + p.k_chunk);
        for (int k = k0; k < k1; k += kBox) {
          mbar_wait(empty + 8 * s, ph);
          mbar_expect_tx(full + 8 * s, kW2StageBytes);
          const uint32_t st = ring + s * kW2StageBytes;
          tma_load_3d(st, &tm_dy, k, mt * kW2M, image, full + 8 * s);
          tma_load_3d(st + kW2ABytes, &tm_cols, k, nt * kW2N, image,
                      full + 8 * s);
          if (++s == kW2Stages) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    const int c = wgi, warp = t / 32, lane = t % 32;
    float acc[64], part[64];
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int mt = tile % p.tiles_m, rest = tile / p.tiles_m;
      const int nt = rest % p.tiles_n, z = rest / p.tiles_n;
      const int k0 = (z % p.splits) * p.k_chunk;
      const int k1 = min(p.P, k0 + p.k_chunk);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int k = k0; k < k1; k += kBox) {
        mbar_wait(full + 8 * s, ph);
        const uint32_t a = ring + s * kW2StageBytes + c * kBox * 128;
        const uint32_t b = ring + s * kW2StageBytes + kW2ABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128_k(part, desc_sw128(a + kk * 32, 16, 1024),
                          desc_sw128(b + kk * 32, 16, 1024), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        if (lane == 0) mbar_arrive(empty + 8 * s);
        __syncwarp();   // wgmma's .aligned instructions want whole warps
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        if (++s == kW2Stages) s = 0, ph ^= 1;
      }
      // thread (warp, lane) holds rows 16*warp + lane/4 (+ 8) and columns
      // 8j + 2*(lane % 4) (+ 1) of its 64 x 128
      float* C = p.partial + (int64_t)z * p.O * p.KC;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = nt * kW2N + 8 * j + 2 * (lane % 4);
        if (n >= p.KC) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = mt * kW2M + c * 64 + warp * 16 + lane / 4 + 8 * h;
          if (o < p.O)
            *reinterpret_cast<float2*>(C + (int64_t)o * p.KC + n) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// -- host side: tensor maps, the route, the launches

// The map of a contiguous bf16 tensor of dims (d0 contiguous, d1, d2) read
// or written in 128-byte swizzled boxes of (64, box1, 1), zero outside.
bool map_bf16(CUtensorMap* m, const void* ptr, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

// How a bf16 backward's GEMMs run, by shape (conv_bwd also sends views
// that are not 16-byte aligned, which the allocator never gives, to kMma):
//   kMma     the mma.sync GEMMs: a dcols block of 192 columns would straddle
//            a group (K*Cg not a multiple of 192), W2's slice (O rows) would
//            not fit in shared memory (O > 256), or KC % 8 != 0;
//   kWgmma   the wgmma GEMMs on dy and cols as they are (TMA needs 16-byte
//            row strides: P % 8 == 0);
//   kPadded  P % 8 != 0 (800x1344: P5-P7, P = 1050, 273, 77; HRFPN's 12x21,
//            6x10): dy and cols are first copied into rows of P rounded up
//            to 8, zero-filled, in the caller's scratch (pad_rows_kernel),
//            and the wgmma GEMMs read those.
enum Route { kMma = 0, kWgmma = 1, kPadded = 2 };

int route(int P, int KC, int KCg, int O) {
  if (KC % 8 != 0 || KCg % kDcN != 0 || O > kDcMaxKs * kBox) return kMma;
  return P % 8 == 0 ? kWgmma : kPadded;
}

// Floats of the caller's scratch before the padded copies: the dW2
// partials, rounded up to 64 (256 bytes).
int64_t partial_floats(int B, int O, int KC, int P) {
  const int64_t splits = (P + kSplitK - 1) / kSplitK;
  return ((int64_t)B * splits * O * KC + 63) / 64 * 64;
}

// bf16 elements of a padded copy of `rows` rows of P: rows of P rounded up
// to 8, the whole rounded up to 128 (256 bytes)
int64_t padded_elems(int64_t rows, int P) {
  return (rows * ((P + 7) / 8 * 8) + 127) / 128 * 128;
}

// out (rows, P8) = in (rows, P) and zeros after, for two tensors in one
// launch (rows_a of a, then rows_b of b); a thread writes 8 elements (16
// bytes), P8 = P rounded up to 8.
__global__ void __launch_bounds__(256) pad_rows_kernel(
    const uint16_t* __restrict__ a, uint16_t* __restrict__ a_out,
    int64_t rows_a, const uint16_t* __restrict__ b,
    uint16_t* __restrict__ b_out, int64_t rows_b, int P) {
  const int P8 = (P + 7) / 8 * 8, per_row = P8 / 8;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (rows_a + rows_b) * per_row) return;
  int64_t row = i / per_row;
  const int p0 = (int)(i - row * per_row) * 8;
  const uint16_t* in = a;
  uint16_t* out = a_out;
  if (row >= rows_a) row -= rows_a, in = b, out = b_out;
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = p0 + 2 * e;
    const uint32_t lo = q < P ? in[row * P + q] : 0u;
    const uint32_t hi = q + 1 < P ? in[row * P + q + 1] : 0u;
    v[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(out + row * P8 + p0) =
      make_uint4(v[0], v[1], v[2], v[3]);
}

// The wgmma GEMMs. dy (B, O, ld) and cols (B, KC, ld) hold P pixels a row
// (ld = P, or P rounded up to 8 with zeros after P).
cudaError_t launch_wgmma_gemms(const bf16* dy, const bf16* w2,
                               const bf16* cols, bf16* dcols, float* partial,
                               int B, int G, int P, int ld, int KCg, int O,
                               int splits, cudaStream_t st) {
  const int KC = G * KCg;
  CUtensorMap m_dy64, m_w2, m_dcols, m_dy128, m_cols;
  if (!map_bf16(&m_dy64, dy, ld, O, B, kBox) ||
      !map_bf16(&m_w2, w2, KC, O, 1, kBox) ||
      !map_bf16(&m_dcols, dcols, KCg, P, (uint64_t)B * G, kBox) ||
      !map_bf16(&m_dy128, dy, ld, O, B, kW2M) ||
      !map_bf16(&m_cols, cols, ld, KC, B, kW2N))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  cudaError_t err = cudaFuncSetAttribute(
      deform_bwd_gemm_wgmma_dcols, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDcSmem);
  if (err != cudaSuccess) return err;
  {
    DcolsArgs a{};
    a.P = P, a.KCg = KCg, a.G = G, a.ks = (O + kBox - 1) / kBox;
    a.tiles_per_image = (P + 127) / 128;
    a.tiles = B * a.tiles_per_image;
    const int n_tiles = KC / kDcN;
    const int per_n = std::max(1, std::min(a.tiles, sms / n_tiles));
    deform_bwd_gemm_wgmma_dcols<<<dim3(per_n, n_tiles), kThreads, kDcSmem,
                                  st>>>(m_dy64, m_w2, m_dcols, a);
    if ((err = cudaGetLastError())) return err;
  }
  auto dw2_kernel = deform_bwd_gemm_wgmma_dw2;
  err = cudaFuncSetAttribute(
      dw2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kW2Smem);
  if (err != cudaSuccess) return err;
  Dw2Args a{};
  a.partial = partial;
  a.O = O, a.KC = KC, a.P = P, a.splits = splits, a.k_chunk = kSplitK;
  a.tiles_m = (O + kW2M - 1) / kW2M;
  a.tiles_n = (KC + kW2N - 1) / kW2N;
  a.tiles = B * splits * a.tiles_m * a.tiles_n;
  dw2_kernel<<<std::min(a.tiles, sms), kW2Threads, kW2Smem, st>>>(
      m_dy128, m_cols, a);
  return cudaGetLastError();
}

}  // namespace wg

// ---- fold, transpose, scatter

// out[i] = sum over z < nz of partial[z*n + i], in order.
__global__ void fold_partials_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int64_t n,
                                     int nz) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < nz; ++z) acc += partial[z * n + i];
    out[i] = acc;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// out[z] (S, R) = in[z] (R, S) transposed, through a 32x33 shared tile of
// f32, converted from In and to Out (bf16 rounded to nearest even); zero,
// when not null, an f32 array shaped like out, gets 0 wherever out is
// written. grid (ceil(S/32), ceil(R/32), nz), block (32, 8).
template <typename In, typename Out>
__global__ void deform_bwd_transpose_kernel(const In* __restrict__ in,
                                            Out* __restrict__ out,
                                            float* __restrict__ zero, int R,
                                            int S) {
  __shared__ float tile[32][33];
  const int64_t base = (int64_t)blockIdx.z * R * S;
  const int s0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, s = s0 + threadIdx.x;
    if (r < R && s < S)
      tile[i][threadIdx.x] = to_f32(in[base + (int64_t)r * S + s]);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int s = s0 + i, r = r0 + threadIdx.x;
    if (s < S && r < R) {
      store_out(out + base + (int64_t)s * R + r, tile[threadIdx.x][i]);
      if (zero != nullptr) zero[base + (int64_t)s * R + r] = 0.f;
    }
  }
}

// A lane's VEC channels of element type E (f32 or bf16): the register
// type T, channel i in f32, and the add of d * w into an f32 row (dX's
// sums are f32 for either E: no bf16 atomics).
template <typename E, int VEC>
struct Lanes;
template <>
struct Lanes<float, 1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void add(float* dst, const T& d, float w) {
    atomicAdd(dst, d * w);
  }
};
template <>
struct Lanes<float, 2> {
  using T = float2;
  __device__ static float get(const T& v, int i) { return i ? v.y : v.x; }
  __device__ static void add(float* dst, const T& d, float w) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(d.x * w, d.y * w));
  }
};
template <>
struct Lanes<bf16, 1> {
  using T = bf16;
  __device__ static float get(const T& v, int) { return __bfloat162float(v); }
  __device__ static void add(float* dst, const T& d, float w) {
    atomicAdd(dst, __bfloat162float(d) * w);
  }
};
template <>
struct Lanes<bf16, 2> {
  using T = __nv_bfloat162;
  __device__ static float get(const T& v, int i) {
    return __bfloat162float(i ? v.y : v.x);
  }
  __device__ static void add(float* dst, const T& d, float w) {
    atomicAdd(reinterpret_cast<float2*>(dst),
              make_float2(get(d, 0) * w, get(d, 1) * w));
  }
};

// grid (ceil(N*P / 8)): one warp per (n, p), n = image*G + group, over the
// K taps; lanes along the Cg channels, VEC (1 or 2) each. dcols (N, P, K,
// Cg) p-major and x_rows (N, H*W, Cg) channels-last, of element type E;
// dx_rows (N, H*W, Cg) f32, zeroed by the caller; offsets and doffsets
// (B, G*K*2, Ho, Wo) f32.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads) deform_col2im_kernel(
    const E* __restrict__ x_rows, const float* __restrict__ offsets,
    const E* __restrict__ dcols, float* __restrict__ dx_rows,
    float* __restrict__ doffsets, int N, int H, int W, int Cg, int Ho, int Wo,
    int kh, int kw, int stride, int pad, int dil) {
  using L = Lanes<E, VEC>;
  using T = typename L::T;
  const int P = Ho * Wo;
  const int64_t item = (int64_t)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5);
  if (item >= (int64_t)N * P) return;
  const int lane = threadIdx.x & 31;
  const int n = (int)(item / P);
  const int p = (int)(item - (int64_t)n * P);
  const int ho = p / Wo, wo = p - (p / Wo) * Wo;
  const int K = kh * kw;
  const int cv = Cg / VEC;   // vectors per row
  const int64_t rows = (int64_t)n * H * W;
  const T* xn = reinterpret_cast<const T*>(x_rows) + rows * cv;
  float* dxn = dx_rows + rows * Cg;
  const T* drow = reinterpret_cast<const T*>(dcols) + item * K * cv;
  const T zero{};
  for (int tap = 0; tap < K; ++tap) {
    const int i = tap / kw, j = tap - (tap / kw) * kw;
    const int64_t off_row = ((int64_t)n * K * 2 + 2 * tap) * P + p;
    const float py = (float)(ho * stride - pad + i * dil) + offsets[off_row];
    const float px =
        (float)(wo * stride - pad + j * dil) + offsets[off_row + P];
    const Corners c = corners(py, px, H, W);
    float gy = 0.f, gx = 0.f;
    for (int v = lane; v < cv; v += 32) {
      const T d = drow[tap * cv + v];
      const T a00 = c.v00 ? xn[c.q00 * cv + v] : zero;
      const T a01 = c.v01 ? xn[c.q01 * cv + v] : zero;
      const T a10 = c.v10 ? xn[c.q10 * cv + v] : zero;
      const T a11 = c.v11 ? xn[c.q11 * cv + v] : zero;
      if (c.v00) L::add(dxn + c.q00 * Cg + v * VEC, d, c.w00);
      if (c.v01) L::add(dxn + c.q01 * Cg + v * VEC, d, c.w01);
      if (c.v10) L::add(dxn + c.q10 * Cg + v * VEC, d, c.w10);
      if (c.v11) L::add(dxn + c.q11 * Cg + v * VEC, d, c.w11);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float de = L::get(d, e);
        const float b00 = L::get(a00, e), b01 = L::get(a01, e);
        const float b10 = L::get(a10, e), b11 = L::get(a11, e);
        gy += de * ((b10 - b00) * c.hx + (b11 - b01) * c.lx);
        gx += de * ((b01 - b00) * c.hy + (b11 - b10) * c.ly);
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      gy += __shfl_xor_sync(0xffffffffu, gy, s);
      gx += __shfl_xor_sync(0xffffffffu, gx, s);
    }
    if (lane == 0) {
      doffsets[off_row] = gy;
      doffsets[off_row + P] = gx;
    }
  }
}

// The bf16 scatter for Cg % 4 == 0. grid (ceil(N*P*K / 16)): a half-warp
// per (n, p, tap), in that order (the two taps of a warp are neighbours in
// dcols), lanes along the Cg channels four each; dcols (N, P, K, Cg) and
// x_rows (N, H*W, Cg) bf16, 8-byte aligned rows; dx_rows (N, H*W, Cg) f32,
// 16-byte aligned, zeroed by the caller; offsets and doffsets as above.
__global__ void __launch_bounds__(kThreads) deform_col2im_bf16x4_kernel(
    const bf16* __restrict__ x_rows, const float* __restrict__ offsets,
    const bf16* __restrict__ dcols, float* __restrict__ dx_rows,
    float* __restrict__ doffsets, int N, int H, int W, int Cg, int Ho,
    int Wo, int kh, int kw, int stride, int pad, int dil) {
  const int P = Ho * Wo, K = kh * kw;
  const int64_t item = (int64_t)blockIdx.x * (kThreads / 16) +
                       (threadIdx.x >> 4);
  if (item >= (int64_t)N * P * K) return;
  const int sub = threadIdx.x & 15;
  const int64_t np = item / K;
  const int tap = (int)(item - np * K);
  const int n = (int)(np / P);
  const int p = (int)(np - (int64_t)n * P);
  const int ho = p / Wo, wo = p - (p / Wo) * Wo;
  const int i = tap / kw, j = tap - (tap / kw) * kw;
  const int64_t off_row = ((int64_t)n * K * 2 + 2 * tap) * P + p;
  const float py = (float)(ho * stride - pad + i * dil) + offsets[off_row];
  const float px = (float)(wo * stride - pad + j * dil) + offsets[off_row + P];
  const Corners c = corners(py, px, H, W);
  const int cv = Cg / 4;   // vectors of 4 per row
  const int64_t rows = (int64_t)n * H * W;
  const float2 g = dcn::scatter_bf16x4<16>(
      reinterpret_cast<const uint2*>(x_rows) + rows * cv,
      reinterpret_cast<float4*>(dx_rows) + rows * cv,
      reinterpret_cast<const uint2*>(dcols) + item * cv, c, cv, sub);
  if (sub == 0) {
    doffsets[off_row] = g.x;
    doffsets[off_row + P] = g.y;
  }
}

template <typename In, typename Out>
cudaError_t transpose(const In* in, Out* out, int nz, int R, int S,
                      cudaStream_t st, float* zero = nullptr) {
  const dim3 grid((S + 31) / 32, (R + 31) / 32, nz);
  deform_bwd_transpose_kernel<In, Out><<<grid, dim3(32, 8), 0, st>>>(
      in, out, zero, R, S);
  return cudaGetLastError();
}

// After the GEMMs: the fold of the dW2 partials, the scatter and the
// transpose of dX rows to dX.
template <typename E>
int finish(const E* x_rows, const float* offsets, const E* dcols,
           const float* partial, float* dx_rows, E* dx, float* doffsets,
           float* dw2, int B, int C, int H, int W, int G, int Ho, int Wo,
           int kh, int kw, int stride, int pad, int dil, int O, int splits,
           cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<E, bf16>::value;
  const int K = kh * kw, Cg = C / G, P = Ho * Wo, HW = H * W;
  cudaError_t err;
  {
    const int64_t n = (int64_t)O * G * K * Cg;
    const int blocks = (int)((n + kThreads - 1) / kThreads);
    fold_partials_kernel<<<blocks, kThreads, 0, st>>>(partial, dw2, n,
                                                      B * splits);
    if ((err = cudaGetLastError())) return (int)err;
  }
  {
    const int64_t items = (int64_t)B * G * P;
    const unsigned blocks = (unsigned)((items + 7) / 8);
    if (kBf16 && Cg % 4 == 0)
      deform_col2im_bf16x4_kernel<<<(unsigned)((items * K + 15) / 16),
                                    kThreads, 0, st>>>(
          reinterpret_cast<const bf16*>(x_rows), offsets,
          reinterpret_cast<const bf16*>(dcols), dx_rows, doffsets, B * G, H,
          W, Cg, Ho, Wo, kh, kw, stride, pad, dil);
    else if (Cg % 2 == 0)
      deform_col2im_kernel<E, 2><<<blocks, kThreads, 0, st>>>(
          x_rows, offsets, dcols, dx_rows, doffsets, B * G, H, W, Cg, Ho, Wo,
          kh, kw, stride, pad, dil);
    else
      deform_col2im_kernel<E, 1><<<blocks, kThreads, 0, st>>>(
          x_rows, offsets, dcols, dx_rows, doffsets, B * G, H, W, Cg, Ho, Wo,
          kh, kw, stride, pad, dil);
    if ((err = cudaGetLastError())) return (int)err;
  }
  // dx_rows (B*G, HW, Cg) -> dx (B*G, Cg, HW)
  return (int)transpose((const float*)dx_rows, dx, B * G, HW, Cg, st);
}

// The whole backward for operands of element type E (f32: 3xTF32 GEMMs;
// bf16: bf16 GEMMs, dcols rounded to bf16, dX summed in f32 and rounded
// once to bf16 in the last transpose). Offsets, d offsets, the dW2
// partials and dw2 are f32 either way; dx_rows is f32 scratch.
template <typename E>
int conv_bwd(const E* x, const float* offsets, const E* cols, const E* w2,
             const E* dy, E* x_rows, E* dcols, float* partial,
             float* dx_rows, E* dx, float* doffsets, float* dw2, int B,
             int C, int H, int W, int G, int Ho, int Wo, int kh, int kw,
             int stride, int pad, int dil, int O, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<E, bf16>::value;
  const int K = kh * kw;
  const int Cg = C / G;
  const int KC = G * K * Cg;
  const int P = Ho * Wo;
  const int HW = H * W;
  cudaError_t err;
  // x (B*G, Cg, HW) -> x_rows (B*G, HW, Cg); dX rows start at zero (in
  // bf16 zeroed by the transpose)
  if constexpr (kBf16) {
    if ((err = transpose(x, x_rows, B * G, Cg, HW, st, dx_rows)))
      return (int)err;
  } else {
    if ((err = transpose(x, x_rows, B * G, Cg, HW, st))) return (int)err;
    if ((err = cudaMemsetAsync(dx_rows, 0, sizeof(float) * B * C * HW, st)))
      return (int)err;
  }
  const int splits = (P + kSplitK - 1) / kSplitK;
  if constexpr (kBf16) {
    int r = wg::route(P, KC, K * Cg, O);
    // TMA reads 16-byte aligned tensors: a view that is not takes mma.sync
    if (!wg::aligned16(w2) || !wg::aligned16(dcols) ||
        (r == wg::kWgmma && (!wg::aligned16(dy) || !wg::aligned16(cols))))
      r = wg::kMma;
    if (r != wg::kMma) {
      const bf16 *dy_g = dy, *cols_g = cols;
      int ld = P;
      if (r == wg::kPadded) {   // row-padded copies after the partials
        bf16* dy_p = reinterpret_cast<bf16*>(
            partial + wg::partial_floats(B, O, KC, P));
        bf16* cols_p = dy_p + wg::padded_elems((int64_t)B * O, P);
        const int64_t rows_a = (int64_t)B * O, rows_b = (int64_t)B * KC;
        const int64_t n = (rows_a + rows_b) * ((P + 7) / 8);
        wg::pad_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
            reinterpret_cast<const uint16_t*>(dy),
            reinterpret_cast<uint16_t*>(dy_p), rows_a,
            reinterpret_cast<const uint16_t*>(cols),
            reinterpret_cast<uint16_t*>(cols_p), rows_b, P);
        if ((err = cudaGetLastError())) return (int)err;
        dy_g = dy_p, cols_g = cols_p, ld = (P + 7) / 8 * 8;
      }
      if ((err = wg::launch_wgmma_gemms(dy_g, w2, cols_g, dcols, partial, B,
                                        G, P, ld, K * Cg, O, splits, st)))
        return (int)err;
      return finish(x_rows, offsets, dcols, partial, dx_rows, dx, doffsets,
                    dw2, B, C, H, W, G, Ho, Wo, kh, kw, stride, pad, dil, O,
                    splits, st);
    }
  }
  // 16-byte copies: 4 f32 or 8 bf16 along each contiguous axis
  constexpr int kVec = 16 / sizeof(E);
  const int vec = P % kVec == 0 && KC % kVec == 0 && wg::aligned16(dy) &&
                  wg::aligned16(cols) && wg::aligned16(w2);
  // dcols_b^T (P, KC) = dy_b^T · W2: A(m=p, k=o) = dy_b[o*P + p] and
  // B(k=o, n) = W2[o*KC + n], both M/N-major; column n = g*K*Cg + r goes to
  // dcols[((b*G + g)*P + p)*K*Cg + r]
  {
    GemmArgsT<E, E> a{};
    a.A = dy;
    a.B = w2;
    a.C = dcols;
    a.M = P, a.N = KC, a.K = O, a.lda = P, a.ldb = KC;
    a.strideA = (int64_t)O * P, a.strideB = 0;
    a.splits = 1, a.k_chunk = O;
    a.strideC = (int64_t)KC * P, a.group_stride = (int64_t)P * K * Cg;
    a.ldc = K * Cg, a.n_group = K * Cg;
    a.vec = vec;
    if constexpr (kBf16)
      err = launch_gemm_bf16<false, false>(a, B, st);
    else
      err = launch_gemm<false, false>(a, B, st);
    if (err) return (int)err;
  }
  // dW2 partials (O, KC) per (image, chunk): A(m=o, k=p) = dy_b[o*P + p],
  // B(k=p, n) = cols_b[n*P + p], both K-major
  {
    GemmArgsT<E, float> a{};
    a.A = dy;
    a.B = cols;
    a.C = partial;
    a.M = O, a.N = KC, a.K = P, a.lda = P, a.ldb = P;
    a.strideA = (int64_t)O * P, a.strideB = (int64_t)KC * P;
    a.splits = splits, a.k_chunk = kSplitK;
    a.strideC = (int64_t)O * KC, a.group_stride = 0;
    a.ldc = KC, a.n_group = KC;
    a.vec = vec;
    if constexpr (kBf16)
      err = launch_gemm_bf16<true, true>(a, B, st);
    else
      err = launch_gemm<true, true>(a, B, st);
    if (err) return (int)err;
  }
  return finish(x_rows, offsets, dcols, partial, dx_rows, dx, doffsets, dw2,
                B, C, H, W, G, Ho, Wo, kh, kw, stride, pad, dil, O, splits,
                st);
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates (16-byte aligned) for a call
// with C = G*Cg channels and K taps: the dW2 partials and, for a bf16 call
// whose GEMMs take the padded route, row-padded copies of dy and cols.
long long deform_conv_bwd_scratch_floats(int B, int O, int G, int K, int Cg,
                                         int P, int bf16) {
  const int KC = G * K * Cg;
  const int64_t partials = wg::partial_floats(B, O, KC, P);
  if (!bf16 || wg::route(P, KC, K * Cg, O) != wg::kPadded) return partials;
  return partials + (wg::padded_elems((int64_t)B * O, P) +
                     wg::padded_elems((int64_t)B * KC, P)) / 2;
}

// x (B, C, H, W), offsets (B, G*K*2, Ho, Wo), cols (B, KC, P), w2 (O, KC),
// dy (B, O, P), all contiguous f32. Scratch from the caller: x_rows and
// dx_rows (B*C*H*W floats each), dcols (B*KC*P), partial
// (deform_conv_bwd_scratch_floats). Writes dx (B, C, H, W), doffsets (like
// offsets) and dw2 (O, KC). Returns the cudaError_t of the first failed
// launch (0 on success).
int deform_conv_bwd_f32(const void* x, const void* offsets, const void* cols,
                        const void* w2, const void* dy, void* x_rows,
                        void* dcols, void* partial, void* dx_rows, void* dx,
                        void* doffsets, void* dw2, int B, int C, int H, int W,
                        int G, int Ho, int Wo, int kh, int kw, int stride,
                        int pad, int dil, int O, void* stream) {
  return conv_bwd<float>(
      (const float*)x, (const float*)offsets, (const float*)cols,
      (const float*)w2, (const float*)dy, (float*)x_rows, (float*)dcols,
      (float*)partial, (float*)dx_rows, (float*)dx, (float*)doffsets,
      (float*)dw2, B, C, H, W, G, Ho, Wo, kh, kw, stride, pad, dil, O,
      (cudaStream_t)stream);
}

// The same with x, cols, w2, dy, x_rows, dcols and dx bf16; offsets,
// doffsets, partial, dx_rows (B*C*H*W floats) and dw2 f32.
int deform_conv_bwd_bf16(const void* x, const void* offsets,
                         const void* cols, const void* w2, const void* dy,
                         void* x_rows, void* dcols, void* partial,
                         void* dx_rows, void* dx, void* doffsets, void* dw2,
                         int B, int C, int H, int W, int G, int Ho, int Wo,
                         int kh, int kw, int stride, int pad, int dil, int O,
                         void* stream) {
  return conv_bwd<bf16>(
      (const bf16*)x, (const float*)offsets, (const bf16*)cols,
      (const bf16*)w2, (const bf16*)dy, (bf16*)x_rows, (bf16*)dcols,
      (float*)partial, (float*)dx_rows, (bf16*)dx, (float*)doffsets,
      (float*)dw2, B, C, H, W, G, Ho, Wo, kh, kw, stride, pad, dil, O,
      (cudaStream_t)stream);
}

const char* deform_col2im_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
