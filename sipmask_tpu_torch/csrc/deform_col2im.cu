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
//                            written p-major per group        3xTF32
//   dW2    (O, KC)         = sum_b dy_b (O, P) · cols_b^T   GEMM, split over
//                            (image, 2048-pixel chunk) into   3xTF32
//                            partials, then a fold in order
//   dX rows, d offsets     from dcols                        scatter
//   dX (B, C, H, W)        = dX rows transposed              transpose
//
// with KC = G*K*Cg rows of cols in deform_im2col.cu's order (g*K*Cg +
// tap*Cg + c), O output channels, P = Ho*Wo.
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
// What bounds it on an H100: operations. The two GEMMs are 2*KC*O*P flops
// per image each (79 GFLOP each at the P3 level of an 800x1344 image, batch
// 4), and must keep f32 accuracy. On the CUDA cores (67 TFLOP/s by the
// H100 SXM data sheet) they were the bound, and SIMT SGEMMs took 61% of the
// time at 22 TFLOP/s (NVIDIA H100 80GB HBM3, 700 W). The design moves them
// onto the tensor cores in 3xTF32: each operand is split into
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
// What bounds the GEMMs now is mma.sync itself: with a third of the
// products they run about twice as fast (tools/k2_gemm_probe.py), and
// mma.sync reaches about a third of the TF32 rate that wgmma can. wgmma
// takes B only from shared memory, and 3xTF32 reads it three times a k8
// step in each warpgroup: a stage's shared-memory traffic then matches its
// tensor time, and wgmma versions of this loop ran no faster.
// The scatter was the other 38% (same card): one thread per (image, group,
// tap, pixel) added each channel's value into NCHW dX with scalar atomics
// whose addresses lay a plane apart from channel to channel. Now dcols is
// p-major per group, x and dX are channels-last rows, and one warp takes
// one (image, group, pixel) and its K taps with its lanes along the Cg
// channels (two each, Cg even): every corner read and every atomic of a
// warp is one contiguous run of Cg floats (float2 atomics), and d position
// is reduced across the warp with shuffles (no atomics). dX's atomics are
// the only sums whose order changes from run to run.

#include <cuda_runtime.h>

#include <cstdint>

#include "deform_corners.cuh"

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

struct GemmArgs {
  const float* A;
  const float* B;
  float* C;
  int M, N, K, lda, ldb;
  int64_t strideA, strideB;  // per image
  int splits, k_chunk;       // z = image * splits + split
  // C(m, n) of z lies at C[z*strideC + (n / n_group)*group_stride
  //                        + m*ldc + n % n_group]
  int64_t strideC, group_stride;
  int ldc, n_group;
  int vec;                   // 16-byte copies (see load_tile)
};

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

// out[z] (S, R) = in[z] (R, S) transposed, through a 32x33 shared tile.
// grid (ceil(S/32), ceil(R/32), nz), block (32, 8).
__global__ void deform_bwd_transpose_kernel(const float* __restrict__ in,
                                            float* __restrict__ out, int R,
                                            int S) {
  __shared__ float tile[32][33];
  const int64_t base = (int64_t)blockIdx.z * R * S;
  const int s0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, s = s0 + threadIdx.x;
    if (r < R && s < S) tile[i][threadIdx.x] = in[base + (int64_t)r * S + s];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int s = s0 + i, r = r0 + threadIdx.x;
    if (s < S && r < R) out[base + (int64_t)s * R + r] = tile[threadIdx.x][i];
  }
}

template <int VEC>
struct Lanes;
template <>
struct Lanes<1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void add(float* dst, const T& d, float w) {
    atomicAdd(dst, d * w);
  }
};
template <>
struct Lanes<2> {
  using T = float2;
  __device__ static float get(const T& v, int i) { return i ? v.y : v.x; }
  __device__ static void add(float* dst, const T& d, float w) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(d.x * w, d.y * w));
  }
};

// grid (ceil(N*P / 8)): one warp per (n, p), n = image*G + group, over the
// K taps; lanes along the Cg channels, VEC (1 or 2) each. dcols (N, P, K,
// Cg) p-major, x_rows and dx_rows (N, H*W, Cg) channels-last (dx_rows
// zeroed by the caller), offsets and doffsets (B, G*K*2, Ho, Wo).
template <int VEC>
__global__ void __launch_bounds__(kThreads) deform_col2im_kernel(
    const float* __restrict__ x_rows, const float* __restrict__ offsets,
    const float* __restrict__ dcols, float* __restrict__ dx_rows,
    float* __restrict__ doffsets, int N, int H, int W, int Cg, int Ho, int Wo,
    int kh, int kw, int stride, int pad, int dil) {
  using L = Lanes<VEC>;
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

cudaError_t transpose(const float* in, float* out, int nz, int R, int S,
                      cudaStream_t st) {
  const dim3 grid((S + 31) / 32, (R + 31) / 32, nz);
  deform_bwd_transpose_kernel<<<grid, dim3(32, 8), 0, st>>>(in, out, R, S);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for the dW2 partials.
long long deform_conv_bwd_partial_floats(int B, int O, int KC, int P) {
  const long long splits = (P + kSplitK - 1) / kSplitK;
  return (long long)B * splits * O * KC;
}

// x (B, C, H, W), offsets (B, G*K*2, Ho, Wo), cols (B, KC, P), w2 (O, KC),
// dy (B, O, P), all contiguous f32. Scratch from the caller: x_rows and
// dx_rows (B*C*H*W floats each), dcols (B*KC*P), partial
// (deform_conv_bwd_partial_floats). Writes dx (B, C, H, W), doffsets (like
// offsets) and dw2 (O, KC). Returns the cudaError_t of the first failed
// launch (0 on success).
int deform_conv_bwd_f32(const void* x, const void* offsets, const void* cols,
                        const void* w2, const void* dy, void* x_rows,
                        void* dcols, void* partial, void* dx_rows, void* dx,
                        void* doffsets, void* dw2, int B, int C, int H, int W,
                        int G, int Ho, int Wo, int kh, int kw, int stride,
                        int pad, int dil, int O, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int K = kh * kw;
  const int Cg = C / G;
  const int KC = G * K * Cg;
  const int P = Ho * Wo;
  const int HW = H * W;
  cudaError_t err;
  // x (B*G, Cg, HW) -> x_rows (B*G, HW, Cg); dX rows start at zero
  if ((err = transpose((const float*)x, (float*)x_rows, B * G, Cg, HW, st)))
    return (int)err;
  if ((err = cudaMemsetAsync(dx_rows, 0, sizeof(float) * B * C * HW, st)))
    return (int)err;
  const int vec = P % 4 == 0 && KC % 4 == 0 && aligned16(dy) &&
                  aligned16(cols) && aligned16(w2);
  // dcols_b^T (P, KC) = dy_b^T · W2: A(m=p, k=o) = dy_b[o*P + p] and
  // B(k=o, n) = W2[o*KC + n], both M/N-major; column n = g*K*Cg + r goes to
  // dcols[((b*G + g)*P + p)*K*Cg + r]
  {
    GemmArgs a{};
    a.A = (const float*)dy;
    a.B = (const float*)w2;
    a.C = (float*)dcols;
    a.M = P, a.N = KC, a.K = O, a.lda = P, a.ldb = KC;
    a.strideA = (int64_t)O * P, a.strideB = 0;
    a.splits = 1, a.k_chunk = O;
    a.strideC = (int64_t)KC * P, a.group_stride = (int64_t)P * K * Cg;
    a.ldc = K * Cg, a.n_group = K * Cg;
    a.vec = vec;
    if ((err = launch_gemm<false, false>(a, B, st))) return (int)err;
  }
  // dW2 partials (O, KC) per (image, chunk): A(m=o, k=p) = dy_b[o*P + p],
  // B(k=p, n) = cols_b[n*P + p], both K-major
  const int splits = (P + kSplitK - 1) / kSplitK;
  {
    GemmArgs a{};
    a.A = (const float*)dy;
    a.B = (const float*)cols;
    a.C = (float*)partial;
    a.M = O, a.N = KC, a.K = P, a.lda = P, a.ldb = P;
    a.strideA = (int64_t)O * P, a.strideB = (int64_t)KC * P;
    a.splits = splits, a.k_chunk = kSplitK;
    a.strideC = (int64_t)O * KC, a.group_stride = 0;
    a.ldc = KC, a.n_group = KC;
    a.vec = vec;
    if ((err = launch_gemm<true, true>(a, B, st))) return (int)err;
  }
  {
    const int64_t n = (int64_t)O * KC;
    const int blocks = (int)((n + kThreads - 1) / kThreads);
    fold_partials_kernel<<<blocks, kThreads, 0, st>>>(
        (const float*)partial, (float*)dw2, n, B * splits);
    if ((err = cudaGetLastError())) return (int)err;
  }
  {
    const int64_t items = (int64_t)B * G * P;
    const unsigned blocks = (unsigned)((items + 7) / 8);
    if (Cg % 2 == 0)
      deform_col2im_kernel<2><<<blocks, kThreads, 0, st>>>(
          (const float*)x_rows, (const float*)offsets, (const float*)dcols,
          (float*)dx_rows, (float*)doffsets, B * G, H, W, Cg, Ho, Wo, kh, kw,
          stride, pad, dil);
    else
      deform_col2im_kernel<1><<<blocks, kThreads, 0, st>>>(
          (const float*)x_rows, (const float*)offsets, (const float*)dcols,
          (float*)dx_rows, (float*)doffsets, B * G, H, W, Cg, Ho, Wo, kh, kw,
          stride, pad, dil);
    if ((err = cudaGetLastError())) return (int)err;
  }
  // dx_rows (B*G, HW, Cg) -> dx (B*G, Cg, HW)
  return (int)transpose((const float*)dx_rows, (float*)dx, B * G, HW, Cg, st);
}

const char* deform_col2im_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
