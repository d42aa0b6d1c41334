// Deformable convolution backward for FeatureAlign's deformable convolution.
//
// Replaces the TPU kernel sipmask_tpu/ops/pallas/deform_gather.py:
// _deform_bwd_pallas (:878, body _bwd_conv_kernel :807), which computes the
// whole backward of out = W2 @ cols in one banded pass: dsamp = dy·W^T,
// dW = samp^T·dy, dX by col2im, and d positions. Here the same four
// products, in three kernels:
//
//   dcols (B, KC, P) = W2^T (KC, O) · dy_b (O, P)       sgemm, per image
//   dW2   (O, KC)    = sum_b dy_b (O, P) · cols_b^T      sgemm, split over
//                      (image, chunk of P) into partials, then a fold
//   dX, d offsets    from dcols                          col2im + coordinates
//
// with KC = G*K*Cg rows in the order of deform_im2col.cu's cols
// (g*K*Cg + tap*Cg + c), O output channels, P = Ho*Wo.
//
// Semantics of dX and d offsets: the autodiff of sample_ref
// (deform_gather.py:99-130), which the JAX package's CPU path takes
// (:1021-1026). Each of a sample's four corners (floor(p), floor(p)+1)
// contributes only when it lies in the map; the derivative of a corner's
// weight with respect to the position is the one-sided, floor-based one of
// _dtent (:164-167): the floor corner gets -1, the other +1 (times the other
// axis's weight). It is not sign(): at integer positions, which zero
// offsets give, sign() would zero every offset gradient and the
// zero-initialised conv_offset would never train.
//
// What bounds it on an H100: the two GEMMs, 2*KC*O*P*B flops each
// (batch 4 at the P3 level of an 800x1344 image: 79 GFLOP each), run here on
// the CUDA cores in f32 (the forward contraction's precision; TF32 would
// change the numbers). They are classic shared-memory tiled SGEMMs: 128x128
// output tiles, 8-deep k steps, 8x8 outputs per thread in registers; no
// tensor cores, no TMA yet. The weight gradient reduces over B*P (67,200 at
// P3), so it is split into (image, 2048-pixel chunk) partials that a fold
// adds in a fixed order, instead of one long serial k loop in few blocks.
// The col2im kernel is bound by the scatter: one thread per (image, group,
// tap, pixel) works out its corners once (bounds tested on the float
// position before an address is formed, as in the forward) and loops over
// the group's channels, adding dcols x weight into dX with atomicAdd (the
// only nondeterministic sum here) and reducing d position in registers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8;  // sgemm tile
constexpr int kPad = 4;                        // shared-memory row padding
constexpr int kGemmThreads = 256;              // 16 x 16, 8x8 outputs each
constexpr int kSplitK = 2048;                  // pixels per dW2 partial
constexpr int kThreads = 256;

// C_z = A_z · B_z for z = batch*splits + split, where split covers
// k in [split*k_chunk, min(K, (split+1)*k_chunk)).
// A(m, k) = A_KMAJOR ? A[k*lda + m] : A[m*lda + k]
// B(k, n) = B_NMAJOR ? B[n*ldb + k] : B[k*ldb + n]
// C row-major with ldc. grid (ceil(N/kBN), ceil(M/kBM), batches*splits).
template <bool A_KMAJOR, bool B_NMAJOR>
__global__ void __launch_bounds__(kGemmThreads) sgemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, int M, int N, int K, int lda, int ldb, int ldc,
    int64_t strideA, int64_t strideB, int64_t strideC, int splits,
    int k_chunk) {
  const int z = blockIdx.z;
  const int batch = z / splits, split = z - batch * splits;
  A += batch * strideA;
  B += batch * strideB;
  C += z * strideC;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  __shared__ float As[kBK][kBM + kPad];
  __shared__ float Bs[kBK][kBN + kPad];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kGemmThreads; ++r) {
      const int idx = tid + r * kGemmThreads;
      const int kk = A_KMAJOR ? idx / kBM : idx % kBK;
      const int mm = A_KMAJOR ? idx % kBM : idx / kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < k_end)
        v = A_KMAJOR ? A[(int64_t)gk * lda + gm] : A[(int64_t)gm * lda + gk];
      As[kk][mm] = v;
    }
#pragma unroll
    for (int r = 0; r < kBN * kBK / kGemmThreads; ++r) {
      const int idx = tid + r * kGemmThreads;
      const int kk = B_NMAJOR ? idx % kBK : idx / kBN;
      const int nn = B_NMAJOR ? idx / kBK : idx % kBN;
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < k_end)
        v = B_NMAJOR ? B[(int64_t)gn * ldb + gk] : B[(int64_t)gk * ldb + gn];
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(int64_t)m * ldc + n] = acc[i][j];
    }
  }
}

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

// grid (ceil(P/kThreads), K, B*G): one thread per (image, group, tap,
// output pixel). dx must be zeroed by the caller.
__global__ void __launch_bounds__(kThreads) deform_col2im_kernel(
    const float* __restrict__ x, const float* __restrict__ offsets,
    const float* __restrict__ dcols, float* __restrict__ dx,
    float* __restrict__ doffsets, int C, int H, int W, int G, int Ho, int Wo,
    int kh, int kw, int stride, int pad, int dil) {
  const int P = Ho * Wo;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int K = kh * kw;
  const int Cg = C / G;
  const int t = blockIdx.y;
  const int bg = blockIdx.z;
  const int b = bg / G;
  const int g = bg - b * G;
  const int ho = p / Wo;
  const int wo = p - ho * Wo;
  const int i = t / kw;
  const int j = t - i * kw;

  const int64_t off_row = ((int64_t)bg * K * 2 + 2 * t) * P + p;
  const float py = (float)(ho * stride - pad + i * dil) + offsets[off_row];
  const float px = (float)(wo * stride - pad + j * dil) + offsets[off_row + P];

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
  const int64_t chan0 = (int64_t)b * C + (int64_t)g * Cg;
  const float* dc = dcols + ((int64_t)bg * K * Cg + (int64_t)t * Cg) * P + p;
  float gy = 0.f, gx = 0.f;
  for (int c = 0; c < Cg; ++c) {
    const float d = dc[(int64_t)c * P];
    const float* xc = x + (chan0 + c) * HW;
    float* dxc = dx + (chan0 + c) * HW;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    if (v00) {
      a00 = __ldg(xc + q00);
      atomicAdd(dxc + q00, d * w00);
    }
    if (v01) {
      a01 = __ldg(xc + q01);
      atomicAdd(dxc + q01, d * w01);
    }
    if (v10) {
      a10 = __ldg(xc + q10);
      atomicAdd(dxc + q10, d * w10);
    }
    if (v11) {
      a11 = __ldg(xc + q11);
      atomicAdd(dxc + q11, d * w11);
    }
    gy += d * ((a10 - a00) * hx + (a11 - a01) * lx);
    gx += d * ((a01 - a00) * hy + (a11 - a10) * ly);
  }
  doffsets[off_row] = gy;
  doffsets[off_row + P] = gx;
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for the dW2 partials.
long long deform_conv_bwd_partial_floats(int B, int O, int KC, int P) {
  const long long splits = (P + kSplitK - 1) / kSplitK;
  return (long long)B * splits * O * KC;
}

// x (B, C, H, W), offsets (B, G*K*2, Ho, Wo), cols (B, KC, P), w2 (O, KC),
// dy (B, O, P), all contiguous f32. Writes dcols (B, KC, P) and partial
// (scratch), dx (B, C, H, W; zeroed by the caller), doffsets (like offsets)
// and dw2 (O, KC). Returns the cudaError_t of the first failed launch.
int deform_conv_bwd_f32(const void* x, const void* offsets, const void* cols,
                        const void* w2, const void* dy, void* dcols,
                        void* partial, void* dx, void* doffsets, void* dw2,
                        int B, int C, int H, int W, int G, int Ho, int Wo,
                        int kh, int kw, int stride, int pad, int dil, int O,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int K = kh * kw;
  const int KC = G * K * (C / G);
  const int P = Ho * Wo;
  // dcols_b = W2^T · dy_b: A = W2 read k-major (A(m, k) = W2[k*KC + m])
  {
    const dim3 grid((P + kBN - 1) / kBN, (KC + kBM - 1) / kBM, B);
    sgemm_kernel<true, false><<<grid, kGemmThreads, 0, st>>>(
        (const float*)w2, (const float*)dy, (float*)dcols, KC, P, O, KC, P,
        P, 0, (int64_t)O * P, (int64_t)KC * P, 1, O);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // dW2 partials: dy_b (O, P) · cols_b^T, B(k, n) = cols_b[n*P + k]
  const int splits = (P + kSplitK - 1) / kSplitK;
  {
    const dim3 grid((KC + kBN - 1) / kBN, (O + kBM - 1) / kBM, B * splits);
    sgemm_kernel<false, true><<<grid, kGemmThreads, 0, st>>>(
        (const float*)dy, (const float*)cols, (float*)partial, O, KC, P, P,
        P, KC, (int64_t)O * P, (int64_t)KC * P, (int64_t)O * KC, splits,
        kSplitK);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  {
    const int64_t n = (int64_t)O * KC;
    const int blocks = (int)((n + kThreads - 1) / kThreads);
    fold_partials_kernel<<<blocks, kThreads, 0, st>>>(
        (const float*)partial, (float*)dw2, n, B * splits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((P + kThreads - 1) / kThreads, K, B * G);
  deform_col2im_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)offsets, (const float*)dcols,
      (float*)dx, (float*)doffsets, C, H, W, G, Ho, Wo, kh, kw, stride, pad,
      dil);
  return (int)cudaGetLastError();
}

const char* deform_col2im_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
