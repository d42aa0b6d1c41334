// The tile design of K5c, the row-sampling backward, kept for the
// measurement of sipmask_tpu_torch/tools/k5c_probe.py; the package does not
// build it. It adds to csrc/deform_rows.cu (included whole) a backward for
// same-size maps (P == H*W, Cg % 32 == 0: every SipMask++ DCN conv) that
// accumulates dx on chip, as the TPU kernel _sample_pallas_bwd keeps dX
// resident:
//   - a block owns one output tile of one image and 32 channels, and adds
//     into a shared-memory window of dx (the tile and a halo on each side):
//     a corner in the window takes a shared atomic, one outside it (a far
//     offset) a global one;
//   - after a barrier the block adds the window into dx with 16-byte vector
//     reductions, about window/tile global adds an x element instead of
//     ~36;
//   - each warp reduces its item's 32 channels of d position by shuffles in
//     a fixed order and writes one partial per (chunk, item);
//     deform_rows_fold_dpyx_kernel adds the partials in chunk order, so
//     dpyx gives the same bits on every call.
// On an H100 it ran 3x slower than the item kernel (PERF.md, PR 8):
// sm_90 has no shared float atomic add (it compiles to ATOMS.CAST.SPIN
// loops), and with plain shared adds it still ran 3x slower, since a warp
// item of 32 channels pays the corner math, the loads' latency and the
// shuffles that the item kernel spreads over Cg channels.

#include "deform_rows.cu"

namespace {

// Grid (N * tiles, Cg / 32): block (n, tile, chunk) owns output pixels
// [ty0, ty0 + th) x [tx0, tx0 + tw) of image n and channels
// [32*chunk, 32*chunk + 32). Dynamic shared memory: the dx window,
// (th + 2*halo) x (tw + 2*halo) pixels x 32 channels, pixel-major; then
// one float4 per (tile pixel, tap) item, pixel-major: its position (py, px)
// and, as int bits, its row p*K + k of dsampled and its index k*P + p of
// pyx (-1 for a pixel past the map's edge).

constexpr int kChunkC = 32;   // channels of a block: one a lane
constexpr int kUnroll = 2;    // items a warp has in flight

// The 32 sums of a warp's lanes, of gy and of gx, in a fixed order: lane 0
// gets sum gy, lane 16 sum gx.
__device__ __forceinline__ float warp_sum_pair(float gy, float gx,
                                               int lane) {
  float v = (lane & 16) ? gx : gy;
  v += __shfl_xor_sync(0xffffffffu, (lane & 16) ? gy : gx, 16);
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__global__ void __launch_bounds__(kThreads) deform_rows_bwd_tiles_kernel(
    const float* __restrict__ x, const float* __restrict__ pyx,
    const float* __restrict__ dsampled, float* __restrict__ dx,
    float* __restrict__ part, int N, int H, int W, int Cg, int K, int th,
    int tw, int halo, int tiles_x, int tiles) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x / tiles, tile = blockIdx.x - n * tiles;
  const int chunk = blockIdx.y;
  const int ty0 = (tile / tiles_x) * th, tx0 = (tile % tiles_x) * tw;
  const int wh = th + 2 * halo, ww = tw + 2 * halo;
  const int wy0 = ty0 - halo, wx0 = tx0 - halo;
  const int n_win4 = wh * ww * (kChunkC / 4);
  float4* items = smem4 + n_win4;
  const int P = H * W, tpx = th * tw, n_items = tpx * K;
  const int64_t pixel0 = (int64_t)n * P;
  const float2* pyx2 = reinterpret_cast<const float2*>(pyx) + pixel0 * K;

  for (int i = threadIdx.x; i < n_win4; i += kThreads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the tile's items, positions read coalesced along each tile row
  for (int i = threadIdx.x; i < n_items; i += kThreads) {
    const int k = i / tpx, t = i - k * tpx;
    const int y = ty0 + t / tw, xx = tx0 + t % tw;
    float4 e = make_float4(0.f, 0.f, __int_as_float(-1), __int_as_float(-1));
    if (y < H && xx < W) {
      const int p = y * W + xx;
      const float2 pos = pyx2[(int64_t)k * P + p];
      e = make_float4(pos.x, pos.y, __int_as_float(p * K + k),
                      __int_as_float(k * P + p));
    }
    items[t * K + k] = e;
  }
  __syncthreads();

  const int c0 = chunk * kChunkC;
  const float* xn = x + pixel0 * Cg + c0 + lane;
  float* dxn = dx + pixel0 * Cg + c0 + lane;
  const float* gn = dsampled + pixel0 * K * Cg + c0 + lane;
  float* pn = part + ((int64_t)chunk * N + n) * K * P * 2;
  const float wmy = (float)(wh - 1), wmx = (float)(ww - 1);
  for (int base = warp * kUnroll; base < n_items; base += kWarps * kUnroll) {
    // the loads of kUnroll items first, then their adds
    float4 e[kUnroll];
    Corners c[kUnroll];
    float d[kUnroll], a[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e[u] = base + u < n_items
                 ? items[base + u]
                 : make_float4(0.f, 0.f, __int_as_float(-1), 0.f);
      if (__float_as_int(e[u].z) < 0) continue;   // warp-uniform
      c[u] = corners(e[u].x, e[u].y, H, W);
      d[u] = gn[(int64_t)__float_as_int(e[u].z) * Cg];
      a[u][0] = c[u].v00 ? xn[c[u].q00 * Cg] : 0.f;
      a[u][1] = c[u].v01 ? xn[c[u].q01 * Cg] : 0.f;
      a[u][2] = c[u].v10 ? xn[c[u].q10 * Cg] : 0.f;
      a[u][3] = c[u].v11 ? xn[c[u].q11 * Cg] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (__float_as_int(e[u].z) < 0) continue;
      const Corners& cu = c[u];
      const float du = d[u];
      const float gy = du * ((a[u][2] - a[u][0]) * cu.hx +
                             (a[u][3] - a[u][1]) * cu.lx);
      const float gx = du * ((a[u][1] - a[u][0]) * cu.hy +
                             (a[u][3] - a[u][2]) * cu.ly);
      // window row and column of the floor corner, as floats: a far
      // position is never converted to an int
      const float ry = floorf(e[u].x) - (float)wy0;
      const float rx = floorf(e[u].y) - (float)wx0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool v = j == 0 ? cu.v00 : j == 1 ? cu.v01
                     : j == 2 ? cu.v10 : cu.v11;
        const float wgt = j == 0 ? cu.w00 : j == 1 ? cu.w01
                        : j == 2 ? cu.w10 : cu.w11;
        if (!v || wgt == 0.f) continue;
        const float cy = ry + (float)(j >> 1), cx = rx + (float)(j & 1);
        if (cy >= 0.f && cy <= wmy && cx >= 0.f && cx <= wmx) {
          atomicAdd(win + ((int)cy * ww + (int)cx) * kChunkC + lane,
                    du * wgt);
        } else {
          const int64_t q = j == 0 ? cu.q00 : j == 1 ? cu.q01
                          : j == 2 ? cu.q10 : cu.q11;
          atomicAdd(dxn + q * Cg, du * wgt);
        }
      }
      const float sum = warp_sum_pair(gy, gx, lane);
      if ((lane & 15) == 0)
        pn[(int64_t)__float_as_int(e[u].w) * 2 + (lane >> 4)] = sum;
    }
  }
  __syncthreads();

  // the window into dx: 8 lanes a pixel's 32 channels, 16-byte reductions;
  // all-zero vectors (halo the offsets never reached) add nothing
  float4* dx4 = reinterpret_cast<float4*>(dx + pixel0 * Cg + c0);
  const int cg4 = Cg / 4;
  for (int i = threadIdx.x; i < n_win4; i += kThreads) {
    const int j = i >> 3, q = i & 7;
    const int jy = j / ww;
    const int gy = wy0 + jy, gx = wx0 + (j - jy * ww);
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    const float4 v = smem4[i];
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
    atomicAdd(dx4 + (int64_t)(gy * W + gx) * cg4 + q, v);
  }
}

// dpyx (M = N*K*P float2) = the sum of the chunks' partials, in chunk
// order.
__global__ void __launch_bounds__(kThreads) deform_rows_fold_dpyx_kernel(
    const float2* __restrict__ part, float2* __restrict__ dpyx, int64_t M,
    int chunks) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  float2 s = part[i];
  for (int c = 1; c < chunks; ++c) {
    const float2 v = part[c * M + i];
    s.x += v.x;
    s.y += v.y;
  }
  dpyx[i] = s;
}

}  // namespace

extern "C" {

// The tile route of the backward, for P == H*W and Cg % 32 == 0: dx
// (zeroed by the caller, 16-byte aligned) and dpyx as above, through part,
// the caller's scratch of (Cg/32) * N*K*P * 2 floats, in two launches.
// Tiles of th x tw output pixels with a halo of halo pixels a side.
int deform_rows_bwd_tiles_f32(const void* x, const void* pyx,
                              const void* dsampled, void* dx, void* dpyx,
                              void* part, int N, int H, int W, int Cg, int K,
                              int th, int tw, int halo, void* stream) {
  const int64_t M = (int64_t)N * K * H * W;
  if (M == 0) return 0;
  if (Cg % kChunkC || th < 1 || tw < 1 || halo < 0 ||
      ((uintptr_t)dx | (uintptr_t)pyx) % 16)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  const int64_t blocks = (int64_t)N * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL || Cg / kChunkC > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = ((size_t)(th + 2 * halo) * (tw + 2 * halo) *
                          (kChunkC / 4) + (size_t)th * tw * K) *
                      sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      deform_rows_bwd_tiles_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  deform_rows_bwd_tiles_kernel<<<dim3((unsigned)blocks, Cg / kChunkC),
                                 kThreads, smem, st>>>(
      (const float*)x, (const float*)pyx, (const float*)dsampled,
      (float*)dx, (float*)part, N, H, W, Cg, K, th, tw, halo, tiles_x,
      tiles_x * tiles_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deform_rows_fold_dpyx_kernel<<<(unsigned)((M + kThreads - 1) / kThreads),
                                 kThreads, 0, st>>>(
      (const float2*)part, (float2*)dpyx, M, Cg / kChunkC);
  return (int)cudaGetLastError();
}

}  // extern "C"
