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
// with rx = x1 + (x2 - x1 + 0.1)/2 and by = y1 + (y2 - y1 + 0.1)/2 computed
// by the caller in the f32 expressions of crop_split._quadrant_bounds, so
// the compares here give the plain version's bits.
//
// Layouts (contiguous f32):
//   basis    (B, nb, H*W)     the head's NCHW basis masks
//   cq       (B, 4, nb, N)    coefficients by quadrant, detections minor
//   params   (B, 6, N)        x1, y1, x2, y2, rx, by
//   out      (B, H*W, N)      the JAX layout (B, h, w, N)
//
// What bounds it on an H100: bytes. The output (B*H*W*N floats; 237 MB for
// a decode of 100 detections on the 272x272 grid at batch 8) is written
// once, about 0.07 ms at 3.35 TB/s; the dot is 2*nb = 64 flops per in-box
// (pixel, detection), 3.8 GFLOP there if every pair were in its box
// (0.057 ms at the 67 TFLOP/s f32 rate) and a fraction of that in practice.
// So the design uses no tensor cores and keeps the write stream dense:
//   - one block per tile of 64 pixels of one image; the tile's basis values
//     (nb x 64) and the image's box parameters sit in shared memory, read
//     coalesced once;
//   - threads walk the (pixel, detection) pairs with the detection fastest,
//     so a warp's stores are contiguous and its coefficient reads (cq,
//     detections minor) are coalesced within a quadrant;
//   - only the selected quadrant's nb-term dot is computed (a quarter of the
//     TPU kernel's work), and not at all outside the box.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 64;   // pixels per block

__global__ void __launch_bounds__(kThreads) assemble_masks_kernel(
    const float* __restrict__ basis, const float* __restrict__ cq,
    const float* __restrict__ params, float* __restrict__ out, int HW, int W,
    int nb, int N) {
  extern __shared__ float smem[];
  float* bs = smem;                  // (nb, kPix)
  float* prm = smem + nb * kPix;     // (6, N)
  const int b = blockIdx.y;
  const int pix0 = blockIdx.x * kPix;
  const int npix = min(kPix, HW - pix0);
  const float* bb = basis + (int64_t)b * nb * HW;
  for (int i = threadIdx.x; i < nb * kPix; i += kThreads) {
    const int k = i / kPix, j = i - k * kPix;
    bs[i] = j < npix ? bb[(int64_t)k * HW + pix0 + j] : 0.f;
  }
  const float* pb = params + (int64_t)b * 6 * N;
  for (int i = threadIdx.x; i < 6 * N; i += kThreads) prm[i] = pb[i];
  __syncthreads();

  const float* cb = cq + (int64_t)b * 4 * nb * N;
  float* ob = out + ((int64_t)b * HW + pix0) * N;
  const int items = npix * N;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int j = it / N, n = it - j * N;
    const int pix = pix0 + j;
    const int r = pix / W;
    const float row = (float)r, col = (float)(pix - r * W);
    const float x1 = prm[n], y1 = prm[N + n], x2 = prm[2 * N + n];
    const float y2 = prm[3 * N + n], rx = prm[4 * N + n];
    const float by = prm[5 * N + n];
    float v = 0.f;
    if (col >= x1 && col < x2 && row >= y1 && row < y2) {
      const int q = (row >= by ? 2 : 0) + (col >= rx ? 1 : 0);
      const float* c = cb + (int64_t)q * nb * N + n;
      float acc = 0.f;
      for (int k = 0; k < nb; ++k) acc += bs[k * kPix + j] * __ldg(c + k * N);
      v = 1.f / (1.f + expf(-acc));
    }
    ob[it] = v;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs.
int assemble_masks_smem_bytes(int nb, int N) {
  return (nb * kPix + 6 * N) * (int)sizeof(float);
}

// basis (B, nb, HW), cq (B, 4, nb, N), params (B, 6, N) -> out (B, HW, N),
// all contiguous f32. Returns the cudaError_t of the launch.
int assemble_masks_f32(const void* basis, const void* cq, const void* params,
                       void* out, int B, int H, int W, int nb, int N,
                       void* stream) {
  const int HW = H * W;
  if (B == 0 || HW == 0 || N == 0) return 0;
  const int smem = assemble_masks_smem_bytes(nb, N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_masks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((HW + kPix - 1) / kPix, B);
  assemble_masks_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)basis, (const float*)cq, (const float*)params,
      (float*)out, HW, W, nb, N);
  return (int)cudaGetLastError();
}

const char* mask_assembly_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
