// Kernel B4: banded-window speckle vote.
//
// Replaces the TPU kernel video3d_tpu/kernels/speckle.py
// speckle_filter_pallas (body _speckle_kernel), which walks row blocks with
// a VMEM ring of band masks and running column sums.
//
// What bounds it on the H100: it reads and writes one f32 disparity map
// (2 x 33 MB for two 1080p frames, ~0.02 ms at 3.35 TB/s); the work is the
// (2r+1)^2 = 441-tap window count per pixel at the default r = 10.
//
// Simple design: a first kernel turns each pixel into one band byte (255
// for invalid pixels). The vote kernel stages a tile of band bytes with an
// r-pixel halo in shared memory (255 outside the image, so the window is
// border-clipped) and each thread counts, in a direct loop, the bytes of
// its window that lie in its own or an adjacent band. Counts are exact
// integers, so the result is bit-identical to the plain twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 8;

__global__ void band_kernel(const float* __restrict__ disp,
                            uint8_t* __restrict__ code, long long n,
                            float invalid, float max_diff, float lo,
                            int n_bands) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = disp[i];
  if (v == invalid) {
    code[i] = 255;
    return;
  }
  int band = (int)floorf((v - lo) / max_diff);
  band = min(max(band, 0), n_bands - 1);
  code[i] = (uint8_t)band;
}

// grid (ceil(W/TW), ceil(H/TH), B), block (TW, TH)
__global__ void vote_kernel(const float* __restrict__ disp,
                            const uint8_t* __restrict__ code,
                            float* __restrict__ out, int H, int W,
                            float invalid, int radius, int min_region) {
  extern __shared__ uint8_t tile[];
  const int SW = TW + 2 * radius, SH = TH + 2 * radius;
  const long long b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const uint8_t* img = code + b * H * (long long)W;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int i = tid; i < SW * SH; i += TW * TH) {
    int yy = y0 - radius + i / SW, xx = x0 - radius + i % SW;
    tile[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? img[(long long)yy * W + xx]
                  : (uint8_t)255;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long idx = (b * H + y) * (long long)W + x;
  const int k = tile[(threadIdx.y + radius) * SW + threadIdx.x + radius];
  const float v = disp[idx];
  if (k == 255) {
    out[idx] = invalid;
    return;
  }
  int support = 0;
  for (int r = 0; r <= 2 * radius; ++r) {
    const uint8_t* trow = tile + (threadIdx.y + r) * SW + threadIdx.x;
    for (int c = 0; c <= 2 * radius; ++c) {
      int q = trow[c];
      support += (q != 255) & (abs(q - k) <= 1);
    }
  }
  out[idx] = support >= min_region ? v : invalid;
}

}  // namespace

// disp, out: (B, H, W) f32; code: (B, H, W) uint8 scratch.
extern "C" int v3d_speckle(void* disp, void* out, void* code, int B, int H,
                           int W, float invalid, float max_diff, float lo,
                           int n_bands, int radius, int min_region,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_bands > 254) return (int)cudaErrorInvalidValue;
  long long n = (long long)B * H * W;
  band_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)disp, (uint8_t*)code, n, invalid, max_diff, lo, n_bands);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  size_t smem = (size_t)(TW + 2 * radius) * (TH + 2 * radius);
  e = cudaFuncSetAttribute(vote_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  vote_kernel<<<grid, dim3(TW, TH), smem, s>>>(
      (const float*)disp, (const uint8_t*)code, (float*)out, H, W, invalid,
      radius, min_region);
  return (int)cudaGetLastError();
}
