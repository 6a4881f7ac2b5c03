// Kernel B5: gather-free separable shift warp of the flow smoother.
//
// Replaces the TPU kernel video3d_tpu/kernels/warp.py
// warp_bilinear_shifts_pallas (bodies _vwarp_kernel, then _hwarp_kernel),
// which accumulates 2r+1 hat-weighted edge-replicated shifts per pass:
//   mid(y, x) = sum_k max(0, 1 - |fy(y, x) - k|) * img(clamp(y + k), x)
//   out(y, x) = sum_k max(0, 1 - |fx(y, x) - k|) * mid(y, clamp(x + k))
// with fy, fx clamped to [-r, r].
//
// What bounds it on the H100: memory. Per output pixel it reads four
// image values, two fy and one fx and writes one f32 (1080x1920 at
// r = 16: ~66 MB, ~0.02 ms at 3.35 TB/s); the arithmetic is a few flops.
//
// Design: only k = floor(f) and floor(f) + 1 have a non-zero hat weight,
// so each pass computes those two taps and skips the other 2r - 1. Both
// passes fuse into one launch with no intermediate plane: the output at
// (y, x) needs mid at the two clamped columns c, each warped vertically
// with fy at (y, c) -- not at (y, x), so this is not a 2-D bilinear
// sample. The weights are the twin's f32 expression, the lower tap is
// added first, and the skipped taps add exact zeros in the twin, so the
// result equals the plain twin bit for bit (up to the sign of zero).
// Built with -fmad=false so no multiply-add is contracted.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float hat(float f, int k) {
  return fmaxf(0.0f, 1.0f - fabsf(f - (float)k));
}

// vertical two-tap resample of column c at row y, by fy(y, c)
__device__ __forceinline__ float vtap(const float* __restrict__ img,
                                      const float* __restrict__ fy, int y,
                                      int c, int H, int W, float r) {
  const float f = fminf(fmaxf(fy[(long long)y * W + c], -r), r);
  const int k0 = (int)floorf(f);
  const float w0 = hat(f, k0), w1 = hat(f, k0 + 1);
  const int r0 = clampi(y + k0, 0, H - 1), r1 = clampi(y + k0 + 1, 0, H - 1);
  float acc = w0 * img[(long long)r0 * W + c];
  acc = acc + w1 * img[(long long)r1 * W + c];
  return acc;
}

__global__ void warp_kernel(const float* __restrict__ img,
                            const float* __restrict__ fy,
                            const float* __restrict__ fx,
                            float* __restrict__ out, int H, int W, float r) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)H * W) return;
  const int y = (int)(i / W), x = (int)(i % W);
  const float f = fminf(fmaxf(fx[i], -r), r);
  const int k0 = (int)floorf(f);
  const float w0 = hat(f, k0), w1 = hat(f, k0 + 1);
  const int c0 = clampi(x + k0, 0, W - 1), c1 = clampi(x + k0 + 1, 0, W - 1);
  float acc = w0 * vtap(img, fy, y, c0, H, W, r);
  acc = acc + w1 * vtap(img, fy, y, c1, H, W, r);
  out[i] = acc;
}

}  // namespace

// img, fy, fx, out: (H, W) f32, contiguous.
extern "C" int v3d_warp(void* img, void* fy, void* fx, void* out, int H,
                        int W, int r, void* stream) {
  long long n = (long long)H * W;
  if (n == 0) return 0;
  warp_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)fy, (const float*)fx, (float*)out, H,
      W, (float)r);
  return (int)cudaGetLastError();
}
