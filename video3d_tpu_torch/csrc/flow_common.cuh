// Device helpers shared by the flow smoother's kernels B5 (warp.cu) and
// B6 (flowmatch.cu): the bilinear upsample of a flow plane from host-built
// tap tables, and B5's separable two-tap shift warp of a tile region.
#pragma once

#include <cuda_runtime.h>

namespace v3dflow {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float hat(float f, int k) {
  return fmaxf(0.0f, 1.0f - fabsf(f - (float)k));
}

// One axis of resample_matrix(n_in, n_out, "bilinear"): for output o, the
// two source indices idx[2o] <= idx[2o+1] and their f32 weights (the
// matrix's two non-zero entries; a lone entry has its twin at weight 0).
struct Taps {
  const int* idx;
  const float* w;
};

// A plane read at another resolution: v(y, x) = clamp(scale * sum of the
// 2x2 taps of clamp(f, +-pre), +-lim), the taps from `ty` (rows) and `tx`
// (columns), height pass first as resize2d's matmuls; `ty.idx == nullptr`
// reads f(y, x) itself; `f == nullptr` is a zero plane.
struct Plane {
  const float* f;
  int w;  // row stride of f
  Taps ty, tx;
  float scale, pre, lim;
};

__device__ __forceinline__ float plane_at(const Plane& p, int y, int x) {
  if (p.f == nullptr) return 0.0f;
  float v;
  if (p.ty.idx == nullptr) {
    v = fminf(fmaxf(p.f[(long long)y * p.w + x], -p.pre), p.pre);
  } else {
    const int y0 = p.ty.idx[2 * y], y1 = p.ty.idx[2 * y + 1];
    const int x0 = p.tx.idx[2 * x], x1 = p.tx.idx[2 * x + 1];
    const float wy0 = p.ty.w[2 * y], wy1 = p.ty.w[2 * y + 1];
    const float wx0 = p.tx.w[2 * x], wx1 = p.tx.w[2 * x + 1];
    const float* r0 = p.f + (long long)y0 * p.w;
    const float* r1 = p.f + (long long)y1 * p.w;
    const float a = wy0 * fminf(fmaxf(r0[x0], -p.pre), p.pre) +
                    wy1 * fminf(fmaxf(r1[x0], -p.pre), p.pre);
    const float b = wy0 * fminf(fmaxf(r0[x1], -p.pre), p.pre) +
                    wy1 * fminf(fmaxf(r1[x1], -p.pre), p.pre);
    v = (wx0 * a + wx1 * b) * p.scale;
  }
  return fminf(fmaxf(v, -p.lim), p.lim);
}

// A plane's height pass staged in shared memory for a block's region:
// rows clamp(ya + j), j < rows, and the source columns [c0, c0 + nc) that
// the upsample of image columns [xa, xa + cols) reads. Reading through it
// gives plane_at's value bit for bit (the same products and sums in the
// same order); where no stage is set (st == nullptr), plane_at itself.
struct Staged {
  Plane p;
  const float* st;
  int nc, c0;

  __device__ __forceinline__ float operator()(int j, int y, int x) const {
    if (st == nullptr) return plane_at(p, y, x);
    const int x0 = p.tx.idx[2 * x], x1 = p.tx.idx[2 * x + 1];
    const float* r = st + j * nc - c0;
    const float v =
        (p.tx.w[2 * x] * r[x0] + p.tx.w[2 * x + 1] * r[x1]) * p.scale;
    return fminf(fmaxf(v, -p.lim), p.lim);
  }
};

// Fills `buf` (at most rows x cap floats) with p's height pass for the
// region and returns the reader; a plane read directly, or a region
// wider than `cap` source columns, reads through plane_at instead. Needs
// a block barrier before the first read.
__device__ __forceinline__ Staged stage(const Plane& p, int H, int W, int ya,
                                        int rows, int xa, int cols, int cap,
                                        float* buf) {
  if (p.f == nullptr || p.ty.idx == nullptr) return Staged{p, nullptr, 0, 0};
  const int c0 = p.tx.idx[2 * clampi(xa, 0, W - 1)];
  const int nc = p.tx.idx[2 * clampi(xa + cols - 1, 0, W - 1) + 1] - c0 + 1;
  if (nc > cap) return Staged{p, nullptr, 0, 0};
  for (int i = threadIdx.x; i < rows * nc; i += blockDim.x) {
    const int j = i / nc, k = i - j * nc;
    const int y = clampi(ya + j, 0, H - 1);
    const int y0 = p.ty.idx[2 * y], y1 = p.ty.idx[2 * y + 1];
    const float a = fminf(fmaxf(p.f[(long long)y0 * p.w + c0 + k], -p.pre),
                          p.pre);
    const float b = fminf(fmaxf(p.f[(long long)y1 * p.w + c0 + k], -p.pre),
                          p.pre);
    buf[i] = p.ty.w[2 * y] * a + p.ty.w[2 * y + 1] * b;
  }
  return Staged{p, buf, nc, c0};
}

// B5's warp on a region: dst[j * cols + i] = warp(img)(clamp(ya + j),
// clamp(xa + i)) for j < rows, i < cols, with the flow clamped to [-r, r]:
//   mid(y, c) = sum_k hat(fy(y, c), k) * img(clamp(y + k), c)
//   out(y, x) = sum_k hat(fx(y, x), k) * mid(y, clamp(x + k))
// Only k = floor(f) and floor(f) + 1 have a non-zero hat weight, so each
// pass takes those two taps, the lower first: with -fmad=false this is
// the twin's sum of 2r + 1 taps bit for bit (the others add exact zeros).
// `mid` holds rows x (cols + 2r + 1) floats: the columns the horizontal
// pass can reach. fy and fx are read at (region row, y, x); staged, they
// cover rows x (cols + 2r + 1) from (ya, xa - r). Ends with a barrier.
__device__ __forceinline__ void warp_region(const float* __restrict__ img,
                                            int H, int W, int ya, int xa,
                                            int rows, int cols, int r,
                                            const Staged& fy,
                                            const Staged& fx, float* mid,
                                            float* dst) {
  const int mw = cols + 2 * r + 1, base = xa - r;
  const float rf = (float)r;
  for (int i = threadIdx.x; i < rows * mw; i += blockDim.x) {
    const int j = i / mw, c = i - j * mw;
    const int y = clampi(ya + j, 0, H - 1), col = clampi(base + c, 0, W - 1);
    const float f = fminf(fmaxf(fy(j, y, col), -rf), rf);
    const int k0 = (int)floorf(f);
    const float w0 = hat(f, k0), w1 = hat(f, k0 + 1);
    const int r0 = clampi(y + k0, 0, H - 1), r1 = clampi(y + k0 + 1, 0, H - 1);
    float acc = w0 * img[(long long)r0 * W + col];
    acc = acc + w1 * img[(long long)r1 * W + col];
    mid[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int j = i / cols, ii = i - j * cols;
    const int y = clampi(ya + j, 0, H - 1), x = clampi(xa + ii, 0, W - 1);
    const float f = fminf(fmaxf(fx(j, y, x), -rf), rf);
    const int k0 = (int)floorf(f);
    const float w0 = hat(f, k0), w1 = hat(f, k0 + 1);
    const float* m = mid + j * mw;
    float acc = w0 * m[clampi(x + k0, 0, W - 1) - base];
    acc = acc + w1 * m[clampi(x + k0 + 1, 0, W - 1) - base];
    dst[i] = acc;
  }
  __syncthreads();
}

// the border-clipped (2r+1)-wide window's in-image count at i of n
__device__ __forceinline__ int win_count(int i, int n, int r) {
  return min(i, r) + min(n - 1 - i, r) + 1;
}

}  // namespace v3dflow
