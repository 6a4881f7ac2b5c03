// Kernel B6: one pyramid level of the flow smoother's block matcher.
//
// Replaces the TPU kernel video3d_tpu/kernels/flowmatch.py
// flow_match_pallas (body _match_kernel), which runs a whole level in one
// grid step from VMEM: for each of the (2s+1)^2 candidate shifts of the
// warped previous frame (edge-replicated), the border-clipped
// (2R+1)^2 SAD against the current frame divided by the true window
// area; an online softargmin over the candidates (running minimum,
// rescaled sums); the residual smoothed by an area-normalised radius-2
// box and added to the incoming flow.
//
// What bounds it on the H100: neither memory nor arithmetic at the
// smoother's sizes (<= 540x960; four f32 planes in, two out, ~25 MFLOP
// at 270x480). A level is one small launch, so launch latency and the
// block's serial walk over the 25 candidates set its time.
//
// Design: one block per 32x16 output tile. The block stages `cur` with a
// halo of R + 2 (zero outside the image) and `prev_w` with a halo of
// s + R + 2 (edge-clamped, so a shifted read is shift_edge) in shared
// memory. The residual is needed on the tile plus the radius-2 halo of
// the smoothing box, so the block computes it on that 36x20 region:
// per candidate, a vertical pass writes (2R+1)-row sums of |cur - cand|
// to shared memory, then each thread finishes the horizontal sums of the
// residual pixels it owns and updates their softargmin state in
// registers. Two border rules are kept apart: candidate shifts replicate
// the image edge; both boxes are clipped at the image edge (zero outside,
// divided by the in-image count), not at the tile edge. expf, not
// __expf. The sums run in another order than the twin's cumulative sums,
// so the flow agrees to ~1e-5 px, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32, TH = 16;  // output tile (block of TW x TH threads)
constexpr int SR = 2;            // radius of the residual smoothing box
constexpr int RW = TW + 2 * SR, RH = TH + 2 * SR;  // residual region
constexpr int NT = TW * TH;
constexpr int PER = (RW * RH + NT - 1) / NT;  // residual pixels per thread

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// 1 / border-clipped (2r+1)^2 window area at (y, x)
__device__ __forceinline__ float inv_count(int y, int x, int H, int W,
                                           int r) {
  const int cy = min(y, r) + min(H - 1 - y, r) + 1;
  const int cx = min(x, r) + min(W - 1 - x, r) + 1;
  return 1.0f / (float)(cy * cx);
}

// grid (ceil(W/TW), ceil(H/TH)), block (TW, TH)
__global__ void match_kernel(const float* __restrict__ cur,
                             const float* __restrict__ prev,
                             const float* __restrict__ fy,
                             const float* __restrict__ fx,
                             float* __restrict__ oy, float* __restrict__ ox,
                             int H, int W, int S, int R, float inv_tau) {
  extern __shared__ float smem[];
  const int HC = R + SR, HP = S + R + SR;  // halos of cur and prev
  const int CW = TW + 2 * HC, CH = TH + 2 * HC;
  const int PW = TW + 2 * HP, PH = TH + 2 * HP;
  const int VW = RW + 2 * R;  // columns of the vertical sums
  float* cur_s = smem;                // CH x CW
  float* prev_s = cur_s + CH * CW;    // PH x PW
  float* vs = prev_s + PH * PW;       // RH x VW
  float* ry_s = vs + RH * VW;         // RH x RW
  float* rx_s = ry_s + RH * RW;       // RH x RW

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < CH * CW; i += NT) {
    const int yy = y0 - HC + i / CW, xx = x0 - HC + i % CW;
    cur_s[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                   ? cur[(long long)yy * W + xx]
                   : 0.0f;
  }
  for (int i = tid; i < PH * PW; i += NT) {
    const int yy = clampi(y0 - HP + i / PW, 0, H - 1);
    const int xx = clampi(x0 - HP + i % PW, 0, W - 1);
    prev_s[i] = prev[(long long)yy * W + xx];
  }

  // online softargmin state of the residual pixels this thread owns
  float m[PER], ws[PER], wy[PER], wx[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    m[k] = 3.4e38f;
    ws[k] = 0.0f;
    wy[k] = 0.0f;
    wx[k] = 0.0f;
  }
  __syncthreads();

  for (int dy = -S; dy <= S; ++dy) {
    for (int dx = -S; dx <= S; ++dx) {
      // vertical (2R+1)-row sums of |cur - cand|, zero outside the image
      for (int i = tid; i < RH * VW; i += NT) {
        const int j = i / VW, c = i % VW;
        const int gy = y0 - SR + j, gx = x0 - SR - R + c;
        float s = 0.0f;
        if (gx >= 0 && gx < W) {
          for (int t = -R; t <= R; ++t) {
            if (gy + t < 0 || gy + t >= H) continue;
            const float a = cur_s[(j + t + R) * CW + c];
            const float b = prev_s[(j + t + dy + S + R) * PW + c + dx + S];
            s += fabsf(a - b);
          }
        }
        vs[i] = s;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int p = tid + k * NT;
        if (p >= RW * RH) break;
        const int j = p / RW, i = p % RW;
        const int gy = y0 - SR + j, gx = x0 - SR + i;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
        float s = 0.0f;
        for (int u = 0; u <= 2 * R; ++u) s += vs[j * VW + i + u];
        const float c = s * inv_count(gy, gx, H, W, R);
        const float m_new = fminf(m[k], c);
        const float scale =
            ws[k] > 0.0f ? expf((m_new - m[k]) * inv_tau) : 0.0f;
        const float u = expf((m_new - c) * inv_tau);
        ws[k] = ws[k] * scale + u;
        wy[k] = wy[k] * scale + (float)dy * u;
        wx[k] = wx[k] * scale + (float)dx * u;
        m[k] = m_new;
      }
      __syncthreads();
    }
  }

  // the residual, zero outside the image (the smoothing box is clipped)
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int p = tid + k * NT;
    if (p >= RW * RH) break;
    const int gy = y0 - SR + p / RW, gx = x0 - SR + p % RW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    ry_s[p] = in ? wy[k] / ws[k] : 0.0f;
    rx_s[p] = in ? wx[k] / ws[k] : 0.0f;
  }
  __syncthreads();

  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (y >= H || x >= W) return;
  float sy = 0.0f, sx = 0.0f;
  for (int a = 0; a <= 2 * SR; ++a) {
    const int row = (threadIdx.y + a) * RW + threadIdx.x;
    for (int b = 0; b <= 2 * SR; ++b) {
      sy += ry_s[row + b];
      sx += rx_s[row + b];
    }
  }
  const float inv2 = inv_count(y, x, H, W, SR);
  const long long idx = (long long)y * W + x;
  oy[idx] = fy[idx] + sy * inv2;
  ox[idx] = fx[idx] + sx * inv2;
}

}  // namespace

// cur, prev (already warped), fy, fx, oy, ox: (H, W) f32, contiguous.
extern "C" int v3d_flow_match(void* cur, void* prev, void* fy, void* fx,
                              void* oy, void* ox, int H, int W, int search,
                              int radius, float inv_tau, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const int HC = radius + SR, HP = search + radius + SR;
  const size_t floats = (size_t)(TH + 2 * HC) * (TW + 2 * HC) +
                        (size_t)(TH + 2 * HP) * (TW + 2 * HP) +
                        (size_t)RH * (RW + 2 * radius) + 2 * (size_t)RH * RW;
  const size_t smem = floats * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  match_kernel<<<grid, dim3(TW, TH), smem, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, (const float*)fy,
      (const float*)fx, (float*)oy, (float*)ox, H, W, search, radius,
      inv_tau);
  return (int)cudaGetLastError();
}
