// Kernel B5: the flow smoother's separable shift warp, and the
// full-resolution EMA step built around it.
//
// Replaces the TPU kernel video3d_tpu/kernels/warp.py
// warp_bilinear_shifts_pallas (bodies _vwarp_kernel, then _hwarp_kernel),
// which accumulates 2r+1 hat-weighted edge-replicated shifts per pass:
//   mid(y, x) = sum_k max(0, 1 - |fy(y, x) - k|) * img(clamp(y + k), x)
//   out(y, x) = sum_k max(0, 1 - |fx(y, x) - k|) * mid(y, clamp(x + k))
// with fy, fx clamped to [-r, r] (flow_common.cuh warp_region: two taps a
// pass, bit-equal to the twin). On the TPU the EMA step around the warp is
// more calls inside one jitted scan; here one kernel serves four modes:
//
//   warp   out = warp(img, fy, fx, r)                 (the public entry)
//   guide  alpha_q = clamp(alpha_min + gain * box2(|g - warp(prev_g, f,
//          rq)|) / area2, alpha_min, 1) at guide scale
//   head   rd = box2(|depth - prev_warp|) / area2 at full resolution,
//          prev_warp = warp(prev_out, clamp(up(clamp(f, +-rq)) * s,
//          +-max_warp)); a partial sum of rd per block, the last block to
//          finish sums the partials in block order (deterministic: no
//          float atomics) and writes the mean
//   tail   alpha = up(alpha_q), with the gate max(alpha, clamp((rd /
//          (mean + 1e-6) - t0) * gain_d, 0, 1)); out = alpha * depth +
//          (1 - alpha) * prev_warp, written into the caller's frame
//
// up() is resize2d(..., "bilinear") from the host's tap tables of
// resample_matrix, so the three full-resolution resizes are never stored.
// With the depth gate off, the step is guide + tail; with it, guide +
// head + tail (the tail recomputes the head's warp and rd: cheaper than a
// round trip of two full-resolution planes).
//
// What bounds it on the H100: bytes. At 1080x1920 the tail reads depth and
// prev_out and writes out (25 MB, 7.4 us at 3.35 TB/s); the head reads the
// two again (from L2 in part). The flow and alpha at guide scale are small.
//
// Design: one block of 256 threads per 64x16 output tile (the warp's mid
// rows reach r + 1 columns past the region, so a wide tile wastes less),
// the region warped into shared memory with a halo of 2 for the box, the
// box as a 5-row then 5-column pass over |ref - warp| in shared memory.
// The upsampled flow and alpha are read through their height passes,
// staged once a block in shared memory (flow_common.cuh stage), so a
// pixel's flow is two shared reads and its width pass.

#include <cuda_runtime.h>

#include "flow_common.cuh"

namespace {

using v3dflow::clampi;
using v3dflow::Plane;
using v3dflow::Taps;
using v3dflow::win_count;

constexpr int NT = 256;
constexpr int TW = 64, TH = 16;
constexpr int BR = 2;  // radius of the residual box
enum Mode { WARP = 0, GUIDE = 1, HEAD = 2, TAIL = 3 };

struct EmaArgs {
  const float* img;  // warped: img, prev_g or prev_out
  const float* ref;  // compared: g or depth
  Plane fy, fx, alpha;
  float* out;        // warped plane, alpha_q or the blended frame
  float* partial;    // head: a sum per block
  unsigned* ticket;  // head: blocks done (reset to 0 by the last)
  float* mean;       // head writes, tail reads
  int H, W, r, mode, gate;
  int cap_f, cap_a;  // source columns a block's staged flow / alpha holds
  float alpha_min, gain, t0, gain_d;
};

__host__ __device__ inline int halo_of(int mode, int gate) {
  return (mode == WARP || (mode == TAIL && !gate)) ? 0 : BR;
}

__global__ void __launch_bounds__(NT) ema_kernel(EmaArgs a) {
  extern __shared__ float smem[];
  const int h = halo_of(a.mode, a.gate);
  const int RW = TW + 2 * h, RH = TH + 2 * h;
  const int H = a.H, W = a.W;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  float* pw = smem;            // RH x RW: the warped region
  float* dd = pw + RH * RW;    // RH x RW: |ref - warp|, zero outside
  float* vsum = dd + RH * RW;  // TH x RW: 5-row sums of dd
  float* sfy = vsum + TH * RW;  // RH x cap_f: fy's height pass
  float* sfx = sfy + RH * a.cap_f;
  float* sal = sfx + RH * a.cap_f;  // TH x cap_a: alpha's
  float* mid = sal + TH * a.cap_a;
  float* red = mid;            // reused for the block sum

  // the upsampled planes' height passes for the block (tables only)
  const int mw = RW + 2 * a.r + 1;
  const v3dflow::Staged fy = v3dflow::stage(a.fy, H, W, y0 - h, RH,
                                            x0 - h - a.r, mw, a.cap_f, sfy);
  const v3dflow::Staged fx = v3dflow::stage(a.fx, H, W, y0 - h, RH,
                                            x0 - h - a.r, mw, a.cap_f, sfx);
  const v3dflow::Staged al_q =
      a.mode == TAIL
          ? v3dflow::stage(a.alpha, H, W, y0, TH, x0, TW, a.cap_a, sal)
          : v3dflow::Staged{a.alpha, nullptr, 0, 0};
  __syncthreads();
  v3dflow::warp_region(a.img, H, W, y0 - h, x0 - h, RH, RW, a.r, fy, fx, mid,
                       pw);
  float rd_sum = 0.0f;
  constexpr int PER = TW * TH / NT;
  float rd[PER];
  if (h > 0) {
    for (int i = threadIdx.x; i < RH * RW; i += NT) {
      const int gy = y0 - h + i / RW, gx = x0 - h + i % RW;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      dd[i] = in ? fabsf(a.ref[(long long)gy * W + gx] - pw[i]) : 0.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TH * RW; i += NT) {
      const int j = i / RW, c = i - j * RW;
      float s = 0.0f;
      for (int t = 0; t <= 2 * BR; ++t) s += dd[(j + t) * RW + c];
      vsum[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = threadIdx.x + k * NT;
      const int ty = p / TW, tx = p - ty * TW, y = y0 + ty, x = x0 + tx;
      float s = 0.0f;
      for (int u = 0; u <= 2 * BR; ++u) s += vsum[ty * RW + tx + u];
      const bool in = y < H && x < W;
      rd[k] = in ? s / (float)(win_count(y, H, BR) * win_count(x, W, BR))
                 : 0.0f;
      rd_sum += rd[k];
    }
  }

  if (a.mode == HEAD) {
    // the block's sum in a fixed order: warp shuffles, then the warps
    for (int o = 16; o > 0; o >>= 1)
      rd_sum += __shfl_down_sync(0xffffffffu, rd_sum, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = rd_sum;
    __syncthreads();
    const unsigned nblk = gridDim.x * gridDim.y;
    const unsigned blk = blockIdx.y * gridDim.x + blockIdx.x;
    __shared__ bool last;
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int w = 0; w < NT / 32; ++w) s += red[w];
      a.partial[blk] = s;
      __threadfence();
      last = atomicAdd(a.ticket, 1u) == nblk - 1;
    }
    __syncthreads();
    if (!last) return;
    // every partial is visible: sum them in block order, in double
    __shared__ double dsum[NT];
    double s = 0.0;
    for (unsigned b = threadIdx.x; b < nblk; b += NT)
      s += (double)__ldcg(a.partial + b);
    dsum[threadIdx.x] = s;
    __syncthreads();
    for (int n = NT / 2; n > 0; n >>= 1) {
      if (threadIdx.x < n) dsum[threadIdx.x] += dsum[threadIdx.x + n];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      a.mean[0] = (float)(dsum[0] / ((double)H * (double)W));
      *a.ticket = 0u;
    }
    return;
  }

  const float denom = a.mode == TAIL && a.gate ? a.mean[0] + 1e-6f : 1.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int p = threadIdx.x + k * NT;
    const int ty = p / TW, tx = p - ty * TW, y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const long long idx = (long long)y * W + x;
    const float v = pw[(ty + h) * RW + tx + h];
    if (a.mode == WARP) {
      a.out[idx] = v;
    } else if (a.mode == GUIDE) {
      a.out[idx] = fminf(fmaxf(a.alpha_min + a.gain * rd[k], a.alpha_min),
                         1.0f);
    } else {
      float al = al_q(ty, y, x);
      if (a.gate) {
        const float ad = fminf(
            fmaxf((rd[k] / denom - a.t0) * a.gain_d, 0.0f), 1.0f);
        al = fmaxf(al, ad);
      }
      a.out[idx] = al * a.ref[idx] + (1.0f - al) * v;
    }
  }
}

size_t smem_of(const EmaArgs& a) {
  const int h = halo_of(a.mode, a.gate);
  const int RW = TW + 2 * h, RH = TH + 2 * h;
  const size_t mid = (size_t)RH * (RW + 2 * a.r + 1);
  return (2 * (size_t)RH * RW + (size_t)TH * RW + 2 * (size_t)RH * a.cap_f +
          (size_t)TH * a.cap_a + (mid > 8 ? mid : 8)) *
         sizeof(float);
}

// source columns of an n_in -> n_out bilinear upsample that `cols`
// consecutive outputs read: at most cols * n_in / n_out + 3
int cap_of(int cols, int n_in, int n_out) {
  const int c = (int)(((long long)cols * n_in + n_out - 1) / n_out) + 3;
  return c < n_in ? c : n_in;
}

int launch(const EmaArgs& a, cudaStream_t stream) {
  // the dynamic size allowed so far; it and the head's static shared
  // memory must fit in a block's 227 KB, else the attribute call fails
  static size_t allowed = 48 * 1024;
  const size_t smem = smem_of(a);
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        ema_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH);
  ema_kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

const float kInf = __builtin_huge_valf();

Plane direct(const void* f, int w) {
  return Plane{(const float*)f, w, {nullptr, nullptr}, {nullptr, nullptr},
               1.0f, kInf, kInf};
}

}  // namespace

// img, fy, fx, out: (H, W) f32, contiguous.
extern "C" int v3d_warp(void* img, void* fy, void* fx, void* out, int H,
                        int W, int r, void* stream) {
  if ((long long)H * W == 0) return 0;
  EmaArgs a{};
  a.img = (const float*)img;
  a.fy = direct(fy, W);
  a.fx = direct(fx, W);
  a.alpha = direct(nullptr, W);
  a.out = (float*)out;
  a.H = H;
  a.W = W;
  a.r = r;
  a.mode = WARP;
  return launch(a, (cudaStream_t)stream);
}

// alpha_q (hq, wq) from g, prev_g and the final guide-scale flow fy, fx
// (all (hq, wq) f32, contiguous); the flow is clamped to [-rq, rq].
extern "C" int v3d_ema_guide(void* g, void* prev_g, void* fy, void* fx,
                             void* alpha_q, int hq, int wq, int rq,
                             float alpha_min, float gain, void* stream) {
  if ((long long)hq * wq == 0) return 0;
  EmaArgs a{};
  a.img = (const float*)prev_g;
  a.ref = (const float*)g;
  a.fy = direct(fy, wq);
  a.fx = direct(fx, wq);
  a.alpha = direct(nullptr, wq);
  a.out = (float*)alpha_q;
  a.H = hq;
  a.W = wq;
  a.r = rq;
  a.mode = GUIDE;
  a.alpha_min = alpha_min;
  a.gain = gain;
  return launch(a, (cudaStream_t)stream);
}

// The full-resolution step: depth, prev_out, out (H, W) f32; fy, fx,
// alpha_q (hq, wq) f32; the tap tables of hq -> H (ty_*) and wq -> W
// (tx_*); the flow clamped to [-rq, rq] at guide scale, times scale_y/x,
// then to [-max_warp, max_warp]. gate != 0 runs the head first: scratch
// holds a ticket word (0 between calls), the mean and one float per block
// of the 64x16 tiling.
extern "C" int v3d_ema_step(void* depth, void* prev_out, void* fy, void* fx,
                            void* alpha_q, void* out, int H, int W, int hq,
                            int wq, void* ty_idx, void* ty_w, void* tx_idx,
                            void* tx_w, float scale_y, float scale_x, int rq,
                            int max_warp, int gate, float t0, float gain_d,
                            void* scratch, void* stream) {
  if ((long long)H * W == 0) return 0;
  const Taps ty{(const int*)ty_idx, (const float*)ty_w};
  const Taps tx{(const int*)tx_idx, (const float*)tx_w};
  EmaArgs a{};
  a.img = (const float*)prev_out;
  a.ref = (const float*)depth;
  a.fy = Plane{(const float*)fy, wq, ty, tx, scale_y, (float)rq, kInf};
  a.fx = Plane{(const float*)fx, wq, ty, tx, scale_x, (float)rq, kInf};
  a.alpha = Plane{(const float*)alpha_q, wq, ty, tx, 1.0f, kInf, kInf};
  a.cap_f = cap_of(TW + 2 * BR + 2 * max_warp + 1, wq, W);
  a.cap_a = cap_of(TW, wq, W);
  a.out = (float*)out;
  a.ticket = (unsigned*)scratch;
  a.mean = (float*)scratch + 1;
  a.partial = (float*)scratch + 2;
  a.H = H;
  a.W = W;
  a.r = max_warp;
  a.gate = gate;
  a.t0 = t0;
  a.gain_d = gain_d;
  if (gate) {
    a.mode = HEAD;
    const int e = launch(a, (cudaStream_t)stream);
    if (e != 0) return e;
  }
  a.mode = TAIL;
  return launch(a, (cudaStream_t)stream);
}

// blocks of the 64x16 tiling of an (H, W) plane: the head's partial sums
extern "C" int v3d_ema_blocks(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}
