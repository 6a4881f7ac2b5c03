// Kernel B6: one pyramid level of the flow smoother's block matcher, with
// the level's warp (B5's formula) and the incoming flow's upsample inside.
//
// Replaces the TPU kernel video3d_tpu/kernels/flowmatch.py
// flow_match_pallas (body _match_kernel), which runs a whole level in one
// grid step from VMEM: for each of the (2s+1)^2 candidate shifts of the
// warped previous frame (edge-replicated), the border-clipped (2R+1)^2 SAD
// against the current frame divided by the true window area; a softargmin
// over the candidates; the residual smoothed by an area-normalised
// radius-2 box and added to the incoming flow. On the TPU the warp before
// it (kernels/warp.py) and the flow's upsample between levels are more
// calls inside one jitted scan; here they are in this launch.
//
// One launch computes, for the level step of ops/flow.py flow_level:
//   f   = clamp(resize2d(flow_in, h, w, "bilinear") * scale, +-r)
//         (zero with no incoming flow; flow_in itself at the same size)
//   pw  = warp(prev, f)                         (B5's two-tap warp)
//   out = f + box2(softargmin_residual(cur, pw)) / area2
// Mode "match" is the public flow_match: prev is already warped and the
// flow is taken as given (no clamp, no upsample).
//
// What bounds it on the H100: neither bytes nor operations at the
// smoother's sizes (<= 540x960: a few planes of <= 2 MB, ~0.1 GFLOP); a
// launch of a few hundred blocks, so latency: the number of launches per
// frame (now one per level step instead of a clamp pair, a warp and a
// match) and the block's chain of barriers.
//
// Design: one block of 256 threads per output tile, 32x16, 16x16 or 16x8
// (the largest whose grid still has a block per multiprocessor, so the
// coarse levels fill more of the card). The block stages `cur` with a
// zero halo of R + 2 by cp.async (zero-filled outside the image, as the
// clipped box needs) while it warps `prev` into a tile with an
// edge-clamped halo of s + R + 2 (a shifted read is then shift_edge). The
// residual is needed on the tile plus the smoothing box's halo of 2. Per
// row of 2s + 1 candidates, a thread walks a column down the region with a
// running (2R+1)-row sum, then a thread walks a row with a running
// (2R+1)-column sum and scales it by the pixel's inverse window area,
// computed once from its row and column counts; the 25 costs of each
// residual pixel stay in shared memory. Then two passes: the minimum, and
// one expf((cmin - c) / tau) per candidate, the twin's softmax (no online
// rescale). Two border rules are kept apart: candidate shifts replicate
// the image edge; both boxes are clipped at the image edge, not the
// tile's. The flow is held to the twin within 2e-4 px: the running sums,
// the upsample and the softmax's normalisation round in another order
// than the twin's cumulative sums and matmuls.

#include <cuda_runtime.h>

#include "flow_common.cuh"

namespace {

using v3dflow::clampi;
using v3dflow::Plane;
using v3dflow::Taps;
using v3dflow::win_count;

constexpr int NT = 256;  // threads per block
constexpr int SR = 2;    // radius of the residual smoothing box

struct Geom {
  int TW, TH, S, R, r, warp;
  __host__ __device__ int HC() const { return R + SR; }
  __host__ __device__ int HP() const { return S + R + SR; }
  __host__ __device__ int CW() const { return TW + 2 * HC(); }
  __host__ __device__ int CH() const { return TH + 2 * HC(); }
  __host__ __device__ int PW() const { return TW + 2 * HP(); }
  __host__ __device__ int PH() const { return TH + 2 * HP(); }
  __host__ __device__ int RW() const { return TW + 2 * SR; }
  __host__ __device__ int RH() const { return TH + 2 * SR; }
  __host__ __device__ int VW() const { return RW() + 2 * R; }
  __host__ __device__ int NX() const { return 2 * S + 1; }
  // costs of every candidate; at least two planes, which hold the
  // residual afterwards
  __host__ __device__ int cost_floats() const {
    const int nc = NX() * NX();
    return (nc < 2 ? 2 : nc) * RH() * RW();
  }
  __host__ __device__ int vsum_floats() const { return NX() * RH() * VW(); }
  __host__ __device__ int mid_floats() const {
    return warp ? PH() * (PW() + 2 * r + 1) : 0;
  }
  // cur | prev | inverse areas | costs + vertical sums (the warp's mid
  // rows before them)
  __host__ __device__ int work_floats() const {
    const int a = cost_floats() + vsum_floats(), b = mid_floats();
    return a > b ? a : b;
  }
  __host__ __device__ size_t floats() const {
    return (size_t)CH() * CW() + (size_t)PH() * PW() +
           (size_t)RH() * RW() + work_floats();
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;  // 0: fill the word with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// grid (ceil(W / TW), ceil(H / TH)), block NT
__global__ void __launch_bounds__(NT)
    level_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                 Plane fy, Plane fx, float* __restrict__ oy,
                 float* __restrict__ ox, int H, int W, Geom g, float inv_tau) {
  extern __shared__ float smem[];
  const int TW = g.TW, TH = g.TH, S = g.S, R = g.R;
  const int HC = g.HC(), HP = g.HP(), CW = g.CW(), CH = g.CH();
  const int PW = g.PW(), PH = g.PH(), RW = g.RW(), RH = g.RH();
  const int VW = g.VW(), NX = g.NX(), NR = RH * RW;
  float* cur_s = smem;             // CH x CW, zero outside the image
  float* prev_s = cur_s + CH * CW;  // PH x PW, edge-clamped
  float* inv_a = prev_s + PH * PW;  // NR: 1 / window area, 0 outside
  float* cs = inv_a + NR;           // candidates x NR costs
  float* vs = cs + g.cost_floats();  // NX x RH x VW vertical sums
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;

  for (int i = tid; i < CH * CW; i += NT) {
    const int yy = y0 - HC + i / CW, xx = x0 - HC + i % CW;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    cp_async4(cur_s + i, in ? cur + (long long)yy * W + xx : cur, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  if (g.warp) {
    const v3dflow::Staged sy{fy, nullptr, 0, 0}, sx{fx, nullptr, 0, 0};
    v3dflow::warp_region(prev, H, W, y0 - HP, x0 - HP, PH, PW, g.r, sy, sx,
                         cs, prev_s);
  } else {
    for (int i = tid; i < PH * PW; i += NT) {
      const int yy = clampi(y0 - HP + i / PW, 0, H - 1);
      const int xx = clampi(x0 - HP + i % PW, 0, W - 1);
      prev_s[i] = prev[(long long)yy * W + xx];
    }
  }
  for (int p = tid; p < NR; p += NT) {
    const int gy = y0 - SR + p / RW, gx = x0 - SR + p % RW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    inv_a[p] = in ? 1.0f / (float)(win_count(gy, H, R) * win_count(gx, W, R))
                  : 0.0f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int dyi = 0; dyi < NX; ++dyi) {
    const int dy = dyi - S;
    // a column of |cur - cand| down the region, running (2R+1)-row sums
    for (int item = tid; item < NX * VW; item += NT) {
      const int dxi = item / VW, c = item - dxi * VW;
      const int gx = x0 - SR - R + c;
      const bool col_in = gx >= 0 && gx < W;
      const float* cc = cur_s + c;                       // row yy - (y0 - HC)
      const float* pc = prev_s + c + S + (dxi - S) +     // row yy + dy
                        (dy + HP - HC) * PW;             //   - (y0 - HP)
      auto d = [&](int j) {  // |cur - cand| at region row j of cur_s
        const int yy = y0 - HC + j;
        return (col_in && yy >= 0 && yy < H)
                   ? fabsf(cc[j * CW] - pc[j * PW])
                   : 0.0f;
      };
      float s = 0.0f;
      for (int t = 0; t <= 2 * R; ++t) s += d(t);
      float* out = vs + dxi * RH * VW + c;
      out[0] = s;
      for (int j = 1; j < RH; ++j) {
        s = s + d(j + 2 * R) - d(j - 1);
        out[j * VW] = s;
      }
    }
    __syncthreads();
    // a row of vertical sums, running (2R+1)-column sums, over the area
    for (int item = tid; item < NX * RH; item += NT) {
      const int dxi = item / RH, j = item - dxi * RH;
      const float* v = vs + (dxi * RH + j) * VW;
      float* out = cs + (dyi * NX + dxi) * NR + j * RW;
      const float* ia = inv_a + j * RW;
      float s = 0.0f;
      for (int u = 0; u <= 2 * R; ++u) s += v[u];
      out[0] = s * ia[0];
      for (int i = 1; i < RW; ++i) {
        s = s + v[i + 2 * R] - v[i - 1];
        out[i] = s * ia[i];
      }
    }
    __syncthreads();
  }

  // softargmin of each residual pixel: the minimum, then one exp per
  // candidate; the residual overwrites the pixel's first two costs
  const int nc = NX * NX;
  for (int p = tid; p < NR; p += NT) {
    float ry = 0.0f, rx = 0.0f;
    if (inv_a[p] != 0.0f) {
      float cmin = cs[p];
      for (int k = 1; k < nc; ++k) cmin = fminf(cmin, cs[k * NR + p]);
      float sw = 0.0f, sy = 0.0f, sx = 0.0f;
      for (int k = 0; k < nc; ++k) {
        const float e = expf((cmin - cs[k * NR + p]) * inv_tau);
        sw += e;
        sy += e * (float)(k / NX - S);
        sx += e * (float)(k % NX - S);
      }
      ry = sy / sw;
      rx = sx / sw;
    }
    cs[p] = ry;
    cs[NR + p] = rx;
  }
  __syncthreads();

  const float* ry_s = cs;
  const float* rx_s = cs + NR;
  for (int p = tid; p < TW * TH; p += NT) {
    const int ty = p / TW, tx = p - ty * TW;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    float sy = 0.0f, sx = 0.0f;
    for (int a = 0; a <= 2 * SR; ++a) {
      const int row = (ty + a) * RW + tx;
      for (int b = 0; b <= 2 * SR; ++b) {
        sy += ry_s[row + b];
        sx += rx_s[row + b];
      }
    }
    const float area = (float)(win_count(y, H, SR) * win_count(x, W, SR));
    const long long idx = (long long)y * W + x;
    oy[idx] = v3dflow::plane_at(fy, y, x) + sy / area;
    ox[idx] = v3dflow::plane_at(fx, y, x) + sx / area;
  }
}

}  // namespace

// One level step. cur, prev, oy, ox: (H, W) f32, contiguous. mode 0: the
// public match (prev already warped, fy/fx (H, W) taken as given); mode
// 1: the level step with no incoming flow; mode 2: with fy/fx at
// (hin, win) read through the tap tables (rows ty_idx/ty_w, columns
// tx_idx/tx_w; identity tables at the same size), times scale_y/x, both
// clamped to [-r, r]. Returns a CUDA error code (cudaErrorInvalidValue if
// the tile does not fit in shared memory).
extern "C" int v3d_flow_level(void* cur, void* prev, void* fy, void* fx,
                              void* oy, void* ox, int H, int W, int win,
                              void* ty_idx, void* ty_w, void* tx_idx,
                              void* tx_w, float scale_y, float scale_x,
                              int mode, int r, int search, int radius,
                              float inv_tau, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaError_t e = cudaDeviceGetAttribute(
        &n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(level_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles[3][2] = {{32, 16}, {16, 16}, {16, 8}};
  int t = 0;
  while (t < 2 && (long long)((W + tiles[t][0] - 1) / tiles[t][0]) *
                          ((H + tiles[t][1] - 1) / tiles[t][1]) <
                      n_sm)
    ++t;
  const Geom g{tiles[t][0], tiles[t][1], search, radius, r, mode != 0};
  const size_t smem = g.floats() * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const float inf = __builtin_huge_valf();
  const float lim = mode == 0 ? inf : (float)r;
  Plane py{mode == 1 ? nullptr : (const float*)fy, mode == 2 ? win : W,
           {nullptr, nullptr}, {nullptr, nullptr}, scale_y, inf, lim};
  Plane px{mode == 1 ? nullptr : (const float*)fx, py.w,
           {nullptr, nullptr}, {nullptr, nullptr}, scale_x, inf, lim};
  if (mode == 2) {
    const Taps ty{(const int*)ty_idx, (const float*)ty_w};
    const Taps tx{(const int*)tx_idx, (const float*)tx_w};
    py.ty = px.ty = ty;
    py.tx = px.tx = tx;
  }
  dim3 grid((W + g.TW - 1) / g.TW, (H + g.TH - 1) / g.TH);
  level_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, py, px, (float*)oy, (float*)ox,
      H, W, g, inv_tau);
  return (int)cudaGetLastError();
}
