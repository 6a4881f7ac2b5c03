// Kernels B2 and B3: semi-global path sweeps and winner-take-all.
//
// Replace the TPU kernels video3d_tpu/kernels/sgm.py
// _directional_pass_dmajor (body _row_kernel_dmajor; B2, the two horizontal
// sweeps) and sgm_wta_pallas_dmajor (body _final_wta_kernel_dmajor; B3, the
// top-down vertical + two diagonal sweeps fused with WTA). The TPU walks a
// row-block grid in order with the carries in VMEM.
//
// What bounds them on the H100: each sweep reads the int16 cost volume and
// read-modify-writes the int16 accumulator (3 x 531 MB for two 1080p frames
// at D=64, ~0.5 ms at 3.35 TB/s), but every scan line is a serial chain of
// W or H dependent steps, each a min over D -- so latency of that chain,
// not bandwidth, is the first limit.
//
// Simple design: every SGM direction is a set of independent 1-D scan lines
// (rows for the horizontals, columns for the vertical, diagonal lines that
// start on the top row or on the left/right edge -- the TPU's zero lateral
// fill). One warp owns one scan line, each lane DPL consecutive
// disparities, the carry in registers; the min over D is a __shfl_xor
// butterfly and the d-1/d+1 neighbours come over __shfl_up/down, with a
// sentinel past both ends of d. The next pixel's cost and accumulator are
// loaded before the current step is computed. One launch per direction
// read-modify-writes the accumulator; each pixel is touched once per launch,
// so there are no atomics. Path values are integers (int32 in registers,
// int16 in memory, exact by the bound of acc_dtype_for_params), so the
// result does not depend on summation order.
//
// The WTA (second half of B3) is a separate per-row kernel: a block owns one
// image row, first computes the right-image WTA of that row into shared
// memory, then one warp per pixel takes the first minimum, the sub-pixel
// step in f32, the uniqueness test, the margin and the LR check. Fusing the
// last sweep with the WTA, as the TPU does, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SENT = 1 << 20;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// First pixel and length of scan line i for the step (dy, dx).
__device__ __forceinline__ void line_start(int i, int H, int W, int dy,
                                           int dx, int* y, int* x,
                                           int* len) {
  if (dy == 0) {
    *y = i;
    *x = dx > 0 ? 0 : W - 1;
    *len = W;
    return;
  }
  if (dx == 0) {
    *x = i;
    *y = dy > 0 ? 0 : H - 1;
    *len = H;
    return;
  }
  if (i < W) {
    *x = i;
    *y = dy > 0 ? 0 : H - 1;
  } else {
    int k = i - W + 1;
    *x = dx > 0 ? 0 : W - 1;
    *y = dy > 0 ? k : H - 1 - k;
  }
  int ylen = dy > 0 ? H - *y : *y + 1;
  int xlen = dx > 0 ? W - *x : *x + 1;
  *len = min(ylen, xlen);
}

template <int DPL>
__global__ void sweep_kernel(const int16_t* __restrict__ cost,
                             const int16_t* acc_in, int16_t* acc_out, int H,
                             int W, int D, int dy, int dx, int p1, int p2,
                             int n_lines) {
  const int line = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (line >= n_lines) return;  // whole warps leave together
  const long long b = blockIdx.y;
  int y, x, len;
  line_start(line, H, W, dy, dx, &y, &x, &len);

  int L[DPL], c[DPL], a[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    int d = lane * DPL + j;
    L[j] = d < D ? 0 : SENT;  // carries start at zero
    c[j] = 0;
    a[j] = 0;
  }
  long long base = ((b * H + y) * (long long)W + x) * D;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    int d = lane * DPL + j;
    if (d < D) {
      c[j] = cost[base + d];
      if (acc_in) a[j] = acc_in[base + d];
    }
  }
  for (int t = 0; t < len; ++t) {
    const long long next =
        ((b * H + (y + dy)) * (long long)W + (x + dx)) * D;
    int cn[DPL], an[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      cn[j] = 0;
      an[j] = 0;
      if (t + 1 < len && d < D) {
        cn[j] = cost[next + d];
        if (acc_in) an[j] = acc_in[next + d];
      }
    }
    int m = L[0];
#pragma unroll
    for (int j = 1; j < DPL; ++j) m = min(m, L[j]);
    m = warp_min(m);
    int below = __shfl_up_sync(FULL, L[DPL - 1], 1);
    int above = __shfl_down_sync(FULL, L[0], 1);
    if (lane == 0) below = SENT;
    if (lane == 31) above = SENT;
    int Ln[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      int dn = j > 0 ? L[j - 1] : below;
      int up = j < DPL - 1 ? L[j + 1] : above;
      int best = min(min(L[j], m + p2), min(up, dn) + p1);
      Ln[j] = d < D ? c[j] + best - m : SENT;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      L[j] = Ln[j];
      if (d < D) acc_out[base + d] = (int16_t)(a[j] + Ln[j]);
      c[j] = cn[j];
      a[j] = an[j];
    }
    base = next;
    y += dy;
    x += dx;
  }
}

// value v[d % DPL] of the lane that owns disparity d
template <int DPL>
__device__ __forceinline__ int value_at(const int* v, int d) {
  int j = d % DPL, sel = v[0];
#pragma unroll
  for (int k = 1; k < DPL; ++k)
    if (k == j) sel = v[k];
  return __shfl_sync(FULL, sel, d / DPL);
}

// grid (H, B); dynamic shared memory: W ints (right-image disparities)
template <int DPL>
__global__ void wta_kernel(const int16_t* __restrict__ total,
                           float* __restrict__ disp,
                           float* __restrict__ margin, int H, int W, int D,
                           int md, int uniq, int lr) {
  extern __shared__ int d_right[];
  const int y = blockIdx.x;
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int16_t* row = total + (b * H + y) * (long long)W * D;
  const long long orow = (b * H + y) * (long long)W;

  if (lr >= 0) {
    // right-image WTA: first minimum over d of total[d, xr + d + md];
    // hypotheses past the right edge are invalid (key = SENT)
    for (int xr = warp; xr < W; xr += nw) {
      int key = SENT * 256 + 255;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        int d = lane * DPL + j;
        if (d < D) {
          int xx = xr + d + md;
          int v = xx < W ? (int)row[(long long)xx * D + d] : SENT;
          key = min(key, v * 256 + d);
        }
      }
      key = warp_min(key);
      if (lane == 0) d_right[xr] = key & 255;
    }
    __syncthreads();
  }

  for (int x = warp; x < W; x += nw) {
    int v[DPL];
    int key = SENT * 256 + 255;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      v[j] = d < D ? (int)row[(long long)x * D + d] : SENT;
      if (d < D) key = min(key, v[j] * 256 + d);
    }
    key = warp_min(key);  // first minimum wins ties
    const int s_min = key >> 8, d_int = key & 255;
    const int s_m1 = value_at<DPL>(v, d_int > 0 ? d_int - 1 : 0);
    const int s_p1 = value_at<DPL>(v, d_int < D - 1 ? d_int + 1 : D - 1);
    int sec = SENT;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      if (d < D && abs(d - d_int) > 1) sec = min(sec, v[j]);
    }
    sec = warp_min(sec);
    if (lane != 0) continue;

    const float fs = (float)s_min, fm1 = (float)s_m1, fp1 = (float)s_p1;
    const float denom = (fm1 + fp1) - 2.0f * fs;
    float sub = denom > 1e-6f ? (fm1 - fp1) / (2.0f * denom + 1e-12f) : 0.0f;
    sub = fminf(fmaxf(sub, -0.5f), 0.5f);
    if (d_int == 0 || d_int == D - 1) sub = 0.0f;
    const float dval = ((float)d_int + sub) + (float)md;
    bool valid = x >= md + D;
    const float second = sec == SENT ? 1e9f : (float)sec;
    if (uniq > 0) valid = valid && (second * 100.0f >= fs * (100.0f + uniq));
    if (margin) margin[orow + x] = fmaxf(second - fs, 0.0f) / (fs + 1.0f);
    if (lr >= 0) {
      const float dl = dval - (float)md;
      int dr = (int)rintf(dl);  // half to even, like jnp.round
      dr = min(max(dr, 0), D - 1);
      const int xr = x - md - dr;
      valid = valid && xr >= 0 &&
              fabsf(dl - (float)d_right[max(xr, 0)]) <= (float)lr;
    }
    disp[orow + x] = valid ? dval : (float)(md - 1);
  }
}

template <int DPL>
int launch_sweep(const int16_t* cost, const int16_t* acc_in,
                 int16_t* acc_out, int B, int H, int W, int D, int dy,
                 int dx, int p1, int p2, cudaStream_t s) {
  int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const int warps = 8;
  dim3 grid((n_lines + warps - 1) / warps, B);
  sweep_kernel<DPL><<<grid, warps * 32, 0, s>>>(cost, acc_in, acc_out, H, W,
                                                D, dy, dx, p1, p2, n_lines);
  return (int)cudaGetLastError();
}

template <int DPL>
int launch_wta(const int16_t* total, float* disp, float* margin, int B,
               int H, int W, int D, int md, int uniq, int lr,
               cudaStream_t s) {
  size_t smem = sizeof(int) * (size_t)W;
  cudaError_t e = cudaFuncSetAttribute(
      wta_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B);
  wta_kernel<DPL><<<grid, 256, smem, s>>>(total, disp, margin, H, W, D, md,
                                          uniq, lr);
  return (int)cudaGetLastError();
}

}  // namespace

// One SGM direction (dy, dx) over the (B, H, W, D) int16 cost, added into
// acc_out; acc_in is NULL for a fresh accumulation or equal to acc_out.
extern "C" int v3d_sgm_sweep(void* cost, void* acc_in, void* acc_out, int B,
                             int H, int W, int D, int dy, int dx, int p1,
                             int p2, void* stream) {
  const int16_t* c = (const int16_t*)cost;
  const int16_t* ai = (const int16_t*)acc_in;
  int16_t* ao = (int16_t*)acc_out;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return launch_sweep<1>(c, ai, ao, B, H, W, D, dy, dx, p1, p2, s);
    case 2: return launch_sweep<2>(c, ai, ao, B, H, W, D, dy, dx, p1, p2, s);
    case 3: return launch_sweep<3>(c, ai, ao, B, H, W, D, dy, dx, p1, p2, s);
    case 4: return launch_sweep<4>(c, ai, ao, B, H, W, D, dy, dx, p1, p2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// WTA of the (B, H, W, D) int16 path total -> f32 disparity (B, H, W) and,
// when margin is not NULL, the f32 uniqueness margin.
extern "C" int v3d_sgm_wta(void* total, void* disp, void* margin, int B,
                           int H, int W, int D, int md, int uniq, int lr,
                           void* stream) {
  const int16_t* t = (const int16_t*)total;
  float* dp = (float*)disp;
  float* mg = (float*)margin;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return launch_wta<1>(t, dp, mg, B, H, W, D, md, uniq, lr, s);
    case 2: return launch_wta<2>(t, dp, mg, B, H, W, D, md, uniq, lr, s);
    case 3: return launch_wta<3>(t, dp, mg, B, H, W, D, md, uniq, lr, s);
    case 4: return launch_wta<4>(t, dp, mg, B, H, W, D, md, uniq, lr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
