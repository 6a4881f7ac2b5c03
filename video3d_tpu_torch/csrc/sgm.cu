// Kernels B2, B3 and B8a: semi-global path sweeps and winner-take-all.
//
// Replace the TPU kernels video3d_tpu/kernels/sgm.py
// _directional_pass_dmajor (body _row_kernel_dmajor; B2, one sweep of the
// int16 volume with an int16 or f32 accumulator), sgm_wta_pallas_dmajor
// (body _final_wta_kernel_dmajor; B3, the closing vertical sweeps fused
// with WTA: top-down for MODE_SGBM, bottom-up for 4 and 8 paths) and
// _directional_pass (body _row_kernel; B8a, the sweeps of
// sgm_aggregate_pallas on an f32 or bf16 (B, H, W, D) cost with f32
// carries). The TPU walks a row-block grid in order with the carries in
// VMEM.
//
// What bounds them on the H100: each sweep reads the cost volume and
// read-modify-writes the accumulator (3 x 531 MB for two 1080p frames at
// D=64 in int16, ~0.5 ms at 3.35 TB/s; 5/3 of that with an f32
// accumulator), but every scan line is a serial chain of W or H dependent
// steps, each a min over D -- so latency of that chain, not bandwidth, is
// the first limit.
//
// Simple design: every SGM direction is a set of independent 1-D scan lines
// (rows for the horizontals, columns for the verticals, diagonal lines that
// start on the first row of the sweep or on the left/right edge -- the
// TPU's zero lateral fill). One warp owns one scan line, each lane DPL
// consecutive disparities, the carry in registers; the min over D is a
// __shfl_xor butterfly and the d-1/d+1 neighbours come over
// __shfl_up/down, with a sentinel past both ends of d. The next pixel's
// cost and accumulator are loaded before the current step is computed. One
// launch per direction read-modify-writes the accumulator; each pixel is
// touched once per launch, so there are no atomics.
//
// The kernel is one template over the cost type, the accumulator type and
// the compute type. An int16 cost computes in int32 (exact; an f32
// accumulator holds the integer totals exactly, as the TPU's f32 carries
// do), so the result does not depend on summation order. An f32 or bf16
// cost (B8a) computes in f32 with the TPU kernel's 1e9 sentinel and its
// order of operations, (c + best) - m and then acc + L, direction by
// direction in the TPU's order, so it rounds as the TPU kernel and the
// plain twin do.
//
// The WTA (second half of B3) is a separate per-row kernel over the int16 or
// f32 total: a block owns one image row, first computes the right-image WTA
// of that row into shared memory, then one warp per pixel takes the first
// minimum, the sub-pixel step in f32, the uniqueness test, the margin and
// the LR check. Totals are integers, held in int32 in registers. Fusing the
// last sweep with the WTA, as the TPU does, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SENT = 1 << 20;
constexpr float BIGF = 1e9f;
constexpr unsigned FULL = 0xffffffffu;

// type codes of the C interface
enum { T_I16 = 0, T_F32 = 1, T_BF16 = 2 };

__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }

template <typename C>
__device__ __forceinline__ C sentinel();
template <>
__device__ __forceinline__ int sentinel<int>() { return SENT; }
template <>
__device__ __forceinline__ float sentinel<float>() { return BIGF; }

template <typename C>
__device__ __forceinline__ C load(const int16_t* p, long long i) {
  return (C)p[i];
}
template <typename C>
__device__ __forceinline__ C load(const float* p, long long i) {
  return (C)p[i];  // an f32 accumulator of integer totals: exact in int
}
template <typename C>
__device__ __forceinline__ C load(const __nv_bfloat16* p, long long i) {
  return (C)__bfloat162float(p[i]);
}

template <typename C>
__device__ __forceinline__ C warp_min(C v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = vmin(v, __shfl_xor_sync(FULL, v, o));
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

// CT cost, AT accumulator, C compute type (int for int16 cost, else float)
template <typename CT, typename AT, typename C, int DPL>
__global__ void sweep_kernel(const CT* __restrict__ cost, const AT* acc_in,
                             AT* acc_out, int H, int W, int D, int dy, int dx,
                             C p1, C p2, int n_lines) {
  const int line = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (line >= n_lines) return;  // whole warps leave together
  const long long b = blockIdx.y;
  const C sent = sentinel<C>();
  int y, x, len;
  line_start(line, H, W, dy, dx, &y, &x, &len);

  C L[DPL], c[DPL], a[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    int d = lane * DPL + j;
    L[j] = d < D ? C(0) : sent;  // carries start at zero
    c[j] = C(0);
    a[j] = C(0);
  }
  long long base = ((b * H + y) * (long long)W + x) * D;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    int d = lane * DPL + j;
    if (d < D) {
      c[j] = load<C>(cost, base + d);
      if (acc_in) a[j] = load<C>(acc_in, base + d);
    }
  }
  for (int t = 0; t < len; ++t) {
    const long long next =
        ((b * H + (y + dy)) * (long long)W + (x + dx)) * D;
    C cn[DPL], an[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      cn[j] = C(0);
      an[j] = C(0);
      if (t + 1 < len && d < D) {
        cn[j] = load<C>(cost, next + d);
        if (acc_in) an[j] = load<C>(acc_in, next + d);
      }
    }
    C m = L[0];
#pragma unroll
    for (int j = 1; j < DPL; ++j) m = vmin(m, L[j]);
    m = warp_min(m);
    C below = __shfl_up_sync(FULL, L[DPL - 1], 1);
    C above = __shfl_down_sync(FULL, L[0], 1);
    if (lane == 0) below = sent;
    if (lane == 31) above = sent;
    C Ln[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      C dn = j > 0 ? L[j - 1] : below;
      C up = j < DPL - 1 ? L[j + 1] : above;
      C best = vmin(vmin(L[j], m + p2), vmin(up, dn) + p1);
      Ln[j] = d < D ? (c[j] + best) - m : sent;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      int d = lane * DPL + j;
      L[j] = Ln[j];
      if (d < D) acc_out[base + d] = (AT)(acc_in ? a[j] + Ln[j] : Ln[j]);
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

// grid (H, B); dynamic shared memory: W ints (right-image disparities).
// TT is int16_t or float (integer totals; exact in int32).
template <typename TT, int DPL>
__global__ void wta_kernel(const TT* __restrict__ total,
                           float* __restrict__ disp,
                           float* __restrict__ margin, int H, int W, int D,
                           int md, int uniq, int lr) {
  extern __shared__ int d_right[];
  const int y = blockIdx.x;
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const TT* row = total + (b * H + y) * (long long)W * D;
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
          int v = xx < W ? load<int>(row, (long long)xx * D + d) : SENT;
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
      v[j] = d < D ? load<int>(row, (long long)x * D + d) : SENT;
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

template <typename CT, typename AT, typename C, int DPL>
int launch_sweep(const void* cost, const void* acc_in, void* acc_out, int B,
                 int H, int W, int D, int dy, int dx, C p1, C p2,
                 cudaStream_t s) {
  int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const int warps = 8;
  dim3 grid((n_lines + warps - 1) / warps, B);
  sweep_kernel<CT, AT, C, DPL><<<grid, warps * 32, 0, s>>>(
      (const CT*)cost, (const AT*)acc_in, (AT*)acc_out, H, W, D, dy, dx, p1,
      p2, n_lines);
  return (int)cudaGetLastError();
}

template <typename CT, typename AT, typename C>
int sweep_dpl(const void* cost, const void* acc_in, void* acc_out, int B,
              int H, int W, int D, int dy, int dx, C p1, C p2,
              cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1:
      return launch_sweep<CT, AT, C, 1>(cost, acc_in, acc_out, B, H, W, D,
                                        dy, dx, p1, p2, s);
    case 2:
      return launch_sweep<CT, AT, C, 2>(cost, acc_in, acc_out, B, H, W, D,
                                        dy, dx, p1, p2, s);
    case 3:
      return launch_sweep<CT, AT, C, 3>(cost, acc_in, acc_out, B, H, W, D,
                                        dy, dx, p1, p2, s);
    case 4:
      return launch_sweep<CT, AT, C, 4>(cost, acc_in, acc_out, B, H, W, D,
                                        dy, dx, p1, p2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TT, int DPL>
int launch_wta(const void* total, float* disp, float* margin, int B, int H,
               int W, int D, int md, int uniq, int lr, cudaStream_t s) {
  size_t smem = sizeof(int) * (size_t)W;
  cudaError_t e = cudaFuncSetAttribute(
      wta_kernel<TT, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B);
  wta_kernel<TT, DPL><<<grid, 256, smem, s>>>((const TT*)total, disp, margin,
                                              H, W, D, md, uniq, lr);
  return (int)cudaGetLastError();
}

template <typename TT>
int wta_dpl(const void* total, float* disp, float* margin, int B, int H,
            int W, int D, int md, int uniq, int lr, cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch_wta<TT, 1>(total, disp, margin, B, H, W, D, md, uniq, lr, s);
    case 2: return launch_wta<TT, 2>(total, disp, margin, B, H, W, D, md, uniq, lr, s);
    case 3: return launch_wta<TT, 3>(total, disp, margin, B, H, W, D, md, uniq, lr, s);
    case 4: return launch_wta<TT, 4>(total, disp, margin, B, H, W, D, md, uniq, lr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One SGM direction (dy, dx) over the (B, H, W, D) cost, added into
// acc_out; acc_in is NULL for a fresh accumulation or equal to acc_out.
// (cost_type, acc_type): (int16, int16) and (int16, f32) compute in int32
// with whole penalties; (f32, f32) and (bf16, f32) compute in f32.
extern "C" int v3d_sgm_sweep(void* cost, void* acc_in, void* acc_out, int B,
                             int H, int W, int D, int dy, int dx, float p1,
                             float p2, int cost_type, int acc_type,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cost_type == T_I16 && acc_type == T_I16)
    return sweep_dpl<int16_t, int16_t, int>(cost, acc_in, acc_out, B, H, W,
                                            D, dy, dx, (int)p1, (int)p2, s);
  if (cost_type == T_I16 && acc_type == T_F32)
    return sweep_dpl<int16_t, float, int>(cost, acc_in, acc_out, B, H, W, D,
                                          dy, dx, (int)p1, (int)p2, s);
  if (cost_type == T_F32 && acc_type == T_F32)
    return sweep_dpl<float, float, float>(cost, acc_in, acc_out, B, H, W, D,
                                          dy, dx, p1, p2, s);
  if (cost_type == T_BF16 && acc_type == T_F32)
    return sweep_dpl<__nv_bfloat16, float, float>(cost, acc_in, acc_out, B, H,
                                                  W, D, dy, dx, p1, p2, s);
  return (int)cudaErrorInvalidValue;
}

// WTA of the (B, H, W, D) int16 or f32 (total_type) integer path total ->
// f32 disparity (B, H, W) and, when margin is not NULL, the f32 uniqueness
// margin.
extern "C" int v3d_sgm_wta(void* total, void* disp, void* margin, int B,
                           int H, int W, int D, int md, int uniq, int lr,
                           int total_type, void* stream) {
  float* dp = (float*)disp;
  float* mg = (float*)margin;
  cudaStream_t s = (cudaStream_t)stream;
  if (total_type == T_I16)
    return wta_dpl<int16_t>(total, dp, mg, B, H, W, D, md, uniq, lr, s);
  if (total_type == T_F32)
    return wta_dpl<float>(total, dp, mg, B, H, W, D, md, uniq, lr, s);
  return (int)cudaErrorInvalidValue;
}
