// Kernel B1: x-Sobel prefilter + symmetric Birchfield-Tomasi cost + box sum.
//
// Replaces the TPU kernel video3d_tpu/kernels/costvol.py fused_cost_volume
// (body _cost_kernel / _cost_row_step), which streams image rows through a
// VMEM ring so the raw per-pixel cost never reaches HBM.
//
// What bounds it on the H100: the int16 output, B*H*W*D*2 bytes (531 MB for
// two 1080p frames at D=64), written once -- about 0.16 ms at 3.35 TB/s --
// against ~25 BT evaluations per output if the box sum were taken directly.
//
// Simple design: a tiny prefilter kernel writes the two filtered eyes to a
// scratch buffer as exact int16 integers. The cost kernel gives each block
// one output row y and TX columns: it stages the BT envelopes of the
// (2*pad+1) input rows it needs in shared memory, computes the raw cost of
// that window once per (row, column, d) into shared memory, sums it
// vertically, then horizontally. Threads run along d, so the (B, H, W, D)
// output with d contiguous is written coalesced. All cost arithmetic is in
// integers at 2x scale (every BT cost is a multiple of 1/2), so the 25-term
// sum is exact; the final halving rounds half to even like jnp.round.
// Rows and columns outside the image count zero (zero-padded box).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void prefilter_kernel(const float* __restrict__ left,
                                 const float* __restrict__ right,
                                 int16_t* __restrict__ lf,
                                 int16_t* __restrict__ rf, int B, int H,
                                 int W, float cap) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long n = (long long)B * H * W;
  if (i >= n) return;
  const float* g = blockIdx.y == 0 ? left : right;
  int16_t* out = blockIdx.y == 0 ? lf : rf;
  int x = (int)(i % W);
  long long t = i / W;
  int y = (int)(t % H);
  long long b = t / H;
  const float* img = g + b * H * W;
  int ym = max(y - 1, 0), yp = min(y + 1, H - 1);
  int xm = max(x - 1, 0), xp = min(x + 1, W - 1);
  // same association as xsobel_clip: (top + 2*mid) + bottom
  float top = img[(long long)ym * W + xp] - img[(long long)ym * W + xm];
  float mid = img[(long long)y * W + xp] - img[(long long)y * W + xm];
  float bot = img[(long long)yp * W + xp] - img[(long long)yp * W + xm];
  float dx = (top + 2.0f * mid) + bot;
  dx = fminf(fmaxf(dx, -cap), cap);
  out[i] = (int16_t)(rintf(dx) + cap);  // rintf: half to even
}

// 2x-scaled BT envelope of pixel x of an int16 row: (2v, lo2, hi2).
__device__ __forceinline__ void envelope(const int16_t* row, int x, int W,
                                         int* v2, int* lo2, int* hi2) {
  int v = row[x];
  int pv = row[max(x - 1, 0)];
  int nv = row[min(x + 1, W - 1)];
  int ml = v + pv, mr = v + nv;
  *v2 = 2 * v;
  *lo2 = min(min(ml, mr), 2 * v);
  *hi2 = max(max(ml, mr), 2 * v);
}

// grid (ceil(W/TX), H, B); dynamic shared memory laid out below.
__global__ void cost_kernel(const int16_t* __restrict__ lf,
                            const int16_t* __restrict__ rf,
                            int16_t* __restrict__ out, int H, int W, int D,
                            int min_d, int pad, int inv2, int TX) {
  extern __shared__ int smem[];
  const int R = 2 * pad + 1;
  const int C = TX + 2 * pad;       // staged output-window columns
  const int CR = C + D - 1;         // staged right-image columns
  const int y = blockIdx.y;
  const long long b = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int xl0 = x0 - pad;               // left column of smem col 0
  const int xr0 = xl0 - (D - 1) - min_d;  // right column of smem col 0

  int* lenv = smem;                 // [3][R][C]
  int* renv = lenv + 3 * R * C;     // [3][R][CR]
  int* vs = renv + 3 * R * CR;      // [C][D] vertical sums
  int16_t* raw = (int16_t*)(vs + C * D);  // [R][C][D]

  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    int r = i / C, c = i % C;
    int yy = y - pad + r, xx = xl0 + c;
    int v2 = 0, lo2 = 0, hi2 = 0;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      envelope(lf + (b * H + yy) * W, xx, W, &v2, &lo2, &hi2);
    lenv[(0 * R + r) * C + c] = v2;
    lenv[(1 * R + r) * C + c] = lo2;
    lenv[(2 * R + r) * C + c] = hi2;
  }
  for (int i = threadIdx.x; i < R * CR; i += blockDim.x) {
    int r = i / CR, c = i % CR;
    int yy = y - pad + r, xs = xr0 + c;
    int v2 = 0, lo2 = 0, hi2 = 0;
    if (yy >= 0 && yy < H && xs >= 0 && xs < W)
      envelope(rf + (b * H + yy) * W, xs, W, &v2, &lo2, &hi2);
    renv[(0 * R + r) * CR + c] = v2;
    renv[(1 * R + r) * CR + c] = lo2;
    renv[(2 * R + r) * CR + c] = hi2;
  }
  __syncthreads();

  // raw 2x-scaled cost of every (row, column, d) of the window
  for (int i = threadIdx.x; i < R * C * D; i += blockDim.x) {
    int d = i % D;
    int c = (i / D) % C;
    int r = i / (D * C);
    int yy = y - pad + r, xx = xl0 + c;
    int v = 0;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      if (xx - d - min_d < 0) {
        v = inv2;
      } else {
        int cr = c + (D - 1) - d;
        int l2 = lenv[(0 * R + r) * C + c];
        int llo = lenv[(1 * R + r) * C + c];
        int lhi = lenv[(2 * R + r) * C + c];
        int r2 = renv[(0 * R + r) * CR + cr];
        int rlo = renv[(1 * R + r) * CR + cr];
        int rhi = renv[(2 * R + r) * CR + cr];
        int d_lr = max(0, max(l2 - rhi, rlo - l2));
        int d_rl = max(0, max(r2 - lhi, llo - r2));
        v = min(d_lr, d_rl);
      }
    }
    raw[i] = (int16_t)v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < C * D; i += blockDim.x) {
    int s = 0;
    for (int r = 0; r < R; ++r) s += raw[r * C * D + i];
    vs[i] = s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TX * D; i += blockDim.x) {
    int d = i % D;
    int c = i / D;
    int x = x0 + c;
    if (x >= W) continue;
    int s2 = 0;
    for (int k = 0; k < R; ++k) s2 += vs[(c + k) * D + d];
    int q = s2 >> 1;
    if ((s2 & 1) && (q & 1)) ++q;  // half to even (s2 >= 0)
    out[((b * H + y) * (long long)W + x) * D + d] = (int16_t)q;
  }
}

size_t cost_smem_bytes(int TX, int pad, int D) {
  int R = 2 * pad + 1, C = TX + 2 * pad, CR = C + D - 1;
  return sizeof(int) * (3 * R * C + 3 * R * CR + C * D) +
         sizeof(int16_t) * (size_t)R * C * D;
}

}  // namespace

extern "C" int v3d_prefilter(void* left, void* right, void* lf, void* rf,
                             int B, int H, int W, float cap, void* stream) {
  long long n = (long long)B * H * W;
  dim3 grid((unsigned)((n + 255) / 256), 2);
  prefilter_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)right, (int16_t*)lf, (int16_t*)rf, B,
      H, W, cap);
  return (int)cudaGetLastError();
}

extern "C" int v3d_cost_volume(void* lf, void* rf, void* out, int B, int H,
                               int W, int D, int min_d, int block_size,
                               int inv2, void* stream) {
  int pad = block_size / 2;
  int TX = 32;
  const size_t limit = 200 * 1024;
  while (TX > 1 && cost_smem_bytes(TX, pad, D) > limit) TX /= 2;
  size_t smem = cost_smem_bytes(TX, pad, D);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TX - 1) / TX, H, B);
  cost_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int16_t*)lf, (const int16_t*)rf, (int16_t*)out, H, W, D, min_d,
      pad, inv2, TX);
  return (int)cudaGetLastError();
}
