// Kernel B1: x-Sobel prefilter + symmetric Birchfield-Tomasi cost + box sum.
//
// Replaces the TPU kernel video3d_tpu/kernels/costvol.py fused_cost_volume
// (body _cost_kernel / _cost_row_step), which streams image rows through a
// VMEM ring so the raw per-pixel cost never reaches HBM and is computed
// once.
//
// What bounds it on the H100: the int16 output, B*H*W*D*2 bytes (265 MB a
// 1080p frame at D=64), written once -- about 0.08 ms at 3.35 TB/s. The
// arithmetic is ~25 integer operations and ~15 shared-memory accesses per
// output when every raw cost is computed once; a block that recomputes its
// whole window per output row pays five times that.
//
// Design: a tiny prefilter kernel writes the two filtered eyes to a scratch
// buffer as exact int16 integers. The cost kernel gives each block a strip
// of TX columns of one frame and a segment of rows, and walks down the
// rows. For each input row it stages the BT envelopes of the columns it
// needs in shared memory, computes the raw 2x-scaled cost of its
// (TX + 2*pad) x D window once, sums it horizontally over the 2*pad+1
// window and keeps the last 2*pad+1 such row sums in a shared-memory ring.
// The vertical sum is a running one held in registers: add the row that
// enters, subtract the row that leaves. So no raw cost of a (row, column,
// d) is computed more than once per segment; only the 2*pad warm-up rows
// above a segment repeat the work of the segment before it. All cost
// arithmetic is in integers at 2x scale (every BT cost is a multiple of
// 1/2), so the running sum is exact; the final halving rounds half to even
// like jnp.round. Rows and columns outside the image count zero
// (zero-padded box). A strip's TX x D outputs of one row are contiguous in
// the (B, H, W, D) volume, so threads run along that run and store VEC
// adjacent disparities (up to 16 bytes) at once.

#include <cuda_runtime.h>
#include <limits.h>
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

constexpr int NT = 256;    // threads of a cost block
constexpr int ITEMS = 16;  // most outputs a thread owns: TX * D / NT
constexpr int SEG_ROWS = 64;  // rows of a segment at pad <= 2
constexpr int OUTSIDE = INT_MIN;  // lenv.w of a column outside the image

__host__ __device__ inline size_t round8(size_t n) {
  return (n + 7) & ~(size_t)7;
}

// VEC adjacent uint16 values moved as one 2*VEC-byte word
template <int VEC>
struct Pack;
template <>
struct Pack<1> { typedef uint16_t T; };
template <>
struct Pack<2> { typedef uint32_t T; };
template <>
struct Pack<4> { typedef uint2 T; };
template <>
struct Pack<8> { typedef uint4 T; };

template <int VEC>
union Vec {
  typename Pack<VEC>::T word;
  uint16_t v[VEC];
};

// grid (ceil(W/TX), ceil(H/seg_h), B), NT threads; dynamic shared memory
// laid out below. VEC divides D.
template <int VEC>
__global__ void __launch_bounds__(NT)
cost_kernel(const int16_t* __restrict__ lf, const int16_t* __restrict__ rf,
            int16_t* __restrict__ out, int H, int W, int D, int min_d,
            int pad, int inv2, int TX, int seg_h) {
  extern __shared__ uint4 smem_raw[];
  const int R = 2 * pad + 1;
  const int C = TX + 2 * pad;  // staged window columns
  const int CR = C + D - 1;    // staged right-image columns
  const int n_out = TX * D;    // outputs of the strip per row
  const long long b = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * seg_h;
  const int y1 = min(y0 + seg_h, H);
  const int xl0 = x0 - pad;               // left column of window col 0
  const int xr0 = xl0 - (D - 1) - min_d;  // right column of renv col 0

  // ring [R][n_out] and raw [C][D] as uint16 (a row sum stays below 2^16
  // because the wrapper bounds the box total), then the envelopes
  uint16_t* ring = (uint16_t*)smem_raw;
  uint16_t* raw = ring + round8((size_t)R * n_out);
  int4* lenv = (int4*)(raw + round8((size_t)C * D));  // [C]
  int* renv = (int*)(lenv + C);                                    // [3][CR]

  int vs[ITEMS];  // running vertical sums of the outputs this thread owns
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) vs[k] = 0;

  int slot = 0;
  for (int yy = y0 - pad; yy < y1 + pad; ++yy) {
    const bool row_in = yy >= 0 && yy < H;
    if (row_in) {
      const int16_t* lrow = lf + (b * H + yy) * W;
      const int16_t* rrow = rf + (b * H + yy) * W;
      for (int i = threadIdx.x; i < C + CR; i += NT) {
        int v2 = 0, lo2 = 0, hi2 = 0;
        if (i < C) {
          int xx = xl0 + i;
          bool in = xx >= 0 && xx < W;
          if (in) envelope(lrow, xx, W, &v2, &lo2, &hi2);
          lenv[i] = make_int4(v2, lo2, hi2, in ? xx - min_d : OUTSIDE);
        } else {
          int c = i - C, xs = xr0 + c;
          if (xs >= 0 && xs < W) envelope(rrow, xs, W, &v2, &lo2, &hi2);
          renv[c] = v2;
          renv[CR + c] = lo2;
          renv[2 * CR + c] = hi2;
        }
      }
      __syncthreads();
      // raw 2x-scaled cost of every (column, d) of the window, once
      int c = threadIdx.x / D, d = threadIdx.x % D;
      const int dc = NT / D, dd = NT % D;
      for (int i = threadIdx.x; i < C * D; i += NT) {
        const int4 l = lenv[c];  // w: x - min_d, or OUTSIDE
        int v = 0;
        if (l.w != OUTSIDE) {
          if (l.w - d < 0) {
            v = inv2;
          } else {
            int cr = c + (D - 1) - d;
            int r2 = renv[cr], rlo = renv[CR + cr], rhi = renv[2 * CR + cr];
            int d_lr = max(0, max(l.x - rhi, rlo - l.x));
            int d_rl = max(0, max(r2 - l.z, l.y - r2));
            v = min(d_lr, d_rl);
          }
        }
        raw[i] = (uint16_t)v;
        c += dc;
        d += dd;
        if (d >= D) {
          d -= D;
          ++c;
        }
      }
      __syncthreads();
    }
    // horizontal window sum of the new row into the ring, running vertical
    // sum, and the output row yy - pad
    const int y = yy - pad;
    const bool leaving = yy - R >= y0 - pad;  // the slot holds row yy - R
    const bool emit = y >= y0;
    uint16_t* rs = ring + (size_t)slot * n_out;
    int16_t* orow = out + ((b * H + y) * (long long)W + x0) * D;
    const int n_in = min(TX, W - x0) * D;  // outputs inside the image
#pragma unroll
    for (int k = 0; k < ITEMS / VEC; ++k) {
      const int e = (k * NT + threadIdx.x) * VEC;
      if (e < n_out) {
        int hs[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) hs[j] = 0;
        if (row_in) {
          for (int w = 0; w < R; ++w) {
            Vec<VEC> t;
            t.word = *(const typename Pack<VEC>::T*)(raw + e + w * D);
#pragma unroll
            for (int j = 0; j < VEC; ++j) hs[j] += t.v[j];
          }
        }
        Vec<VEC> old, cur, q;
        if (leaving) old.word = *(const typename Pack<VEC>::T*)(rs + e);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          cur.v[j] = (uint16_t)hs[j];
          int s2 = vs[k * VEC + j] + hs[j] - (leaving ? (int)old.v[j] : 0);
          vs[k * VEC + j] = s2;
          int h = s2 >> 1;
          if ((s2 & 1) && (h & 1)) ++h;  // half to even (s2 >= 0)
          q.v[j] = (uint16_t)h;
        }
        *(typename Pack<VEC>::T*)(rs + e) = cur.word;
        if (emit && e < n_in)
          *(typename Pack<VEC>::T*)(orow + e) = q.word;
      }
    }
    slot = slot + 1 == R ? 0 : slot + 1;
    // the next row's envelopes may be written at once (nothing above reads
    // them); its raw costs only after the barrier that follows them
  }
}

size_t cost_smem_bytes(int TX, int pad, int D) {
  int R = 2 * pad + 1, C = TX + 2 * pad, CR = C + D - 1;
  return sizeof(uint16_t) * (round8((size_t)R * TX * D) +
                             round8((size_t)C * D)) + sizeof(int4) * C +
         sizeof(int) * 3 * CR;
}

template <int VEC>
int launch_cost(const int16_t* lf, const int16_t* rf, int16_t* out, int B,
                int H, int W, int D, int min_d, int pad, int inv2,
                cudaStream_t s) {
  // the widest strip whose ring fits; a thread owns at most ITEMS outputs
  int TX = 32;
  const size_t limit = 200 * 1024;
  while (TX > 1 && cost_smem_bytes(TX, pad, D) > limit) TX /= 2;
  size_t smem = cost_smem_bytes(TX, pad, D);
  if (smem > limit || TX * D > NT * ITEMS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cost_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // segments of rows: each warms its ring up over 2*pad extra rows, so a
  // segment is at least 16 such warm-ups tall; short enough that one frame
  // alone gives the card a few blocks per multiprocessor
  int seg_h = SEG_ROWS > 32 * pad ? SEG_ROWS : 32 * pad;
  dim3 grid((W + TX - 1) / TX, (H + seg_h - 1) / seg_h, B);
  cost_kernel<VEC><<<grid, NT, smem, s>>>(lf, rf, out, H, W, D, min_d, pad,
                                          inv2, TX, seg_h);
  return (int)cudaGetLastError();
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
  const int pad = block_size / 2;
  const int16_t* l = (const int16_t*)lf;
  const int16_t* r = (const int16_t*)rf;
  int16_t* o = (int16_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || min_d < 0) return (int)cudaErrorInvalidValue;
  if (D % 8 == 0)
    return launch_cost<8>(l, r, o, B, H, W, D, min_d, pad, inv2, s);
  if (D % 4 == 0)
    return launch_cost<4>(l, r, o, B, H, W, D, min_d, pad, inv2, s);
  if (D % 2 == 0)
    return launch_cost<2>(l, r, o, B, H, W, D, min_d, pad, inv2, s);
  return launch_cost<1>(l, r, o, B, H, W, D, min_d, pad, inv2, s);
}
