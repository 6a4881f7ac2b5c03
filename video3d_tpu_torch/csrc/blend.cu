// Kernels F1 and F2: the depth stage's hole fill, and its confidence-trust
// blend after the guide's output.
//
// Replaces no TPU kernel: the JAX package computes the fill
// (video3d_tpu/ops/fill.py), the box sums (ops/boxsum.py), the monocular
// landing and the blend (stages/depth.py confidence_trust_blend and the
// guidance branch of depth_batch_pipeline) as plain jnp. The port's plain
// code (ops/fill.py fill_holes, stages/depth.py guidance_blend), which
// stays as the twin, takes some 60 eager operations a batch: cumulative
// sums, concatenations, gathers, flips and per-frame reductions, each a
// pass over an f32 plane.
//
// What bounds it on the H100: bytes. The blend has to read the disparity,
// the margin and the guide's output once and write the blended map once:
// at 8 frames of 1080x1920, four f32 planes of 66.4 MB at K=1 (0.079 ms at
// 3.35 TB/s), 216 MB at K=4, where the guide has 2 keyframes (0.064 ms).
// The fill, before the guide runs, reads and writes the disparity once
// (0.040 ms). The design keeps every intermediate plane (confidence,
// agreement, landed guide, box sums, window area, trust) out of device
// memory:
//
// F1: a warp a row, 32 consecutive pixels a step, in two kernels.
//   fill_kernel: the background-extension fill. A step's valid pixels are
//     a ballot; each lane takes the value of the nearest valid pixel at or
//     left of it from the ballot (a shuffle), or the carry of the steps
//     before; the same from the right on the way back; a hole takes the
//     smaller of the two (copies: bit-equal to the twin). The left values
//     wait in the output row, which the same thread reads back, so the
//     kernel needs no scratch of a row's width.
//   stats_kernel: a frame's sums from the disparity, the margin and the
//     guide. STATS_STEREO: the confident mass and the mass agreeing with a
//     stereo guide. STATS_MONO: the confident mass, a monocular guide's min
//     and max and the sums of the scale-and-shift fit (models/mono.py
//     ssi_align). AGREE, after STATS_MONO: the mass agreeing with the
//     monocular guide landed by the frame's fit.
//   Sums are in double: per lane, the warp's in a fixed shuffle order, the
//   block's warps in order, a partial per block; the last block of a frame
//   to finish (a ticket per frame) sums the frame's partials in block
//   order and writes the frame's scalars. No float atomics, so a second
//   run gives the same bits.
// F2, tile_kernel: a block of 256 threads takes a strip of 240 output
//   columns plus an 8-column halo on each side, a thread a column, and
//   walks down a segment of 64 output rows from 8 rows above it to 8 below.
//   Per input row a thread computes the confidence and the agreement of
//   its pixel, keeps them in a ring of the last 17 rows in shared memory
//   and their running vertical sums in double registers (add the row that
//   enters, subtract the one that leaves); the sums go to a shared row in
//   f32 and each output pixel adds the 17 around it. The window's area is a closed
//   form; frame b reads the guide's keyframe b / K, so no expanded copy of
//   the guide is made.
//
// Per-pixel arithmetic is the twin's, in f32 and in its order (the build
// has -fmad=false); the sums are wider and in another order, the only
// difference.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;  // threads a block
constexpr int WARPS = NT / 32;
constexpr int R = 8;  // radius of the trust window
constexpr int WIN = 2 * R + 1;
constexpr int TW = NT - 2 * R;  // output columns of F2's strip
constexpr int SEG = 64;         // output rows of F2's segment
constexpr int NSUM = 7;         // sums a block's partial holds

enum Mode { STATS_STEREO = 1, STATS_MONO = 2, AGREE = 3 };
// a partial's sums
enum { S_MASS = 0, S_AGREE = 1, S_P = 1, S_T = 2, S_PP = 3, S_PT = 4,
       S_MIN = 5, S_MAX = 6 };
// a frame's scalars
enum { FR_MASS = 0, FR_Q = 1, FR_MIN = 2, FR_MAX = 3, FR_S = 4, FR_T = 5,
       FR_N = 8 };

__host__ __device__ constexpr int sums_of(int mode) {
  return mode == STATS_STEREO ? 2 : mode == STATS_MONO ? NSUM : 1;
}

struct Args {
  const float* disp;    // (B, H, W)
  const float* margin;  // (B, H, W)
  const float* guide;   // (G, H, W), G = ceil(B / every)
  float* out;           // (B, H, W): the filled disparity, or the blend
  double* partial;      // (B, blocks a frame, NSUM)
  double* frame;        // (B, FR_N)
  unsigned* ticket;     // (B,): blocks of the frame done, 0 between calls
  int B, H, W, every;
  float invalid;     // fill_kernel: the hole's value
  float conf_above;  // a pixel is confident where disp > min_disparity - 0.5
  float D;           // num_disparities: a monocular guide's range
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The twin's confidence: the margin where the disparity is valid
__device__ __forceinline__ float conf_of(float d, float m, float above) {
  return d > above ? m : 0.0f;
}

// A monocular guide landed in disparity units as the twin lands it: the
// fit where its scale is positive, else the min-max normalised guide; a
// stereo guide as it is.
struct Landing {
  float s, t, lo, range, D;
  bool stereo, fit;

  __device__ Landing(const double* fr, float D_, bool stereo_)
      : s(0.0f), t(0.0f), lo(0.0f), range(1.0f), D(D_), stereo(stereo_),
        fit(false) {
    if (stereo) return;  // a stereo guide's frame has no fit
    s = (float)fr[FR_S];
    t = (float)fr[FR_T];
    lo = (float)fr[FR_MIN];
    range = fmaxf((float)fr[FR_MAX] - lo, 1e-6f);
    fit = s > 0.0f;
  }

  __device__ __forceinline__ float operator()(float g) const {
    if (stereo) return g;
    if (fit) return fminf(fmaxf(g * s + t, 0.0f), D);
    return (g - lo) / range * D;
  }
};

__device__ __forceinline__ float agree_of(float g, float sp, float c) {
  return fabsf(g - sp) <= 2.0f ? c : 0.0f;
}

__device__ __forceinline__ double combine(int k, int mode, double a,
                                          double b) {
  if (mode == STATS_MONO && k == S_MIN) return fmin(a, b);
  if (mode == STATS_MONO && k == S_MAX) return fmax(a, b);
  return a + b;
}

__device__ __forceinline__ double start_of(int k, int mode) {
  if (mode == STATS_MONO && k == S_MIN) return (double)inf_f();
  if (mode == STATS_MONO && k == S_MAX) return -(double)inf_f();
  return 0.0;
}

// The fill of one row by one warp (see the file's head), FU steps at a
// time: their loads are issued together, then the steps run in order.
constexpr int FU = 4;

__device__ void fill_row(const float* d, float* o, int W, float invalid,
                         int lane) {
  float carry = inf_f();
  for (int x0 = 0; x0 < W; x0 += 32 * FU) {
    float v[FU];
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int x = x0 + 32 * u + lane;
      v[u] = x < W ? d[x] : invalid;
    }
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int x = x0 + 32 * u + lane;
      const unsigned m = __ballot_sync(FULL, x < W && v[u] != invalid);
      const unsigned upto = m & (FULL >> (31 - lane));  // lanes 0..lane
      const float got =
          __shfl_sync(FULL, v[u], upto ? 31 - __clz(upto) : 0);
      if (x < W) o[x] = upto ? got : carry;
      if (m) carry = __shfl_sync(FULL, v[u], 31 - __clz(m));
    }
  }
  carry = inf_f();
  for (int x0 = (W - 1) / (32 * FU) * (32 * FU); x0 >= 0; x0 -= 32 * FU) {
    float v[FU], left[FU];
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int x = x0 + 32 * u + lane;
      v[u] = x < W ? d[x] : invalid;
      left[u] = x < W ? o[x] : inf_f();
    }
#pragma unroll
    for (int u = FU - 1; u >= 0; --u) {
      const int x = x0 + 32 * u + lane;
      const bool valid = x < W && v[u] != invalid;
      const unsigned m = __ballot_sync(FULL, valid);
      const unsigned from = m & (FULL << lane);  // lanes lane..31
      const float got = __shfl_sync(FULL, v[u], from ? __ffs(from) - 1 : 0);
      if (x < W) {
        float f = fminf(left[u], from ? got : carry);
        if (isinf(f)) f = invalid;
        o[x] = valid ? v[u] : f;
      }
      if (m) carry = __shfl_sync(FULL, v[u], __ffs(m) - 1);
    }
  }
}

// grid (ceil(H / WARPS), B), block NT: warp w of block (i, b) takes row
// i * WARPS + w of frame b.
__global__ void __launch_bounds__(NT) fill_kernel(Args a) {
  const int y = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (y >= a.H) return;
  const long long row = ((long long)blockIdx.y * a.H + y) * a.W;
  fill_row(a.disp + row, a.out + row, a.W, a.invalid, threadIdx.x & 31);
}

// F1's statistics (MODE STATS_STEREO, STATS_MONO or AGREE), on the grid
// of fill_kernel.
template <int MODE>
__global__ void __launch_bounds__(NT) stats_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, y = blockIdx.x * WARPS + warp;
  const int H = a.H, W = a.W;
  const long long plane = (long long)H * W;
  const long long row = b * plane + (long long)y * W;
  constexpr int NS = sums_of(MODE);
  double acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = start_of(k, MODE);
  if (y < H) {
    const float* d = a.disp + row;
    const float* mg = a.margin + row;
    const float* g = a.guide + (b / a.every) * plane + (long long)y * W;
    const Landing land(a.frame + b * FR_N, a.D, MODE != AGREE);
#pragma unroll 4
    for (int x = lane; x < W; x += 32) {
      const float dv = d[x], gv = g[x];
      const float c = conf_of(dv, mg[x], a.conf_above);
      const float sp = fmaxf(dv, 0.0f);
      if constexpr (MODE == STATS_STEREO) {
        acc[S_MASS] += c;
        acc[S_AGREE] += agree_of(gv, sp, c);
      } else if constexpr (MODE == STATS_MONO) {
        // the twin's terms: pred * v, target * v, pred * pred * v and
        // pred * target * v, each in f32
        acc[S_MASS] += c;
        acc[S_P] += gv * c;
        acc[S_T] += sp * c;
        acc[S_PP] += gv * gv * c;
        acc[S_PT] += gv * sp * c;
        acc[S_MIN] = fmin(acc[S_MIN], (double)gv);
        acc[S_MAX] = fmax(acc[S_MAX], (double)gv);
      } else {
        acc[0] += agree_of(land(gv), sp, c);
      }
    }
  }
  // the warp's sums, then the block's in warp order
  __shared__ double red[WARPS][NSUM];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    for (int o = 16; o > 0; o >>= 1)
      acc[k] = combine(k, MODE, acc[k], __shfl_down_sync(FULL, acc[k], o));
    if (lane == 0) red[warp][k] = acc[k];
  }
  __syncthreads();
  const int nblk = gridDim.x;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    double* p = a.partial + ((long long)b * nblk + blockIdx.x) * NSUM;
    for (int k = 0; k < NS; ++k) {
      double s = red[0][k];
      for (int w = 1; w < WARPS; ++w) s = combine(k, MODE, s, red[w][k]);
      p[k] = s;
    }
    __threadfence();
    last = atomicAdd(a.ticket + b, 1u) == (unsigned)nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  // the frame's last block: its partials in block order
  __threadfence();
  __shared__ double tree[NT];
  double tot[NS];
  for (int k = 0; k < NS; ++k) {
    double s = start_of(k, MODE);
    for (int i = threadIdx.x; i < nblk; i += NT)
      s = combine(k, MODE, s,
                  __ldcg(a.partial + ((long long)b * nblk + i) * NSUM + k));
    tree[threadIdx.x] = s;
    __syncthreads();
    for (int n = NT / 2; n > 0; n >>= 1) {
      if (threadIdx.x < n)
        tree[threadIdx.x] =
            combine(k, MODE, tree[threadIdx.x], tree[threadIdx.x + n]);
      __syncthreads();
    }
    tot[k] = tree[0];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  double* fr = a.frame + b * FR_N;
  if constexpr (MODE == STATS_MONO) {
    // ssi_align's fit: a degenerate one (|det| <= 1e-6) has s = 1
    const double n = fmax(tot[S_MASS], 1.0);
    const double det = n * tot[S_PP] - tot[S_P] * tot[S_P];
    const double s = fabs(det) > 1e-6
                         ? (n * tot[S_PT] - tot[S_P] * tot[S_T]) / det
                         : 1.0;
    fr[FR_MASS] = tot[S_MASS];
    fr[FR_MIN] = tot[S_MIN];
    fr[FR_MAX] = tot[S_MAX];
    fr[FR_S] = s;
    fr[FR_T] = (tot[S_T] - s * tot[S_P]) / n;
  } else {
    // the frame's trust where a window holds too little confidence: 1
    // where the frame holds under 32
    double mass = fr[FR_MASS], agree = tot[0];
    if constexpr (MODE == STATS_STEREO) {
      mass = tot[S_MASS];
      agree = tot[S_AGREE];
    }
    fr[FR_MASS] = mass;
    fr[FR_Q] = mass >= 32.0 ? agree / fmax(mass, 1e-6) : 1.0;
  }
  a.ticket[b] = 0u;
}

// pixels of the clipped window [i - R, i + R] on an axis of n
__device__ __forceinline__ int win_count(int i, int n) {
  return min(i + R, n - 1) - max(i - R, 0) + 1;
}

// grid (ceil(W / TW), ceil(H / SEG), B), block NT (see the file's head).
// The entering row is loaded a step ahead, and the output row's disparity
// and guide at the top of its step.
template <bool STEREO>
__global__ void __launch_bounds__(NT) tile_kernel(Args a) {
  __shared__ float ring_c[WIN][NT], ring_a[WIN][NT];
  __shared__ float row_c[2][NT], row_a[2][NT];
  const int t = threadIdx.x, b = blockIdx.z;
  const int H = a.H, W = a.W;
  const int x = blockIdx.x * TW - R + t;
  const int y0 = blockIdx.y * SEG;
  const bool col_in = x >= 0 && x < W;
  const bool out_col = t >= R && t < NT - R && x < W;
  const long long plane = (long long)H * W;
  const float* dp = a.disp + b * plane;
  const float* mp = a.margin + b * plane;
  const float* gp = a.guide + (b / a.every) * plane;
  float* op = a.out + b * plane;
  const double* fr = a.frame + b * FR_N;
  const Landing land(fr, a.D, STEREO);
  const float q = (float)fr[FR_Q];
  for (int k = 0; k < WIN; ++k) ring_c[k][t] = ring_a[k][t] = 0.0f;
  double vc = 0.0, va = 0.0;
  // input rows y0 - R .. y_end + R - 1; output row j - R after row j
  const int steps = min(y0 + SEG, H) - y0 + 2 * R;
  auto in_row = [&](int j) { return col_in && j >= 0 && j < H; };
  float nd = 0.0f, nm = 0.0f, ng = 0.0f;  // the next entering pixel
  if (in_row(y0 - R)) {
    const long long i = (long long)(y0 - R) * W + x;
    nd = dp[i];
    nm = mp[i];
    ng = gp[i];
  }
  for (int k = 0; k < steps; ++k) {
    const int j = y0 - R + k, slot = k % WIN, o = j - R;
    const bool have = in_row(j);
    const float dv = nd, mv = nm, gv = ng;
    if (in_row(j + 1)) {
      const long long i = (long long)(j + 1) * W + x;
      nd = dp[i];
      nm = mp[i];
      ng = gp[i];
    }
    float od = 0.0f, og = 0.0f;  // the output pixel's disparity and guide
    if (o >= y0 && out_col) {
      const long long i = (long long)o * W + x;
      od = dp[i];
      og = gp[i];
    }
    float c = 0.0f, ag = 0.0f;
    if (have) {
      c = conf_of(dv, mv, a.conf_above);
      ag = agree_of(land(gv), fmaxf(dv, 0.0f), c);
    }
    vc += (double)c - (double)ring_c[slot][t];
    va += (double)ag - (double)ring_a[slot][t];
    ring_c[slot][t] = c;
    ring_a[slot][t] = ag;
    if (o < y0) continue;  // the same for the whole block
    float* rc = row_c[k & 1];
    float* ra = row_a[k & 1];
    rc[t] = (float)vc;
    ra[t] = (float)va;
    __syncthreads();
    if (!out_col) continue;
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int u = -R; u <= R; ++u) {
      den += rc[t + u];
      num += ra[t + u];
    }
    const float area = (float)(win_count(o, H) * win_count(x, W));
    const float trust = den > 0.02f * area ? num / fmaxf(den, 1e-6f) : q;
    const float cc = ring_c[(k - R) % WIN][t];
    const float sp = fmaxf(od, 0.0f);
    const float conf = 1.0f - (1.0f - cc) * fminf(fmaxf(trust, 0.0f), 1.0f);
    op[(long long)o * W + x] = conf * sp + (1.0f - conf) * land(og);
  }
}

dim3 rows_grid(const Args& a) { return dim3((a.H + WARPS - 1) / WARPS, a.B); }

template <int MODE>
int stats(const Args& a, cudaStream_t stream) {
  stats_kernel<MODE><<<rows_grid(a), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// F1's fill: disp, out (B, H, W) f32, contiguous; holes are == invalid.
extern "C" int v3d_fill_holes(void* disp, void* out, int B, int H, int W,
                              float invalid, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  Args a{};
  a.disp = (const float*)disp;
  a.out = (float*)out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.invalid = invalid;
  fill_kernel<<<rows_grid(a), NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Doubles of scratch that v3d_trust_blend needs for B frames of H rows.
extern "C" int v3d_blend_scratch(int B, int H) {
  return B * (((H + WARPS - 1) / WARPS) * NSUM + FR_N);
}

// The blend: disp, margin, out (B, H, W) and guide (ceil(B / every), H, W)
// f32, contiguous; stereo != 0 for a guide that gives disparity, else a
// monocular one, landed first; scratch v3d_blend_scratch(B, H) doubles;
// ticket B words, 0 (and left 0). Launches F1's statistics, for a
// monocular guide F1's agreement, then F2.
extern "C" int v3d_trust_blend(void* disp, void* margin, void* guide,
                               void* out, void* scratch, void* ticket, int B,
                               int H, int W, int every, int stereo,
                               float conf_above, float num_disparities,
                               void* stream) {
  if ((long long)B * H * W == 0) return 0;
  Args a{};
  a.disp = (const float*)disp;
  a.margin = (const float*)margin;
  a.guide = (const float*)guide;
  a.out = (float*)out;
  a.frame = (double*)scratch;
  a.partial = a.frame + B * FR_N;
  a.ticket = (unsigned*)ticket;
  a.B = B;
  a.H = H;
  a.W = W;
  a.every = every;
  a.conf_above = conf_above;
  a.D = num_disparities;
  cudaStream_t s = (cudaStream_t)stream;
  int e = stereo ? stats<STATS_STEREO>(a, s) : stats<STATS_MONO>(a, s);
  if (e == 0 && !stereo) e = stats<AGREE>(a, s);
  if (e != 0) return e;
  dim3 grid((W + TW - 1) / TW, (H + SEG - 1) / SEG, B);
  if (stereo)
    tile_kernel<true><<<grid, NT, 0, s>>>(a);
  else
    tile_kernel<false><<<grid, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}
