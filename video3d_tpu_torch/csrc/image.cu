// Kernel I1: the depth stage's image ops in one launch. The SBS split, the
// 2x Lanczos-4 unsqueeze of each RGB channel (or none, for full-SBS) and
// BT.601 gray, from the uint8 SBS batch to the f32 gray eyes and, where
// the guide reads them, the f32 RGB eyes.
//
// It replaces no TPU kernel: the JAX stage resamples with a dense
// (W/2, W) f32 matrix product, which the port's plain twin
// (ops/image.py eyes_gray_plain) keeps. That matrix has at most 8 non-zero
// entries a column, so ~99% of the product's multiply-adds are by zeros.
//
// What bounds it on the H100: the bytes. A half-SBS 1080p batch of 8 reads
// 49.8 MB and writes 132.7 MB of gray (0.054 ms at 3.35 TB/s), and 398 MB
// more of RGB where the guide needs it (0.173 ms). The arithmetic is 24
// fused multiply-adds and 5 operations an output pixel.
//
// Design. A warp takes one row of a tile of 128 output columns of one eye
// at a time, four adjacent columns a lane, and walks a contiguous share of
// all (frame, eye, tile, row) rows, so every warp of the one-wave grid gets
// the same number of rows. Per row:
//   - the row's source span (72 pixels for the unsqueeze, 128 without; 216
//     or 384 bytes) is copied into the warp's shared-memory ring by
//     16-byte cp.async, STAGES - 1 rows ahead of the row being computed, so
//     enough bytes are in flight to keep the loads at the memory's rate;
//   - the lanes turn its bytes into f32 R, G and B rows in shared memory,
//     the edge pixel repeated for source indices outside the eye;
//   - a lane reads its window of L consecutive pixels a channel with 8- or
//     16-byte loads, sums each column's NT taps with fmaf in ascending
//     index order, then forms gray = 0.299f R + 0.587f G + 0.114f B as
//     ops/image.py rgb_to_gray does (resample first, then gray; -fmad=false
//     keeps the gray's multiplies and adds apart);
//   - and stores its four gray values (and the RGB ones) with 16-byte
//     stores where the row allows.
// The taps are the resampling matrix's non-zero entries as ops/image.py
// lanczos_taps gives them: (Wo, 8) source indices, ascending, and their f32
// weights, clipped border indices already merged. Once per tile a lane puts
// each of its columns' weights at the first window position that reads the
// tap's index (positions read the eye's pixels clamped to its edge), 0 at
// the others, and keeps them in registers for every row of the tile. A
// weight of 0 adds exactly nothing, so the sum is the matrix column's taps
// in ascending index order, all in f32: no TF32, no bf16, no approximate
// math. Without the unsqueeze a column's one tap is its own pixel.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sgm_common.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

using v3dsgm::cp_async16;
using v3dsgm::cp_async_commit;
using v3dsgm::cp_async_wait;

constexpr int COLS = 4;                    // adjacent output columns a lane
constexpr int WARP_GROUPS = 32;            // lanes of a warp
constexpr int TILE = COLS * WARP_GROUPS;   // output columns a warp-row
constexpr int WARPS = 8;                   // warps of a block
constexpr int STAGES = 4;                  // rows of a warp's copy ring
constexpr int TAPS = 8;                    // taps a column of the table

// The instance's geometry: NT taps a column, DEN = 2 for the 2x unsqueeze,
// 1 for none. Lane group g (output columns COLS g .. COLS g + 3) reads the
// window of L pixels from STEP g - BACK, column c of it the NT from off(c):
// for the 2x unsqueeze, output column o's taps are floor((o + 0.5) / 2 -
// 0.5) - 3 .. + 4, the virtual taps of ops/image.py resample_matrix.
template <int NT, int DEN>
struct Geo {
  __host__ __device__ static constexpr int off(int c) {
    return (c + DEN - 1) / DEN;
  }
  static constexpr int L = off(COLS - 1) + NT;  // window of a lane
  static constexpr int STEP = COLS / DEN;       // window starts a lane apart
  static constexpr int BACK = NT / 2;           // first tap before STEP g
  static constexpr int SPAN = (WARP_GROUPS - 1) * STEP + L;  // tile's pixels
  static constexpr int SPAN_PAD = (SPAN + 3) / 4 * 4;
  // bytes of a staged row: the span's 3 * SPAN bytes from a 16-byte
  // aligned start, up to 15 bytes before the first
  static constexpr int RAW = (3 * SPAN + 15 + 15) / 16 * 16;
  static_assert(RAW / 16 <= 32, "a row's copies are one a lane");
  static_assert(L % STEP == 0, "a window is whole vector loads");
};

// a byte as f32, exactly: 2^23 + b has b in its low mantissa bits
__device__ __forceinline__ float u8f(uint8_t b) {
  return __int_as_float(0x4B000000 | b) - 8388608.0f;
}

// a window's STEP floats from shared memory into registers
template <int STEP>
__device__ __forceinline__ void load_step(float* v, const float* src);
template <>
__device__ __forceinline__ void load_step<2>(float* v, const float* src) {
  const float2 a = *reinterpret_cast<const float2*>(src);
  v[0] = a.x;
  v[1] = a.y;
}
template <>
__device__ __forceinline__ void load_step<4>(float* v, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// Where a row of the flattened (frame, eye, tile, row) space lies; a warp
// walks its rows in order, so it divides once and then counts.
struct Row {
  int b, eye, tile, y;
  __device__ Row(int r, int H, int T) {
    y = r % H;
    const int q = r / H;
    tile = q % T;
    const int fe = q / T;
    b = fe >> 1;
    eye = fe & 1;
  }
  __device__ void next(int H, int T) {
    if (++y < H) return;
    y = 0;
    if (++tile < T) return;
    tile = 0;
    eye ^= 1;
    b += eye == 0;
  }
};

// The row's source pixels [plo, phi] (the tile's span from v0, clamped to
// the eye) and their bytes' address and its 16-byte aligned start.
struct Span {
  int v0, plo;
  uintptr_t lo, a0, hi;
  template <class G>
  __device__ static Span of(const uint8_t* frames, const Row& rw, int H,
                            int W, int Win) {
    Span s;
    s.v0 = G::STEP * rw.tile * WARP_GROUPS - G::BACK;
    s.plo = min(max(s.v0, 0), Win - 1);
    const int phi = min(max(s.v0 + G::SPAN - 1, 0), Win - 1);
    const uint8_t* row =
        frames + ((long long)(rw.b * H + rw.y) * W + rw.eye * Win) * 3;
    s.lo = (uintptr_t)(row + 3 * s.plo);
    s.hi = (uintptr_t)(row + 3 * (phi + 1));
    s.a0 = s.lo & ~(uintptr_t)15;
    return s;
  }
};

// grid: one wave of blocks of WARPS warps. Outputs gl, gr (B, H, Wo);
// rl, rr (B, 3, H, Wo) where rgb_planar, else (B, H, Wo, 3), or null.
// tap_idx, tap_w: the (Wo, TAPS) table where NT > 1, else unread.
template <int NT, int DEN>
__global__ void __launch_bounds__(WARPS * 32)
    eyes_gray_kernel(const uint8_t* __restrict__ frames,
                     float* __restrict__ gl, float* __restrict__ gr,
                     float* __restrict__ rl, float* __restrict__ rr,
                     const int* __restrict__ tap_idx,
                     const float* __restrict__ tap_w, int H, int W, int Wo,
                     int T, int rgb_planar, int rows) {
  using G = Geo<NT, DEN>;
  __shared__ __align__(16) uint8_t raw_s[WARPS][STAGES][G::RAW];
  __shared__ __align__(16) float rgb_s[WARPS][3][G::SPAN_PAD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Win = W / 2;
  const long long nw = (long long)gridDim.x * WARPS;
  const long long wid = (long long)blockIdx.x * WARPS + warp;
  const int r0 = (int)(wid * rows / nw), r1 = (int)((wid + 1) * rows / nw);
  const bool vec_ok = (Wo % 4) == 0;  // rows of whole 16-byte stores

  Row ahead(r0, H, T);  // the next row to copy
  auto copy_row = [&](int k) {
    const Span s = Span::of<G>(frames, ahead, H, W, Win);
    const int n = (int)((s.hi - s.a0 + 15) >> 4);
    if (lane < n)
      cp_async16(raw_s[warp][k % STAGES] + lane * 16,
                 (const void*)(s.a0 + lane * 16));
    ahead.next(H, T);
  };

  for (int k = 0; k < STAGES - 1; ++k) {
    if (r0 + k < r1) copy_row(k);
    cp_async_commit();
  }

  int cur_tile = -1;
  const int rel = G::STEP * lane;  // the lane's window in the tile's span
  float wr[COLS][NT];
  Row rw(r0, H, T);
  for (int k = 0; k < r1 - r0; ++k, rw.next(H, T)) {
    if (r0 + k + STAGES - 1 < r1) copy_row(k + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // row k's bytes have landed
    __syncwarp();

    // the span's bytes -> f32 planes, edge pixels repeated
    const Span s = Span::of<G>(frames, rw, H, W, Win);
    const uint8_t* raw = raw_s[warp][k % STAGES] + (int)(s.lo - s.a0);
#pragma unroll
    for (int p0 = 0; p0 < G::SPAN; p0 += 32) {
      const int p = p0 + lane;
      if (p0 + 32 <= G::SPAN || p < G::SPAN) {
        const int pix = min(max(s.v0 + p, 0), Win - 1);
        const uint8_t* px = raw + 3 * (pix - s.plo);
        rgb_s[warp][0][p] = u8f(px[0]);
        rgb_s[warp][1][p] = u8f(px[1]);
        rgb_s[warp][2][p] = u8f(px[2]);
      }
    }
    __syncwarp();

    if (rw.tile != cur_tile) {  // the lane's weights at its window
      cur_tile = rw.tile;
      const int g = cur_tile * WARP_GROUPS + lane;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        if (NT == 1) {
          wr[c][0] = 1.0f;
          continue;
        }
        const int o = g * COLS + c;
        int ti[TAPS];
        float tw[TAPS];
#pragma unroll
        for (int j = 0; j < TAPS; ++j) {
          ti[j] = o < Wo ? __ldg(tap_idx + o * TAPS + j) : -1;
          tw[j] = o < Wo ? __ldg(tap_w + o * TAPS + j) : 0.0f;
        }
        int prev = -1;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int p = min(max(s.v0 + rel + G::off(c) + t, 0), Win - 1);
          float a = 0.0f;
#pragma unroll
          for (int j = 0; j < TAPS; ++j)
            a += ti[j] == p && p != prev ? tw[j] : 0.0f;
          wr[c][t] = a;
          prev = p;
        }
      }
    }

    float out[3][COLS];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v[G::L];
#pragma unroll
      for (int k = 0; k < G::L; k += G::STEP)
        load_step<G::STEP>(v + k, &rgb_s[warp][ch][rel + k]);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float a = 0.0f;
#pragma unroll
        for (int t = 0; t < NT; ++t) a = fmaf(wr[c][t], v[G::off(c) + t], a);
        out[ch][c] = a;
      }
    }
    float gray[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      gray[c] = 0.299f * out[0][c] + 0.587f * out[1][c] + 0.114f * out[2][c];

    const int x = rw.tile * TILE + lane * COLS;
    const bool whole = vec_ok && x + COLS <= Wo;
    const long long pix0 = (long long)(rw.b * H + rw.y) * Wo + x;
    float* g_out = (rw.eye ? gr : gl) + pix0;
    if (whole) {
      *reinterpret_cast<float4*>(g_out) =
          make_float4(gray[0], gray[1], gray[2], gray[3]);
    } else {
      for (int c = 0; c < COLS; ++c)
        if (x + c < Wo) g_out[c] = gray[c];
    }
    float* rgb = rw.eye ? rr : rl;
    if (rgb != nullptr) {
      if (rgb_planar) {
        for (int ch = 0; ch < 3; ++ch) {
          float* o = rgb + ((long long)(rw.b * 3 + ch) * H + rw.y) * Wo + x;
          if (whole) {
            *reinterpret_cast<float4*>(o) =
                make_float4(out[ch][0], out[ch][1], out[ch][2], out[ch][3]);
          } else {
            for (int c = 0; c < COLS; ++c)
              if (x + c < Wo) o[c] = out[ch][c];
          }
        }
      } else {
        float* o = rgb + pix0 * 3;
        if (whole) {
          float4* o4 = reinterpret_cast<float4*>(o);
          o4[0] = make_float4(out[0][0], out[1][0], out[2][0], out[0][1]);
          o4[1] = make_float4(out[1][1], out[2][1], out[0][2], out[1][2]);
          o4[2] = make_float4(out[2][2], out[0][3], out[1][3], out[2][3]);
        } else {
          for (int c = 0; c < COLS; ++c)
            if (x + c < Wo)
              for (int ch = 0; ch < 3; ++ch) o[c * 3 + ch] = out[ch][c];
        }
      }
    }
    __syncwarp();  // the planes and the ring slot are free again
  }
  cp_async_wait<0>();
}

template <int NT, int DEN>
cudaError_t launch(const uint8_t* frames, float* gl, float* gr, float* rl,
                   float* rr, const int* tap_idx, const float* tap_w, int B,
                   int H, int W, int Wo, int rgb_planar, cudaStream_t s) {
  static int grid_max = 0;  // blocks of one wave on this card
  if (grid_max == 0) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, eyes_gray_kernel<NT, DEN>, WARPS * 32, 0);
    if (e != cudaSuccess) return e;
    grid_max = per_sm * n_sm;
  }
  const int T = (Wo + TILE - 1) / TILE;
  const long long rows = (long long)B * 2 * T * H;
  if (rows > INT_MAX) return cudaErrorInvalidValue;  // rows count in int
  const long long need = (rows + WARPS - 1) / WARPS;
  const int grid = need < grid_max ? (int)need : grid_max;
  eyes_gray_kernel<NT, DEN><<<grid, WARPS * 32, 0, s>>>(
      frames, gl, gr, rl, rr, tap_idx, tap_w, H, W, Wo, T, rgb_planar,
      (int)rows);
  return cudaGetLastError();
}

}  // namespace

// frames (B, H, W, 3) uint8 contiguous; gl, gr (B, H, Wo) f32; rl, rr the
// RGB eyes or null; unsqueeze 1: Wo = W, the 2x Lanczos-4 unsqueeze with
// tap_idx, tap_w from ops/image.py lanczos_taps (Wo, 8), and planar RGB;
// unsqueeze 0: Wo = W / 2, no taps, interleaved RGB.
extern "C" int v3d_eyes_gray(void* frames, void* gl, void* gr, void* rl,
                             void* rr, void* tap_idx, void* tap_w, int B,
                             int H, int W, int unsqueeze, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const uint8_t* f = (const uint8_t*)frames;
  cudaStream_t s = (cudaStream_t)stream;
  if (unsqueeze)
    return (int)launch<8, 2>(f, (float*)gl, (float*)gr, (float*)rl,
                             (float*)rr, (const int*)tap_idx,
                             (const float*)tap_w, B, H, W, W, 1, s);
  return (int)launch<1, 1>(f, (float*)gl, (float*)gr, (float*)rl, (float*)rr,
                           nullptr, nullptr, B, H, W, W / 2, 0, s);
}
