// Kernel A1: one call of the published CREStereo's adaptive group
// correlation (AGCL), both routes and both search patterns.
//
// Replaces no TPU kernel: the JAX package has no published CREStereo. The
// port's plain code (models/crestereo_net.py agcl_warped and
// agcl_deformable), which stays as the twin for CPU tensors, samples with
// grid_sample, pads, multiplies the left map by nine shifted right maps
// into a (B, C, h, w, 9) f32 product, copies and averages it: at 1/4 of a
// 544x960 keyframe pair some 0.6 GB written and read back a call.
//
// What it computes. Per output pixel p, group g (CG = 64 of the C
// channels) and search point k (the 1x9 row dx = -4..4, or the 3x3
// window row-major, as crestereo_net.py search_points):
//   corr[p, 9 g + k] = the mean over the group's channels c of
//                      f1[c, p] * R[c],
//   warped (1/4):      R = Wp[clamp(p + s_k)], Wp[q] the zero-padded
//                      bilinear sample of f2 at q + flow(q); the clamp is
//                      the twin's replicate padding;
//   deformable (1/16, 1/8): R = the zero-padded bilinear sample of f2 at
//                      p + flow(p) + s_k + offset_k(p).
// The taps, their weights and their order are grid_sample's (the twin's
// align_corners=False on its half-pixel grid is a sample at pixel
// coordinates); the coordinates are summed in the twin's order.
//
// What bounds it on the H100: bytes. A call has to read both f32 maps once
// and write the 36 f32 maps once: 4 x (2 x 256 + 36) bytes a pixel, 143 MB
// a call at 1/4 of two 544x960 keyframes (42.7 us at 3.35 TB/s); its
// products, 9 x 256 multiply-adds a pixel, take a tenth of that at the
// f32 rate.
// The design keeps every intermediate out of device memory:
//
// The maps are channels-last (a pixel's C channels are one piece of 4 C
// bytes), so a bilinear tap of a group is one 256-byte read by 16 lanes,
// 16 bytes each; the output is channels-last too, the layout the update
// block's first conv reads.
//
// warped_kernel: a block takes a tile of 128 output pixels (2 x 64 for the
//   1x9 row, 8 x 16 for the 3x3 window) and one group. Its 8 half-warps
//   build the warped right map of the group over the tile and its halo
//   (+-4 columns, or +-1 row and column; halo pixels clamped into the
//   frame) in shared memory, a pixel of 64 channels at a time; then a
//   thread takes an output pixel, its group's 64 channels of f1 in
//   registers (loaded before the halo, so the loads overlap), and sums the
//   nine products from shared memory. A halo pixel takes 68 floats, so a
//   quarter-warp's 16-byte reads of 8 neighbouring pixels fall in distinct
//   banks. The warped map's taps of f2 are read once a group from device
//   memory; the halo's re-reads (1.125x and 1.41x) and the neighbouring
//   pixels' shared taps come from L1 and L2.
// deformable_kernel: every point of every pixel samples f2 at its own
//   place, so nothing is shared between pixels: a half-warp takes a
//   (pixel, group), 4 channels a lane; per point the four taps are four
//   256-byte reads, the lane's 4 products are summed over the half-warp by
//   shuffles, and lanes 0-8 write the group's 9 sums. The 1/16 and 1/8
//   maps (0.5 and 2.1 MB a keyframe) stay in L2.
//
// Everything is f32: the coordinates, the taps' weights, the products and
// the sums (the build has -fmad=false). Only the order of a group's 64-term
// sum differs from the twin's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CG = 64;         // channels a group
constexpr int NPT = 9;         // search points
constexpr int SPAD = CG + 4;   // floats a halo pixel takes in shared memory
constexpr int NT_WARP = 128;   // threads of warped_kernel's block
constexpr int NT_DEF = 256;    // threads of deformable_kernel's block

struct Args {
  const float* f1;      // (B, H, W, C) channels-last
  const float* f2;      // (B, H, W, C) channels-last
  const float* flow;    // (B, 2, H, W) at the element strides below
  const float* offset;  // (B, H, W, 18) channels-last, (x, y) a point
  float* out;           // (B, H, W, groups * 9) channels-last
  int sfb, sfc, sfy, sfx;
  int B, H, W, groups;
};

// the search point k: (dx, dy) of the 3x3 window (SMALL) or the 1x9 row
template <bool SMALL>
__device__ __forceinline__ int point_dx(int k) {
  return SMALL ? k % 3 - 1 : k - 4;
}
template <bool SMALL>
__device__ __forceinline__ int point_dy(int k) {
  return SMALL ? k / 3 - 1 : 0;
}

__device__ __forceinline__ void add4(float4& r, float w, float4 v) {
  r.x = r.x + v.x * w;
  r.y = r.y + v.y * w;
  r.z = r.z + v.z * w;
  r.w = r.w + v.w * w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Channels c0..c0+3 of img (H, W, C) sampled at pixel coordinates (x, y):
// grid_sample's four taps and weights, zero outside, added in its order
// (nw, ne, sw, se).
__device__ __forceinline__ float4 sample4(const float* __restrict__ img,
                                          int H, int W, int C, float x,
                                          float y, int c0) {
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float x0f = floorf(x), y0f = floorf(y);
  // every tap outside, or a coordinate that is not finite
  if (!(x0f >= -1.0f && x0f < (float)W && y0f >= -1.0f && y0f < (float)H))
    return r;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float wx0 = (x0f + 1.0f) - x, wx1 = x - x0f;
  const float wy0 = (y0f + 1.0f) - y, wy1 = y - y0f;
  const bool l = x0 >= 0, rr = x0 + 1 < W, t = y0 >= 0, b = y0 + 1 < H;
  const float* p = img + ((long long)y0 * W + x0) * C + c0;
  const long long row = (long long)W * C;
  if (t && l) add4(r, wx0 * wy0, __ldg((const float4*)p));
  if (t && rr) add4(r, wx1 * wy0, __ldg((const float4*)(p + C)));
  if (b && l) add4(r, wx0 * wy1, __ldg((const float4*)(p + row)));
  if (b && rr) add4(r, wx1 * wy1, __ldg((const float4*)(p + row + C)));
  return r;
}

__device__ __forceinline__ float flow_at(const Args& a, int b, int c, int y,
                                         int x) {
  return __ldg(a.flow + (long long)b * a.sfb + (long long)c * a.sfc +
               (long long)y * a.sfy + (long long)x * a.sfx);
}

template <bool SMALL>
struct Tile {
  static constexpr int TW = SMALL ? 16 : 64;  // output columns
  static constexpr int TH = NT_WARP / TW;     // output rows
  static constexpr int RX = SMALL ? 1 : 4;    // halo columns each side
  static constexpr int RY = SMALL ? 1 : 0;    // halo rows each side
  static constexpr int HWD = TW + 2 * RX;     // halo width
  static constexpr int NH = HWD * (TH + 2 * RY);  // halo pixels
};

template <bool SMALL>
__global__ void __launch_bounds__(NT_WARP)
    warped_kernel(Args a) {
  using T = Tile<SMALL>;
  __shared__ __align__(16) float S[T::NH * SPAD];
  const int tiles_x = (a.W + T::TW - 1) / T::TW;
  const int tx0 = (blockIdx.x % tiles_x) * T::TW;
  const int ty0 = (blockIdx.x / tiles_x) * T::TH;
  const int g = blockIdx.y, b = blockIdx.z;
  const int C = a.groups * CG;
  const long long plane = (long long)a.H * a.W;
  const float* f2b = a.f2 + b * plane * C;

  // this thread's output pixel; its group's channels of f1, loaded first
  const int r = threadIdx.x / T::TW, c = threadIdx.x % T::TW;
  const int y = ty0 + r, x = tx0 + c;
  const bool inside = y < a.H && x < a.W;
  const long long pix = b * plane + (long long)y * a.W + x;
  float4 lv[CG / 4];
  if (inside) {
    const float4* p = (const float4*)(a.f1 + pix * C + g * CG);
#pragma unroll
    for (int j = 0; j < CG / 4; ++j) lv[j] = __ldg(p + j);
  }

  // the warped right map over the tile and its halo: a half-warp a pixel
  const int lane = threadIdx.x & 15;
  const int c0 = g * CG + 4 * lane;
#pragma unroll 3
  for (int i = threadIdx.x >> 4; i < T::NH; i += NT_WARP / 16) {
    const int qy = min(max(ty0 - T::RY + i / T::HWD, 0), a.H - 1);
    const int qx = min(max(tx0 - T::RX + i % T::HWD, 0), a.W - 1);
    const float sx = (float)qx + flow_at(a, b, 0, qy, qx);
    const float sy = (float)qy + flow_at(a, b, 1, qy, qx);
    *(float4*)(S + i * SPAD + 4 * lane) =
        sample4(f2b, a.H, a.W, C, sx, sy, c0);
  }
  __syncthreads();
  if (!inside) return;

  float acc[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < CG / 4; ++j) {
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int q = (r + T::RY + point_dy<SMALL>(k)) * T::HWD +
                    (c + T::RX + point_dx<SMALL>(k));
      acc[k] = acc[k] + dot4(lv[j], *(const float4*)(S + q * SPAD + 4 * j));
    }
  }
  float* o = a.out + pix * (a.groups * NPT) + g * NPT;
#pragma unroll
  for (int k = 0; k < NPT; ++k) o[k] = acc[k] * (1.0f / CG);
}

template <bool SMALL>
__global__ void __launch_bounds__(NT_DEF)
    deformable_kernel(Args a) {
  const long long task = (long long)blockIdx.x * (NT_DEF / 16) +
                         (threadIdx.x >> 4);
  const long long tasks = (long long)a.B * a.H * a.W * a.groups;
  if (task >= tasks) return;  // a whole half-warp leaves together
  const int lane = threadIdx.x & 15;
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const int g = (int)(task % a.groups);
  const long long pix = task / a.groups;
  const int x = (int)(pix % a.W);
  const int y = (int)((pix / a.W) % a.H);
  const int b = (int)(pix / ((long long)a.W * a.H));
  const int C = a.groups * CG;
  const int c0 = g * CG + 4 * lane;
  const float* f2b = a.f2 + (long long)b * a.H * a.W * C;
  const float4 lv = __ldg((const float4*)(a.f1 + pix * C + c0));
  const float bx = (float)x + flow_at(a, b, 0, y, x);
  const float by = (float)y + flow_at(a, b, 1, y, x);
  const float* off = a.offset + pix * (2 * NPT);
  float mine = 0.0f;  // lane k keeps point k's sum
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const float sx = (bx + (float)point_dx<SMALL>(k)) + __ldg(off + 2 * k);
    const float sy = (by + (float)point_dy<SMALL>(k)) + __ldg(off + 2 * k + 1);
    float s = dot4(lv, sample4(f2b, a.H, a.W, C, sx, sy, c0));
#pragma unroll
    for (int m = 8; m >= 1; m >>= 1) s += __shfl_xor_sync(half, s, m, 16);
    if (lane == k) mine = s;
  }
  if (lane < NPT) a.out[pix * (a.groups * NPT) + g * NPT + lane] =
      mine * (1.0f / CG);
}

}  // namespace

// One AGCL call: f1, f2 (B, groups * 64, H, W) f32 channels-last, 16-byte
// aligned; flow (B, 2, H, W) f32 at element strides (sfb, sfc, sfy, sfx);
// offset (B, 18, H, W) f32 channels-last for the deformable route, or null
// for the warped one; small != 0 for the 3x3 window, else the 1x9 row; out
// (B, groups * 9, H, W) f32 channels-last. One launch.
extern "C" int v3d_agcl(void* f1, void* f2, void* flow, void* offset,
                        void* out, int B, int H, int W, int groups,
                        int small, int sfb, int sfc, int sfy, int sfx,
                        void* stream) {
  if ((long long)B * H * W * groups == 0) return 0;
  Args a{};
  a.f1 = (const float*)f1;
  a.f2 = (const float*)f2;
  a.flow = (const float*)flow;
  a.offset = (const float*)offset;
  a.out = (float*)out;
  a.sfb = sfb;
  a.sfc = sfc;
  a.sfy = sfy;
  a.sfx = sfx;
  a.B = B;
  a.H = H;
  a.W = W;
  a.groups = groups;
  cudaStream_t s = (cudaStream_t)stream;
  if (offset != nullptr) {
    const long long tasks = (long long)B * H * W * groups;
    const unsigned blocks = (unsigned)((tasks + NT_DEF / 16 - 1) /
                                       (NT_DEF / 16));
    if (small)
      deformable_kernel<true><<<blocks, NT_DEF, 0, s>>>(a);
    else
      deformable_kernel<false><<<blocks, NT_DEF, 0, s>>>(a);
  } else if (small) {
    using T = Tile<true>;
    dim3 grid(((W + T::TW - 1) / T::TW) * ((H + T::TH - 1) / T::TH), groups,
              B);
    warped_kernel<true><<<grid, NT_WARP, 0, s>>>(a);
  } else {
    using T = Tile<false>;
    dim3 grid(((W + T::TW - 1) / T::TW) * ((H + T::TH - 1) / T::TH), groups,
              B);
    warped_kernel<false><<<grid, NT_WARP, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
