// Kernel B4: banded-window speckle vote.
//
// Replaces the TPU kernel video3d_tpu/kernels/speckle.py
// speckle_filter_pallas (body _speckle_kernel), which walks row blocks with
// a VMEM ring of band masks and running column sums.
//
// What bounds it on the H100: the bytes. It reads and writes one f32
// disparity map (2 x 8.3 MB a 1080p frame, 0.005 ms at 3.35 TB/s), and
// counted with running sums the window costs a few adds a pixel (tap by
// tap it would be 441 taps of ~5 operations at the default r = 10).
//
// A valid pixel of band k keeps its value when at least min_region valid
// pixels of bands k-1..k+1 lie in its border-clipped (2r+1)^2 window. One
// kernel: a block of T threads takes a strip of T - 2r output columns plus
// an r-pixel halo on each side, one thread a column, and walks down a
// segment of SEG rows plus r rows above and below. Per input row a thread
// turns its f32 disparity into a band with the twin's own expression; the
// output row is r rows behind the input row, and pixels outside the image
// count as invalid (the border-clipped window).
//
// Few bands (n_bands <= 4, the default's 3): the cumulative indicators
// C_j = "valid and band <= j" of a pixel are one byte each of a 32-bit
// word, so one add serves all planes. A row's words go to shared memory,
// each output column adds the 2r+1 words around it (the horizontal window
// counts, at most 2r+1 <= 255 a byte), keeps the last 2r+1 rows of these in
// its own column of a shared-memory ring, and holds the running vertical
// sum in two registers of 16-bit fields (add the row that enters, subtract
// the one that leaves; at most (2r+1)^2 <= 65535 a field). The support of
// band k is field(min(k+1, n-1)) - field(k-2).
//
// Many bands (a small max_diff gives up to 254): a plane per band would
// cost n adds a pixel and n bytes a ring entry. Instead the vertical sum
// comes first and per band: a ring of the last 2r+1 rows of band codes and,
// per column, a histogram over the bands of the codes in the ring (one
// increment for the row that enters, one decrement for the one that
// leaves; at most 2r+1 <= 255, a byte). An output pixel of band k then adds
// the histogram entries of bands k-1..k+1 over the 2r+1 columns around it.
//
// Counts are exact integers either way, so the result is bit-identical to
// the plain twin. The C entry refuses what the counters cannot hold
// (r > 127, more than 254 bands) and what shared memory cannot (the launch
// attribute's error) rather than wrap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 64;         // output rows of a block
constexpr int PLANE_BANDS = 4;  // bands that fit the bytes of a word
constexpr int NO_BAND = 255;    // the code of an invalid pixel

// the twin's band of a valid value: no reciprocal, no fused multiply-add
__device__ __forceinline__ int band_of(float v, float lo, float max_diff,
                                       int n_bands) {
  int band = (int)floorf((v - lo) / max_diff);
  return min(max(band, 0), n_bands - 1);
}

// grid (strips of T - 2r columns, segments of SEG rows, B), block T.
// Shared memory, PLANES: uint32 ind[2][T], ring[2r+1][T]; else
// uint8 hist[n_bands][T], codes[2r+1][T].
template <bool PLANES>
__global__ void speckle_kernel(const float* __restrict__ disp,
                               float* __restrict__ out, int H, int W,
                               float invalid, float max_diff, float lo,
                               int n_bands, int radius, int min_region) {
  extern __shared__ uint32_t ssm[];
  const int T = blockDim.x, tid = threadIdx.x, R = 2 * radius + 1;
  const int x = blockIdx.x * (T - 2 * radius) - radius + tid;
  const int y0 = blockIdx.y * SEG, y1 = min(y0 + SEG, H);
  const float* img = disp + (long long)blockIdx.z * H * W;
  float* dst = out + (long long)blockIdx.z * H * W;
  const bool in_x = x >= 0 && x < W;
  // an output column has its whole window inside the block's columns
  const bool votes = tid >= radius && tid < T - radius && x < W;

  uint32_t* ind = ssm;            // [2][T] a row's packed indicators
  uint32_t* ring = ssm + 2 * T;   // [R][T] horizontal counts, packed
  uint8_t* hist = (uint8_t*)ssm;  // [n_bands][T] codes in the ring, by band
  uint8_t* codes = hist + n_bands * T;  // [R][T]
  if (!PLANES) {
    for (int i = tid; i < n_bands * T; i += T) hist[i] = 0;
    __syncthreads();
  }

  uint32_t even = 0, odd = 0;  // vertical sums of planes 0, 2 and 1, 3
  int slot = 0;                // ring row of the input row
  const int y_in0 = y0 - radius, y_in1 = y1 + radius;
  auto fetch = [&](int yy) {
    return in_x && yy >= 0 && yy < min(H, y_in1) ? img[(long long)yy * W + x]
                                                 : 0.0f;
  };
  float v_next = fetch(y_in0);
  for (int yy = y_in0; yy < y_in1; ++yy) {
    const float v = v_next;
    v_next = fetch(yy + 1);      // a row ahead of its use
    const int yo = yy - radius;  // the output row
    const bool writes = votes && yo >= y0;
    const float vo = writes ? img[(long long)yo * W + x] : invalid;
    const bool valid = in_x && yy >= 0 && yy < H && v != invalid;
    const int k = valid ? band_of(v, lo, max_diff, n_bands) : NO_BAND;
    const bool full = yy - y_in0 >= R;  // a row leaves the window
    int support = 0;
    if (PLANES) {
      // bytes k..3 set: the planes C_j, j >= k
      uint32_t* row = ind + ((yy - y_in0) & 1) * T;
      row[tid] = valid ? 0x01010101u << (8 * k) : 0u;
      __syncthreads();
      if (votes) {
        uint32_t hs = 0;
        for (int c = tid - radius; c <= tid + radius; ++c) hs += row[c];
        uint32_t* mine = ring + slot * T + tid;
        const uint32_t old = full ? *mine : 0u;
        *mine = hs;
        even += (hs & 0x00ff00ffu) - (old & 0x00ff00ffu);
        odd += ((hs >> 8) & 0x00ff00ffu) - ((old >> 8) & 0x00ff00ffu);
      }
    } else {
      uint8_t* mine = codes + slot * T + tid;
      const int old = full ? *mine : NO_BAND;
      *mine = (uint8_t)k;
      if (old != NO_BAND) --hist[old * T + tid];
      if (k != NO_BAND) ++hist[k * T + tid];
      __syncthreads();
    }
    if (writes) {
      float res = invalid;
      if (vo != invalid) {
        const int ko = band_of(vo, lo, max_diff, n_bands);
        if (PLANES) {
          auto field = [&](int j) {
            return (int)(((j & 1 ? odd : even) >> (16 * (j >> 1))) & 0xffffu);
          };
          support = field(min(ko + 1, n_bands - 1)) -
                    (ko >= 2 ? field(ko - 2) : 0);
        } else {
          for (int j = max(ko - 1, 0); j <= min(ko + 1, n_bands - 1); ++j)
            for (int c = tid - radius; c <= tid + radius; ++c)
              support += hist[j * T + c];
        }
        if (support >= min_region) res = vo;
      }
      dst[(long long)yo * W + x] = res;
    }
    if (!PLANES) __syncthreads();  // the histogram is read before it moves
    if (++slot == R) slot = 0;
  }
}

}  // namespace

// disp, out: (B, H, W) f32.
extern "C" int v3d_speckle(void* disp, void* out, int B, int H, int W,
                           float invalid, float max_diff, float lo,
                           int n_bands, int radius, int min_region,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // what the counters hold: a byte a row count, 16 bits a window count,
  // NO_BAND the code of no band
  if (n_bands < 1 || n_bands >= NO_BAND || radius < 0 || radius > 127)
    return (int)cudaErrorInvalidValue;
  // threads of a block: at least as many output columns as halo columns
  int T = 128;
  while (T - 2 * radius < T / 2) T *= 2;
  const int R = 2 * radius + 1;
  const bool planes = n_bands <= PLANE_BANDS;
  const size_t smem = planes ? sizeof(uint32_t) * (size_t)(2 + R) * T
                             : (size_t)(n_bands + R) * T;
  auto kernel = planes ? speckle_kernel<true> : speckle_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ow = T - 2 * radius;
  dim3 grid((W + ow - 1) / ow, (H + SEG - 1) / SEG, B);
  kernel<<<grid, T, smem, s>>>((const float*)disp, (float*)out, H, W, invalid,
                               max_diff, lo, n_bands, radius, min_region);
  return (int)cudaGetLastError();
}
