// Kernel B7: fused self-attention for short sequences (DPT's ViT-L blocks,
// S = 577 tokens, D = 64, 16 heads).
//
// Replaces the TPU kernels video3d_tpu/kernels/attention.py
// attention_multihead (body _multihead_kernel, a group of heads per grid
// step) and attention_oneblock (body _oneblock_kernel, one head per step).
// Both compute, per (batch, head):
//   s = (q k^T) * scale   in f32
//   m = row max of s over the S real keys
//   p = exp(s - m),  z = sum p   in f32
//   o = (p rounded to v's dtype) v   accumulated in f32
//   out = o / z, cast to q's dtype
// The TPU pads S to 128 and masks the padded keys to -1e30; here the key
// loop runs over the S real keys and the ragged last tile is guarded.
//
// What bounds it on the H100: arithmetic. One head at S = 577, D = 64 is
// 85 MFLOP of products against 0.2 MB of q, k, v, far above the card's
// ratio of flops to bytes; this first kernel runs the products on the CUDA
// cores in f32 (tensor cores via wgmma are later work), so it is bound by
// FMA issue and shared-memory reads.
//
// Design: one block of 256 threads per (tile of 64 queries, group of
// heads_per_block heads, batch); the heads of a group run one after the
// other (1 for attention_oneblock, 8 for attention_multihead). K and V
// stream through shared memory in tiles of 64 keys, converted to f32. Two
// passes over K: the first finds the exact row max, the second computes p,
// z and the PV sum, so the softmax rounds as the single-pass TPU kernel
// does, with no online rescale. Each thread owns a 4x4 block of scores
// (queries 4*ty.., keys tx + 16 j) and a 4 x D/16 block of the output;
// row max and z are reduced over the 16 lanes of a half warp by shuffles.
// The score tile is written, rounded, over the K tile once the scores are
// in registers. Products use explicit fmaf (the library builds with
// -fmad=false, which only stops implicit contraction); exp is expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int PLD = BK + 1;  // row stride of the score tile
static_assert(BK == BQ, "load_tile moves BQ rows for q, k and v alike");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// rows [r0, r0 + BQ) of one (S, D) head into a (BQ, D + 1) f32 tile,
// zeros past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int S, float* dst) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * LD + c] = (r0 + r < S) ? to_f(src[(long long)(r0 + r) * D + c])
                                   : 0.0f;
  }
}

// the thread's 4x4 block of unscaled scores against the K tile in kt
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* kt,
                                       int ty, int tx, float s[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = kt[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int N,
                     int S, int hpb, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* kp = qs + BQ * LD;    // BK x LD keys, then BQ x PLD scores
  float* vs = kp + BQ * PLD;   // BK x LD
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ;

  for (int hh = 0; hh < hpb; ++hh) {
    const int head = blockIdx.y * hpb + hh;
    const long long base = ((long long)blockIdx.z * N + head) * S * D;
    const T* qh = q + base;
    const T* kh = k + base;
    const T* vh = v + base;
    __syncthreads();  // the previous head is done with every tile
    load_tile<T, D>(qh, q0, S, qs);

    // pass 1: exact row max of the scaled scores
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int k0 = 0; k0 < S; k0 += BK) {
      __syncthreads();
      load_tile<T, D>(kh, k0, S, kp);
      __syncthreads();
      float s[4][4];
      scores<D>(qs, kp, ty, tx, s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j < S) {
#pragma unroll
          for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j] * scale);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));

    // pass 2: p, z and the PV sum
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < S; k0 += BK) {
      __syncthreads();
      load_tile<T, D>(kh, k0, S, kp);
      load_tile<T, D>(vh, k0, S, vs);
      __syncthreads();
      float s[4][4];
      scores<D>(qs, kp, ty, tx, s);
      __syncthreads();  // every thread has its scores: kp becomes P
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool real = k0 + tx + 16 * j < S;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = real ? expf(s[i][j] * scale - m[i]) : 0.0f;
          z[i] += p;
          kp[(4 * ty + i) * PLD + tx + 16 * j] = to_f(from_f<T>(p));
        }
      }
      __syncthreads();
      const int kn = min(BK, S - k0);
      for (int kk = 0; kk < kn; ++kk) {
        float vv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = kp[(4 * ty + i) * PLD + kk];
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        z[i] += __shfl_xor_sync(0xffffffffu, z[i], off);

    T* oh = o + base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row < S) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          oh[(long long)row * D + tx + 16 * j] = from_f<T>(acc[i][j] / z[i]);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int n,
           int s, int hpb, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + BQ * PLD);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, n / hpb, b);
  attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, s, hpb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int n, int s, int d, int hpb, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, n, s, hpb, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, n, s, hpb, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, n, s, hpb, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (b, n, s, d); dtype 0 = f32, 1 = bf16; hpb heads
// per block, dividing n.
extern "C" int v3d_attention(const void* q, const void* k, const void* v,
                             void* o, int b, int n, int s, int d, int hpb,
                             int dtype, float scale, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || hpb <= 0 || n % hpb != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, b, n, s, d, hpb, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, n, s, d, hpb, scale, st);
  return (int)cudaErrorInvalidValue;
}
