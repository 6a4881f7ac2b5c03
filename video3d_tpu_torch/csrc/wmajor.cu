// Kernels B8b and B8c: the W-major horizontal route of the SGM matcher.
//
// B8c replaces the TPU kernel video3d_tpu/kernels/sgm.py
// _directional_pass_wmajor (body _row_kernel_wmajor): one horizontal SGM
// sweep, forward or reverse along W, of the W-major (B, D, W, HL) volume
// (HL: image rows, padded or not), with f32 carries, shift set (0,), int16
// or f32 storage of cost and accumulator. B8b replaces
// transpose_to_wmajor / transpose_from_wmajor (bodies _mxu_t_kernel_fwd /
// _bwd): exact layout changes between the port's (B, H, W, D) volume and
// (B, D, W, HP), HP = H rounded up to 128. The TPU computes its transposes
// as bf16 hi/lo identity matmuls on the MXU, a device of that chip; here
// they are plain tiled transposes, equal in value.
//
// What bounds them on the H100: B8b moves each element once each way (531
// MB in and ~566 MB out for two 1080p frames at D=64 in int16: ~0.33 ms at
// 3.35 TB/s). B8c reads the cost and read-modify-writes the accumulator,
// the same bytes as a B2 sweep, but each of its B*HL threads walks a
// serial chain of W steps, each a min over D in registers: 2160 threads
// for two 1080p frames fill 68 warps of the card's 132 SMs, so the chain's
// latency, not bandwidth, bounds it.
//
// B8c design: the W-major layout puts the image row on the last axis, so
// one thread owns one (b, row) and walks W with its D carries in registers;
// the min over D stays in the thread. Adjacent threads read adjacent rows,
// so every load and store of a step coalesces. A step first loads all D
// costs (and accumulator values) into registers -- independent loads in
// flight together -- then updates the carries in the TPU kernel's order of
// operations, taking the next step's min over D on the way. Values are
// integers below 2^24, so f32 is exact.
//
// B8b design: a 32x32 tile through shared memory (one padding column
// against bank conflicts) per (b, x) and tile of (h, d); reads run along d
// in the input and writes along h in the output, both coalesced. Padding
// lanes h >= H of the W-major volume are written as zero; the inverse reads
// only h < H.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIGF = 1e9f;

// type codes of the C interface
enum { T_I16 = 0, T_F32 = 1 };

__device__ __forceinline__ float ld(const int16_t* p, long long i) {
  return (float)p[i];
}
__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ void st(int16_t* p, long long i, float v) {
  p[i] = (int16_t)(int)v;  // integer-valued, in range by acc_dtype_for_params
}
__device__ __forceinline__ void st(float* p, long long i, float v) {
  p[i] = v;
}

// grid (ceil(HL / 32), B), 32 threads: thread h walks row h of frame b
template <typename CT, typename AT, int DC>
__global__ void wmajor_sweep_kernel(const CT* __restrict__ cost,
                                    const AT* acc_in, AT* acc_out, int D,
                                    int W, int HL, float p1, float p2,
                                    int reverse) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= HL) return;
  const long long plane = (long long)W * HL;  // stride of d
  const long long base = (long long)blockIdx.y * D * plane + h;
  float L[DC], c[DC], a[DC];
#pragma unroll
  for (int d = 0; d < DC; ++d) L[d] = d < D ? 0.0f : BIGF;
  float m = 0.0f;  // min over d of L, kept up to date by each step
  for (int t = 0; t < W; ++t) {
    const int x = reverse ? W - 1 - t : t;
    const long long off = base + (long long)x * HL;
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      c[d] = 0.0f;
      a[d] = 0.0f;
      if (d < D) {
        c[d] = ld(cost, off + d * plane);
        if (acc_in) a[d] = ld(acc_in, off + d * plane);
      }
    }
    float dn = BIGF;  // L[d - 1] before this step
    float m_next = BIGF;
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      if (d < D) {
        const float up = d + 1 < DC ? L[d + 1] : BIGF;  // BIGF past D
        const float best = fminf(fminf(L[d], m + p2), fminf(up, dn) + p1);
        const float ln = (c[d] + best) - m;
        dn = L[d];
        L[d] = ln;
        m_next = fminf(m_next, ln);
        st(acc_out, off + d * plane, acc_in ? a[d] + ln : ln);
      }
    }
    m = m_next;
  }
}

template <typename CT, typename AT, int DC>
int launch_wmajor(const void* cost, const void* acc_in, void* acc_out, int B,
                  int D, int W, int HL, float p1, float p2, int reverse,
                  cudaStream_t s) {
  dim3 grid((HL + 31) / 32, B);
  wmajor_sweep_kernel<CT, AT, DC><<<grid, 32, 0, s>>>(
      (const CT*)cost, (const AT*)acc_in, (AT*)acc_out, D, W, HL, p1, p2,
      reverse);
  return (int)cudaGetLastError();
}

template <typename CT, typename AT>
int wmajor_dc(const void* cost, const void* acc_in, void* acc_out, int B,
              int D, int W, int HL, float p1, float p2, int reverse,
              cudaStream_t s) {
  if (D <= 16)
    return launch_wmajor<CT, AT, 16>(cost, acc_in, acc_out, B, D, W, HL, p1,
                                     p2, reverse, s);
  if (D <= 32)
    return launch_wmajor<CT, AT, 32>(cost, acc_in, acc_out, B, D, W, HL, p1,
                                     p2, reverse, s);
  if (D <= 64)
    return launch_wmajor<CT, AT, 64>(cost, acc_in, acc_out, B, D, W, HL, p1,
                                     p2, reverse, s);
  if (D <= 128)
    return launch_wmajor<CT, AT, 128>(cost, acc_in, acc_out, B, D, W, HL, p1,
                                      p2, reverse, s);
  return (int)cudaErrorInvalidValue;
}

constexpr int TT = 32;  // transpose tile

// (B, H, W, D) -> (B, D, W, HP), zero lanes h >= H.
// grid (B * W, HP / 32, ceil(D / 32)), block (32, 8)
template <typename T>
__global__ void to_wmajor_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 int H, int W, int D, int HP) {
  __shared__ T tile[TT][TT + 1];
  const long long bw = blockIdx.x;
  const long long b = bw / W;
  const int x = (int)(bw % W);
  const int h0 = blockIdx.y * TT, d0 = blockIdx.z * TT;
  for (int i = threadIdx.y; i < TT; i += blockDim.y) {
    const int h = h0 + i, d = d0 + threadIdx.x;
    T v = 0;
    if (h < H && d < D) v = in[((b * H + h) * W + x) * D + d];
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TT; i += blockDim.y) {
    const int d = d0 + i, h = h0 + threadIdx.x;
    if (d < D && h < HP) out[((b * D + d) * W + x) * HP + h] = tile[threadIdx.x][i];
  }
}

// (B, D, W, HP) -> (B, H, W, D), rows h < H only.
// grid (B * W, ceil(H / 32), ceil(D / 32)), block (32, 8)
template <typename T>
__global__ void from_wmajor_kernel(const T* __restrict__ in,
                                   T* __restrict__ out, int H, int W, int D,
                                   int HP) {
  __shared__ T tile[TT][TT + 1];
  const long long bw = blockIdx.x;
  const long long b = bw / W;
  const int x = (int)(bw % W);
  const int h0 = blockIdx.y * TT, d0 = blockIdx.z * TT;
  for (int i = threadIdx.y; i < TT; i += blockDim.y) {
    const int d = d0 + i, h = h0 + threadIdx.x;
    T v = 0;
    if (d < D && h < H) v = in[((b * D + d) * W + x) * HP + h];
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TT; i += blockDim.y) {
    const int h = h0 + i, d = d0 + threadIdx.x;
    if (h < H && d < D) out[((b * H + h) * W + x) * D + d] = tile[threadIdx.x][i];
  }
}

template <typename T>
int launch_transpose(const void* in, void* out, int B, int H, int W, int D,
                     int HP, int to_wmajor, cudaStream_t s) {
  dim3 block(TT, 8);
  if (to_wmajor) {
    dim3 grid((unsigned)B * W, (HP + TT - 1) / TT, (D + TT - 1) / TT);
    to_wmajor_kernel<T><<<grid, block, 0, s>>>((const T*)in, (T*)out, H, W,
                                               D, HP);
  } else {
    dim3 grid((unsigned)B * W, (H + TT - 1) / TT, (D + TT - 1) / TT);
    from_wmajor_kernel<T><<<grid, block, 0, s>>>((const T*)in, (T*)out, H, W,
                                                 D, HP);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One horizontal sweep of the (B, D, W, HL) cost along W (reverse: right to
// left), added into acc_out; acc_in is NULL for a fresh accumulation or
// equal to acc_out. (cost_type, acc_type): (int16, int16), (int16, f32) or
// (f32, f32).
extern "C" int v3d_wmajor_sweep(void* cost, void* acc_in, void* acc_out,
                                int B, int D, int W, int HL, float p1,
                                float p2, int reverse, int cost_type,
                                int acc_type, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cost_type == T_I16 && acc_type == T_I16)
    return wmajor_dc<int16_t, int16_t>(cost, acc_in, acc_out, B, D, W, HL,
                                       p1, p2, reverse, s);
  if (cost_type == T_I16 && acc_type == T_F32)
    return wmajor_dc<int16_t, float>(cost, acc_in, acc_out, B, D, W, HL, p1,
                                     p2, reverse, s);
  if (cost_type == T_F32 && acc_type == T_F32)
    return wmajor_dc<float, float>(cost, acc_in, acc_out, B, D, W, HL, p1,
                                   p2, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Exact layout change of 2- or 4-byte elements: to_wmajor != 0 maps
// (B, H, W, D) -> (B, D, W, HP), else (B, D, W, HP) -> (B, H, W, D).
extern "C" int v3d_wmajor_transpose(void* in, void* out, int B, int H, int W,
                                    int D, int HP, int elem_size,
                                    int to_wmajor, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 2)
    return launch_transpose<uint16_t>(in, out, B, H, W, D, HP, to_wmajor, s);
  if (elem_size == 4)
    return launch_transpose<uint32_t>(in, out, B, H, W, D, HP, to_wmajor, s);
  return (int)cudaErrorInvalidValue;
}
