// Kernel B7: fused self-attention for short sequences (DPT's ViT-L blocks,
// S = 577 tokens, D = 64, 16 heads).
//
// Replaces the TPU kernels video3d_tpu/kernels/attention.py:84
// attention_multihead (body _multihead_kernel, a group of heads per grid
// step) and :116 attention_oneblock (body _oneblock_kernel, one head per
// step). Both compute, per (batch, head):
//   s = (q k^T) * scale   in f32
//   m = row max of s over the S real keys
//   p = exp(s - m),  z = sum p   in f32
//   o = (p rounded to v's dtype) v   accumulated in f32
//   out = o / z, cast to q's dtype
// The TPU pads S to 128 and masks the padded keys to -1e30; here the ragged
// last 64-key tile is masked in the kernel: a key at or past S gets p = 0
// and adds to neither z nor o.
//
// What bounds it on the H100 at DPT-large's (2, 16, 577, 64) in bf16: the
// 2.73 GFLOP of QK^T and PV take 2.8 us at the tensor cores' 989 TFLOP/s,
// and the 9.45 MB of q, k, v and out take 2.8 us at 3.35 TB/s. Both are
// tiny, so the launch and the latency of each block's chain of tiles set
// the floor. Grouping heads per block, as the TPU does to amortise its
// per-grid-step cost, would only lengthen that chain, so no block loops
// over heads: attention_multihead and attention_oneblock are one launch.
//
// Each dtype takes its own route.
//
// bf16 (the DPT path), on the tensor cores: one block of two warpgroups
// (256 threads) per (64-query tile, head, batch): 320 blocks at
// (2, 16, 577, 64), all resident at once (three an SM at D = 64: under 85
// registers a thread, 74.8 KB of shared memory, all of it dynamic).
// - The two warpgroups share out the key tiles (even and odd), which
//   halves each block's chain of tiles; the block combines their row max
//   after pass 1, and their z and o after pass 2, through shared memory.
// - Q K^T is wgmma over D with Q and K from shared memory (K-major):
//   m64n64k16 in pass 1, m64n32k16 in two halves of 32 keys in pass 2, so
//   16 score registers sit beside the D / 2 of o.
// - P V is wgmma m64nDk16 with A = P from registers (the Q K^T
//   accumulator, rounded to bf16 in place, where the twin rounds p) and
//   B = V from shared memory, read transposed (MN-major). The second
//   half's Q K^T runs beside the first half's P V.
// - Q, and each warpgroup's ring of STAGES stages of 64-key K (and V)
//   tiles, arrive by TMA, swizzled as wgmma reads them, each stage
//   completing on its mbarrier. A warpgroup's thread 0 starts the copy of
//   its tile STAGES ahead as soon as the warpgroup is done with a stage, so
//   copies overlap the products. TMA zero-fills rows past S.
// - Two passes over K keep the exact row max and the twin's rounding
//   points: pass 1 streams K and reduces the row max; pass 2 streams K and
//   V again and computes s, p, z and P V. (An online rescaled softmax would
//   round p against a running max instead.)
// - The softmax stays in registers: each accumulator row lies on the 4
//   threads of a quad, which reduce the row max and z by shuffles. No
//   score tile goes through shared memory. Only the tile (pass 1) or half
//   (pass 2) that reaches S is masked; a half wholly past S is skipped.
//
// f32, on the CUDA cores: the tensor cores would need TF32, which breaks
// the twin's 1e-5 f32 gate. One block of 256 threads per (64-query tile,
// head, batch) and the same two passes; K and V tiles go through shared
// memory, each thread owns a 4x4 block of scores and a 4 x D/16 block of
// the output, and the p tile is written over the K tile.
//
// Products outside the tensor cores use explicit fmaf (the library builds
// with -fmad=false, which only stops implicit contraction); exp is expf.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int PLD = BK + 1;  // row stride of the score tile
static_assert(BK == BQ, "load_tile moves BQ rows for q, k and v alike");

// rows [r0, r0 + BQ) of one (S, D) head into a (BQ, D + 1) tile, zeros
// past S
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int r0, int S, float* dst) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < BQ * D; e += F32_THREADS) {
    const int r = e / D, c = e % D;
    dst[r * LD + c] = (r0 + r < S) ? src[(long long)(r0 + r) * D + c] : 0.0f;
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

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S,
                  float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* kp = qs + BQ * LD;    // BK x LD keys, then BQ x PLD scores
  float* vs = kp + BQ * PLD;   // BK x LD
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ;
  const long long base =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * S * D;
  const float* kh = k + base;
  const float* vh = v + base;
  load_tile<D>(q + base, q0, S, qs);

  // pass 1: exact row max of the scaled scores
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile<D>(kh, k0, S, kp);
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
    load_tile<D>(kh, k0, S, kp);
    load_tile<D>(vh, k0, S, vs);
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
        kp[(4 * ty + i) * PLD + tx + 16 * j] = p;
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

  float* oh = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        oh[(long long)row * D + tx + 16 * j] = acc[i][j] / z[i];
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int n, int s, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + BQ * PLD);
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, n, b);
  attention_f32<D><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma, TMA, mbarriers (sm_90a)
// ---------------------------------------------------------------------------

constexpr int WG = 128;    // threads of a warpgroup
constexpr int SPLIT = 2;   // warpgroups per block, sharing out the key tiles
constexpr int STAGES = 2;  // K/V stages per warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival, and the bytes the phase still waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) __trap();  // a copy that never lands fails
  }
  __syncwarp();  // converged again for the .aligned wgmma that follows
}

// the box at (c0, c1, c2) of the map into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma shared-memory matrix descriptor; SW is the swizzle span in bytes
// (the row pitch of a tile: 2 D), lbo and sbo in bytes
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}

// keep the compiler from moving reads or writes of r across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n32k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64nDk16, A (4 registers of bf16 pairs) from registers, B
// MN-major in shared memory (transposed on read)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared memory, all dynamic (three blocks fit on an SM at D = 64): the Q
// tile, then each warpgroup's ring of STAGES stages of a K tile and a V
// tile, each tile BK rows of 2 D bytes as TMA writes them; then the
// mbarriers, and each warpgroup's partial row max and z per query row.
template <int D>
__host__ __device__ constexpr size_t bf16_tile_bytes() {
  return (size_t)BK * 2 * D * (1 + 2 * STAGES * SPLIT);
}
template <int D>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return bf16_tile_bytes<D>() + sizeof(uint64_t) * (SPLIT * STAGES + 1) +
         sizeof(float) * 2 * SPLIT * BQ;
}

__device__ __forceinline__ void wg_sync(int wg) {  // one warpgroup's barrier
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
}

// SPLIT warpgroups share out a block's key tiles: warpgroup wg takes tiles
// wg, wg + SPLIT, ...; the block combines the row max after pass 1, and z
// and o after pass 2, through shared memory.
//
// The accumulator layout of wgmma m64nN (f32): thread (warp w of the
// warpgroup, lane 4 g + t) holds rows 16 w + g (h = 0) and 16 w + g + 8
// (h = 1); element 4 j + 2 h + c is column 8 j + 2 t + c. Two neighbouring
// elements, rounded and packed, are the A operand of the next product over
// those columns. Pass 2 takes its scores in halves of 32 keys, 16 registers
// each, beside the 32 of o, so that three blocks of two warpgroups fit on
// an SM; pass 1 holds no o and takes a tile's 64 scores at once.
template <int D>
__global__ void __launch_bounds__(WG * SPLIT)
    attention_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int S, float scale) {
  constexpr int SW = 2 * D;              // bytes per tile row
  constexpr uint32_t TILE = BK * SW;     // bytes per 64-row tile
  constexpr int NO = D / 2;              // PV accumulators per thread
  static_assert(2 * STAGES * TILE >= WG * NO * sizeof(float),
                "a ring holds its warpgroup's partial output");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = smem_addr(smem_raw);
  if (sq & 1023u) __trap();  // the 128-byte swizzle needs 1024-byte tiles
  // per warpgroup and stage, then Q's
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem_raw + bf16_tile_bytes<D>());
  float* xm = reinterpret_cast<float*>(bars + SPLIT * STAGES + 1);
  float* xz = xm + SPLIT * BQ;  // both [SPLIT][BQ]
  const int tid = threadIdx.x;
  const int wg = tid / WG, wt = tid % WG;
  const int q0 = blockIdx.x * BQ;
  const int bn = blockIdx.z * gridDim.y + blockIdx.y;  // head row of the maps
  const int nk = (S + BK - 1) / BK;
  const int mine = (nk - wg + SPLIT - 1) / SPLIT;  // this warpgroup's tiles
  const int total = 2 * mine;  // pass 1's K tiles, then pass 2's K and V
  const uint32_t ring = sq + TILE * (1 + 2 * STAGES * wg);
  const uint32_t qbar = smem_addr(&bars[SPLIT * STAGES]);

  // tile `it` of this warpgroup's sequence: its stage, its first key
  auto stage_of = [&](int it) { return ring + 2 * TILE * (it % STAGES); };
  auto key0_of = [&](int it) { return (wg + SPLIT * (it % mine)) * BK; };
  auto bar_of = [&](int it) {
    return smem_addr(&bars[wg * STAGES + it % STAGES]);
  };
  // the copy of tile `it` into its stage (the warpgroup's thread 0)
  auto fetch = [&](int it) {
    const uint32_t bar = bar_of(it), sk = stage_of(it);
    const int k0 = key0_of(it);
    if (it < mine) {
      mbar_expect_tx(bar, TILE);
      tma_load(sk, &tk, 0, k0, bn, bar);
    } else {
      mbar_expect_tx(bar, 2 * TILE);
      tma_load(sk, &tk, 0, k0, bn, bar);
      tma_load(sk + TILE, &tv, 0, k0, bn, bar);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= SPLIT * STAGES; ++i)
      mbar_init(smem_addr(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_expect_tx(qbar, TILE);
    tma_load(sq, &tq, 0, q0, bn, qbar);
  }
  if (wt == 0)
    for (int it = 0; it < STAGES && it < total; ++it) fetch(it);

  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // K-major Q and K: rows SW bytes apart, 8-row groups 8 SW apart; a k16
  // step is 32 bytes along the row
  const uint64_t dq = make_desc<SW>(sq, 16, 8 * SW);
  float m[2] = {-INFINITY, -INFINITY};
  float z[2] = {0.0f, 0.0f};
  float acc[NO];  // zeroed after pass 1, which leaves its registers free
  float s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.0f;
  mbar_wait(qbar, 0);

  auto wait_for = [&](int it) { mbar_wait(bar_of(it), (it / STAGES) & 1); };
  auto hand_back = [&](int it) {  // the warpgroup is done with the stage
    wg_sync(wg);
    if (wt == 0 && it + STAGES < total) fetch(it + STAGES);
  };

  // pass 1, one tile: s = Q K^T (m64n64) and the row max over real keys
  auto pass1 = [&](int it) {
    const uint32_t sk = stage_of(it);
    const int k0 = key0_of(it);
    wait_for(it);
    float s64[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s64[i] = 0.0f;
    const uint64_t dk = make_desc<SW>(sk, 16, 8 * SW);
    fence_regs(s64);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s64, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wg_commit_wait();
    fence_regs(s64);
    auto max_of = [&](bool masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!masked || k0 + 8 * j + 2 * t + (e & 1) < S)
            m[e >> 1] = fmaxf(m[e >> 1], s64[4 * j + e] * scale);
    };
    if (k0 + BK > S)  // only the last tile has keys at or past S
      max_of(true);
    else
      max_of(false);
    hand_back(it);
  };

  // pass 2, one tile, in halves of 32 keys: s = Q K^T (m64n32), p and z,
  // and o += P V; the second half's Q K^T runs beside the first's P V
  auto pass2 = [&](int it) {
    const uint32_t sk = stage_of(it);
    const int k0 = key0_of(it);
    wait_for(it);
    const uint64_t dk = make_desc<SW>(sk, 16, 8 * SW);
    auto qk = [&](int hf) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32(s, dq + 2 * kk, dk + (32 * hf * SW >> 4) + 2 * kk,
                     kk > 0);
    };
    uint32_t pa[8];
    auto softmax = [&](int hf) {  // s -> p, z += p, pa = p rounded to bf16
      const int c0 = k0 + 32 * hf;
      auto p_of = [&](bool masked) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = !masked || c0 + 8 * j + 2 * t + (e & 1) < S
                                ? expf(s[4 * j + e] * scale - m[e >> 1])
                                : 0.0f;
            z[e >> 1] += p;
            s[4 * j + e] = p;
          }
      };
      if (c0 + 32 > S)  // only the half that reaches S is masked
        p_of(true);
      else
        p_of(false);
#pragma unroll
      for (int i = 0; i < 8; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    // V, MN-major: D contiguous in each SW-byte row, 8-key groups 8 SW
    // apart; a k16 step is 16 rows
    auto pv = [&](int hf) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs<D>(acc, pa + 4 * kk,
                    make_desc<SW>(sk + TILE + (32 * hf + 16 * kk) * SW,
                                  8 * SW * 8, 8 * SW));
    };
    const bool second = k0 + 32 < S;  // the ragged tile may end in half 0
    fence_regs(s);
    wg_fence();
    qk(0);
    wg_commit_wait();
    fence_regs(s);
    softmax(0);
    fence_regs(s);
    fence_regs(acc);
    wg_fence();
    pv(0);
    if (second) qk(1);
    wg_commit_wait();
    fence_regs(s);
    fence_regs(acc);
    if (second) {
      softmax(1);
      fence_regs(acc);
      wg_fence();
      pv(1);
      wg_commit_wait();
      fence_regs(acc);
    }
    hand_back(it);
  };

  int it = 0;
  for (; it < mine; ++it) pass1(it);
  const int row0 = 16 * warp + g;  // this thread's rows: row0 and row0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    if (t == 0) xm[wg * BQ + row0 + 8 * h] = m[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int w = 0; w < SPLIT; ++w)
      m[h] = fmaxf(m[h], xm[w * BQ + row0 + 8 * h]);
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  for (; it < total; ++it) pass2(it);

  // z and o: the other warpgroups' partial sums into warpgroup 0, through
  // their own rings (their copies have all landed and been read)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    z[h] += __shfl_xor_sync(0xffffffffu, z[h], 1);
    z[h] += __shfl_xor_sync(0xffffffffu, z[h], 2);
    if (t == 0) xz[wg * BQ + row0 + 8 * h] = z[h];
  }
  if (wg > 0) {
    float* part = reinterpret_cast<float*>(smem_raw + (ring - sq));
#pragma unroll
    for (int i = 0; i < NO; ++i) part[i * WG + wt] = acc[i];
  }
  __syncthreads();
  if (wg > 0) return;
#pragma unroll
  for (int w = 1; w < SPLIT; ++w) {
    const float* part = reinterpret_cast<const float*>(
        smem_raw + TILE * (1 + 2 * STAGES * w));
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] += part[i * WG + wt];
#pragma unroll
    for (int h = 0; h < 2; ++h) z[h] += xz[w * BQ + row0 + 8 * h];
  }
  __nv_bfloat16* oh = o + (size_t)bn * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row < S) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * D + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] / z[h],
                                  acc[4 * j + 2 * h + 1] / z[h]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, CUDA's tiled tensor-map encoder, through the
// runtime's entry-point query (no link to libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// one (bn, s, D) bf16 tensor as 3-D boxes of (D, BK, 1), swizzled by the
// row pitch 2 D; rows past s read as zeros
template <int D>
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int bn,
              int s) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)bn};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)s * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)BK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int n, int s, float scale, cudaStream_t stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;  // TMA needs 16-byte bases
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, encode, q, b * n, s) ||
      !make_map<D>(&mk, encode, k, b * n, s) ||
      !make_map<D>(&mv, encode, v, b * n, s))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((s + BQ - 1) / BQ, n, b);
  attention_bf16<D><<<grid, WG * SPLIT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (b, n, s, d), d in {16, 32, 64}; dtype 0 = f32
// (CUDA cores), 1 = bf16 (tensor cores; 16-byte aligned pointers)
extern "C" int v3d_attention(const void* q, const void* k, const void* v,
                             void* o, int b, int n, int s, int d, int dtype,
                             float scale, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(q, k, v, o, b, n, s, scale, st);
      case 32: return launch_f32<32>(q, k, v, o, b, n, s, scale, st);
      case 64: return launch_f32<64>(q, k, v, o, b, n, s, scale, st);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16>(q, k, v, o, b, n, s, scale, st);
      case 32: return launch_bf16<32>(q, k, v, o, b, n, s, scale, st);
      case 64: return launch_bf16<64>(q, k, v, o, b, n, s, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
