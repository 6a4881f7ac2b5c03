// Device helpers shared by the SGM sweep kernels B2, B3, B8a (sgm.cu) and
// B8c (wmajor.cu): a pixel's D disparities held by lanes_per_pixel lanes of
// a warp, three or four adjacent ones a lane; the min over D as a shuffle
// butterfly, the d-1/d+1 neighbours over shuffles; asynchronous copies into
// shared memory; and B3's packed route, eight disparities a lane as signed
// 16-bit pairs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace v3dsgm {

constexpr int SENT = 1 << 20;  // integer carry sentinel past both ends of d
constexpr float BIGF = 1e9f;   // f32 carry sentinel (the TPU kernel's)
constexpr unsigned FULL = 0xffffffffu;

// a bf16 cost value as its 16 bits (the top half of an f32's)
struct Bf16Bits { uint16_t x; };

// the step's arithmetic for a cost type: int32 for int16 (exact), else f32
template <typename CT>
struct Compute { using type = int; };
template <>
struct Compute<float> { using type = float; };
template <>
struct Compute<Bf16Bits> { using type = float; };

// Lanes of a warp that share one pixel, each with three or four adjacent
// disparities (DPL: 4, or 3 for 64 < D <= 96): a warp holds 4, 2 or 1
// pixels, so the shuffles of a step are shared between them.
__host__ __device__ inline int lanes_per_pixel(int D) {
  return D <= 32 ? 8 : D <= 64 ? 16 : 32;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* global) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(global)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int lmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ float lmin(float a, float b) { return fminf(a, b); }

// min over the LPP lanes of a pixel
template <int LPP, typename C>
__device__ __forceinline__ C seg_min(C v) {
#pragma unroll
  for (int o = LPP / 2; o > 0; o >>= 1)
    v = lmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// One step of the recurrence on a lane's DPL disparities of a pixel held
// by LPP lanes, in the TPU kernel's order of operations, (c + best) - m,
// with `sent` past both ends of d. An int32 step is exact (integer costs):
// past D the cost is SENT, so a carry there is SENT or more (and at most
// SENT + p2) from the first step on and no step needs a mask: it never is
// the minimum, and as the neighbour of D - 1 it loses to every real value,
// as the sentinel would. An f32 step rounds as the TPU kernel and the twin
// do; its caller sets the carries past D back to the sentinel.
template <int LPP, int DPL, typename C>
__device__ __forceinline__ void sgm_step(const C (&L)[DPL], const C (&c)[DPL],
                                         C (&Ln)[DPL], int dl, C p1, C p2,
                                         C sent = C(SENT)) {
  C m = L[0];
#pragma unroll
  for (int j = 1; j < DPL; ++j) m = lmin(m, L[j]);
  m = seg_min<LPP>(m);
  C below = __shfl_up_sync(FULL, L[DPL - 1], 1, LPP);
  C above = __shfl_down_sync(FULL, L[0], 1, LPP);
  if (dl == 0) below = sent;
  if (dl == LPP - 1) above = sent;
  const C mp2 = m + p2;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    C dn = j > 0 ? L[j - 1] : below;
    C up = j < DPL - 1 ? L[j + 1] : above;
    C best = lmin(lmin(L[j], mp2), lmin(up, dn) + p1);
    Ln[j] = (c[j] + best) - m;
  }
}

// B3's packed route (sgm.cu's note): a lane's eight disparities d0..d0+7
// as four 32-bit words of signed 16-bit halves, (d0, d0+1) .. (d0+6,
// d0+7), the lower disparity in the low half, every value in [0, 2^15).
// Hopper's DPX instructions (and __vmins2, native from sm_90) take the
// min, or the add then the min, of both halves in one instruction.
constexpr int SENT16 = 1 << 14;  // carry and cost sentinel past both ends of d
constexpr int TSENT16 = 0x7fff;  // a total past D
constexpr unsigned PAIR_MAX = 0x7fff7fffu;

// v in both halves
__host__ __device__ constexpr unsigned pair_of(int v) {
  return (unsigned)(v & 0xffff) * 0x10001u;
}

// (high half of x, low half of y): the pair one disparity above x's low half
__device__ __forceinline__ unsigned pair_shift(unsigned x, unsigned y) {
  return __byte_perm(x, y, 0x5432);
}

// min over the lane's NP pairs, then over the LPP lanes of the pixel, then
// over the two halves: the pixel's minimum in both halves
template <int LPP, int NP>
__device__ __forceinline__ unsigned seg_min_pairs(const unsigned (&L)[NP]) {
  unsigned v = L[0];
#pragma unroll
  for (int k = 1; k < NP; ++k) v = __vmins2(v, L[k]);
#pragma unroll
  for (int o = LPP / 2; o > 0; o >>= 1)
    v = __vmins2(v, __shfl_xor_sync(FULL, v, o));
  return __vmins2(v, __byte_perm(v, 0, 0x1032));
}

// sgm_step on NP pairs: best = min(L, min(L(d-1), L(d+1)) + P1, m + P2),
// taken as min(min(L(d-1), L(d+1), m + P2 - P1) + P1, L) in two DPX
// instructions a pair, then Ln = c + best - m as one 32-bit add of both
// halves (no carry or borrow crosses them: the note in sgm.cu). p1 is P1
// and p21 is P2 - P1 in both halves. The neighbours past both ends of the
// pixel's disparities are SENT16; past D the caller's cost is SENT16, so
// every carry there lies in [SENT16, SENT16 + P2].
template <int LPP, int NP>
__device__ __forceinline__ void sgm_step_pairs(const unsigned (&L)[NP],
                                               const unsigned (&c)[NP],
                                               unsigned (&Ln)[NP], int dl,
                                               unsigned p1, unsigned p21) {
  const unsigned m = seg_min_pairs<LPP>(L);
  unsigned below = __shfl_up_sync(FULL, L[NP - 1], 1, LPP);  // high: d0 - 1
  unsigned above = __shfl_down_sync(FULL, L[0], 1, LPP);  // low: d0 + 2 NP
  if (dl == 0) below = pair_of(SENT16);
  if (dl == LPP - 1) above = pair_of(SENT16);
  const unsigned mq = __viaddmin_s16x2(m, p21, PAIR_MAX);  // m + P2 - P1
  unsigned dn = pair_shift(below, L[0]);  // (d - 1) of pair k's two
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const unsigned up = pair_shift(L[k], k + 1 < NP ? L[k + 1] : above);
    const unsigned best =
        __viaddmin_s16x2(__vimin3_s16x2(dn, up, mq), p1, L[k]);
    Ln[k] = c[k] + best - m;
    dn = up;
  }
}

}  // namespace v3dsgm
