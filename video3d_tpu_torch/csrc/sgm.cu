// Kernels B2, B3 and B8a: semi-global path sweeps and winner-take-all.
//
// Replace the TPU kernels video3d_tpu/kernels/sgm.py
// _directional_pass_dmajor (body _row_kernel_dmajor; B2, the two horizontal
// sweeps of the int16 volume into an int16 or f32 accumulator, which the
// TPU runs as two calls), sgm_wta_pallas_dmajor
// (body _final_wta_kernel_dmajor; B3, the vertical sweeps fused with WTA:
// top-down for MODE_SGBM, top-down then bottom-up for 4 and 8 paths) and
// _directional_pass (body _row_kernel; B8a, the sweeps of
// sgm_aggregate_pallas on an f32 or bf16 (B, H, W, D) cost with f32
// carries, one call per direction). The TPU walks a row-block grid in
// order with the carries in VMEM, all vertical directions and the WTA in
// one walk down the rows, the total never stored.
//
// B8a runs on B2's and B3's kernels instantiated for a float cost: the
// horizontal pair is one horizontal_kernel launch and each vertical sweep
// step one vertical_kernel launch that stores the f32 total where B3's
// closing launch runs the WTA. 2 paths is one launch, 5 paths two, 4 and
// 8 paths three (top-down writes the accumulator, bottom-up stores the
// total). At 1080p, D = 64, f32 cost, 8 paths this moves 5,839 MB a
// frame (2,654 in the horizontal launch: cost twice, accumulator three
// times; 1,592 in each vertical one: cost and accumulator read, total
// written), 4,777 with a bf16 cost, where a launch per direction, each
// reading the cost and reading and writing the running total, moves
// 12,209 and a single pass that read the cost once and wrote the total
// once would move 1,062. Measured, the vertical launches take as long with
// a bf16 cost as with f32: like B3's they are bound by a row's chain of
// operations more than by bytes.
//
// B2, horizontal_kernel: both horizontal directions in one launch. The
// second direction to reach a pixel needs the first one's sum for it, and
// a row's sums (245 KB at 1080p, D=64) times the rows it takes to fill the
// card do not fit shared memory or the L2, so the work moves the cost
// twice and the accumulator three times whatever the order: 1,325 MB a
// 1080p frame at D=64 in int16 (0.40 ms at 3.35 TB/s) against the 530 MB
// (0.16 ms) of reading the cost and writing the sum once. What the design
// saves is operations, latency and a launch: a row's pixel is held by
// lanes_per_pixel lanes with three or four disparities each, as in B3, so
// the rows of a warp share a step's shuffles; a thread runs the row's two
// directions as two independent chains from the two ends, which cross in
// the middle (see the kernel); every line keeps HPF pixels in flight by
// asynchronous copies; moves are 8 or 16 bytes a lane; and the grid is
// sized from the occupancy, each warp taking rows in turn.
//
// B3, vertical_kernel: what the work needs is the cost and the horizontal
// accumulator read once and two small planes written -- 530 MB a 1080p
// frame at D=64 with an int16 accumulator, 795 MB with f32 (0.16 and 0.24
// ms at 3.35 TB/s). So all directions that share a dy run in one launch,
// and the launch that closes the mode does the left-image WTA on the total
// it holds in registers: the total is never written and never read back.
// 5 paths is one launch; 4 and 8 paths are two (top-down writes the
// accumulator once, bottom-up closes); 2 paths is the WTA alone. Measured
// on the card, what then bounds the kernel is not the bytes but the
// instructions each lane issues a row (the card issues 64 lanes of integer
// operations a clock and multiprocessor), so the design spends as few as
// it can on each pixel. Of the int32 route's roughly 450 a lane and row
// (1080p, D = 64, from the SASS), the recurrence's min, add and shuffle
// are about a third; addresses, the edge exchange, the WTA's butterflies
// and selects and the right-image votes the rest. The packed route (below)
// takes 5 paths at batch 8 from 0.77 to 0.48 ms a frame, 3x its byte
// bound; there the right-image votes are 0.10 of it (0.38 without the LR
// check) and a WTA alone on the int32 layout 0.37 (H100 SXM at 700 W):
//   - A pixel is held by 8, 16 or 32 lanes (lanes_per_pixel), each with
//     three or four adjacent disparities, so a warp walks 4, 2 or 1
//     adjacent columns down the rows in sweep order and the shuffles of a
//     step (the min over D, the d-1/d+1 neighbours) serve all of them. The
//     vertical carry stays in registers. Past D the cost reads as the
//     sentinel, once a row, and nothing after that needs a mask.
//   - A diagonal at column x needs the previous row's carry of column
//     x - dx: inside the block's strip of columns that goes through a
//     double-buffered shared-memory array and one __syncthreads() a row.
//   - Each column keeps PF rows of cost and accumulator in flight, copied
//     asynchronously (cp.async, 16 bytes a lane) into its own ring of
//     shared-memory slots, so no step waits for a load it has just asked
//     for. (Where a pixel's D values do not start on 16-byte boundaries
//     the lanes load them one by one.)
//   - Across strips the edge column's carry goes through global memory:
//     each value is stored in one word with the row's tag above it (int:
//     32 bits, a 12-bit tag above 20 bits of value, since a path value
//     stays below 2^19 in size: the wrapper bounds the mode's total by
//     2^20; f32: 64 bits, the tag above the float's bits), in a ring of
//     four rows, and the neighbour spins on the words it needs until the
//     tag is the row's -- no fence, no separate flag. An edge column first does the direction whose carry it
//     publishes, asks for the neighbour's words before that step and looks
//     at them after it. A block can run at most one row ahead of its
//     neighbour, so a ring of four is never overwritten unread. All blocks
//     of a launch must be resident for this: the launch is cooperative, the
//     grid is sized from the occupancy, and the C function loops over
//     chunks of frames when B x strips exceeds it. A refused launch returns
//     its error; nothing falls back to per-direction launches.
//   - Every block of a frame advances in lockstep with its neighbours, so
//     fewer, wider strips run faster as long as every multiprocessor still
//     has a block: a block has 32 warps (one block a multiprocessor) where
//     launches of such blocks would be nearly full, else 16 (two blocks),
//     chosen by vertical_warps from the batch, the width and D.
//   - The closing launch takes the first minimum by the v*256 + d key, the
//     second minimum and the neighbours of the first per pixel and row; the
//     f32 part (sub-pixel step, uniqueness test, margin) runs once for as
//     many rows as the pixel has lanes, each lane one row.
//     The right-image WTA (first minimum over d of total[y, xr+d+md, d])
//     crosses columns: pixel x votes its key for xr = x - d - md with a
//     shared-memory atomicMin over the strip, and a row later the strip's
//     CW + D - 1 keys go to its own run of a (B, H, strips, CW + D - 1)
//     plane with plain stores. (One global atomicMin per touched xr into a
//     (B, H, W) plane was measured first: every block of a frame is on the
//     same row at the same time, the atomics on that row's few lines
//     serialise, and the next row's barrier waits for them -- more than
//     half of the kernel's time.) lr_kernel, a small elementwise kernel, then takes for
//     each valid pixel the least key over the strips that reach its xr --
//     ties go to the smallest d because the key orders them -- and applies
//     the LR check to the disparity.
//
// B3's packed route (vertical_kernel with PK; kernels/sgm.py
// vertical_route picks it): B3's int16 5-path closing launch -- int16 cost
// and accumulator, three directions and the WTA -- on signed 16-bit pairs,
// each instruction of the recurrence on two disparities. Every value it
// forms is an exact integer in [0, 2^15), so it gives the int32 route's
// bits.
//   - Layout: eight disparities a lane (half the lanes of lanes_per_pixel:
//     4, 8 or 16 a pixel, a warp on 8, 4 or 2 columns, strips twice as
//     wide), as four 32-bit words (d0, d0+1) .. (d0+6, d0+7), the lower
//     disparity in the low half. A lane's run of int16 values is one
//     16-byte cp.async piece, one 16-byte shared load from the ring or
//     from the diagonal carries (2 bytes a value), never widened; the edge
//     exchange sends a pair as one 64-bit word, its row's tag above it.
//     Eight a lane halves the lanes, and with them the per-lane work of a
//     row that is not the recurrence (addresses, the min butterflies, the
//     WTA's bookkeeping): with four a lane the pairs ran only 4% faster.
//   - The step (sgm_common.cuh sgm_step_pairs): m is __vmins2 over the
//     lane's pairs, the butterfly over the pixel's lanes, then the min of
//     the two halves; the neighbour pairs (d-1, d) and (d+1, d+2) are byte
//     permutes of the lane's pairs and of the one shuffled pair at each end
//     of the lane; best = min(min(L(d-1), L(d+1), m + P2 - P1) + P1, L) is
//     __vimin3_s16x2 then __viaddmin_s16x2; Ln = c + best - m is one 32-bit
//     add of three words. No carry or borrow crosses the halves: per half
//     c >= 0 and best >= m (every carry, neighbour and m + P2 is at least
//     m), so c + best - m lies in [0, 2^15), and a 32-bit sum whose low
//     part lies in [0, 2^16) leaves the high part exact.
//   - The total: accumulator plus the three paths as 32-bit adds of pairs.
//     Past D the ring holds garbage, so those halves may carry -- only
//     upward, into another half past D (d and d + 1 of a word: the high
//     one is past D whenever the low one is) or out of the word -- and a
//     lane that reaches past D sets them to TSENT16 = 2^15 - 1. A real
//     total is below BIG_I16 = 30000.
//   - The WTA: each key v*256 + d is one byte permute of a total pair and
//     the pair's disparities as bytes; the minimum, the neighbours and the
//     second minimum (from keys; TSENT16 or more means none) as before.
//   - The sentinel SENT16 = 2^14 stands past both ends of the pixel's
//     disparities and is the cost past D, so a carry past D lies in
//     [SENT16, SENT16 + P2]. With V = cost_max + P2, the largest real path
//     value, the route needs: SENT16 > V (past D is never the minimum m);
//     SENT16 >= V + P2 - P1 (a sentinel neighbour never beats m + P2, as
//     the int32 route's 2^20 never does); SENT16 + P2 < 2^15 (a carry past
//     D stays a non-negative int16); 0 <= P1, P2 < 2^15 (m + P2 - P1 and
//     the sums with P1 stay in int16: min(L(d-1), L(d+1), m + P2 - P1) +
//     P1 lies in [m, m + P2]). kernels/sgm.py admits the route on the
//     stronger V + max(P1, P2) < SENT16 and SENT16 + P1 + P2 < 2^15, with
//     the int16 accumulator (5 V < 30000). At SGBMParams(): V = 3950,
//     6350 < 16384 and 19384 < 32768; the largest P2 admitted is 4449,
//     where the accumulator binds.
//   - The int32 step stays in every other instantiation: MODE_HH and a
//     large P2 (f32 accumulator: the int16 halves cannot hold the total),
//     4 paths (two one-direction launches that store the accumulator) and
//     2 (no sweep), 64 < D <= 96 (eight a lane would hold 128 disparities
//     for at most 96; the int32 route's three a lane hold 96), and B2 and
//     B8c, which call sgm_step (B2 runs at 66% of the memory rate that its
//     two directions must move). B8a's float costs keep f32.
//
// An int16 cost computes in int32 (exact; an f32 accumulator holds the
// integer totals exactly, as the TPU's f32 carries do), so the result does
// not depend on the order of the directions. An f32 or bf16 cost (B8a)
// computes in f32 with f32 penalties, the TPU kernel's 1e9 sentinel past
// both ends of d (a carry past D is set back to it after every step) and
// its order of operations, (c + best) - m, and adds a pixel's total in the
// TPU's order, ((L_lr + L_rl) + top-down 0, +1, -1) + bottom-up 0, +1, -1,
// whatever order a column computes its directions in; so it rounds as the
// TPU kernel and the plain twin do. (IEEE addition commutes, so B2's
// second chain to reach a pixel may add L_rl + L_lr.)

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "sgm_common.cuh"

namespace {

using namespace v3dsgm;

// type codes of the C interface
enum { T_I16 = 0, T_F32 = 1, T_BF16 = 2 };

constexpr int PF = 4;           // rows in flight per column (power of 2)
constexpr int XCH_RING = 4;     // rows of an edge-exchange ring
constexpr int RINIT = INT_MAX;  // a right-image key nothing voted for
constexpr unsigned SPIN_LIMIT = 1u << 24;  // polls before a block gives up
static_assert(PF >= 1 && (PF & (PF - 1)) == 0, "ring slots");

// lanes of a pixel in B3: lanes_per_pixel, or half as many on the packed
// route, eight disparities (four pairs) a lane
__host__ __device__ inline int vertical_lanes(int D, bool packed) {
  return packed ? lanes_per_pixel(D) / 2 : lanes_per_pixel(D);
}
// columns of the strip of a vertical block of vw warps
__host__ __device__ inline int strip_cols(int D, int vw, bool packed = false) {
  return vw * (32 / vertical_lanes(D, packed));
}
// ints between the two buffers of a block's right-image keys
__host__ __device__ inline int keys_pitch(int D, int vw, bool packed = false) {
  return (strip_cols(D, vw, packed) + D - 1 + 3) & ~3;
}

// a stored value in the compute type V (a bf16 widens exactly to f32: its
// bits are the top half of the float's)
template <typename V, typename T>
__device__ __forceinline__ V widen(T v) {
  return (V)v;
}
template <typename V>
__device__ __forceinline__ V widen(Bf16Bits v) {
  return (V)__uint_as_float((unsigned)v.x << 16);
}

// value v[d % DPL] of the lane of this pixel that owns disparity d
template <int LPP, int DPL>
__device__ __forceinline__ int value_at(const int (&v)[DPL], int d) {
  int j = d % DPL, sel = v[0];
#pragma unroll
  for (int k = 1; k < DPL; ++k)
    if (k == j) sel = v[k];
  return __shfl_sync(FULL, sel, d / DPL, LPP);
}

// N adjacent values moved as one word where a lane's run is 8 or 16 bytes
template <typename T, int N>
struct alignas(sizeof(T) * N) Run { T v[N]; };

// a lane's DPL values at p (aligned to the run where DPL is 4)
template <typename T, int DPL, typename V>
__device__ __forceinline__ void load_run(const T* p, V (&out)[DPL]) {
  if constexpr (DPL == 4) {
    Run<T, DPL> r = *(const Run<T, DPL>*)p;
#pragma unroll
    for (int j = 0; j < DPL; ++j) out[j] = widen<V>(r.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < DPL; ++j) out[j] = widen<V>(p[j]);
  }
}

template <typename T, int DPL, typename V>
__device__ __forceinline__ void store_run(T* p, const V (&v)[DPL]) {
  if constexpr (DPL == 4) {
    Run<T, DPL> r;
#pragma unroll
    for (int j = 0; j < DPL; ++j) r.v[j] = (T)v[j];
    *(Run<T, DPL>*)p = r;
  } else {
#pragma unroll
    for (int j = 0; j < DPL; ++j) p[j] = (T)v[j];
  }
}

constexpr int HPF = 8;  // pixels in flight per scan line of B2 (power of 2)
constexpr int HW = 4;   // warps of a horizontal block
static_assert(HPF >= 1 && (HPF & (HPF - 1)) == 0, "ring slots");

// one pixel's D values of type T from global memory into a ring slot: 16
// bytes a lane, asynchronously, where every pixel starts on a 16-byte
// boundary (vec); else each lane its own values with plain loads
template <typename T, int DPL>
__device__ __forceinline__ void fetch_pixel(char* slot, const T* src, int D,
                                            int dl, int d0, bool vec,
                                            bool active) {
  if (vec) {
    if (active && dl < D * (int)sizeof(T) / 16)
      cp_async16(slot + dl * 16, (const char*)src + dl * 16);
  } else if (active) {
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (d0 + j < D) ((T*)slot)[d0 + j] = src[d0 + j];
  }
}

// a lane's DPL values of a pixel at p, D of them real: whole runs where D
// is a multiple of the run (vec), else value by value
template <typename T, int DPL, typename V>
__device__ __forceinline__ void load_pixel(const T* p, int D, int d0,
                                           bool vec, V (&out)[DPL]) {
  if (DPL == 4 && vec) {
    if (d0 < D) load_run<T, DPL>(p + d0, out);
  } else {
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (d0 + j < D) out[j] = widen<V>(p[d0 + j]);
  }
}

template <typename T, int DPL, typename V>
__device__ __forceinline__ void store_pixel(T* p, int D, int d0, bool vec,
                                            const V (&v)[DPL]) {
  if (DPL == 4 && vec) {
    if (d0 < D) store_run<T, DPL>(p + d0, v);
  } else {
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (d0 + j < D) p[d0 + j] = (T)v[j];
  }
}

// B2 (and B8a's horizontal pair): both horizontal sweeps of the rows (B * H
// of them, W pixels of D costs of type CT each) in one launch; acc receives
// the sum of the two paths and is not read before it is written.
//
// A row is held by LPP lanes with DPL adjacent disparities each, so a warp
// carries 32 / LPP rows and shares every shuffle of a step between them.
// The same lanes run the row's two directions at the same time, from the
// two ends: in iteration t the left-to-right line is at x = t and the
// right-to-left one at x = W - 1 - t, two independent chains a thread. Up
// to the middle of the row each stores its own path sum to acc; past it
// each finds the other's sum there, adds its own and stores the total; an
// odd width's middle pixel gets the sum of the two straight from the
// registers. The int16 cost's sums are exact integers (int16, or integer
// totals in f32), so the order of the two additions changes no bit; a
// float cost's total is the one f32 addition L_lr + L_rl, which commutes.
// Each line keeps HPF pixels in flight, copied asynchronously into its own
// ring of shared-memory slots: the cost and, past the middle, the other
// line's sum. The copy for iteration s is started in iteration s - HPF,
// before that iteration's stores, and the other line stored that pixel in
// iteration W - 1 - s: so the ring holds the sum only from 2 s >= W + HPF
// on, and the few pixels just past the middle are read straight from acc
// when they are needed (the lane reads what it stored itself). acc is
// never read through the non-coherent path.
// The grid is sized by the host from the occupancy: a warp takes row
// groups g, g + warps, ... in turn.
template <typename CT, typename AT, int LPP, int DPL>
__global__ void __launch_bounds__(HW * 32)
horizontal_kernel(const CT* __restrict__ cost, AT* acc, int rows, int W,
                  int D, typename Compute<CT>::type p1,
                  typename Compute<CT>::type p2) {
  using C = typename Compute<CT>::type;
  constexpr bool FLOAT = std::is_same<C, float>::value;
  extern __shared__ int4 hsm4[];
  constexpr int PPW = 32 / LPP;  // rows of a warp
  constexpr int DP = LPP * DPL;  // disparities a pixel's lanes hold
  constexpr int CB = DP * (int)sizeof(CT);         // bytes: cost,
  constexpr int SLOT = CB + DP * (int)sizeof(AT);  // then sum
  const C sent = FLOAT ? C(BIGF) : C(SENT);
  const int lane = threadIdx.x & 31, dl = lane % LPP, d0 = dl * DPL;
  const int wib = threadIdx.x >> 5;
  // this row's rings: HPF slots left-to-right, then HPF right-to-left
  char* ring = (char*)hsm4 + (wib * PPW + lane / LPP) * (2 * HPF * SLOT);
  const bool vec_c = (D * (int)sizeof(CT)) % 16 == 0;
  const bool vec_a = (D * (int)sizeof(AT)) % 16 == 0;
  const int groups = (rows + PPW - 1) / PPW;
  const int warps = gridDim.x * HW;

  for (int g = blockIdx.x * HW + wib; g < groups; g += warps) {
    const int row = g * PPW + lane / LPP;
    const bool active = row < rows;
    const CT* crow = cost + (long long)row * W * D;
    AT* arow = acc + (long long)row * W * D;
    auto fetch = [&](int s) {  // the pixels of iteration s into slot s % HPF
      char* sf = ring + (s & (HPF - 1)) * SLOT;
      char* sr = sf + HPF * SLOT;
      const long long of = (long long)s * D, orv = (long long)(W - 1 - s) * D;
      fetch_pixel<CT, DPL>(sf, crow + of, D, dl, d0, vec_c, active);
      fetch_pixel<CT, DPL>(sr, crow + orv, D, dl, d0, vec_c, active);
      if (2 * s >= W + HPF) {
        fetch_pixel<AT, DPL>(sf + CB, arow + of, D, dl, d0, vec_a, active);
        fetch_pixel<AT, DPL>(sr + CB, arow + orv, D, dl, d0, vec_a, active);
      }
    };
    __syncwarp();  // the rings are free of the group before
#pragma unroll
    for (int s = 0; s < HPF; ++s) {
      if (s < W) fetch(s);
      cp_async_commit();
    }
    C Lf[DPL], Lr[DPL];  // carries start at zero (f32: the sentinel past D)
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      Lf[j] = Lr[j] = FLOAT && d0 + j >= D ? sent : C(0);

    for (int t = 0; t < W; ++t) {
      const bool second = 2 * t > W - 1;  // the other line was here first
      const bool ringed = 2 * t >= W + HPF;  // and its sum is in the ring
      C cf[DPL], cr[DPL], af[DPL], ar[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) af[j] = ar[j] = C(0);
      cp_async_wait<HPF - 1>();  // iteration t's pixels have landed
      __syncwarp();
      {
        const char* sf = ring + (t & (HPF - 1)) * SLOT;
        const char* sr = sf + HPF * SLOT;
        load_run<CT, DPL>((const CT*)sf + d0, cf);
        load_run<CT, DPL>((const CT*)sr + d0, cr);
        if (ringed) {
          load_run<AT, DPL>((const AT*)(sf + CB) + d0, af);
          load_run<AT, DPL>((const AT*)(sr + CB) + d0, ar);
        }
#pragma unroll
        for (int j = 0; j < DPL; ++j)  // the only int mask of the step
          if (d0 + j >= D) cf[j] = cr[j] = sent;
      }
      __syncwarp();  // the slot is free for iteration t + HPF
      if (t + HPF < W) fetch(t + HPF);
      cp_async_commit();

      AT* pf = arow + (long long)t * D;
      AT* pr = arow + (long long)(W - 1 - t) * D;
      if (second && !ringed && active) {
        load_pixel<AT, DPL>(pf, D, d0, vec_a, af);
        load_pixel<AT, DPL>(pr, D, d0, vec_a, ar);
      }
      C Ln[DPL];
      sgm_step<LPP, DPL>(Lf, cf, Ln, dl, p1, p2, sent);
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        Lf[j] = FLOAT && d0 + j >= D ? sent : Ln[j];
      sgm_step<LPP, DPL>(Lr, cr, Ln, dl, p1, p2, sent);
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        Lr[j] = FLOAT && d0 + j >= D ? sent : Ln[j];
      if (2 * t == W - 1) {  // the middle pixel of an odd width
#pragma unroll
        for (int j = 0; j < DPL; ++j) af[j] = Lf[j] + Lr[j];
        if (active) store_pixel<AT, DPL>(pf, D, d0, vec_a, af);
      } else {
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          af[j] += Lf[j];
          ar[j] += Lr[j];
        }
        if (active) {
          store_pixel<AT, DPL>(pf, D, d0, vec_a, af);
          store_pixel<AT, DPL>(pr, D, d0, vec_a, ar);
        }
      }
    }
  }
}

// A diagonal carry and its row's tag as one word of the edge exchange,
// written with one store and polled with one load, so the two arrive
// together: int, a 12-bit tag above a 20-bit value (|value| < 2^19) in 32
// bits; f32, the tag above the float's bits in 64; a packed pair (B3's
// packed route), the tag above the pair's 32 bits in 64.
template <typename C>
struct Xch;
template <>
struct Xch<int> {
  using Word = unsigned;
  static constexpr unsigned TAG = 0xfffu;
  __device__ static Word pack(unsigned tag, int v) {
    return (tag << 20) | ((unsigned)v & 0xfffffu);
  }
  __device__ static unsigned tag(Word w) { return w >> 20; }
  __device__ static int value(Word w) { return (int)(w << 12) >> 12; }
};
template <>
struct Xch<float> {
  using Word = unsigned long long;
  static constexpr unsigned TAG = 0xffffffffu;
  __device__ static Word pack(unsigned tag, float v) {
    return ((Word)tag << 32) | __float_as_uint(v);
  }
  __device__ static unsigned tag(Word w) { return (unsigned)(w >> 32); }
  __device__ static float value(Word w) { return __uint_as_float((unsigned)w); }
};
template <>
struct Xch<unsigned> {
  using Word = unsigned long long;
  static constexpr unsigned TAG = 0xffffffffu;
  __device__ static Word pack(unsigned tag, unsigned v) {
    return ((Word)tag << 32) | v;
  }
  __device__ static unsigned tag(Word w) { return (unsigned)(w >> 32); }
  __device__ static unsigned value(Word w) { return (unsigned)w; }
};
// a lane's register type: the compute type, or a packed pair
template <typename CT, bool PK>
using Reg = std::conditional_t<PK, unsigned, typename Compute<CT>::type>;
template <typename CT, bool PK = false>
using XchWord = typename Xch<Reg<CT, PK>>::Word;

// bytes of a vertical block's shared memory: the diagonal carries (4
// bytes each, packed 2) [2][2][CW][DP] when ndir == 3, the right-image keys
// int [2][keys_pitch] when the launch closes with an LR check, then per
// column a ring of PF slots, each the cost and the accumulator of one pixel
inline size_t vertical_smem(int vw, int DP, int D, int ndir, bool right,
                            bool packed, int cost_bytes, int acc_bytes) {
  const int cw = strip_cols(D, vw, packed);
  return (size_t)(packed ? 2 : 4) * (ndir == 3 ? 2 * 2 * cw * DP : 0) +
         sizeof(int) * (right ? 2 * keys_pitch(D, vw, packed) : 0) +
         (size_t)cw * PF * DP * (cost_bytes + acc_bytes);
}

// The f32 part of the left-image WTA of one pixel and row at oo: the
// sub-pixel step, the uniqueness test and the margin from the first
// minimum's key v*256 + d, its neighbours' totals and the second minimum
// outside d +- 1 (SENT where there is none).
__device__ __forceinline__ void wta_store(float* __restrict__ disp,
                                          float* __restrict__ margin,
                                          long long oo, int x, int D, int md,
                                          int uniq, int key, int m1, int p1,
                                          int sec) {
  const int k_d = key & 255;
  const float fs = (float)(key >> 8);
  const float fm1 = (float)m1, fp1 = (float)p1;
  const float denom = (fm1 + fp1) - 2.0f * fs;
  float sub = denom > 1e-6f ? (fm1 - fp1) / (2.0f * denom + 1e-12f) : 0.0f;
  sub = fminf(fmaxf(sub, -0.5f), 0.5f);
  if (k_d == 0 || k_d == D - 1) sub = 0.0f;
  const float dval = ((float)k_d + sub) + (float)md;
  bool valid = x >= md + D;
  const float second = sec == SENT ? 1e9f : (float)sec;
  if (uniq > 0) valid = valid && (second * 100.0f >= fs * (100.0f + uniq));
  if (margin) margin[oo] = fmaxf(second - fs, 0.0f) / (fs + 1.0f);
  disp[oo] = valid ? dval : (float)(md - 1);
}

// B3: the NDIR (0, 1: dx 0, or 3: dx 0, +1, -1) sweeps of step dy over the
// frames frame0.. of the int16 cost, added to acc. CLOSE: the total goes to
// the WTA and is not stored; else it is written back to acc. B8a: the same
// sweeps of an f32 or bf16 cost (CT), never CLOSE: the f32 total of the
// launch is stored to acc. PK: the packed route (int16 cost and
// accumulator, DPL = 8 disparities a lane, three directions, CLOSE): a
// lane's values as four pairs of int16 halves, never widened; p1 and p2
// are then P1 and P2 - P1 in both halves of a word.
// grid (strips of CW columns, frames of the chunk), VW (16 or 32) warps, 64
// registers a thread; LPP lanes a pixel, DPL disparities a lane,
// LPP * DPL >= D.
// xch: word [frame][strip][side][XCH_RING][WP] (WP words a pixel: DP, or
// DP / 2 pairs), zeroed before the launch; side 0 the first column's dx -1
// carry, side 1 the last's dx +1.
// rkey: int [frame][row][strip][CW + D - 1], the strip's right-image keys.
template <typename CT, typename AT, int VW, int LPP, int DPL, int NDIR,
          bool CLOSE, bool PK = false>
__global__ void __launch_bounds__(VW * 32, 32 / VW)
vertical_kernel(const CT* __restrict__ cost, AT* acc,
                float* __restrict__ disp, float* __restrict__ margin,
                int* __restrict__ rkey, XchWord<CT, PK>* xch, int H, int W,
                int D, int dy, typename Compute<CT>::type p1,
                typename Compute<CT>::type p2, int md, int uniq, int lr,
                int frame0) {
  using C = typename Compute<CT>::type;
  using R = Reg<CT, PK>;
  using X = Xch<R>;
  using Word = typename X::Word;
  constexpr bool FLOAT = std::is_same<C, float>::value;
  static_assert(!(FLOAT && CLOSE), "the WTA takes an integer total");
  static_assert(!PK || (std::is_same<CT, int16_t>::value &&
                        std::is_same<AT, int16_t>::value && DPL == 8 &&
                        NDIR == 3 && CLOSE),
                "the packed route is B3's int16 5-path closing launch");
  extern __shared__ int4 vsm4[];
  constexpr int PPW = 32 / LPP;  // pixels (columns) of a warp
  constexpr int CW = VW * PPW;   // columns of the block's strip
  constexpr int DP = LPP * DPL;  // disparities a pixel's lanes hold
  constexpr int NR = PK ? DPL / 2 : DPL;  // registers a lane's values take
  constexpr int WP = PK ? DP / 2 : DP;    // words a pixel's carries take
  constexpr int CB = DP * (int)sizeof(CT);         // bytes of a ring slot:
  constexpr int SLOT = CB + DP * (int)sizeof(AT);  // cost, then accumulator
  const C sent = FLOAT ? C(BIGF) : C(SENT);
  const int tid = threadIdx.x, lane = tid & 31;
  const int dl = lane % LPP, d0 = dl * DPL;
  const int w0 = dl * NR;  // the lane's first word of a pixel's WP
  const int colb = (tid >> 5) * PPW + lane / LPP;  // column in the strip
  const int x = blockIdx.x * CW + colb;
  const bool active = x < W;
  const long long b = frame0 + blockIdx.y;
  const int n_r = CW + D - 1, pitch = keys_pitch(D, VW, PK);
  const bool right = CLOSE && lr >= 0;
  R* Lsm = (R*)vsm4;                                            // [2][2][CW][WP]
  int* rmin = (int*)(Lsm + (NDIR == 3 ? 2 * 2 * CW * WP : 0));  // [2][pitch]
  char* ring = (char*)(rmin + (right ? 2 * pitch : 0)) + colb * (PF * SLOT);
  if (right) {
    for (int i = tid; i < 2 * pitch; i += VW * 32) rmin[i] = RINIT;
    __syncthreads();
  }
  // packed route: a lane whose run reaches past D masks those halves
  const bool partial = PK && d0 + DPL > D;
  // pair k's halves below D
  auto keep = [&](int k) {
    return (d0 + 2 * k < D ? 0xffffu : 0u) |
           (d0 + 2 * k + 1 < D ? 0xffff0000u : 0u);
  };

  // A diagonal's carry comes from the neighbour column: zero at the image
  // edge, from the next block (polled) for the strip's first and last
  // column, else from shared memory. Direction 0 is dx +1 (from x - 1),
  // direction 1 is dx -1 (from x + 1). A column does direction kA, then kB;
  // an edge column publishes kA's carry and polls for kB's.
  const bool zero_p = x - 1 < 0, zero_n = x + 1 >= W;
  const bool edge_p = active && colb == 0 && !zero_p;
  const bool edge_n = active && colb == CW - 1 && !zero_n;
  const bool edge = edge_p || edge_n;
  const int kA = edge_p ? 1 : 0, kB = 1 - kA;
  const bool zeroA = kA == 0 ? zero_p : zero_n;
  const bool zeroB = kB == 0 ? zero_p : zero_n;
  const int srcA = (kA * CW + colb + (kA == 0 ? -1 : 1)) * WP + w0;
  const int srcB = (kB * CW + colb + (kB == 0 ? -1 : 1)) * WP + w0;
  const int dstA = (kA * CW + colb) * WP + w0;
  const int dstB = (kB * CW + colb) * WP + w0;
  Word* xmine = xch + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                          (2 * XCH_RING * WP);
  // the left block's side 1 or the right block's side 0; our side 0 or 1
  const Word* xfrom =
      (edge_p ? xmine - XCH_RING * WP : xmine + 2 * XCH_RING * WP) + w0;
  Word* xto = xmine + (edge_n ? XCH_RING * WP : 0) + w0;

  // this column's pixel of the sweep's current row, and of the next row to
  // fetch, as offsets into the volume
  const long long row_step = (long long)dy * W;
  const long long vol_step = row_step * D;
  long long o = (b * H + (dy > 0 ? 0 : H - 1)) * (long long)W + x;
  long long obase = o * D;
  // a pixel's D values go in 16-byte pieces where every pixel starts on a
  // 16-byte boundary, one piece a lane; else lane by lane with plain loads
  const bool vec_c = (D * (int)sizeof(CT)) % 16 == 0;
  const bool vec_a = (D * (int)sizeof(AT)) % 16 == 0;
  const bool piece_c = active && dl < D * (int)sizeof(CT) / 16;
  const bool piece_a = active && dl < D * (int)sizeof(AT) / 16;
  auto fetch = [&](int r, long long fbase) {  // row r into slot r % PF
    char* slot = ring + (r & (PF - 1)) * SLOT;
    if (NDIR > 0) {
      if (vec_c) {
        if (piece_c)
          cp_async16(slot + dl * 16, (const char*)(cost + fbase) + dl * 16);
      } else if (active) {
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          if (d0 + j < D) ((CT*)slot)[d0 + j] = cost[fbase + d0 + j];
      }
    }
    if (vec_a) {
      if (piece_a)
        cp_async16(slot + CB + dl * 16, (const char*)(acc + fbase) + dl * 16);
    } else if (active) {
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        if (d0 + j < D) ((AT*)(slot + CB))[d0 + j] = acc[fbase + d0 + j];
    }
  };
#pragma unroll
  for (int r = 0; r < PF; ++r) {
    if (r < H) fetch(r, obase + r * vol_step);
    cp_async_commit();
  }

  R c[NR];  // this row's cost: the same for every direction
  // one step of the recurrence from carries L
  auto step = [&](const R (&L)[NR], R (&Ln)[NR]) {
    if constexpr (PK)
      sgm_step_pairs<LPP, NR>(L, c, Ln, dl, p1, p2);
    else
      sgm_step<LPP, DPL>(L, c, Ln, dl, p1, p2, sent);
  };
  R L0[NR];  // carries start at zero (f32: the sentinel past D)
#pragma unroll
  for (int j = 0; j < NR; ++j) L0[j] = FLOAT && d0 + j >= D ? sent : C(0);
  // the WTA's results of row t, kept by lane t % LPP of the pixel until
  // the pixel's lanes finish LPP rows together
  int w_key = 0, w_m1 = 0, w_p1 = 0, w_sec = 0;
  // this strip's run of the current row's right-image keys
  int* rk = rkey + ((b * H + (dy > 0 ? 0 : H - 1)) * (long long)gridDim.x +
                    blockIdx.x) * n_r;
  const long long rk_step = (long long)dy * gridDim.x * n_r;

  for (int t = 0; t < H; ++t) {
    if (right && t > 0 && tid < n_r) {
      // the keys of the row before, to the strip's own run of the plane
      int* rm = rmin + ((t - 1) & 1) * pitch;
      (rk - rk_step)[tid] = rm[tid];
      rm[tid] = RINIT;
    }
    R a[NR];
    cp_async_wait<PF - 1>();  // row t has landed
    __syncwarp();
    {
      const char* slot = ring + (t & (PF - 1)) * SLOT;
      if constexpr (PK) {
        // the pairs as they lie in the ring; past D the cost sentinel
        load_run<unsigned, NR>((const unsigned*)slot + w0, c);
        load_run<unsigned, NR>((const unsigned*)(slot + CB) + w0, a);
        if (partial) {
#pragma unroll
          for (int k = 0; k < NR; ++k)
            c[k] = (c[k] & keep(k)) | (pair_of(SENT16) & ~keep(k));
        }
      } else {
        if (NDIR > 0) load_run<CT, DPL>((const CT*)slot + d0, c);
        load_run<AT, DPL>((const AT*)(slot + CB) + d0, a);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {  // the only int masks of the row
          if (NDIR == 0 || d0 + j >= D) c[j] = sent;
          if (d0 + j >= D) a[j] = sent;
        }
      }
    }
    __syncwarp();  // the slot is free for row t + PF
    if (t + PF < H) fetch(t + PF, obase + PF * vol_step);
    cp_async_commit();

    R total[NR], Lp[NR], Ln[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) total[j] = a[j];
    if (NDIR == 3) {
      const unsigned tag = (unsigned)t & X::TAG;  // of the row before
      const unsigned tag_out = (unsigned)(t + 1) & X::TAG;
      R* cur = Lsm + (t & 1) * (2 * CW * WP);
      const R* prev = Lsm + ((t - 1) & 1) * (2 * CW * WP);
      const Word* from = xfrom + ((t - 1) & (XCH_RING - 1)) * WP;
      Word* to = xto + (t & (XCH_RING - 1)) * WP;
      // the words of this lane's carries that the neighbour publishes:
      // every pair; of single values, those below D
      auto published = [&](int j) { return PK || d0 + j < D; };
      // the neighbour's words, asked for before direction kA's step
      Word pw[NR];
      const bool polls = edge && t > 0;
      if (polls) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          pw[j] = published(j) ? *(const volatile Word*)(from + j) : Word(0);
      }
      // direction kA
      if (t == 0 || zeroA) {
#pragma unroll
        for (int j = 0; j < NR; ++j)  // the zero lateral fill
          Lp[j] = FLOAT && d0 + j >= D ? sent : C(0);
      } else {
        load_run<R, NR>(prev + srcA, Lp);
      }
      step(Lp, Ln);
#pragma unroll
      for (int j = 0; j < NR; ++j)
        if (FLOAT && d0 + j >= D) Ln[j] = sent;
      store_run<R, NR>(cur + dstA, Ln);
      if constexpr (!FLOAT) {
#pragma unroll
        for (int j = 0; j < NR; ++j) total[j] += Ln[j];
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          if (published(j))
            *(volatile Word*)(to + j) = X::pack(tag_out, Ln[j]);
      }
      // direction kB
      if (t == 0 || zeroB) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          Lp[j] = FLOAT && d0 + j >= D ? sent : C(0);
      } else if (edge) {
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          R v = PK ? R(0) : R(sent);
          if (published(j)) {
            Word w = pw[j];
            unsigned spins = 0;
            while (X::tag(w) != tag) {
              if (++spins > SPIN_LIMIT) __trap();
              w = *(const volatile Word*)(from + j);
            }
            v = X::value(w);
          }
          Lp[j] = v;
        }
      } else {
        load_run<R, NR>(prev + srcB, Lp);
      }
      step(Lp, Ln);
#pragma unroll
      for (int j = 0; j < NR; ++j)
        if (FLOAT && d0 + j >= D) Ln[j] = sent;
      store_run<R, NR>(cur + dstB, Ln);
      if constexpr (!FLOAT) {
#pragma unroll
        for (int j = 0; j < NR; ++j) total[j] += Ln[j];
      }
    }
    if (NDIR > 0) {
      step(L0, Ln);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        L0[j] = FLOAT && d0 + j >= D ? sent : Ln[j];
        total[j] += Ln[j];
      }
    }
    if constexpr (FLOAT) {
      if (NDIR == 3) {
        // the diagonals after the vertical, dx +1 (direction 0) then dx -1,
        // as the TPU adds them, read back from this lane's own stores
        const C* cur = Lsm + (t & 1) * (2 * CW * DP);
        load_run<C, DPL>(cur + colb * DP + d0, Lp);
#pragma unroll
        for (int j = 0; j < DPL; ++j) total[j] += Lp[j];
        load_run<C, DPL>(cur + (CW + colb) * DP + d0, Lp);
#pragma unroll
        for (int j = 0; j < DPL; ++j) total[j] += Lp[j];
      }
    }
    if constexpr (!CLOSE) {
      if (active) {
        if (DPL == 4 && vec_a) {  // D is a multiple of 4: no run straddles
          if (d0 < D) store_run<AT, DPL>(acc + obase + d0, total);
        } else {
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            if (d0 + j < D) acc[obase + d0 + j] = (AT)total[j];
        }
      }
    } else {
      // left-image WTA of the total in registers; first minimum wins ties
      // by the key v*256 + d (past D the total is SENT or more, packed
      // TSENT16: never a minimum)
      int kv[DPL];
      int key = INT_MAX, sec;
      if constexpr (PK) {
        // past D TSENT16; a total's bytes above its disparity's, the key
        // in one permute (dk: pair k's two disparities as bytes)
        if (partial) {
#pragma unroll
          for (int k = 0; k < NR; ++k)
            total[k] = (total[k] & keep(k)) | (pair_of(TSENT16) & ~keep(k));
        }
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          const unsigned dk = (unsigned)(d0 + 2 * k) * 0x101u + 0x100u;
          kv[2 * k] = (int)__byte_perm(total[k], dk, 0x6104);
          kv[2 * k + 1] = (int)__byte_perm(total[k], dk, 0x6325);
        }
      } else {
#pragma unroll
        for (int j = 0; j < DPL; ++j) kv[j] = total[j] * 256 + (d0 + j);
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) key = min(key, kv[j]);
      key = seg_min<LPP>(key);
      const int d_int = key & 255;
      const int dm1 = d_int > 0 ? d_int - 1 : 0;
      const int dp1 = d_int < D - 1 ? d_int + 1 : D - 1;
      int s_m1, s_p1;
      if constexpr (PK) {
        s_m1 = value_at<LPP, DPL>(kv, dm1) >> 8;
        s_p1 = value_at<LPP, DPL>(kv, dp1) >> 8;
        int sk = INT_MAX;
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          if (abs(d0 + j - d_int) > 1) sk = min(sk, kv[j]);
        sk = seg_min<LPP>(sk) >> 8;
        sec = sk >= TSENT16 ? SENT : sk;
      } else {
        s_m1 = value_at<LPP, DPL>(total, dm1);
        s_p1 = value_at<LPP, DPL>(total, dp1);
        sec = SENT;
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          if (abs(d0 + j - d_int) > 1) sec = min(sec, total[j]);
        sec = seg_min<LPP>(sec);
      }
      if (right && active) {
        // right-image WTA: pixel x votes v*256 + d for xr = x - d - md
        int* rm = rmin + (t & 1) * pitch + colb + (D - 1);
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          if (d0 + j < D && x - (d0 + j) - md >= 0)
            atomicMin(rm - (d0 + j), kv[j]);
      }
      if ((t & (LPP - 1)) == dl) {
        w_key = key;
        w_m1 = s_m1;
        w_p1 = s_p1;
        w_sec = sec;
      }
      if ((t & (LPP - 1)) == LPP - 1 || t == H - 1) {
        // LPP rows of the pixel at once, lane dl the row t - t % LPP + dl
        const int back = (t & (LPP - 1)) - dl;  // rows before row t
        if (active && back >= 0)
          wta_store(disp, margin, o - back * row_step, x, D, md, uniq, w_key,
                    w_m1, w_p1, w_sec);
      }
    }
    o += row_step;
    obase += vol_step;
    rk += rk_step;
    if (NDIR == 3 || right) __syncthreads();
  }
  if (right && tid < n_r)
    (rk - rk_step)[tid] = rmin[((H - 1) & 1) * pitch + tid];
}

// The LR check on the disparity of the closing launch: a valid pixel stays
// valid where the right image's winner at xr = x - md - round(d) agrees
// within lr. In place. rkey holds each strip's keys v*256 + d of the xr its
// columns vote for, [row][strip][CW + D - 1]; the winner at xr is the least
// key over the strips whose columns reach it (the first minimum over d).
__global__ void lr_kernel(float* __restrict__ disp,
                          const int* __restrict__ rkey, long long n, int W,
                          int D, int md, int lr, int cw) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float dval = disp[i];
  if (dval < (float)md) return;  // invalid already
  const int x = (int)(i % W);
  const float dl = dval - (float)md;
  int dr = (int)rintf(dl);  // half to even, like jnp.round
  dr = min(max(dr, 0), D - 1);
  const int xr = x - md - dr;
  bool ok = xr >= 0;
  if (ok) {
    // strip s votes for xr in [s*CW - (D-1) - md, s*CW + CW - 1 - md]
    const int strips = (W + cw - 1) / cw, n_r = cw + D - 1;
    const int* row = rkey + (i / W) * (long long)strips * n_r;
    const int s_lo = (xr + md) / cw;
    const int s_hi = min((xr + md + D - 1) / cw, strips - 1);
    int key = RINIT;
    for (int s = s_lo; s <= s_hi; ++s)
      key = min(key, row[s * n_r + xr - (s * cw - (D - 1) - md)]);
    ok = fabsf(dl - (float)(key & 255)) <= (float)lr;
  }
  if (!ok) disp[i] = (float)(md - 1);
}

// B2's launch: as many warps as the card holds at once, or, where the row
// groups need several rounds, as many as share them out evenly, each warp
// taking its groups in turn. plan, when not NULL, receives four host ints:
// blocks per multiprocessor, multiprocessors, blocks launched, rounds.
template <typename CT, typename AT, int LPP, int DPL>
int launch_horizontal(const void* cost, void* acc, long long rows, int W,
                      int D, float p1, float p2, int* plan, cudaStream_t s) {
  using C = typename Compute<CT>::type;
  auto kernel = horizontal_kernel<CT, AT, LPP, DPL>;
  const int ppw = 32 / LPP;
  const size_t smem =
      (size_t)HW * ppw * 2 * HPF * LPP * DPL * (sizeof(CT) + sizeof(AT));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, HW * 32, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long groups = (rows + ppw - 1) / ppw;
  const long long resident = (long long)per_sm * sms * HW;  // warps
  const long long rounds = (groups + resident - 1) / resident;
  const long long warps = (groups + rounds - 1) / rounds;
  const int blocks = (int)((warps + HW - 1) / HW);
  if (plan) {
    plan[0] = per_sm;
    plan[1] = sms;
    plan[2] = blocks;
    plan[3] = (int)rounds;
  }
  if (blocks < 1) return (int)cudaSuccess;
  kernel<<<blocks, HW * 32, smem, s>>>((const CT*)cost, (AT*)acc, (int)rows,
                                       W, D, (C)p1, (C)p2);
  return (int)cudaGetLastError();
}

// lanes a pixel and disparities a lane by D, as lanes_per_pixel
template <typename CT, typename AT>
int horizontal_shape(const void* cost, void* acc, long long rows, int W,
                     int D, float p1, float p2, int* plan, cudaStream_t s) {
  if (D < 1 || D > 128 || W < 1) return (int)cudaErrorInvalidValue;
  if (D <= 32)
    return launch_horizontal<CT, AT, 8, 4>(cost, acc, rows, W, D, p1, p2,
                                           plan, s);
  if (D <= 64)
    return launch_horizontal<CT, AT, 16, 4>(cost, acc, rows, W, D, p1, p2,
                                            plan, s);
  if (D <= 96)
    return launch_horizontal<CT, AT, 32, 3>(cost, acc, rows, W, D, p1, p2,
                                            plan, s);
  return launch_horizontal<CT, AT, 32, 4>(cost, acc, rows, W, D, p1, p2, plan,
                                          s);
}

// Warps of a vertical block for B frames of width W: 32 (one block a
// multiprocessor, strips twice as wide, so half as many edge exchanges and
// blocks in lockstep) where the launches of such blocks are at least four
// fifths full, else 16 (two blocks a multiprocessor). Measured at 1080p,
// D = 64 on 132 multiprocessors: a launch of 32-warp blocks takes the same
// time for one frame as for the four it can hold, one of 16-warp blocks
// time in proportion to its frames. (A float cost's 32-warp block takes
// 192 KB of shared memory at every D, so it too is one a multiprocessor,
// as is the packed route's, 194 KB with the right-image keys.) The packed
// route's strips hold twice the columns, so it halves the blocks first: 16
// warps where those launches still give four fifths of the multiprocessors
// a block, else 8 (at 1080p: 32 from 8 frames, 16 from 4, 8 below).
int vertical_warps(int B, int W, int D, bool packed) {
  static int sms = 0;  // of the current device, read once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 16;
  }
  for (int vw = 32; vw >= 16; vw /= 2) {
    const int cw = strip_cols(D, vw, packed);
    const int strips = (W + cw - 1) / cw;
    const int slots = sms * (32 / vw);  // blocks resident at once
    const int fit = slots / strips > 0 ? slots / strips : 1;  // frames a launch
    const int launches = (B + fit - 1) / fit;
    if (5LL * B * strips >= 4LL * sms * launches) return vw;
    if (!packed) return 16;
  }
  return 8;
}

template <typename CT, typename AT, int VW, int LPP, int DPL, int NDIR,
          bool CLOSE, bool PK = false>
int launch_vertical(const void* cost, void* acc, float* disp, float* margin,
                    int* rkey, void* xch, int B, int H, int W, int D, int dy,
                    float p1, float p2, int md, int uniq, int lr, int* plan,
                    cudaStream_t s) {
  using C = typename Compute<CT>::type;
  using Word = XchWord<CT, PK>;
  auto kernel = vertical_kernel<CT, AT, VW, LPP, DPL, NDIR, CLOSE, PK>;
  const int DP = LPP * DPL;
  const int WP = PK ? DP / 2 : DP;  // exchange words a pixel
  const size_t smem = vertical_smem(VW, DP, D, NDIR, CLOSE && lr >= 0, PK,
                                    (int)sizeof(CT), (int)sizeof(AT));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int cw = strip_cols(D, VW, PK);
  const int strips = (W + cw - 1) / cw;
  const CT* cp = (const CT*)cost;
  AT* ap = (AT*)acc;
  Word* xp = (Word*)xch;
  // the packed route takes P1 and P2 - P1 in both halves of a word
  C cp1 = PK ? (C)pair_of((int)p1) : (C)p1;
  C cp2 = PK ? (C)pair_of((int)p2 - (int)p1) : (C)p2;
  if (NDIR < 3) {
    // no carry crosses a column: blocks are independent
    int frame0 = 0;
    kernel<<<dim3(strips, B), VW * 32, smem, s>>>(
        cp, ap, disp, margin, rkey, xp, H, W, D, dy, cp1, cp2, md, uniq, lr,
        frame0);
    return (int)cudaGetLastError();
  }
  // every block of a launch must be resident: a cooperative launch of at
  // most the occupancy's grid, in chunks of whole frames
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, VW * 32, smem)) != cudaSuccess)
    return (int)e;
  const int fit = per_sm * sms / strips;  // whole frames resident
  // as few launches as that allows, the frames shared out evenly
  const int launches = fit > 0 ? (B + fit - 1) / fit : 0;
  const int chunk = launches > 0 ? (B + launches - 1) / launches : 0;
  if (plan) {
    plan[0] = per_sm;
    plan[1] = sms;
    plan[2] = strips;
    plan[3] = chunk;
    plan[4] = launches;
    plan[5] = cw;
  }
  if (chunk < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  for (int frame0 = 0; frame0 < B; frame0 += chunk) {
    const int n = B - frame0 < chunk ? B - frame0 : chunk;
    if ((e = cudaMemsetAsync(xp, 0,
                             sizeof(Word) * (size_t)n * strips * 2 *
                                 XCH_RING * WP,
                             s)) != cudaSuccess)
      return (int)e;
    void* args[] = {&cp,  &ap,  &disp, &margin, &rkey, &xp, &H,  &W,
                    &D,   &dy,  &cp1,  &cp2,    &md,   &uniq, &lr, &frame0};
    if ((e = cudaLaunchCooperativeKernel((void*)kernel, dim3(strips, n),
                                         dim3(VW * 32), args, smem, s)) !=
        cudaSuccess)
      return (int)e;
  }
  return (int)cudaGetLastError();
}

// The launch's instantiation by its directions and whether it closes: an
// int16 cost takes every mode of B3; a float cost (B8a) the sweeps of 1 or
// 3 directions that store the total, never the WTA.
template <typename CT, typename AT, int VW, int LPP, int DPL>
int vertical_mode(const void* cost, void* acc, float* disp, float* margin,
                  int* rkey, void* xch, int B, int H, int W, int D,
                  int num_dirs, int dy, int close, float p1, float p2, int md,
                  int uniq, int lr, int* plan, cudaStream_t s) {
#define V3D_VERTICAL(NDIR, CLOSE)                                         \
  return launch_vertical<CT, AT, VW, LPP, DPL, NDIR, CLOSE>(              \
      cost, acc, disp, margin, rkey, xch, B, H, W, D, dy, p1, p2, md,     \
      uniq, lr, plan, s)
  if constexpr (std::is_same<CT, int16_t>::value) {
    if (num_dirs == 0 && close) V3D_VERTICAL(0, true);
    if (num_dirs == 1 && close) V3D_VERTICAL(1, true);
    if (num_dirs == 1 && !close) V3D_VERTICAL(1, false);
    if (num_dirs == 3 && close) V3D_VERTICAL(3, true);
    if (num_dirs == 3 && !close) V3D_VERTICAL(3, false);
  } else {
    if (num_dirs == 1 && !close) V3D_VERTICAL(1, false);
    if (num_dirs == 3 && !close) V3D_VERTICAL(3, false);
  }
#undef V3D_VERTICAL
  return (int)cudaErrorInvalidValue;
}

// lanes a pixel and disparities a lane by D, as lanes_per_pixel; packed:
// the packed route, eight disparities a lane, only for an int16 cost and
// accumulator, three directions and the WTA, and not 64 < D <= 96
template <typename CT, typename AT>
int vertical_shape(const void* cost, void* acc, float* disp, float* margin,
                   int* rkey, void* xch, int B, int H, int W, int D,
                   int num_dirs, int dy, int close, int packed, float p1,
                   float p2, int md, int uniq, int lr, int* plan,
                   cudaStream_t s) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  const int vw = vertical_warps(B, W, D, packed);
  const bool wide = vw == 32;
  if (packed) {
    if constexpr (std::is_same<CT, int16_t>::value &&
                  std::is_same<AT, int16_t>::value) {
#define V3D_PACKED_VW(VW, LPP)                                            \
  launch_vertical<CT, AT, VW, LPP, 8, 3, true, true>(                     \
      cost, acc, disp, margin, rkey, xch, B, H, W, D, dy, p1, p2, md,     \
      uniq, lr, plan, s)
#define V3D_PACKED(LPP)                                                   \
  return vw == 32   ? V3D_PACKED_VW(32, LPP)                              \
         : vw == 16 ? V3D_PACKED_VW(16, LPP)                              \
                    : V3D_PACKED_VW(8, LPP)
      if (num_dirs == 3 && close && D <= 32) V3D_PACKED(4);
      if (num_dirs == 3 && close && D <= 64) V3D_PACKED(8);
      if (num_dirs == 3 && close && D > 96) V3D_PACKED(16);
#undef V3D_PACKED
#undef V3D_PACKED_VW
    }
    return (int)cudaErrorInvalidValue;
  }
#define V3D_SHAPE(LPP, DPL)                                               \
  return wide ? vertical_mode<CT, AT, 32, LPP, DPL>(                      \
                    cost, acc, disp, margin, rkey, xch, B, H, W, D,       \
                    num_dirs, dy, close, p1, p2, md, uniq, lr, plan, s)   \
              : vertical_mode<CT, AT, 16, LPP, DPL>(                      \
                    cost, acc, disp, margin, rkey, xch, B, H, W, D,       \
                    num_dirs, dy, close, p1, p2, md, uniq, lr, plan, s)
  if (D <= 32) V3D_SHAPE(8, 4);
  if (D <= 64) V3D_SHAPE(16, 4);
  if (D <= 96) V3D_SHAPE(32, 3);
  V3D_SHAPE(32, 4);
#undef V3D_SHAPE
}

}  // namespace

// B2: the sum of the left-to-right and the right-to-left path over the
// (B, H, W, D) cost into acc, every element written; one launch. An int16
// cost (cost_type) with whole penalties into an int16 or f32 acc
// (acc_type); an f32 or bf16 cost into an f32 acc (B8a's horizontal pair).
// plan as launch_horizontal.
extern "C" int v3d_sgm_horizontal(void* cost, void* acc, int B, int H, int W,
                                  int D, float p1, float p2, int cost_type,
                                  int acc_type, void* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)B * H;
  int* pl = (int*)plan;
  if (cost_type == T_I16 && acc_type == T_I16)
    return horizontal_shape<int16_t, int16_t>(cost, acc, rows, W, D, p1, p2,
                                              pl, s);
  if (cost_type == T_I16 && acc_type == T_F32)
    return horizontal_shape<int16_t, float>(cost, acc, rows, W, D, p1, p2, pl,
                                            s);
  if (cost_type == T_F32 && acc_type == T_F32)
    return horizontal_shape<float, float>(cost, acc, rows, W, D, p1, p2, pl,
                                          s);
  if (cost_type == T_BF16 && acc_type == T_F32)
    return horizontal_shape<Bf16Bits, float>(cost, acc, rows, W, D, p1, p2,
                                             pl, s);
  return (int)cudaErrorInvalidValue;
}

// B3, one launch per sweep step dy: the num_dirs (0; 1: vertical; 3:
// vertical and both diagonals) sweeps of step dy over the (B, H, W, D) cost
// of cost_type, added to the accumulator of the horizontal paths (acc_type).
// An int16 cost with whole penalties, int16 or f32 acc: close = 0 writes
// the sum back to acc. close = 1 leaves acc as it is and does the
// left-image WTA on the total: f32 disparity (B, H, W) before the LR
// check, the f32 uniqueness margin when margin is not NULL and, when lr >=
// 0, each strip's right-image keys min v*256 + d into rkey, B *
// v3d_sgm_vertical_keys(H, W, D) ints, every one written. An f32 or bf16
// cost (B8a), f32 acc, num_dirs 1 or 3, close = 0: the f32 total is
// stored to acc; disp, margin and rkey are not used. packed = 1 takes the
// packed route (the note): int16 cost and acc, D <= 64 or D > 96, num_dirs
// 3, close = 1, whole penalties P1, P2 >= 0 with SENT16 + P1 + P2 < 2^15,
// and every path value plus the larger penalty below SENT16 (the caller's
// bound; the kernel cannot see the cost's range). xch is scratch of
// v3d_sgm_vertical_scratch(B, W, cost_type) ints. plan, when not NULL,
// receives six host ints of a 3-direction launch: blocks per
// multiprocessor, multiprocessors, strips per frame, frames per chunk,
// chunks, columns per block.
extern "C" int v3d_sgm_vertical(void* cost, void* acc, void* disp,
                                void* margin, void* rkey, void* xch, int B,
                                int H, int W, int D, int num_dirs, int dy,
                                int close, float p1, float p2, int md,
                                int uniq, int lr, int cost_type, int acc_type,
                                int packed, void* plan, void* stream) {
#define V3D_TYPES(CT, AT)                                                  \
  return vertical_shape<CT, AT>(cost, acc, (float*)disp, (float*)margin,   \
                                (int*)rkey, xch, B, H, W, D, num_dirs, dy, \
                                close, packed, p1, p2, md, uniq, lr,       \
                                (int*)plan, (cudaStream_t)stream)
  if (packed && !(p1 >= 0.0f && p2 >= 0.0f &&
                  v3dsgm::SENT16 + (double)p1 + (double)p2 < 32768.0))
    return (int)cudaErrorInvalidValue;
  if (cost_type == T_I16 && acc_type == T_I16) V3D_TYPES(int16_t, int16_t);
  if (cost_type == T_I16 && acc_type == T_F32) V3D_TYPES(int16_t, float);
  if (cost_type == T_F32 && acc_type == T_F32) V3D_TYPES(float, float);
  if (cost_type == T_BF16 && acc_type == T_F32) V3D_TYPES(Bf16Bits, float);
#undef V3D_TYPES
  return (int)cudaErrorInvalidValue;
}

// ints of edge-exchange scratch that v3d_sgm_vertical needs for B frames of
// width W (at the narrowest strip and the widest pixel, 128 disparities):
// a 32-bit word a carry for an int16 cost, a 64-bit one for a float cost
extern "C" int v3d_sgm_vertical_scratch(int B, int W, int cost_type) {
  return B * ((W + 15) / 16) * 2 * XCH_RING * 128 *
         (cost_type == T_I16 ? 1 : 2);
}

// ints of right-image keys per frame that a closing v3d_sgm_vertical on B
// frames with lr >= 0 (and the same packed) writes and v3d_sgm_lr_check
// reads
extern "C" int v3d_sgm_vertical_keys(int B, int H, int W, int D,
                                     int packed) {
  const int cw = strip_cols(D, vertical_warps(B, W, D, packed), packed);
  return H * ((W + cw - 1) / cw) * (cw + D - 1);
}

// The LR check of B3 on the disparity and right-image keys of the closing
// v3d_sgm_vertical launch (with the same packed), in place.
extern "C" int v3d_sgm_lr_check(void* disp, void* rkey, int B, int H, int W,
                                int D, int md, int lr, int packed,
                                void* stream) {
  long long n = (long long)B * H * W;
  lr_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (float*)disp, (const int*)rkey, n, W, D, md, lr,
      strip_cols(D, vertical_warps(B, W, D, packed), packed));
  return (int)cudaGetLastError();
}
