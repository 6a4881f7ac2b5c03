// Kernels B8b and B8c: the W-major horizontal route of the SGM matcher.
//
// B8c replaces the TPU kernel video3d_tpu/kernels/sgm.py
// _directional_pass_wmajor (body _row_kernel_wmajor): one horizontal SGM
// sweep, forward or reverse along W, of the W-major (B, D, W, HL) volume
// (HL: image rows, padded or not), with f32 carries, shift set (0,), an
// int16 cost into an int16 or f32 accumulator or an f32 cost into f32, added
// into the accumulator when one is given. The JAX route
// _horizontal_passes_wmajor runs it forward, then in reverse. B8b replaces
// transpose_to_wmajor / transpose_from_wmajor (bodies _mxu_t_kernel_fwd /
// _bwd): exact layout changes between the port's (B, H, W, D) volume and
// (B, D, W, HP), HP = H rounded up to 128. The TPU computes its transposes
// as bf16 hi/lo identity matmuls on the MXU, a device of that chip; here
// they are plain tiled transposes, equal in value.
//
// What bounds them on the H100: B8b moves each element once each way (a
// round trip of one 1080p frame at D=64 in int16 reads and writes 1,062
// MB: 0.317 ms at 3.35 TB/s). B8c, with both directions in one launch,
// moves the cost twice and the accumulator three times, as B2 does on the
// D-major layout and for the same reason (the second chain to reach a
// pixel needs the first one's sum, and a row tile's sums do not fit on
// chip): 1,325 MB a 1080p frame at
// D=64 with an int16 accumulator (0.40 ms at 3.35 TB/s), 2,120 MB with f32
// (0.63 ms), against the 530 MB (0.16 ms) of reading the cost and writing
// the sum once. Measured on an H100 80GB HBM3 at 700 W (1080p, D=64), it
// takes 1.24-1.26 ms a frame at batch 2 and ~1.5 at batch 8: those bytes
// at ~1.06 and ~0.87 TB/s. What bounds it is the memory system serving
// this pattern, not the chain: a pixel's D values are D row segments of
// R * 2 (or 4) bytes, W * HL elements apart, so each step of a block asks
// for D segments per tile it moves (up to six tiles), and with four steps
// (64 KB a block) in flight Little's law puts a copy's latency near 4 us
// at batch 2. Longer segments helped: 32-row tiles (64-byte segments) ran
// batch 8 at 1.49 ms a frame where 16-row tiles (32 bytes) took 2.01;
// asking the L2 for 256-byte spans around each copy did not (1.61). So a
// lane holds eight disparities where D allows, which makes a 256-thread
// tile 32 rows at D <= 64.
//
// B8c design (wmajor_kernel): the route's W-major layout puts the image
// rows on the last axis, so adjacent rows sit on adjacent addresses and a
// pixel's D values lie W * HL elements apart. A block of WT = 256 threads
// owns a tile of R adjacent rows of one frame: a row is held by LPP lanes
// with DPL adjacent disparities each -- (LPP, DPL) = (8, 4) up to D = 32,
// (8, 8) up to 64, (16, 8) up to 128, so R = 32, 32, 16 rows -- so the min
// over D is log2(LPP) shuffle rounds and the d-1/d+1 neighbours two
// shuffles (sgm_common.cuh sgm_step, B2's and B3's step), instead of a
// D-long chain in one thread. At every scan position the block copies the
// D x R cost tile with cp.async into a ring of NPF shared-memory slots, 16
// bytes a lane along h where HL * element size and the pointers allow it
// (else element by element): D row segments, each coalesced. A lane then
// reads its row's disparities across the tile. A tile row d starts at
// 16-byte chunk d * CPR + d / DPL (one chunk of skew a lane's run), so the
// lanes of a pixel, whose first disparities are DPL rows apart, fall on
// different bank groups: no conflict at 8 lanes a pixel, two-way at 16
// (the least a chunked copy allows, since every lane reads the same
// offset within its chunk). A step's sums go to a D x R shared tile (two,
// used in turn), which the block stores along h one step later,
// coalesced; so each step has a single barrier.
// Both directions run in one launch, as B2 runs them: the block runs a
// row's two scan lines as two independent chains from the two ends. Up to
// the middle each chain stores its own path sum; past it each adds the
// other's sum, which it finds in the ring (copied with the cost, from
// 2 s >= W + NPF on), or straight from acc for the few positions just past
// the middle whose sums were stored after the ring's copy had to start, or,
// at 2 s == W, in the other chain's out tile of the step before; an odd
// width's middle pixel is summed in registers. The one-direction entry is
// the same kernel with one chain (and the accumulator copied into the ring
// at every step when one is given). The grid is sized from the occupancy
// as B2's, each block taking row tiles in turn; wmajor.py horizontal_plan
// records it.
//
// Shared memory of a block: NPF ring slots of NCH (chains) cost tiles and
// NCH accumulator tiles, plus 2 x NCH out tiles; a tile is
// (DP * R * elem / 16 + (DP - 1) / DPL) 16-byte chunks, DP = LPP * DPL,
// and NPF is the deepest ring (2 to 8) that keeps a block within half a
// multiprocessor's 228 KB less 1 KB (ring_depth). Two chains, D = 64
// (4,208 bytes an int16 tile, 8,304 an f32 one): int16 cost and
// accumulator, NPF = 5: 7 x 2 x 4,208 + 5 x 2 x 4,208 = 100,992 bytes;
// int16 into f32, NPF = 3: 5 x 2 x 8,304 + 3 x 2 x 4,208 = 108,288; f32
// into f32, NPF = 2: 99,648. At D = 128: 104,064 / 110,336 / 101,184. So
// two blocks fit on an SM in every case, and __launch_bounds__(256, 2)
// keeps the registers to 128 a thread.
//
// Arithmetic: an int16 cost computes in int32 with the SENT sentinel, exact,
// so the order of the two additions of a pixel changes no bit. An f32 cost
// computes in f32 with the TPU kernel's 1e9 sentinel and its order of
// operations, (c + best) - m and then acc + L (a fresh sum is 0 + L, as in
// the twin), so it rounds as the TPU kernel and the plain twin do: the two
// chains' sums meet in one addition, which commutes.
//
// B8b design (transpose_kernel). What bounds it is bytes: a round trip
// reads and writes the volume twice, 4 x vol x 2 B a frame in int16 (1,062
// MB at 1080p, D=64: 0.317 ms at 3.35 TB/s), so the design is about
// moving those bytes in whole lines. Each frame is a matrix transpose with
// a regroup: `to` views frame b as an H x (W * D) matrix, whose column
// c = (x, d) becomes the output row (d, x) of HP values; `from` is the
// inverse and reads only the chunks that hold rows h < H. A tile is XT_H =
// 64 rows h by XT_ROW_BYTES = 256 bytes of the (x, d) span (128 int16
// columns: two x at D = 64, one at D = 128; 64 f32 ones), wherever the x
// boundaries fall. Its input side is one 256-byte row segment per h (`to`)
// or 64 h per column, 128 bytes in int16 (`from`); its output side the
// other way round, so both sides move whole 128-byte lines, 16 bytes a
// thread. The launch is persistent: a few blocks per multiprocessor walk
// the tiles in turn, each with a ring of XT_STAGES tiles in shared memory
// filled by cp.async XT_STAGES - 1 tiles ahead, so the next tiles load
// while the current one is written out. A thread moves an EPC x EPC block
// (EPC = 16 / element size: 8x8 int16, 4x4 f32): EPC 16-byte loads from
// the shared tile, a register transpose (int16 by __byte_perm on word
// pairs; f32 by register renaming), EPC 16-byte stores straight to device
// memory; the threads of a quarter warp take the eight blocks along one
// output row, so each store instruction writes 128 contiguous bytes. The
// shared tile keeps its input rows whole and swaps the 16-byte chunks of
// row r by k ^ ((r / EPC) & 7): the eight threads of a quarter warp, which
// read chunk k of rows EPC apart, meet eight bank groups, and the copy in,
// eight chunks of one row, too, for 2- and 4-byte elements alike. Tiles
// that lie wholly in H <= h < HP write zeros and read nothing; a partial
// tile masks the rows >= H to zero. Where a row is no multiple of 16
// bytes (W * D or HP * element size) or a pointer is not 16-byte
// aligned, that side moves element by element in the same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sgm_common.cuh"

namespace {

using namespace v3dsgm;

constexpr int WT = 256;  // threads of a B8c block: R rows x LPP lanes

// type codes of the C interface
enum { T_I16 = 0, T_F32 = 1 };

// Shared bytes a B8c block may take so that two blocks share a
// multiprocessor (228 KB, 1 KB of it reserved per block).
constexpr int SMEM_TWO_BLOCKS = 233472 / 2 - 1024;

// ring slots of B8c: as many as fit beside the out tiles within
// SMEM_TWO_BLOCKS, at most 8 and at least 2
__host__ __device__ constexpr int ring_depth(int slot_bytes, int out_bytes) {
  return (SMEM_TWO_BLOCKS - out_bytes) / slot_bytes > 8
             ? 8
             : (SMEM_TWO_BLOCKS - out_bytes) / slot_bytes < 2
                   ? 2
                   : (SMEM_TWO_BLOCKS - out_bytes) / slot_bytes;
}

// A (DP disparities) x (R rows) tile of T in shared memory: row d starts at
// 16-byte chunk d * CPR + (d >> SK), one chunk of skew every 2^SK rows
// (2^SK: a lane's run of disparities).
template <typename T, int R, int SK>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int CPR = R / EPC;              // chunks a tile row
  static_assert(R % EPC == 0, "a tile row is whole chunks");
  __host__ __device__ static constexpr int bytes(int DP) {
    return (DP * CPR + ((DP - 1) >> SK)) * 16;
  }
  __device__ static int chunk(int d) { return d * CPR + (d >> SK); }
  __device__ static int offset(int d, int r) {
    return chunk(d) * 16 + r * (int)sizeof(T);
  }
};

// The D x R tile at src (element (d, h0 + r) at src[d * plane + r]) into
// shared memory: 16-byte asynchronous copies (vec), else element by element.
// Rows h >= HL are left as they were.
template <typename TT, typename T>
__device__ __forceinline__ void copy_in(char* tile, const T* src,
                                        long long plane, int D, int rows,
                                        bool vec) {
  if (vec) {
    const int n = D * TT::CPR;
    for (int i = threadIdx.x; i < n; i += WT) {
      const int d = i / TT::CPR, c = i % TT::CPR;
      if (c * TT::EPC < rows)
        cp_async16(tile + (TT::chunk(d) + c) * 16,
                   src + d * plane + c * TT::EPC);
    }
  } else {
    constexpr int R = TT::CPR * TT::EPC;
    const int n = D * R;
    for (int i = threadIdx.x; i < n; i += WT) {
      const int d = i / R, r = i % R;
      if (r < rows) *(T*)(tile + TT::offset(d, r)) = src[d * plane + r];
    }
  }
}

// the shared D x R tile out to dst, as copy_in reads it
template <typename TT, typename T>
__device__ __forceinline__ void copy_out(const char* tile, T* dst,
                                         long long plane, int D, int rows,
                                         bool vec) {
  if (vec) {
    const int n = D * TT::CPR;
    for (int i = threadIdx.x; i < n; i += WT) {
      const int d = i / TT::CPR, c = i % TT::CPR;
      if (c * TT::EPC < rows)
        *(int4*)(dst + d * plane + c * TT::EPC) =
            *(const int4*)(tile + (TT::chunk(d) + c) * 16);
    }
  } else {
    constexpr int R = TT::CPR * TT::EPC;
    const int n = D * R;
    for (int i = threadIdx.x; i < n; i += WT) {
      const int d = i / R, r = i % R;
      if (r < rows) dst[d * plane + r] = *(const T*)(tile + TT::offset(d, r));
    }
  }
}

// B8c: NCH = 2 runs both horizontal sweeps of the (B, D, W, HL) cost, their
// sum into acc (every element written, acc_in unused); NCH = 1 runs one
// sweep (reverse: right to left) added into acc_in when it is not NULL (it
// then equals acc). vec_c / vec_a: 16-byte copies of the cost / the
// accumulator are aligned. See the note at the top of the file.
template <typename CT, typename AT, int LPP, int DPL, int NCH, int NPF>
__global__ void __launch_bounds__(WT, 2)
wmajor_kernel(const CT* __restrict__ cost, const AT* acc_in, AT* acc, int B,
              int D, int W, int HL, typename Compute<CT>::type p1,
              typename Compute<CT>::type p2, int reverse, int vec_c,
              int vec_a) {
  using C = typename Compute<CT>::type;
  constexpr bool FLOAT = std::is_same<C, float>::value;
  constexpr int R = WT / LPP;    // rows of a tile
  constexpr int DP = LPP * DPL;  // disparities a pixel's lanes hold
  constexpr int SK = DPL > 4 ? 3 : 2;
  static_assert(DPL == 1 << SK, "a lane's run is one skew group");
  using TC = Tile<CT, R, SK>;
  using TA = Tile<AT, R, SK>;
  constexpr int CB = TC::bytes(DP), AB = TA::bytes(DP);
  constexpr int SLOT = NCH * (CB + AB);  // ring slot: cost tiles, acc tiles
  constexpr bool TWO = NCH == 2;
  extern __shared__ int4 wsm4[];
  char* const ring = (char*)wsm4;
  char* const outs = ring + NPF * SLOT;  // [2][NCH] out tiles
  const C sent = FLOAT ? C(BIGF) : C(SENT);
  const int dl = threadIdx.x % LPP, d0 = dl * DPL, r = threadIdx.x / LPP;
  // byte offsets of the lane's values in a tile: the lane's run is one
  // skew group, so value j lies j tile rows past the first
  const int oc0 = TC::offset(d0, r), oa0 = TA::offset(d0, r);
  auto oc = [&](int j) { return oc0 + j * TC::CPR * 16; };
  auto oa = [&](int j) { return oa0 + j * TA::CPR * 16; };
  const long long plane = (long long)W * HL;  // stride of d
  const int tpf = (HL + R - 1) / R;           // tiles of a frame
  const long long tiles = (long long)B * tpf;
  const AT* const acc_src = TWO ? acc : acc_in;

  for (long long g = blockIdx.x; g < tiles; g += gridDim.x) {
    const int h0 = (int)(g % tpf) * R, rows = min(R, HL - h0);
    const long long fbase = (g / tpf) * D * plane + h0;  // (b, 0, 0, h0)
    auto xat = [&](int k, int s) {  // chain k's scan position at step s
      return k == 1 || reverse ? W - 1 - s : s;
    };
    auto fetch = [&](int s) {  // step s's tiles into ring slot s % NPF
      char* slot = ring + (s % NPF) * SLOT;
      const bool with_acc = TWO ? 2 * s >= W + NPF : acc_in != nullptr;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const long long xo = fbase + (long long)xat(k, s) * HL;
        copy_in<TC>(slot + k * CB, cost + xo, plane, D, rows, vec_c);
        if (with_acc)
          copy_in<TA>(slot + NCH * CB + k * AB, acc_src + xo, plane, D,
                      rows, vec_a);
      }
    };
    auto store = [&](int s) {  // step s's out tiles to acc
      const char* out = outs + (s & 1) * NCH * AB;
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        if (!(TWO && k == 1 && 2 * s == W - 1))  // a middle pixel once
          copy_out<TA>(out + k * AB, acc + fbase + (long long)xat(k, s) * HL,
                       plane, D, rows, vec_a);
    };

#pragma unroll 1
    for (int s = 0; s < NPF - 1; ++s) {
      if (s < W) fetch(s);
      cp_async_commit();
    }
    C L[NCH][DPL];  // carries start at zero (f32: the sentinel past D)
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        L[k][j] = FLOAT && d0 + j >= D ? sent : C(0);

#pragma unroll 1
    for (int t = 0; t < W; ++t) {
      cp_async_wait<NPF - 2>();  // step t's tiles have landed
      __syncthreads();  // ... for every thread; slot (t - 1) % NPF is free
      if (t > 0) store(t - 1);
      if (t + NPF - 1 < W) fetch(t + NPF - 1);
      cp_async_commit();

      const char* slot = ring + (t % NPF) * SLOT;
      const int mid = 2 * t - (W - 1);  // < 0 before the middle
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        C c[DPL], Ln[DPL];
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          c[j] = (C)*(const CT*)(slot + k * CB + oc(j));
          if (!FLOAT && d0 + j >= D) c[j] = SENT;  // the only int mask
        }
        sgm_step<LPP, DPL>(L[k], c, Ln, dl, p1, p2, sent);
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          L[k][j] = FLOAT && d0 + j >= D ? sent : Ln[j];
      }
      // value j of the sum chain k adds its path value to (read after the
      // step, so it holds no registers across it)
      auto sum_at = [&](int k, int j) -> C {
        if (!TWO)
          return acc_in != nullptr ? (C)*(const AT*)(slot + CB + oa(j))
                                   : C(0);
        if (mid < 1) return C(0);
        if (mid == 1)  // the other chain was here one step ago
          return (C)*(const AT*)(outs + ((t - 1) & 1) * NCH * AB +
                                 (1 - k) * AB + oa(j));
        if (2 * t >= W + NPF)  // copied with the cost
          return (C)*(const AT*)(slot + NCH * CB + k * AB + oa(j));
        // stored after the copy had to start
        return r < rows && d0 + j < D
                   ? (C)acc[fbase + (d0 + j) * plane +
                            (long long)xat(k, t) * HL + r]
                   : C(0);
      };
      char* out = outs + (t & 1) * NCH * AB;
      if (TWO && mid == 0) {  // an odd width's middle pixel
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          *(AT*)(out + oa(j)) = (AT)((C(0) + L[0][j]) + L[1][j]);
      } else {
#pragma unroll
        for (int k = 0; k < NCH; ++k)
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            *(AT*)(out + k * AB + oa(j)) = (AT)(sum_at(k, j) + L[k][j]);
      }
    }
    __syncthreads();
    store(W - 1);
    cp_async_wait<0>();
  }
}

// B8c's launch, planned as B2's: as many blocks as the card holds at once,
// or, where the row tiles need several rounds, as many as share them out
// evenly, each block taking its tiles in turn. plan, when not NULL,
// receives six host ints: blocks per multiprocessor, multiprocessors,
// blocks launched, rounds, rows a tile, shared bytes a block.
template <typename CT, typename AT, int LPP, int DPL, int NCH>
int launch_wmajor(const void* cost, const void* acc_in, void* acc, int B,
                  int D, int W, int HL, float p1, float p2, int reverse,
                  int* plan, cudaStream_t s) {
  constexpr int R = WT / LPP, DP = LPP * DPL, SK = DPL > 4 ? 3 : 2;
  constexpr int CB = Tile<CT, R, SK>::bytes(DP);
  constexpr int AB = Tile<AT, R, SK>::bytes(DP);
  constexpr int NPF = ring_depth(NCH * (CB + AB), 2 * NCH * AB);
  constexpr size_t smem = (size_t)(NPF + 2) * NCH * AB + NPF * NCH * CB;
  using C = typename Compute<CT>::type;
  auto kernel = wmajor_kernel<CT, AT, LPP, DPL, NCH, NPF>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WT,
                                                          smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long tiles = (long long)B * ((HL + R - 1) / R);
  const long long resident = (long long)per_sm * sms;
  const long long rounds = (tiles + resident - 1) / resident;
  const int blocks = (int)((tiles + rounds - 1) / rounds);
  if (plan) {
    plan[0] = per_sm;
    plan[1] = sms;
    plan[2] = blocks;
    plan[3] = (int)rounds;
    plan[4] = R;
    plan[5] = (int)smem;
  }
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec_c = (HL * (int)sizeof(CT)) % 16 == 0 && aligned(cost);
  const int vec_a = (HL * (int)sizeof(AT)) % 16 == 0 && aligned(acc) &&
                    (acc_in == nullptr || aligned(acc_in));
  kernel<<<blocks, WT, smem, s>>>((const CT*)cost, (const AT*)acc_in,
                                  (AT*)acc, B, D, W, HL, (C)p1, (C)p2,
                                  reverse, vec_c, vec_a);
  return (int)cudaGetLastError();
}

// lanes a pixel and disparities a lane by D: (8, 4) to D = 32, (8, 8) to
// 64, (16, 8) to 128, so a tile holds 32, 32 or 16 rows
template <typename CT, typename AT, int NCH>
int wmajor_shape(const void* cost, const void* acc_in, void* acc, int B,
                 int D, int W, int HL, float p1, float p2, int reverse,
                 int* plan, cudaStream_t s) {
  if (D < 1 || D > 128 || W < 1 || HL < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  if (D <= 32)
    return launch_wmajor<CT, AT, 8, 4, NCH>(cost, acc_in, acc, B, D, W, HL,
                                            p1, p2, reverse, plan, s);
  if (D <= 64)
    return launch_wmajor<CT, AT, 8, 8, NCH>(cost, acc_in, acc, B, D, W, HL,
                                            p1, p2, reverse, plan, s);
  return launch_wmajor<CT, AT, 16, 8, NCH>(cost, acc_in, acc, B, D, W, HL,
                                           p1, p2, reverse, plan, s);
}

// the (cost_type, acc_type) pairs: (int16, int16), (int16, f32), (f32, f32)
template <int NCH>
int wmajor_types(const void* cost, const void* acc_in, void* acc, int B,
                 int D, int W, int HL, float p1, float p2, int reverse,
                 int cost_type, int acc_type, int* plan, cudaStream_t s) {
  if (cost_type == T_I16 && acc_type == T_I16)
    return wmajor_shape<int16_t, int16_t, NCH>(cost, acc_in, acc, B, D, W,
                                               HL, p1, p2, reverse, plan, s);
  if (cost_type == T_I16 && acc_type == T_F32)
    return wmajor_shape<int16_t, float, NCH>(cost, acc_in, acc, B, D, W, HL,
                                             p1, p2, reverse, plan, s);
  if (cost_type == T_F32 && acc_type == T_F32)
    return wmajor_shape<float, float, NCH>(cost, acc_in, acc, B, D, W, HL,
                                           p1, p2, reverse, plan, s);
  return (int)cudaErrorInvalidValue;
}

// B8b's tile: XT_H rows h by XT_ROW_BYTES of the (x, d) span; XT_STAGES
// tiles in flight a block
constexpr int XT_H = 64;
constexpr int XT_ROW_BYTES = 256;
constexpr int XT_STAGES = 3;
constexpr int XT_THREADS = 128;
constexpr int XT_TILE_BYTES = XT_H * XT_ROW_BYTES;

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// element j of a chunk of 2- or 4-byte elements, as the element's bits
template <typename T>
__device__ __forceinline__ T elem(const uint4& v, int j) {
  if (sizeof(T) == 4) return (T)word(v, j);
  return (T)(word(v, j >> 1) >> (16 * (j & 1)));
}

// o[i] element j = a[j] element i, for 8x8 2-byte elements: the two halves
// of output word p come from rows 2p and 2p + 1
__device__ __forceinline__ void xpose(const uint4 (&a)[8], uint4 (&o)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned sel = (i & 1) ? 0x7632 : 0x5410;
    const int q = i >> 1;
    o[i] = make_uint4(__byte_perm(word(a[0], q), word(a[1], q), sel),
                      __byte_perm(word(a[2], q), word(a[3], q), sel),
                      __byte_perm(word(a[4], q), word(a[5], q), sel),
                      __byte_perm(word(a[6], q), word(a[7], q), sel));
  }
}

// the same for 4x4 4-byte elements
__device__ __forceinline__ void xpose(const uint4 (&a)[4], uint4 (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = make_uint4(word(a[0], i), word(a[1], i), word(a[2], i),
                      word(a[3], i));
}

// 16-byte chunk of the shared tile that holds chunk k of input row r (NC
// chunks a row)
template <int EPC, int NC>
__device__ __forceinline__ int xchunk(int r, int k) {
  return r * NC + (k ^ ((r / EPC) & 7));
}

// B8b: TO maps (B, H, W, D) -> (B, D, W, HP), rows h >= H zero; else
// (B, D, W, HP) -> (B, H, W, D). T: the element's bits (2 or 4 bytes).
// vec_in / vec_out: 16-byte accesses on that side. See the note at the
// top of the file.
template <typename T, bool TO>
__global__ void __launch_bounds__(XT_THREADS)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, int B, int H,
                 int W, int D, int HP, int vec_in, int vec_out) {
  constexpr int ES = (int)sizeof(T), EPC = 16 / ES;
  constexpr int CW = XT_ROW_BYTES / ES;       // (x, d) columns a tile
  constexpr int NR = TO ? XT_H : CW;          // input rows a tile
  constexpr int NC = (TO ? CW : XT_H) / EPC;  // chunks an input row
  constexpr int NRB = NR / EPC;               // chunks an output row
  static_assert(NRB % 8 == 0 && NC % 8 == 0, "a quarter warp's 8 chunks");
  extern __shared__ int4 xsm[];
  const long long WD = (long long)W * D;
  const int n_ht = ((TO ? HP : H) + XT_H - 1) / XT_H;
  const long long n_ct = (WD + CW - 1) / CW;
  const long long tiles = B * n_ht * n_ct;

  struct Tile {
    long long b, c0;
    int h0;
    int nr;   // input rows to read: rows h < H (TO), columns c < WD
    int ne;   // elements of an input row to read = output rows to write
    int len;  // elements of an output row to write
  };
  auto tile_at = [&](long long g) {
    Tile t;
    t.c0 = (g % n_ct) * CW;
    t.h0 = (int)((g / n_ct) % n_ht) * XT_H;
    t.b = g / (n_ct * n_ht);
    const int cols = (int)min((long long)CW, WD - t.c0);
    if (TO) {
      t.nr = max(0, min(XT_H, H - t.h0));
      t.ne = cols;
      t.len = min(XT_H, HP - t.h0);
    } else {
      t.nr = cols;
      t.ne = min(XT_H, H - t.h0);
      t.len = cols;
    }
    return t;
  };
  // input row r of tile t
  auto in_row = [&](const Tile& t, int r) -> const T* {
    if (TO) return in + ((t.b * H + t.h0 + r) * WD + t.c0);
    const long long c = t.c0 + r;
    return in + (((t.b * D + c % D) * W + c / D) * (long long)HP + t.h0);
  };
  // tile t into ring slot `slot`, asynchronously where vec_in
  auto fetch = [&](long long g, int slot) {
    if (g >= tiles) return;
    const Tile t = tile_at(g);
    char* s = (char*)xsm + slot * XT_TILE_BYTES;
    if (vec_in) {
      for (int i = threadIdx.x; i < NR * NC; i += XT_THREADS) {
        const int r = i / NC, k = i % NC;
        if (r < t.nr && k * EPC < t.ne)
          cp_async16(s + xchunk<EPC, NC>(r, k) * 16, in_row(t, r) + k * EPC);
      }
    } else {
      for (int i = threadIdx.x; i < NR * NC * EPC; i += XT_THREADS) {
        const int r = i / (NC * EPC), e = i % (NC * EPC);
        if (r < t.nr && e < t.ne)
          *(T*)(s + xchunk<EPC, NC>(r, e / EPC) * 16 + (e % EPC) * ES) =
              in_row(t, r)[e];
      }
    }
  };

  long long g = blockIdx.x;
#pragma unroll 1
  for (int s = 0; s < XT_STAGES - 1; ++s) {
    fetch(g + (long long)s * gridDim.x, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; g < tiles; ++k, g += gridDim.x) {
    cp_async_wait<XT_STAGES - 2>();  // tile k's copies have landed
    __syncthreads();  // ... every thread's; slot (k - 1) % XT_STAGES is free
    fetch(g + (long long)(XT_STAGES - 1) * gridDim.x,
          (k + XT_STAGES - 1) % XT_STAGES);
    cp_async_commit();
    const Tile t = tile_at(g);
    const char* s = (const char*)xsm + (k % XT_STAGES) * XT_TILE_BYTES;
    for (int q = threadIdx.x; q < NRB * NC; q += XT_THREADS) {
      const int rb = q % NRB, kb = q / NRB;  // output chunk, input chunk
      uint4 a[EPC], o[EPC];
#pragma unroll
      for (int j = 0; j < EPC; ++j) {
        const int r = rb * EPC + j;
        a[j] = r < t.nr ? *(const uint4*)(s + xchunk<EPC, NC>(r, kb) * 16)
                        : make_uint4(0, 0, 0, 0);
      }
      xpose(a, o);
      // output row e = kb * EPC + i: column (x, d) = c0 + e (TO) or row
      // h0 + e; its elements rb * EPC + j
      long long x = 0;
      int d = 0;
      if (TO) {
        const long long c = t.c0 + kb * EPC;
        x = c / D;
        d = (int)(c % D);
      }
#pragma unroll
      for (int i = 0; i < EPC; ++i) {
        const int e = kb * EPC + i;
        if (e < t.ne) {
          T* dst = (TO ? out + ((t.b * D + d) * W + x) * (long long)HP + t.h0
                       : out + (t.b * H + t.h0 + e) * WD + t.c0) +
                   rb * EPC;
          if (vec_out) {
            if (rb * EPC < t.len) *(uint4*)dst = o[i];
          } else {
#pragma unroll
            for (int j = 0; j < EPC; ++j)
              if (rb * EPC + j < t.len) dst[j] = elem<T>(o[i], j);
          }
        }
        if (TO && ++d == D) {
          d = 0;
          ++x;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// B8b's launch: as many blocks as the card holds at once, or one a tile
// where there are fewer tiles. plan, when not NULL, receives four host
// ints: blocks per multiprocessor, multiprocessors, blocks, tiles.
template <typename T, bool TO>
int launch_transpose(const void* in, void* out, int B, int H, int W, int D,
                     int HP, int* plan, cudaStream_t s) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || HP < H)
    return (int)cudaErrorInvalidValue;
  auto kernel = transpose_kernel<T, TO>;
  constexpr int smem = XT_STAGES * XT_TILE_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, XT_THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  constexpr int CW = XT_ROW_BYTES / (int)sizeof(T);
  const long long wd = (long long)W * D;
  const long long tiles = (long long)B * (((TO ? HP : H) + XT_H - 1) / XT_H) *
                          ((wd + CW - 1) / CW);
  const int blocks = (int)std::min(tiles, (long long)per_sm * sms);
  if (plan) {
    plan[0] = per_sm;
    plan[1] = sms;
    plan[2] = blocks;
    plan[3] = (int)std::min(tiles, 2147483647LL);
  }
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const bool rows_h = (long long)HP * sizeof(T) % 16 == 0;
  const bool rows_c = wd * (long long)sizeof(T) % 16 == 0;
  const int vec_in = aligned(in) && (TO ? rows_c : rows_h);
  const int vec_out = aligned(out) && (TO ? rows_h : rows_c);
  kernel<<<blocks, XT_THREADS, smem, s>>>((const T*)in, (T*)out, B, H, W, D,
                                          HP, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// B8c, one horizontal sweep of the (B, D, W, HL) cost along W (reverse: right
// to left) into acc_out, added to acc_in when it is not NULL (it then equals
// acc_out). (cost_type, acc_type): (int16, int16), (int16, f32) or
// (f32, f32). plan as launch_wmajor.
extern "C" int v3d_wmajor_sweep(void* cost, void* acc_in, void* acc_out,
                                int B, int D, int W, int HL, float p1,
                                float p2, int reverse, int cost_type,
                                int acc_type, void* plan, void* stream) {
  return wmajor_types<1>(cost, acc_in, acc_out, B, D, W, HL, p1, p2,
                         reverse ? 1 : 0, cost_type, acc_type, (int*)plan,
                         (cudaStream_t)stream);
}

// B8c, both horizontal sweeps in one launch: the sum of the left-to-right
// and the right-to-left path of the (B, D, W, HL) cost into acc, every
// element written. Types and plan as v3d_wmajor_sweep.
extern "C" int v3d_wmajor_horizontal(void* cost, void* acc, int B, int D,
                                     int W, int HL, float p1, float p2,
                                     int cost_type, int acc_type, void* plan,
                                     void* stream) {
  return wmajor_types<2>(cost, nullptr, acc, B, D, W, HL, p1, p2, 0,
                         cost_type, acc_type, (int*)plan,
                         (cudaStream_t)stream);
}

// B8b, an exact layout change of 2- or 4-byte elements: to_wmajor != 0
// maps (B, H, W, D) -> (B, D, W, HP), rows h >= H zero, else
// (B, D, W, HP) -> (B, H, W, D). plan as launch_transpose.
extern "C" int v3d_wmajor_transpose(void* in, void* out, int B, int H, int W,
                                    int D, int HP, int elem_size,
                                    int to_wmajor, void* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* pl = (int*)plan;
  if (elem_size == 2)
    return to_wmajor ? launch_transpose<uint16_t, true>(in, out, B, H, W, D,
                                                        HP, pl, s)
                     : launch_transpose<uint16_t, false>(in, out, B, H, W,
                                                         D, HP, pl, s);
  if (elem_size == 4)
    return to_wmajor ? launch_transpose<uint32_t, true>(in, out, B, H, W, D,
                                                        HP, pl, s)
                     : launch_transpose<uint32_t, false>(in, out, B, H, W,
                                                         D, HP, pl, s);
  return (int)cudaErrorInvalidValue;
}
