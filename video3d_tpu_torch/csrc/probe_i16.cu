// Kernel P: six toy int16 ops, the card's counterpart of the TPU toolchain
// probe tools/probe_i16.py (its toy kernels k_add ... k_shift, lines 50-70,
// launched by run, line 34).
//
// On the TPU the probe asks which int16 vector ops Mosaic lowers (i16
// min/cmp and 16-bit lane rotates did not). The CUDA compiler lowers all
// of them; here they are held against their torch expressions over the
// probe's (8, 64, 256) int16 tile: add, add+sub (the cost kernel's ring
// update), select by column, f32 -> int16 cast, int16 -> f32 cast with a
// roll of 1 along the last axis, and the shift/and halving. int16
// arithmetic wraps and the f32 -> int16 cast saturates, as XLA's add and
// convert do.
//
// What bounds it on the H100: bytes, in principle (three 256 KB inputs and
// six 256 KB outputs: 2.4 MB, 0.7 us at 3.35 TB/s), but one launch costs
// about as much, so no design reaches half of that. The design cuts the
// launches: one launch computes every op its mask asks for in one pass
// over the inputs. A thread takes eight adjacent elements: one 16-byte
// load of each input the ops need and one 16-byte store per op. The roll
// takes its wrapped neighbour (column - 1 mod last) from the element
// before it in the thread's registers, or, for the first element of the
// eight and at a row's first column, with one scalar load; the select
// takes its column from the index. The output planes lie n rounded up to 8
// elements apart, so every plane starts 16-byte aligned. The last n % 8
// elements, and all of them where a pointer is not 16-byte aligned, go
// element by element in the same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NOPS = 6;
constexpr int THREADS = 256;

union Vec8 {
  uint4 u;
  int16_t e[8];
};

__device__ __forceinline__ void load8(const int16_t* p, int i0, int m,
                                      bool vec, int16_t (&v)[8]) {
  if (vec) {
    Vec8 t;
    t.u = *(const uint4*)(p + i0);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = t.e[k];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < m ? p[i0 + k] : int16_t(0);
  }
}

__device__ __forceinline__ void store8(int16_t* p, int i0, int m, bool vec,
                                       const int16_t (&v)[8]) {
  if (vec) {
    Vec8 t;
#pragma unroll
    for (int k = 0; k < 8; ++k) t.e[k] = v[k];
    *(uint4*)(p + i0) = t.u;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < m) p[i0 + k] = v[k];
  }
}

// mask bit k asks for op k: 0 add, 1 add+sub, 2 where, 3 f32->i16 cast,
// 4 i16->f32 cast + roll, 5 shift/and. out holds one plane per op asked
// for, in op order, planes ps elements apart. b is read only for ops 0-2,
// c for op 1.
__global__ void __launch_bounds__(THREADS)
probe_kernel(const int16_t* __restrict__ a, const int16_t* __restrict__ b,
             const int16_t* __restrict__ c, int16_t* __restrict__ out, int n,
             int ps, int last, int mask, int vec) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t * 8 >= n) return;
  const int i0 = (int)(t * 8), m = min(8, n - i0);
  const bool v = vec && m == 8;
  int16_t va[8], vb[8], vc[8], o[8];
  load8(a, i0, m, v, va);
  if (mask & 7) load8(b, i0, m, v, vb);
  if (mask & 2) load8(c, i0, m, v, vc);
  int plane = 0;
  auto put = [&]() { store8(out + (long long)plane++ * ps, i0, m, v, o); };
  if (mask & 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = (int16_t)(va[k] + vb[k]);
    put();
  }
  if (mask & 2) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = (int16_t)((int16_t)(va[k] + vb[k]) - vc[k]);
    put();
  }
  if (mask & 4) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = (i0 + k) % last < 4 ? va[k] : vb[k];
    put();
  }
  if (mask & 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = (int16_t)(int)fminf(fmaxf((float)va[k] * 2.0f, -32768.0f),
                                 32767.0f);
    put();
  }
  if (mask & 16) {
    const int col0 = i0 % last;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int16_t prev = 0;
      if (k < m) {
        const int col = (col0 + k) % last;
        prev = col == 0 ? a[i0 + k + last - 1]  // the row's last element
               : k > 0  ? va[k - 1]
                        : a[i0 - 1];
      }
      o[k] = (int16_t)(int)(float)prev;  // roll by +1
    }
    put();
  }
  if (mask & 32) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = (int16_t)((va[k] >> 1) + (va[k] & 1));
    put();
  }
}

}  // namespace

// The ops of mask (bit k: op k, see probe_kernel) on n int16 elements whose
// last axis has `last` elements, in one launch; out holds one plane per op
// asked for, in op order, planes n rounded up to 8 elements apart. b and c
// may be NULL where no op asked for reads them.
extern "C" int v3d_probe_i16_all(void* a, void* b, void* c, void* out, int n,
                                 int last, int mask, void* stream) {
  if (n < 1 || last < 1 || n % last != 0 || mask < 1 ||
      mask >= (1 << NOPS) || ((mask & 7) && !b) || ((mask & 2) && !c))
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = aligned(a) && aligned(out) && (!(mask & 7) || aligned(b)) &&
                  (!(mask & 2) || aligned(c));
  const long long chunks = (n + 7LL) / 8;
  probe_kernel<<<(unsigned)((chunks + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>((const int16_t*)a, (const int16_t*)b,
                                         (const int16_t*)c, (int16_t*)out, n,
                                         (int)(chunks * 8), last, mask, vec);
  return (int)cudaGetLastError();
}
