// Kernel P: six toy int16 ops, the card's counterpart of the TPU toolchain
// probe tools/probe_i16.py (its toy kernels k_add ... k_shift, lines 50-70,
// launched by run, line 34).
//
// On the TPU the probe asks which int16 vector ops Mosaic lowers (i16
// min/cmp and 16-bit lane rotates did not). The CUDA compiler lowers all
// of them, so here each op is one elementwise kernel over the probe's
// (8, 64, 256) int16 tile, held against its torch expression: add,
// add+sub (the cost kernel's ring update), select by column, f32 -> int16
// cast, int16 -> f32 cast with a roll of 1 along the last axis, and the
// shift/and halving. int16 arithmetic wraps and the f32 -> int16 cast
// saturates, as XLA's add and convert do.
//
// What bounds them on the H100: nothing of note -- 256 KB in and out per
// op, a few microseconds of launch each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void k_add(const int16_t* a, const int16_t* b, int16_t* o,
                      int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = (int16_t)(a[i] + b[i]);
}

__global__ void k_addsub(const int16_t* a, const int16_t* b, const int16_t* c,
                         int16_t* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = (int16_t)((int16_t)(a[i] + b[i]) - c[i]);
}

__global__ void k_where(const int16_t* a, const int16_t* b, int16_t* o, int n,
                        int last) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = i % last < 4 ? a[i] : b[i];
}

__global__ void k_cast_f32_i16(const int16_t* a, int16_t* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = (int16_t)(int)fminf(fmaxf((float)a[i] * 2.0f, -32768.0f),
                                          32767.0f);
}

__global__ void k_cast_roll(const int16_t* a, int16_t* o, int n, int last) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int col = i % last;
  float f = (float)a[i - col + (col + last - 1) % last];  // roll by +1
  o[i] = (int16_t)(int)f;
}

__global__ void k_shift(const int16_t* a, int16_t* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = (int16_t)((a[i] >> 1) + (a[i] & 1));
}

}  // namespace

// op: 0 add, 1 add+sub, 2 where, 3 f32->i16 cast, 4 i16->f32 cast + roll,
// 5 shift/and. n elements, last = size of the last axis.
extern "C" int v3d_probe_i16(int op, void* a, void* b, void* c, void* out,
                             int n, int last, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int16_t *pa = (const int16_t*)a, *pb = (const int16_t*)b,
                *pc = (const int16_t*)c;
  int16_t* po = (int16_t*)out;
  dim3 grid((n + 255) / 256), block(256);
  switch (op) {
    case 0: k_add<<<grid, block, 0, s>>>(pa, pb, po, n); break;
    case 1: k_addsub<<<grid, block, 0, s>>>(pa, pb, pc, po, n); break;
    case 2: k_where<<<grid, block, 0, s>>>(pa, pb, po, n, last); break;
    case 3: k_cast_f32_i16<<<grid, block, 0, s>>>(pa, po, n); break;
    case 4: k_cast_roll<<<grid, block, 0, s>>>(pa, po, n, last); break;
    case 5: k_shift<<<grid, block, 0, s>>>(pa, po, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
