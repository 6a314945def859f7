// Reduction slab kernels K4-K5 of the reduce_scatterv/allreducev data plane,
// for sm_90a.
//
// Same rank-batched layout as K1-K3 (slab.cu): buf (P, buf_rows, row) and
// slab (P, rows, row), one int32 table entry per rank, the CTAs of rank r
// (grid.y == r) read entry r, starts placed as lax.dynamic_slice places them
// (a negative start counts once from the end, then it is clamped to
// [0, buf_rows - rows]) and valid counts clamped to [0, rows].
//
// Unlike K1-K3 these kernels add, so they are typed: one instantiation per
// dtype, each thread handling one 16-byte vector per iteration of a
// grid-stride loop (4 fp32, 8 bf16 or 4 int32 elements):
//   fp32  one IEEE add per element (no FMA to contract, no flush to zero);
//   bf16  each element widened to fp32, added, rounded once to nearest even
//         (__float2bfloat16_rn), which is how PyTorch adds bf16 on the CPU
//         and on the card and how XLA does;
//   int32 wrapping add (done in unsigned arithmetic, where it is defined).
// Rows of a receive window at or past its valid count are never stored to,
// so they keep their bits (-0.0 included: cur + 0 would give +0.0).
//
// Bound: device memory.  K4 reads 2 * nv rows and writes nv rows per rank;
// K5 moves the same plus rows_out rows written and rows_out - overlap rows
// read.  One add per element is ~1/12 of an operation per byte, far below
// what the card computes per byte it loads, so the design only has to move
// the live rows once with full-width coalesced 16-byte accesses.  No TMA yet:
// making them fast is later work.
//
// Each launcher returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCtas = 2048;  // as in slab.cu: two waves of 132 SMs

enum DType { kF32 = 0, kBF16 = 1, kI32 = 2 };

__device__ __forceinline__ long long clamp_ll(long long x, long long lo,
                                              long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ long long place(int start, long long buf_rows,
                                           long long rows) {
  const long long s = start < 0 ? start + buf_rows : start;
  return clamp_ll(s, 0, buf_rows - rows);
}

// a + b on one 16-byte vector of dtype D.
template <int D>
__device__ __forceinline__ uint4 vadd(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 vadd<kF32>(uint4 a, uint4 b) {
  uint4 r;
  r.x = __float_as_uint(__fadd_rn(__uint_as_float(a.x), __uint_as_float(b.x)));
  r.y = __float_as_uint(__fadd_rn(__uint_as_float(a.y), __uint_as_float(b.y)));
  r.z = __float_as_uint(__fadd_rn(__uint_as_float(a.z), __uint_as_float(b.z)));
  r.w = __float_as_uint(__fadd_rn(__uint_as_float(a.w), __uint_as_float(b.w)));
  return r;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const float2 fx = __bfloat1622float2(x);
  const float2 fy = __bfloat1622float2(y);
  const __nv_bfloat162 s = __floats2bfloat162_rn(__fadd_rn(fx.x, fy.x),
                                                 __fadd_rn(fx.y, fy.y));
  return *reinterpret_cast<const uint32_t*>(&s);
}

template <>
__device__ __forceinline__ uint4 vadd<kBF16>(uint4 a, uint4 b) {
  return make_uint4(add_bf16x2(a.x, b.x), add_bf16x2(a.y, b.y),
                    add_bf16x2(a.z, b.z), add_bf16x2(a.w, b.w));
}

template <>
__device__ __forceinline__ uint4 vadd<kI32>(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// K4. Replaces slab_merge_add_kernel (src/repro/kernels/ragged_gather/kernel.py).
// In place: buf[r, rs + i] += slab[r, i] for i < nv, rs = place(start[r]),
// nv = clamp(valid[r]).  No other row of buf is touched.
// Bytes moved: 2 * nv rows read, nv rows written.
template <int D>
__global__ void slab_merge_add_kernel(uint4* __restrict__ buf,
                                      const uint4* __restrict__ slab,
                                      const int* __restrict__ start,
                                      const int* __restrict__ valid,
                                      long long buf_rows, long long rows,
                                      long long vpr) {
  const long long r = blockIdx.y;
  const long long s = place(start[r], buf_rows, rows);
  const long long n = clamp_ll(valid[r], 0, rows) * vpr;
  uint4* dst = buf + (r * buf_rows + s) * vpr;
  const uint4* src = slab + r * rows * vpr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dst[i] = vadd<D>(dst[i], src[i]);
  }
}

// K5. Replaces slab_step_reduce_kernel (src/repro/kernels/ragged_gather/kernel.py).
// In place: fold as K4 at rs = place(recv_start[r]), nv = clamp(recv_valid[r]);
// then out[r, i] = updated buf[r, ss + i], ss = place(send_start[r]).
//
// K3's closed form (read an in-window output row from the slab) does not
// carry over: the output row there is buf_old[j] + slab[j - rs], and a
// thread that read buf[j] after another thread stored the sum would add the
// slab twice.  So one thread owns each buffer vector in both roles: the
// thread that folds vector rs + i stores the sum to buf and, when it falls
// in the send window [ss, ss + rows_out), also to out.  Output vectors
// outside the merge window are copied from buf vectors this launch never
// writes.  Every out vector is written exactly once and no thread reads a
// vector another thread writes.
// Bytes moved: 2 * nv rows read and nv written for the fold, rows_out rows
// written, and rows_out minus the overlap read from buf.
template <int D>
__global__ void slab_step_reduce_kernel(uint4* __restrict__ buf,
                                        const uint4* __restrict__ slab,
                                        uint4* __restrict__ out,
                                        const int* __restrict__ recv_start,
                                        const int* __restrict__ recv_valid,
                                        const int* __restrict__ send_start,
                                        long long buf_rows, long long rows_in,
                                        long long rows_out, long long vpr) {
  const long long r = blockIdx.y;
  const long long rs = place(recv_start[r], buf_rows, rows_in) * vpr;
  const long long nv = clamp_ll(recv_valid[r], 0, rows_in) * vpr;
  const long long ss = place(send_start[r], buf_rows, rows_out) * vpr;
  uint4* b = buf + r * buf_rows * vpr;
  const uint4* sl = slab + r * rows_in * vpr;
  uint4* o = out + r * rows_out * vpr;
  const long long n_out = rows_out * vpr;
  const long long n = nv > n_out ? nv : n_out;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < nv) {
      const long long j = rs + i;
      const uint4 v = vadd<D>(b[j], sl[i]);
      b[j] = v;
      if (j >= ss && j < ss + n_out) o[j - ss] = v;
    }
    if (i < n_out) {
      const long long j = ss + i;
      if (j < rs || j >= rs + nv) o[i] = b[j];
    }
  }
}

dim3 grid_for(long long vectors_per_rank, int P) {
  long long per_rank = kMaxCtas / P;
  if (per_rank < 1) per_rank = 1;
  long long x = (vectors_per_rank + kThreads - 1) / kThreads;
  if (x > per_rank) x = per_rank;
  if (x < 1) x = 1;
  return dim3((unsigned)x, (unsigned)P, 1);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16, 2 = int32.  Anything else: cudaErrorInvalidValue.
int slab_merge_add_launch(void* buf, const void* slab, const void* start,
                          const void* valid, int dtype, int P,
                          long long buf_rows, long long rows,
                          long long row_bytes, void* stream) {
  const long long vpr = row_bytes / 16;
  const dim3 grid = grid_for(rows * vpr, P);
  const cudaStream_t st = (cudaStream_t)stream;
  uint4* b = (uint4*)buf;
  const uint4* s = (const uint4*)slab;
  const int* a = (const int*)start;
  const int* v = (const int*)valid;
  switch (dtype) {
    case kF32:
      slab_merge_add_kernel<kF32><<<grid, kThreads, 0, st>>>(b, s, a, v,
                                                            buf_rows, rows, vpr);
      break;
    case kBF16:
      slab_merge_add_kernel<kBF16><<<grid, kThreads, 0, st>>>(b, s, a, v,
                                                             buf_rows, rows, vpr);
      break;
    case kI32:
      slab_merge_add_kernel<kI32><<<grid, kThreads, 0, st>>>(b, s, a, v,
                                                            buf_rows, rows, vpr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int slab_step_reduce_launch(void* buf, const void* slab, void* out,
                            const void* recv_start, const void* recv_valid,
                            const void* send_start, int dtype, int P,
                            long long buf_rows, long long rows_in,
                            long long rows_out, long long row_bytes,
                            void* stream) {
  const long long vpr = row_bytes / 16;
  const long long rows = rows_in > rows_out ? rows_in : rows_out;
  const dim3 grid = grid_for(rows * vpr, P);
  const cudaStream_t st = (cudaStream_t)stream;
  uint4* b = (uint4*)buf;
  const uint4* s = (const uint4*)slab;
  uint4* o = (uint4*)out;
  const int* rs = (const int*)recv_start;
  const int* rv = (const int*)recv_valid;
  const int* ss = (const int*)send_start;
  switch (dtype) {
    case kF32:
      slab_step_reduce_kernel<kF32><<<grid, kThreads, 0, st>>>(
          b, s, o, rs, rv, ss, buf_rows, rows_in, rows_out, vpr);
      break;
    case kBF16:
      slab_step_reduce_kernel<kBF16><<<grid, kThreads, 0, st>>>(
          b, s, o, rs, rv, ss, buf_rows, rows_in, rows_out, vpr);
      break;
    case kI32:
      slab_step_reduce_kernel<kI32><<<grid, kThreads, 0, st>>>(
          b, s, o, rs, rv, ss, buf_rows, rows_in, rows_out, vpr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Each library has its own copy, looked up through its own handle.
const char* slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
