// Pack/unpack kernels K6-K7 of the data plane (MoE dispatch and combine,
// pack_blocks / unpack_blocks), for sm_90a.
//
// Both move whole rows through an int32 row-index map.  A row is raw bytes,
// so one kernel serves every dtype and every row width.  Each kernel is a
// template on the unit a thread copies: 16 bytes (uint4) when the row width
// and both base pointers are multiples of 16, else the widest of 8, 4, 2 or
// 1 bytes that divides them all (a 28-byte fp32 row of F=7 moves in 4-byte
// units).  The launcher picks the unit from the row width and the pointers.
//
// Layout: a group of tpr threads (a power of two, at most a block) copies
// one row, tpr = the row's units rounded up to a power of two and capped at
// the block; a block holds kThreads / tpr groups.  The groups walk the rows
// in a grid-stride loop, and each group reads its row's index once.  No
// division runs inside the loop.
//
// Bound: no arithmetic on the data, so each kernel is bound by the bytes it
// moves over device memory (3.35 TB/s on an H100 SXM): K6 reads M rows and
// writes M rows, K7 zeroes its output (a memset by the launcher's caller)
// and writes the rows whose destination is in range.  The design answers
// the bound with coalesced accesses of the widest unit the rows allow, and
// the odd-width path pays for narrower units.  No TMA yet.
//
// Each launcher returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// CTAs per launch at most: 132 SMs x 8 resident CTAs of 256 threads, two
// waves; the grid-stride loop covers the rest.
constexpr long long kMaxCtas = 2048;

// K6. Replaces ragged_gather_kernel (src/repro/kernels/ragged_gather/kernel.py).
// out[i] = x[clip(idx[i], 0, n_rows - 1)] for i < m, upr units per row.
// Bytes moved: m rows read + m rows written (+ 4 m bytes of index).
template <typename U>
__global__ void ragged_gather_kernel(const U* __restrict__ x,
                                     const int* __restrict__ idx,
                                     U* __restrict__ out, long long n_rows,
                                     long long m, long long upr, int tpr) {
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const long long groups = (long long)gridDim.x * (kThreads / tpr);
  for (long long i = (long long)blockIdx.x * (kThreads / tpr) + group; i < m;
       i += groups) {
    long long s = idx[i];
    s = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
    const U* src = x + s * upr;
    U* dst = out + i * upr;
    for (long long c = lane; c < upr; c += tpr) dst[c] = src[c];
  }
}

// K7. Replaces ragged_scatter_kernel (src/repro/kernels/ragged_gather/kernel.py).
// out[idx[i]] = x[i] for i < m over an output the caller has zeroed.  A row
// whose destination is outside [0, n_out) is never stored: the trash row
// of the reference, which slices it off, is not needed.  Rows with the same
// destination land in no defined order (the reference leaves it open).
// Bytes moved: the in-range rows read and written (+ 4 m bytes of index).
template <typename U>
__global__ void ragged_scatter_kernel(const U* __restrict__ x,
                                      const int* __restrict__ idx,
                                      U* __restrict__ out, long long m,
                                      long long n_out, long long upr,
                                      int tpr) {
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const long long groups = (long long)gridDim.x * (kThreads / tpr);
  for (long long i = (long long)blockIdx.x * (kThreads / tpr) + group; i < m;
       i += groups) {
    const long long d = idx[i];
    if (d < 0 || d >= n_out) continue;
    const U* src = x + i * upr;
    U* dst = out + d * upr;
    for (long long c = lane; c < upr; c += tpr) dst[c] = src[c];
  }
}

// Widest unit (bytes) dividing the row width and both base addresses.
int unit_bytes(const void* a, const void* b, long long row_bytes) {
  const unsigned long long bits = (unsigned long long)(uintptr_t)a |
                                  (unsigned long long)(uintptr_t)b |
                                  (unsigned long long)row_bytes;
  for (int u = 16; u > 1; u /= 2)
    if (bits % u == 0) return u;
  return 1;
}

struct Shape {
  long long upr;  // units per row
  int tpr;        // threads per row
  dim3 grid;
};

Shape shape_for(long long rows, long long row_bytes, int unit) {
  Shape s;
  s.upr = row_bytes / unit;
  s.tpr = 1;
  while (s.tpr < kThreads && s.tpr < s.upr) s.tpr *= 2;
  const long long per_cta = kThreads / s.tpr;
  long long ctas = (rows + per_cta - 1) / per_cta;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  if (ctas < 1) ctas = 1;
  s.grid = dim3((unsigned)ctas, 1, 1);
  return s;
}

template <typename U>
void gather_as(const void* x, const void* idx, void* out, long long n_rows,
               long long m, long long row_bytes, cudaStream_t stream) {
  const Shape s = shape_for(m, row_bytes, sizeof(U));
  ragged_gather_kernel<U><<<s.grid, kThreads, 0, stream>>>(
      (const U*)x, (const int*)idx, (U*)out, n_rows, m, s.upr, s.tpr);
}

template <typename U>
void scatter_as(const void* x, const void* idx, void* out, long long m,
                long long n_out, long long row_bytes, cudaStream_t stream) {
  const Shape s = shape_for(m, row_bytes, sizeof(U));
  ragged_scatter_kernel<U><<<s.grid, kThreads, 0, stream>>>(
      (const U*)x, (const int*)idx, (U*)out, m, n_out, s.upr, s.tpr);
}

}  // namespace

extern "C" {

int ragged_gather_launch(const void* x, const void* idx, void* out,
                         long long n_rows, long long m, long long row_bytes,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit_bytes(x, out, row_bytes)) {
    case 16: gather_as<uint4>(x, idx, out, n_rows, m, row_bytes, st); break;
    case 8: gather_as<uint2>(x, idx, out, n_rows, m, row_bytes, st); break;
    case 4: gather_as<uint32_t>(x, idx, out, n_rows, m, row_bytes, st); break;
    case 2: gather_as<uint16_t>(x, idx, out, n_rows, m, row_bytes, st); break;
    default: gather_as<uint8_t>(x, idx, out, n_rows, m, row_bytes, st); break;
  }
  return (int)cudaGetLastError();
}

int ragged_scatter_launch(const void* x, const void* idx, void* out,
                          long long m, long long n_out, long long row_bytes,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit_bytes(x, out, row_bytes)) {
    case 16: scatter_as<uint4>(x, idx, out, m, n_out, row_bytes, st); break;
    case 8: scatter_as<uint2>(x, idx, out, m, n_out, row_bytes, st); break;
    case 4: scatter_as<uint32_t>(x, idx, out, m, n_out, row_bytes, st); break;
    case 2: scatter_as<uint16_t>(x, idx, out, m, n_out, row_bytes, st); break;
    default: scatter_as<uint8_t>(x, idx, out, m, n_out, row_bytes, st); break;
  }
  return (int)cudaGetLastError();
}

const char* slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
