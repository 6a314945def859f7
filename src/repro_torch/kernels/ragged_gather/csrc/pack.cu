// Pack/unpack kernels K6-K7 of the data plane (MoE dispatch and combine,
// pack_blocks / unpack_blocks), for sm_90a.
//
// Both move whole rows through an int32 row-index map.  A row is raw bytes,
// so one kernel serves every dtype and every row width.
//
// K6 has two kernels, chosen by shape in the launcher:
// - the bulk kernel, for rows of at least kBulkMinBytes whose width and
//   both base pointers are multiples of 16: Hopper's 1-D bulk copy
//   (bulk.cuh).  The output is cut into units of one ring stage each:
//   kGatherStageBytes / row_bytes whole rows, or, for a row wider than a
//   stage, one stage-sized piece of one row.  A persistent grid of
//   kGatherCtasPerSm CTAs an SM takes the units round robin, so the grid
//   writes the output front together.  A CTA loads its units' indices
//   into shared memory in one coalesced pass and clips them there; then
//   one warp streams its units through a ring of kGatherStages stages on
//   mbarriers: each row arrives by its own bulk load, issued from its own
//   lane, and a full stage (consecutive output rows are contiguous) leaves
//   by one bulk store, marked evict-first in L2 so that the output does
//   not push out source rows that are read again (top-2 reads each token
//   twice).  No byte passes through registers.
//   The ring: stage k of a CTA uses slot k % S in phase k / S (S =
//   kGatherStages, one full mbarrier a slot, count 1: the arrival that
//   announces the stage's bytes).  Loads run S - 2 stages ahead of the
//   stores, so S - 1 stages load while at most one store still reads its
//   slot; before slot k % S is loaded again, the store of stage k - S must
//   have read it (cp.async.bulk.wait_group.read 1: all but the newest
//   store group).  Lane 0 issues every store, commit and wait: bulk groups
//   belong to a thread.
// - the unit kernel, for narrower, odd-width or misaligned rows: a
//   template on the unit a thread copies, 16 bytes (uint4) when the row
//   width and both base pointers are multiples of 16, else the widest of
//   8, 4, 2 or 1 bytes that divides them all (a 28-byte fp32 row of F=7
//   moves in 4-byte units).  A group of tpr threads (a power of two, at
//   most a block) copies one row, tpr = the row's units rounded up to a
//   power of two and capped at the block; a block holds kThreads / tpr
//   groups.  The groups walk the rows in a grid-stride loop, and each
//   group reads its row's index once.  No division runs inside the loop.
// K7 is the unit kernel's scatter twin.
//
// Bound: no arithmetic on the data, so each kernel is bound by the bytes it
// moves over device memory (3.35 TB/s on an H100 SXM): K6 reads each
// distinct source row once (repeats, such as top-2's two reads of a token
// or the sentinel row of empty slots, come from L2) and writes M rows, K7
// zeroes its output (a memset by the launcher's caller) and writes the rows
// whose destination is in range.  The unit kernel has one row in flight a
// group between two dependent latencies (the index, then the row); the
// bulk kernel reads its indices ahead and keeps whole stages in flight.
//
// Each launcher returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"

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

// K6's bulk kernel.  Same function as ragged_gather_kernel, for rows of at
// least kBulkMinBytes, 16-byte aligned.  The threshold, the ring and the
// grid are the fastest of those measured on an H100 (PERF.md): below 384
// bytes a stage needs more bulk loads than one warp issues as fast as HBM
// brings them, and the unit kernel is faster at 256 bytes and below.
constexpr long long kBulkMinBytes = 384;
constexpr int kGatherStages = 6;
constexpr int kGatherStageBytes = 16384;
constexpr int kGatherCtasPerSm = 2;
constexpr int kGatherIdxCap = 2048;     // source rows a CTA holds, at most
constexpr int kGatherBulkThreads = 128; // all load the indices, warp 0 copies
// the barriers (128 bytes), the source rows (kGatherIdxCap ints), then the
// ring; a CTA with fewer rows or stages gets less of each
constexpr int kGatherSmem =
    128 + kGatherIdxCap * 4 + kGatherStages * kGatherStageBytes;
// Shared memory of one SM on sm_90 (228 KB), and what the hardware keeps
// of it for each resident CTA (1 KB).
constexpr int kSmemPerSm = 233472;
constexpr int kSmemPerCta = 1024;
static_assert(kGatherCtasPerSm * (kGatherSmem + kSmemPerCta) <= kSmemPerSm &&
                  kGatherStageBytes % 16 == 0 && kGatherStages >= 3,
              "the rings of kGatherCtasPerSm CTAs fit an SM, their stages are "
              "whole 16-byte units, and loads run ahead of a store");

// Shared memory for the source rows of a CTA's stages, at most most
// stages of per_stage rows, in whole 128-byte lines.
__host__ __device__ __forceinline__ int idx_bytes(long long most,
                                                  int per_stage) {
  return (int)((most * per_stage * 4 + 127) / 128 * 128);
}

// The output cut into units, a ring stage each: kSplit false, unit u is
// output rows [u * per, u * per + per) (the last unit shorter); kSplit
// true, unit u is piece u % pieces of output row u / pieces, pieces
// stage-sized pieces a row (the last one shorter).  Stage k of CTA b is
// unit b + k * gridDim.x; src holds the clipped source rows of its
// stages, per (kSplit: 1) a stage.
template <bool kSplit>
__global__ void __launch_bounds__(kGatherBulkThreads)
    ragged_gather_bulk_kernel(const uint8_t* __restrict__ x,
                              const int* __restrict__ idx,
                              uint8_t* __restrict__ out, long long n_rows,
                              long long m, long long row_bytes, long long units,
                              int per, int pieces) {
  constexpr int S = kGatherStages, kLag = S - 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const long long G = gridDim.x, b = blockIdx.x;
  const int per_stage = kSplit ? 1 : per;
  uint64_t* full = (uint64_t*)smem;
  int* src = (int*)(smem + 128);
  uint8_t* ring = smem + 128 + idx_bytes((units + G - 1) / G, per_stage);
  const long long n = (units - b + G - 1) / G;   // this CTA's stages
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) bulk::mbar_init(&full[s], 1);
    bulk::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < n * per_stage; i += kGatherBulkThreads) {
    const int k = i / per_stage;
    const long long u = b + k * G;
    const long long row = kSplit ? u / pieces : u * per + (i - k * per_stage);
    if (row < m) {
      const long long s = idx[row];
      src[i] = (int)(s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s));
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  // the bytes stage k carries (a multiple of 16) and where they go
  auto stage_bytes = [&](long long k) -> uint32_t {
    const long long u = b + k * G;
    if (kSplit) {
      const long long left = row_bytes - (u % pieces) * kGatherStageBytes;
      return (uint32_t)(left < kGatherStageBytes ? left : kGatherStageBytes);
    }
    return (uint32_t)((m - u * per < per ? m - u * per : per) * row_bytes);
  };
  auto stage_dst = [&](long long k) -> uint8_t* {
    const long long u = b + k * G;
    if (kSplit)
      return out + (u / pieces) * row_bytes + (u % pieces) * kGatherStageBytes;
    return out + u * per * row_bytes;
  };
  for (long long k = 0; k < n + kLag; ++k) {
    if (k < n) {
      const int s = (int)(k % S);
      uint8_t* slot = ring + (size_t)s * kGatherStageBytes;
      const uint32_t bytes = stage_bytes(k);
      if (lane == 0) {
        if (k >= S) bulk::wait_read<1>();   // the store of stage k - S is out
        bulk::mbar_expect_tx(&full[s], bytes);
      }
      __syncwarp();
      const long long u = b + k * G;
      if (kSplit) {
        if (lane == 0)
          bulk::load(slot,
                     x + src[k] * row_bytes + (u % pieces) * kGatherStageBytes,
                     bytes, &full[s]);
      } else {
        const int rows = (int)(m - u * per < per ? m - u * per : per);
        for (int l = lane; l < rows; l += 32)
          bulk::load(slot + l * row_bytes, x + src[k * per + l] * row_bytes,
                     (uint32_t)row_bytes, &full[s]);
      }
    }
    const long long j = k - kLag;
    if (lane == 0 && j >= 0) {
      const int s = (int)(j % S);
      bulk::mbar_wait(&full[s], (uint32_t)(j / S) & 1u);
      bulk::fence_async();
      bulk::store_evict_first(stage_dst(j), ring + (size_t)s * kGatherStageBytes,
                              stage_bytes(j));
      bulk::commit();
    }
  }
  // the CTA may leave once its stores have read shared memory; their
  // writes complete before the grid does
  if (lane == 0) bulk::wait_read<0>();
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

// SMs of the current device, read once per device and kept; and the
// bulk kernel's dynamic shared memory allowed once per device.
int sm_count(int dev) {
  static int cached[64];
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n < 1)
    n = 1;
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

template <bool kSplit>
cudaError_t allow_ring_smem(int dev) {
  static bool done[64];
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(ragged_gather_bulk_kernel<kSplit>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGatherSmem);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

template <bool kSplit>
cudaError_t gather_bulk_as(const void* x, const void* idx, void* out,
                           long long n_rows, long long m, long long row_bytes,
                           long long units, int per, int pieces,
                           cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  long long ctas = (long long)kGatherCtasPerSm * sm_count(dev);
  if (ctas > units) ctas = units;              // a stage a CTA at least
  const int per_stage = kSplit ? 1 : per;
  const long long stages_fit = kGatherIdxCap / per_stage;
  const long long by_idx = (units + stages_fit - 1) / stages_fit;
  if (ctas < by_idx) ctas = by_idx;            // its indices fit
  if (ctas < 1) ctas = 1;
  // what a CTA can use: the rows of its stages and a slot each, at most
  // the ring
  const long long most = (units + ctas - 1) / ctas;
  const int smem = 128 + idx_bytes(most, per_stage) +
                   (int)(most < kGatherStages ? most : kGatherStages) *
                       kGatherStageBytes;
  e = allow_ring_smem<kSplit>(dev);
  if (e != cudaSuccess) return e;
  ragged_gather_bulk_kernel<kSplit><<<(unsigned)ctas, kGatherBulkThreads,
                                      smem, stream>>>(
      (const uint8_t*)x, (const int*)idx, (uint8_t*)out, n_rows, m,
      row_bytes, units, per, pieces);
  return cudaGetLastError();
}

cudaError_t gather_bulk(const void* x, const void* idx, void* out,
                        long long n_rows, long long m, long long row_bytes,
                        cudaStream_t stream) {
  if (row_bytes > kGatherStageBytes) {
    const int pieces =
        (int)((row_bytes + kGatherStageBytes - 1) / kGatherStageBytes);
    return gather_bulk_as<true>(x, idx, out, n_rows, m, row_bytes,
                                m * pieces, 1, pieces, stream);
  }
  const int per = (int)(kGatherStageBytes / row_bytes);
  return gather_bulk_as<false>(x, idx, out, n_rows, m, row_bytes,
                               (m + per - 1) / per, per, 1, stream);
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
  const int unit = unit_bytes(x, out, row_bytes);
  if (unit == 16 && row_bytes >= kBulkMinBytes)
    return (int)gather_bulk(x, idx, out, n_rows, m, row_bytes, st);
  switch (unit) {
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
