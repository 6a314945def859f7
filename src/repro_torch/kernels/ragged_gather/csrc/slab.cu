// Slab kernels K1-K3 of the gatherv/scatterv data plane, for sm_90a.
//
// Every buffer is a batch of P ranks: buf (P, buf_rows, row_bytes) and
// slab (P, rows, row_bytes), each row raw bytes, so one kernel serves
// fp32, bf16 and int32 alike.  Offsets come from int32 device tables, one
// entry per rank.  A start is placed as lax.dynamic_slice /
// dynamic_update_slice place it in the reference: a negative start counts
// once from the end (start + buf_rows), then it is clamped to [0, buf_rows
// - rows].  Valid counts are clamped to [0, rows].  The launchers' callers
// reject rows and pointers that are not 16-byte aligned.
//
// K1 copies, for each rank, one contiguous window of rows * row_bytes
// bytes to one contiguous output: P memcpys.  It flattens them into one
// list of kExtractChunk-byte chunks (the last chunk of a rank shorter) and
// gives each chunk a CTA of one thread, which brings the chunk into
// shared memory with Hopper's 1-D bulk copy (on an mbarrier) and sends it
// back out with a bulk store (bulk.cuh); no byte passes through
// registers.  A CTA holds 16 KB of shared memory, so 13 are resident an
// SM, each with its chunk in flight, and the block scheduler starts the
// next as soon as a store has read its chunk.  A persistent grid with a
// ring of chunks a CTA, and register copies, measured slower on an H100
// (PERF.md).
//
// K2 and K3: each thread copies 16 bytes (one uint4) per iteration of a
// grid-stride loop, neighbouring threads on neighbouring addresses; the
// CTAs of rank r (grid.y == r) read table entry r.
//
// Bound: the kernels do no arithmetic on the data, so each one is bound by
// the bytes it moves over device memory (3.35 TB/s on an H100 SXM).  The
// designs answer that bound by touching only live rows (the Pallas kernels
// copy the whole buffer per step), K1 with about 200 KB of loads in flight
// an SM, K2-K3 with full-width coalesced 16-byte accesses.
//
// Each launcher returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;
// K2-K3's CTAs across all ranks: enough to keep every SM busy (132 SMs x 8
// resident CTAs of 256 threads, two waves), the grid-stride loop covers
// the rest.
constexpr long long kMaxCtas = 2048;

// K1's chunk.  8 to 32 KB measured the same on an H100 (PERF.md).
constexpr int kExtractChunk = 16384;
static_assert(kExtractChunk % 16 == 0 && kExtractChunk <= 32768,
              "a chunk is whole 16-byte units in static shared memory");

__device__ __forceinline__ long long clamp_ll(long long x, long long lo,
                                              long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Row at which a rows-row window of a buf_rows-row buffer starts.
__device__ __forceinline__ long long place(int start, long long buf_rows,
                                           long long rows) {
  const long long s = start < 0 ? start + buf_rows : start;
  return clamp_ll(s, 0, buf_rows - rows);
}

// K1. Replaces slab_extract_kernel (src/repro/kernels/ragged_gather/kernel.py).
// out[r, i] = buf[r, place(start[r]) + i] for i < rows.
// Bytes moved: P * rows * row_bytes read + the same written.

// Chunk blockIdx.x of the flat list: rank c / per_rank, at byte
// (c % per_rank) * kExtractChunk of the rank's window.
__global__ void __launch_bounds__(1)
    slab_extract_kernel(const uint8_t* __restrict__ buf,
                        uint8_t* __restrict__ out,
                        const int* __restrict__ start, long long per_rank,
                        long long buf_rows, long long rows,
                        long long row_bytes) {
  __shared__ __align__(128) uint8_t chunk[kExtractChunk];
  __shared__ uint64_t full;
  const long long c = blockIdx.x, r = c / per_rank;
  const long long window = rows * row_bytes;
  const long long off = (c - r * per_rank) * kExtractChunk;
  const uint32_t bytes =
      (uint32_t)(window - off < kExtractChunk ? window - off : kExtractChunk);
  const long long s = place(start[r], buf_rows, rows);
  bulk::mbar_init(&full, 1);
  bulk::mbar_fence_init();
  bulk::mbar_expect_tx(&full, bytes);
  bulk::load(chunk, buf + (r * buf_rows + s) * row_bytes + off, bytes, &full);
  bulk::mbar_wait(&full, 0);
  bulk::fence_async();
  bulk::store(out + r * window + off, chunk, bytes);
  bulk::commit();
  bulk::wait_read<0>();
}

// K2. Replaces slab_merge_kernel (src/repro/kernels/ragged_gather/kernel.py).
// In place: buf[r, place(start[r]) + i] = slab[r, i] for i < clamp(valid[r]).
// No other row of buf is touched.
// Bytes moved: sum_r valid[r] * row_bytes read + the same written.
__global__ void slab_merge_kernel(uint4* __restrict__ buf,
                                  const uint4* __restrict__ slab,
                                  const int* __restrict__ start,
                                  const int* __restrict__ valid,
                                  long long buf_rows, long long rows,
                                  long long vpr) {
  const long long r = blockIdx.y;
  const long long s = place(start[r], buf_rows, rows);
  const long long nv = clamp_ll(valid[r], 0, rows);
  uint4* dst = buf + (r * buf_rows + s) * vpr;
  const uint4* src = slab + r * rows * vpr;
  const long long n = nv * vpr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dst[i] = src[i];
  }
}

// K3. Replaces slab_step_kernel (src/repro/kernels/ragged_gather/kernel.py).
// In place: merge as K2 at rs = place(recv_start[r]), nv = clamp(recv_valid[r]);
// then out[r, i] = merged buf[r, ss + i], ss = place(send_start[r]).
// The extract must see the merged rows, and CTAs cannot wait for each other,
// so the read-after-write is resolved in closed form: an output row j that
// lies in the merge window [rs, rs + nv) is read from the slab, any other
// from buf.  Rows read from buf are never written by this launch, so no CTA
// reads a row another CTA writes.
// Bytes moved: 2 * nv rows for the merge, rows_out written, and rows_out
// minus the overlap read from buf (the overlap is read from the slab).
__global__ void slab_step_kernel(uint4* __restrict__ buf,
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
    if (i < nv) b[rs + i] = sl[i];
    if (i < n_out) {
      const long long j = ss + i;
      o[i] = (j >= rs && j < rs + nv) ? sl[j - rs] : b[j];
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

int slab_extract_launch(const void* buf, void* out, const void* start, int P,
                        long long buf_rows, long long rows,
                        long long row_bytes, void* stream) {
  const long long per_rank = (rows * row_bytes + kExtractChunk - 1) /
                             kExtractChunk;
  if (per_rank == 0) return 0;   // rows of 0 bytes: nothing to move
  slab_extract_kernel<<<(unsigned)(per_rank * P), 1, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (uint8_t*)out, (const int*)start, per_rank,
      buf_rows, rows, row_bytes);
  return (int)cudaGetLastError();
}

int slab_merge_launch(void* buf, const void* slab, const void* start,
                      const void* valid, int P, long long buf_rows,
                      long long rows, long long row_bytes, void* stream) {
  const long long vpr = row_bytes / 16;
  slab_merge_kernel<<<grid_for(rows * vpr, P), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (uint4*)buf, (const uint4*)slab, (const int*)start, (const int*)valid,
      buf_rows, rows, vpr);
  return (int)cudaGetLastError();
}

int slab_step_launch(void* buf, const void* slab, void* out,
                     const void* recv_start, const void* recv_valid,
                     const void* send_start, int P, long long buf_rows,
                     long long rows_in, long long rows_out,
                     long long row_bytes, void* stream) {
  const long long vpr = row_bytes / 16;
  const long long rows = rows_in > rows_out ? rows_in : rows_out;
  slab_step_kernel<<<grid_for(rows * vpr, P), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (uint4*)buf, (const uint4*)slab, (uint4*)out, (const int*)recv_start,
      (const int*)recv_valid, (const int*)send_start, buf_rows, rows_in,
      rows_out, vpr);
  return (int)cudaGetLastError();
}

const char* slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
