// K9: the RG-LRU linear recurrence, for sm_90a.
// Replaces rglru_scan_kernel (src/repro/kernels/rg_lru/kernel.py:43).
//
// h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + x[b, t, d] for t = 0 .. T - 1,
// from h[b, -1, d] = h0[b, d]; returns h (B, T, D) and h_last = h[:, T - 1]
// (B, D).  fp32 in and out, contiguous, any B, T >= 1 and D.
//
// Bound: bytes.  The function reads a and x once and writes h once, 12
// bytes an element; 2 FLOPs an element are nothing against that.  The
// Pallas kernel runs its grid's chunk axis in order on one core and
// carries h from chunk to chunk in VMEM, so it moves those 12 bytes.  Here
// blocks run in parallel and in no order, and one thread per (b, d)
// channel gives only B * D sequential threads (10,240 at recurrentgemma-2b's
// prefill, B = 4, D = 2560): too few bytes in flight to fill HBM.  So the
// work is cut into tiles of kSteps steps by kChannels channels of one
// batch row, many tiles in flight at once, and the carry crosses tiles
// through device memory.
//
// chained_scan_kernel, the single pass (D % 4 == 0 and a, x, h0 16-byte
// aligned, as TMA needs; chosen by kernel.py).  It reads a and x from
// device memory once: 12 bytes an element, and 12 bytes a channel a tile
// of summaries (3 / kSteps of that).  A CTA a tile:
//  1. Thread 0 takes the tile id from a global counter (atomicAdd),
//     chunk-major: every tile of chunk c - 1 was taken before any of chunk
//     c, by a CTA that is running, so waiting on a predecessor cannot
//     deadlock (blockIdx order could: blocks start in no fixed order).
//  2. One thread of the last warp loads the tile's a and x into shared
//     memory, one TMA box each of a (D, T, B) tensor map, on one mbarrier.
//     TMA fills rows past T and channels past D with zeros and counts the
//     whole box, so the barrier expects 2 * kSteps * kChannels * 4 bytes
//     for every tile, the ragged ones included (boxes of T rows where T <
//     kSteps).
//  3. Meanwhile each channel's first thread walks back over the tiles
//     before its own in the same (b, channel group) (decoupled look-back):
//     it folds their aggregates (flag 1) until it meets an inclusive
//     prefix (flag 2), a tile's carry-out; a tile that has published
//     nothing yet is read again on the next turn.  Chunk 0's carry-in is h0.
//  4. kParts threads a channel scan kSteps / kParts steps each from shared
//     memory, from 0, and the parts give the tile's decay A = prod a and
//     end state H.  If every carry-in is known by then, the tile publishes
//     its carry-out A * carry + H (flag 2) at once; else it publishes
//     (A, H) (flag 1), finishes the walk, then publishes its carry-out.
//  5. Each thread rescans its steps from its part's carry-in and stores h;
//     the last chunk stores h_last.
// The last warp issues the loads and the flags, so no scanning thread
// waits on them.  Tiles of 256 steps by 32 channels (4 threads a channel)
// keep the chains short (12 tiles at T = 2920) and each box one 128-byte
// segment a row; 64 KB of shared memory a tile, three CTAs an SM.
// Memory order: a tile's values are stored with st.global.cg, the CTA
// synchronises, then one thread stores the flag with st.release.gpu
// (cumulative over the barrier).  A reader loads the flag with
// ld.acquire.gpu, each thread for itself, and the values behind it with
// ld.global.cg (L1 bypassed; __ldg could serve a stale line).  The flags
// and the counter are zeroed by the launcher before every launch (a memset
// of 4 * (tiles + 1) bytes on the same stream), so nothing leaks from one
// launch into the next.
//
// Within a part the sum runs in the sequential order of rglru_scan_ref;
// only the carry-in is reassociated (folded from the summaries before it).
//
// The two-pass path (D % 4 != 0, or a, x or h0 not 16-byte aligned: TMA
// needs 16-byte strides and addresses) keeps one thread per chunk of
// `chunk` steps of one channel, one float at a time:
//  1. chunk_summary_kernel: every chunk but the last scans its steps from 0
//     and stores its (A, H) (the reference's chunked form,
//     recurrent.py:84-99, with h0 = 0);
//  2. rescan_kernel: every chunk folds h0 and the summaries before it
//     into its carry-in, then scans its steps again from there, storing h;
//     the last chunk stores h_last.
// It reads a and x twice, 20 bytes an element.
//
// The launchers return cudaGetLastError() as an int (0 = launched), or
// kEncodeError + the CUresult when a tensor map cannot be built.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"
#include "tensor_map.cuh"

namespace {

// ------------------------------------------------------------ single pass

constexpr int kChannels = 32;    // a tile's channels
constexpr int kSteps = 256;      // a tile's steps
constexpr int kParts = 4;        // threads a channel, each a run of steps
constexpr int kPartSteps = kSteps / kParts;
// kChannels * kParts scanning threads and one warp more, which issues the
// loads and the flags, so that no scanning thread waits on them
constexpr int kScanThreads = kChannels * kParts;
constexpr int kChainedThreads = kScanThreads + 32;
constexpr int kTileFloats = kSteps * kChannels;
constexpr int kTileBytes = kTileFloats * 4;
// a and x of one tile (2 x 32 KB) and room to align them to 128 bytes
constexpr int kChainedSmem = 2 * kTileBytes + 128;
constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode
static_assert(kScanThreads % 32 == 0 && kSteps % kParts == 0,
              "whole warps, whole parts");

struct ChainedParams {
  CUtensorMap a_map;  // a and x as (D, T, B), in (kChannels, box_rows, 1)
  CUtensorMap x_map;  // boxes
  const float* h0;
  float* h;
  float* h_last;
  int* status;    // [0] the tile counter, [1 + tile] the tile's flag
  float2* agg;    // (tiles, kChannels): each tile's (A, H) from 0
  float* incl;    // (tiles, kChannels): each tile's carry-out
  long long T, D;
  int groups;     // channel groups, ceil(D / kChannels)
  int per_chunk;  // tiles of one chunk, B * groups
  int n_chunks;   // ceil(T / kSteps)
  int box_rows;   // the boxes' steps: kSteps, or T where T is shorter
};

// Where a tile lies: chunk c of channel group d0 / kChannels of batch row
// bb; its first element, channels and steps.
struct Tile {
  int c, width, rows;
  long long bb, d0, base;
};

__device__ __forceinline__ Tile tile_at(const ChainedParams& p, int tile) {
  Tile t;
  t.c = tile / p.per_chunk;
  const int r = tile - t.c * p.per_chunk;
  t.bb = r / p.groups;
  t.d0 = (long long)(r % p.groups) * kChannels;
  const long long t0 = (long long)t.c * kSteps;
  t.width = (int)min((long long)kChannels, p.D - t.d0);
  t.rows = (int)min((long long)kSteps, p.T - t0);
  t.base = (t.bb * p.T + t0) * p.D + t.d0;
  return t;
}

__device__ __forceinline__ void flag_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int flag_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A box of a (D, T, B) tensor map into shared memory at dst, completing on
// bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          bulk::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bulk::smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Flag the tile once every thread has stored its value: the CTA barrier
// orders their stores before the release of the last warp's first thread,
// which is cumulative.
__device__ __forceinline__ void publish(int* flag, int v) {
  __syncthreads();
  if (threadIdx.x == kScanThreads) flag_release(flag, v);
}

// A channel's walk back over the tiles before its own in the same (batch
// row, channel group): the fold of the tiles passed (x -> fa x + fh), the
// next tile to read, and the carry-in once an inclusive prefix is met.
struct LookBack {
  float fa, fh, carry;
  long long k;
  bool done;
};

// One step of the walk for channel i; false if tile k has published
// nothing yet.
__device__ __forceinline__ bool step(const ChainedParams& p, LookBack& w,
                                     int i) {
  const int f = flag_acquire(p.status + 1 + w.k);
  if (f == 0) return false;
  const long long ks = w.k * kChannels + i;
  if (f == 2) {
    w.carry = w.fa * __ldcg(p.incl + ks) + w.fh;
    w.done = true;
  } else {
    const float2 v = __ldcg(p.agg + ks);
    w.fh = w.fa * v.y + w.fh;
    w.fa *= v.x;
    w.k -= p.per_chunk;  // chunk 0 always ends with flag 2: k stays >= 0
  }
  return true;
}

__global__ void __launch_bounds__(kChainedThreads)
    chained_scan_kernel(const __grid_constant__ ChainedParams p) {
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t bar;
  __shared__ int tile_id;
  __shared__ float2 parts[kParts][kChannels];  // each part's (A, H)
  __shared__ float carry[kChannels];           // each channel's carry-in
  float* const sa = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem) + 127) & ~uintptr_t(127));
  float* const sx = sa + kTileFloats;
  const int i = threadIdx.x;
  if (i == 0) {
    tile_id = atomicAdd(p.status, 1);
    bulk::mbar_init(&bar, 1);
    bulk::mbar_fence_init();
  }
  __syncthreads();
  const int tile = tile_id;
  const Tile t = tile_at(p, tile);
  if (i == kScanThreads) {  // the last warp starts the loads: a box each,
    // whole (kChannels x box_rows), zeros past D and T
    bulk::mbar_expect_tx(&bar, 2u * kChannels * p.box_rows * 4u);
    tma_load(sa, &p.a_map, &bar, (int)t.d0, t.c * kSteps, (int)t.bb);
    tma_load(sx, &p.x_map, &bar, (int)t.d0, t.c * kSteps, (int)t.bb);
  }

  // thread i scans channel ch over steps [s0, s1) of the tile; the threads
  // of part 0 walk back for their channel
  const int ch = i % kChannels, part = i / kChannels;
  const bool live = i < kScanThreads && ch < t.width;
  const bool walker = live && part == 0;
  const int s0 = min(part * kPartSteps, t.rows);
  const int s1 = min(s0 + kPartSteps, t.rows);
  LookBack w{1.f, 0.f, 0.f, tile - p.per_chunk, t.c == 0};
  if (t.c == 0 && walker) w.carry = p.h0[t.bb * p.D + t.d0 + ch];
  // walk back while the tile's a and x land
  while (!bulk::mbar_test(&bar, 0))
    if (walker && !w.done) step(p, w, ch);

  float A = 1.f, H = 0.f;
  if (live) {
#pragma unroll 8
    for (int s = s0; s < s1; ++s) {
      const float av = sa[s * kChannels + ch];
      H = av * H + sx[s * kChannels + ch];
      A *= av;
    }
  }
  // the tile's (A, H): the parts in order
  if (live) parts[part][ch] = make_float2(A, H);
  __syncthreads();
  if (walker)
    for (int q = 1; q < kParts; ++q) {
      const float2 v = parts[q][ch];
      H = v.x * H + v.y;
      A *= v.x;
    }
  const long long slot = (long long)tile * kChannels + ch;
  if (!__syncthreads_and(w.done || !walker)) {
    // a carry-in is still open: publish the aggregate, finish the walk
    if (walker) __stcg(p.agg + slot, make_float2(A, H));
    publish(p.status + 1 + tile, 1);
    if (walker)
      while (!w.done) step(p, w, ch);
  }
  if (t.c + 1 < p.n_chunks) {
    if (walker) __stcg(p.incl + slot, A * w.carry + H);
    publish(p.status + 1 + tile, 2);
  }
  // each part's carry-in: the tile's, through the parts before it
  if (walker) carry[ch] = w.carry;
  __syncthreads();
  if (live) {
    float hv = carry[ch];
    for (int q = 0; q < part; ++q) {
      const float2 v = parts[q][ch];
      hv = v.x * hv + v.y;
    }
    float* out = p.h + t.base + ch;
#pragma unroll 8
    for (int s = s0; s < s1; ++s) {
      hv = sa[s * kChannels + ch] * hv + sx[s * kChannels + ch];
      out[s * p.D] = hv;
    }
    if (t.c + 1 == p.n_chunks && s1 == t.rows && s0 < s1)
      p.h_last[t.bb * p.D + t.d0 + ch] = hv;
  }
}

// Dynamic shared memory above 48 KB, allowed once a device.
cudaError_t allow_chained_smem() {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(chained_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kChainedSmem);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

long long chained_tiles(long long B, long long T, long long D) {
  return B * ((D + kChannels - 1) / kChannels) * ((T + kSteps - 1) / kSteps);
}

bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
}

// An fp32 (D, T, B) map of a contiguous tensor, read in (kChannels, rows,
// 1) boxes, zeros past its ends.  0 or kEncodeError + the CUresult.
int encode(CUtensorMap* map, const float* ptr, long long B, long long T,
           long long D, int rows) {
  tmap::EncodeTiled fn = tmap::encoder();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(D * 4),
                                 (cuuint64_t)(T * D * 4)};
  const cuuint32_t box[3] = {kChannels, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// --------------------------------------------------------------- two pass

constexpr int kThreads = 128;

struct Params {
  const float* a;
  const float* x;
  const float* h0;
  float* h;
  float* h_last;
  float* sum_a;  // (B, n_chunks - 1, D): each chunk's prod of a
  float* sum_h;  // (B, n_chunks - 1, D): each chunk's end state from 0
  long long T, D;
  int chunk, n_chunks, d_blocks;
};

// This thread's batch row and channel; false past the last channel.
__device__ __forceinline__ bool channel(const Params& p, long long* bb,
                                        long long* d) {
  *bb = blockIdx.x / p.d_blocks;
  *d = (long long)(blockIdx.x % p.d_blocks) * kThreads + threadIdx.x;
  return *d < p.D;
}

__global__ void __launch_bounds__(kThreads)
    chunk_summary_kernel(const Params p) {
  long long bb, d;
  if (!channel(p, &bb, &d)) return;
  const int c = blockIdx.y;
  const long long t0 = (long long)c * p.chunk;
  const long long t1 = t0 + p.chunk;  // never the last (partial) chunk
  float A = 1.f, H = 0.f;
  const long long row = bb * p.T;
#pragma unroll 4
  for (long long t = t0; t < t1; ++t) {
    const long long off = (row + t) * p.D + d;
    const float av = __ldg(p.a + off);
    H = av * H + __ldg(p.x + off);
    A *= av;
  }
  const long long s = (bb * (p.n_chunks - 1) + c) * p.D + d;
  p.sum_a[s] = A;
  p.sum_h[s] = H;
}

__global__ void __launch_bounds__(kThreads) rescan_kernel(const Params p) {
  long long bb, d;
  if (!channel(p, &bb, &d)) return;
  const int c = blockIdx.y;
  float H = __ldg(p.h0 + bb * p.D + d);
  const long long srow = bb * (p.n_chunks - 1) * p.D + d;
#pragma unroll 4
  for (int k = 0; k < c; ++k)
    H = __ldg(p.sum_a + srow + k * p.D) * H + __ldg(p.sum_h + srow + k * p.D);
  const long long t0 = (long long)c * p.chunk;
  const long long t1 = t0 + p.chunk < p.T ? t0 + p.chunk : p.T;
  const long long row = bb * p.T;
#pragma unroll 4
  for (long long t = t0; t < t1; ++t) {
    const long long off = (row + t) * p.D + d;
    H = __ldg(p.a + off) * H + __ldg(p.x + off);
    p.h[off] = H;
  }
  if (c == p.n_chunks - 1) p.h_last[bb * p.D + d] = H;
}

}  // namespace

extern "C" {

// Bytes of the single pass's workspace for a (B, T, D) scan: the flags and
// counter, then the tiles' summaries.
long long rglru_chained_workspace_bytes(long long B, long long T,
                                        long long D) {
  const long long tiles = chained_tiles(B, T, D);
  return ((tiles + 1) * 4 + 15) / 16 * 16 + tiles * kChannels * 12;
}

// The single pass.  a, x, h: (B, T, D); h0, h_last: (B, D); workspace of
// rglru_chained_workspace_bytes(B, T, D) bytes, 16-byte aligned (its
// flags are zeroed here, on the stream).  Needs B, T, D >= 1, D % 4 == 0
// and every pointer 16-byte aligned.
int rglru_chained_scan_launch(const float* a, const float* x,
                              const float* h0, float* h, float* h_last,
                              void* workspace, long long B, long long T,
                              long long D, void* stream) {
  if (B < 1 || T < 1 || D < 1 || D % 4 != 0 || !aligned16(a) ||
      !aligned16(x) || !aligned16(h0) || !aligned16(h) ||
      !aligned16(h_last) || !aligned16(workspace))
    return (int)cudaErrorInvalidValue;
  const long long tiles = chained_tiles(B, T, D);
  const long long groups = (D + kChannels - 1) / kChannels;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long status_bytes = ((tiles + 1) * 4 + 15) / 16 * 16;
  char* w = static_cast<char*>(workspace);
  float2* agg = reinterpret_cast<float2*>(w + status_bytes);
  ChainedParams p{{},
                  {},
                  h0,
                  h,
                  h_last,
                  reinterpret_cast<int*>(w),
                  agg,
                  reinterpret_cast<float*>(agg + tiles * kChannels),
                  T,
                  D,
                  (int)groups,
                  (int)(B * groups),
                  (int)((T + kSteps - 1) / kSteps),
                  (int)(T < kSteps ? T : kSteps)};
  int err = encode(&p.a_map, a, B, T, D, p.box_rows);
  if (err == 0) err = encode(&p.x_map, x, B, T, D, p.box_rows);
  if (err != 0) return err;
  cudaError_t e = allow_chained_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(workspace, 0, (size_t)status_bytes, st);
  if (e != cudaSuccess) return (int)e;
  chained_scan_kernel<<<(unsigned)tiles, kChainedThreads, kChainedSmem,
                        st>>>(p);
  return (int)cudaGetLastError();
}

// The two-pass scan.  a, x, h: (B, T, D); h0, h_last: (B, D); scratch:
// 2 * B * (n_chunks - 1) * D floats, n_chunks = ceil(T / chunk).  Needs
// B, D >= 1, T >= 1.
int rglru_scan_launch(const float* a, const float* x, const float* h0,
                      float* h, float* h_last, float* scratch, long long B,
                      long long T, long long D, int chunk, void* stream) {
  if (B < 1 || T < 1 || D < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (T + chunk - 1) / chunk;
  const long long d_blocks = (D + kThreads - 1) / kThreads;
  if (n_chunks > 65535 || B * d_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Params p{a, x, h0, h, h_last, scratch, scratch + B * (n_chunks - 1) * D,
           T, D, chunk, (int)n_chunks, (int)d_blocks};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)(B * d_blocks), (unsigned)n_chunks, 1);
  if (n_chunks > 1) {
    chunk_summary_kernel<<<dim3(grid.x, grid.y - 1, 1), kThreads, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rescan_kernel<<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

const char* rglru_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
