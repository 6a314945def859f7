// K9: the RG-LRU linear recurrence (a chunked scan), for sm_90a.
// Replaces rglru_scan_kernel (src/repro/kernels/rg_lru/kernel.py:43).
//
// h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + x[b, t, d] for t = 0 .. T - 1,
// from h[b, -1, d] = h0[b, d]; returns h (B, T, D) and h_last = h[:, T - 1]
// (B, D).  fp32 in and out, contiguous, any B, T >= 1 and D.
//
// The Pallas kernel runs its grid's chunk axis in order on one core and
// carries h from one chunk to the next in VMEM.  Here blocks run in
// parallel and in no order, and one thread per (b, d) channel gives only
// B * D sequential threads (10,240 at recurrentgemma-2b's prefill, B = 4,
// D = 2560): too few loads in flight to fill HBM.  So T is cut into chunks
// of `chunk` steps, each chunk of each channel a thread of its own, in two
// passes:
//  1. chunk_summary_kernel: every chunk but the last scans its steps from
//     0 and stores its end state H_c and its decay A_c = prod a (the
//     reference's chunked form, recurrent.py:84-99, with h0 = 0);
//  2. rescan_kernel: every chunk takes its carry-in from h0 and the
//     summaries of the chunks before it (h_in(c + 1) = A_c h_in(c) + H_c),
//     then scans its steps again from there in order, storing h; the last
//     chunk stores h_last.
// Within a chunk the sum runs in the sequential order of rglru_scan_ref;
// only the carry-in is reassociated.
//
// Bound: bytes.  The function reads a and x once and writes h once, 12
// bytes an element; 2 FLOPs an element are nothing against that.  This
// design reads a and x twice (20 bytes an element, the summaries are
// 2 / chunk of that), so it can reach about 60 % of the bound at best.
// Loads are 16 bytes a thread (four channels, float4) where D % 4 == 0 and
// every pointer is 16-byte aligned, one float otherwise; neighbouring
// threads take neighbouring channels, so a warp reads 512 contiguous bytes
// of a row per step.
//
// The launcher returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// This thread's batch row and first channel; false past the last channel.
template <int V>
__device__ __forceinline__ bool channel(const Params& p, long long* bb,
                                        long long* d0) {
  *bb = blockIdx.x / p.d_blocks;
  const long long g =
      (long long)(blockIdx.x % p.d_blocks) * kThreads + threadIdx.x;
  *d0 = g * V;
  return *d0 < p.D;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    chunk_summary_kernel(const Params p) {
  long long bb, d0;
  if (!channel<V>(p, &bb, &d0)) return;
  const int c = blockIdx.y;
  const long long t0 = (long long)c * p.chunk;
  const long long t1 = t0 + p.chunk;  // never the last (partial) chunk
  float A[V], H[V], av[V], xv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    A[i] = 1.f;
    H[i] = 0.f;
  }
  const long long row = bb * p.T;
#pragma unroll 4
  for (long long t = t0; t < t1; ++t) {
    const long long off = (row + t) * p.D + d0;
    load<V>(p.a + off, av);
    load<V>(p.x + off, xv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      H[i] = av[i] * H[i] + xv[i];
      A[i] *= av[i];
    }
  }
  const long long s = (bb * (p.n_chunks - 1) + c) * p.D + d0;
  store<V>(p.sum_a + s, A);
  store<V>(p.sum_h + s, H);
}

template <int V>
__global__ void __launch_bounds__(kThreads) rescan_kernel(const Params p) {
  long long bb, d0;
  if (!channel<V>(p, &bb, &d0)) return;
  const int c = blockIdx.y;
  float H[V], av[V], xv[V];
  load<V>(p.h0 + bb * p.D + d0, H);
  const long long srow = bb * (p.n_chunks - 1) * p.D + d0;
#pragma unroll 4
  for (int k = 0; k < c; ++k) {
    load<V>(p.sum_a + srow + k * p.D, av);
    load<V>(p.sum_h + srow + k * p.D, xv);
#pragma unroll
    for (int i = 0; i < V; ++i) H[i] = av[i] * H[i] + xv[i];
  }
  const long long t0 = (long long)c * p.chunk;
  const long long t1 = t0 + p.chunk < p.T ? t0 + p.chunk : p.T;
  const long long row = bb * p.T;
#pragma unroll 4
  for (long long t = t0; t < t1; ++t) {
    const long long off = (row + t) * p.D + d0;
    load<V>(p.a + off, av);
    load<V>(p.x + off, xv);
#pragma unroll
    for (int i = 0; i < V; ++i) H[i] = av[i] * H[i] + xv[i];
    store<V>(p.h + off, H);
  }
  if (c == p.n_chunks - 1) store<V>(p.h_last + bb * p.D + d0, H);
}

template <int V>
int launch(Params p, long long B, cudaStream_t stream) {
  const long long groups = (p.D + V - 1) / V;
  p.d_blocks = (int)((groups + kThreads - 1) / kThreads);
  const long long bx = B * p.d_blocks;
  if (bx > 0x7fffffffLL || p.n_chunks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (p.n_chunks > 1) {
    chunk_summary_kernel<V>
        <<<dim3((unsigned)bx, p.n_chunks - 1, 1), kThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rescan_kernel<V><<<dim3((unsigned)bx, p.n_chunks, 1), kThreads, 0, stream>>>(
      p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
}

}  // namespace

extern "C" {

// a, x, h: (B, T, D); h0, h_last: (B, D); scratch: 2 * B * (n_chunks - 1)
// * D floats, n_chunks = ceil(T / chunk).  Needs B, D >= 1, T >= 1.
int rglru_scan_launch(const float* a, const float* x, const float* h0,
                      float* h, float* h_last, float* scratch, long long B,
                      long long T, long long D, int chunk, void* stream) {
  if (B < 1 || T < 1 || D < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (T + chunk - 1) / chunk;
  if (n_chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  float* sum_h = scratch + B * (n_chunks - 1) * D;
  Params p{a, x, h0, h, h_last, scratch, sum_h, T, D, chunk, (int)n_chunks,
           0};
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = D % 4 == 0 && aligned16(a) && aligned16(x) &&
                   aligned16(h0) && aligned16(h) && aligned16(h_last) &&
                   aligned16(scratch) && aligned16(sum_h);
  return vec ? launch<4>(p, B, st) : launch<1>(p, B, st);
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
