// K8: blocked online-softmax attention (flash attention, forward), for
// sm_90a.  Replaces flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:78).
//
// o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / group, j] / sqrt(hd))
//              v[b, h / group, j]
// over the keys j that the masks leave visible: j < S, j <= i when causal,
// j > i - window with a window.  q (B, H, T, hd), k/v (B, Hkv, S, hd),
// o like q; any strides whose last one is 1 and whose rows start on 16
// bytes, so the model hands over its (B, T, H, hd) tensors as views with
// no transpose.  GQA maps q head h to kv head h / group, with no broadcast
// of k or v materialised.  Any T and S: the ragged last blocks are masked.
//
// The Pallas grid (B*H, q blocks, kv blocks) runs its kv axis in order and
// keeps (m, l, acc) in VMEM scratch from one kv step to the next.  Here
// one CTA owns one (b*h, q block) pair and a loop over kv blocks takes the
// place of that axis, with the running max m, the running sum l and the
// fp32 accumulator acc in registers.  The loop runs only over the kv blocks
// that the causal and window masks leave visible: the Pallas pl.when(run)
// skip (kernel.py:39-46), done as loop bounds.  Masking is an explicit
// select with NEG_INF = -1e30 and p = 0 where masked, and the final sum is
// floored at 1e-30 (kernel.py:60-74), so a row that sees no key gives 0.
//
// Bound: 4 * hd FLOPs per visible (q, k) pair per head on the tensor
// cores (989 TFLOP/s in bf16).  A prefill at T = 2048, hd = 128 is
// compute-bound: q, k, v and o move over HBM in about a third of that
// time.  So the bf16 kernel at hd 64, 128 and 256 is built
// to keep the tensor cores fed:
//  * TMA loads into rings.  One producer thread loads the CTA's q tile
//    once, then each kv block's k tile and v tile into two-stage rings of
//    their own, each stage with a full and an empty mbarrier, so the next
//    tiles load while the current ones are multiplied.  The
//    tensor maps are 4-d, (hd, rows, heads, batch) with the caller's
//    strides, built on every launch and passed as __grid_constant__
//    parameters; the encoder is looked up through the runtime, so the
//    library needs no -lcuda.  TMA fills rows past T or S with zeros and
//    the masks still decide what is visible.
//  * wgmma for both products.  Two consumer warpgroups own 64 query rows
//    each (BM = 128).  s = q k^T takes q and k from shared memory (both
//    K-major); o += p v takes p from registers (the score accumulator's
//    layout is the A fragment's) and v from shared memory with the B
//    transpose flag, so v is never gathered or transposed by hand.  Tiles
//    are 64 columns (128 bytes) wide with the 128-byte swizzle that TMA
//    writes and wgmma reads; an hd 128 or 256 tile is two or four of them.
//    setmaxnreg gives the producer warpgroup's registers to the consumers.
//    The kv block is 128 keys at hd <= 128 and 64 at hd 256, where the
//    64 x 256 fp32 accumulator already takes 128 registers a thread.
//  * The two products overlap inside a warpgroup: block n's scores go
//    out with block n - 1's p v, and block n's softmax runs while p v is
//    on the tensor cores; the two warpgroups overlap each other as well.
//  * Masks only on edge blocks: the causal diagonal, the window's lower
//    edge and the ragged block past S are masked; every other block runs
//    without a compare.  The scale log2(e) / sqrt(hd) is folded
//    into one multiply-add before exp2, and the running max is kept in
//    that scaled base-2 domain.
//  * The heaviest q blocks first: under a causal mask a q block's work
//    grows with its index, so grid x walks q blocks from the last to the
//    first, with batch * head fastest (B * H > 65535 runs: grid x takes
//    2^31 - 1 blocks).
//  * o is written into the warpgroup's own q tile in shared memory and
//    stored by TMA, which clips the rows past T.
// The scores leave the product in fp32 (scaling q in fp32 first, as
// kernel.py:48 does, gives the same value without rounding a scaled q to
// bf16); p is rounded to bf16 for the second product, as the JAX model's
// _sdpa casts it to v's dtype; l sums the unrounded p.
//
// Dispatch by shape, not a fallback: hd 16, 32 and 80 run the first design
// of this kernel (mma.sync m16n8k16, four warps, 64 query rows a CTA,
// synchronous loads).  80 is stablelm-3b's head dim: the wgmma tiles are
// 64-column, 128-byte swizzled chunks, which 80 columns do not fill, while
// the mma.sync tile takes any multiple of 16 (5 k-steps and 10 16-byte
// vectors a row at 80).  fp32 runs
// plain fp32 FMAs (TF32 would miss the 2e-5 that fp32 is held to), q
// scaled by 1/sqrt(hd) in fp32 as it is loaded, 32 query rows a CTA.
//
// The launcher returns cudaGetLastError() as an int (0 = launched), or
// kEncodeError + the CUresult when a tensor map cannot be built.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_map.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // kernel.py NEG_INF
constexpr float kMinL = 1e-30f;    // kernel.py:74, the floor of the sum
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;      // the mma.sync and fp32 kernels
constexpr int kEncodeError = 10000;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, group, T, S;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int causal;
  int window;  // <= 0: no window
  float scale;
  int q_blocks;  // q blocks a (batch, head); set by the launcher
};

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  if (j >= p.S) return false;
  if (p.causal && j > i) return false;
  if (p.window > 0 && j <= i - p.window) return false;
  return true;
}

// The kv blocks [lo, hi) of width bn that hold a key visible to some query
// row of [q0, q1): causal keeps j <= q1 - 1, a window keeps
// j >= q0 - window + 1.
__device__ __forceinline__ void kv_blocks(int S, int causal, int window,
                                          int q0, int q1, int bn, int* lo,
                                          int* hi) {
  int klo = 0, khi = S;
  if (causal) khi = min(khi, q1);
  if (window > 0) klo = max(0, q0 - window + 1);
  *lo = klo / bn;
  *hi = khi > klo ? (khi + bn - 1) / bn : *lo;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats as bf16 in one register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two bf16 from shared memory in one register, the first in the low half.
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

template <int HD>
struct Bf16Tile {
  static constexpr int BM = 64;                  // query rows a CTA
  static constexpr int BN = 64;                  // keys a kv block
  static constexpr int LD = HD + 8;  // row stride in shared memory: rows
                                     // stay 16-byte aligned, and the 8
                                     // rows of a fragment fall in 8
                                     // distinct groups of 4 banks
  static constexpr int kSmem = (BM + 2 * BN) * LD * 2;
};

// The mma.sync kernel of hd 16, 32 and 80: warp w holds query rows
// [q0 + 16 w, q0 + 16 w + 16); in the mma
// layouts a thread (g = lane / 4, t = lane % 4) holds rows g and g + 8 of
// that slab and columns 2t, 2t + 1 of each 8-wide tile.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params p) {
  using Tile = Bf16Tile<HD>;
  constexpr int BM = Tile::BM, BN = Tile::BN, LD = Tile::LD;
  constexpr int C8 = HD / 8;  // 16-byte vectors a row
  extern __shared__ uint4 smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qb = (int)(blockIdx.x % p.q_blocks);
  const int bh = (int)(blockIdx.x / p.q_blocks), b = bh / p.H, h = bh % p.H,
            hk = h / p.group;
  const int q0 = qb * BM, q1 = min(q0 + BM, p.T);
  const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = reinterpret_cast<const __nv_bfloat16*>(p.k) +
                           b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(p.v) +
                           b * p.v_sb + hk * p.v_sh;

  for (int e = tid; e < BM * C8; e += kThreads) {
    const int r = e / C8, c = e % C8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.T)
      x = *reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * p.q_st +
                                          8 * c);
    *reinterpret_cast<uint4*>(Qs + r * LD + 8 * c) = x;
  }

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int lo, hi;
  kv_blocks(p.S, p.causal, p.window, q0, q1, BN, &lo, &hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous tiles are used up; Qs is written
    for (int e = tid; e < BN * C8; e += kThreads) {
      const int r = e / C8, c = e % C8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.S) {
        kx = *reinterpret_cast<const uint4*>(
            k + (long long)(k0 + r) * p.k_st + 8 * c);
        vx = *reinterpret_cast<const uint4*>(
            v + (long long)(k0 + r) * p.v_st + 8 * c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + 8 * c) = kx;
      *reinterpret_cast<uint4*>(Vs + r * LD + 8 * c) = vx;
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the block's BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * LD + kk * 16 + 2 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // scale and mask in fp32, then the online softmax
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + n * 8 + 2 * t + e;
        s[n][e] = visible(p, row0, col) ? s[n][e] * p.scale : kNegInf;
        s[n][2 + e] = visible(p, row1, col) ? s[n][2 + e] * p.scale : kNegInf;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + n * 8 + 2 * t + e;
        s[n][e] = visible(p, row0, col) ? expf(s[n][e] - mn0) : 0.f;
        s[n][2 + e] = visible(p, row1, col) ? expf(s[n][2 + e] - mn1) : 0.f;
        sum0 += s[n][e];
        sum1 += s[n][2 + e];
      }
    }
    // each thread keeps its own columns' part of l; alpha is the row's
    // own, so the parts add up to l at the end
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += p v: the score tiles' accumulator layout is the A layout of
    // the second product, two 8-key tiles to one 16-key step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vn = vp + n * 8;
        mma_bf16(acc[n], a0, a1, a2, a3, pair_bf16(vn, vn + LD),
                 pair_bf16(vn + 8 * LD, vn + 9 * LD));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, kMinL), d1 = fmaxf(l1, kMinL);
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                     h * p.o_sh;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < p.T)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)row0 * p.o_st + col) =
          __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < p.T)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)row1 * p.o_st + col) =
          __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
  }
}

// ---------------------------------------------------------------- Hopper
// The bf16 kernel of hd 64, 128 and 256: TMA, mbarriers, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also announces the bytes the TMA loads will bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A (64 columns, rows) box of a 4-d tensor map into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a tile stored as 128-byte rows with
// the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO); lbo is the
// step between 64-column chunks, read only for MN-major (transposed)
// operands.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)

// d (64 x 64, fp32) {=, +=} a (64 x 16, K-major smem) b (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D16(0), D16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) {=, +=} a (64 x 16, K-major smem) b (16 x 128, K-major smem)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D16(0), D16(16), D16(32), D16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += a (64 x 16, registers) b (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D16(0), D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += a (64 x 16, registers) b (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D16(0), D16(16), D16(32), D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += a (64 x 16, registers) b (16 x 256, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : D16(0), D16(16), D16(32), D16(48), D16(64), D16(80), D16(96), D16(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D16
#undef D4

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

struct WgParams {
  int H, group, T, S;
  int bh;        // B * H
  int q_blocks;  // q blocks a (batch, head)
  int causal;
  int window;    // <= 0: no window
  float scale_log2;  // log2(e) / sqrt(hd)
};

template <int HD>
struct WgTile {
  static constexpr int BM = 128;                  // two warpgroups of 64
  static constexpr int BN = HD >= 256 ? 64 : 128; // keys a kv block
  static constexpr int STAGES = 2;                // depth of each ring
  static constexpr int CH = HD / 64;              // 128-byte chunks a row
  static constexpr int CHUNK = 64 * 128;          // a q chunk of 64 rows
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;    // one k or v tile
  static constexpr int kBars = 1 + 4 * STAGES;    // q; k, v full, empty
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte
  // pattern, then q, the k ring, the v ring and the barriers
  static constexpr int kSmem =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * kBars;
  static constexpr int kThreadsWg = 384;  // producer + two consumers
};

// The online-softmax step of one kv block for a thread's two rows (A and
// B, 8 apart): s holds the raw scores q.k of BN keys in the accumulator
// layout and leaves as p = exp2(s * scale_log2 - m).  On an edge block the
// keys outside [jlo, jhi) of each row are masked first.  al0 and al1 are
// the factors by which the old acc and l shrink.
template <int BN, bool EDGE>
__device__ __forceinline__ void softmax_block(float (&s)[BN / 2], float& m0,
                                              float& m1, float& l0,
                                              float& l1, float& al0,
                                              float& al1, float sl2, int c0,
                                              int jlo0, int jhi0, int jlo1,
                                              int jhi1) {
  if (EDGE) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + e;
        if (col < jlo0 || col >= jhi0) s[4 * n + e] = kNegInf;
        if (col < jlo1 || col >= jhi1) s[4 * n + 2 + e] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // the scale is positive, so the max commutes with it
  const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
  al0 = ex2(m0 - mn0);
  al1 = ex2(m1 - mn1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p0 = ex2(fmaf(s[4 * n + e], sl2, -mn0));
      float p1 = ex2(fmaf(s[4 * n + 2 + e], sl2, -mn1));
      if (EDGE) {
        if (s[4 * n + e] == kNegInf) p0 = 0.f;
        if (s[4 * n + 2 + e] == kNegInf) p1 = 0.f;
      }
      s[4 * n + e] = p0;
      s[4 * n + 2 + e] = p1;
      sum0 += p0;
      sum1 += p1;
    }
  }
  // each thread keeps its own columns' part of l; alpha is the row's own,
  // so the parts add up to l at the end
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
  m0 = mn0;
  m1 = mn1;
}

// Thread roles: warpgroup 0 is the producer (one thread issues every TMA
// load), warpgroups 1 and 2 the consumers of q rows [q0, q0 + 64) and
// [q0 + 64, q0 + 128).  In the wgmma layouts warp w of a consumer holds
// rows 16 w .. 16 w + 15 of its 64; a thread (g = lane / 4, t = lane % 4)
// holds rows g and g + 8 of those and columns 2t, 2t + 1 of each 8-wide
// tile.  Shared memory, each tile in 64-column chunks of 128-byte rows:
// q [consumer][chunk][64 rows], k and v [stage][chunk][BN rows].
//
// A consumer overlaps its two products: with block n's s = q k^T it issues
// block n - 1's o += p v, waits for the scores alone, and runs block n's
// softmax while p v is still on the tensor cores; then it waits for p v
// and rescales o by block n's alpha.  So k and v have rings (and
// barriers) of their own: a k tile is released once its scores are out,
// a v tile once its product is.  No branch stands around a product (ptxas
// would serialise them), so a block that no row of a warpgroup sees is
// computed and masked like any edge block.
template <int HD>
__global__ void __launch_bounds__(WgTile<HD>::kThreadsWg, 1)
    flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to,
                         const WgParams p) {
  using Tile = WgTile<HD>;
  constexpr int BM = Tile::BM, BN = Tile::BN, ST = Tile::STAGES;
  constexpr int CH = Tile::CH, CHUNK = Tile::CHUNK;
  constexpr int KV_BYTES = Tile::KV_BYTES;
  extern __shared__ uint8_t smem_wg[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_wg) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = Qs + Tile::Q_BYTES;
  uint8_t* Vs = Ks + ST * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int qb = p.q_blocks - 1 - (int)(blockIdx.x / (unsigned)p.bh);
  const int bh = (int)(blockIdx.x % (unsigned)p.bh), b = bh / p.H,
            h = bh % p.H, hk = h / p.group;
  const int q0 = qb * BM, q1 = min(q0 + BM, p.T);
  int lo, hi;
  kv_blocks(p.S, p.causal, p.window, q0, q1, BN, &lo, &hi);
  const int nblk = hi - lo;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival a consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, Tile::Q_BYTES);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(Qs + (w * CH + c) * CHUNK, &tq, q_full, 64 * c,
                   q0 + 64 * w, h, b);
      for (int n = 0; n < nblk; ++n) {
        const int s = n % ST, k0 = (hi - 1 - n) * BN;
        const uint32_t ph = ((n / ST) & 1) ^ 1;
        uint8_t* kd = Ks + s * KV_BYTES;
        uint8_t* vd = Vs + s * KV_BYTES;
        mbar_wait(&k_empty[s], ph);
        mbar_expect_tx(&k_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(kd + c * BN * 128, &tk, &k_full[s], 64 * c, k0, hk, b);
        mbar_wait(&v_empty[s], ph);
        mbar_expect_tx(&v_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(vd + c * BN * 128, &tv, &v_full[s], 64 * c, k0, hk, b);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // the warpgroup index through a shuffle: the compiler then knows it
    // is warp-uniform and computes the descriptors in uniform registers
    const int cw = __shfl_sync(0xffffffffu, wg - 1, 0);
    const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * cw;  // this warpgroup's first row
    const int row0 = r0 + 16 * warp + g, row1 = row0 + 8;
    // the keys [jlo, jhi) that each of the thread's rows sees
    const int jhi0 = p.causal ? min(p.S, row0 + 1) : p.S;
    const int jhi1 = p.causal ? min(p.S, row1 + 1) : p.S;
    const int jlo0 = p.window > 0 ? row0 - p.window + 1 : 0;
    const int jlo1 = p.window > 0 ? row1 - p.window + 1 : 0;
    uint8_t* Qw = Qs + cw * CH * CHUNK;
    // descriptors of the tiles' first bytes; an offset of b bytes adds
    // b / 16 to the address field
    const uint64_t dq = sw128_desc(smem_u32(Qw), 16),
                   dk = sw128_desc(smem_u32(Ks), 16),
                   dv = sw128_desc(smem_u32(Vs), BN * 128);
    const float sl2 = p.scale_log2;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    // p of the previous block, kept in fp32 and packed into fresh bf16 A
    // fragments just before its product: fragments carried from one
    // iteration to the next make ptxas serialise every product
    float pf[BN / 2];

    // sc = q k^T of the block in stage st (issued, not waited for); like
    // the p fragments, sc is a fresh array each block
    auto issue_scores = [&](float (&sc)[BN / 2], int st) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BN>(sc, dq + ((kk >> 2) * CHUNK + (kk & 3) * 32) / 16,
                     dk + (st * KV_BYTES + (kk >> 2) * BN * 128 +
                           (kk & 3) * 32) / 16,
                     kk > 0);
      wgmma_commit();
    };
    // acc += pa v of the block in stage st (issued, not waited for)
    auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], int st) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<HD>(acc, pa[kk], dv + (st * KV_BYTES + kk * 16 * 128) / 16);
      wgmma_commit();
    };
    // block n's softmax over sc, its p into pf
    auto softmax = [&](float (&sc)[BN / 2], int n, float& al0, float& al1) {
      const int k0 = (hi - 1 - n) * BN;
      // some row of this warpgroup does not see every key of the block
      const bool edge = k0 + BN > p.S || (p.causal && k0 + BN - 1 > r0) ||
                        (p.window > 0 && k0 < r0 + 64 - p.window);
      if (edge)
        softmax_block<BN, true>(sc, m0, m1, l0, l1, al0, al1, sl2,
                                k0 + 2 * t, jlo0, jhi0, jlo1, jhi1);
      else
        softmax_block<BN, false>(sc, m0, m1, l0, l1, al0, al1, sl2,
                                 k0 + 2 * t, jlo0, jhi0, jlo1, jhi1);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pf[i] = sc[i];
    };
    // pf in bf16: the accumulator layout of two 8-key tiles is the A
    // fragment of one 16-key step
    auto pack = [&](uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(pf[8 * kk], pf[8 * kk + 1]);
        pa[kk][1] = pack_bf16(pf[8 * kk + 2], pf[8 * kk + 3]);
        pa[kk][2] = pack_bf16(pf[8 * kk + 4], pf[8 * kk + 5]);
        pa[kk][3] = pack_bf16(pf[8 * kk + 6], pf[8 * kk + 7]);
      }
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(q_full, 0);
    if (nblk > 0) {
      float al0, al1;
      {
        float sc[BN / 2];
        mbar_wait(&k_full[0], 0);
        wgmma_fence();
        issue_scores(sc, 0);
        wgmma_wait<0>();
        fence_regs(sc);
        release(&k_empty[0]);
        softmax(sc, 0, al0, al1);  // acc is 0: nothing to rescale
      }
      for (int n = 1; n < nblk; ++n) {
        // block n's scores and block n - 1's p v go out together; the
        // softmax of n runs while p v of n - 1 is on the tensor cores
        const int s = n % ST, sp = (n - 1) % ST;
        float sc[BN / 2];
        uint32_t pa[BN / 16][4];
        pack(pa);
        mbar_wait(&k_full[s], (n / ST) & 1);
        wgmma_fence();
        issue_scores(sc, s);
        mbar_wait(&v_full[sp], ((n - 1) / ST) & 1);
        wgmma_fence();
        issue_pv(pa, sp);
        wgmma_wait<1>();  // the scores are out; p v may still run
        fence_regs(sc);
        release(&k_empty[s]);
        softmax(sc, n, al0, al1);
        wgmma_wait<0>();  // p v of block n - 1 is in acc
        fence_regs(acc);
        release(&v_empty[sp]);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          acc[4 * i] *= al0;
          acc[4 * i + 1] *= al0;
          acc[4 * i + 2] *= al1;
          acc[4 * i + 3] *= al1;
        }
      }
      const int sp = (nblk - 1) % ST;
      mbar_wait(&v_full[sp], ((nblk - 1) / ST) & 1);
      uint32_t pa[BN / 16][4];
      pack(pa);
      wgmma_fence();
      issue_pv(pa, sp);
      wgmma_wait<0>();
      fence_regs(acc);
      release(&v_empty[sp]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, kMinL), inv1 = 1.f / fmaxf(l1, kMinL);
    // o in bf16 over this warpgroup's q tile (its last product has read
    // it), in the swizzled layout the TMA store reads: 16-byte group
    // (column / 8) of row r sits at group ^ (r % 8)
    const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      uint8_t* chunk = Qw + (i >> 3) * CHUNK;
      const int grp = ((i & 7) ^ g) * 16 + 4 * t;
      *reinterpret_cast<__nv_bfloat162*>(chunk + ra * 128 + grp) =
          __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(chunk + rb * 128 + grp) =
          __floats2bfloat162_rn(acc[4 * i + 2] * inv1,
                                acc[4 * i + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (wt == 0 && r0 < p.T) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_store(&to, Qw + c * CHUNK, 64 * c, r0, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int HD>
struct F32Tile {
  static constexpr int BM = 32, BN = 32;
  // q and k rows padded by one float: the dot products' reads of eight
  // rows at once fall in eight banks
  static constexpr int kSmem =
      (BM * (HD + 1) + BN * (HD + 1) + BN * HD + BM * (BN + 1)) * 4;
};

// fp32: thread (r = tid / 4, c = tid % 4) holds query row q0 + r, the
// scores of keys c, c + 4, ... of each block and output columns c, c + 4,
// ...; the four threads of a row are neighbouring lanes of one warp.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  using Tile = F32Tile<HD>;
  constexpr int BM = Tile::BM, BN = Tile::BN;
  constexpr int QL = HD + 1, KL = HD + 1, PL = BN + 1;
  constexpr int C4 = HD / 4;  // 16-byte vectors a row
  extern __shared__ float4 smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);
  float* Ks = Qs + BM * QL;
  float* Vs = Ks + BN * KL;
  float* Ps = Vs + BN * HD;

  const int tid = threadIdx.x;
  const int qb = (int)(blockIdx.x % p.q_blocks);
  const int bh = (int)(blockIdx.x / p.q_blocks), b = bh / p.H, h = bh % p.H,
            hk = h / p.group;
  const int q0 = qb * BM, q1 = min(q0 + BM, p.T);
  const float* q = reinterpret_cast<const float*>(p.q) + b * p.q_sb +
                   h * p.q_sh;
  const float* k = reinterpret_cast<const float*>(p.k) + b * p.k_sb +
                   hk * p.k_sh;
  const float* v = reinterpret_cast<const float*>(p.v) + b * p.v_sb +
                   hk * p.v_sh;

  for (int e = tid; e < BM * C4; e += kThreads) {
    const int r = e / C4, c = e % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.T)
      x = *reinterpret_cast<const float4*>(q + (long long)(q0 + r) * p.q_st +
                                           4 * c);
    float* d = Qs + r * QL + 4 * c;
    d[0] = x.x * p.scale;
    d[1] = x.y * p.scale;
    d[2] = x.z * p.scale;
    d[3] = x.w * p.scale;
  }

  const int r = tid >> 2, c4 = tid & 3, qi = q0 + r;
  float m = kNegInf, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  int lo, hi;
  kv_blocks(p.S, p.causal, p.window, q0, q1, BN, &lo, &hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();
    for (int e = tid; e < BN * C4; e += kThreads) {
      const int rr = e / C4, c = e % C4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + rr < p.S) {
        kx = *reinterpret_cast<const float4*>(
            k + (long long)(k0 + rr) * p.k_st + 4 * c);
        vx = *reinterpret_cast<const float4*>(
            v + (long long)(k0 + rr) * p.v_st + 4 * c);
      }
      float* kd = Ks + rr * KL + 4 * c;
      float* vd = Vs + rr * HD + 4 * c;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      vd[0] = vx.x; vd[1] = vx.y; vd[2] = vx.z; vd[3] = vx.w;
    }
    __syncthreads();

    float s[BN / 4];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < BN / 4; ++c) {
      const int col = c4 + 4 * c;
      const float* qr = Qs + r * QL;
      const float* kr = Ks + col * KL;
      float d = 0.f;
#pragma unroll 8
      for (int e = 0; e < HD; ++e) d = fmaf(qr[e], kr[e], d);
      s[c] = visible(p, qi, k0 + col) ? d : kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < BN / 4; ++c) {
      const int col = c4 + 4 * c;
      const float e = visible(p, qi, k0 + col) ? expf(s[c] - mn) : 0.f;
      Ps[r * PL + col] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = mn;
    __syncwarp();  // row r of Ps comes from the four lanes that read it
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < BN; ++c) {
      const float pc = Ps[r * PL + c];
      const float* vr = Vs + c * HD + c4;
#pragma unroll
      for (int j = 0; j < HD / 4; ++j) acc[j] = fmaf(pc, vr[4 * j], acc[j]);
    }
  }

  if (qi < p.T) {
    const float d = fmaxf(l, kMinL);
    float* o = reinterpret_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
               (long long)qi * p.o_st + c4;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) o[4 * j] = acc[j] / d;
  }
}

template <typename Kernel>
int run(Kernel kernel, int smem, int bm, int bh, Params p,
        cudaStream_t stream) {
  // One block per (batch * head, q block), flattened onto grid x (up to
  // 2^31 - 1 blocks): grid y and z stop at 65535, and B * H alone passes
  // that at long batches of short sequences.
  p.q_blocks = (p.T + bm - 1) / bm;
  const long long blocks = (long long)p.q_blocks * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// A bf16 (hd, rows, heads, batch) map with element strides (row, head,
// batch), read and written in (64 columns, box_rows) boxes with the
// 128-byte swizzle.  0 or kEncodeError + the CUresult.
int encode(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
           int batch, long long s_row, long long s_head, long long s_batch,
           int box_rows) {
  tmap::EncodeTiled fn = tmap::encoder();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2,
                                 (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int HD>
int run_wgmma(const Params& p, int B, int Hkv, cudaStream_t stream) {
  using Tile = WgTile<HD>;
  const int bh = B * p.H;
  WgParams w{p.H,      p.group,  p.T, p.S, bh, (p.T + Tile::BM - 1) / Tile::BM,
             p.causal, p.window, p.scale * kLog2e};
  const long long blocks = (long long)w.q_blocks * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv, to;
  int err = encode(&tq, p.q, HD, p.T, p.H, B, p.q_st, p.q_sh, p.q_sb, 64);
  if (!err)
    err = encode(&to, p.o, HD, p.T, p.H, B, p.o_st, p.o_sh, p.o_sb, 64);
  if (!err && p.S > 0) {
    err = encode(&tk, p.k, HD, p.S, Hkv, B, p.k_st, p.k_sh, p.k_sb,
                 Tile::BN);
    if (!err)
      err = encode(&tv, p.v, HD, p.S, Hkv, B, p.v_st, p.v_sh, p.v_sb,
                   Tile::BN);
  } else {
    tk = tv = tq;  // no key: no k or v tile is ever loaded
  }
  if (err) return err;
  auto kernel = flash_fwd_bf16_wgmma<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, Tile::kThreadsWg, Tile::kSmem, stream>>>(
      tq, tk, tv, to, w);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, int B, int Hkv, const Params& p,
              cudaStream_t stream) {
  const int bh = B * p.H;
  if (dtype == 1) {
    if constexpr (HD % 64 == 0) {
      return run_wgmma<HD>(p, B, Hkv, stream);
    } else {
      using Tile = Bf16Tile<HD>;
      return run(flash_fwd_bf16<HD>, Tile::kSmem, Tile::BM, bh, p, stream);
    }
  }
  using Tile = F32Tile<HD>;
  return run(flash_fwd_f32<HD>, Tile::kSmem, Tile::BM, bh, p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16.  Strides in elements; window <= 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int hd, int B, int H, int Hkv,
                           int T, int S, long long q_sb, long long q_sh,
                           long long q_st, long long k_sb, long long k_sh,
                           long long k_st, long long v_sb, long long v_sh,
                           long long v_st, long long o_sb, long long o_sh,
                           long long o_st, int causal, int window,
                           float scale, void* stream) {
  Params p{q,    k,    v,    o,    H,    H / Hkv, T,    S,    q_sb,
           q_sh, q_st, k_sb, k_sh, k_st, v_sb,    v_sh, v_st, o_sb,
           o_sh, o_st, causal, window, scale, 0};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch_hd<16>(dtype, B, Hkv, p, st);
    case 32: return launch_hd<32>(dtype, B, Hkv, p, st);
    case 64: return launch_hd<64>(dtype, B, Hkv, p, st);
    case 80: return launch_hd<80>(dtype, B, Hkv, p, st);
    case 128: return launch_hd<128>(dtype, B, Hkv, p, st);
    case 256: return launch_hd<256>(dtype, B, Hkv, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
