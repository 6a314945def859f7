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
// Two kernels, one per input type, each a template over hd (16, 32, 64,
// 128, 256):
//  * bf16: four warps, 64 query rows a CTA (16 a warp); q.k^T and p.v on
//    the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate).  The
//    scores come out of the product in fp32 and are scaled there by
//    1/sqrt(hd): the same value as scaling q in fp32 first (kernel.py:48),
//    without rounding the scaled q back to bf16 for the tensor cores.  The
//    probabilities are rounded to bf16 for the second product, as the JAX
//    model's _sdpa casts them to v's dtype.
//  * fp32: plain fp32 FMAs (TF32 would miss the 2e-5 that fp32 is held
//    to), q scaled by 1/sqrt(hd) in fp32 as it is loaded, 32 query rows
//    a CTA, four threads a row.
//
// Bound: 4 * hd FLOPs per visible (q, k) pair per head, over the tensor
// cores' 989 TFLOP/s in bf16; a prefill at T = 2048, hd = 128 is
// compute-bound (q, k, v and o move in about a third of that time).  This
// first design answers the bound only in part: the products run on the
// tensor cores and every k/v tile is read once per CTA from shared memory
// for 64 query rows; but tiles are loaded synchronously (no cp.async, TMA
// or double buffering), v's fragments are gathered with 16-bit shared loads
// (no ldmatrix.trans), and there is no wgmma or warp specialisation.
//
// The launcher returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // kernel.py NEG_INF
constexpr float kMinL = 1e-30f;    // kernel.py:74, the floor of the sum
constexpr int kThreads = 128;

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
__device__ __forceinline__ void kv_blocks(const Params& p, int q0, int q1,
                                          int bn, int* lo, int* hi) {
  int klo = 0, khi = p.S;
  if (p.causal) khi = min(khi, q1);
  if (p.window > 0) klo = max(0, q0 - p.window + 1);
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
  static constexpr int BN = HD >= 256 ? 32 : 64; // keys a kv block
  static constexpr int LD = HD + 8;  // row stride in shared memory: rows
                                     // stay 16-byte aligned and start 4
                                     // banks apart
  static constexpr int kSmem = (BM + 2 * BN) * LD * 2;
};

// bf16: warp w holds query rows [q0 + 16 w, q0 + 16 w + 16); in the mma
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
  kv_blocks(p, q0, q1, BN, &lo, &hi);
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
  kv_blocks(p, q0, q1, BN, &lo, &hi);
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

template <int HD>
int launch_hd(int dtype, int bh, const Params& p, cudaStream_t stream) {
  if (dtype == 1) {
    using Tile = Bf16Tile<HD>;
    return run(flash_fwd_bf16<HD>, Tile::kSmem, Tile::BM, bh, p, stream);
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
  const int bh = B * H;
  switch (hd) {
    case 16: return launch_hd<16>(dtype, bh, p, st);
    case 32: return launch_hd<32>(dtype, bh, p, st);
    case 64: return launch_hd<64>(dtype, bh, p, st);
    case 128: return launch_hd<128>(dtype, bh, p, st);
    case 256: return launch_hd<256>(dtype, bh, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
