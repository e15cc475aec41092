// Shared parts of the dequant-matmul kernels (int4: K4/K5b, K6, K7; int8:
// K3/K5a): nibble unpacking and dequantization, the decode-shaped (M <= 32)
// int4 GEMV kernel with its optional prologues and epilogues, its tile
// constants (which the int8 GEMV shares), and the mma.sync helpers of the
// prefill-shaped (M > 32) kernels' fp32 route.
//
// Weight layout (tinygpt_tpu/ops/quant.py, kept byte for byte): a stacked
// weight is data int8 [L, IN/2, OUT] and scales fp32 [L, IN/group, OUT].
// Packed row p holds the BIASED nibbles u = q + 8 of original row p (low
// nibble) and row IN/2 + p (high nibble). So each nibble plane has its own
// scale rows: the low plane uses scales[p / group], the high plane
// scales[(IN/2 + p) / group]. A layer is a pointer offset into the stack.
//
// Dequantization is exact in fp32: the GEMV rounds the exact (u - 8) * s
// once, the same value the plain PyTorch version computes as q.float() * s.
// The TPU kernel's rank-1 correction of the bias (s * (x @ u) - 8 s * sum(x)
// per group) is not needed: dequantizing in registers costs a conversion, a
// subtraction and a multiplication a weight.
#pragma once

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace tg {
// Internal linkage: each kernel library keeps its own copies. Otherwise the
// function-local statics of the launch templates (the once-per-kernel
// shared-memory attribute) would be merged across the libraries loaded into
// one process, and a library would skip setting the attribute of its own
// kernel.
namespace {

template <typename T>
__device__ __forceinline__ float to_float(T v);

template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Exact fp32 dequantization of one biased nibble u in [0, 15]: u - 8 is
// exact, so (u - 8) * s is rounded once.
__device__ __forceinline__ float dq(uint32_t u, float s) {
  return (static_cast<float>(u) - 8.f) * s;
}

// Everything one call of the GEMV kernel reads. Optional operands are null
// when absent. x is [M, in_x] (or [M, 2 * in_x] = gate || up with silu);
// in_x <= IN = 2 * half, the weight's (row-padded) contraction dim, and
// activation columns in_x .. IN are zeros. ln is [L, in_x], bias [L, OUT],
// q_norm / k_norm [L, rope_dim] (all of x's type), invrms [M] and
// rope_cos / rope_sin [M, rope_dim] fp32, res and out [M, OUT] of the
// output type.
struct GemvArgs {
  const void* x;
  const int8_t* data;
  const float* scales;
  const void* ln;
  const float* invrms;
  const void* res;
  const void* bias;
  const float* rope_cos;
  const float* rope_sin;
  const void* q_norm;
  const void* k_norm;
  void* out;
  int M, in_x, half, OUT, group, layer;
  int silu;       // x is gate || up: the activation is silu(gate) * up
  int rope_cols;  // columns [0, rope_cols) are q || k heads to rotate
  int rope_dim;   // head dim D
  int qk_cols;    // columns [0, qk_cols) are q heads (q_norm), then k heads
  float eps;
};

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_BN = 256;  // columns of a block: 8 a lane, one packed row's 256 bytes a warp
constexpr int GEMV_RP = 16;   // packed rows a warp has in flight (group % 16 == 0)
constexpr int GEMV_CH = GEMV_WARPS * GEMV_RP;  // packed rows staged at a time
constexpr int GEMV_SK = 8;    // blocks of a cluster, splitting the packed rows
constexpr int GEMV_HEADS = GEMV_BN / 32;       // most heads in a tile (head dim >= 32)

template <int MR>
struct GemvShape {
  static constexpr int XS = MR * 2 * GEMV_CH;           // staged activations
  static constexpr int RED = GEMV_WARPS * MR * GEMV_BN;  // the warps' partial sums
  static constexpr int TILE = MR * GEMV_BN;
  static constexpr size_t SMEM = sizeof(float) * (XS + RED + 2 * TILE + MR * GEMV_HEADS);
};

// The activation of row m at padded column c (0 <= c < IN), in fp32: the
// silu(gate) * up or x * invrms * ln prologue, zero in the pad columns.
template <typename TIn>
__device__ __forceinline__ float gemv_prologue(const GemvArgs& a, int m, int c) {
  if (c >= a.in_x) return 0.f;
  const TIn* x = static_cast<const TIn*>(a.x);
  if (a.silu) {
    const TIn* row = x + (size_t)m * 2 * a.in_x;
    const float g = to_float<TIn>(row[c]);
    const float u = to_float<TIn>(row[a.in_x + c]);
    return g * (1.f / (1.f + expf(-g))) * u;
  }
  float v = to_float<TIn>(x[(size_t)m * a.in_x + c]);
  if (a.ln != nullptr) {
    const TIn* ln = static_cast<const TIn*>(a.ln) + (size_t)a.layer * a.in_x;
    v = v * a.invrms[m] * to_float<TIn>(ln[c]);
  }
  return v;
}

// out[m, o] = epilogue(sum_i act[m, i] * w[i, o]) for M <= 32 rows.
//
// Bound on an H100 by the packed weight bytes (0.5 byte a weight plus the
// scales), read once. The design is about reading them at the memory's
// rate: each warp reads one packed row's 256 contiguous bytes (8 columns, 8
// bytes a lane) per load, 16 rows in flight, dequantizes in registers and
// takes the MR activation rows from shared memory as broadcasts. A block
// owns 256 columns; its 8 warps split its packed rows, and a cluster of 8
// blocks (Hopper's thread block clusters) splits the rows again, so a
// 4096-column matrix still spreads over 128 SMs. The block sums its warps
// through shared memory; block 0 of the cluster sums the 8 blocks' tiles
// through distributed shared memory and runs the epilogue on the fp32 tile:
// + bias, per-head qk RMS-norm, RoPE (rotate-half) on heads below
// rope_cols, + res, one rounding.
template <typename TIn, typename TOut, int MR>
__global__ void __cluster_dims__(1, GEMV_SK, 1) __launch_bounds__(GEMV_THREADS)
    int4_gemv_kernel(GemvArgs a) {
  using S = GemvShape<MR>;
  constexpr int BN = GEMV_BN, RP = GEMV_RP, CH = GEMV_CH;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* xs = smem;              // [MR][2][CH] staged activations
  float* red = xs + S::XS;       // [WARPS][MR][BN] the warps' partial sums
  float* tile = red + S::RED;    // [MR][BN] this block's partial sums
  float* fin = tile + S::TILE;   // [MR][BN] the cluster's sums (block 0)
  float* sinv = fin + S::TILE;   // [MR][HEADS] per-head qk-norm factors

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * BN;
  const int col = col0 + lane * 8;
  const bool col_ok = col < a.OUT;
  const int m0 = blockIdx.z * MR;
  const int half = a.half;
  const int rows = half / GEMV_SK;  // packed rows of this block
  const int r0 = blockIdx.y * rows;
  const int8_t* W = a.data + (size_t)a.layer * half * a.OUT;
  const float* Sc = a.scales + (size_t)a.layer * (2 * half / a.group) * a.OUT;

  float acc[MR][8];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int c0 = r0; c0 < r0 + rows; c0 += CH) {
    __syncthreads();
    for (int i = tid; i < MR * 2 * CH; i += GEMV_THREADS) {
      const int m = i / (2 * CH);
      const int plane = (i / CH) % 2;
      const int c = c0 + i % CH;
      float v = 0.f;
      if (m0 + m < a.M && c < r0 + rows) v = gemv_prologue<TIn>(a, m0 + m, plane * half + c);
      xs[i] = v;
    }
    __syncthreads();
    const int p0 = c0 + warp * RP;
    if (col_ok && p0 < r0 + rows) {
      // the warp's 16 rows lie inside one group (group % 16 == 0)
      const int gi = p0 / a.group;
      float s_lo[8], s_hi[8];
      const float4* sl = reinterpret_cast<const float4*>(Sc + (size_t)gi * a.OUT + col);
      const float4* sh =
          reinterpret_cast<const float4*>(Sc + (size_t)(half / a.group + gi) * a.OUT + col);
      const float4 l0 = __ldg(sl), l1 = __ldg(sl + 1), h0 = __ldg(sh), h1 = __ldg(sh + 1);
      s_lo[0] = l0.x; s_lo[1] = l0.y; s_lo[2] = l0.z; s_lo[3] = l0.w;
      s_lo[4] = l1.x; s_lo[5] = l1.y; s_lo[6] = l1.z; s_lo[7] = l1.w;
      s_hi[0] = h0.x; s_hi[1] = h0.y; s_hi[2] = h0.z; s_hi[3] = h0.w;
      s_hi[4] = h1.x; s_hi[5] = h1.y; s_hi[6] = h1.z; s_hi[7] = h1.w;
      uint2 w[RP];
#pragma unroll
      for (int r = 0; r < RP; ++r)
        w[r] = __ldg(reinterpret_cast<const uint2*>(W + (size_t)(p0 + r) * a.OUT + col));
      const float* xw = xs + (p0 - c0);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        float xl[MR], xh[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          xl[m] = xw[(m * 2 + 0) * CH + r];
          xh[m] = xw[(m * 2 + 1) * CH + r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t b = ((j < 4 ? w[r].x : w[r].y) >> (8 * (j & 3))) & 0xFFu;
          const float wl = dq(b & 0x0Fu, s_lo[j]);
          const float wh = dq(b >> 4, s_hi[j]);
#pragma unroll
          for (int m = 0; m < MR; ++m) acc[m][j] = fmaf(xl[m], wl, fmaf(xh[m], wh, acc[m][j]));
        }
      }
    }
  }

  // sum the block's warps, then the cluster's blocks
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(warp * MR + m) * BN + lane * 8 + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < MR * BN; i += GEMV_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) s += red[w * MR * BN + i];
    tile[i] = s;
  }
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = tid; i < MR * BN; i += GEMV_THREADS) {
      float s = 0.f;
      for (int q = 0; q < GEMV_SK; ++q) s += cluster.map_shared_rank(tile, q)[i];
      const int c = col0 + i % BN;
      if (a.bias != nullptr && c < a.OUT)
        s += to_float<TIn>(static_cast<const TIn*>(a.bias)[(size_t)a.layer * a.OUT + c]);
      fin[i] = s;
    }
    __syncthreads();
    const int D = a.rope_dim;
    if (a.qk_cols > 0) {  // per-head RMS-norm factors of the q and k heads
      for (int pr = warp; pr < MR * (BN / D); pr += GEMV_WARPS) {
        const int m = pr / (BN / D), h = pr % (BN / D);
        float ss = 0.f;
        for (int c = lane; c < D; c += 32) ss += fin[m * BN + h * D + c] * fin[m * BN + h * D + c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (lane == 0) sinv[m * GEMV_HEADS + h] = rsqrtf(ss / D + a.eps);
      }
      __syncthreads();
    }
    for (int i = tid; i < MR * BN; i += GEMV_THREADS) {
      const int m = i / BN;
      const int c = i % BN;
      if (m0 + m >= a.M || col0 + c >= a.OUT) continue;
      float v = fin[i];
      if (D > 0 && col0 + c - c % D < a.rope_cols) {  // this column's head is roped
        const int h = c / D, hc = c % D, hd = D / 2;
        const int pc = hc < hd ? hc + hd : hc - hd;
        float p = fin[m * BN + h * D + pc];
        if (a.qk_cols > 0) {
          const TIn* nw = static_cast<const TIn*>(col0 + h * D < a.qk_cols ? a.q_norm
                                                                           : a.k_norm) +
                          (size_t)a.layer * D;
          const float f = sinv[m * GEMV_HEADS + h];
          v *= f * to_float<TIn>(nw[hc]);
          p *= f * to_float<TIn>(nw[pc]);
        }
        const size_t r = (size_t)(m0 + m) * D + hc;
        v = v * a.rope_cos[r] + (hc < hd ? -p : p) * a.rope_sin[r];
      }
      const size_t o = (size_t)(m0 + m) * a.OUT + col0 + c;
      if (a.res != nullptr) v += to_float<TOut>(static_cast<const TOut*>(a.res)[o]);
      static_cast<TOut*>(a.out)[o] = from_float<TOut>(v);
    }
  }
  cluster.sync();  // every block's tile stays alive until block 0 has read it
}

template <typename TIn, typename TOut, int MR>
cudaError_t launch_gemv_mr(const GemvArgs& a, cudaStream_t stream) {
  using S = GemvShape<MR>;
  static const cudaError_t attr = allow_smem(int4_gemv_kernel<TIn, TOut, MR>, S::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.OUT + GEMV_BN - 1) / GEMV_BN, GEMV_SK, (a.M + MR - 1) / MR);
  int4_gemv_kernel<TIn, TOut, MR><<<grid, GEMV_THREADS, S::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// Needs 1 <= M <= 32, group % 16 == 0, half % group == 0, half % 128 == 0
// (16 rows a warp, 8 blocks a cluster), OUT % 8 == 0, and a head dim of 32,
// 64 or 128 with RoPE. Rows per block: 4 for M <= 4 (the decode batch),
// else 8.
template <typename TIn, typename TOut>
cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream) {
  if (a.M <= 0 || a.M > 32 || a.group % GEMV_RP != 0 || a.half % a.group != 0 ||
      a.half % (GEMV_RP * GEMV_SK) != 0 || a.OUT % 8 != 0)
    return cudaErrorInvalidValue;
  if (a.rope_cols > 0 && a.rope_dim != 32 && a.rope_dim != 64 && a.rope_dim != 128)
    return cudaErrorInvalidValue;
  if (a.rope_cols <= 0) {
    GemvArgs b = a;
    b.rope_dim = 0;
    b.qk_cols = 0;
    return a.M <= 4 ? launch_gemv_mr<TIn, TOut, 4>(b, stream)
                    : launch_gemv_mr<TIn, TOut, 8>(b, stream);
  }
  if (a.M <= 4) return launch_gemv_mr<TIn, TOut, 4>(a, stream);
  return launch_gemv_mr<TIn, TOut, 8>(a, stream);
}

inline GemvArgs plain_gemv_args(const void* x, const void* data, const void* scales, void* out,
                                int M, int in_x, int IN, int OUT, int group, int layer) {
  GemvArgs a{};
  a.x = x;
  a.data = static_cast<const int8_t*>(data);
  a.scales = static_cast<const float*>(scales);
  a.out = out;
  a.M = M;
  a.in_x = in_x;
  a.half = IN / 2;
  a.OUT = OUT;
  a.group = group;
  a.layer = layer;
  return a;
}

// -- mma.sync helpers of the tensor-core (M > 32) kernels ------------------------

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory into mma fragments: lane l
// gives the address of row l % 8 of matrix l / 8, which lands in r[l / 8].
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The A fragment of rows [0, 16) x columns [0, 16) of a staged fp32
// activation tile (at `tile`, row stride LD floats), times the B fragments
// of four 8-column tiles, into c: the activations are split into three
// bf16 parts x = hi + mid + lo (exact: 24 bits of significand in three
// 8-bit pieces), each multiplied. (bf16 activations run the wgmma kernel
// of dequant_mm_tc.cuh.)
template <int LD>
struct MmaRows {
  static __device__ __forceinline__ void run(const float* tile, int lane,
                                             const uint32_t (*b)[2], float (*c)[4]) {
    const float* ap = tile + (lane / 4) * LD + (lane % 4) * 2;
    const float* src[4] = {ap, ap + 8 * LD, ap + 8, ap + 8 * LD + 8};
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = *reinterpret_cast<const float2*>(src[i]);
      const float h0 = __bfloat162float(__float2bfloat16(f.x));
      const float h1 = __bfloat162float(__float2bfloat16(f.y));
      const float m0 = __bfloat162float(__float2bfloat16(f.x - h0));
      const float m1 = __bfloat162float(__float2bfloat16(f.y - h1));
      hi[i] = pack_bf16x2(h0, h1);
      mid[i] = pack_bf16x2(m0, m1);
      lo[i] = pack_bf16x2(f.x - h0 - m0, f.y - h1 - m1);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma_bf16(c[nt], hi, b[nt]);
      mma_bf16(c[nt], mid, b[nt]);
      mma_bf16(c[nt], lo, b[nt]);
    }
  }
};

}  // namespace
}  // namespace tg
