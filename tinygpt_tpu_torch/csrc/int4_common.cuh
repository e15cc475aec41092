// Shared parts of the dequant-matmul kernels (int4: K4/K5b, K6, K7; int8:
// K3/K5a; the MoE kernels K11a/K11b): nibble conversion, the mma.sync
// helpers, and the decode-shaped (M <= 32) int4 GEMV kernel with its
// optional prologues and epilogues.
//
// Weight layout (tinygpt_tpu/ops/quant.py, kept byte for byte): a stacked
// weight is data int8 [L, IN/2, OUT] and scales fp32 [L, IN/group, OUT].
// Packed row p holds the BIASED nibbles u = q + 8 of original row p (low
// nibble) and row IN/2 + p (high nibble). So each nibble plane has its own
// scale rows: the low plane uses scales[p / group], the high plane
// scales[(IN/2 + p) / group]. A layer is a pointer offset into the stack.
//
// Dequantization is exact: the GEMV (and the MoE kernels K11a/K11b) turn
// each nibble into the bf16 value u - 8 (exact), multiply it on the tensor
// cores, sum each group in fp32 and multiply the group's sum by its scale
// once, as the TPU kernels do (s * (x @ u - 8 sum(x)) a group).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

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
  // The MLP's pair of calls. gated: the columns are gate || up (OUT = 2I);
  // a block's 128 columns are 64 gate columns and their 64 up columns, and
  // out receives silu(gate) * up in the fragment order of the down call
  // (frag_half its packed rows, frag_nt its n-tiles, frag_parts bf16
  // parts), zeros in its pad columns. xfrag: x is such an activation, which
  // the block copies instead of staging.
  int gated, frag_half, frag_nt, frag_parts;
  int xfrag;
};

// The activation of row m at padded column c (0 <= c < IN), in fp32: the
// silu(gate) * up or x * ln prologue (the norm's row factor invrms is
// applied to the sums), zero in the pad columns.
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
    v *= to_float<TIn>(ln[c]);
  }
  return v;
}


// -- mma.sync helpers ------------------------------------------------------------

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

// -- the decode-shaped int4 GEMV (M <= 32) -----------------------------------------
//
// out[m, o] = epilogue(sum_i act[m, i] * w[i, o]) for M <= 32 rows, one pass
// over the packed weight whatever M is (rows pass in n-tiles of 8: 1 for M
// <= 8, 2 for M <= 16, else 4).
//
// Bound on an H100 by the packed weight bytes (0.5 byte a weight plus the
// scales), read once. At 4 to 32 rows the card must spend few instructions
// a weight to keep up with the memory, so the products run on the tensor
// cores:
// - mma.sync m16n8k16 with the weight as the A operand: 16 output columns x
//   16 packed rows of one nibble plane (each plane has its own scale rows),
//   the activations as B, NT n-tiles of 8 rows. A block holds all the
//   call's rows, so no packed byte is read twice. The 16 k slots of a
//   thread's fragments are packed rows 4t .. 4t + 3 of a chunk (t its quad
//   position), so its activations are 4 consecutive values.
// - A nibble becomes an exact bf16 u - 8 in about 1.5 instructions: a byte
//   permute gathers two rows' bytes, a LOP3 puts a nibble under the
//   exponent of 128 (0x43 0u is 128 + u), a bf16x2 subtraction of 136 serves
//   two weights.
// - The activation goes in as P bf16 parts: bf16 x as it is (P = 1); an
//   fp32 activation with bf16 outputs in two (x * ln, exact: two bf16
//   values' product has 16 significant bits; silu(g) * u within 2^-17);
//   the fp32 route in three (exact). The norm's row factor invrms
//   multiplies the sums, not the activation.
// - Each group's fp32 sums are multiplied by the group's scale once a
//   column and row, after the group's last chunk.
// - Streaming without block barriers: a block owns 128 columns; NT column
//   warps (128 / NT columns each) x the rest as k warps stream their 16-row
//   chunks through their own cp.async ring, 2 NT stages (4 KB of weights)
//   in flight, ordered by cp.async.wait_group and __syncwarp. A stage
//   carries the chunk's weights, its group's scale rows where it ends one,
//   and the activation payload (GvShape's X): bf16 x's 16 rows of the chunk
//   (X = 0), or x and ln, or the MLP's fragments, from which the warp forms
//   its B fragments (X = 2). These blocks are 4 warps, two an SM. A block
//   that must stage (X = 1: the silu prologue, x rows not 16-byte aligned,
//   or more than 16 rows) is 8 warps, one an SM, and copies its rows once
//   by cp.async while its first chunks fly, then splits them in place.
// - A planned split: the C blocks of a thread-block cluster split the
//   packed rows in 16-row units, C planned on the host from M, IN, OUT, the
//   parts, the route and the SM count (ops/quant_kernels.int4_gemv_split,
//   up to a non-portable cluster of 16). The block sums its k warps through
//   shared memory, then the cluster reduce-scatters through distributed
//   shared memory: rank r sums its share of the (row, segment) units, a
//   segment 32 columns or, where the epilogue norms or rotates heads, one
//   head, and runs the epilogue on the fp32 sums: invrms, + bias, per-head
//   qk RMS-norm, RoPE (rotate-half) on heads below rope_cols, + res, one
//   rounding. The MLP's gate_up call (gated) takes 64 gate columns and their
//   64 up columns a block, and its epilogue writes silu(g) * u as the down
//   call's bf16 parts in that call's fragment order (int4_mlp.cu).
// A staged shape whose activations do not fit the block's shared memory at
// the given split runs with fewer n-tiles a pass, over more passes of the
// rows (grid y); the main path's shapes take one pass.

constexpr int GV_COLS = 128;        // columns of a block
constexpr int GV_UNIT = 16;         // packed rows of a chunk and of the split's unit
constexpr int GV_MAX_SPLIT = 16;    // blocks of a cluster (above 8: non-portable)
constexpr int GV_SMEM_MAX = 232448;  // shared memory a block may take
constexpr int GV_PITCH = GV_COLS + 2;  // floats a row of the k warps' sums (spreads the banks)

// How a block gets its activation rows (the template's X): 0, bf16 x as
// it is (P = 1) rides the ring beside the weights; 2, an activation in
// parts is formed chunk by chunk from what rides the ring (x and ln, or
// the MLP's fragments); 1, the block stages all its rows once (the silu
// prologue, x rows not 16-byte aligned, and 32 rows, whose ring payload
// would be four times the weights).
template <int NT, int P, int X>
struct GvShape {
  // rings only (X = 0, 2): 4 warps, two blocks an SM (their registers), so
  // one block's tail overlaps another's stream; staged (X = 1): 8 warps,
  // one block an SM (its shared memory)
  static constexpr int WARPS = X == 1 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int W = GV_COLS / NT;     // columns of a warp
  static constexpr int CT = W / 16;          // 16-column mma tiles of a warp
  static constexpr int TB = W / 8;           // bytes of a packed row a thread converts
  static constexpr int CW = GV_COLS / W;     // warps across the block's columns (NT)
  static constexpr int KW = WARPS / CW;      // warps splitting the block's rows
  static constexpr int D = 2 * NT;           // ring stages in flight (4 KB)
  static constexpr int NS = D + 1;           // ring slots
  static constexpr int WBYTES = GV_UNIT * W;  // a stage's weight bytes
  // the activation payload of a stage: x rows [2][8 NT][16] bf16 (X = 0),
  // or the fragments [P][2][NT][32] uint2, or x rows (bf16 or fp32) and ln
  static constexpr int XPAY = X == 0   ? 512 * NT
                              : X == 2 ? (P * 512 * NT > 1024 * NT + 128 ? P * 512 * NT
                                                                         : 1024 * NT + 128)
                                       : 0;
  // weights, both planes' scale rows, payload
  static constexpr int SLOT = WBYTES + 8 * W + XPAY;
  static constexpr int RING = WARPS * NS * SLOT;
  static constexpr int RED = KW * 8 * NT * GV_PITCH * 4;  // the k warps' sums, after the walk
  static constexpr int BASE = RING > RED ? RING : RED;
};

// Shared memory of a block: rings (or sums), then, staged (X = 1), the
// activations, P bf16 parts x 2 planes x 8 NT rows of each of its nk
// packed rows, and the norm's weights at those rows (up to 8 bytes a row).
template <int NT>
inline size_t gv_bytes_nt(int nk, int parts, int x) {
  if (x == 0) return GvShape<NT, 1, 0>::BASE;
  if (x == 2) return parts == 2 ? GvShape<NT, 2, 2>::BASE : GvShape<NT, 3, 2>::BASE;
  return GvShape<NT, 2, 1>::BASE + (size_t)nk * (32 * parts * NT + 8);
}

inline size_t gv_bytes(int nt, int nk, int parts, int x) {
  return nt == 1 ? gv_bytes_nt<1>(nk, parts, x) : nt == 2 ? gv_bytes_nt<2>(nk, parts, x)
                                                           : gv_bytes_nt<4>(nk, parts, x);
}

// Byte offset of 16-byte unit u of row `row` in a ring stage of rows of W
// bytes: the 128-byte lines of 128 / W rows have their units permuted
// (XOR 2 ((row / 4) % 4)), so a warp's fragment reads of rows 4t + jj
// fall on distinct banks.
template <int W>
__device__ __forceinline__ int gv_offset(int row, int u) {
  constexpr int L = 128 / W;  // rows a line
  const int unit = ((row % L) * (W / 16) + u) ^ (2 * ((row >> 2) & 3));
  return (row / L) * 128 + unit * 16;
}

template <int BYTES>
__device__ __forceinline__ void gv_copy(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 8 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void gv_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void gv_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mma_bf16 without `volatile`, so the compiler may interleave the GEMV's
// products with its conversions.
__device__ __forceinline__ void gv_mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The low nibbles of bytes 0 and 2 of x as the bf16 pair (u0 - 8, u2 - 8):
// 0x43 0u is the bf16 128 + u, and 136 is subtracted.
__device__ __forceinline__ uint32_t gv_nibbles(uint32_t x) {
  uint32_t t = (x & 0x000F000Fu) | 0x43004300u;  // one LOP3
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight consecutive activations, loaded as 16-byte vectors (zeros until
// loaded), and their fp32 values.
template <typename T>
struct Oct {
  uint4 v[sizeof(T) / 2] = {};
};

template <typename T>
__device__ __forceinline__ Oct<T> load_oct(const T* p) {
  Oct<T> o;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) o.v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  return o;
}

__device__ __forceinline__ void oct_floats(const Oct<__nv_bfloat16>& o, float* f) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(o.v);
#pragma unroll
  for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(e[q]);
}

__device__ __forceinline__ void oct_floats(const Oct<float>& o, float* f) {
  const float* e = reinterpret_cast<const float*>(o.v);
#pragma unroll
  for (int q = 0; q < 8; ++q) f[q] = e[q];
}

// The next bf16 part of four activations, as two bf16x2 words (their bf16
// values); what is left of each stays in v for the next part.
__device__ __forceinline__ uint2 gv_part(float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  const float2 fl = __bfloat1622float2(lo), fh = __bfloat1622float2(hi);
  v[0] -= fl.x;
  v[1] -= fl.y;
  v[2] -= fh.x;
  v[3] -= fh.y;
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

template <typename TIn, typename TOut, int NT, int P, int X>
__global__ void __launch_bounds__(GvShape<NT, P, X>::THREADS, 1) int4_gemv_kernel(GemvArgs a) {
  using S = GvShape<NT, P, X>;
  constexpr int W = S::W, KW = S::KW, CW = S::CW, CT = S::CT, TB = S::TB, D = S::D,
                NS = S::NS, THREADS = S::THREADS, WARPS = S::WARPS;
  constexpr int MP = 8 * NT;     // rows of a pass
  constexpr bool XR = X == 0;    // bf16 x rides the ring beside the weights
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + S::BASE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp % CW, wk = warp / CW;
  const int tile = blockIdx.x / C;
  const int col0 = tile * GV_COLS;
  // the global column of the block's column c, -1 past the weight's edge
  const int half_out = a.OUT / 2;
  auto colmap = [&](int c) {
    if (a.gated) {
      const int gc = tile * (GV_COLS / 2) + (c % (GV_COLS / 2));
      return gc < half_out ? (c < GV_COLS / 2 ? gc : half_out + gc) : -1;
    }
    return col0 + c < a.OUT ? col0 + c : -1;
  };
  const int m0 = blockIdx.y * MP;
  const int mrows = min(MP, a.M - m0);  // the pass's real rows
  const int half = a.half, OUT = a.OUT, group = a.group;
  // the block's packed rows [k0, k0 + nk) and the warp's n_st chunks from r0
  const int n16 = half / GV_UNIT;
  const int u0 = (int)((long long)rank * n16 / C);
  const int nu = (int)((long long)(rank + 1) * n16 / C) - u0;
  const int k0 = u0 * GV_UNIT, nk = nu * GV_UNIT;
  const int wu0 = wk * nu / KW;
  const int n_st = (wk + 1) * nu / KW - wu0;
  const int r0 = k0 + wu0 * GV_UNIT;
  const int8_t* Wt = a.data + (size_t)a.layer * half * OUT;
  const float* Sc = a.scales + (size_t)a.layer * (2 * half / group) * OUT;
  const int hi_groups = half / group;  // the high plane's first scale row
  const bool wide = OUT % 16 == 0;     // rows 16-byte aligned
  const int gpc = group / GV_UNIT;     // chunks a group
  const int first_end = gpc - 1 - (r0 / GV_UNIT) % gpc;  // the warp's first chunk ending a group

  unsigned char* ring = smem + warp * NS * S::SLOT;
  // chunk i of the warp's rows into ring slot `slot`: weights, the scale
  // rows of the group it ends (if it ends one), the activation payload
  int is_end = first_end, is_gi = r0 / group;
  auto issue = [&](int i, int slot) {
    const int r = r0 + i * GV_UNIT;
    const int8_t* wrow = Wt + (size_t)r * OUT;
    unsigned char* dst = ring + slot * S::SLOT;
    if (wide) {
#pragma unroll
      for (int k = 0; k < W / 32; ++k) {
        const int q = lane + 32 * k, row = q / (W / 16), u = q % (W / 16);
        const int c = colmap(wc * W + u * 16);
        gv_copy<16>(dst + gv_offset<W>(row, u), c >= 0 ? wrow + (size_t)row * OUT + c : Wt,
                    c >= 0);
      }
    } else {  // rows only 8-byte aligned
#pragma unroll
      for (int k = 0; k < W / 16; ++k) {
        const int q = lane + 32 * k, row = q / (W / 8), h = q % (W / 8);
        const int c = colmap(wc * W + h * 8);
        gv_copy<8>(dst + gv_offset<W>(row, h / 2) + (h % 2) * 8,
                   c >= 0 ? wrow + (size_t)row * OUT + c : Wt, c >= 0);
      }
    }
    if (i == is_end || i == n_st - 1) {  // the group's scale rows, both planes
      float* sd = reinterpret_cast<float*>(dst + S::WBYTES);
#pragma unroll
      for (int k = 0; k < (W / 2 + 31) / 32; ++k) {
        const int q = lane + 32 * k;
        if (q < W / 2) {
          const int plane = q / (W / 4), v = (q % (W / 4)) * 4;
          const int c = colmap(wc * W + v);
          gv_copy<16>(sd + plane * W + v,
                      c >= 0 ? Sc + (size_t)(is_gi + plane * hi_groups) * OUT + c : Sc, c >= 0);
        }
      }
      if (i == is_end) {
        is_end += gpc;
        ++is_gi;
      }
    }
    if constexpr (X == 2) {
      unsigned char* xd = dst + S::WBYTES + 8 * W;
      if (a.xfrag) {  // the chunk's fragments, P x 2 x NT x 256 bytes
        const unsigned char* src =
            static_cast<const unsigned char*>(a.x) + (size_t)(r / GV_UNIT) * P * 2 * NT * 256;
#pragma unroll
        for (int k = 0; k < P * NT; ++k) {
          const int q = lane + 32 * k;
          gv_copy<16>(xd + q * 16, src + q * 16, true);
        }
      } else {  // x [plane][MP][16] and ln [plane][16], of x's type
        constexpr int PC = sizeof(TIn);  // 16-byte pieces of 16 values
        constexpr int E = 16 / sizeof(TIn);  // values a piece
        const TIn* x = static_cast<const TIn*>(a.x);
#pragma unroll
        for (int k = 0; k < (2 * MP * PC + 31) / 32; ++k) {
          const int q = lane + 32 * k;
          const int plane = q / (MP * PC), m = (q / PC) % MP, c = plane * half + r + (q % PC) * E;
          if (q < 2 * MP * PC && m < mrows)
            gv_copy<16>(xd + q * 16, c < a.in_x ? x + (size_t)(m0 + m) * a.in_x + c : x,
                        c < a.in_x);
        }
        if (a.ln != nullptr && lane < 2 * PC) {
          const TIn* ln = static_cast<const TIn*>(a.ln) + (size_t)a.layer * a.in_x;
          const int c = (lane / PC) * half + r + (lane % PC) * E;
          gv_copy<16>(xd + (2 * MP * PC + lane) * 16, c < a.in_x ? ln + c : ln, c < a.in_x);
        }
      }
    }
    if constexpr (XR) {  // x [plane][MP][16] bf16: rows past M are left alone
      const TIn* x = static_cast<const TIn*>(a.x);
      unsigned char* xd = dst + S::WBYTES + 8 * W;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const int q = lane + 32 * k, plane = q / (2 * MP), m = (q / 2) % MP, sh = q % 2;
        const int c = plane * half + r + 8 * sh;
        if (m0 + m < a.M)
          gv_copy<16>(xd + (plane * MP + m) * 32 + sh * 16,
                      c < a.in_x ? x + (size_t)(m0 + m) * a.in_x + c : x, c < a.in_x);
      }
    }
  };

  // x for the staged routes, by cp.async ahead of the ring's first chunks:
  // already in fragment order (xfrag), or raw into the fragments' first
  // part (with fp32 x, its first two) and ln beside, split in place below
  uint2* slots = reinterpret_cast<uint2*>(xs);
  TIn* lns = reinterpret_cast<TIn*>(smem + S::BASE + (size_t)nk * 32 * P * NT);  // [2][nk]
  const bool raw = X == 1 && !a.xfrag && !a.silu && a.in_x % 8 == 0;
  if (X == 1 && a.xfrag) {
    const size_t chunk = (size_t)P * 2 * NT * 256;  // bytes a chunk
    const unsigned char* src = static_cast<const unsigned char*>(a.x) + (k0 / GV_UNIT) * chunk;
    for (size_t q = tid; q < nu * chunk / 16; q += THREADS)
      gv_copy<16>(reinterpret_cast<unsigned char*>(xs) + q * 16, src + q * 16, true);
    gv_commit();
  } else if (raw) {
    const TIn* x = static_cast<const TIn*>(a.x);
    const int n4 = nk / 4;  // 4-column groups of a row's plane
    for (int q = tid; q < mrows * 2 * n4; q += THREADS) {
      const int m = q / (2 * n4), plane = (q / n4) % 2, g4 = q % n4;
      const int c = plane * half + k0 + 4 * g4;
      const bool ok = c < a.in_x;
      const TIn* src = ok ? x + (size_t)(m0 + m) * a.in_x + c : x;
      uint2* d = slots + ((((size_t)(g4 / 4) * P * 2 + plane) * NT + m / 8) * 32 + (m % 8) * 4 +
                          g4 % 4);
      gv_copy<8>(d, src, ok);
      if (sizeof(TIn) == 4) gv_copy<8>(d + 2 * NT * 32, ok ? src + 2 : x, ok);
    }
    if (a.ln != nullptr) {
      const TIn* ln = static_cast<const TIn*>(a.ln) + (size_t)a.layer * a.in_x;
      constexpr int E = 8 / sizeof(TIn);  // values of an 8-byte copy
      for (int q = tid; q < 2 * nk / E; q += THREADS) {
        const int plane = q / (nk / E), c = plane * half + k0 + (q % (nk / E)) * E;
        gv_copy<8>(lns + (size_t)q * E, c < a.in_x ? ln + c : ln, c < a.in_x);
      }
    }
    gv_commit();
  }
#pragma unroll
  for (int p = 0; p < D; ++p) {
    if (p < n_st) issue(p, p);
    gv_commit();
  }

  if constexpr (X == 1) {
    if (a.xfrag) {
      gv_wait<D>();  // the copy, not the ring's stages
    } else if (raw) {
      gv_wait<D>();
      __syncthreads();
      // each fragment slot of a real row: x (times ln), split into P parts
      for (int q = tid; q < nu * 2 * NT * 32; q += THREADS) {
        const int ln_ = q % 32, j = (q / 32) % NT, plane = (q / (32 * NT)) % 2;
        const int cb = q / (64 * NT), m = 8 * j + ln_ / 4, tt = ln_ % 4;
        if (m >= mrows) continue;
        uint2* d = slots + ((((size_t)cb * P * 2 + plane) * NT + j) * 32 + ln_);
        float v[4];
        if constexpr (sizeof(TIn) == 2) {
          const uint2 r = *d;
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(e[k]);
        } else {
          const float2 lo = *reinterpret_cast<const float2*>(d);
          const float2 hi = *reinterpret_cast<const float2*>(d + 2 * NT * 32);
          v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
        }
        if (a.ln != nullptr) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] *= to_float<TIn>(lns[(size_t)plane * nk + 16 * cb + 4 * tt + k]);
        }
#pragma unroll
        for (int part = 0; part < P; ++part) d[part * 2 * NT * 32] = gv_part(v);
      }
    } else {
      // the silu prologue, or x rows not 16-byte aligned: the block's
      // activation rows [m0, m0 + MP) at its packed rows, both planes,
      // prologue applied, as P bf16 parts in fragment order: lane (g, t) of
      // n-tile j holds packed rows 4t .. 4t + 3 of a chunk, of row 8j + g
      const int n8 = nk / 8;
      constexpr int RB = sizeof(TIn) == 2 ? 8 : 4;  // rows whose loads fly at once
      const int nb = (mrows + RB - 1) / RB;
      const TIn* x = static_cast<const TIn*>(a.x);
      const size_t xrow = a.silu ? 2 * (size_t)a.in_x : a.in_x;  // elements a row of x
      const bool vec = a.in_x % 8 == 0;  // an octet of columns is all in or all out
      for (int it = tid; it < 2 * n8 * nb; it += THREADS) {
        const int plane = it / (n8 * nb), h = (it / nb) % n8, mb = (it % nb) * RB;
        const int c = plane * half + k0 + 8 * h;  // padded column of the octet
        float v[RB][8];
        if (vec) {  // silu(g) * u, every load of the batch in flight at once
          Oct<TIn> rg[RB], ru[RB];
          const bool live = c < a.in_x;
#pragma unroll
          for (int r = 0; r < RB; ++r)
            if (live && mb + r < mrows) {
              const TIn* row = x + (size_t)(m0 + mb + r) * xrow + c;
              rg[r] = load_oct(row);
              ru[r] = load_oct(row + a.in_x);
            }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float gf[8], uf[8];
            oct_floats(rg[r], gf);
            oct_floats(ru[r], uf);
#pragma unroll
            for (int q = 0; q < 8; ++q)
              v[r][q] = live ? gf[q] * (1.f / (1.f + expf(-gf[q]))) * uf[q] : 0.f;
          }
        } else {
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              v[r][q] = mb + r < mrows ? gemv_prologue<TIn>(a, m0 + mb + r, c + q) : 0.f;
        }
        const int cb = h / 2, t0 = 2 * (h % 2);  // the octet is rows 4 t0 .. 4 t0 + 7 of chunk cb
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int m = mb + r;
          if (m >= mrows) break;  // rows past M stay unwritten: no stored output reads them
          const int j = m / 8, gg = m % 8;
#pragma unroll
          for (int part = 0; part < P; ++part) {
            uint2* dst = reinterpret_cast<uint2*>(xs) +
                         ((((size_t)cb * P + part) * 2 + plane) * NT + j) * 32 + gg * 4 + t0;
            dst[0] = gv_part(v[r]);
            dst[1] = gv_part(v[r] + 4);
          }
        }
      }
    }
    __syncthreads();
  }

  float acc[CT][NT][4], pacc[2][CT][NT][4];
#pragma unroll
  for (int i = 0; i < CT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = pacc[0][i][j][e] = pacc[1][i][j][e] = 0.f;

  int slot = 0, next = D % NS, cs_end = first_end;
  const int xoff = (r0 - k0) / GV_UNIT;  // the warp's first chunk in the staged rows
  for (int i = 0; i < n_st; ++i) {
    gv_wait<D - 1>();  // chunk i has landed (for this lane's copies)
    __syncwarp();      // ... and for the warp's; the previous slot is free
    if (i + D < n_st) issue(i + D, next);
    gv_commit();
    next = next + 1 == NS ? 0 : next + 1;
    const unsigned char* st = ring + slot * S::SLOT;
    // the thread's TB bytes of packed rows 4t .. 4t + 3
    uint32_t R[4][TB / 4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int row = 4 * t + jj;
      const unsigned char* src = st + gv_offset<W>(row, (g * TB) / 16) + (g * TB) % 16;
      if constexpr (TB == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        R[jj][0] = v.x; R[jj][1] = v.y; R[jj][2] = v.z; R[jj][3] = v.w;
      } else if constexpr (TB == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        R[jj][0] = v.x; R[jj][1] = v.y;
      } else {
        R[jj][0] = *reinterpret_cast<const uint32_t*>(src);
      }
    }
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      uint32_t B[P][NT][2];  // the plane's activation fragments, every part and n-tile
#pragma unroll
      for (int part = 0; part < P; ++part)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint2 bv;
          if constexpr (XR)
            bv = *reinterpret_cast<const uint2*>(st + S::WBYTES + 8 * W +
                                                 ((plane * MP + 8 * j + g) * 16 + 4 * t) * 2);
          else if constexpr (X == 1)
            bv = reinterpret_cast<const uint2*>(xs)[
                ((((size_t)(xoff + i) * P + part) * 2 + plane) * NT + j) * 32 + lane];
          else if (a.xfrag)
            bv = reinterpret_cast<const uint2*>(st + S::WBYTES + 8 * W)[
                ((part * 2 + plane) * NT + j) * 32 + lane];
          else
            continue;  // formed below, all parts at once
          B[part][j][0] = bv.x;
          B[part][j][1] = bv.y;
        }
      if constexpr (X == 2) {
        if (!a.xfrag) {  // x (times ln) at rows 4t .. 4t + 3, split into its parts
          const TIn* xd = reinterpret_cast<const TIn*>(st + S::WBYTES + 8 * W);
          float l[4] = {1.f, 1.f, 1.f, 1.f};
          if (a.ln != nullptr) {
#pragma unroll
            for (int k = 0; k < 4; ++k) l[k] = to_float<TIn>(xd[2 * MP * 16 + plane * 16 + 4 * t + k]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[k] = to_float<TIn>(xd[(plane * MP + 8 * j + g) * 16 + 4 * t + k]) * l[k];
#pragma unroll
            for (int part = 0; part < P; ++part) {
              const uint2 w = gv_part(v);
              B[part][j][0] = w.x;
              B[part][j][1] = w.y;
            }
          }
        }
      }
      // tile ci is the thread's bytes 2ci, 2ci + 1: its A fragment, then its products
#pragma unroll
      for (int ci = 0; ci < CT; ++ci) {
        const int w = ci / 2, b = (ci % 2) * 2;
        const uint32_t sel = b | ((b + 1) << 4) | ((b + 4) << 8) | ((b + 5) << 12);
        uint32_t x01 = __byte_perm(R[0][w], R[1][w], sel);
        uint32_t x23 = __byte_perm(R[2][w], R[3][w], sel);
        if (plane) {
          x01 >>= 4;
          x23 >>= 4;
        }
        const uint32_t A[4] = {gv_nibbles(x01), gv_nibbles(x01 >> 8), gv_nibbles(x23),
                               gv_nibbles(x23 >> 8)};
#pragma unroll
        for (int part = 0; part < P; ++part)
#pragma unroll
          for (int j = 0; j < NT; ++j) gv_mma(pacc[plane][ci][j], A, B[part][j]);
      }
    }
    if (i == cs_end || i == n_st - 1) {  // the group ends: scale its sums once
      if (i == cs_end) cs_end += gpc;
      const float* sd = reinterpret_cast<const float*>(st + S::WBYTES);
#pragma unroll
      for (int ci = 0; ci < CT; ++ci) {
        const float2 sl = *reinterpret_cast<const float2*>(sd + g * TB + 2 * ci);
        const float2 sh = *reinterpret_cast<const float2*>(sd + W + g * TB + 2 * ci);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[ci][j][e] = fmaf(e < 2 ? sl.x : sl.y, pacc[0][ci][j][e],
                                 fmaf(e < 2 ? sh.x : sh.y, pacc[1][ci][j][e], acc[ci][j][e]));
            pacc[0][ci][j][e] = pacc[1][ci][j][e] = 0.f;
          }
      }
    }
    slot = slot + 1 == NS ? 0 : slot + 1;
  }
  gv_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // sum the block's k warps into red[0] ([MP][GV_PITCH]), in warp order
  float* red = reinterpret_cast<float*>(smem);  // [KW][MP][GV_PITCH]
#pragma unroll
  for (int ci = 0; ci < CT; ++ci)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = 8 * j + 2 * t, c = wc * W + g * TB + 2 * ci;
      float* d = red + ((size_t)wk * MP + m) * GV_PITCH + c;
      *reinterpret_cast<float2*>(d) = make_float2(acc[ci][j][0], acc[ci][j][2]);
      *reinterpret_cast<float2*>(d + GV_PITCH) = make_float2(acc[ci][j][1], acc[ci][j][3]);
    }
  __syncthreads();
  const int mv = min(MP, a.M - m0);
  for (int i = tid; i < mv * GV_COLS; i += THREADS) {
    const int o = (i / GV_COLS) * GV_PITCH + i % GV_COLS;
    float s = red[o];
#pragma unroll
    for (int w = 1; w < KW; ++w) s += red[w * MP * GV_PITCH + o];
    red[o] = s;
  }
  cluster.sync();

  // reduce-scatter: rank r sums its units over the cluster's blocks (every
  // rank's value in flight at once, then summed in rank order) and runs the
  // epilogue; a warp takes a unit, a lane its columns lane + 32 k
  auto gather = [&](int m, int c) {
    if (C == 1) return red[m * GV_PITCH + c];
    float r[GV_MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < GV_MAX_SPLIT; ++q)
      r[q] = q < C ? cluster.map_shared_rank(red, q)[m * GV_PITCH + c] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < GV_MAX_SPLIT; ++q) v += r[q];
    return v;
  };
  if (a.gated) {  // silu(gate) * up into the down call's fragments
    const int U = mv * 2, ulo = (int)((long long)rank * U / C);
    const int uhi = (int)((long long)(rank + 1) * U / C);
    const int fh = a.frag_half, fp = a.frag_parts, fnt = a.frag_nt;
    __nv_bfloat16* frag = static_cast<__nv_bfloat16*>(a.out);
    for (int un = ulo + warp; un < uhi; un += WARPS) {
      const int m = un / 2, c = (un % 2) * 32 + lane, row = m0 + m;
      const int i = tile * (GV_COLS / 2) + c;  // the activation's column
      if (i >= 2 * fh) continue;
      const float inv = a.ln != nullptr ? a.invrms[row] : 1.f;
      const float gv = gather(m, c) * inv, uv = gather(m, c + GV_COLS / 2) * inv;
      float v = i < half_out ? gv * (1.f / (1.f + expf(-gv))) * uv : 0.f;
      const int plane = i / fh, p = i % fh, ch = p / GV_UNIT, rr = p % GV_UNIT;
      for (int part = 0; part < fp; ++part) {
        const __nv_bfloat16 b = __float2bfloat16(v);
        v -= __bfloat162float(b);
        frag[(((((size_t)ch * fp + part) * 2 + plane) * fnt + row / 8) * 32 + (row % 8) * 4 +
              rr / 4) * 4 + rr % 4] = b;
      }
    }
    cluster.sync();
    return;
  }
  const int Dh = a.rope_dim;
  const int SW = Dh > 0 ? Dh : 32;  // columns of a unit
  const int segs = GV_COLS / SW;
  const int U = mv * segs;
  const int ulo = (int)((long long)rank * U / C), uhi = (int)((long long)(rank + 1) * U / C);
  for (int un = ulo + warp; un < uhi; un += WARPS) {
    const int m = un / segs, cb = (un % segs) * SW;
    const int row = m0 + m;
    const float inv = a.ln != nullptr ? a.invrms[row] : 1.f;  // the norm's row factor
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = 0.f;
      if (k < SW / 32) {
        const int c = cb + lane + 32 * k;
        v[k] = gather(m, c) * inv;
        if (a.bias != nullptr && col0 + c < OUT)
          v[k] += to_float<TIn>(static_cast<const TIn*>(a.bias)[(size_t)a.layer * OUT + col0 + c]);
      }
    }
    if (Dh > 0 && col0 + cb < a.rope_cols && col0 + cb < OUT) {  // one roped head
      if (a.qk_cols > 0) {  // its RMS-norm with q_norm or k_norm
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) ss += v[k] * v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        const float f = rsqrtf(ss / Dh + a.eps);
        const TIn* nw = static_cast<const TIn*>(col0 + cb < a.qk_cols ? a.q_norm : a.k_norm) +
                        (size_t)a.layer * Dh;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < SW / 32) v[k] *= f * to_float<TIn>(nw[lane + 32 * k]);
      }
      float p[4];  // the rotate-half partner of each column, hc +- Dh / 2
      if (Dh == 128) {
        p[0] = v[2]; p[1] = v[3]; p[2] = v[0]; p[3] = v[1];
      } else if (Dh == 64) {
        p[0] = v[1]; p[1] = v[0]; p[2] = p[3] = 0.f;
      } else {
        p[0] = __shfl_xor_sync(0xffffffffu, v[0], 16);
        p[1] = p[2] = p[3] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < SW / 32) {
          const int hc = lane + 32 * k;
          const size_t ri = (size_t)row * Dh + hc;
          v[k] = v[k] * a.rope_cos[ri] + (hc < Dh / 2 ? -p[k] : p[k]) * a.rope_sin[ri];
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = col0 + cb + lane + 32 * k;
      if (k < SW / 32 && c < OUT) {
        const size_t o = (size_t)row * OUT + c;
        float x = v[k];
        if (a.res != nullptr) x += to_float<TOut>(static_cast<const TOut*>(a.res)[o]);
        static_cast<TOut*>(a.out)[o] = from_float<TOut>(x);
      }
    }
  }
  cluster.sync();  // every block's sums stay alive until the cluster has read them
}

// Packed rows of a block's share of `half` at split `split` (16-row units)
inline int gv_rows(int half, int split) {
  return (half / GV_UNIT + split - 1) / split * GV_UNIT;
}

template <typename TIn, typename TOut, int NT, int P, int X>
cudaError_t launch_gemv_nt(const GemvArgs& a, int split, cudaStream_t stream) {
  auto kernel = int4_gemv_kernel<TIn, TOut, NT, P, X>;
  const int nk = gv_rows(a.half, split);
  static const cudaError_t attr = [kernel] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GV_SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  const int tiles = a.gated ? (2 * a.frag_half + GV_COLS / 2 - 1) / (GV_COLS / 2)
                            : (a.OUT + GV_COLS - 1) / GV_COLS;
  cfg.gridDim = dim3(tiles * split, (a.M + 8 * NT - 1) / (8 * NT), 1);
  cfg.blockDim = dim3(GvShape<NT, P, X>::THREADS);
  cfg.dynamicSmemBytes = gv_bytes(NT, nk, P, X);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The route of the activation rows (GvShape's X) and the n-tiles a pass
// takes: those of M (1 for M <= 8, 2 for M <= 16, else 4), or fewer where
// a block's staged activations would not fit (nt 0 when even one does not).
struct GvPlan {
  int nt, x;
};

inline GvPlan gv_plan(int M, int half, int split, int parts, bool silu, bool xfrag, int in_x) {
  const int nk = gv_rows(half, split);
  int nt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  if (parts == 1) return {nt, 0};
  if (nt <= 2 && !silu && (xfrag || in_x % 8 == 0)) return {nt, 2};
  while (nt > 0 && gv_bytes(nt, nk, parts, 1) > GV_SMEM_MAX) nt /= 2;
  return {nt, 1};
}

// What launch_gemv<., ., parts> launches for a at split `split`, into
// plan[0..2]: the n-tiles a pass (0: refused), the route (GvShape's X) and
// the block's dynamic shared memory in bytes. The libraries export it, so
// that the host's model of the plan (ops/quant_kernels._i4_plan) is held
// against this one.
inline void gv_describe(const GemvArgs& a, int split, int parts, int* plan) {
  const GvPlan pl = gv_plan(a.M, a.half, split, parts, a.silu, a.xfrag, a.in_x);
  plan[0] = pl.nt;
  plan[1] = pl.x;
  plan[2] = pl.nt ? (int)gv_bytes(pl.nt, gv_rows(a.half, split), parts, pl.x) : 0;
}

// Needs 1 <= M <= 32, group % 16 == 0, half % group == 0, OUT % 8 == 0,
// 1 <= split <= 16, and a head dim of 32, 64 or 128 dividing 128 with RoPE.
// P is the activation's bf16 parts (1: bf16 x as it is, in_x % 8 == 0; 2:
// an fp32 activation with bf16 outputs; 3: the fp32 route).
template <typename TIn, typename TOut, int P>
cudaError_t launch_gemv(const GemvArgs& a, int split, cudaStream_t stream) {
  if (a.M <= 0 || a.M > 32 || a.group <= 0 || a.group % GV_UNIT != 0 || a.half <= 0 ||
      a.half % a.group != 0 || a.OUT <= 0 || a.OUT % 8 != 0 || split < 1 ||
      split > GV_MAX_SPLIT)
    return cudaErrorInvalidValue;
  if (P == 1 && a.in_x % 8 != 0) return cudaErrorInvalidValue;  // x's rows ride the ring
  GemvArgs b = a;
  if (a.rope_cols <= 0) {
    b.rope_dim = 0;
    b.qk_cols = 0;
  } else if (a.rope_dim != 32 && a.rope_dim != 64 && a.rope_dim != 128) {
    return cudaErrorInvalidValue;
  }
  const GvPlan pl = gv_plan(a.M, a.half, split, P, a.silu, a.xfrag, a.in_x);
  if constexpr (P == 1) {
    switch (pl.nt) {
      case 4: return launch_gemv_nt<TIn, TOut, 4, 1, 0>(b, split, stream);
      case 2: return launch_gemv_nt<TIn, TOut, 2, 1, 0>(b, split, stream);
      case 1: return launch_gemv_nt<TIn, TOut, 1, 1, 0>(b, split, stream);
    }
  } else if (pl.x == 2) {
    if (pl.nt == 2) return launch_gemv_nt<TIn, TOut, 2, P, 2>(b, split, stream);
    return launch_gemv_nt<TIn, TOut, 1, P, 2>(b, split, stream);
  } else {
    switch (pl.nt) {
      case 4: return launch_gemv_nt<TIn, TOut, 4, P, 1>(b, split, stream);
      case 2: return launch_gemv_nt<TIn, TOut, 2, P, 1>(b, split, stream);
      case 1: return launch_gemv_nt<TIn, TOut, 1, P, 1>(b, split, stream);
    }
  }
  return cudaErrorInvalidValue;
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

}  // namespace
}  // namespace tg
