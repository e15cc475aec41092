// Gathered-expert matmuls of the MoE decode step: out[r] = x[r] @ W[layer,
// idx[r]] for rows r < R, with x [R, in_x] (bf16 or fp32), idx [R] int32,
// fp32 accumulation and one rounding to x's type.
//
// Replaces the TPU kernels tinygpt_tpu/ops/moe_kernels.py::
// moe_gather_matmul (K12, _kernel; bf16 or fp32 stacks [L, E, IN, OUT]),
// moe_gather_matmul_int8 (K11a, _int8_kernel_moe; int8 [L, E, IN, OUT] and
// fp32 scales [L, E, IN/group, OUT]) and moe_gather_matmul_int4 (K11b,
// _int4_kernel_moe; biased, half-split packed int4 [L, E, IN/2, OUT] with the
// same scales). The layer and the expert are pointer offsets into the stack:
// no expert's bytes are copied or gathered.
//
// Bound on an H100 by the bytes of the experts the rows are routed to (a
// decode step of 4 to 16 tokens, 2 experts each, does 2 to 32 operations a
// weight): each DISTINCT routed expert's bytes should be read once. The TPU
// kernel runs one grid row per routed row and so re-reads an expert for
// every row routed to it. Here the blocks are expert-major: grid z is the
// expert e, a block owns a column tile of W[layer, e], and it accumulates
// the rows routed to e, found from idx by warp 0 (a ballot scan in row
// order; the host never reads idx). A block whose expert no row names reads
// nothing and exits. Expert ids outside [0, E) are clamped, as the plain
// version clamps them.
//
// K12 on a bf16 stack (moe_gather_tc_kernel): the products on the tensor
// cores.
// - mma.sync m16n8k16 with the weight as the A operand (16 output columns
//   x 16 weight rows, from shared memory by ldmatrix.trans) and the routed
//   rows as B, NT n-tiles of 8 rows a pass: those of R (up to 64 rows at
//   NT = 8), fewer where their staged activations would keep a second
//   block off the SM, but never fewer than 32 rows (or R): up to 32 rows
//   an expert, however the rows fall, no weight byte is read twice; an
//   expert with more rows than a pass takes further passes. bf16 x goes in
//   as it is; fp32 x in two bf16 parts (x = hi + lo, within 2^-16 of x:
//   well inside the fp32 tolerance, see tests/test_torch_moe_tiling.py),
//   fp32 sums.
// - A block is 4 warps and owns 128 columns: 2 column warps of 64 x 2 k
//   warps. Each warp streams its 16-row chunks (2 KB) through its own
//   cp.async ring of TC_NS slots, TC_NS - 1 chunks in flight, ordered by
//   cp.async.wait_group and __syncwarp: no block barrier while the weight
//   streams. The block stages its rows' activations (its share of IN, as
//   bf16 parts) once a pass, while the ring's first chunks are in flight.
// - A planned split: the SK blocks of a thread-block cluster split IN in
//   16-row units, SK planned on the host (ops/moe_kernels.moe_gather_split)
//   from R, E, IN, OUT, the parts, the SM count and what a launch takes at
//   each split (tg_moe_gather_plan) so that an expert's rows take the
//   fewest passes, the cluster stays portable, a pass of more than 8 rows
//   keeps two blocks an SM, and the live experts' blocks fill the card.
//   The block sums its k warps through shared memory; the cluster
//   then reduce-scatters through distributed shared memory: each rank sums
//   its share of the (row, 4-column) units over the SK tiles and writes
//   them.
//
// fp32 stacks, and K11a and K11b (moe_gather_kernel), stream on the CUDA
// cores: each warp reads RP contiguous rows of 256 columns at a time (8
// columns a lane: 32 bytes of fp32, 8 of int8 or of packed int4),
// dequantizes in registers (q * s and (u - 8) * s rounded once, exactly the
// plain version's fp32 weight) and takes the MR activation rows from
// shared memory as broadcasts. Rows are taken MR at a time (4 for R <= 8,
// else 8): for each group of MR rows the block streams its tile of the
// expert once. The block's 8 warps, and a cluster of 8 blocks where the
// experts' column tiles are few, split the expert's rows in RP-row steps;
// the block sums its warps through shared memory, and block 0 of the
// cluster sums the blocks' tiles through distributed shared memory and
// writes the rows. int4 x columns at and past in_x read as zeros, so a
// stack whose IN was row-padded at quantize time takes the unpadded x (the
// pad rows are zeros in the weight too).

#include "int4_common.cuh"

namespace {

using tg::from_float;
using tg::gv_commit;
using tg::gv_copy;
using tg::gv_mma;
using tg::gv_part;
using tg::gv_wait;
using tg::ldsm_x4;
using tg::to_float;

constexpr int NT = 256, NW = NT / 32;
constexpr int BN = 256;  // columns of a block: 8 a lane
// Blocks of a cluster, splitting an expert's rows: 8 when the column tiles
// of the experts are few (down: 16 tiles x 8 experts), 1 when they fill the
// card alone (gate_up: 112 x 8), where the split's reduction would cost as
// much as the block's share of the rows.
constexpr int SK_SPLIT = 8;
constexpr int MANY_BLOCKS = 4 * 132;

enum WKind : int { kInt8W = 1, kInt4W = 2, kF32W = 3 };

struct MoeArgs {
  const void* x;      // [R, in_x]
  const void* w;      // the stack's data: [L, E, rows, OUT]
  const float* sc;    // [L, E, IN / group, OUT], null for float weights
  const int* idx;     // [R]
  void* out;          // [R, OUT]
  int R, in_x, rows, OUT, E, group, layer;
};

template <int WK>
struct WTraits {
  static constexpr bool FLOAT = WK == kF32W;  // no scales, no groups
  static constexpr int RP = FLOAT ? 8 : 16;  // rows a warp has in flight
  static constexpr int PLANES = (WK == kInt4W) ? 2 : 1;
  static constexpr int ESIZE = WK == kF32W ? 4 : 1;  // bytes an element
  static constexpr int CH = NW * RP;                    // stored rows staged at a time
};

template <int WK, int MR>
constexpr size_t moe_smem_bytes() {
  using W = WTraits<WK>;
  return sizeof(float) * (MR * W::PLANES * W::CH + NW * MR * BN + MR * BN);
}

// 8 weights of stored row `r` at this lane's 8 columns, dequantized in fp32:
// wl the row (fp32, int8) or its low nibbles (int4), wh the high nibbles.
template <int WK>
struct RowLoad;

template <>
struct RowLoad<kF32W> {
  uint4 v[2];
  __device__ __forceinline__ void load(const unsigned char* p) {
    v[0] = __ldg(reinterpret_cast<const uint4*>(p));
    v[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  }
  __device__ __forceinline__ void dq(const float*, const float*, float* wl, float*) const {
    const float* e = reinterpret_cast<const float*>(v);
#pragma unroll
    for (int j = 0; j < 8; ++j) wl[j] = e[j];
  }
};

template <>
struct RowLoad<kInt8W> {
  uint2 v;
  __device__ __forceinline__ void load(const unsigned char* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void dq(const float* s, const float*, float* wl, float*) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wl[j] = static_cast<float>(
                  static_cast<int8_t>(((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xFFu)) *
              s[j];
  }
};

template <>
struct RowLoad<kInt4W> {
  uint2 v;
  __device__ __forceinline__ void load(const unsigned char* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void dq(const float* sl, const float* sh, float* wl,
                                     float* wh) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t b = ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xFFu;
      wl[j] = tg::dq(b & 0x0Fu, sl[j]);
      wh[j] = tg::dq(b >> 4, sh[j]);
    }
  }
};

__device__ __forceinline__ void load8(const float* p, float* s) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

template <typename T, int WK, int MR, int SK>
__global__ void __cluster_dims__(1, SK, 1) __launch_bounds__(NT)
    moe_gather_kernel(MoeArgs a) {
  using W = WTraits<WK>;
  constexpr int RP = W::RP, CH = W::CH, P = W::PLANES;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* xs = smem;                  // [MR][P][CH] staged activations
  float* red = xs + MR * P * CH;     // [NW][MR][BN] the warps' partial sums
  float* tile = red + NW * MR * BN;  // [MR][BN] this block's partial sums
  __shared__ int s_rows[MR];         // the rows of this group, routed to e
  __shared__ int s_n, s_next;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.z;
  const int col0 = blockIdx.x * BN;
  const int col = col0 + lane * 8;
  const bool col_ok = col < a.OUT;
  const int rows = a.rows;                    // stored rows (IN, or IN/2 packed)
  const int IN = rows * (WK == kInt4W ? 2 : 1);
  const int nstep = (rows + RP - 1) / RP;     // RP-row steps, split over the cluster
  const int r0 = (int)((long long)blockIdx.y * nstep / SK) * RP;
  const int r1 = min((int)((long long)(blockIdx.y + 1) * nstep / SK) * RP, rows);
  const size_t slab = (size_t)a.layer * a.E + e;
  const unsigned char* Wb =
      static_cast<const unsigned char*>(a.w) + slab * rows * a.OUT * W::ESIZE;
  const float* Sc = a.sc == nullptr ? nullptr : a.sc + slab * (IN / a.group) * a.OUT;
  const T* x = static_cast<const T*>(a.x);

  int next = 0;  // the first row not yet looked at
  for (;;) {
    if (warp == 0) {  // the next MR rows routed to e, in row order
      int n = 0, c = next;
      while (c < a.R && n < MR) {
        const int i = c + lane;
        const bool hit = i < a.R && min(max(a.idx[i], 0), a.E - 1) == e;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        const int before = __popc(m & ((1u << lane) - 1u));
        if (hit && n + before < MR) s_rows[n + before] = i;
        const int total = __popc(m);
        if (n + total > MR) {  // stop after the hit that fills the group
          unsigned mm = m;
          for (int t = 1; t < MR - n; ++t) mm &= mm - 1u;
          c += __ffs(mm);
          n = MR;
        } else {
          n += total;
          c += 32;
        }
      }
      if (lane == 0) {
        s_n = n;
        s_next = min(c, a.R);
      }
    }
    __syncthreads();
    const int n = s_n;
    next = s_next;
    if (n == 0) break;  // the same in every block of the cluster (same e, same idx)

    float acc[MR][8];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

    for (int c0 = r0; c0 < r1; c0 += CH) {
      __syncthreads();
      for (int i = tid; i < MR * P * CH; i += NT) {
        const int m = i / (P * CH);
        const int plane = (i / CH) % P;
        const int c = c0 + i % CH;
        const int xc = plane * rows + c;  // the x column of stored row c
        float v = 0.f;
        if (m < n && c < r1 && xc < a.in_x) v = to_float<T>(x[(size_t)s_rows[m] * a.in_x + xc]);
        xs[i] = v;
      }
      __syncthreads();
      const int p0 = c0 + warp * RP;
      if (col_ok && p0 < r1) {
        // the warp's RP rows lie inside one group (group % 16 == 0)
        float s_lo[8] = {}, s_hi[8] = {};
        if constexpr (!W::FLOAT) load8(Sc + (size_t)(p0 / a.group) * a.OUT + col, s_lo);
        if constexpr (WK == kInt4W)
          load8(Sc + (size_t)((rows + p0) / a.group) * a.OUT + col, s_hi);
        RowLoad<WK> w[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          if (!W::FLOAT || p0 + r < r1)  // a float stack's last step may be short
            w[r].load(Wb + ((size_t)(p0 + r) * a.OUT + col) * W::ESIZE);
          else
            w[r] = RowLoad<WK>{};
        }
        const float* xw = xs + (p0 - c0);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          float wl[8], wh[8];
          w[r].dq(s_lo, s_hi, wl, wh);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xl = xw[(m * P) * CH + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xl, wl[j], acc[m][j]);
            if constexpr (WK == kInt4W) {
              const float xh = xw[(m * P + 1) * CH + r];
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xh, wh[j], acc[m][j]);
            }
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
    for (int i = tid; i < MR * BN; i += NT) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) s += red[q * MR * BN + i];
      tile[i] = s;
    }
    cluster.sync();
    if (cluster.block_rank() == 0) {
      T* out = static_cast<T*>(a.out);
      for (int i = tid; i < MR * BN; i += NT) {
        const int m = i / BN, c = col0 + i % BN;
        if (m >= n || c >= a.OUT) continue;
        float s = 0.f;
        for (int q = 0; q < SK; ++q) s += cluster.map_shared_rank(tile, q)[i];
        out[(size_t)s_rows[m] * a.OUT + c] = from_float<T>(s);
      }
    }
    cluster.sync();  // every tile (and s_rows) stays as it is until block 0 has read it
  }
}

template <typename T, int WK, int MR, int SK>
cudaError_t launch_sk(const MoeArgs& a, cudaStream_t stream) {
  constexpr size_t smem = moe_smem_bytes<WK, MR>();
  static const cudaError_t attr = tg::allow_smem(moe_gather_kernel<T, WK, MR, SK>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.OUT + BN - 1) / BN, SK, a.E);
  moe_gather_kernel<T, WK, MR, SK><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int WK, int MR>
cudaError_t launch_mr(const MoeArgs& a, cudaStream_t stream) {
  if ((long long)((a.OUT + BN - 1) / BN) * a.E >= MANY_BLOCKS)
    return launch_sk<T, WK, MR, 1>(a, stream);
  return launch_sk<T, WK, MR, SK_SPLIT>(a, stream);
}

template <int WK>
cudaError_t launch(const MoeArgs& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case tg::kF32:
      return a.R <= 8 ? launch_mr<float, WK, 4>(a, stream) : launch_mr<float, WK, 8>(a, stream);
    case tg::kBF16:
      return a.R <= 8 ? launch_mr<__nv_bfloat16, WK, 4>(a, stream)
                      : launch_mr<__nv_bfloat16, WK, 8>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// -- K12 on bf16 stacks: the tensor-core body ---------------------------------------

constexpr int TC_COLS = 128;                       // columns of a block
constexpr int TC_WARPS = 4;                        // 2 column warps x 2 k warps
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_UNIT = 16;                        // weight rows of a chunk and of the split's unit
constexpr int TC_NS = 5;                           // ring slots a warp: 4 chunks in flight
constexpr int TC_SLOT = TC_UNIT * 64 * 2;          // a chunk: 16 rows x 64 bf16 columns
constexpr int TC_RING = TC_WARPS * TC_NS * TC_SLOT;  // 40 KB
constexpr int TC_PITCH = TC_COLS + 4;  // floats a row of the block's sums (spreads the banks)
constexpr int TC_XSOFT = 112640 - TC_RING;  // staged activation bytes at which two blocks fit an SM
constexpr int TC_SMEM_MAX = 231424;    // dynamic shared memory a block may take (227 KB less
                                       // 1 KB for its static shared memory)
constexpr int TC_MAX_SPLIT = 16;       // blocks of a cluster (above 8: non-portable)
static_assert(64 * TC_PITCH * 4 <= TC_RING, "the sums of 64 rows fit the rings' memory");

// The weight rows of the largest rank's share at split SK (16-row units).
inline int tc_nk(int IN, int split) {
  return ((IN + TC_UNIT - 1) / TC_UNIT + split - 1) / split * TC_UNIT;
}

// Bytes of a block's staged activations: `parts` bf16 parts x 8 nt rows x
// nk columns, a row padded by 16 bytes (its ldmatrix rows then fall on
// distinct banks).
inline size_t tc_xbytes(int nt, int parts, int nk) {
  return (size_t)parts * 8 * nt * (2 * nk + 16);
}

// What a launch at split SK takes (tg_moe_gather_plan exports it): the
// n-tiles of 8 rows a pass, those of R (1 for R <= 8, 2 <= 16, 4 <= 32,
// else 8), halved while the staged activations exceed TC_XSOFT but never
// below those of min(R, 32): an expert's first 32 rows are always one
// pass, however the rows fall on the experts. 0 where those do not fit the
// block's shared memory (the split is too small for these rows). And the
// block's dynamic shared memory.
inline int tc_ntiles(int R, int parts, int IN, int split) {
  int nt = R <= 8 ? 1 : R <= 16 ? 2 : R <= 32 ? 4 : 8;
  const int least = nt < 4 ? nt : 4;
  const int nk = tc_nk(IN, split);
  while (nt > least && tc_xbytes(nt, parts, nk) > TC_XSOFT) nt /= 2;
  return TC_RING + tc_xbytes(nt, parts, nk) <= TC_SMEM_MAX ? nt : 0;
}

inline size_t tc_smem(int nt, int parts, int IN, int split) {
  return TC_RING + tc_xbytes(nt, parts, tc_nk(IN, split));
}

// Four 8x8 bf16 matrices, transposed, from shared memory into mma
// fragments: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two 8x8 bf16 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// Warp 0: the next (up to) MR rows routed to expert e from row `next` on,
// in row order, into s_rows; their count into s_n and the row after the
// last one looked at into s_next. The ids of SCAN 32-row chunks are loaded
// at once: one round trip for every 128 rows.
template <int MR>
__device__ __forceinline__ void scan_rows(const MoeArgs& a, int e, int next, int lane, int* s_rows,
                                          int* s_n, int* s_next) {
  constexpr int SCAN = 4;
  int n = 0, c = next;
  while (c < a.R && n < MR) {
    int ids[SCAN];
#pragma unroll
    for (int k = 0; k < SCAN; ++k) {
      const int i = c + 32 * k + lane;
      ids[k] = i < a.R ? min(max(__ldg(a.idx + i), 0), a.E - 1) : -1;
    }
#pragma unroll
    for (int k = 0; k < SCAN; ++k) {
      if (c >= a.R || n >= MR) break;
      const bool hit = ids[k] == e;  // row c + lane
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      const int before = __popc(m & ((1u << lane) - 1u));
      if (hit && n + before < MR) s_rows[n + before] = c + lane;
      const int total = __popc(m);
      if (n + total > MR) {  // stop after the hit that fills the group
        unsigned mm = m;
        for (int t = 1; t < MR - n; ++t) mm &= mm - 1u;
        c += __ffs(mm);
        n = MR;
      } else {
        n += total;
        c += 32;
      }
    }
  }
  if (lane == 0) {
    *s_n = n;
    *s_next = min(c, a.R);
  }
}

template <typename T, int NT, int P>
__global__ void __launch_bounds__(TC_THREADS) moe_gather_tc_kernel(const MoeArgs a) {
  constexpr int NR = 8 * NT;  // rows of a pass
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char tc_smem_base[];
  unsigned char* smem = tc_smem_base;
  unsigned char* xs = smem + TC_RING;           // [P][NR][nk] bf16, rows of xp bytes
  float* red = reinterpret_cast<float*>(smem);  // [NR][TC_PITCH], after the walk
  __shared__ int s_rows[NR];
  __shared__ int s_n, s_next;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp % 2, wk = warp / 2;
  const int e = blockIdx.z;
  const int col0 = (blockIdx.x / C) * TC_COLS;
  const int wcol = col0 + wc * 64;  // the warp's first column
  const int IN = a.rows, OUT = a.OUT;
  // the block's weight rows [k0, k0 + nk), and the warp's n_st chunks from
  // its unit wu0 of them
  const int n16 = (IN + TC_UNIT - 1) / TC_UNIT;
  const int u0 = (int)((long long)rank * n16 / C);
  const int nu = (int)((long long)(rank + 1) * n16 / C) - u0;
  const int k0 = u0 * TC_UNIT, nk = nu * TC_UNIT;
  const int xp = 2 * nk + 16;  // bytes of a staged row
  const int wu0 = wk * nu / 2;
  const int n_st = (wk + 1) * nu / 2 - wu0;
  const unsigned char* Wb = static_cast<const unsigned char*>(a.w) +
                            ((size_t)a.layer * a.E + e) * IN * OUT * 2;
  const T* x = static_cast<const T*>(a.x);
  const bool raw = sizeof(T) == 2 && a.in_x % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;  // bf16 x copied as it is
  unsigned char* ring = smem + warp * TC_NS * TC_SLOT;

  // chunk i of the warp's rows into ring slot `slot`: 16 rows of 64
  // columns, 16-byte unit u of row r at unit u ^ (r % 8) of the row (the
  // eight rows an ldmatrix reads fall on distinct banks); rows past IN and
  // columns past OUT are zeros
  auto issue = [&](int i, int slot) {
    const int r = k0 + (wu0 + i) * TC_UNIT;
    unsigned char* dst = ring + slot * TC_SLOT;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = lane + 32 * k, row = q / 8, u = q % 8;
      const int c = wcol + 8 * u;
      const bool ok = r + row < IN && c < OUT;
      gv_copy<16>(dst + (row * 8 + (u ^ (row & 7))) * 16,
                  ok ? Wb + ((size_t)(r + row) * OUT + c) * 2 : Wb, ok);
    }
  };

  int next = 0;  // the first row not yet looked at
  for (;;) {
    if (warp == 0) scan_rows<NR>(a, e, next, lane, s_rows, &s_n, &s_next);
    __syncthreads();
    const int n = s_n;
    next = s_next;
    if (n == 0) break;  // the same in every block of the cluster (same e, same idx)

    // the pass's activations at the block's rows, and the ring's first
    // chunks: bf16 x by cp.async ahead of the ring, else after it, through
    // registers, split into P bf16 parts
    const int n8 = nk / 8;  // octets of a staged row
    if (raw) {
      for (int q = tid; q < n * n8; q += TC_THREADS) {
        const int m = q / n8, c = k0 + 8 * (q % n8);
        const bool ok = c < a.in_x;
        gv_copy<16>(xs + m * xp + (q % n8) * 16, ok ? x + (size_t)s_rows[m] * a.in_x + c : x, ok);
      }
      gv_commit();
    }
#pragma unroll
    for (int p = 0; p < TC_NS - 1; ++p) {
      if (p < n_st) issue(p, p);
      gv_commit();
    }
    if (raw) {
      gv_wait<TC_NS - 1>();  // this thread's activation copies
    } else {
      for (int q = tid; q < n * n8; q += TC_THREADS) {
        const int m = q / n8, c = k0 + 8 * (q % n8);
        const T* src = x + (size_t)s_rows[m] * a.in_x;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = c + j < a.in_x ? to_float<T>(src[c + j]) : 0.f;
#pragma unroll
        for (int part = 0; part < P; ++part) {
          const uint2 lo = gv_part(v), hi = gv_part(v + 4);
          *reinterpret_cast<uint4*>(xs + (size_t)(part * NR + m) * xp + (q % n8) * 16) =
              make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    }
    __syncthreads();

    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

    for (int i = 0; i < n_st; ++i) {
      gv_wait<TC_NS - 2>();  // this lane's copies of chunk i
      __syncwarp();          // ... and every lane's; the warp is done with slot i - 1
      if (i + TC_NS - 1 < n_st) issue(i + TC_NS - 1, (i + TC_NS - 1) % TC_NS);
      gv_commit();
      const unsigned char* sl = ring + (i % TC_NS) * TC_SLOT;
      // A: the 4 m-tiles of 16 columns; matrix l / 8 of lane l is rows
      // 8 (l / 16) .. + 7 and columns 8 (l / 8 % 2) .. + 7 of the m-tile
      uint32_t af[4][4];
      const int arow = lane % 8 + 8 * (lane / 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int u = 2 * mt + (lane / 8) % 2;
        ldsm_x4_trans(af[mt], sl + (arow * 8 + (u ^ (arow & 7))) * 16);
      }
      // B: rows of the pass at the chunk's 16 columns of x
      const unsigned char* xb = xs + (wu0 + i) * TC_UNIT * 2 + ((lane / 8) % 2) * 16;
#pragma unroll
      for (int part = 0; part < P; ++part) {
        const unsigned char* xpart = xb + (size_t)part * NR * xp;
        if constexpr (NT == 1) {
          uint32_t b[2];
          ldsm_x2(b, xpart + (lane % 8) * xp);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) gv_mma(acc[mt][0], af[mt], b);
        } else {
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj) {
            if (16 * jj >= n) break;  // n-tiles past the pass's rows
            uint32_t b[4];
            ldsm_x4(b, xpart + (16 * jj + 8 * (lane / 16) + lane % 8) * xp);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              gv_mma(acc[mt][2 * jj], af[mt], b);
              gv_mma(acc[mt][2 * jj + 1], af[mt], b + 2);
            }
          }
        }
      }
    }
    gv_wait<0>();
    __syncthreads();  // every warp is done with its ring: its memory holds the sums now

    // acc[mt][j]: columns wc * 64 + 16 mt + g (+ 8 for q >= 2) of rows
    // 8 j + 2 t (+ 1 for odd q); the k warps' sums meet in red
    auto at = [&](int mt, int j, int q) {
      return (8 * j + 2 * t + (q & 1)) * TC_PITCH + wc * 64 + 16 * mt + g + 8 * (q >> 1);
    };
    if (wk == 1) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) red[at(mt, j, q)] = acc[mt][j][q];
    }
    __syncthreads();
    T* out = static_cast<T*>(a.out);
    if (wk == 0) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = acc[mt][j][q] + red[at(mt, j, q)];
            if (C > 1) {
              red[at(mt, j, q)] = v;
            } else {
              const int m = 8 * j + 2 * t + (q & 1), c = wcol + 16 * mt + g + 8 * (q >> 1);
              if (m < n && c < OUT) out[(size_t)s_rows[m] * OUT + c] = from_float<T>(v);
            }
          }
    }
    if (C > 1) {
      // reduce-scatter: rank r sums its share of the pass's (row, 4-column)
      // units over the C blocks' sums and writes them
      cluster.sync();
      const int units = n * (TC_COLS / 4);
      for (int q = rank * units / C + tid; q < (rank + 1) * units / C; q += TC_THREADS) {
        const int m = q / (TC_COLS / 4), c4 = 4 * (q % (TC_COLS / 4));
        if (col0 + c4 >= OUT) continue;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < C; ++r) {
          const float4 v =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + m * TC_PITCH + c4);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        T* o = out + (size_t)s_rows[m] * OUT + col0 + c4;
        o[0] = from_float<T>(s.x);
        o[1] = from_float<T>(s.y);
        o[2] = from_float<T>(s.z);
        o[3] = from_float<T>(s.w);
      }
      cluster.sync();  // every block's sums stay until the cluster has read them
    } else {
      __syncthreads();  // s_rows and red stay until the block has written its rows
    }
  }
}

template <typename T, int NT, int P>
cudaError_t launch_tc(const MoeArgs& a, int split, cudaStream_t stream) {
  auto kernel = moe_gather_tc_kernel<T, NT, P>;
  const size_t smem = tc_smem(NT, P, a.rows, split);
  static const cudaError_t attr = [kernel] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.OUT + TC_COLS - 1) / TC_COLS * split, 1, a.E);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
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

// x of `dtype` (bf16 in one part, fp32 in two) at split `split`.
template <typename T, int P>
cudaError_t launch_tc_nt(const MoeArgs& a, int split, cudaStream_t stream) {
  switch (tc_ntiles(a.R, P, a.rows, split)) {
    case 1: return launch_tc<T, 1, P>(a, split, stream);
    case 2: return launch_tc<T, 2, P>(a, split, stream);
    case 4: return launch_tc<T, 4, P>(a, split, stream);
    case 8: return launch_tc<T, 8, P>(a, split, stream);
  }
  return cudaErrorInvalidValue;
}

MoeArgs args(const void* x, const void* w, const void* scales, const void* idx, void* out, int R,
             int in_x, int rows, int OUT, int E, int group, int layer) {
  MoeArgs a{};
  a.x = x;
  a.w = w;
  a.sc = static_cast<const float*>(scales);
  a.idx = static_cast<const int*>(idx);
  a.out = out;
  a.R = R;
  a.in_x = in_x;
  a.rows = rows;
  a.OUT = OUT;
  a.E = E;
  a.group = group;
  a.layer = layer;
  return a;
}

bool bad_common(int R, int in_x, int rows, int OUT, int E, int layer) {
  return R <= 0 || in_x <= 0 || rows <= 0 || OUT <= 0 || OUT % 8 || E <= 0 || E > 65535 ||
         layer < 0;
}

}  // namespace

extern "C" {

// K12: out [R, OUT] = x [R, IN] @ w[layer, idx[r]] of a float stack [L, E,
// IN, OUT] (wdtype code 2: bf16, 0: fp32), in x's type (dtype code: 0 fp32,
// 2 bf16). Needs OUT % 8 == 0. A bf16 stack runs on the tensor cores, on
// clusters of `split` blocks (1 to 16) that split IN; an fp32 stack ignores
// `split`. Returns the cudaError_t of the launch.
int tg_moe_gather_float(const void* x, const void* w, const void* idx, void* out, int R,
                        int IN, int OUT, int E, int layer, int dtype, int wdtype, int split,
                        void* stream) {
  if (bad_common(R, IN, IN, OUT, E, layer)) return cudaErrorInvalidValue;
  const MoeArgs a = args(x, w, nullptr, idx, out, R, IN, IN, OUT, E, 0, layer);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wdtype == tg::kF32) return launch<kF32W>(a, dtype, s);
  if (wdtype != tg::kBF16 || split < 1 || split > TC_MAX_SPLIT) return cudaErrorInvalidValue;
  switch (dtype) {
    case tg::kF32: return launch_tc_nt<float, 2>(a, split, s);
    case tg::kBF16: return launch_tc_nt<__nv_bfloat16, 1>(a, split, s);
  }
  return cudaErrorInvalidValue;
}

// What tg_moe_gather_float launches on a bf16 stack at split `split` for R
// rows of x of `dtype` and IN: out[0] the n-tiles of 8 rows a pass (0 where
// the activations fit no block), out[1] a block's dynamic shared memory
// (bytes). Returns the cudaError_t (0 on success).
int tg_moe_gather_plan(int R, int IN, int dtype, int split, int* out) {
  if (R <= 0 || IN <= 0 || split < 1 || split > TC_MAX_SPLIT ||
      (dtype != tg::kF32 && dtype != tg::kBF16))
    return cudaErrorInvalidValue;
  const int parts = dtype == tg::kF32 ? 2 : 1;
  const int nt = tc_ntiles(R, parts, IN, split);
  out[0] = nt;
  out[1] = nt ? (int)tc_smem(nt, parts, IN, split) : 0;
  return cudaSuccess;
}

// K11a: the same for int8 data [L, E, IN, OUT] with fp32 scales [L, E,
// IN/group, OUT]. Needs group % 16 == 0, IN % group == 0, OUT % 8 == 0.
int tg_moe_gather_int8(const void* x, const void* data, const void* scales, const void* idx,
                       void* out, int R, int IN, int OUT, int E, int group, int layer, int dtype,
                       void* stream) {
  if (bad_common(R, IN, IN, OUT, E, layer) || group <= 0 || group % 16 || IN % group)
    return cudaErrorInvalidValue;
  return launch<kInt8W>(args(x, data, scales, idx, out, R, IN, IN, OUT, E, group, layer),
                        dtype, static_cast<cudaStream_t>(stream));
}

// K11b: the same for packed int4 data [L, E, IN/2, OUT] (biased nibbles, row
// p and row IN/2 + p in one byte) with fp32 scales [L, E, IN/group, OUT];
// x [R, in_x] with in_x <= IN (the columns past in_x are the zero pad rows of
// a row-padded stack). Needs group % 16 == 0, (IN/2) % group == 0,
// OUT % 8 == 0.
int tg_moe_gather_int4(const void* x, const void* data, const void* scales, const void* idx,
                       void* out, int R, int in_x, int IN, int OUT, int E, int group, int layer,
                       int dtype, void* stream) {
  const int half = IN / 2;
  if (bad_common(R, in_x, half, OUT, E, layer) || IN % 2 || in_x > IN || group <= 0 ||
      group % 16 || half % group)
    return cudaErrorInvalidValue;
  return launch<kInt4W>(args(x, data, scales, idx, out, R, in_x, half, OUT, E, group, layer),
                        dtype, static_cast<cudaStream_t>(stream));
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
