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
// K11a and K11b (moe_gather_q_kernel): K12's body on quantized stacks.
// - The weight is mma.sync's A operand read straight from the ring into
//   registers, as the int4 GEMV reads it (int4_common.cuh): the 16 k slots
//   of a thread's fragments are stored rows 4t .. 4t + 3 of a chunk (t its
//   quad position), so its activations are 4 consecutive values, one 8-byte
//   load from the staged rows. A nibble becomes the exact bf16 u - 8
//   (gv_nibbles: a byte permute, a LOP3 under the exponent of 128, a bf16x2
//   subtraction); an int8 byte q the exact bf16 q (bf16 has 8 significant
//   bits): one byte permute under the float exponent of 2^23 (the float
//   2^23 + q + 128, the byte biased by an XOR), one subtraction, and a
//   permute that packs two floats' high halves. No dequantized weight is
//   rounded: each warp sums x * (u - 8) (or x * q) per group and nibble
//   plane in fp32, and multiplies each group's sums by the group's scale
//   once a column and row, after the group's last chunk or the warp's last
//   chunk where the split cuts a group; the scale rows are read a group
//   ahead into registers.
// - A 16-row chunk of int4 is two k-steps (the low plane at x columns p,
//   the high plane at IN/2 + p), of int8 one. A pass takes the rows of
//   min(R, 32) (NT n-tiles of 8), so an expert's first 32 rows are one
//   pass however the rows fall. A warp takes 128 / NT columns, so its
//   accumulators stay at 8 fragments beside the group sums (two sets for
//   int4, one for int8): at NT = 1 a 4-warp block of 128 columns splits its
//   rows over 4 k warps, at NT = 2 4 warps of 64 columns, at NT = 4 8 warps
//   of 32 (256 columns: the 32 staged rows serve twice the columns).
// - Above 8 rows a call is two launches: the experts that at most 8 rows
//   name run the NT = 1 blocks (a block tells from its first scan of idx
//   which launch its expert belongs to, and the other launch's blocks
//   exit), the others passes of R's n-tiles. A decode step's experts mostly
//   take few rows (16 rows over 8 experts), so a call of 32 rows streams
//   most of its experts at the 1-n-tile rate.
// - Each warp's cp.async ring is K12's, 5 stages of 2 KB, 4 in flight (a
//   stage 128 / W chunks of 16 rows x W bytes), each copy asking L2 for the
//   whole 128-byte line; the block's staged activations (the pass's rows
//   at its share of the stored rows, both planes for int4, as bf16 parts:
//   bf16 x as it is, fp32 x as hi + lo) sit after the rings, each row's
//   pitch an odd multiple of 32 bytes.
// - The split and its reduce-scatter are K12's (16-row units of the stored
//   rows), planned on the host (moe_gather_split) from what the library
//   reports a launch takes (tg_moe_gather_plan: n-tiles, shared memory and
//   the blocks an SM runs, registers counted).
//
// fp32 stacks (moe_gather_kernel) stream on the CUDA cores: each warp reads
// RP contiguous rows of 256 columns at a time (8 columns a lane) and takes
// the MR activation rows from shared memory as broadcasts. Rows are taken
// MR at a time (4 for R <= 8, else 8): for each group of MR rows the block
// streams its tile of the expert once. The block's 8 warps, and a cluster
// of 8 blocks where the experts' column tiles are few, split the expert's
// rows in RP-row steps; the block sums its warps through shared memory, and
// block 0 of the cluster sums the blocks' tiles through distributed shared
// memory and writes the rows.
//
// int4 x columns at and past in_x read as zeros, so a stack whose IN was
// row-padded at quantize time takes the unpadded x (the pad rows are zeros
// in the weight too).

#include "int4_common.cuh"

namespace {

using tg::from_float;
using tg::gv_commit;
using tg::gv_copy;
using tg::gv_mma;
using tg::gv_nibbles;
using tg::gv_offset;
using tg::gv_part;
using tg::gv_wait;
using tg::ldsm_x4;
using tg::to_float;

constexpr int NT = 256, NW = NT / 32;
constexpr int BN = 256;  // columns of a block: 8 a lane
constexpr int RP = 8;    // rows a warp has in flight
constexpr int CH = NW * RP;  // rows staged at a time
// Blocks of a cluster, splitting an expert's rows: 8 when the column tiles
// of the experts are few, 1 when they fill the card alone, where the
// split's reduction would cost as much as the block's share of the rows.
constexpr int SK_SPLIT = 8;
constexpr int MANY_BLOCKS = 4 * 132;

enum WKind : int { kInt8W = 1, kInt4W = 2 };

struct MoeArgs {
  const void* x;      // [R, in_x]
  const void* w;      // the stack's data: [L, E, rows, OUT]
  const float* sc;    // [L, E, IN / group, OUT], null for float weights
  const int* idx;     // [R]
  void* out;          // [R, OUT]
  int R, in_x, rows, OUT, E, group, layer;
};

template <int MR>
constexpr size_t moe_smem_bytes() {
  return sizeof(float) * (MR * CH + NW * MR * BN + MR * BN);
}

template <typename T, int MR, int SK>
__global__ void __cluster_dims__(1, SK, 1) __launch_bounds__(NT)
    moe_gather_kernel(MoeArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* xs = smem;                  // [MR][CH] staged activations
  float* red = xs + MR * CH;         // [NW][MR][BN] the warps' partial sums
  float* tile = red + NW * MR * BN;  // [MR][BN] this block's partial sums
  __shared__ int s_rows[MR];         // the rows of this group, routed to e
  __shared__ int s_n, s_next;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.z;
  const int col0 = blockIdx.x * BN;
  const int col = col0 + lane * 8;
  const bool col_ok = col < a.OUT;
  const int rows = a.rows;
  const int nstep = (rows + RP - 1) / RP;     // RP-row steps, split over the cluster
  const int r0 = (int)((long long)blockIdx.y * nstep / SK) * RP;
  const int r1 = min((int)((long long)(blockIdx.y + 1) * nstep / SK) * RP, rows);
  const float* Wf = static_cast<const float*>(a.w) + ((size_t)a.layer * a.E + e) * rows * a.OUT;
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
      for (int i = tid; i < MR * CH; i += NT) {
        const int m = i / CH, c = c0 + i % CH;
        xs[i] = m < n && c < r1 ? to_float<T>(x[(size_t)s_rows[m] * a.in_x + c]) : 0.f;
      }
      __syncthreads();
      const int p0 = c0 + warp * RP;
      if (col_ok && p0 < r1) {
        float4 w[RP][2];
#pragma unroll
        for (int r = 0; r < RP; ++r) {  // the last step may be short
          const float4* p = reinterpret_cast<const float4*>(Wf + (size_t)(p0 + r) * a.OUT + col);
          w[r][0] = p0 + r < r1 ? __ldg(p) : make_float4(0.f, 0.f, 0.f, 0.f);
          w[r][1] = p0 + r < r1 ? __ldg(p + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float* xw = xs + (p0 - c0);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float* wl = reinterpret_cast<const float*>(w[r]);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xl = xw[m * CH + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xl, wl[j], acc[m][j]);
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

template <typename T, int MR, int SK>
cudaError_t launch_sk(const MoeArgs& a, cudaStream_t stream) {
  constexpr size_t smem = moe_smem_bytes<MR>();
  static const cudaError_t attr = tg::allow_smem(moe_gather_kernel<T, MR, SK>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.OUT + BN - 1) / BN, SK, a.E);
  moe_gather_kernel<T, MR, SK><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int MR>
cudaError_t launch_mr(const MoeArgs& a, cudaStream_t stream) {
  if ((long long)((a.OUT + BN - 1) / BN) * a.E >= MANY_BLOCKS)
    return launch_sk<T, MR, 1>(a, stream);
  return launch_sk<T, MR, SK_SPLIT>(a, stream);
}

// An fp32 stack, x of `dtype`.
cudaError_t launch_f32(const MoeArgs& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case tg::kF32:
      return a.R <= 8 ? launch_mr<float, 4>(a, stream) : launch_mr<float, 8>(a, stream);
    case tg::kBF16:
      return a.R <= 8 ? launch_mr<__nv_bfloat16, 4>(a, stream)
                      : launch_mr<__nv_bfloat16, 8>(a, stream);
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

// The once-per-kernel attributes of a cluster launch: the block's dynamic
// shared memory up to TC_SMEM_MAX, clusters above 8 blocks.
template <typename Kernel>
cudaError_t allow_clusters(Kernel kernel) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// One launch of a tile kernel of `threads` threads: a block a tile of
// `cols` columns of an expert (grid z), clusters of `split` blocks along x.
template <typename... Args>
cudaError_t launch_tiles(void (*kernel)(MoeArgs, Args...), const MoeArgs& a, int cols,
                         int threads, int split, size_t smem, cudaStream_t stream, Args... more) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.OUT + cols - 1) / cols * split, 1, a.E);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, more...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int NT, int P>
cudaError_t launch_tc(const MoeArgs& a, int split, cudaStream_t stream) {
  static const cudaError_t attr = allow_clusters(moe_gather_tc_kernel<T, NT, P>);
  if (attr != cudaSuccess) return attr;
  return launch_tiles(moe_gather_tc_kernel<T, NT, P>, a, TC_COLS, TC_THREADS, split,
                      tc_smem(NT, P, a.rows, split), stream);
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

// -- K11a and K11b: the quantized stacks on the tensor cores ------------------------

constexpr int Q_UNIT = 16;     // stored rows of a chunk and of the split's unit
constexpr int Q_FEW = 8;       // rows of a pass of 1 n-tile
constexpr int Q_NS = 5;        // ring slots a warp: 4 stages in flight
constexpr int Q_STAGE = 2048;  // bytes of a stage

// A block at NT n-tiles of 8 rows a pass (1, 2 or 4): the weight kind's
// planes (k-steps a chunk); CW column warps of W = 128 / NT columns (a
// warp's accumulators and each set of group sums stay at 8 m-tile x n-tile
// fragments) and the rest k warps; 4 warps, 8 at NT = 4, whose 32 staged
// rows then serve 256 columns; a ring stage (2 KB) holds CPS consecutive
// chunks of a warp's rows.
inline constexpr int q_warps(int nt) { return nt == 4 ? 8 : 4; }
inline constexpr int q_ring(int nt) { return q_warps(nt) * Q_NS * Q_STAGE; }

template <int WK, int NT>
struct QShape {
  static constexpr int PL = WK == kInt4W ? 2 : 1;
  static constexpr int WARPS = q_warps(NT), THREADS = 32 * WARPS;
  static constexpr int W = NT == 1 ? 128 : NT == 2 ? 64 : 32;  // columns of a warp
  static constexpr int CW = NT == 1 ? 1 : NT == 2 ? 4 : 8;     // column warps
  static constexpr int COLS = CW * W;           // columns of a block
  static constexpr int PITCH = COLS + 4;        // floats a row of the block's sums
  static constexpr int KW = WARPS / CW;         // k warps
  static constexpr int CT = W / 16;             // 16-column mma tiles of a warp
  static constexpr int TB = W / 8;              // bytes of a stored row a thread converts
  static constexpr int CHUNK = Q_UNIT * W;      // bytes of a chunk
  static constexpr int CPS = Q_STAGE / CHUNK;   // chunks a stage
  static constexpr int RING = q_ring(NT);       // the warps' rings
  static_assert(KW * 8 * NT * PITCH * 4 <= RING, "the k warps' sums fit the rings");
};

// Stored rows of the largest rank's share at split `split` (16-row units).
inline int q_nk(int rows, int split) {
  return ((rows + Q_UNIT - 1) / Q_UNIT + split - 1) / split * Q_UNIT;
}

// Bytes of a staged row of nk bf16 values: an odd multiple of 32, so that
// the 8 rows of a B-fragment read fall on distinct banks.
__host__ __device__ inline int q_pitch(int nk) { return ((2 * nk) & ~63) + 32; }

// What a launch at split `split` takes (tg_moe_gather_plan exports it): a
// block's dynamic shared memory, the rings and the pass's rows as `parts`
// bf16 parts x `planes` planes x 8 nt rows, and the n-tiles a pass, those
// of min(R, 32) (1 for R <= 8, 2 <= 16, else 4); 0 where the staged rows
// do not fit a block.
inline size_t q_smem(int nt, int parts, int planes, int rows, int split) {
  return q_ring(nt) + (size_t)parts * planes * 8 * nt * q_pitch(q_nk(rows, split));
}

inline int q_ntiles(int R, int parts, int planes, int rows, int split) {
  const int nt = R <= 8 ? 1 : R <= 16 ? 2 : 4;
  return q_smem(nt, parts, planes, rows, split) <= TC_SMEM_MAX ? nt : 0;
}

// Bytes j0 of b0 and j1 of b1 (int8 weights biased by XOR 0x80) as the
// bf16 pair (q0, q1): a byte under the float exponent of 2^23 is the float
// 2^23 + q + 128; subtracting 2^23 + 128 leaves q exactly, and its high
// half is its exact bf16 (|q| <= 128 has at most 8 significant bits).
__device__ __forceinline__ uint32_t q8_pair(uint32_t b0, int j0, uint32_t b1, int j1) {
  const float f0 = __uint_as_float(__byte_perm(b0, 0x4B000000u, 0x7440u | j0)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(b1, 0x4B000000u, 0x7440u | j1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

// A 16-byte cp.async of the weight stream (zeros where !ok) that has L2
// fetch the whole 128-byte line, which the block's other warps read too.
__device__ __forceinline__ void q_copy16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// Warp 0: whether a row from `from` on names expert e.
__device__ __forceinline__ bool any_row(const MoeArgs& a, int e, int from, int lane) {
  for (int c = from; c < a.R; c += 32) {
    const int i = c + lane;
    if (__any_sync(0xffffffffu, i < a.R && min(max(__ldg(a.idx + i), 0), a.E - 1) == e))
      return true;
  }
  return false;
}

// cls 0: every expert; 1: only the experts that at most Q_FEW rows name;
// 2: only the others.
template <typename T, int WK, int NT, int P>
__global__ void __launch_bounds__(QShape<WK, NT>::THREADS)
    moe_gather_q_kernel(const MoeArgs a, const int cls) {
  using S = QShape<WK, NT>;
  constexpr int PL = S::PL, W = S::W, CT = S::CT, TB = S::TB, CW = S::CW, KW = S::KW,
                CPS = S::CPS, COLS = S::COLS, PITCH = S::PITCH, THREADS = S::THREADS;
  constexpr int D = Q_NS - 1;  // stages in flight
  constexpr int NR = 8 * NT;  // rows of a pass
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char q_smem_base[];
  unsigned char* smem = q_smem_base;
  unsigned char* xs = smem + S::RING;           // [P][PL][NR] rows of xp bytes, bf16
  float* red = reinterpret_cast<float*>(smem);  // [KW][NR][PITCH], after the walk
  __shared__ int s_rows[NR];
  __shared__ int s_n, s_next;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp % CW, wk = warp / CW;
  const int e = blockIdx.z;
  const int col0 = (blockIdx.x / C) * COLS;
  const int wcol = col0 + wc * W;  // the warp's first column
  const int rows = a.rows, OUT = a.OUT, group = a.group;
  // the block's stored rows [k0, k0 + nk), the warp's n_st chunks from r0
  const int n16 = rows / Q_UNIT;
  const int u0 = (int)((long long)rank * n16 / C);
  const int nu = (int)((long long)(rank + 1) * n16 / C) - u0;
  const int k0 = u0 * Q_UNIT, nk = nu * Q_UNIT;
  const int xp = q_pitch(nk);
  const int wu0 = wk * nu / KW;
  const int n_st = (wk + 1) * nu / KW - wu0;
  const int n_sg = (n_st + CPS - 1) / CPS;  // the warp's ring stages
  const int r0 = k0 + wu0 * Q_UNIT;
  const size_t slab = (size_t)a.layer * a.E + e;
  const unsigned char* Wb = static_cast<const unsigned char*>(a.w) + slab * rows * OUT;
  const float* Sc = a.sc + slab * (PL * rows / group) * OUT;
  const bool wide = OUT % 16 == 0;  // rows 16-byte aligned
  const T* x = static_cast<const T*>(a.x);
  const bool raw = P == 1 && sizeof(T) == 2 && a.in_x % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;  // bf16 x copied as it is
  unsigned char* ring = smem + warp * Q_NS * Q_STAGE;

  // stage sg of the warp's rows (its chunks sg CPS .. sg CPS + CPS - 1)
  // into ring slot `slot`, 128 units of 16 bytes: unit u of a chunk's row
  // r at gv_offset<W>(r, u) of the chunk, by one copy, or two of 8 bytes
  // where rows are only 8-byte aligned; columns past OUT are zeros
  auto issue = [&](int sg, int slot) {
    unsigned char* dst = ring + slot * Q_STAGE;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = lane + 32 * k, cc = q / W, row = (q % W) / (W / 16), u = q % (W / 16);
      const int i = sg * CPS + cc, c = wcol + 16 * u;
      if (i < n_st) {
        unsigned char* d = dst + cc * S::CHUNK + gv_offset<W>(row, u);
        const unsigned char* src = Wb + (size_t)(r0 + i * Q_UNIT + row) * OUT + c;
        if (wide) {
          q_copy16(d, c < OUT ? src : Wb, c < OUT);
        } else {
          gv_copy<8>(d, c < OUT ? src : Wb, c < OUT);
          gv_copy<8>(d + 8, c + 8 < OUT ? src + 8 : Wb, c + 8 < OUT);
        }
      }
    }
  };
  // the scales of stored row r's group at the thread's TB columns, each
  // plane (int4: the high plane's rows follow the low plane's)
  float sc[PL][TB];
  auto load_scales = [&](int r) {
#pragma unroll
    for (int pl = 0; pl < PL; ++pl) {
      const float* row = Sc + (size_t)(r / group + pl * (rows / group)) * OUT + wcol + g * TB;
      const bool ok = wcol + g * TB < OUT;  // OUT % 8 == 0: the TB columns all in or out
      if constexpr (TB >= 4) {
#pragma unroll
        for (int v = 0; v < TB / 4; ++v) {
          const float4 s = ok ? __ldg(reinterpret_cast<const float4*>(row) + v)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          sc[pl][4 * v] = s.x;
          sc[pl][4 * v + 1] = s.y;
          sc[pl][4 * v + 2] = s.z;
          sc[pl][4 * v + 3] = s.w;
        }
      } else {
        const float2 s = ok ? __ldg(reinterpret_cast<const float2*>(row)) : make_float2(0.f, 0.f);
        sc[pl][0] = s.x;
        sc[pl][1] = s.y;
      }
    }
  };

  int next = 0;  // the first row not yet looked at
  for (int pass = 0;; ++pass) {
    if (warp == 0) {
      scan_rows<NR>(a, e, next, lane, s_rows, &s_n, &s_next);
      __syncwarp();
      // the first pass of a launch that takes one class of experts: cls 1
      // (NR = Q_FEW) leaves an expert that a row past its first Q_FEW
      // names; cls 2 (NR > Q_FEW) one that at most Q_FEW rows name, which
      // its scan found to the end
      if (pass == 0 && ((cls == 1 && s_n == NR && any_row(a, e, s_next, lane)) ||
                        (cls == 2 && s_n <= Q_FEW)) && lane == 0)
        s_n = 0;
    }
    __syncthreads();
    const int n = s_n;
    next = s_next;
    if (n == 0) break;  // the same in every block of the cluster (same e, same idx)

    // the pass's activations at the block's stored rows (plane pl at x
    // columns pl * rows + k0 ...) and the ring's first chunks: bf16 x by
    // cp.async ahead of the ring, else after it, through registers, split
    // into P bf16 parts
    const int n8 = nk / 8;  // octets of a staged row
    if (raw) {
      for (int q = tid; q < n * PL * n8; q += THREADS) {
        const int m = q / (PL * n8), pl = (q / n8) % PL, o = q % n8;
        const int c = pl * rows + k0 + 8 * o;
        const bool ok = c < a.in_x;
        gv_copy<16>(xs + (size_t)(pl * NR + m) * xp + 16 * o,
                    ok ? x + (size_t)s_rows[m] * a.in_x + c : x, ok);
      }
      gv_commit();
    }
#pragma unroll 1
    for (int p = 0; p < D; ++p) {  // not unrolled: each copy of issue holds its addresses
      if (p < n_sg) issue(p, p);
      gv_commit();
    }
    if (n_st > 0) load_scales(r0);
    if (raw) {
      gv_wait<D>();  // this thread's activation copies
    } else {
      for (int q = tid; q < n * PL * n8; q += THREADS) {
        const int m = q / (PL * n8), pl = (q / n8) % PL, o = q % n8;
        const int c = pl * rows + k0 + 8 * o;
        const T* src = x + (size_t)s_rows[m] * a.in_x;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = c + j < a.in_x ? to_float<T>(src[c + j]) : 0.f;
#pragma unroll
        for (int part = 0; part < P; ++part) {
          const uint2 lo = gv_part(v), hi = gv_part(v + 4);
          *reinterpret_cast<uint4*>(xs + (size_t)((part * PL + pl) * NR + m) * xp + 16 * o) =
              make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    }
    __syncthreads();

    float acc[CT][NT][4], pacc[PL][CT][NT][4];
#pragma unroll
    for (int ci = 0; ci < CT; ++ci)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[ci][j][q] = 0.f;
#pragma unroll
          for (int pl = 0; pl < PL; ++pl) pacc[pl][ci][j][q] = 0.f;
        }

    int slot = 0, nxt = D, gend = (r0 / group + 1) * group;  // the stored row ending the group
    for (int sg = 0; sg < n_sg; ++sg) {
      gv_wait<D - 1>();  // this lane's copies of stage sg
      __syncwarp();      // ... and every lane's; the warp is done with slot sg - 1
      if (sg + D < n_sg) issue(sg + D, nxt);
      gv_commit();
      nxt = nxt + 1 == Q_NS ? 0 : nxt + 1;
#pragma unroll 1
      for (int cc = 0; cc < CPS; ++cc) {
        const int i = sg * CPS + cc;
        if (i >= n_st) break;
        const int r = r0 + i * Q_UNIT;
        const unsigned char* st = ring + slot * Q_STAGE + cc * S::CHUNK;
        // the thread's TB bytes of stored rows 4t .. 4t + 3
        uint32_t Rw[4][(TB + 3) / 4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int row = 4 * t + jj;
          const unsigned char* src = st + gv_offset<W>(row, (g * TB) / 16) + (g * TB) % 16;
          if constexpr (TB == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
            Rw[jj][0] = v.x; Rw[jj][1] = v.y; Rw[jj][2] = v.z; Rw[jj][3] = v.w;
          } else if constexpr (TB == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(src);
            Rw[jj][0] = v.x; Rw[jj][1] = v.y;
          } else if constexpr (TB == 4) {
            Rw[jj][0] = *reinterpret_cast<const uint32_t*>(src);
          } else {
            Rw[jj][0] = *reinterpret_cast<const uint16_t*>(src);
          }
          if constexpr (WK == kInt8W) {
#pragma unroll
            for (int w = 0; w < (TB + 3) / 4; ++w) Rw[jj][w] ^= 0x80808080u;
          }
        }
        // B: the pass's rows 8 j + g at the chunk's x columns 4t .. 4t + 3
        const unsigned char* xb = xs + (size_t)g * xp + 2 * (r - k0 + 4 * t);
#pragma unroll
        for (int pl = 0; pl < PL; ++pl) {
          uint32_t B[P][NT][2];
#pragma unroll
          for (int part = 0; part < P; ++part)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (8 * j < n) {
                const uint2 v = *reinterpret_cast<const uint2*>(
                    xb + (size_t)((part * PL + pl) * NR + 8 * j) * xp);
                B[part][j][0] = v.x;
                B[part][j][1] = v.y;
              }
            }
          // m-tile ci is the thread's bytes 2 ci, 2 ci + 1: mma rows g and g + 8
#pragma unroll
          for (int ci = 0; ci < CT; ++ci) {
            const int w = ci / 2, b = (ci % 2) * 2;
            uint32_t A[4];
            if constexpr (WK == kInt4W) {
              const uint32_t sel = b | ((b + 1) << 4) | ((b + 4) << 8) | ((b + 5) << 12);
              uint32_t x01 = __byte_perm(Rw[0][w], Rw[1][w], sel);
              uint32_t x23 = __byte_perm(Rw[2][w], Rw[3][w], sel);
              if (pl) {
                x01 >>= 4;
                x23 >>= 4;
              }
              A[0] = gv_nibbles(x01);
              A[1] = gv_nibbles(x01 >> 8);
              A[2] = gv_nibbles(x23);
              A[3] = gv_nibbles(x23 >> 8);
            } else {
              A[0] = q8_pair(Rw[0][w], b, Rw[1][w], b);
              A[1] = q8_pair(Rw[0][w], b + 1, Rw[1][w], b + 1);
              A[2] = q8_pair(Rw[2][w], b, Rw[3][w], b);
              A[3] = q8_pair(Rw[2][w], b + 1, Rw[3][w], b + 1);
            }
#pragma unroll
            for (int part = 0; part < P; ++part)
#pragma unroll
              for (int j = 0; j < NT; ++j)
                if (8 * j < n) gv_mma(pacc[pl][ci][j], A, B[part][j]);
          }
        }
        if (r + Q_UNIT == gend || i == n_st - 1) {  // the group's (or the warp's) last chunk
#pragma unroll
          for (int ci = 0; ci < CT; ++ci)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                float v = acc[ci][j][q];
#pragma unroll
                for (int pl = 0; pl < PL; ++pl) {
                  v = fmaf(sc[pl][2 * ci + q / 2], pacc[pl][ci][j][q], v);
                  pacc[pl][ci][j][q] = 0.f;
                }
                acc[ci][j][q] = v;
              }
          gend += group;
          if (i + 1 < n_st) load_scales(r + Q_UNIT);  // the next group's, a group ahead
        }
      }
      slot = slot + 1 == Q_NS ? 0 : slot + 1;
    }
    gv_wait<0>();
    __syncthreads();  // every warp is done with its ring: its memory holds the sums now

    // acc[ci][j]: the warp's columns g TB + 2 ci (+ 1 for q >= 2) of rows
    // 8 j + 2 t (+ 1 for odd q); each k warp's into its own rows of red
#pragma unroll
    for (int ci = 0; ci < CT; ++ci)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (8 * j < n) {
          float* d = red + (size_t)(wk * NR + 8 * j + 2 * t) * PITCH + wc * W + g * TB + 2 * ci;
          *reinterpret_cast<float2*>(d) = make_float2(acc[ci][j][0], acc[ci][j][2]);
          *reinterpret_cast<float2*>(d + PITCH) = make_float2(acc[ci][j][1], acc[ci][j][3]);
        }
    __syncthreads();
    const int units = n * (COLS / 4);  // (row, 4-column) units of the pass
    if constexpr (KW > 1) {
      for (int q = tid; q < units; q += THREADS) {
        float* d = red + (q / (COLS / 4)) * PITCH + 4 * (q % (COLS / 4));
        float4 s = *reinterpret_cast<const float4*>(d);
#pragma unroll
        for (int w = 1; w < KW; ++w) {
          const float4 v = *reinterpret_cast<const float4*>(d + w * NR * PITCH);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        *reinterpret_cast<float4*>(d) = s;
      }
    }
    if (C > 1) cluster.sync(); else __syncthreads();
    // reduce-scatter: rank r sums its share of the units over the C blocks'
    // sums and writes them
    T* out = static_cast<T*>(a.out);
    for (int q = rank * units / C + tid; q < (rank + 1) * units / C; q += THREADS) {
      const int m = q / (COLS / 4), c4 = 4 * (q % (COLS / 4));
      if (col0 + c4 >= OUT) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < C; ++r) {
        const float* src = C == 1 ? red : cluster.map_shared_rank(red, r);
        const float4 v = *reinterpret_cast<const float4*>(src + m * PITCH + c4);
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
    if (C > 1) cluster.sync(); else __syncthreads();  // red and s_rows stay until read
  }
}

template <typename T, int WK, int NT, int P>
cudaError_t launch_q(const MoeArgs& a, int split, int cls, cudaStream_t stream) {
  static const cudaError_t attr = allow_clusters(moe_gather_q_kernel<T, WK, NT, P>);
  if (attr != cudaSuccess) return attr;
  using S = QShape<WK, NT>;
  return launch_tiles(moe_gather_q_kernel<T, WK, NT, P>, a, S::COLS, S::THREADS, split,
                      q_smem(NT, P, S::PL, a.rows, split), stream, cls);
}

// The blocks an SM runs at once of the instantiation a launch at `nt`
// n-tiles takes with `smem` bytes of dynamic shared memory (registers and
// shared memory counted), or 0.
template <typename T, int WK, int NT, int P>
int q_occupancy(size_t smem) {
  auto kernel = moe_gather_q_kernel<T, WK, NT, P>;
  constexpr int threads = QShape<WK, NT>::THREADS;
  int per_sm = 0;
  if (allow_clusters(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) != cudaSuccess)
    return 0;
  return per_sm;
}

template <int WK>
int q_per_sm(int dtype, int nt, size_t smem) {
  switch (dtype * 8 + nt) {
    case tg::kF32 * 8 + 1: return q_occupancy<float, WK, 1, 2>(smem);
    case tg::kF32 * 8 + 2: return q_occupancy<float, WK, 2, 2>(smem);
    case tg::kF32 * 8 + 4: return q_occupancy<float, WK, 4, 2>(smem);
    case tg::kBF16 * 8 + 1: return q_occupancy<__nv_bfloat16, WK, 1, 1>(smem);
    case tg::kBF16 * 8 + 2: return q_occupancy<__nv_bfloat16, WK, 2, 1>(smem);
    case tg::kBF16 * 8 + 4: return q_occupancy<__nv_bfloat16, WK, 4, 1>(smem);
  }
  return 0;
}

// One launch of the quantized kernel of kind WK for x of `dtype` (bf16 in
// one part, fp32 in two) at nt n-tiles a pass and split `split`, taking
// the experts of class `cls` (moe_gather_q_kernel).
template <int WK>
cudaError_t launch_q_nt(const MoeArgs& a, int dtype, int nt, int split, int cls,
                        cudaStream_t stream) {
  switch (dtype * 8 + nt) {
    case tg::kF32 * 8 + 1: return launch_q<float, WK, 1, 2>(a, split, cls, stream);
    case tg::kF32 * 8 + 2: return launch_q<float, WK, 2, 2>(a, split, cls, stream);
    case tg::kF32 * 8 + 4: return launch_q<float, WK, 4, 2>(a, split, cls, stream);
    case tg::kBF16 * 8 + 1: return launch_q<__nv_bfloat16, WK, 1, 1>(a, split, cls, stream);
    case tg::kBF16 * 8 + 2: return launch_q<__nv_bfloat16, WK, 2, 1>(a, split, cls, stream);
    case tg::kBF16 * 8 + 4: return launch_q<__nv_bfloat16, WK, 4, 1>(a, split, cls, stream);
  }
  return cudaErrorInvalidValue;
}

// A quantized stack of kind WK, x of `dtype`: at R <= Q_FEW one launch at
// split `split`; above, the experts that at most Q_FEW rows name take
// passes of 1 n-tile at split `split_few`, the others those of R at split
// `split` (each expert's first 32 rows one pass either way).
template <int WK>
cudaError_t launch_quant(const MoeArgs& a, int dtype, int split, int split_few,
                         cudaStream_t stream) {
  if (split < 1 || split > TC_MAX_SPLIT) return cudaErrorInvalidValue;
  const int parts = dtype == tg::kF32 ? 2 : 1, planes = QShape<WK, 1>::PL;
  const int nt = q_ntiles(a.R, parts, planes, a.rows, split);
  if (nt == 0) return cudaErrorInvalidValue;
  if (nt == 1) return launch_q_nt<WK>(a, dtype, 1, split, 0, stream);
  if (split_few < 1 || split_few > TC_MAX_SPLIT ||
      q_ntiles(Q_FEW, parts, planes, a.rows, split_few) != 1)
    return cudaErrorInvalidValue;
  const cudaError_t err = launch_q_nt<WK>(a, dtype, 1, split_few, 1, stream);
  return err != cudaSuccess ? err : launch_q_nt<WK>(a, dtype, nt, split, 2, stream);
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
  if (wdtype == tg::kF32) return launch_f32(a, dtype, s);
  if (wdtype != tg::kBF16 || split < 1 || split > TC_MAX_SPLIT) return cudaErrorInvalidValue;
  switch (dtype) {
    case tg::kF32: return launch_tc_nt<float, 2>(a, split, s);
    case tg::kBF16: return launch_tc_nt<__nv_bfloat16, 1>(a, split, s);
  }
  return cudaErrorInvalidValue;
}

// What a launch takes at split `split` for R rows of x of `dtype` over a
// stack of `bits` (16: K12 on bf16, tg_moe_gather_float; 8: K11a; 4: K11b)
// and contraction dim IN: out[0] the n-tiles of 8 rows a pass (0 where the
// pass's rows fit no block at this split), out[1] a block's dynamic shared
// memory (bytes), out[2] for K11 the blocks an SM runs at once (0 for K12,
// whose plan does not read it). Returns the cudaError_t (0 on success).
int tg_moe_gather_plan(int R, int IN, int dtype, int bits, int split, int* out) {
  if (R <= 0 || IN <= 0 || split < 1 || split > TC_MAX_SPLIT ||
      (dtype != tg::kF32 && dtype != tg::kBF16) || (bits != 16 && bits != 8 && bits != 4) ||
      (bits == 4 && IN % 2))
    return cudaErrorInvalidValue;
  const int parts = dtype == tg::kF32 ? 2 : 1;
  if (bits == 16) {
    const int nt = tc_ntiles(R, parts, IN, split);
    out[0] = nt;
    out[1] = nt ? (int)tc_smem(nt, parts, IN, split) : 0;
  } else {
    const int planes = bits == 4 ? 2 : 1, rows = IN / planes;
    const int nt = q_ntiles(R, parts, planes, rows, split);
    const size_t smem = nt ? q_smem(nt, parts, planes, rows, split) : 0;
    out[0] = nt;
    out[1] = (int)smem;
    out[2] = !nt ? 0 : bits == 4 ? q_per_sm<kInt4W>(dtype, nt, smem)
                                 : q_per_sm<kInt8W>(dtype, nt, smem);
    if (nt && !out[2]) return cudaErrorInvalidValue;
    return cudaSuccess;
  }
  out[2] = 0;
  return cudaSuccess;
}

// K11a: the same for int8 data [L, E, IN, OUT] with fp32 scales [L, E,
// IN/group, OUT], on clusters of `split` blocks (1 to 16) that split IN;
// above 8 rows, the experts that at most 8 rows name on clusters of
// `split_few` (launch_quant). Needs group % 16 == 0, IN % group == 0,
// OUT % 8 == 0.
int tg_moe_gather_int8(const void* x, const void* data, const void* scales, const void* idx,
                       void* out, int R, int IN, int OUT, int E, int group, int layer, int dtype,
                       int split, int split_few, void* stream) {
  if (bad_common(R, IN, IN, OUT, E, layer) || group <= 0 || group % 16 || IN % group)
    return cudaErrorInvalidValue;
  return launch_quant<kInt8W>(args(x, data, scales, idx, out, R, IN, IN, OUT, E, group, layer),
                              dtype, split, split_few, static_cast<cudaStream_t>(stream));
}

// K11b: the same for packed int4 data [L, E, IN/2, OUT] (biased nibbles, row
// p and row IN/2 + p in one byte) with fp32 scales [L, E, IN/group, OUT];
// x [R, in_x] with in_x <= IN (the columns past in_x are the zero pad rows of
// a row-padded stack). Clusters of `split` (and `split_few`) blocks split
// IN/2. Needs group % 16 == 0, (IN/2) % group == 0, OUT % 8 == 0.
int tg_moe_gather_int4(const void* x, const void* data, const void* scales, const void* idx,
                       void* out, int R, int in_x, int IN, int OUT, int E, int group, int layer,
                       int dtype, int split, int split_few, void* stream) {
  const int half = IN / 2;
  if (bad_common(R, in_x, half, OUT, E, layer) || IN % 2 || in_x > IN || group <= 0 ||
      group % 16 || half % group)
    return cudaErrorInvalidValue;
  return launch_quant<kInt4W>(args(x, data, scales, idx, out, R, in_x, half, OUT, E, group, layer),
                              dtype, split, split_few, static_cast<cudaStream_t>(stream));
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
