// Speculative-verify attention over layer `layer` of the frozen, stacked
// paged KV pools, merged with the speculative quantum's in-flight K/V.
//
// Replaces the TPU kernel
// tinygpt_tpu/ops/paged_attention.py::paged_decode_spec_tpu
// (_paged_spec_kernel), with the sliding-window masks of
// paged_decode_spec_xla added. Same function: row b verifies S positions;
// its queries q [B, S, Nq, D] attend to
//   - the pool slots t of k_pools/v_pools [L, n_blocks, Nk, bs, D] at layer
//     `layer`, slot t in block tables[b, t / bs] at offset t % bs, visible to
//     every position iff starts[b] <= t < lengths0[b];
//   - the in-flight slots j of k_infl/v_infl [B, Nk, N, D] accepted in earlier
//     rounds (infl_valid[b, j]), and the own round's slots base <= j <= base +
//     s for position s (causal within the round);
//   - with a window w > 0, only slots whose pool slot is > q_slots[b, s] - w:
//     pool slot t is its own, an accepted in-flight slot carries its pool slot
//     in infl_slots[b, j], an own-round slot j the one of position j - base.
// One fp32 online softmax over both; a query that sees no slot gives zeros.
//
// What bounds it on an H100: the bytes of the visible K/V slots, read once
// for all R = S * G queries of a KV head (at the serving shape, 16 rows of
// 64 to 904 slots, Nk = 8, D = 128, bf16: 30 MB a layer, 0.0090 ms), against
// 4 * B * S * Nq * visible * D operations (0.6 GFLOP, under 0.001 ms at the
// bf16 tensor-core rate): bound by memory.
//
// Design, for bf16 and fp16 q (the tensor-core split, paged_spec_tc_kernel).
// (One 256-thread block a (KV head, row, 64-row group) walked the row's
// whole span in 64-slot tiles, each staged in shared memory as fp32 behind
// three block barriers, both products fp32 FMAs from shared memory: 16x
// its bound.)
// - Each (row, KV head, row group) gets a thread-block cluster of C <= 8
//   blocks (the wrapper's plan, attention_kernels.paged_spec_split, from the
//   blocks an SM runs that tg_paged_decode_spec_plan exports). A block holds
//   RM = 16 * MT query rows of the head, s-major (row r: position r / G,
//   head r % G), MT m-tiles of 16 (MT * D <= 256: D = 128 takes up to 32
//   rows a block, D = 64 up to 64); more rows go to more row groups, each
//   reading the same K/V (the later reads mostly from L2).
// - The span is the pool range [lo, hi) (lo raised by position 0's window)
//   in 64-slot tiles aligned to absolute slot numbers, then the in-flight
//   slots [0, min(base + S, N)) in 64-slot tiles: nothing is scanned. Its
//   tiles are cut into C shares (tg::share, shares of two tiles at least),
//   so the in-flight tiles go with the last share. A block reads its row's
//   block ids (up to kTableCache) into shared memory at its start, beside
//   the row's scalars, so no copy waits on two dependent loads.
// - Each of the 4 warps owns 16 slots of every tile (its sub-tile) and
//   streams their K and V rows with cp.async into its own ring of NS stages,
//   NS - 1 tiles ahead, in 16-byte units XOR-swizzled by row (so the eight
//   rows an ldmatrix reads fall on distinct banks); slots past the span are
//   zero-filled by the copy (src-size 0), never read from the pool. A warp
//   reads back only what its own lanes copied, so the ring needs
//   cp.async.wait_group and a warp barrier, never a block barrier. An e4m3
//   pool's sub-tile lands in the upper half of its stage and is widened in
//   place to bf16 (exact: every e4m3 value is a bf16) before the products;
//   the in-flight rows beside it are bf16 already.
// - S = Q K^T on mma.sync m16n8k16 (Q's m-tiles by ldmatrix from a
//   swizzled copy in shared memory, K by ldmatrix as the col-major B); the
//   scores scaled by scale * log2 e in fp32; visibility from scalars (a
//   pool slot inside [lo, hi) is seen by every position; an in-flight slot
//   j by position s iff infl_valid[b, j] or base <= j <= base + s; a window
//   compares pool slots with q_slots), masked scores -inf by select; a
//   base-2 online softmax per row whose reference m moves only when a score
//   passes it by more than 2^kLazy (P <= 2^8, so the 128 accumulators a
//   thread holds are rescaled rarely, for the whole warp at once: doing it
//   every 16 slots cost more instructions than both products); P rounded to
//   q's 16-bit type in the registers that held the scores, the row sums l
//   taken from those rounded values (so the weights are an exact softmax of
//   slightly moved scores); P V on mma.sync with V by ldmatrix.trans; fp32
//   accumulators.
// - The warps' states merge through shared memory into the block's; then
//   the cluster reduce-scatters: after a cluster barrier each rank reads
//   the C block states of its rows (rank, rank + C, ...) through distributed
//   shared memory (every rank's loads of a row issued before any is used:
//   one round trip, not C), merges and writes them, and a second barrier
//   keeps every block's shared memory alive until then. The states live in
//   the ring's memory, so a larger C costs no shared memory (merging into
//   rank 0 would hold C states there, 16.6 KB each at 32 rows of 128, and
//   leave one rank writing every row). One launch a call.
// fp32 q, and fp16 q over an e4m3 pool (whose in-flight rows are bf16),
// keep the FMA body (paged_decode_spec_kernel): one block a (KV head, row,
// 64-row group), each 64-slot tile staged as fp32 in shared memory; it does
// not split (C is ignored there).

#include "decode_split.cuh"

namespace {

using tg::NEG_INF;

struct Args {
  const void *q, *k_pools, *v_pools;
  const int *tables, *lengths0, *starts;
  const void *k_infl, *v_infl;
  const uint8_t* infl_valid;
  const int *q_slots, *infl_slots;
  void* out;
  int B, S, Nk, n_blocks, bs, MB, N, layer, base, window;
  float scale;
  cudaStream_t stream;
};

// -- the FMA body: fp32 q, and fp16 q over an e4m3 pool ---------------------------

constexpr int BT = 64;         // slots per tile
constexpr int NTHREADS = 256;  // thread (ty, tx): ty = tid / 16 owns rows ty*RPT .. +RPT-1
constexpr int KIND_POOL = -1;  // column kinds: a pool slot, an in-flight slot j >= 0,
constexpr int KIND_NONE = -2;  // or nothing (past the tile's end)

template <int D, int RPT>
constexpr size_t smem_bytes() {
  constexpr int RM = 16 * RPT;
  // q [RM][D+1], k [BT][D+1], v [BT][D], p [RM][BT+1] as float; column kind,
  // slot and prior-validity [BT] and row position and slot [RM] as int
  return sizeof(float) * (RM * (D + 1) + BT * (D + 1) + BT * D + RM * (BT + 1)) +
         sizeof(int) * (3 * BT + 2 * RM);
}


template <typename T, typename C, int D, int RPT>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_spec_kernel(const T* __restrict__ q, const C* __restrict__ k_pools,
                             const C* __restrict__ v_pools, const int* __restrict__ tables,
                             const int* __restrict__ lengths0, const int* __restrict__ starts,
                             const typename tg::Inflight<T, C>::type* __restrict__ k_infl,
                             const typename tg::Inflight<T, C>::type* __restrict__ v_infl,
                             const uint8_t* __restrict__ infl_valid,
                             const int* __restrict__ q_slots, const int* __restrict__ infl_slots,
                             T* __restrict__ out, int S, int G, int Nk, int n_blocks, int bs,
                             int MB, int N, int layer, int base, float scale, int window) {
  using TI = typename tg::Inflight<T, C>::type;
  constexpr int RM = 16 * RPT;
  constexpr int DC = D / 16;  // output columns per thread: tx, tx + 16, ...
  extern __shared__ float smem[];
  float* qs = smem;                  // [RM][D+1]
  float* ks = qs + RM * (D + 1);     // [BT][D+1]
  float* vs = ks + BT * (D + 1);     // [BT][D]
  float* ps = vs + BT * D;           // [RM][BT+1]
  int* ckind = reinterpret_cast<int*>(ps + RM * (BT + 1));  // [BT]
  int* cslot = ckind + BT;           // [BT]
  int* cprior = cslot + BT;          // [BT]
  int* rpos = cprior + BT;           // [RM] query position s of a row, -1 past R
  int* rslot = rpos + RM;            // [RM] its pool slot (window masks)

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * RM;  // the block's first query row
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int R = S * G;
  const int Nq = Nk * G;

  // query rows r0 .. r0 + RM - 1 of this KV head's R, s-major (row r:
  // position r / G, head kvh * G + r % G), pre-scaled; rows past R are zeros
  {
    constexpr int VEC = tg::Vec<T>::N;
    constexpr int VPR = D / VEC;
    for (int i = threadIdx.x; i < RM * VPR; i += NTHREADS) {
      const int r = i / VPR;
      const int c = (i % VPR) * VEC;
      float f[VEC];
      if (r0 + r < R) {
        const int s = (r0 + r) / G, g = (r0 + r) % G;
        tg::raw_to_float<T, VEC>(
            tg::load_raw<T, VEC>(q + (((size_t)b * S + s) * Nq + kvh * G + g) * D + c), f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qs[r * (D + 1) + c + e] = f[e] * scale;
    }
    for (int r = threadIdx.x; r < RM; r += NTHREADS) {
      const int rr = r0 + r;
      rpos[r] = rr < R ? rr / G : -1;
      rslot[r] = (rr < R && window > 0) ? q_slots[(size_t)b * S + rr / G] : 0;
    }
  }

  // the visible ranges: pool slots [lo, hi), in-flight slots [0, n_infl)
  const int len = lengths0[b];
  int lo = max(starts[b], 0);
  if (window > 0) lo = max(lo, q_slots[(size_t)b * S] - window + 1);  // position 0's bound
  const int hi = min(len, MB * bs);  // never past the table, whatever len is
  const int n_pool = max(hi - lo, 0);
  const int n_infl = max(min(base + S, N), 0);
  const int total = n_pool + n_infl;

  const size_t block_stride = (size_t)Nk * bs * D;
  const C* kl = k_pools + (size_t)layer * n_blocks * block_stride + (size_t)kvh * bs * D;
  const C* vl = v_pools + (size_t)layer * n_blocks * block_stride + (size_t)kvh * bs * D;
  const int* tab = tables + (size_t)b * MB;
  const size_t row = (size_t)b * Nk + kvh;
  const TI* ki = k_infl + row * N * D;
  const TI* vi = v_infl + row * N * D;

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();
  int my_pos[RPT], my_slot[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    my_pos[i] = rpos[ty * RPT + i];
    my_slot[i] = rslot[ty * RPT + i];
  }

  // virtual slots: [0, n_pool) the pool range, [n_pool, total) in flight
  for (int x0 = 0; x0 < total; x0 += BT) {
    __syncthreads();  // the previous tile's k/v/p/columns are no longer read
    const int n_here = min(BT, total - x0);
    if (threadIdx.x < BT) {
      const int c = threadIdx.x;
      const int x = x0 + c;
      int kind = KIND_NONE, slot = 0, prior = 0;
      if (c < n_here) {
        if (x < n_pool) {
          kind = KIND_POOL;
          slot = lo + x;
        } else {
          const int j = x - n_pool;
          kind = j;
          prior = infl_valid[(size_t)b * N + j] != 0;
          if (window > 0)
            slot = j >= base ? q_slots[(size_t)b * S + min(j - base, S - 1)]
                             : infl_slots[(size_t)b * N + j];
        }
      }
      ckind[c] = kind;
      cslot[c] = slot;
      cprior[c] = prior;
    }
    // pool slots of the tile, through the block table
    {
      constexpr int VEC = tg::Vec<C>::N;
      constexpr int VPR = D / VEC;
      const int np = max(0, min(n_here, n_pool - x0));
      for (int i = threadIdx.x; i < np * VPR; i += NTHREADS) {
        const int r = i / VPR;
        const int c = (i % VPR) * VEC;
        const int t = lo + x0 + r;
        int blk = __ldg(tab + t / bs);
        if ((unsigned)blk >= (unsigned)n_blocks) blk = 0;  // never out of the pool
        const size_t off = (size_t)blk * block_stride + (size_t)(t % bs) * D + c;
        float f[VEC];
        tg::raw_to_float<C, VEC>(tg::load_raw<C, VEC>(kl + off), f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ks[r * (D + 1) + c + e] = f[e];
        tg::raw_to_float<C, VEC>(tg::load_raw<C, VEC>(vl + off), f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) vs[r * D + c + e] = f[e];
      }
    }
    // in-flight slots of the tile
    {
      constexpr int VEC = tg::Vec<TI>::N;
      constexpr int VPR = D / VEC;
      const int xi = max(x0, n_pool);  // first in-flight virtual slot here
      const int ni = max(0, x0 + n_here - xi);
      for (int i = threadIdx.x; i < ni * VPR; i += NTHREADS) {
        const int r = xi - x0 + i / VPR;
        const int c = (i % VPR) * VEC;
        const size_t off = (size_t)(xi - n_pool + i / VPR) * D + c;
        float f[VEC];
        tg::raw_to_float<TI, VEC>(tg::load_raw<TI, VEC>(ki + off), f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ks[r * (D + 1) + c + e] = f[e];
        tg::raw_to_float<TI, VEC>(tg::load_raw<TI, VEC>(vi + off), f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) vs[r * D + c + e] = f[e];
      }
    }
    // the tile's rows past the ranges are zeros
    for (int i = threadIdx.x; i < (BT - n_here) * D; i += NTHREADS) {
      const int r = n_here + i / D;
      const int c = i % D;
      ks[r * (D + 1) + c] = 0.f;
      vs[r * D + c] = 0.f;
    }
    __syncthreads();

    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int pos = my_pos[i];
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kind = ckind[c];
        bool vis;
        if (kind == KIND_NONE || pos < 0) {
          vis = false;
        } else if (kind == KIND_POOL) {
          vis = true;  // every pool slot predates the quantum
        } else {
          vis = cprior[c] != 0 || (kind >= base && kind <= base + pos);
        }
        if (window > 0) vis = vis && cslot[c] > my_slot[i] - window;
        ok[j] = vis;
        s[i][j] = vis ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are one half warp: xor offsets < 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * RPT + i) * (BT + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float pv[RPT], vv[DC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty * RPT + i) * (BT + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = vs[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty * RPT + i;
    if (r >= R) continue;
    const int s = r / G, g = r % G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* o = out + (((size_t)b * S + s) * Nq + kvh * G + g) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) o[tx + 16 * cc] = tg::from_float<T>(acc[i][cc] * inv);
  }
}

// rows a thread holds: a block takes all R = S * G rows up to 64, else 64
template <typename T, typename C, int D, int RPT>
cudaError_t fma_launch(const Args& a, int G, int* plan) {
  using TI = typename tg::Inflight<T, C>::type;
  auto kernel = paged_decode_spec_kernel<T, C, D, RPT>;
  constexpr size_t smem = smem_bytes<D, RPT>();
  constexpr int RM = 16 * RPT;
  static const cudaError_t attr = tg::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  if (plan) {
    plan[0] = (int)smem;
    plan[2] = RM;
    plan[3] = (a.S * G + RM - 1) / RM;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[1], kernel, NTHREADS, smem);
  }
  dim3 grid(a.Nk, a.B, (a.S * G + RM - 1) / RM);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_pools),
      static_cast<const C*>(a.v_pools), a.tables, a.lengths0, a.starts,
      static_cast<const TI*>(a.k_infl), static_cast<const TI*>(a.v_infl), a.infl_valid,
      a.q_slots, a.infl_slots, static_cast<T*>(a.out), a.S, G, a.Nk, a.n_blocks, a.bs, a.MB,
      a.N, a.layer, a.base, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, typename C, int D>
cudaError_t fma_launch_r(int G, const Args& a, int* plan) {
  const int rpt = (a.S * G + 15) / 16;
  switch (rpt < 4 ? rpt : 4) {
    case 1: return fma_launch<T, C, D, 1>(a, G, plan);
    case 2: return fma_launch<T, C, D, 2>(a, G, plan);
    case 3: return fma_launch<T, C, D, 3>(a, G, plan);
    case 4: return fma_launch<T, C, D, 4>(a, G, plan);
  }
  return cudaErrorInvalidValue;
}

// -- the tensor-core split: bf16 and fp16 q -------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 16;               // slots of a warp's sub-tile
constexpr int kTile = kWarps * kSub;   // slots of a tile, aligned to absolute slot numbers
constexpr int kStages = 3;             // the ring's stages
constexpr int kTableCache = 2048;      // block ids a block keeps in shared memory
constexpr float kLazy = 8.f;           // log2 of the most a weight P may reach

// m-tiles of 16 query rows a block holds for head dim D and R rows a KV
// head: the accumulators of MT * 16 rows x D columns stay at 128 floats a
// thread (attention_kernels.spec_row_tile repeats this)
inline int spec_mt(int D, int R) {
  if (R <= 16) return 1;
  if (D == 128 || R <= 32) return 2;
  return 4;
}

template <typename T, typename C, int D, int MT>
struct SpecShape {
  using TI = typename tg::Inflight<T, C>::type;  // T, or bf16 beside an e4m3 pool
  static constexpr bool E4 = std::is_same<C, tg::e4m3>::value;
  static constexpr int RM = 16 * MT;          // query rows of a block
  static constexpr int ROWB = 2 * D;          // bytes of a 16-bit K, V or q row
  static constexpr int UNITS = D / 8;         // 16-byte units of a row
  static constexpr int PART = kSub * ROWB;    // a sub-tile's K (or V)
  static constexpr int STAGE = 2 * PART;      // a warp's K and V of one tile
  static constexpr int RING = kStages * kWarps * STAGE;
  static constexpr int DP = D + 4;            // a warp state's row stride (floats)
  static constexpr int WSTATE = RM * (DP + 2);          // floats of a warp's state
  static constexpr int BSTATE = RM * (D + 2);           // ... of the block's
  static constexpr int MERGE = 4 * (kWarps * WSTATE + BSTATE + 8 * RM);  // + weights
  static constexpr int SCRATCH = RING > MERGE ? RING : MERGE;
  static constexpr int QBYTES = RM * ROWB;
  static size_t bytes(int MB) {
    return SCRATCH + QBYTES + 4 * (size_t)(MB < kTableCache ? MB : kTableCache);
  }
};

// Byte offset of 16-byte unit u of row r in a swizzled 16-bit tile.
template <int ROWB>
__device__ __forceinline__ int swz(int r, int u) {
  return r * ROWB + ((u ^ (r & 7)) << 4);
}

// 16 bytes from global memory into shared memory, or 16 zero bytes when !ok
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a b on the tensor cores, a 16 x 16 and b 16 x 8 of T, c fp32.
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  if constexpr (std::is_same<T, __half>::value) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Two floats rounded to T (bf16 or fp16), packed as an mma operand; and the
// rounded values back as floats (the row sums add exactly what P V
// multiplies).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi, float& rlo, float& rhi) {
  uint32_t r;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(lo, hi);
    const float2 f = __half22float2(h);
    rlo = f.x;
    rhi = f.y;
    r = *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    const float2 f = __bfloat1622float2(h);
    rlo = f.x;
    rhi = f.y;
    r = *reinterpret_cast<const uint32_t*>(&h);
  }
  return r;
}

// Two e4m3 values (the low byte first) as a bf16 pair, exactly: the card's
// conversion to an fp16 pair, then through fp32.
__device__ __forceinline__ uint32_t e4m3x2_bf16x2(uint32_t two) {
  uint32_t h;
  const unsigned short v = static_cast<unsigned short>(two);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(v));
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

struct SpecArgs {
  const void *q, *k_pools, *v_pools;
  const int *tables, *lengths0, *starts;
  const void *k_infl, *v_infl;
  const uint8_t* infl_valid;
  const int *q_slots, *infl_slots;
  void* out;
  int S, G, Nk, n_blocks, bs, MB, N, layer, base, window, n_rg;
  float scale;
};

template <typename T, typename C, int D, int MT>
__global__ void __launch_bounds__(kThreads) paged_spec_tc_kernel(const SpecArgs a) {
  using Sh = SpecShape<T, C, D, MT>;
  using TI = typename Sh::TI;
  constexpr int RM = Sh::RM, ROWB = Sh::ROWB, UNITS = Sh::UNITS, NS = kStages;
  constexpr int ND = D / 8;  // n-tiles of the output's columns
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  extern __shared__ __align__(128) uint8_t tc_smem[];
  uint8_t* const smem = tc_smem;
  uint8_t* qs = smem + Sh::SCRATCH;                          // [RM][D] swizzled
  int* ids = reinterpret_cast<int*>(qs + Sh::QBYTES);       // the share's block ids
  const int cap = min(a.MB, kTableCache);

  const int S = a.S, G = a.G, R = S * G, Nq = a.Nk * G, bs = a.bs;
  const int cid = blockIdx.x / nc;  // this cluster's (KV head, row group)
  const int kvh = cid / a.n_rg;
  const int r0 = (cid % a.n_rg) * RM;  // the block's first query row of the head
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the block's query rows r0 .. r0 + RM - 1, zeros past R
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < RM * UNITS; i += kThreads) {
    const int r = i / UNITS, u = i % UNITS, rr = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rr < R)
      v = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * S + rr / G) * Nq + kvh * G + rr % G) * D + u * 8));
    *reinterpret_cast<uint4*>(qs + swz<ROWB>(r, u)) = v;
  }

  // the row's first block ids, read at once (no K/V copy waits on a table
  // load, and the table load waits on nothing); a slot past them looks its
  // id up itself
  const int* tab = a.tables + (size_t)b * a.MB;
  for (int i = tid; i < cap; i += kThreads) {
    int blk = __ldg(tab + i);
    if ((unsigned)blk >= (unsigned)a.n_blocks) blk = 0;  // never out of the pool
    ids[i] = blk;
  }

  // the span: pool slots [lo, hi) in n_pt tiles from tile t_lo, then the
  // in-flight slots [0, n_infl); rank `rank`'s share is tiles [s0, s1)
  const int len = a.lengths0[b];
  int lo = max(a.starts[b], 0);
  if (a.window > 0) lo = max(lo, a.q_slots[(size_t)b * S] - a.window + 1);  // position 0's bound
  const int hi = min(len, a.MB * bs);  // never past the table, whatever len is
  const int n_infl = max(min(a.base + S, a.N), 0);
  const int t_lo = lo / kTile;
  const int n_pt = hi > lo ? (hi - 1) / kTile + 1 - t_lo : 0;
  const int n_t = n_pt + (n_infl + kTile - 1) / kTile;
  int s0, s1;
  tg::share(0, n_t, nc, rank, s0, s1);

  __syncthreads();

  // layer `layer`, kv head `kvh` of a pool block; this row's in-flight K/V
  const size_t block_stride = (size_t)a.Nk * bs * D;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * block_stride + (size_t)kvh * bs * D;
  const C* kl = static_cast<const C*>(a.k_pools) + layer_off;
  const C* vl = static_cast<const C*>(a.v_pools) + layer_off;
  const size_t row = (size_t)b * a.Nk + kvh;
  const TI* ki = static_cast<const TI*>(a.k_infl) + row * a.N * D;
  const TI* vi = static_cast<const TI*>(a.v_infl) + row * a.N * D;
  const int bshift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;  // log2(bs), or -1
  uint8_t* wring = smem + (size_t)warp * NS * Sh::STAGE;       // this warp's stages

  // the rows this lane's fragments hold: position and (window) query slot
  int pos[MT][2], qslot[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + mt * 16 + h * 8 + lane / 4;
      pos[mt][h] = rr / G;
      qslot[mt][h] = a.window > 0 ? a.q_slots[(size_t)b * S + min(rr / G, S - 1)] : 0;
    }

  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = -INFINITY;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  // the first slot of this warp's sub-tile of tile v (a pool slot, or an
  // in-flight slot), and whether it holds a slot of the span
  auto first = [&](int v) {
    return (v < n_pt ? (t_lo + v) * kTile : (v - n_pt) * kTile) + warp * kSub;
  };
  auto holds = [&](int v) {
    const int f = first(v);
    return v < n_pt ? f + kSub > lo && f < hi : f < n_infl;
  };
  auto pool_off = [&](int t) {  // pool slot t's row in layer `layer`, head `kvh`
    const int bi = bshift >= 0 ? t >> bshift : t / bs;
    int blk;
    if (bi < cap) {
      blk = ids[bi];
    } else {  // a row longer than the cache
      blk = __ldg(tab + bi);
      if ((unsigned)blk >= (unsigned)a.n_blocks) blk = 0;
    }
    return (size_t)blk * block_stride + (size_t)(t - bi * bs) * D;
  };
  auto issue = [&](int v, int st) {
    uint8_t* kd = wring + st * Sh::STAGE;
    uint8_t* vd = kd + Sh::PART;
    const int f = first(v);
    if (v < n_pt) {
      if constexpr (Sh::E4) {  // e4m3 rows, unswizzled, in the stage's upper halves
        constexpr int CPS = D / 16;  // 16-byte chunks a row
#pragma unroll
        for (int i = lane; i < kSub * CPS; i += 32) {
          const int t = f + i / CPS;
          const bool ok = t >= lo && t < hi;
          const size_t off = ok ? pool_off(t) + (i % CPS) * 16 : 0;
          cp16(kd + Sh::PART / 2 + i * 16, kl + off, ok);
          cp16(vd + Sh::PART / 2 + i * 16, vl + off, ok);
        }
      } else {
#pragma unroll
        for (int i = lane; i < kSub * UNITS; i += 32) {
          const int sl = i / UNITS, u = i % UNITS, t = f + sl;
          const bool ok = t >= lo && t < hi;
          const size_t off = ok ? pool_off(t) + u * 8 : 0;
          cp16(kd + swz<ROWB>(sl, u), kl + off, ok);
          cp16(vd + swz<ROWB>(sl, u), vl + off, ok);
        }
      }
    } else {
#pragma unroll
      for (int i = lane; i < kSub * UNITS; i += 32) {
        const int sl = i / UNITS, u = i % UNITS, j = f + sl;
        const bool ok = j < n_infl;
        const size_t off = ok ? (size_t)j * D + u * 8 : 0;
        cp16(kd + swz<ROWB>(sl, u), ki + off, ok);
        cp16(vd + swz<ROWB>(sl, u), vi + off, ok);
      }
    }
  };
  // an e4m3 sub-tile widened in place to bf16: every lane first reads its
  // chunks of the upper halves, then writes them as swizzled bf16 units
  auto widen = [&](int st) {
    constexpr int CPS = D / 16, PER = kSub * CPS / 32;  // chunks a row, chunks a lane
    uint8_t* kd = wring + st * Sh::STAGE;
    uint4 raw[2][PER];
#pragma unroll
    for (int kv = 0; kv < 2; ++kv)
#pragma unroll
      for (int c = 0; c < PER; ++c)
        raw[kv][c] = *reinterpret_cast<const uint4*>(kd + kv * Sh::PART + Sh::PART / 2 +
                                                     (lane + 32 * c) * 16);
    __syncwarp();
#pragma unroll
    for (int kv = 0; kv < 2; ++kv)
#pragma unroll
      for (int c = 0; c < PER; ++c) {
        const int i = lane + 32 * c, sl = i / CPS, u = (i % CPS) * 2;
        const uint32_t w[4] = {raw[kv][c].x, raw[kv][c].y, raw[kv][c].z, raw[kv][c].w};
        uint4 lo4, hi4;
        lo4.x = e4m3x2_bf16x2(w[0]);
        lo4.y = e4m3x2_bf16x2(w[0] >> 16);
        lo4.z = e4m3x2_bf16x2(w[1]);
        lo4.w = e4m3x2_bf16x2(w[1] >> 16);
        hi4.x = e4m3x2_bf16x2(w[2]);
        hi4.y = e4m3x2_bf16x2(w[2] >> 16);
        hi4.z = e4m3x2_bf16x2(w[3]);
        hi4.w = e4m3x2_bf16x2(w[3] >> 16);
        uint8_t* base = kd + kv * Sh::PART;
        *reinterpret_cast<uint4*>(base + swz<ROWB>(sl, u)) = lo4;
        *reinterpret_cast<uint4*>(base + swz<ROWB>(sl, u + 1)) = hi4;
      }
    __syncwarp();
  };

  const float sc = a.scale * 1.4426950408889634f;
  // one sub-tile's 16 slots folded into the lane's online-softmax states
  auto compute = [&](int v, int st) {
    const uint8_t* kd = wring + st * Sh::STAGE;
    const uint8_t* vd = kd + Sh::PART;
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
    // S = Q K^T, 16 columns of D a step
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kb[4];  // the B fragments of slots 0-7 and 8-15
      ldsm4(kb, kd + swz<ROWB>((lane >> 4) * 8 + (lane & 7), ks * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        ldsm4(qa, qs + swz<ROWB>(mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                 ks * 2 + (lane >> 4)));
        mma16816<T>(s[mt][0], qa, kb);
        mma16816<T>(s[mt][1], qa, kb + 2);
      }
    }
    // scale, then hide what a position does not see (a pool sub-tile inside
    // [lo, hi) without a window hides nothing)
    const int f = first(v);
    const bool pool = v < n_pt;
    const bool all = pool && f >= lo && f + kSub <= hi && a.window <= 0;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = f + n * 8 + 2 * (lane & 3) + e;  // this column's slot
        bool in = true, prior = true;
        int slot = x;
        if (!all) {
          if (pool) {
            in = x >= lo && x < hi;
          } else {
            in = x < n_infl;
            prior = in && a.infl_valid[(size_t)b * a.N + x] != 0;
            if (in && a.window > 0)
              slot = x >= a.base ? a.q_slots[(size_t)b * S + min(x - a.base, S - 1)]
                                 : a.infl_slots[(size_t)b * a.N + x];
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bool vis = in && (prior || (x >= a.base && x <= a.base + pos[mt][h]));
            if (a.window > 0) vis = vis && slot > qslot[mt][h] - a.window;
            const float y = s[mt][n][h * 2 + e] * sc;
            s[mt][n][h * 2 + e] = (all || vis) ? y : -INFINITY;
          }
      }
    // the online softmax (base 2) against a reference m per row that moves
    // only when a score passes it by more than kLazy (so P <= 2^kLazy, and
    // the accumulators are rescaled only then, for the whole warp at once);
    // P rounded to T, l summed from the rounded P
    float mx[MT][2];
    bool up = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaxf(fmaxf(s[mt][0][h * 2], s[mt][0][h * 2 + 1]),
                        fmaxf(s[mt][1][h * 2], s[mt][1][h * 2 + 1]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        mx[mt][h] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        up = up || mx[mt][h] > m[mt][h] + kLazy;
      }
    if (__any_sync(0xffffffffu, up)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool move = mx[mt][h] > m[mt][h] + kLazy;
          const float alpha = move ? tg::ex2(m[mt][h] - mx[mt][h]) : 1.f;  // 0 from -inf
          m[mt][h] = move ? mx[mt][h] : m[mt][h];
          l[mt][h] *= alpha;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            acc[mt][n][h * 2] *= alpha;
            acc[mt][n][h * 2 + 1] *= alpha;
          }
        }
    }
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float ref = m[mt][h] == -INFINITY ? 0.f : m[mt][h];  // a row that saw nothing
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float r0f, r1f;
          pa[mt][n * 2 + h] = pack2<T>(tg::ex2(s[mt][n][h * 2] - ref),
                                       tg::ex2(s[mt][n][h * 2 + 1] - ref), r0f, r1f);
          l[mt][h] += r0f + r1f;
        }
      }
    // O += P V, 16 columns of D a step
#pragma unroll
    for (int nd = 0; nd < ND / 2; ++nd) {
      uint32_t vb[4];  // the B fragments of columns nd*16 .. +7 and +8 .. +15
      ldsm4_trans(vb, vd + swz<ROWB>(((lane >> 3) & 1) * 8 + (lane & 7), nd * 2 + (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816<T>(acc[mt][2 * nd], pa[mt], vb);
        mma16816<T>(acc[mt][2 * nd + 1], pa[mt], vb + 2);
      }
    }
  };

  // the share's tiles in turn, each warp on its own sub-tiles
  int ji = s0;
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (ji < s1) issue(ji++, p);
    tg::cp_commit();
  }
  int st = 0;
  for (int jc = s0; jc < s1; ++jc) {
    __syncwarp();  // every lane is done with the stage the next copy refills
    if (ji < s1) issue(ji++, (st + NS - 1) % NS);
    tg::cp_commit();
    tg::cp_wait<NS - 1>();  // this lane's copies of tile jc have landed
    __syncwarp();           // and every lane's
    if (holds(jc)) {
      if constexpr (Sh::E4) {
        if (jc < n_pt) widen(st);
      }
      compute(jc, st);
    }
    st = st + 1 == NS ? 0 : st + 1;
  }
  tg::cp_wait<0>();
  __syncthreads();  // the ring's memory is free now

  // the warps' states of the block's rows < R into shared memory: acc
  // [RM][DP], then m [RM], l [RM]
  const int rows = min(RM, R - r0);
  float* ws = reinterpret_cast<float*>(smem) + warp * Sh::WSTATE;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + h * 8 + lane / 4;
      float lr = l[mt][h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      if (mt * 16 + h * 8 >= rows) continue;  // eight rows past R (warp-uniform)
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(ws + r * Sh::DP + n * 8 + 2 * (lane & 3)) =
            make_float2(acc[mt][n][h * 2], acc[mt][n][h * 2 + 1]);
      if ((lane & 3) == 0) {
        ws[RM * Sh::DP + r] = m[mt][h];
        ws[RM * Sh::DP + RM + r] = lr;
      }
    }
  __syncthreads();
  // the block's state: acc [RM][D], m [RM], l [RM]; first each row's m, l
  // and its warps' weights (a thread a row), then acc four columns a thread
  float* bst = reinterpret_cast<float*>(smem) + kWarps * Sh::WSTATE;
  float* wx = bst + Sh::BSTATE;  // [8][RM]: the warps', later the ranks', weights
  const float* w0 = reinterpret_cast<const float*>(smem);
  if (tid < rows) {
    float M = -INFINITY, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w0[w * Sh::WSTATE + RM * Sh::DP + tid]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wsw = w0 + w * Sh::WSTATE + RM * Sh::DP;
      const float x = M == -INFINITY ? 0.f : tg::ex2(wsw[tid] - M);
      wx[w * RM + tid] = x;
      L = fmaf(wsw[RM + tid], x, L);
    }
    bst[RM * D + tid] = M;
    bst[RM * D + RM + tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < rows * D / 4; i += kThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(w0 + w * Sh::WSTATE + r * Sh::DP + d);
      const float x = wx[w * RM + r];
      o.x = fmaf(v.x, x, o.x);
      o.y = fmaf(v.y, x, o.y);
      o.z = fmaf(v.z, x, o.z);
      o.w = fmaf(v.w, x, o.w);
    }
    *reinterpret_cast<float4*>(bst + r * D + d) = o;
  }

  // the cluster reduce-scatters: rank `rank` merges and writes rows rank,
  // rank + C, ... of the block's RM, reading every rank's state in place
  // (distributed shared memory): first each row's weights over the ranks,
  // 1 / l folded in, then the output four columns a thread
  cluster.sync();
  const int mine = rank < rows ? (rows - rank + nc - 1) / nc : 0;
  for (int k = tid; k < mine; k += kThreads) {
    const int r = rank + nc * k;
    float mc[8], lc[8], M = -INFINITY, L = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < nc) {
        const float* st = cluster.map_shared_rank(bst, c) + RM * D;
        mc[c] = st[r];
        lc[c] = st[RM + r];
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) M = c < nc ? fmaxf(M, mc[c]) : M;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < nc) {
        mc[c] = M == -INFINITY ? 0.f : tg::ex2(mc[c] - M);
        L = fmaf(lc[c], mc[c], L);
      }
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nc) wx[c * RM + r] = mc[c] * inv;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < mine * (D / 4); i += kThreads) {
    const int r = rank + nc * (i / (D / 4)), d = (i % (D / 4)) * 4;
    float4 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nc)
        v[c] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(bst, c) + r * D + d);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < nc) {
        const float x = wx[c * RM + r];
        o.x = fmaf(v[c].x, x, o.x);
        o.y = fmaf(v[c].y, x, o.y);
        o.z = fmaf(v[c].z, x, o.z);
        o.w = fmaf(v[c].w, x, o.w);
      }
    }
    const int rr = r0 + r;
    T* orow = out + (((size_t)b * S + rr / G) * Nq + kvh * G + rr % G) * D + d;
    orow[0] = tg::from_float<T>(o.x);
    orow[1] = tg::from_float<T>(o.y);
    orow[2] = tg::from_float<T>(o.z);
    orow[3] = tg::from_float<T>(o.w);
  }
  cluster.sync();  // no block leaves while another reads its state
}

// One call of the tensor-core split on clusters of C blocks, or (plan not
// null) what it takes: plan[0] the dynamic shared memory of a block, plan[1]
// the blocks an SM runs, plan[2] the query rows a block holds, plan[3] the
// row groups of a KV head.
template <typename T, typename C, int D, int MT>
cudaError_t tc_launch(const Args& a, int G, int nc, int* plan) {
  using Sh = SpecShape<T, C, D, MT>;
  auto kernel = paged_spec_tc_kernel<T, C, D, MT>;
  const size_t smem = Sh::bytes(a.MB);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  const int n_rg = (a.S * G + Sh::RM - 1) / Sh::RM;
  if (plan) {
    plan[0] = (int)smem;
    plan[2] = Sh::RM;
    plan[3] = n_rg;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[1], kernel, kThreads, smem);
  }
  const SpecArgs s{a.q,          a.k_pools,  a.v_pools, a.tables,     a.lengths0,
                   a.starts,     a.k_infl,   a.v_infl,  a.infl_valid, a.q_slots,
                   a.infl_slots, a.out,      a.S,       G,            a.Nk,
                   a.n_blocks,   a.bs,       a.MB,      a.N,          a.layer,
                   a.base,       a.window,   n_rg,      a.scale};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * a.Nk * n_rg, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = nc;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename C, int D>
cudaError_t tc_launch_m(int G, const Args& a, int nc, int* plan) {
  switch (spec_mt(D, a.S * G)) {
    case 1: return tc_launch<T, C, D, 1>(a, G, nc, plan);
    case 2: return tc_launch<T, C, D, 2>(a, G, nc, plan);
    case 4:
      if constexpr (D == 64) return tc_launch<T, C, D, 4>(a, G, nc, plan);
  }
  return cudaErrorInvalidValue;
}

// The body for q's type T and the pool's type C (q's own, or e4m3) at head
// dim D: the tensor-core split for bf16 q, and for fp16 q over an fp16
// pool; the FMA body otherwise.
template <typename T, typename C>
cudaError_t dispatch_d(int D, int G, const Args& a, int nc, int* plan) {
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value ||
                      (std::is_same<T, __half>::value && std::is_same<C, __half>::value);
  if constexpr (tc) {
    if (D == 64) return tc_launch_m<T, C, 64>(G, a, nc, plan);
    if (D == 128) return tc_launch_m<T, C, 128>(G, a, nc, plan);
  } else {
    if (D == 64) return fma_launch_r<T, C, 64>(G, a, plan);
    if (D == 128) return fma_launch_r<T, C, 128>(G, a, plan);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_c(int kv_dtype, int dtype, int D, int G, const Args& a, int nc, int* plan) {
  if (kv_dtype == dtype) return dispatch_d<T, T>(D, G, a, nc, plan);
  if (kv_dtype == tg::kE4M3) return dispatch_d<T, tg::e4m3>(D, G, a, nc, plan);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int dtype, int kv_dtype, int D, int G, const Args& a, int nc, int* plan) {
  if (a.Nk <= 0 || G <= 0 || a.S <= 0 || nc < 1 || nc > 8) return cudaErrorInvalidValue;
  switch (dtype) {
    case tg::kF32: return dispatch_c<float>(kv_dtype, dtype, D, G, a, nc, plan);
    case tg::kF16: return dispatch_c<__half>(kv_dtype, dtype, D, G, a, nc, plan);
    case tg::kBF16: return dispatch_c<__nv_bfloat16>(kv_dtype, dtype, D, G, a, nc, plan);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [B, S, Nq, D] = speculative-verify attention of q [B, S, Nq, D] over layer
// `layer` of the frozen k_pools/v_pools [L, n_blocks, Nk, bs, D] through
// tables [B, MB] (int32) at slots starts[b] <= t < lengths0[b], merged with the
// in-flight k_infl/v_infl [B, Nk, N, D] at slots j with infl_valid[b, j] (uint8)
// or base <= j <= base + s. With window > 0, q_slots [B, S] and infl_slots
// [B, N] (int32) give the pool slots the window masks; otherwise they may be
// null. q and out are of `dtype`, the pools of `kv_dtype` (= dtype, or kE4M3
// with bf16 in-flight K/V). bf16 and fp16 q run on clusters of C blocks (1 to
// 8; the FMA body ignores C). Returns the cudaError_t of the launch (0 on
// success).
int tg_paged_decode_spec(const void* q, const void* k_pools, const void* v_pools,
                         const void* tables, const void* lengths0, const void* starts,
                         const void* k_infl, const void* v_infl, const void* infl_valid,
                         const void* q_slots, const void* infl_slots, void* out, int B, int S,
                         int Nq, int Nk, int n_blocks, int bs, int MB, int N, int D, int dtype,
                         int kv_dtype, int layer, int base, float scale, int window, int C,
                         void* stream) {
  if (Nk <= 0 || Nq % Nk != 0 || S <= 0 || bs <= 0 || MB <= 0 || N <= 0 || base < 0 ||
      (window > 0 && (q_slots == nullptr || infl_slots == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q,
               k_pools,
               v_pools,
               static_cast<const int*>(tables),
               static_cast<const int*>(lengths0),
               static_cast<const int*>(starts),
               k_infl,
               v_infl,
               static_cast<const uint8_t*>(infl_valid),
               static_cast<const int*>(q_slots),
               static_cast<const int*>(infl_slots),
               out,
               B,
               S,
               Nk,
               n_blocks,
               bs,
               MB,
               N,
               layer,
               base,
               window,
               scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kv_dtype, D, Nq / Nk, a, C, nullptr);
}

// What tg_paged_decode_spec launches at split C for these types and sizes:
// out[0] the dynamic shared memory of a block (bytes), out[1] the blocks an
// SM the card runs at once (registers included), out[2] the query rows a
// block holds, out[3] the row groups of a KV head (the grid's share of the
// S * G rows). Returns the cudaError_t (0 on success).
int tg_paged_decode_spec_plan(int Nq, int Nk, int S, int MB, int D, int dtype, int kv_dtype,
                              int C, int* out) {
  if (Nk <= 0 || Nq % Nk != 0 || S <= 0 || MB <= 0) return cudaErrorInvalidValue;
  Args a{};
  a.S = S;
  a.Nk = Nk;
  a.MB = MB;
  return dispatch(dtype, kv_dtype, D, Nq / Nk, a, C, out);
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
