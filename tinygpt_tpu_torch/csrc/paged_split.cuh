// The one-token GQA decode split over a paged pool's block table, shared by
// K8 (paged_decode_frozen.cu: layer `layer` of the frozen stacked pools,
// merged with the decode quantum's in-flight K/V; INFL true) and K9
// (paged_decode.cu: one layer's pool, its own K/V already written there;
// INFL false). The tile arithmetic and the merge are decode_split.cuh's
// (split_begin, split_tile, split_finish), shared with K2 and K13.
//
// The query q [B, Nq, D] of row b attends to the pool slots t of
// k_pools/v_pools [L, n_blocks, Nk, bs, D] at layer `layer` (K9 passes its
// single layer's pool as layer 0: the view's data pointer carries the
// layer's offset), slot t living in block tables[b, t / bs] at offset
// t % bs, visible iff starts[b] <= t < lengths0[b] and, when window > 0,
//   - INFL (K8): t > lengths0[b] + step - window, and the in-flight slots j
//     of k_infl/v_infl [B, Nk, N, D] with j <= step (and step - j < window);
//   - not INFL (K9): t > lengths0[b] - 1 - window (the query sits at slot
//     lengths[b] - 1); there is no in-flight slot.
// One fp32 online softmax; a query that sees no slot is written as zeros.
//
// What bounds it on an H100: the bytes of the visible K/V slots, read once
// (2 * B * Nk * visible * D * 2 bytes in bf16), against 4 * B * Nq * visible
// * D operations, G / 2 operations per byte in bf16: bound by memory (K8
// 0.0128 ms at the serve shape: 16 rows of 512 to 767 slots, 8 KV heads of
// 128; K9 0.0060 ms at GPT-2's serving shape: 16 rows up to 1,023 slots, 12
// KV heads of 64). An e4m3 pool (kv_dtype = kE4M3) halves the pool's bytes:
// its slots are decoded to fp32 in registers by the card's conversion, and
// K8's in-flight K/V beside it are bf16, as the JAX package keeps them. At
// these sizes (tens of MB) the time is how many bytes are in flight at once.
//
// Design: K2's split over the slots (decode_split.cuh), on a span that the
// scalars give. (One 256-thread block a (KV head, row), each iteration a
// table lookup, then the K/V rows it addresses, consumed at once, left 128
// to 192 blocks on 132 SMs at the serving shapes, the longest row setting
// the time.)
// - Each (row, KV head, group tile) gets a thread-block cluster of C <= 8
//   blocks (the wrapper's plan, attention_kernels.paged_decode_split, from
//   the blocks an SM runs that tg_paged_decode_frozen_plan and
//   tg_paged_decode_plan export; set at launch as the cluster dimension). A
//   block holds GT query heads of one KV head (more than 8 are split over
//   G / GT tiles, tg::group_tile).
// - The row's visible slots are one or two ranges known from the lengths,
//   starts, step and the window, so nothing is scanned: pool slots [lo, hi),
//   then (INFL) the in-flight slots [j_lo, step]. Both are cut into 32-slot
//   tiles aligned to absolute slot numbers (a tile never straddles a pool
//   block when bs % 32 == 0), pool tiles first, and the span's tiles into C
//   shares (tg::share: fewer when a share would fall below two tiles). So
//   the in-flight tile is the span's last and goes with the last share, to
//   the highest rank that holds one; a row with no pool slot gives rank 0
//   its in-flight tile alone (and, without INFL, nothing: its output is
//   zeros). An inactive row (length 0, or a stale length over a zero table)
//   walks what it shows, as the TPU kernels do: block 0 of the pool may hold
//   any value, and an out-of-range block id reads block 0.
// - The block ids of a share's pool slots (one int32 a block of bs slots)
//   are read once, into shared memory, before the first K/V copy (up to
//   kTableCache ids; a share past them looks its later ids up per slot), so
//   no K/V load waits on a table load. K9 reads its row's first ids at the
//   kernel's start, beside the row's scalars, so its first copy waits on one
//   load instead of two (its shares cover the same ids).
// - Each lane copies its own columns of its slots' K and V rows with
//   cp.async into a ring of NS stages, NS - 1 tiles ahead of the tile it
//   computes; batched shuffle levels, a base-2 softmax; the groups', then
//   the warps' states merge in the block, and the other ranks send theirs
//   into rank 0's shared memory (split_tile, split_finish). One launch a
//   call. Offsets into the pools are 64-bit: at the server's default pool
//   (1024 blocks) the Mistral-7B shape has 2^31 elements per pool.
#pragma once

#include "decode_split.cuh"

namespace tg {
namespace {

constexpr int kTableCache = 2048;  // block ids a block keeps in shared memory

struct PagedArgs {
  const void *q, *k_pools, *v_pools;
  const int *tables, *lengths0, *starts;
  const void *k_infl, *v_infl;
  void* out;
  int Nk, G, n_blocks, bs, MB, N, layer, step, window;
  float scale;
};

// Shared memory of a block: the ring (or the warps' states), the C block
// states (rank 0's), the share's block ids, rank 0's mbarrier.
template <typename T, typename C, int D, int GT, bool INFL>
size_t paged_smem(int MB, int n_blocks) {
  using Sh = DecodeShape<T, C, D, GT, INFL>;
  return Sh::SCRATCH + 4 * ((size_t)n_blocks * Sh::PART + (MB < kTableCache ? MB : kTableCache)) +
         16;
}

// Slots [s0, s1] of a 32-slot tile as a word of bits (0 when s0 > s1).
__device__ __forceinline__ uint32_t tile_bits(int s0, int s1) {
  s0 = max(s0, 0);
  s1 = min(s1, kTileSlots - 1);
  return s0 > s1 ? 0u : (0xffffffffu >> (kTileSlots - 1 - s1)) & (0xffffffffu << s0);
}

template <typename T, typename C, int D, int GT, bool INFL>
__global__ void __launch_bounds__(kDecodeThreads) paged_split_kernel(const PagedArgs a) {
  using Sh = DecodeShape<T, C, D, GT, INFL>;
  using TI = typename Sh::TI;
  constexpr int TS = kTileSlots;
  constexpr int NT = Sh::NT, VEC = Sh::VEC, LPR = Sh::LPR, NG = Sh::NG, U = Sh::U;
  constexpr int SLOT = Sh::SLOT, NS = Sh::NS;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = a.G, bs = a.bs;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                          // [NS][2][U][NT][SLOT]
  float* states = reinterpret_cast<float*>(smem + Sh::SCRATCH);  // [C][acc GT*D, m GT, l GT]
  int* ids = reinterpret_cast<int*>(states + nc * Sh::PART);     // the share's block ids
  const int cap = min(a.MB, kTableCache);
  uint64_t* landed = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(ids + cap) + 7) & ~static_cast<uintptr_t>(7));

  split_begin<Sh::PART>(landed, rank, nc);

  const int n_gt = G / GT;         // group tiles of a KV head
  const int cid = blockIdx.x / nc;  // this cluster's (KV head, group tile)
  const int kvh = cid / n_gt;
  const int h0 = kvh * G + (cid % n_gt) * GT;  // the block's first query head
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int grp = tid / LPR;
  const int d0 = (tid % LPR) * VEC;
  const int Nq = a.Nk * G;

  // this lane's slice of the GT query rows, pre-scaled by scale * log2(e)
  // (its loads overlap the scalars' and the table's)
  const T* q = static_cast<const T*>(a.q);
  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    raw_to_float<T, VEC>(load_raw<T, VEC>(q + ((size_t)b * Nq + h0 + g) * D + d0), qr[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] *= a.scale * 1.4426950408889634f;
  }

  // K9: the row's first block ids, read at once beside the row's scalars
  // (no K/V copy waits on two dependent loads); a slot past them looks its
  // id up itself
  if constexpr (!INFL) {
    const int* tab0 = a.tables + (size_t)b * a.MB;
    for (int i = tid; i < cap; i += NT) {
      int blk = __ldg(tab0 + i);
      if ((unsigned)blk >= (unsigned)a.n_blocks) blk = 0;  // never out of the pool
      ids[i] = blk;
    }
  }

  // the visible ranges: pool slots [lo, hi), in-flight slots [j_lo, step];
  // their tiles: n_pt pool tiles from tile t_lo, then the in-flight tiles
  // from tile jt_lo, n_t in all
  const int len = a.lengths0[b];
  int lo = max(a.starts[b], 0), j_lo = 0;
  if (a.window > 0) {
    if constexpr (INFL) {
      lo = max(lo, len + a.step - a.window + 1);
      j_lo = max(a.step - a.window + 1, 0);
    } else {
      lo = max(lo, len - a.window);
    }
  }
  const int hi = min(len, a.MB * bs);  // never past the table, whatever len is
  const int t_lo = lo / TS;
  const int n_pt = hi > lo ? (hi - 1) / TS + 1 - t_lo : 0;
  const int jt_lo = j_lo / TS;
  const int n_t = INFL ? n_pt + a.step / TS + 1 - jt_lo : n_pt;
  int s0, s1;
  share(0, n_t, nc, rank, s0, s1);

  // K8: the block ids of the share's pool slots, read once
  const int* tab = a.tables + (size_t)b * a.MB;
  const int pe = min(s1, n_pt);  // the share's pool tiles are [s0, pe)
  int bi0 = 0;
  if (INFL && s0 < pe) {
    bi0 = max(lo, (t_lo + s0) * TS) / bs;
    const int nb = min((min(hi, (t_lo + pe) * TS) - 1) / bs + 1 - bi0, cap);
    for (int i = tid; i < nb; i += NT) {
      int blk = __ldg(tab + bi0 + i);
      if ((unsigned)blk >= (unsigned)a.n_blocks) blk = 0;  // never out of the pool
      ids[i] = blk;
    }
  }
  __syncthreads();

  // layer `layer`, kv head `kvh` of a pool block, this lane's columns
  const size_t block_stride = (size_t)a.Nk * bs * D;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * block_stride + (size_t)kvh * bs * D + d0;
  const C* kl = static_cast<const C*>(a.k_pools) + layer_off;
  const C* vl = static_cast<const C*>(a.v_pools) + layer_off;
  const size_t row = (size_t)b * a.Nk + kvh;
  const TI* ki = INFL ? static_cast<const TI*>(a.k_infl) + row * a.N * D + d0 : nullptr;
  const TI* vi = INFL ? static_cast<const TI*>(a.v_infl) + row * a.N * D + d0 : nullptr;
  const int bshift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;  // log2(bs), or -1

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // tile v's first slot (absolute pool slot, or in-flight slot) and its
  // visible slots as a word
  auto first = [&](int v) { return v < n_pt ? (t_lo + v) * TS : (jt_lo + v - n_pt) * TS; };
  auto word = [&](int v) {
    const int base = first(v);
    return v < n_pt ? tile_bits(lo - base, hi - 1 - base) : tile_bits(j_lo - base, a.step - base);
  };
  // slot u * NG + grp of a tile is this group's u-th; its K and V columns
  // of this lane sit at [stage][0 or 1][u][tid] in the ring
  auto kslot = [&](int stage, int kv, int u) {
    return ring + ((((size_t)stage * 2 + kv) * U + u) * NT + tid) * SLOT;
  };
  auto issue = [&](int v, int stage) {
    const int base = first(v);
    const uint32_t w = word(v);
    if (!INFL || v < n_pt) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = u * NG + grp;
        if ((w >> i) & 1u) {
          const int t = base + i;
          const int bi = bshift >= 0 ? t >> bshift : t / bs;
          int blk;
          if (bi - bi0 < cap) {
            blk = ids[bi - bi0];
          } else {  // a share longer than the cache
            blk = __ldg(tab + bi);
            if ((unsigned)blk >= (unsigned)a.n_blocks) blk = 0;
          }
          const size_t off = (size_t)blk * block_stride + (size_t)(t - bi * bs) * D;
          cp_async<Sh::CB>(kslot(stage, 0, u), kl + off);
          cp_async<Sh::CB>(kslot(stage, 1, u), vl + off);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = u * NG + grp;
        if ((w >> i) & 1u) {
          const size_t j = base + i;
          cp_async<Sh::CBI>(kslot(stage, 0, u), ki + j * D);
          cp_async<Sh::CBI>(kslot(stage, 1, u), vi + j * D);
        }
      }
    }
  };

  // every tile of a share holds a visible slot: the ring walks them in turn
  int ji = s0;
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (ji < s1) issue(ji++, p);
    cp_commit();
  }
  int stage = 0;
  for (int jc = s0; jc < s1; ++jc) {
    if (ji < s1) issue(ji++, (stage + NS - 1) % NS);
    cp_commit();
    cp_wait<NS - 1>();  // this lane's copies of tile jc have landed
    if constexpr (!std::is_same<TI, C>::value) {  // an e4m3 pool beside bf16 in-flight rows
      if (jc >= n_pt) {
        split_tile<TI, VEC, LPR, NG, U>(kslot, stage, word(jc), grp, qr, m, l, acc);
      } else {
        split_tile<C, VEC, LPR, NG, U>(kslot, stage, word(jc), grp, qr, m, l, acc);
      }
    } else {
      split_tile<C, VEC, LPR, NG, U>(kslot, stage, word(jc), grp, qr, m, l, acc);
    }
    stage = stage + 1 == NS ? 0 : stage + 1;
  }
  cp_wait<0>();

  split_finish<D, LPR>(m, l, acc, tid, tid / 32, tid % 32, d0, smem, states, landed, rank, nc,
                       [&] { return static_cast<T*>(a.out) + ((size_t)b * Nq + h0) * D; });
}

template <typename T, typename C, int D, int GT, bool INFL>
cudaError_t paged_launch(const PagedArgs& a, int B, int n_blocks, cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, C, D, GT, INFL>;
  const size_t smem = paged_smem<T, C, D, GT, INFL>(a.MB, n_blocks);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks * a.Nk * (a.G / GT), B);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = n_blocks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What a launch at this shape would take: (dynamic shared memory bytes, the
// blocks an SM the card runs at once), or an error for a shape it refuses.
template <typename T, typename C, int D, int GT, bool INFL>
cudaError_t paged_describe(const PagedArgs& a, int n_blocks, int* out) {
  auto kernel = paged_split_kernel<T, C, D, GT, INFL>;
  const size_t smem = paged_smem<T, C, D, GT, INFL>(a.MB, n_blocks);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDecodeThreads, smem);
  out[0] = (int)smem;
  out[1] = per_sm;
  return err;
}

// The instantiation of q's type T, the pool's type C, the head dim and the
// query heads a block holds (tg::group_tile): launched, or described when
// `plan` is not null.
template <typename T, typename C, int D, bool INFL>
cudaError_t paged_dispatch_g(const PagedArgs& a, int B, int n_blocks, cudaStream_t s, int* plan) {
  switch (group_tile(a.G)) {
#define TG_CASE(GT)                                                 \
  case GT:                                                          \
    return plan ? paged_describe<T, C, D, GT, INFL>(a, n_blocks, plan) \
                : paged_launch<T, C, D, GT, INFL>(a, B, n_blocks, s);
    TG_CASE(1) TG_CASE(2) TG_CASE(3) TG_CASE(4) TG_CASE(5) TG_CASE(6) TG_CASE(7) TG_CASE(8)
#undef TG_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool INFL>
cudaError_t paged_dispatch_c(int kv_dtype, int dtype, int D, const PagedArgs& a, int B,
                             int n_blocks, cudaStream_t s, int* plan) {
  if (kv_dtype == dtype) {
    if (D == 64) return paged_dispatch_g<T, T, 64, INFL>(a, B, n_blocks, s, plan);
    if (D == 128) return paged_dispatch_g<T, T, 128, INFL>(a, B, n_blocks, s, plan);
  } else if (kv_dtype == kE4M3) {
    if (D == 64) return paged_dispatch_g<T, e4m3, 64, INFL>(a, B, n_blocks, s, plan);
    if (D == 128) return paged_dispatch_g<T, e4m3, 128, INFL>(a, B, n_blocks, s, plan);
  }
  return cudaErrorInvalidValue;
}

// One call on clusters of C blocks (1 to 8), or its plan (`plan` not null):
// q and out of `dtype`, the pools of `kv_dtype` (= dtype, or kE4M3).
template <bool INFL>
cudaError_t paged_dispatch(int dtype, int kv_dtype, int D, const PagedArgs& a, int B, int C,
                           cudaStream_t s, int* plan) {
  if (a.Nk <= 0 || a.G <= 0 || C < 1 || C > 8) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return paged_dispatch_c<float, INFL>(kv_dtype, dtype, D, a, B, C, s, plan);
    case kF16: return paged_dispatch_c<__half, INFL>(kv_dtype, dtype, D, a, B, C, s, plan);
    case kBF16:
      return paged_dispatch_c<__nv_bfloat16, INFL>(kv_dtype, dtype, D, a, B, C, s, plan);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tg
