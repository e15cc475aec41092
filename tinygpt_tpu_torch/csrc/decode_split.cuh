// The one-token GQA decode split over the slots, shared by K13
// (flash_decode.cu: one layer's dense cache under a [B, T] mask) and K2
// (flash_decode_frozen.cu: a layer of the frozen stacked cache under a
// [B, T] mask, merged with the chunk's in-flight K/V). K8
// (paged_decode_frozen.cu) walks a paged pool with its own kernel and
// shares this one's ring, tile arithmetic and merge (split_begin,
// split_tile, split_finish).
//
// The query q [B, Nq, D] of row b, head h attends to the slots of the
// frozen cache k/v [B, Nk, T, D] at KV head h / G where mask[b, t] != 0
// and, with INFL (K2), to the in-flight slots j of k_infl/v_infl
// [B, Nk, N, D] where j <= step and step - j < window (window > 0). One
// fp32 online softmax; a query that sees no slot is written as zeros.
//
// What bounds it on an H100: the bytes of the visible K/V slots, read once
// (2 * B * Nk * visible * D * 2 bytes in bf16), against 4 * B * Nq *
// visible * D operations, about 2 operations per byte for G = 4: bound by
// memory (0.00197 ms at the model phase's shape). An e4m3 cache halves the
// frozen bytes; its slots are decoded to fp32 in registers by the card's
// conversion, and K2's in-flight K/V beside it are bf16 (tg::Inflight). At
// these sizes (a few MB) the time is latency: how many blocks read at once
// and how many round trips each makes.
//
// Design: a split over the slots inside one launch. (One block a (KV head,
// batch row) stepping over every slot of T, a mask byte then the K/V rows
// each step with no load in flight across steps, took time in proportion
// to T, hidden slots included, and left most SMs idle at batch 4.)
// - Each (batch row, KV head, group tile) gets a thread-block cluster of C
//   blocks (C <= 8, from the wrapper's split plan, attention_kernels.
//   decode_split, set at launch with cudaLaunchKernelEx's cluster
//   dimension). A block holds GT query heads of one KV head (more than 8
//   are split over G / GT tiles, tg::group_tile).
// - Every block turns the mask row into one 32-bit word a 32-slot tile
//   (one ballot a warp). K2's in-flight slots become words after the
//   frozen ones, computed from step and the window: virtual slots T_w + j,
//   T_w the frozen words' slots. The span runs from the first to the last
//   visible slot, and its tiles are cut into C equal shares (fewer when a
//   share would fall below MIN_TILES tiles, 64 slots); blocks past the last
//   share hold an empty state.
// - So the in-flight tile is the span's last tile, and it goes with the
//   last share: to the highest rank that holds a share, a block that does
//   not wait for the others (only rank 0 waits, for their states), and
//   counted in the cut like any other tile, so it lengthens no share by
//   more than one tile. A row whose frozen slots are all hidden has a span
//   of the in-flight tile alone: rank 0 takes it.
// - A block walks its share's tiles, skipping tiles the mask hides whole.
//   Groups of D / VEC lanes each own slots of a tile; each lane copies its
//   own VEC columns of its slots' K and V rows into a ring of NS shared-
//   memory stages with cp.async (hidden slots are not copied), NS - 1 tiles
//   ahead of the tile it computes. A lane reads back only what it copied,
//   so the ring needs no barrier: cp.async.wait_group alone orders it. A
//   ring slot holds the wider of a frozen and an in-flight row (an e4m3
//   cache's in-flight rows are bf16).
// - A tile's partial dot products are summed over the group's lanes one
//   shuffle level at a time for all of them together (the shuffles of a
//   level issue back to back instead of one dependent chain a dot), and the
//   softmax runs in base 2 (q pre-scaled by scale * log2 e, ex2.approx).
// - The groups' online-softmax states (m, l, unnormalised acc) merge by
//   shuffles inside each warp, then through shared memory into the block's
//   state. Rank 0 keeps its own; every other block sends its state into its
//   slot of rank 0's shared memory (distributed shared memory) with
//   st.async, whose bytes complete on a barrier in rank 0, and exits. A
//   split cluster barrier (arrive at the start, wait before those writes)
//   makes sure every block has started and rank 0's barrier is set up.
//   Rank 0 waits for the C - 1 states, merges them with its own and writes
//   the output. One launch a call: a second merge kernel would add a
//   launch a layer to host-bound decode loops.
// What is left: at batch 1 the time is latency (the launch and mask scan,
// the mask-then-K/V round trips, rank 0 waiting for the slowest share),
// and every block of a cluster scans the whole mask row (T bytes, from L2).
#pragma once

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace tg {
// Internal linkage: each kernel library keeps its own launch statics (see
// int4_common.cuh).
namespace {

constexpr int kDecodeThreads = 256;
constexpr int kTileSlots = 32;   // slots of a tile: one 32-bit word of mask bits
constexpr int kMinShareTiles = 2;  // tiles of a share, unless the span is shorter

// One call's operands: k and v point at the layer's frozen [B, Nk, T, D]
// cache; k_infl and v_infl (K2) at [B, Nk, N, D], null for K13 (N = 0).
struct DecodeArgs {
  const void *q, *k, *v;
  const uint8_t* mask;
  const void *k_infl, *v_infl;
  void* out;
  int Nk, G, T, N, step, window;
  float scale;
};

template <typename E>
struct Tag {
  using type = E;
};

template <typename T, typename C, int D, int GT, bool INFL>
struct DecodeShape {
  using TI = typename std::conditional<INFL, typename Inflight<T, C>::type, C>::type;
  static constexpr int NT = kDecodeThreads;
  static constexpr int VEC = Vec<T>::N;      // elements a lane, as q's 16-byte vectors
  static constexpr int LPR = D / VEC;        // lanes a K/V row (8..32)
  static constexpr int NG = NT / LPR;        // slot groups a block (8 to 32)
  static constexpr int U = kTileSlots / NG;  // slots of a tile a group owns (1..4)
  static constexpr int CB = VEC * static_cast<int>(sizeof(C));    // bytes a lane copies a row
  static constexpr int CBI = VEC * static_cast<int>(sizeof(TI));  // ... an in-flight row
  static constexpr int SLOT = CB > CBI ? CB : CBI;
  static constexpr int STAGE = 2 * U * NT * SLOT;  // a tile's K and V
  static constexpr int NS = STAGE <= 16384 ? 4 : 3;  // stages of the ring
  static constexpr int RING = NS * STAGE;
  static constexpr int NW = NT / 32;                   // warps
  static constexpr int MERGE = NW * GT * (D + 2) * 4;  // the warps' states
  static constexpr int SCRATCH = RING > MERGE ? RING : MERGE;
  static constexpr int PART = GT * (D + 2);            // floats of a block's state
  static __host__ __device__ int words(int Tlen, int N) {
    return (Tlen + kTileSlots - 1) / kTileSlots + (INFL ? (N + kTileSlots - 1) / kTileSlots : 0);
  }
  // the ring (or the warps' states); the C block states (rank 0's); the
  // mask's words; each warp's first and last visible slot; rank 0's
  // mbarrier, on which the other blocks' states land
  static size_t bytes(int Tlen, int N, int n_blocks) {
    return SCRATCH + 4 * ((size_t)n_blocks * PART + words(Tlen, N) + 2 * NW) + 16;
  }
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// BYTES (4, 8 or 16) bytes of the ring into the low bytes of a uint4.
template <int BYTES>
__device__ __forceinline__ uint4 ring_read(const uint8_t* p) {
  if constexpr (BYTES == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else if constexpr (BYTES == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    return make_uint4(r.x, r.y, 0u, 0u);
  } else {
    return make_uint4(*reinterpret_cast<const uint32_t*>(p), 0u, 0u, 0u);
  }
}

// The share of rank `rank` of a cluster of C blocks: tiles [j0, j1) of the
// span of tiles [t_lo, t_hi).
__device__ __forceinline__ void share(int t_lo, int t_hi, int C, int rank, int& j0, int& j1) {
  const int n = t_hi - t_lo;
  const int ce = max(1, min(C, n / kMinShareTiles));
  j0 = j1 = 0;
  if (n > 0 && rank < ce) {
    j0 = t_lo + rank * n / ce;
    j1 = t_lo + (rank + 1) * n / ce;
  }
}

// The start of a split call. Rank 0's barrier expects the other blocks'
// states, nc - 1 of PART floats. Every block of the cluster has started
// (and rank 0 has set its barrier up) before any block writes there: arrive
// now, wait (split_finish) just before the writes.
template <int PART>
__device__ __forceinline__ void split_begin(uint64_t* landed, int rank, int nc) {
  if (rank == 0 && threadIdx.x == 0) {
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(landed));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((nc - 1) * PART * 4)
                 : "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// One tile's slots of a group: the K and V rows this lane copied into ring
// stage `stage` (kslot(stage, 0 or 1, u)), as elements of type E, at the
// slots `word` shows, folded into the lane's online-softmax state (q
// pre-scaled by scale * log2 e).
template <typename E, int VEC, int LPR, int NG, int U, int GT, typename Slot>
__device__ __forceinline__ void split_tile(const Slot& kslot, int stage, uint32_t word, int grp,
                                           const float (&qr)[GT][VEC], float (&m)[GT],
                                           float (&l)[GT], float (&acc)[GT][VEC]) {
  constexpr int EB = VEC * static_cast<int>(sizeof(E));
  float s[U][GT];
  bool ok[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ok[u] = (word >> (u * NG + grp)) & 1u;
    float kv[VEC];
    raw_to_float<E, VEC>(ring_read<EB>(kslot(stage, 0, u)), kv);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float acc_s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s = fmaf(qr[g][e], kv[e], acc_s);
      s[u][g] = acc_s;
    }
  }
  // the partial dots summed over the group's LPR lanes (aligned within
  // the warp), all U * GT of them a level at a time
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GT; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int g = 0; g < GT; ++g)
      s[u][g] = ok[u] ? s[u][g] : NEG_INF;  // a hidden slot's bytes were never copied
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mx = m[g];
#pragma unroll
    for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
    const float alpha = ex2(m[g] - mx);
    l[g] *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
    m[g] = mx;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!ok[u]) continue;
    float vv[VEC];
    raw_to_float<E, VEC>(ring_read<EB>(kslot(stage, 1, u)), vv);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float p = ex2(s[u][g] - m[g]);
      l[g] += p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
    }
  }
}

// The end of a split call: the groups' online-softmax states (m, l,
// unnormalised acc of the lane's VEC columns from d0) merged into the
// block's, then the cluster's blocks' into rank 0's, which writes the GT
// query rows at out_rows() (zeros where no slot was visible). The other
// ranks return once their state is sent.
template <int D, int LPR, int GT, int VEC, typename Rows>
__device__ __forceinline__ void split_finish(float (&m)[GT], float (&l)[GT], float (&acc)[GT][VEC],
                                             int tid, int warp, int lane32, int d0, uint8_t* smem,
                                             float* states, uint64_t* landed, int rank, int nc,
                                             const Rows& out_rows) {
  using T = typename std::remove_pointer<decltype(out_rows())>::type;
  constexpr int NT = kDecodeThreads, NW = NT / 32, PART = GT * (D + 2);
  // the groups of a warp merge by shuffles (a lane and its partner hold the
  // same columns); then the warps' states merge through shared memory
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mp = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lp = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mp);
      const float x = ex2(m[g] - M), xp = ex2(mp - M);
      l[g] = l[g] * x + lp * xp;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = acc[g][e] * x + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * xp;
      m[g] = M;
    }
  }
  __syncthreads();  // the ring's memory is free now
  float* wacc = reinterpret_cast<float*>(smem);  // [NW][GT][D]
  float* wm = wacc + NW * GT * D;                // [NW][GT]
  float* wl = wm + NW * GT;                      // [NW][GT]
  if (lane32 < LPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) wacc[(warp * GT + g) * D + d0 + e] = acc[g][e];
      if (lane32 == 0) {
        wm[warp * GT + g] = m[g];
        wl[warp * GT + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's state: rank 0 keeps it in its slot 0; the others send
  // theirs into their slot of rank 0's shared memory with st.async, which
  // completes on rank 0's barrier, and exit
  uint32_t dst = 0, bar = 0;
  if (rank != 0) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    const uint32_t mine = static_cast<uint32_t>(__cvta_generic_to_shared(states + rank * PART));
    const uint32_t lb = static_cast<uint32_t>(__cvta_generic_to_shared(landed));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(dst) : "r"(mine));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(bar) : "r"(lb));
  }
  for (int i = tid; i < GT * D; i += NT) {
    const int g = i / D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * GT + g]);
    float Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float x = ex2(wm[w * GT + g] - M);
      Lsum = fmaf(wl[w * GT + g], x, Lsum);
      O = fmaf(wacc[(w * GT + g) * D + i % D], x, O);
    }
    if (rank == 0) {
      states[i] = O;
      if (i % D == 0) {
        states[GT * D + g] = M;
        states[GT * D + GT + g] = Lsum;
      }
    } else {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
              dst + 4 * i),
          "f"(O), "r"(bar)
          : "memory");
      if (i % D == 0) {
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                dst + 4 * (GT * D + g)),
            "f"(M), "r"(bar)
            : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                dst + 4 * (GT * D + GT + g)),
            "f"(Lsum), "r"(bar)
            : "memory");
      }
    }
  }
  if (rank != 0) return;

  // rank 0: the C states merged, the output written
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  {
    const uint32_t lb = static_cast<uint32_t>(__cvta_generic_to_shared(landed));
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(lb)
          : "memory");
    } while (!done);
  }
  __syncthreads();  // slot 0, written by this block's threads
  auto orow = out_rows();
  for (int i = tid; i < GT * D; i += NT) {
    const int g = i / D;
    float M = NEG_INF;
    for (int r = 0; r < nc; ++r) M = fmaxf(M, states[r * PART + GT * D + g]);
    float Lsum = 0.f, O = 0.f;
    for (int r = 0; r < nc; ++r) {
      const float* st = states + r * PART;
      const float x = ex2(st[GT * D + g] - M);
      Lsum = fmaf(st[GT * D + GT + g], x, Lsum);
      O = fmaf(st[i], x, O);
    }
    orow[i] = from_float<T>(Lsum > 0.f ? O / Lsum : 0.f);
  }
}

template <typename T, typename C, int D, int GT, bool INFL>
__global__ void __launch_bounds__(kDecodeThreads) split_decode_kernel(const DecodeArgs a) {
  using Sh = DecodeShape<T, C, D, GT, INFL>;
  using TI = typename Sh::TI;
  constexpr int NT = Sh::NT, TS = kTileSlots;
  constexpr int VEC = Sh::VEC, LPR = Sh::LPR, NG = Sh::NG, U = Sh::U, SLOT = Sh::SLOT;
  constexpr int NS = Sh::NS;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int Nk = a.Nk, G = a.G, Tlen = a.T;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                          // [NS][2][U][NT][SLOT]
  float* states = reinterpret_cast<float*>(smem + Sh::SCRATCH);  // [C][acc GT*D, m GT, l GT]
  uint32_t* words = reinterpret_cast<uint32_t*>(states + nc * Sh::PART);
  const int n_fw = (Tlen + TS - 1) / TS;   // the frozen slots' words
  const int n_words = Sh::words(Tlen, a.N);  // and the in-flight slots'
  int* wspan = reinterpret_cast<int*>(words + n_words);  // [2][warps]
  uint64_t* landed = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(wspan + 2 * Sh::NW) + 7) & ~static_cast<uintptr_t>(7));

  split_begin<Sh::PART>(landed, rank, nc);

  const int n_tiles = G / GT;            // group tiles of a KV head
  const int cid = blockIdx.x / nc;       // this cluster's (KV head, group tile)
  const int kvh = cid / n_tiles;
  const int h0 = kvh * G + (cid % n_tiles) * GT;  // the block's first query head
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane32 = tid % 32;
  const int grp = tid / LPR;
  const int lane = tid % LPR;
  const int d0 = lane * VEC;
  const int Nq = Nk * G;

  // this lane's slice of the GT query rows, pre-scaled by scale * log2(e)
  // so that the softmax runs in base 2 (its loads overlap the mask's)
  const T* q = static_cast<const T*>(a.q);
  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    raw_to_float<T, VEC>(load_raw<T, VEC>(q + ((size_t)b * Nq + h0 + g) * D + d0), qr[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] *= a.scale * 1.4426950408889634f;
  }

  // the mask's bits, a word a tile (a warp's ballot), and the span of
  // visible slots
  const uint8_t* mk = a.mask + (size_t)b * Tlen;
  int lo = 0x7fffffff, hi = -1;
#pragma unroll 4
  for (int w = warp; w < n_fw; w += Sh::NW) {
    const int t = w * TS + lane32;
    const uint32_t word = __ballot_sync(0xffffffffu, t < Tlen && mk[t] != 0);
    if (lane32 == 0) words[w] = word;
    if (word != 0) {
      lo = min(lo, w * TS + __ffs(word) - 1);
      hi = max(hi, w * TS + 31 - __clz(word));
    }
  }
  if (lane32 == 0) {
    wspan[warp] = lo;
    wspan[Sh::NW + warp] = hi;
  }
  // the in-flight slots j_lo..step (virtual slots n_fw * TS + j)
  const int j_lo = INFL && a.window > 0 ? max(0, a.step - a.window + 1) : 0;
  if constexpr (INFL) {
    for (int w = tid; w < n_words - n_fw; w += NT) {
      const int s0 = max(j_lo - w * TS, 0), s1 = min(a.step - w * TS, TS - 1);
      words[n_fw + w] = s0 > s1 ? 0u : (0xffffffffu >> (TS - 1 - s1)) & (0xffffffffu << s0);
    }
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < Sh::NW; ++w) {
    lo = min(lo, wspan[w]);
    hi = max(hi, wspan[Sh::NW + w]);
  }
  if constexpr (INFL) {
    lo = min(lo, n_fw * TS + j_lo);
    hi = n_fw * TS + a.step;
  }
  int j0 = 0, j1 = 0;
  if (hi >= 0) share(lo / TS, hi / TS + 1, nc, rank, j0, j1);

  const size_t row = (size_t)b * Nk + kvh;
  const C* kc = static_cast<const C*>(a.k) + row * Tlen * D + d0;
  const C* vc = static_cast<const C*>(a.v) + row * Tlen * D + d0;
  const TI* ki = INFL ? static_cast<const TI*>(a.k_infl) + row * a.N * D + d0 : nullptr;
  const TI* vi = INFL ? static_cast<const TI*>(a.v_infl) + row * a.N * D + d0 : nullptr;

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // slot u * NG + grp of a tile is this group's u-th; its K and V columns
  // of this lane sit at [stage][0 or 1][u][tid] in the ring
  auto kslot = [&](int stage, int kv, int u) {
    return ring + ((((size_t)stage * 2 + kv) * U + u) * NT + tid) * SLOT;
  };
  auto issue = [&](int j, int stage) {
    const uint32_t word = words[j];
    if (!INFL || j < n_fw) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = u * NG + grp;
        if ((word >> i) & 1u) {
          const size_t t = (size_t)j * TS + i;
          cp_async<Sh::CB>(kslot(stage, 0, u), kc + t * D);
          cp_async<Sh::CB>(kslot(stage, 1, u), vc + t * D);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = u * NG + grp;
        if ((word >> i) & 1u) {
          const size_t t = (size_t)(j - n_fw) * TS + i;
          cp_async<Sh::CBI>(kslot(stage, 0, u), ki + t * D);
          cp_async<Sh::CBI>(kslot(stage, 1, u), vi + t * D);
        }
      }
    }
  };
  auto next = [&](int j) {  // the next tile of the share with a visible slot
    for (++j; j < j1 && words[j] == 0; ++j) {
    }
    return j;
  };
  // one tile's slots, their K/V rows in the ring as elements of type E
  auto tile = [&](auto tag, int stage, uint32_t word) {
    split_tile<typename decltype(tag)::type, VEC, LPR, NG, U>(kslot, stage, word, grp, qr, m, l,
                                                              acc);
  };

  int ji = next(j0 - 1);
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (ji < j1) {
      issue(ji, p);
      ji = next(ji);
    }
    cp_commit();
  }
  int stage = 0;
  for (int jc = next(j0 - 1); jc < j1; jc = next(jc)) {
    if (ji < j1) {
      issue(ji, (stage + NS - 1) % NS);
      ji = next(ji);
    }
    cp_commit();
    cp_wait<NS - 1>();  // this lane's copies of tile jc have landed
    if constexpr (!std::is_same<TI, C>::value) {  // an e4m3 cache beside bf16 in-flight rows
      if (jc >= n_fw) {
        tile(Tag<TI>{}, stage, words[jc]);
      } else {
        tile(Tag<C>{}, stage, words[jc]);
      }
    } else {
      tile(Tag<C>{}, stage, words[jc]);
    }
    stage = stage + 1 == NS ? 0 : stage + 1;
  }
  cp_wait<0>();

  split_finish<D, LPR>(m, l, acc, tid, warp, lane32, d0, smem, states, landed, rank, nc, [&] {
    return static_cast<T*>(a.out) + ((size_t)b * Nq + h0) * D;
  });
}

template <typename T, typename C, int D, int GT, bool INFL>
cudaError_t launch_split_decode(const DecodeArgs& a, int B, int n_blocks, cudaStream_t stream) {
  using Sh = DecodeShape<T, C, D, GT, INFL>;
  auto kernel = split_decode_kernel<T, C, D, GT, INFL>;
  const size_t smem = Sh::bytes(a.T, a.N, n_blocks);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
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

// one instantiation per query heads a block holds (tg::group_tile)
template <typename T, typename C, int D, bool INFL>
cudaError_t launch_split_g(const DecodeArgs& a, int B, int n_blocks, cudaStream_t s) {
  switch (group_tile(a.G)) {
    case 1: return launch_split_decode<T, C, D, 1, INFL>(a, B, n_blocks, s);
    case 2: return launch_split_decode<T, C, D, 2, INFL>(a, B, n_blocks, s);
    case 3: return launch_split_decode<T, C, D, 3, INFL>(a, B, n_blocks, s);
    case 4: return launch_split_decode<T, C, D, 4, INFL>(a, B, n_blocks, s);
    case 5: return launch_split_decode<T, C, D, 5, INFL>(a, B, n_blocks, s);
    case 6: return launch_split_decode<T, C, D, 6, INFL>(a, B, n_blocks, s);
    case 7: return launch_split_decode<T, C, D, 7, INFL>(a, B, n_blocks, s);
    case 8: return launch_split_decode<T, C, D, 8, INFL>(a, B, n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

// the head dim, then the cache's type: q's own, or e4m3
template <typename T, bool INFL>
cudaError_t launch_split_c(int kv_dtype, int dtype, int D, const DecodeArgs& a, int B,
                           int n_blocks, cudaStream_t s) {
  if (kv_dtype == dtype) {
    if (D == 64) return launch_split_g<T, T, 64, INFL>(a, B, n_blocks, s);
    if (D == 128) return launch_split_g<T, T, 128, INFL>(a, B, n_blocks, s);
  } else if (kv_dtype == kE4M3) {
    if (D == 64) return launch_split_g<T, e4m3, 64, INFL>(a, B, n_blocks, s);
    if (D == 128) return launch_split_g<T, e4m3, 128, INFL>(a, B, n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

// One call on clusters of n_blocks blocks (1 to 8): q and out of `dtype`,
// the cache of `kv_dtype` (= dtype, or kE4M3).
template <bool INFL>
cudaError_t split_decode(const DecodeArgs& a, int B, int D, int dtype, int kv_dtype,
                         int n_blocks, cudaStream_t s) {
  if (a.Nk <= 0 || a.G <= 0 || n_blocks < 1 || n_blocks > 8) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch_split_c<float, INFL>(kv_dtype, dtype, D, a, B, n_blocks, s);
    case kF16: return launch_split_c<__half, INFL>(kv_dtype, dtype, D, a, B, n_blocks, s);
    case kBF16: return launch_split_c<__nv_bfloat16, INFL>(kv_dtype, dtype, D, a, B, n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tg
