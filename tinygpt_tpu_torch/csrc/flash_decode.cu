// One-token GQA decode over one layer's dense KV cache, under a mask the
// caller computed: the per-token decode step (decode_step) of the streaming
// engine, and attention_with_cache at S == 1.
//
// Replaces the TPU kernel
// tinygpt_tpu/ops/attention_kernels.py::flash_decode (_decode_kernel).
// Same function: the query q [B, Nq, D] of row b, head h attends to the
// slots t of k_cache/v_cache [B, Nk, T, D] at KV head h / G where
// mask[b, t] != 0 (validity, causality and the window, folded in by the
// caller). One fp32 online softmax; a query that sees no slot is written as
// zeros (the JAX kernel gives the uniform mean of V there).
//
// What bounds it on an H100: the bytes of the visible K/V slots, read once
// (2 * B * Nk * visible * D * 2 bytes in bf16), against 4 * B * Nq * visible
// * D operations, about 2 operations per byte for G = 4: bound by memory
// (0.00197 ms at the model phase's per-token shape). An e4m3 cache
// (kv_dtype = kE4M3) halves those bytes; its slots are decoded to fp32 in
// registers by the card's conversion. At these sizes (a few MB) the time is
// latency: how many blocks read at once and how many round trips each makes.
//
// Design: a split over the slots inside one launch.
// - Each (batch row, KV head, group tile) gets a thread-block cluster of C
//   blocks (C <= 8, chosen by the wrapper's split plan and set at launch
//   with cudaLaunchKernelEx's cluster dimension). A block holds GT query
//   heads of one KV head (more than 8 are split over G / GT tiles,
//   tg::group_tile).
// - Every block turns the mask row into one 32-bit word a 32-slot tile
//   (one ballot a warp) and finds the span from the first to the last
//   visible slot. The span's tiles are cut into C equal shares (fewer when
//   a share would fall below MIN_TILES tiles, 64 slots); blocks past the
//   last share hold an empty state.
// - A block walks its share's tiles, skipping tiles the mask hides whole.
//   Groups of D / VEC lanes each own slots of a tile; each lane copies its
//   own VEC columns of its slots' K and V rows into a ring of NS shared-
//   memory stages with cp.async (hidden slots are not copied), NS - 1 tiles
//   ahead of the tile it computes. A lane reads back only what it copied,
//   so the ring needs no barrier: cp.async.wait_group alone orders it.
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
//   the output. One launch a call: the per-token route is host-bound, and a
//   second merge kernel would add a launch a layer.
// The first design's walk (one block per (KV head, batch row) stepping over
// every slot of T, a mask byte then the K/V rows each step, with no load in
// flight across steps) took time in proportion to T, hidden slots
// included: at batch 1 it took twice K2's time over the same slots
// (PERF.md). What is left: at batch 1 the time is latency (the launch and
// mask scan, the mask-then-K/V round trips, rank 0 waiting for the slowest
// share), and every block of a cluster scans the whole mask row (T bytes,
// from L2).

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace {

using tg::NEG_INF;

constexpr int NTHREADS = 256;
constexpr int TS = 32;         // slots of a tile: one 32-bit word of mask bits
constexpr int MIN_TILES = 2;   // tiles of a share, unless the span is shorter

template <typename T, typename C, int D, int GT>
struct Shape {
  static constexpr int VEC = tg::Vec<T>::N;    // elements a lane, as q's 16-byte vectors
  static constexpr int LPR = D / VEC;          // lanes a K/V row (8..32)
  static constexpr int NG = NTHREADS / LPR;    // slot groups a block (8 to 32)
  static constexpr int U = TS / NG;            // slots of a tile a group owns (1..4)
  static constexpr int CB = VEC * static_cast<int>(sizeof(C));  // bytes a lane copies a row
  static constexpr int STAGE = 2 * U * NTHREADS * CB;           // a tile's K and V
  static constexpr int NS = STAGE <= 16384 ? 4 : 3;             // stages of the ring
  static constexpr int RING = NS * STAGE;
  static constexpr int NW = NTHREADS / 32;              // warps
  static constexpr int MERGE = NW * GT * (D + 2) * 4;  // the warps' states
  static constexpr int SCRATCH = RING > MERGE ? RING : MERGE;
  static constexpr int PART = GT * (D + 2);            // floats of a block's state
  // the ring (or the warps' states); the C block states (rank 0's); the
  // mask's words; each warp's first and last visible slot; rank 0's
  // mbarrier, on which the other blocks' states land
  static size_t bytes(int Tlen, int n_blocks) {
    return SCRATCH + 4 * ((size_t)n_blocks * PART + (Tlen + TS - 1) / TS + 2 * NW) + 16;
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
  const int ce = max(1, min(C, n / MIN_TILES));
  j0 = j1 = 0;
  if (n > 0 && rank < ce) {
    j0 = t_lo + rank * n / ce;
    j1 = t_lo + (rank + 1) * n / ce;
  }
}

template <typename T, typename C, int D, int GT>
__global__ void __launch_bounds__(NTHREADS)
    flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                        const C* __restrict__ v_cache, const uint8_t* __restrict__ mask,
                        T* __restrict__ out, int Nk, int G, int Tlen, float scale) {
  using Sh = Shape<T, C, D, GT>;
  constexpr int VEC = Sh::VEC, LPR = Sh::LPR, NG = Sh::NG, U = Sh::U, CB = Sh::CB;
  constexpr int NS = Sh::NS;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                       // [NS][2][U][NTHREADS][CB]
  float* states = reinterpret_cast<float*>(smem + Sh::SCRATCH);  // [C][acc GT*D, m GT, l GT]
  uint32_t* words = reinterpret_cast<uint32_t*>(states + nc * Sh::PART);
  const int n_words = (Tlen + TS - 1) / TS;
  int* wspan = reinterpret_cast<int*>(words + n_words);       // [2][warps]
  uint64_t* landed = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(wspan + 2 * Sh::NW) + 7) & ~static_cast<uintptr_t>(7));

  // Rank 0's barrier expects the other blocks' states, C - 1 of PART
  // floats. Every block of the cluster has started (and rank 0 has set its
  // barrier up) before any block writes there: arrive now, wait just
  // before the writes.
  if (rank == 0 && threadIdx.x == 0) {
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(landed));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((nc - 1) * Sh::PART * 4)
                 : "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

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
  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    tg::raw_to_float<T, VEC>(tg::load_raw<T, VEC>(q + ((size_t)b * Nq + h0 + g) * D + d0),
                             qr[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] *= scale * 1.4426950408889634f;
  }

  // the mask's bits, a word a tile (a warp's ballot), and the span of
  // visible slots
  const uint8_t* mk = mask + (size_t)b * Tlen;
  int lo = Tlen, hi = -1;
#pragma unroll 4
  for (int w = warp; w < n_words; w += NTHREADS / 32) {
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
    wspan[NTHREADS / 32 + warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) {
    lo = min(lo, wspan[w]);
    hi = max(hi, wspan[NTHREADS / 32 + w]);
  }
  int j0 = 0, j1 = 0;
  if (hi >= 0) share(lo / TS, hi / TS + 1, nc, rank, j0, j1);

  const size_t row = (size_t)b * Nk + kvh;
  const C* kc = k_cache + row * Tlen * D + d0;
  const C* vc = v_cache + row * Tlen * D + d0;

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
    return ring + ((((size_t)stage * 2 + kv) * U + u) * NTHREADS + tid) * CB;
  };
  auto issue = [&](int j, int stage) {
    const uint32_t word = words[j];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = u * NG + grp;
      if ((word >> i) & 1u) {
        const size_t t = (size_t)j * TS + i;
        cp_async<CB>(kslot(stage, 0, u), kc + t * D);
        cp_async<CB>(kslot(stage, 1, u), vc + t * D);
      }
    }
  };
  auto next = [&](int j) {  // the next tile of the share with a visible slot
    for (++j; j < j1 && words[j] == 0; ++j) {
    }
    return j;
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

    const uint32_t word = words[jc];
    float s[U][GT];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = (word >> (u * NG + grp)) & 1u;
      const uint4 raw = ring_read<CB>(kslot(stage, 0, u));
      float kv[VEC];
      tg::raw_to_float<C, VEC>(raw, kv);
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
      const uint4 raw = ring_read<CB>(kslot(stage, 1, u));
      float vv[VEC];
      tg::raw_to_float<C, VEC>(raw, vv);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = ex2(s[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
    stage = stage + 1 == NS ? 0 : stage + 1;
  }
  cp_wait<0>();

  // the groups of a warp merge by shuffles (a lane and its partner hold the
  // same columns); then the warps' states merge through shared memory
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mp = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lp = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mp);
      const float a = ex2(m[g] - M), bp = ex2(mp - M);
      l[g] = l[g] * a + lp * bp;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * bp;
      m[g] = M;
    }
  }
  __syncthreads();  // the ring's memory is free now
  float* wacc = reinterpret_cast<float*>(smem);  // [NW][GT][D]
  float* wm = wacc + Sh::NW * GT * D;            // [NW][GT]
  float* wl = wm + Sh::NW * GT;                  // [NW][GT]
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
    const uint32_t mine =
        static_cast<uint32_t>(__cvta_generic_to_shared(states + rank * Sh::PART));
    const uint32_t lb = static_cast<uint32_t>(__cvta_generic_to_shared(landed));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(dst) : "r"(mine));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(bar) : "r"(lb));
  }
  for (int i = tid; i < GT * D; i += NTHREADS) {
    const int g = i / D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < Sh::NW; ++w) M = fmaxf(M, wm[w * GT + g]);
    float Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < Sh::NW; ++w) {
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
  T* orow = out + ((size_t)b * Nq + h0) * D;
  for (int i = tid; i < GT * D; i += NTHREADS) {
    const int g = i / D;
    float M = NEG_INF;
    for (int r = 0; r < nc; ++r) M = fmaxf(M, states[r * Sh::PART + GT * D + g]);
    float Lsum = 0.f, O = 0.f;
    for (int r = 0; r < nc; ++r) {
      const float* st = states + r * Sh::PART;
      const float x = ex2(st[GT * D + g] - M);
      Lsum = fmaf(st[GT * D + GT + g], x, Lsum);
      O = fmaf(st[i], x, O);
    }
    orow[i] = tg::from_float<T>(Lsum > 0.f ? O / Lsum : 0.f);
  }
}

struct Args {
  const void *q, *k_cache, *v_cache, *mask;
  void* out;
  int B, Nk, G, T, C;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int GT>
cudaError_t launch(const Args& a) {
  using Sh = Shape<T, C, D, GT>;
  auto kernel = flash_decode_kernel<T, C, D, GT>;
  const size_t smem = Sh::bytes(a.T, a.C);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * a.Nk * (a.G / GT), a.B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const C*>(a.k_cache),
      static_cast<const C*>(a.v_cache), static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.out), a.Nk, a.G, a.T, a.scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// one instantiation per query heads a block holds (tg::group_tile)
template <typename T, typename C, int D>
cudaError_t launch_g(const Args& a) {
  switch (tg::group_tile(a.G)) {
    case 1: return launch<T, C, D, 1>(a);
    case 2: return launch<T, C, D, 2>(a);
    case 3: return launch<T, C, D, 3>(a);
    case 4: return launch<T, C, D, 4>(a);
    case 5: return launch<T, C, D, 5>(a);
    case 6: return launch<T, C, D, 6>(a);
    case 7: return launch<T, C, D, 7>(a);
    case 8: return launch<T, C, D, 8>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename C>
cudaError_t launch_d(int D, const Args& a) {
  if (D == 64) return launch_g<T, C, 64>(a);
  if (D == 128) return launch_g<T, C, 128>(a);
  return cudaErrorInvalidValue;
}

// the cache is of q's type, or e4m3
template <typename T>
cudaError_t launch_c(int kv_dtype, int dtype, int D, const Args& a) {
  if (kv_dtype == dtype) return launch_d<T, T>(D, a);
  if (kv_dtype == tg::kE4M3) return launch_d<T, tg::e4m3>(D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [B, Nq, D] = attention of q [B, Nq, D] over k_cache/v_cache
// [B, Nk, T, D] (one layer) at the slots where mask [B, T] != 0, split over
// clusters of C blocks (1 <= C <= 8). q and out are of `dtype`; the cache
// of `kv_dtype` (= dtype, or kE4M3). Returns the cudaError_t of the launch
// (0 on success).
int tg_flash_decode(const void* q, const void* k_cache, const void* v_cache, const void* mask,
                    void* out, int B, int Nq, int Nk, int T, int D, int dtype, int kv_dtype,
                    float scale, int C, void* stream) {
  if (Nk <= 0 || Nq % Nk != 0 || C < 1 || C > 8) return cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, mask, out, B, Nk, Nq / Nk, T, C, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case tg::kF32: return launch_c<float>(kv_dtype, dtype, D, a);
    case tg::kF16: return launch_c<__half>(kv_dtype, dtype, D, a);
    case tg::kBF16: return launch_c<__nv_bfloat16>(kv_dtype, dtype, D, a);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
