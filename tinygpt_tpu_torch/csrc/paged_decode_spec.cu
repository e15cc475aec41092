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
// for all S * G queries of a KV head (at the serving shape, 16 rows of about
// 640 slots, Nk = 8, D = 128, bf16: 42 MB a layer, 0.0125 ms), against
// 4 * B * S * Nq * visible * D operations (0.84 GFLOP, 0.001 ms at the bf16
// tensor-core rate): bound by memory. What the design does about it: one
// block per (KV head, row) holds all R = S * G query rows of the head (20 at
// S = 5, G = 4) and walks the row's visible slots in tiles of 64: the pool
// range [lo, hi) through the block table (64-bit offsets, as K8), then the
// in-flight slots up to the own round's last. Each K/V tile is staged in
// shared memory once, as fp32, for all R rows (an e4m3 pool is decoded there
// by the card's conversion, its in-flight K/V are bf16), and each thread
// holds RPT rows x 4 slots of scores and RPT rows x D/16 columns of the
// output (fp32 FMA; tensor cores are a later step). Slots past the ranges are
// staged as zeros, so nothing undefined is ever multiplied by a masked zero.

#include "attention_common.cuh"

namespace {

using tg::NEG_INF;

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
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int R = S * G;
  const int Nq = Nk * G;

  // the R query rows of this KV head, s-major (row r: position r / G, head
  // kvh * G + r % G), pre-scaled; rows past R are zeros
  {
    constexpr int VEC = tg::Vec<T>::N;
    constexpr int VPR = D / VEC;
    for (int i = threadIdx.x; i < RM * VPR; i += NTHREADS) {
      const int r = i / VPR;
      const int c = (i % VPR) * VEC;
      float f[VEC];
      if (r < R) {
        const int s = r / G, g = r % G;
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
      rpos[r] = r < R ? r / G : -1;
      rslot[r] = (r < R && window > 0) ? q_slots[(size_t)b * S + r / G] : 0;
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
    const int r = ty * RPT + i;
    if (r >= R) continue;
    const int s = r / G, g = r % G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* o = out + (((size_t)b * S + s) * Nq + kvh * G + g) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) o[tx + 16 * cc] = tg::from_float<T>(acc[i][cc] * inv);
  }
}

template <typename T, typename C, int D, int RPT>
cudaError_t launch(const Args& a, int G) {
  using TI = typename tg::Inflight<T, C>::type;
  constexpr size_t smem = smem_bytes<D, RPT>();
  static const cudaError_t attr =
      tg::allow_smem(paged_decode_spec_kernel<T, C, D, RPT>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Nk, a.B);
  paged_decode_spec_kernel<T, C, D, RPT><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_pools),
      static_cast<const C*>(a.v_pools), a.tables, a.lengths0, a.starts,
      static_cast<const TI*>(a.k_infl), static_cast<const TI*>(a.v_infl), a.infl_valid,
      a.q_slots, a.infl_slots, static_cast<T*>(a.out), a.S, G, a.Nk, a.n_blocks, a.bs, a.MB,
      a.N, a.layer, a.base, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, typename C, int D>
cudaError_t launch_r(int G, const Args& a) {
  switch ((a.S * G + 15) / 16) {
    case 1: return launch<T, C, D, 1>(a, G);
    case 2: return launch<T, C, D, 2>(a, G);
    case 3: return launch<T, C, D, 3>(a, G);
    case 4: return launch<T, C, D, 4>(a, G);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename C>
cudaError_t launch_d(int D, int G, const Args& a) {
  if (D == 64) return launch_r<T, C, 64>(G, a);
  if (D == 128) return launch_r<T, C, 128>(G, a);
  return cudaErrorInvalidValue;
}

// the pools are of q's type, or e4m3
template <typename T>
cudaError_t launch_c(int kv_dtype, int dtype, int D, int G, const Args& a) {
  if (kv_dtype == dtype) return launch_d<T, T>(D, G, a);
  if (kv_dtype == tg::kE4M3) return launch_d<T, tg::e4m3>(D, G, a);
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
// with bf16 in-flight K/V). S * Nq / Nk must be at most 64. Returns the
// cudaError_t of the launch (0 on success).
int tg_paged_decode_spec(const void* q, const void* k_pools, const void* v_pools,
                         const void* tables, const void* lengths0, const void* starts,
                         const void* k_infl, const void* v_infl, const void* infl_valid,
                         const void* q_slots, const void* infl_slots, void* out, int B, int S,
                         int Nq, int Nk, int n_blocks, int bs, int MB, int N, int D, int dtype,
                         int kv_dtype, int layer, int base, float scale, int window,
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
  const int G = Nq / Nk;
  switch (dtype) {
    case tg::kF32: return launch_c<float>(kv_dtype, dtype, D, G, a);
    case tg::kF16: return launch_c<__half>(kv_dtype, dtype, D, G, a);
    case tg::kBF16: return launch_c<__nv_bfloat16>(kv_dtype, dtype, D, G, a);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
