// One-token GQA decode over layer `layer` of the frozen, stacked paged KV
// pools, merged with the decode quantum's in-flight K/V.
//
// Replaces the TPU kernel
// tinygpt_tpu/ops/paged_attention.py::paged_decode_frozen_tpu
// (_paged_frozen_kernel). Same function: the query q [B, Nq, D] of row b
// attends to the pool slots t of k_pools/v_pools [L, n_blocks, Nk, bs, D] at
// layer `layer`, slot t living in block tables[b, t / bs] at offset t % bs,
// visible iff starts[b] <= t < lengths0[b] (and t > lengths0[b] + step -
// window when window > 0); and to the in-flight slots j of k_infl/v_infl
// [B, Nk, N, D] with j <= step (and step - j < window). One fp32 online
// softmax over both; a query that sees no slot is written as zeros.
//
// What bounds it on an H100: the bytes of the visible K/V slots, read once
// (2 * B * Nk * visible * D * 2 bytes in bf16), against 4 * B * Nq * visible
// * D operations, about 2 operations per byte for G = 4: bound by memory.
// An e4m3 pool (kv_dtype = kE4M3) halves the pool's bytes: its slots are
// decoded to fp32 in registers by the card's conversion, and the in-flight
// K/V beside it are bf16, as the JAX package keeps them.
// What the design does about it: K2's shape (flash_decode_frozen.cu). One
// block per (kv head, batch row) serves all G = Nq / Nk query heads from one
// read of each K/V row. The visible slots of a row form two contiguous
// ranges (pool slots [lo, hi), in-flight slots [j0, step]), so the block
// walks exactly those: a dead table entry, or a slot a mask hides, is never
// read, and nothing is multiplied by a masked zero (the null block 0 may
// hold any value after an inactive row's scatter). Groups of D / 8 (bf16)
// lanes each read one slot's K and V row as 16-byte vectors, several slots
// in flight per group, the block id looked up per slot; the groups' partial
// softmax states are merged once through shared memory. Offsets into the
// pools are 64-bit: at the server's default pool (1024 blocks) the
// Mistral-7B shape has 2^31 elements per pool. With B = 16 and Nk = 8 that
// is 128 blocks on 132 SMs.

#include "attention_common.cuh"

namespace {

using tg::NEG_INF;

constexpr int NTHREADS = 256;

template <typename T, int D>
struct Shape {
  static constexpr int VEC = tg::Vec<T>::N;    // elements per 16-byte load
  static constexpr int LPR = D / VEC;          // lanes per K/V row (8..32)
  static constexpr int NG = NTHREADS / LPR;    // slot groups per block
};

template <typename T, int D, int G>
constexpr size_t smem_bytes() {
  constexpr int NG = Shape<T, D>::NG;
  return sizeof(float) * (NG * G * D + 2 * NG * G);  // acc, m, l of every group
}

struct Args {
  const void *q, *k_pools, *v_pools;
  const int *tables, *lengths0, *starts;
  const void *k_infl, *v_infl;
  void* out;
  int B, Nk, n_blocks, bs, MB, N, layer, step, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int G>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_frozen_kernel(const T* __restrict__ q, const C* __restrict__ k_pools,
                               const C* __restrict__ v_pools, const int* __restrict__ tables,
                               const int* __restrict__ lengths0, const int* __restrict__ starts,
                               const typename tg::Inflight<T, C>::type* __restrict__ k_infl,
                               const typename tg::Inflight<T, C>::type* __restrict__ v_infl,
                               T* __restrict__ out, int Nk, int n_blocks, int bs, int MB, int N,
                               int layer, int step, float scale, int window) {
  using TI = typename tg::Inflight<T, C>::type;
  constexpr bool SAME = std::is_same<C, TI>::value;
  constexpr int VEC = Shape<T, D>::VEC;
  constexpr int LPR = Shape<T, D>::LPR;
  constexpr int NG = Shape<T, D>::NG;
  constexpr int U = G <= 4 ? 4 : 2;  // slots in flight per group

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = threadIdx.x / LPR;
  const int lane = threadIdx.x % LPR;
  const int d0 = lane * VEC;
  const int Nq = Nk * G;

  // this lane's slice of the G query rows, pre-scaled
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    tg::raw_to_float<T, VEC>(tg::load_raw<T, VEC>(q + ((size_t)b * Nq + kvh * G + g) * D + d0),
                             qr[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] *= scale;
  }

  // the visible ranges: pool slots [lo, hi), in-flight slots [j0, step]
  const int len = lengths0[b];
  int lo = max(starts[b], 0);
  int j0 = 0;
  if (window > 0) {
    lo = max(lo, len + step - window + 1);
    j0 = max(step - window + 1, 0);
  }
  const int hi = min(len, MB * bs);  // never past the table, whatever len is
  const int n_pool = max(hi - lo, 0);
  const int total = n_pool + step + 1 - j0;

  // layer `layer`, kv head `kvh` of a pool block: 64-bit offsets
  const size_t block_stride = (size_t)Nk * bs * D;
  const C* kl = k_pools + (size_t)layer * n_blocks * block_stride + (size_t)kvh * bs * D;
  const C* vl = v_pools + (size_t)layer * n_blocks * block_stride + (size_t)kvh * bs * D;
  const int* tab = tables + (size_t)b * MB;
  const size_t row = (size_t)b * Nk + kvh;
  const TI* ki = k_infl + row * N * D;
  const TI* vi = v_infl + row * N * D;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // virtual slots: [0, n_pool) the pool range, [n_pool, total) in flight.
  // Every thread runs the same number of iterations, so the shuffles below
  // never diverge.
  const int n_iter = (total + NG * U - 1) / (NG * U);
  for (int it = 0; it < n_iter; ++it) {
    const int base = (it * NG + grp) * U;
    uint4 kr[U], vr[U];
    bool ok[U], pooled[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = base + u;
      ok[u] = x < total;
      pooled[u] = x < n_pool;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        if (pooled[u]) {
          const int t = lo + x;
          int blk = __ldg(tab + t / bs);
          if ((unsigned)blk >= (unsigned)n_blocks) blk = 0;  // never out of the pool
          const size_t off = (size_t)blk * block_stride + (size_t)(t % bs) * D;
          kr[u] = tg::load_raw<C, VEC>(kl + off + d0);
          vr[u] = tg::load_raw<C, VEC>(vl + off + d0);
        } else {
          const int j = j0 + (x - n_pool);
          kr[u] = tg::load_raw<TI, VEC>(ki + (size_t)j * D + d0);
          vr[u] = tg::load_raw<TI, VEC>(vi + (size_t)j * D + d0);
        }
      }
    }

    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[VEC];
      if (SAME || pooled[u]) {
        tg::raw_to_float<C, VEC>(kr[u], kv);
      } else {
        tg::raw_to_float<TI, VEC>(kr[u], kv);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc_s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc_s = fmaf(qr[g][e], kv[e], acc_s);
        // the LPR lanes of a group are aligned within the warp
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          acc_s += __shfl_xor_sync(0xffffffffu, acc_s, off);
        s[u][g] = ok[u] ? acc_s : NEG_INF;
      }
    }

#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;  // contributes by select: nothing of a hidden slot
      float vv[VEC];
      if (SAME || pooled[u]) {
        tg::raw_to_float<C, VEC>(vr[u], vv);
      } else {
        tg::raw_to_float<TI, VEC>(vr[u], vv);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
  }

  // merge the NG groups' partial states
  extern __shared__ float smem[];
  float* sacc = smem;              // [NG][G][D]
  float* sm = sacc + NG * G * D;   // [NG][G]
  float* sl = sm + NG * G;         // [NG][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) sacc[(grp * G + g) * D + d0 + e] = acc[g][e];
    if (lane == 0) {
      sm[grp * G + g] = m[g];
      sl[grp * G + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NTHREADS) {
    const int g = i / D;
    const int d = i % D;
    float M = NEG_INF;
    for (int n = 0; n < NG; ++n) M = fmaxf(M, sm[n * G + g]);
    float Lsum = 0.f, O = 0.f;
    for (int n = 0; n < NG; ++n) {
      const float w = expf(sm[n * G + g] - M);
      Lsum = fmaf(sl[n * G + g], w, Lsum);
      O = fmaf(sacc[(n * G + g) * D + d], w, O);
    }
    out[((size_t)b * Nq + kvh * G + g) * D + d] =
        tg::from_float<T>(Lsum > 0.f ? O / Lsum : 0.f);
  }
}

template <typename T, typename C, int D, int G>
cudaError_t launch(const Args& a) {
  using TI = typename tg::Inflight<T, C>::type;
  constexpr size_t smem = smem_bytes<T, D, G>();
  static const cudaError_t attr =
      tg::allow_smem(paged_decode_frozen_kernel<T, C, D, G>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Nk, a.B);
  paged_decode_frozen_kernel<T, C, D, G><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_pools),
      static_cast<const C*>(a.v_pools), a.tables, a.lengths0, a.starts,
      static_cast<const TI*>(a.k_infl), static_cast<const TI*>(a.v_infl),
      static_cast<T*>(a.out), a.Nk, a.n_blocks, a.bs, a.MB, a.N, a.layer, a.step, a.scale,
      a.window);
  return cudaGetLastError();
}

template <typename T, typename C, int D>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
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
cudaError_t launch_d(int D, int G, const Args& a) {
  if (D == 64) return launch_g<T, C, 64>(G, a);
  if (D == 128) return launch_g<T, C, 128>(G, a);
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

// out [B, Nq, D] = attention of q [B, Nq, D] over layer `layer` of the frozen
// k_pools/v_pools [L, n_blocks, Nk, bs, D] through tables [B, MB] (int32),
// slots starts[b] <= t < lengths0[b], merged with the in-flight
// k_infl/v_infl [B, Nk, N, D] at slots j <= step (and, when window > 0, pool
// slots t > lengths0[b] + step - window and in-flight step - j < window).
// q and out are of `dtype`; the pools of `kv_dtype` (= dtype, or kE4M3 with
// bf16 in-flight K/V). Returns the cudaError_t of the launch (0 on success).
int tg_paged_decode_frozen(const void* q, const void* k_pools, const void* v_pools,
                           const void* tables, const void* lengths0, const void* starts,
                           const void* k_infl, const void* v_infl, void* out, int B, int Nq,
                           int Nk, int n_blocks, int bs, int MB, int N, int D, int dtype,
                           int kv_dtype, int layer, int step, float scale, int window,
                           void* stream) {
  if (Nk <= 0 || Nq % Nk != 0 || bs <= 0 || MB <= 0 || N <= 0 || step < 0 || step >= N)
    return cudaErrorInvalidValue;
  const Args a{q,
               k_pools,
               v_pools,
               static_cast<const int*>(tables),
               static_cast<const int*>(lengths0),
               static_cast<const int*>(starts),
               k_infl,
               v_infl,
               out,
               B,
               Nk,
               n_blocks,
               bs,
               MB,
               N,
               layer,
               step,
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
