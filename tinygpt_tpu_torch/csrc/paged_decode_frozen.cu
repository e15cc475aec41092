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

template <typename T, int D, int G>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_frozen_kernel(const T* __restrict__ q, const T* __restrict__ k_pools,
                               const T* __restrict__ v_pools, const int* __restrict__ tables,
                               const int* __restrict__ lengths0, const int* __restrict__ starts,
                               const T* __restrict__ k_infl, const T* __restrict__ v_infl,
                               T* __restrict__ out, int Nk, int n_blocks, int bs, int MB, int N,
                               int layer, int step, float scale, int window) {
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
    tg::unpack<T>(tg::load16(q + ((size_t)b * Nq + kvh * G + g) * D + d0), qr[g]);
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
  const T* kl = k_pools + (size_t)layer * n_blocks * block_stride + (size_t)kvh * bs * D;
  const T* vl = v_pools + (size_t)layer * n_blocks * block_stride + (size_t)kvh * bs * D;
  const int* tab = tables + (size_t)b * MB;
  const size_t row = (size_t)b * Nk + kvh;
  const T* ki = k_infl + row * N * D;
  const T* vi = v_infl + row * N * D;

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
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = base + u;
      ok[u] = x < total;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        const T* kp;
        const T* vp;
        if (x < n_pool) {
          const int t = lo + x;
          int blk = __ldg(tab + t / bs);
          if ((unsigned)blk >= (unsigned)n_blocks) blk = 0;  // never out of the pool
          const size_t off = (size_t)blk * block_stride + (size_t)(t % bs) * D;
          kp = kl + off;
          vp = vl + off;
        } else {
          const int j = j0 + (x - n_pool);
          kp = ki + (size_t)j * D;
          vp = vi + (size_t)j * D;
        }
        kr[u] = tg::load16(kp + d0);
        vr[u] = tg::load16(vp + d0);
      }
    }

    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[VEC];
      tg::unpack<T>(kr[u], kv);
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
      tg::unpack<T>(vr[u], vv);
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

template <typename T, int D, int G>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<T, D, G>();
  static const cudaError_t attr = tg::allow_smem(paged_decode_frozen_kernel<T, D, G>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Nk, a.B);
  paged_decode_frozen_kernel<T, D, G><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pools),
      static_cast<const T*>(a.v_pools), a.tables, a.lengths0, a.starts,
      static_cast<const T*>(a.k_infl), static_cast<const T*>(a.v_infl), static_cast<T*>(a.out),
      a.Nk, a.n_blocks, a.bs, a.MB, a.N, a.layer, a.step, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 3: return launch<T, D, 3>(a);
    case 4: return launch<T, D, 4>(a);
    case 5: return launch<T, D, 5>(a);
    case 6: return launch<T, D, 6>(a);
    case 7: return launch<T, D, 7>(a);
    case 8: return launch<T, D, 8>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(int D, int G, const Args& a) {
  if (D == 64) return launch_g<T, 64>(G, a);
  if (D == 128) return launch_g<T, 128>(G, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [B, Nq, D] = attention of q [B, Nq, D] over layer `layer` of the frozen
// k_pools/v_pools [L, n_blocks, Nk, bs, D] through tables [B, MB] (int32),
// slots starts[b] <= t < lengths0[b], merged with the in-flight
// k_infl/v_infl [B, Nk, N, D] at slots j <= step (and, when window > 0, pool
// slots t > lengths0[b] + step - window and in-flight step - j < window).
// Returns the cudaError_t of the launch (0 on success).
int tg_paged_decode_frozen(const void* q, const void* k_pools, const void* v_pools,
                           const void* tables, const void* lengths0, const void* starts,
                           const void* k_infl, const void* v_infl, void* out, int B, int Nq,
                           int Nk, int n_blocks, int bs, int MB, int N, int D, int dtype,
                           int layer, int step, float scale, int window, void* stream) {
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
    case tg::kF32: return launch_d<float>(D, G, a);
    case tg::kF16: return launch_d<__half>(D, G, a);
    case tg::kBF16: return launch_d<__nv_bfloat16>(D, G, a);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
