// One-token GQA decode over one layer's paged KV pool: the stepwise decode
// step (forward_paged) of the continuous batcher.
//
// Replaces the TPU kernel
// tinygpt_tpu/ops/paged_attention.py::paged_decode_tpu (_paged_decode_kernel).
// Same function: the query q [B, Nq, D] of row b attends to the slots t of
// k_pool/v_pool [n_blocks, Nk, bs, D] (one layer), slot t living in block
// tables[b, t / bs] at offset t % bs, visible iff starts[b] <= t < lengths[b]
// (and t > lengths[b] - 1 - window when window > 0: the query sits at slot
// lengths[b] - 1, its own K/V already written into the pool). One fp32
// online softmax; a query that sees no slot is written as zeros (the JAX
// oracle gives the uniform mean there; the batcher discards such rows).
//
// What bounds it on an H100: the bytes of the visible K/V slots, read once
// (2 * B * Nk * visible * D * 2 bytes in bf16), against 4 * B * Nq * visible
// * D operations, G / 2 operations per byte in bf16 (0.5 for GPT-2's G = 1):
// bound by memory. An e4m3 pool (kv_dtype = kE4M3) halves those bytes; its
// slots are decoded to fp32 in registers by the card's conversion.
// What the design does about it: K8's pool walk (paged_decode_frozen.cu)
// without the in-flight merge. One block per (KV head, row) serves the G
// query heads of that KV head from one read of each K/V row (more than 8 are
// split over G / GT blocks, tg::group_tile). A row's visible slots form one
// contiguous range [lo, hi), so the block walks exactly the live table
// entries: a dead entry, or a slot a mask hides, is never read, and nothing
// is multiplied by a masked zero (the null block 0 holds whatever inactive
// rows wrote there). Groups of D / 8 (bf16) lanes each read one slot's K and
// V row as 16-byte vectors, several slots in flight per group, the block id
// looked up per slot; the groups' partial softmax states are merged once
// through shared memory (tg::merge_groups). Offsets into the pool are 64-bit.
// At the GPT-2 serving shape (16 rows, 12 heads) that is 192 blocks on 132
// SMs. wgmma, TMA and a split over slots are later steps.

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

template <typename T, int D, int GT>
constexpr size_t smem_bytes() {
  constexpr int NG = Shape<T, D>::NG;
  return sizeof(float) * (NG * GT * D + 2 * NG * GT);  // acc, m, l of every group
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *tables, *lengths, *starts;
  void* out;
  int B, Nk, G, n_blocks, bs, MB, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int GT>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_pool,
                        const C* __restrict__ v_pool, const int* __restrict__ tables,
                        const int* __restrict__ lengths, const int* __restrict__ starts,
                        T* __restrict__ out, int Nk, int G, int n_blocks, int bs, int MB,
                        float scale, int window) {
  constexpr int VEC = Shape<T, D>::VEC;
  constexpr int LPR = Shape<T, D>::LPR;
  constexpr int NG = Shape<T, D>::NG;
  constexpr int U = GT <= 4 ? 4 : 2;  // slots in flight per group

  const int n_tiles = G / GT;  // blocks of this KV head
  const int kvh = blockIdx.x / n_tiles;
  const int h0 = kvh * G + (blockIdx.x % n_tiles) * GT;  // the block's first query head
  const int b = blockIdx.y;
  const int grp = threadIdx.x / LPR;
  const int lane = threadIdx.x % LPR;
  const int d0 = lane * VEC;
  const int Nq = Nk * G;

  // this lane's slice of the GT query rows, pre-scaled
  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    tg::raw_to_float<T, VEC>(tg::load_raw<T, VEC>(q + ((size_t)b * Nq + h0 + g) * D + d0),
                             qr[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] *= scale;
  }

  // the visible range [lo, hi) of pool slots
  const int len = lengths[b];
  int lo = max(starts[b], 0);
  if (window > 0) lo = max(lo, len - window);
  const int hi = min(len, MB * bs);  // never past the table, whatever len is
  const int total = max(hi - lo, 0);

  // kv head `kvh` of a pool block: 64-bit offsets
  const size_t block_stride = (size_t)Nk * bs * D;
  const C* kh = k_pool + (size_t)kvh * bs * D;
  const C* vh = v_pool + (size_t)kvh * bs * D;
  const int* tab = tables + (size_t)b * MB;

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

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
        const int t = lo + x;
        int blk = __ldg(tab + t / bs);
        if ((unsigned)blk >= (unsigned)n_blocks) blk = 0;  // never out of the pool
        const size_t off = (size_t)blk * block_stride + (size_t)(t % bs) * D + d0;
        kr[u] = tg::load_raw<C, VEC>(kh + off);
        vr[u] = tg::load_raw<C, VEC>(vh + off);
      }
    }

    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[VEC];
      tg::raw_to_float<C, VEC>(kr[u], kv);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
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
    for (int g = 0; g < GT; ++g) {
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
      tg::raw_to_float<C, VEC>(vr[u], vv);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = expf(s[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
  }

  // merge the NG groups' partial states
  extern __shared__ float smem[];
  tg::merge_groups<T, D, GT, NG, VEC, NTHREADS>(m, l, acc, grp, lane,
                                               out + ((size_t)b * Nq + h0) * D, smem);
}

template <typename T, typename C, int D, int GT>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<T, D, GT>();
  static const cudaError_t attr = tg::allow_smem(paged_decode_kernel<T, C, D, GT>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Nk * (a.G / GT), a.B);
  paged_decode_kernel<T, C, D, GT><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_pool),
      static_cast<const C*>(a.v_pool), a.tables, a.lengths, a.starts, static_cast<T*>(a.out),
      a.Nk, a.G, a.n_blocks, a.bs, a.MB, a.scale, a.window);
  return cudaGetLastError();
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

// the pool is of q's type, or e4m3
template <typename T>
cudaError_t launch_c(int kv_dtype, int dtype, int D, const Args& a) {
  if (kv_dtype == dtype) return launch_d<T, T>(D, a);
  if (kv_dtype == tg::kE4M3) return launch_d<T, tg::e4m3>(D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [B, Nq, D] = attention of q [B, Nq, D] over the pool k_pool/v_pool
// [n_blocks, Nk, bs, D] (one layer) through tables [B, MB] (int32), slots
// starts[b] <= t < lengths[b] (and, when window > 0, t > lengths[b] - 1 -
// window). q and out are of `dtype`; the pool of `kv_dtype` (= dtype, or
// kE4M3). Returns the cudaError_t of the launch (0 on success).
int tg_paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                    const void* lengths, const void* starts, void* out, int B, int Nq, int Nk,
                    int n_blocks, int bs, int MB, int D, int dtype, int kv_dtype, float scale,
                    int window, void* stream) {
  if (Nk <= 0 || Nq % Nk != 0 || bs <= 0 || MB <= 0 || n_blocks <= 0)
    return cudaErrorInvalidValue;
  const Args a{q,
               k_pool,
               v_pool,
               static_cast<const int*>(tables),
               static_cast<const int*>(lengths),
               static_cast<const int*>(starts),
               out,
               B,
               Nk,
               Nq / Nk,
               n_blocks,
               bs,
               MB,
               window,
               scale,
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
