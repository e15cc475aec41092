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
// * D operations, about 2 operations per byte for G = 4: bound by memory. An
// e4m3 cache (kv_dtype = kE4M3) halves those bytes; its slots are decoded to
// fp32 in registers by the card's conversion. What the design does about it:
// K2's walk (flash_decode_frozen.cu) over one layer and without the
// in-flight merge. One block per (KV head, batch row) serves the G query
// heads of that KV head from one read of each K/V row (more than 8 are split
// over G / GT blocks, tg::group_tile); groups of D / 8 (bf16) lanes each read
// one slot's K and V row as 16-byte vectors, several slots in flight per
// group, and skip the slots the mask hides; the groups' partial softmax
// states are merged once through shared memory (tg::merge_groups). The layer
// is a view into the stacked cache, so nothing is copied. At batch 1 and 8
// KV heads that is 8 blocks on 132 SMs: correct, latency-bound; a split over
// T with a second merge pass is the next step.

#include "attention_common.cuh"

namespace {

using tg::NEG_INF;

constexpr int NTHREADS = 256;

template <typename T, int D>
struct Shape {
  static constexpr int VEC = tg::Vec<T>::N;    // elements per 16-byte load of q
  static constexpr int LPR = D / VEC;          // lanes per K/V row (8..32)
  static constexpr int NG = NTHREADS / LPR;    // slot groups per block
};

template <typename T, int D, int GT>
constexpr size_t smem_bytes() {
  constexpr int NG = Shape<T, D>::NG;
  return sizeof(float) * (NG * GT * D + 2 * NG * GT);  // acc, m, l of every group
}

template <typename T, typename C, int D, int GT>
__global__ void __launch_bounds__(NTHREADS)
    flash_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                        const C* __restrict__ v_cache, const uint8_t* __restrict__ mask,
                        T* __restrict__ out, int Nk, int G, int Tlen, float scale) {
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

  const size_t row = (size_t)b * Nk + kvh;
  const C* kc = k_cache + row * Tlen * D;
  const C* vc = v_cache + row * Tlen * D;
  const uint8_t* mk = mask + (size_t)b * Tlen;

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
  const int n_iter = (Tlen + NG * U - 1) / (NG * U);
  for (int it = 0; it < n_iter; ++it) {
    const int base = (it * NG + grp) * U;
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      ok[u] = t < Tlen && mk[t] != 0;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        kr[u] = tg::load_raw<C, VEC>(kc + (size_t)t * D + d0);
        vr[u] = tg::load_raw<C, VEC>(vc + (size_t)t * D + d0);
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

struct Args {
  const void *q, *k_cache, *v_cache, *mask;
  void* out;
  int B, Nk, G, T;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int GT>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<T, D, GT>();
  static const cudaError_t attr = tg::allow_smem(flash_decode_kernel<T, C, D, GT>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Nk * (a.G / GT), a.B);
  flash_decode_kernel<T, C, D, GT><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_cache),
      static_cast<const C*>(a.v_cache), static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.out), a.Nk, a.G, a.T, a.scale);
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
// [B, Nk, T, D] (one layer) at the slots where mask [B, T] != 0. q and out
// are of `dtype`; the cache of `kv_dtype` (= dtype, or kE4M3). Returns the
// cudaError_t of the launch (0 on success).
int tg_flash_decode(const void* q, const void* k_cache, const void* v_cache, const void* mask,
                    void* out, int B, int Nq, int Nk, int T, int D, int dtype, int kv_dtype,
                    float scale, void* stream) {
  if (Nk <= 0 || Nq % Nk != 0) return cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, mask, out, B, Nk, Nq / Nk, T, scale,
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
