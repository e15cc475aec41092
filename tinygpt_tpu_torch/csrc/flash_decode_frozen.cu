// One-token GQA decode over layer `layer` of the frozen stacked KV cache,
// merged with the chunk's in-flight K/V.
//
// Replaces the TPU kernel
// tinygpt_tpu/ops/attention_kernels.py::flash_decode_frozen
// (_decode_frozen_kernel). Same function: the query q [B, Nq, D] attends to
// slots t of k_stack/v_stack [L, B, Nk, T, D] at layer `layer` where
// mask[b, t] != 0, and to in-flight slots j of k_infl/v_infl [B, Nk, N, D]
// where j <= step and step - j < window (window > 0). One softmax over both;
// a query that sees no slot is written as zeros.
//
// What bounds it on an H100: the bytes of the visible K/V slots, read once
// (2 * B * Nk * visible * D * 2 bytes in bf16), against 4 * B * Nq * visible
// * D operations, about 2 operations per byte for G = 4. It is bound by
// memory; an e4m3 cache (kv_dtype = kE4M3) halves the frozen bytes. Its
// slots are decoded to fp32 in registers by the card's conversion, and the
// in-flight K/V beside it are bf16, as the JAX package keeps them. What the design does about it: one block per (kv head, batch row)
// serves all G = Nq / Nk query heads from one read of each K/V row; the layer
// is addressed by pointer offset into the stacked cache, so nothing is copied;
// groups of D / 8 (bf16) lanes each read one slot's K and V row as 16-byte
// vectors, several slots in flight per group, and skip the slots the mask
// hides; the groups' partial softmax states are merged once through shared
// memory. With B = 4 and Nk = 8 that is 32 blocks on 132 SMs: correct, but it
// leaves most SMs idle (a split over T with a second merge pass is the next
// step). A KV head with more than 8 query heads is split over G / GT blocks
// of GT heads each (tg::group_tile).

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

template <typename T, typename C, int D, int GT>
__global__ void __launch_bounds__(NTHREADS)
    flash_decode_frozen_kernel(const T* __restrict__ q, const C* __restrict__ k_stack,
                               const C* __restrict__ v_stack, const uint8_t* __restrict__ mask,
                               const typename tg::Inflight<T, C>::type* __restrict__ k_infl,
                               const typename tg::Inflight<T, C>::type* __restrict__ v_infl,
                               T* __restrict__ out, int B, int Nk, int G, int Tlen, int N,
                               int layer, int step, float scale, int window) {
  using TI = typename tg::Inflight<T, C>::type;
  constexpr int VEC = Shape<T, D>::VEC;
  constexpr int LPR = Shape<T, D>::LPR;
  constexpr int NG = Shape<T, D>::NG;
  constexpr int U = GT <= 4 ? 4 : 2;  // slots in flight per group
  constexpr bool SAME = std::is_same<C, TI>::value;

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
  const C* kf = k_stack + ((size_t)layer * B * Nk + row) * Tlen * D;
  const C* vf = v_stack + ((size_t)layer * B * Nk + row) * Tlen * D;
  const TI* ki = k_infl + row * N * D;
  const TI* vi = v_infl + row * N * D;
  const uint8_t* mk = mask + (size_t)b * Tlen;

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // virtual slots: [0, T) frozen, [T, T + step + 1) in flight. Every thread
  // runs the same number of iterations, so the shuffles below never diverge.
  const int total = Tlen + step + 1;
  const int n_iter = (total + NG * U - 1) / (NG * U);
  for (int it = 0; it < n_iter; ++it) {
    const int base = (it * NG + grp) * U;
    uint4 kr[U], vr[U];
    bool ok[U], frozen[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      frozen[u] = t < Tlen;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (frozen[u]) {
        ok[u] = mk[t] != 0;
        if (ok[u]) {
          kr[u] = tg::load_raw<C, VEC>(kf + (size_t)t * D + d0);
          vr[u] = tg::load_raw<C, VEC>(vf + (size_t)t * D + d0);
        }
      } else {
        const int j = t - Tlen;
        ok[u] = j <= step && (window <= 0 || step - j < window);
        if (ok[u]) {
          kr[u] = tg::load_raw<TI, VEC>(ki + (size_t)j * D + d0);
          vr[u] = tg::load_raw<TI, VEC>(vi + (size_t)j * D + d0);
        }
      }
    }

    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[VEC];
      if (SAME || frozen[u]) {
        tg::raw_to_float<C, VEC>(kr[u], kv);
      } else {
        tg::raw_to_float<TI, VEC>(kr[u], kv);
      }
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
      if (SAME || frozen[u]) {
        tg::raw_to_float<C, VEC>(vr[u], vv);
      } else {
        tg::raw_to_float<TI, VEC>(vr[u], vv);
      }
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
  const void *q, *k_stack, *v_stack, *mask, *k_infl, *v_infl;
  void* out;
  int B, Nk, G, T, N, layer, step, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int GT>
cudaError_t launch(const Args& a) {
  using TI = typename tg::Inflight<T, C>::type;
  constexpr size_t smem = smem_bytes<T, D, GT>();
  static const cudaError_t attr =
      tg::allow_smem(flash_decode_frozen_kernel<T, C, D, GT>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Nk * (a.G / GT), a.B);
  flash_decode_frozen_kernel<T, C, D, GT><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_stack),
      static_cast<const C*>(a.v_stack), static_cast<const uint8_t*>(a.mask),
      static_cast<const TI*>(a.k_infl), static_cast<const TI*>(a.v_infl),
      static_cast<T*>(a.out), a.B, a.Nk, a.G, a.T, a.N, a.layer, a.step, a.scale, a.window);
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

// out [B, Nq, D] = attention of q [B, Nq, D] over layer `layer` of the frozen
// k_stack/v_stack [L, B, Nk, T, D] under mask [B, T], merged with the in-flight
// k_infl/v_infl [B, Nk, N, D] at slots j <= step (and step - j < window when
// window > 0). q and out are of `dtype`; the stacks of `kv_dtype` (= dtype,
// or kE4M3 with bf16 in-flight K/V). Returns the cudaError_t of the launch
// (0 on success).
int tg_flash_decode_frozen(const void* q, const void* k_stack, const void* v_stack,
                           const void* mask, const void* k_infl, const void* v_infl, void* out,
                           int B, int Nq, int Nk, int T, int N, int D, int dtype, int kv_dtype,
                           int layer, int step, float scale, int window, void* stream) {
  if (Nk <= 0 || Nq % Nk != 0) return cudaErrorInvalidValue;
  const Args a{q, k_stack, v_stack, mask,  k_infl, v_infl, out,   B,
               Nk, Nq / Nk, T,       N,     layer,  step,   window, scale,
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
