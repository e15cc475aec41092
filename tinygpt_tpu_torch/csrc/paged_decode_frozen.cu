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
// What bounds it on an H100, and the design: paged_split.cuh, whose kernel
// (paged_split_kernel with INFL true) this library instantiates; K9
// (paged_decode.cu) runs the same kernel without the in-flight slots.

#include "paged_split.cuh"

extern "C" {

// out [B, Nq, D] = attention of q [B, Nq, D] over layer `layer` of the frozen
// k_pools/v_pools [L, n_blocks, Nk, bs, D] through tables [B, MB] (int32),
// slots starts[b] <= t < lengths0[b], merged with the in-flight
// k_infl/v_infl [B, Nk, N, D] at slots j <= step (and, when window > 0, pool
// slots t > lengths0[b] + step - window and in-flight step - j < window),
// split over clusters of C blocks (1 <= C <= 8). q and out are of `dtype`;
// the pools of `kv_dtype` (= dtype, or kE4M3 with bf16 in-flight K/V).
// Returns the cudaError_t of the launch (0 on success).
int tg_paged_decode_frozen(const void* q, const void* k_pools, const void* v_pools,
                           const void* tables, const void* lengths0, const void* starts,
                           const void* k_infl, const void* v_infl, void* out, int B, int Nq,
                           int Nk, int n_blocks, int bs, int MB, int N, int D, int dtype,
                           int kv_dtype, int layer, int step, float scale, int window, int C,
                           void* stream) {
  if (Nk <= 0 || Nq % Nk != 0 || bs <= 0 || MB <= 0 || N <= 0 || step < 0 || step >= N)
    return cudaErrorInvalidValue;
  const tg::PagedArgs a{q, k_pools, v_pools, static_cast<const int*>(tables),
                        static_cast<const int*>(lengths0), static_cast<const int*>(starts),
                        k_infl, v_infl, out, Nk, Nq / Nk, n_blocks, bs, MB, N, layer, step,
                        window, scale};
  return tg::paged_dispatch<true>(dtype, kv_dtype, D, a, B, C,
                                  static_cast<cudaStream_t>(stream), nullptr);
}

// What tg_paged_decode_frozen launches at split C for these types and
// sizes: out[0] the dynamic shared memory of a block (bytes), out[1] the
// blocks an SM the card runs at once (registers included). Returns the
// cudaError_t (0 on success).
int tg_paged_decode_frozen_plan(int Nq, int Nk, int MB, int D, int dtype, int kv_dtype, int C,
                                int* out) {
  if (Nk <= 0 || Nq % Nk != 0 || MB <= 0) return cudaErrorInvalidValue;
  tg::PagedArgs a{};
  a.Nk = Nk;
  a.G = Nq / Nk;
  a.MB = MB;
  return tg::paged_dispatch<true>(dtype, kv_dtype, D, a, 0, C, nullptr, out);
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
