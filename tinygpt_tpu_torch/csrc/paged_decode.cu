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
// What bounds it on an H100, and the design: paged_split.cuh, K8's split
// over the block table, whose kernel (paged_split_kernel with INFL false:
// the pool range alone, no in-flight tile) this library instantiates, the
// one layer's pool passed as layer 0 of a stack. (One block a (KV head,
// row), the block id looked up per slot and its K/V rows consumed at once,
// left 192 blocks on 132 SMs at the GPT-2 serving shape, the longest row
// of 1,023 slots setting the time.)

#include "paged_split.cuh"

extern "C" {

// out [B, Nq, D] = attention of q [B, Nq, D] over the pool k_pool/v_pool
// [n_blocks, Nk, bs, D] (one layer) through tables [B, MB] (int32), slots
// starts[b] <= t < lengths[b] (and, when window > 0, t > lengths[b] - 1 -
// window), split over clusters of C blocks (1 <= C <= 8). q and out are of
// `dtype`; the pool of `kv_dtype` (= dtype, or kE4M3). Returns the
// cudaError_t of the launch (0 on success).
int tg_paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                    const void* lengths, const void* starts, void* out, int B, int Nq, int Nk,
                    int n_blocks, int bs, int MB, int D, int dtype, int kv_dtype, float scale,
                    int window, int C, void* stream) {
  if (Nk <= 0 || Nq % Nk != 0 || bs <= 0 || MB <= 0 || n_blocks <= 0)
    return cudaErrorInvalidValue;
  const tg::PagedArgs a{q, k_pool, v_pool, static_cast<const int*>(tables),
                        static_cast<const int*>(lengths), static_cast<const int*>(starts),
                        nullptr, nullptr, out, Nk, Nq / Nk, n_blocks, bs, MB, 0, 0, 0,
                        window, scale};
  return tg::paged_dispatch<false>(dtype, kv_dtype, D, a, B, C,
                                   static_cast<cudaStream_t>(stream), nullptr);
}

// What tg_paged_decode launches at split C for these types and sizes:
// out[0] the dynamic shared memory of a block (bytes), out[1] the blocks an
// SM the card runs at once (registers included). Returns the cudaError_t (0
// on success).
int tg_paged_decode_plan(int Nq, int Nk, int MB, int D, int dtype, int kv_dtype, int C,
                         int* out) {
  if (Nk <= 0 || Nq % Nk != 0 || MB <= 0) return cudaErrorInvalidValue;
  tg::PagedArgs a{};
  a.Nk = Nk;
  a.G = Nq / Nk;
  a.MB = MB;
  return tg::paged_dispatch<false>(dtype, kv_dtype, D, a, 0, C, nullptr, out);
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
