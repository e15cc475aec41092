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
// What bounds it and what the design does: decode_split.cuh, whose
// split-slot kernel this file instantiates without in-flight slots (K2,
// flash_decode_frozen.cu, instantiates it with them).

#include "decode_split.cuh"

extern "C" {

// out [B, Nq, D] = attention of q [B, Nq, D] over k_cache/v_cache
// [B, Nk, T, D] (one layer) at the slots where mask [B, T] != 0, split over
// clusters of C blocks (1 <= C <= 8). q and out are of `dtype`; the cache
// of `kv_dtype` (= dtype, or kE4M3). Returns the cudaError_t of the launch
// (0 on success).
int tg_flash_decode(const void* q, const void* k_cache, const void* v_cache, const void* mask,
                    void* out, int B, int Nq, int Nk, int T, int D, int dtype, int kv_dtype,
                    float scale, int C, void* stream) {
  if (Nk <= 0 || Nq % Nk != 0) return cudaErrorInvalidValue;
  const tg::DecodeArgs a{q,  k_cache, v_cache, static_cast<const uint8_t*>(mask),
                         nullptr, nullptr, out, Nk, Nq / Nk, T, 0, 0, 0, scale};
  return tg::split_decode<false>(a, B, D, dtype, kv_dtype, C, static_cast<cudaStream_t>(stream));
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
