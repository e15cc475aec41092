// One-token GQA decode over layer `layer` of the frozen stacked KV cache,
// merged with the chunk's in-flight K/V: the chunked decode loop
// (decode_steps) of every dense batch decode.
//
// Replaces the TPU kernel
// tinygpt_tpu/ops/attention_kernels.py::flash_decode_frozen
// (_decode_frozen_kernel). Same function: the query q [B, Nq, D] attends to
// slots t of k_stack/v_stack [L, B, Nk, T, D] at layer `layer` where
// mask[b, t] != 0, and to in-flight slots j of k_infl/v_infl [B, Nk, N, D]
// where j <= step and step - j < window (window > 0). One softmax over both;
// a query that sees no slot is written as zeros. The layer is a pointer
// offset into the stacked cache, so nothing is copied.
//
// What bounds it and what the design does: decode_split.cuh, K13's split
// over the slots (flash_decode.cu) with the in-flight slots as the span's
// last tile.

#include "decode_split.cuh"

extern "C" {

// out [B, Nq, D] = attention of q [B, Nq, D] over layer `layer` of the frozen
// k_stack/v_stack [L, B, Nk, T, D] under mask [B, T], merged with the in-flight
// k_infl/v_infl [B, Nk, N, D] at slots j <= step (and step - j < window when
// window > 0), split over clusters of C blocks (1 <= C <= 8). q and out are
// of `dtype`; the stacks of `kv_dtype` (= dtype, or kE4M3 with bf16
// in-flight K/V). Returns the cudaError_t of the launch (0 on success).
int tg_flash_decode_frozen(const void* q, const void* k_stack, const void* v_stack,
                           const void* mask, const void* k_infl, const void* v_infl, void* out,
                           int B, int Nq, int Nk, int T, int N, int D, int dtype, int kv_dtype,
                           int layer, int step, float scale, int window, int C, void* stream) {
  if (Nk <= 0 || Nq % Nk != 0 || N < 1 || step < 0 || step >= N || layer < 0)
    return cudaErrorInvalidValue;
  const size_t elem = kv_dtype == tg::kE4M3 ? 1 : kv_dtype == tg::kF32 ? 4 : 2;
  const size_t off = (size_t)layer * B * Nk * T * D * elem;  // bytes to the layer
  const tg::DecodeArgs a{q,
                         static_cast<const char*>(k_stack) + off,
                         static_cast<const char*>(v_stack) + off,
                         static_cast<const uint8_t*>(mask),
                         k_infl,
                         v_infl,
                         out,
                         Nk,
                         Nq / Nk,
                         T,
                         N,
                         step,
                         window,
                         scale};
  return tg::split_decode<true>(a, B, D, dtype, kv_dtype, C, static_cast<cudaStream_t>(stream));
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
