// The decode-shaped int4 dequant matmul of one layer, with the elementwise
// steps around it fused in.
//
// Replaces the TPU kernel tinygpt_tpu/ops/quant_kernels.py::
// matmul_dequant_int4_stacked_fused (K6, _int4_kernel_stacked_fused). Same
// function, for M <= 32 rows:
//   prologue   x * invrms[m] * ln[layer]      (the RMS-norm, invrms given)
//           or silu(gate) * up                (x = gate || up)
//              zero activations past in_x when the weight's rows were padded
//   matmul     @ dequant(layer `layer` of the packed int4 stack), fp32 sums
//   epilogue   + bias[layer], then per-head RMS-norm on the fp32 sums with
//              q_norm (heads below qk_cols) or k_norm (qwen3), then RoPE
//              (rotate-half) on heads below rope_cols, then + res
//
// What bounds it on an H100: the packed weight bytes (decode at batch 4 does
// about 16 operations a byte), and the decode step's launch count, which is
// why the elementwise steps ride inside. The body is the GEMV kernel of
// int4_common.cuh. Its 256-column tile holds whole heads (head dim 32, 64
// or 128), so the per-head norm and rotation run on the tile in shared
// memory; each head is gated by its first column, so the q || k / v
// boundary may fall inside a tile.

#include "int4_common.cuh"

extern "C" {

// out [M, OUT] (x's type) = epilogue(prologue(x) @ dequant(layer `layer` of
// data int8 [L, IN/2, OUT], scales fp32 [L, IN/group, OUT])). Null pointers
// are absent operands; see tg::GemvArgs for shapes. dtype code: 0 fp32,
// 2 bf16. Returns the cudaError_t of the launch.
int tg_int4_fused(const void* x, const void* data, const void* scales, const void* ln,
                  const void* invrms, const void* res, const void* bias, const void* rope_cos,
                  const void* rope_sin, const void* q_norm, const void* k_norm, void* out, int M,
                  int in_x, int IN, int OUT, int group, int layer, int silu, int rope_cols,
                  int rope_dim, int qk_cols, float eps, int dtype, void* stream) {
  if (IN <= 0 || IN % 2 || in_x > IN || group <= 0) return cudaErrorInvalidValue;
  tg::GemvArgs a = tg::plain_gemv_args(x, data, scales, out, M, in_x, IN, OUT, group, layer);
  a.ln = ln;
  a.invrms = static_cast<const float*>(invrms);
  a.res = res;
  a.bias = bias;
  a.rope_cos = static_cast<const float*>(rope_cos);
  a.rope_sin = static_cast<const float*>(rope_sin);
  a.q_norm = q_norm;
  a.k_norm = k_norm;
  a.silu = silu;
  a.rope_cols = rope_cols;
  a.rope_dim = rope_dim;
  a.qk_cols = qk_cols;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tg::kF32: return tg::launch_gemv<float, float>(a, s);
    case tg::kBF16: return tg::launch_gemv<__nv_bfloat16, __nv_bfloat16>(a, s);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
