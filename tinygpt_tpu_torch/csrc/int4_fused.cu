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
// int4_common.cuh: the prologue is applied as the activation is formed in
// bf16 parts (two, three in fp32; each warp from the x and ln that ride its
// ring, or a block staging its rows for silu * up), the norm's invrms on the
// sums, the epilogue on the fp32 sums of the cluster's reduce-scatter. Its
// 128-column tile holds whole heads (head dim 32, 64 or 128) and a rank's
// share of the tile is whole heads, so the per-head norm and rotation run
// in one warp; each head is gated by its first column, so the q || k / v
// boundary may fall inside a tile.

#include "int4_common.cuh"

namespace {

tg::GemvArgs fused_args(const void* x, const void* data, const void* scales, const void* ln,
                        const void* invrms, const void* res, const void* bias,
                        const void* rope_cos, const void* rope_sin, const void* q_norm,
                        const void* k_norm, void* out, int M, int in_x, int IN, int OUT,
                        int group, int layer, int silu, int rope_cols, int rope_dim,
                        int qk_cols, float eps) {
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
  return a;
}

// The activation's bf16 parts: three in fp32; two for an fp32 activation
// (the norm or silu prologue) or staged x (rows not 16-byte aligned) with
// bf16 outputs; one for bf16 x as it is. 0: an unknown dtype code.
int fused_parts(int dtype, int silu, bool ln, int in_x) {
  if (dtype == tg::kF32) return 3;
  if (dtype != tg::kBF16) return 0;
  return silu || ln || in_x % 8 != 0 ? 2 : 1;
}

}  // namespace

extern "C" {

// out [M, OUT] (x's type) = epilogue(prologue(x) @ dequant(layer `layer` of
// data int8 [L, IN/2, OUT], scales fp32 [L, IN/group, OUT])). Null pointers
// are absent operands; see tg::GemvArgs for shapes. dtype code: 0 fp32,
// 2 bf16. `split` is the GEMV's blocks a cluster (1 to 16,
// ops/quant_kernels.int4_gemv_split). Returns the cudaError_t of the launch.
int tg_int4_fused(const void* x, const void* data, const void* scales, const void* ln,
                  const void* invrms, const void* res, const void* bias, const void* rope_cos,
                  const void* rope_sin, const void* q_norm, const void* k_norm, void* out, int M,
                  int in_x, int IN, int OUT, int group, int layer, int silu, int rope_cols,
                  int rope_dim, int qk_cols, float eps, int dtype, int split, void* stream) {
  if (IN <= 0 || IN % 2 || in_x > IN || group <= 0) return cudaErrorInvalidValue;
  const tg::GemvArgs a =
      fused_args(x, data, scales, ln, invrms, res, bias, rope_cos, rope_sin, q_norm, k_norm, out,
                 M, in_x, IN, OUT, group, layer, silu, rope_cols, rope_dim, qk_cols, eps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fused_parts(dtype, silu, ln != nullptr, in_x)) {
    case 3: return tg::launch_gemv<float, float, 3>(a, split, s);
    case 2: return tg::launch_gemv<__nv_bfloat16, __nv_bfloat16, 2>(a, split, s);
    case 1: return tg::launch_gemv<__nv_bfloat16, __nv_bfloat16, 1>(a, split, s);
  }
  return cudaErrorInvalidValue;
}

// What tg_int4_fused launches for these arguments (has_ln: ln is given):
// plan[0] the activation's bf16 parts, plan[1..3] the GEMV's n-tiles a
// pass, route and shared memory bytes (tg::gv_describe). Returns a
// cudaError_t.
int tg_int4_fused_plan(int M, int in_x, int IN, int OUT, int has_ln, int silu, int dtype,
                       int split, int* plan) {
  const int parts = fused_parts(dtype, silu, has_ln != 0, in_x);
  if (IN <= 0 || IN % 2 || in_x > IN || !parts) return cudaErrorInvalidValue;
  const tg::GemvArgs a =
      fused_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, M, in_x, IN, OUT, 0, 0, silu, 0, 0, 0, 0.f);
  plan[0] = parts;
  tg::gv_describe(a, split, parts, plan + 1);
  return cudaSuccess;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
