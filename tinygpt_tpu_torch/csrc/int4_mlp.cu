// The whole SwiGLU MLP of one layer in int4, for M <= 32 rows:
//   out = x + down(silu(g) * u),  [g || u] = gate_up(x * invrms * ln[layer])
//
// Replaces the TPU kernel tinygpt_tpu/ops/quant_kernels.py::
// mlp_fused_int4_stacked (K7, _mlp_kernel_int4_stacked). As there, the
// gate_up activation stays fp32 between the two matmuls (the two-call route
// rounds it to x's type).
//
// What bounds it on an H100: the packed bytes of both weights (3/2 * H * I
// bytes a layer). The two phases are two launches of the GEMV kernel of
// int4_common.cuh on the caller's stream: phase A (gate_up, with the norm
// prologue) writes the fp32 activation [M, 2I] to a scratch buffer the
// wrapper allocates, and phase B (down, with the silu * up prologue and the
// residual) reads it. The stream orders them, so no grid-wide barrier is
// needed; the activation's round trip through memory is 8 * M * I bytes,
// against 1.5 * H * I bytes of weights.

#include "int4_common.cuh"

namespace {

template <typename T>
cudaError_t launch(const tg::GemvArgs& a, const tg::GemvArgs& b, cudaStream_t stream) {
  const cudaError_t err = tg::launch_gemv<T, float>(a, stream);
  if (err != cudaSuccess) return err;
  return tg::launch_gemv<float, T>(b, stream);
}

}  // namespace

extern "C" {

// out [M, H] = x + down(silu(g) * u) with [g || u] = gate_up(x * invrms * ln):
// x [M, H] and ln [L, H] of one type (dtype code 0 fp32, 2 bf16), invrms [M]
// fp32; gate_up packed [L, Hp/2, 2I] with scales [L, Hp/group, 2I], down
// packed [L, Ip/2, H] with scales [L, Ip/group, H], where Hp >= H and
// Ip >= I are the (row-padded) contraction dims; act is fp32 [M, 2I]
// scratch. Returns the cudaError_t of the launches.
int tg_int4_mlp(const void* x, const void* gu_data, const void* gu_scales, const void* dn_data,
                const void* dn_scales, const void* ln, const void* invrms, void* act, void* out,
                int M, int H, int Hp, int I2, int Ip, int group, int layer, int dtype,
                void* stream) {
  if (H > Hp || I2 % 2 || I2 / 2 > Ip || Hp % 2 || Ip % 2 || group <= 0)
    return cudaErrorInvalidValue;
  tg::GemvArgs a = tg::plain_gemv_args(x, gu_data, gu_scales, act, M, H, Hp, I2, group, layer);
  a.ln = ln;
  a.invrms = static_cast<const float*>(invrms);
  tg::GemvArgs b =
      tg::plain_gemv_args(act, dn_data, dn_scales, out, M, I2 / 2, Ip, H, group, layer);
  b.silu = 1;
  b.res = x;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tg::kF32: return launch<float>(a, b, s);
    case tg::kBF16: return launch<__nv_bfloat16>(a, b, s);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
