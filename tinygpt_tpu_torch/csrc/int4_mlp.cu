// The whole SwiGLU MLP of one layer in int4, for M <= 32 rows:
//   out = x + down(silu(g) * u),  [g || u] = gate_up(x * invrms * ln[layer])
// or, with the residual off, out = down(silu(g) * u): a tensor-parallel
// rank's partial sum, whose residual one rank of the group adds.
//
// Replaces the TPU kernel tinygpt_tpu/ops/quant_kernels.py::
// mlp_fused_int4_stacked (K7, _mlp_kernel_int4_stacked). As there, the
// activation between the two matmuls is not rounded to x's type (the
// two-call route rounds it): it stays fp32, or its bf16 parts within 2^-17.
//
// What bounds it on an H100: the packed bytes of both weights (3/2 * H * I
// bytes a layer). The two phases are two launches of the GEMV kernel of
// int4_common.cuh on the caller's stream, each with its own split. Phase A
// (gate_up, with the norm prologue) takes a gate column and its up column
// in one block, so its epilogue forms silu(g) * u (in fp32, then rounded
// into two bf16 parts, three with fp32 x) and writes it to a scratch
// buffer in phase B's fragment order; phase B (down, + the residual)
// copies its rows of that buffer as they are. Where I % 16 != 0 or down
// would take more than one pass, phase A writes the fp32 [M, 2I] gate || up
// and phase B's prologue forms silu(g) * u. The stream orders the two
// launches, so no grid-wide barrier is needed.

#include "int4_common.cuh"

namespace {

// The two launches' arguments: gate_up (a) and down (b), the activation's
// bf16 parts (three with fp32 x, else two) and the gated choice.
struct MlpPlan {
  tg::GemvArgs a, b;
  int parts;
};

MlpPlan mlp_plan(const void* x, const void* gu_data, const void* gu_scales, const void* dn_data,
                 const void* dn_scales, const void* ln, const void* invrms, void* act, void* out,
                 int M, int H, int Hp, int I2, int Ip, int group, int layer, int dtype,
                 int residual, int split_b) {
  MlpPlan p;
  p.a = tg::plain_gemv_args(x, gu_data, gu_scales, act, M, H, Hp, I2, group, layer);
  p.a.ln = ln;
  p.a.invrms = static_cast<const float*>(invrms);
  p.b = tg::plain_gemv_args(act, dn_data, dn_scales, out, M, I2 / 2, Ip, H, group, layer);
  p.b.silu = 1;
  p.b.res = residual ? x : nullptr;
  // gate_up's epilogue forms silu(g) * u in down's fragment order where
  // down takes all rows in one pass and the gate / up halves split into
  // 16-byte copies; else act is the fp32 [M, 2I] and down's prologue
  // forms it
  p.parts = dtype == tg::kF32 ? 3 : 2;
  const int nt = tg::gv_plan(M, Ip / 2, split_b, p.parts, false, true, I2 / 2).nt;
  if ((I2 / 2) % 16 == 0 && nt > 0 && 8 * nt >= M) {
    p.a.gated = 1;
    p.a.frag_half = Ip / 2;
    p.a.frag_nt = nt;
    p.a.frag_parts = p.parts;
    p.b.silu = 0;
    p.b.xfrag = 1;
  }
  return p;
}

bool mlp_shape_ok(int H, int Hp, int I2, int Ip, int dtype) {
  return H <= Hp && I2 % 2 == 0 && I2 / 2 <= Ip && Hp % 2 == 0 && Ip % 2 == 0 &&
         (dtype == tg::kF32 || dtype == tg::kBF16);
}

template <typename T>
cudaError_t launch(const MlpPlan& p, int split_a, int split_b, cudaStream_t stream) {
  constexpr int parts = std::is_same<T, float>::value ? 3 : 2;
  const cudaError_t err = tg::launch_gemv<T, float, parts>(p.a, split_a, stream);
  if (err != cudaSuccess) return err;
  return tg::launch_gemv<float, T, parts>(p.b, split_b, stream);
}

}  // namespace

extern "C" {

// out [M, H] = x + down(silu(g) * u) with [g || u] = gate_up(x * invrms * ln),
// without the "x +" where residual is 0: x [M, H] and ln [L, H] of one type
// (dtype code 0 fp32, 2 bf16), invrms [M] fp32; gate_up packed [L, Hp/2, 2I] with scales [L, Hp/group, 2I], down
// packed [L, Ip/2, H] with scales [L, Ip/group, H], where Hp >= H and
// Ip >= I are the (row-padded) contraction dims; act is scratch of
// max(4 M 2I, 64 Ip parts) bytes (ops/quant_kernels._mlp_act_bytes);
// split_a and split_b are the two launches' blocks a cluster (1 to 16,
// ops/quant_kernels.int4_gemv_split). Returns the cudaError_t of the
// launches.
int tg_int4_mlp(const void* x, const void* gu_data, const void* gu_scales, const void* dn_data,
                const void* dn_scales, const void* ln, const void* invrms, void* act, void* out,
                int M, int H, int Hp, int I2, int Ip, int group, int layer, int dtype,
                int residual, int split_a, int split_b, void* stream) {
  if (!mlp_shape_ok(H, Hp, I2, Ip, dtype) || group <= 0) return cudaErrorInvalidValue;
  const MlpPlan p = mlp_plan(x, gu_data, gu_scales, dn_data, dn_scales, ln, invrms, act, out, M,
                             H, Hp, I2, Ip, group, layer, dtype, residual, split_b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tg::kF32) return launch<float>(p, split_a, split_b, s);
  return launch<__nv_bfloat16>(p, split_a, split_b, s);
}

// What tg_int4_mlp launches for these arguments: plan[0] the activation's
// bf16 parts, plan[1..3] gate_up's n-tiles a pass, route and shared memory
// bytes (tg::gv_describe), plan[4] 1 where gate_up writes silu(g) * u in
// down's fragment order, plan[5..7] down's as plan[1..3]. Returns a
// cudaError_t.
int tg_int4_mlp_plan(int M, int H, int Hp, int I2, int Ip, int dtype, int split_a, int split_b,
                     int* plan) {
  if (!mlp_shape_ok(H, Hp, I2, Ip, dtype)) return cudaErrorInvalidValue;
  const MlpPlan p = mlp_plan(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, M, H, Hp, I2, Ip, 0, 0, dtype, 1, split_b);
  plan[0] = p.parts;
  tg::gv_describe(p.a, split_a, p.parts, plan + 1);
  plan[4] = p.a.gated;
  tg::gv_describe(p.b, split_b, p.parts, plan + 5);
  return cudaSuccess;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
