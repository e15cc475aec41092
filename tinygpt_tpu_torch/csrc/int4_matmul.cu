// x [M, IN] @ dequant(int4 layer `layer` of a stacked [L, IN/2, OUT] weight)
// → [M, OUT] in x's type, accumulated in fp32.
//
// Replaces the TPU kernels tinygpt_tpu/ops/quant_kernels.py::
// matmul_dequant_int4 (K4, _int4_kernel) and matmul_dequant_int4_stacked
// (K5b, _int4_kernel_stacked). K4 is layer 0 of a one-layer stack; the layer
// is a pointer offset, so no layer's bytes are copied.
//
// Two regimes, as on the TPU:
// - M <= 32 (decode-shaped, the lm_head of a prefill): the GEMV kernel of
//   int4_common.cuh (tensor cores, one pass over the packed weight, the
//   host's split over a cluster). Bound by the packed weight bytes.
// - M > 32 (prefill-shaped, 4 x 512 rows; a verify round's 80): bound by
//   operations (about 4 M operations a packed byte). bf16 activations run
//   the wgmma + TMA kernel of dequant_mm_tc.cuh (shared with
//   int8_matmul.cu): each nibble dequantized to bf16(q * s) in registers as
//   wgmma's A operand, both nibble planes' activations the B operand, the
//   host's plan (tile, split) filling the card. fp32 activations (no main
//   path on the card runs them) keep the mma.sync kernel below: each block
//   stages a 128-row x 64-column tile of each nibble plane's activations
//   (cp.async, split exactly into three bf16 parts, x = hi + mid + lo,
//   each multiplied) and
//   the matching 64 packed rows x 128 columns of weights, unpacked to
//   (u - 8) in bf16 (exact), and scales the fp32 fragments per group, so
//   no dequantized weight is rounded.

#include "dequant_mm_tc.cuh"

namespace {

using tg::cp_async16;
using tg::from_float;
using tg::ldsm_x4;

constexpr int BM = 128;  // rows of a block tile
constexpr int BN = 128;  // columns of a block tile
constexpr int KC = 64;   // packed rows a stage holds
constexpr int NTHREADS = 256;
constexpr int WPAD = 8;  // bf16 row padding of the weight tile, against bank conflicts
constexpr int XLD = KC + 4;           // floats a staged activation row (padded against bank conflicts)
constexpr int XSTAGE = 2 * BM * XLD;  // floats of a stage: both planes
constexpr int SROWS = 2 * (KC / 16);  // scale rows a stage reads: a plane's per 16 rows
constexpr size_t F32_SMEM = 2 * XSTAGE * sizeof(float) +
                            2 * BN * (KC + WPAD) * sizeof(__nv_bfloat16) +
                            2 * SROWS * BN * sizeof(float);

// Byte j of a (row k) and byte j of b (row k + 1), each a biased nibble u,
// as the bf16 pair (u_a - 8, u_b - 8): the byte goes into the mantissa of
// bf16 128 (0x43XX is 128 + XX), and 136 is subtracted. Exact, and a third
// of the instructions of an int-to-float conversion per weight.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t a, uint32_t b, int j) {
  uint32_t t = __byte_perm(a, b, j * 0x11 + (4 + j) * 0x1100);
  t = (t & 0x00FF00FFu) | 0x43004300u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 warps as 2 (rows) x 4 (columns), each computing a 64 x 32 tile of the
// block's 128 x 128 output. W and Sc point at the layer. A two-stage
// pipeline: while a stage's 64 packed rows are multiplied, the next stage's
// activations arrive by cp.async and its packed weights into registers;
// the weights are unpacked to (u - 8) in bf16 into shared memory between
// stages. Each nibble plane is multiplied in turn into one fp32 fragment
// set, which is scaled into the sums at every group boundary and at the end
// of the stage (scale * (a + b) = scale * a + scale * b within a group).
__global__ void __launch_bounds__(NTHREADS)
    int4_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ W,
                       const float* __restrict__ Sc, float* __restrict__ out, int M, int half,
                       int OUT, int group) {
  constexpr int WLD = KC + WPAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [2 stages][2 planes][BM][XLD]
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * XSTAGE * sizeof(float));  // [2][BN][WLD]
  float* ss = reinterpret_cast<float*>(ws + 2 * BN * WLD);  // [2 stages][SROWS][BN] scales

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int IN = 2 * half;
  const int hi_groups = half / group;  // scale row offset of the high plane
  const int n_stages = half / KC;

  auto issue_x = [&](int s, int p0) {
    float* dst = xs + (s % 2) * XSTAGE;
    for (int i = tid; i < 2 * BM * (KC / 4); i += NTHREADS) {
      const int plane = i / (BM * (KC / 4));
      const int r = (i / (KC / 4)) % BM;
      const int v = (i % (KC / 4)) * 4;
      const bool ok = m0 + r < M;
      const float* src = x + (size_t)(ok ? m0 + r : 0) * IN + plane * half + p0 + v;
      cp_async16(dst + (plane * BM + r) * XLD + v, src, ok);
    }
    // the scale row of each plane and 16-row step of the stage (one 16-byte
    // copy a thread), so the group flushes below read shared memory
    for (int i = tid; i < SROWS * (BN / 4); i += NTHREADS) {
      const int row = i / (BN / 4), plane = row / (KC / 16);
      const int v = (i % (BN / 4)) * 4;
      const int gi = (p0 + (row % (KC / 16)) * 16) / group + plane * hi_groups;
      const bool ok = n0 + v < OUT;
      cp_async16(ss + ((s % 2) * SROWS + row) * BN + v, Sc + (size_t)gi * OUT + (ok ? n0 + v : 0),
                 ok);
    }
    asm volatile("cp.async.commit_group;\n");
  };
  // this thread's 4 items of (2 packed rows x 4 columns) of a stage
  uint32_t wr[4][2];
  auto load_w = [&](int p0) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + it * NTHREADS;
      const int pr = (i % 8) + 8 * (i / 256);
      const int gc = n0 + ((i / 8) % 32) * 4;
      wr[it][0] = wr[it][1] = 0x88888888u;  // u = 8 is q = 0 past OUT
      if (gc < OUT) {
        wr[it][0] = __ldg(reinterpret_cast<const uint32_t*>(W + (size_t)(p0 + 2 * pr) * OUT + gc));
        wr[it][1] =
            __ldg(reinterpret_cast<const uint32_t*>(W + (size_t)(p0 + 2 * pr + 1) * OUT + gc));
      }
    }
  };
  auto store_w = [&]() {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + it * NTHREADS;
      const int pr = (i % 8) + 8 * (i / 256);
      const int c = ((i / 8) % 32) * 4;
      const uint32_t la = wr[it][0] & 0x0F0F0F0Fu, lb = wr[it][1] & 0x0F0F0F0Fu;
      const uint32_t ha = (wr[it][0] >> 4) & 0x0F0F0F0Fu, hb = (wr[it][1] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(&ws[(0 * BN + c + j) * WLD + 2 * pr]) = nibble_pair(la, lb, j);
        *reinterpret_cast<uint32_t*>(&ws[(1 * BN + c + j) * WLD + 2 * pr]) = nibble_pair(ha, hb, j);
      }
    }
  };

  float acc[4][4][4], tmp[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = tmp[mt][nt][e] = 0.f;

  issue_x(0, 0);
  load_w(0);
  for (int s = 0; s < n_stages; ++s) {
    const int p0 = s * KC;
    __syncthreads();  // the previous stage is done with ws and with this x buffer's twin
    store_w();
    if (s + 1 < n_stages) {
      issue_x(s + 1, p0 + KC);
      load_w(p0 + KC);
      asm volatile("cp.async.wait_group 1;\n");
    } else {
      asm volatile("cp.async.wait_group 0;\n");
    }
    __syncthreads();
    const float* xst = xs + (s % 2) * XSTAGE;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2)  // B fragments of two 8-column tiles
          ldsm_x4(&b[nt][0], &ws[(plane * BN + wn * 32 + nt * 8 + lane % 8 + (lane / 16) * 8) * WLD +
                                 kk + ((lane / 8) % 2) * 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          tg::MmaRows<XLD>::run(xst + (plane * BM + wm * 64 + mt * 16) * XLD + kk, lane, b,
                                tmp[mt]);
        if ((p0 + kk + 16) % group == 0 || kk + 16 == KC) {  // scale into the sums
          const float* srow = ss + ((s % 2) * SROWS + plane * (KC / 16) + kk / 16) * BN;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float sc = srow[wn * 32 + nt * 8 + t4 * 2 + e];  // 0 past OUT
#pragma unroll
              for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  acc[mt][nt][h * 2 + e] = fmaf(sc, tmp[mt][nt][h * 2 + e], acc[mt][nt][h * 2 + e]);
                  tmp[mt][nt][h * 2 + e] = 0.f;
                }
            }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = m0 + wm * 64 + mt * 16 + gid + (f >= 2 ? 8 : 0);
        const int c = n0 + wn * 32 + nt * 8 + t4 * 2 + (f & 1);
        if (row < M && c < OUT) out[(size_t)row * OUT + c] = acc[mt][nt][f];
      }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* W, const float* Sc, void* out, int M, int IN,
                   int OUT, int group, int split, int tile, cudaStream_t stream) {
  if (M <= 32) {
    tg::GemvArgs a = tg::plain_gemv_args(x, W, Sc, out, M, IN, IN, OUT, group, 0);
    constexpr int parts = std::is_same<T, __nv_bfloat16>::value ? 1 : 3;
    return tg::launch_gemv<T, T, parts>(a, split, stream);
  }
  if ((IN / 2) % KC != 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tg::dqmm::launch<tg::dqmm::Int4>(x, W, Sc, out, M, IN / 2, OUT, group, split, tile,
                                             stream);
  } else {
    static const cudaError_t attr = tg::allow_smem(int4_mm_f32_kernel, F32_SMEM);
    if (attr != cudaSuccess) return attr;
    dim3 grid((OUT + BN - 1) / BN, (M + BM - 1) / BM);
    int4_mm_f32_kernel<<<grid, NTHREADS, F32_SMEM, stream>>>(static_cast<const float*>(x), W, Sc,
                                                             static_cast<float*>(out), M, IN / 2,
                                                             OUT, group);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// out [M, OUT] = x [M, IN] @ dequant(layer `layer` of data int8 [L, IN/2, OUT]
// with scales fp32 [L, IN/group, OUT]), in x's type (dtype code: 0 fp32,
// 2 bf16). Needs OUT % 8 == 0, group % 16 == 0, (IN/2) % group == 0 and
// (IN/2) % 128 == 0. At M <= 32, `split` (1 to 16) is the GEMV's blocks a
// cluster (ops/quant_kernels.int4_gemv_split); at M > 32 with bf16, `split`
// (1 to 8) and `tile` (128 or 256) are the wgmma kernel's plan
// (ops/quant_kernels.dequant_mm_plan); fp32 at M > 32 reads neither.
// Returns the cudaError_t of the launch.
int tg_int4_matmul(const void* x, const void* data, const void* scales, void* out, int M, int IN,
                   int OUT, int group, int layer, int dtype, int split, int tile, void* stream) {
  if (M <= 0 || IN <= 0 || IN % 2 || OUT % 8 || group <= 0 || group % 16 || (IN / 2) % group)
    return cudaErrorInvalidValue;
  const int8_t* W = static_cast<const int8_t*>(data) + (size_t)layer * (IN / 2) * OUT;
  const float* Sc = static_cast<const float*>(scales) + (size_t)layer * (IN / group) * OUT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tg::kF32: return launch<float>(x, W, Sc, out, M, IN, OUT, group, split, tile, s);
    case tg::kBF16:
      return launch<__nv_bfloat16>(x, W, Sc, out, M, IN, OUT, group, split, tile, s);
  }
  return cudaErrorInvalidValue;
}

// The GEMV's plan for tg_int4_matmul's arguments at M <= 32 and split
// `split` (tg::gv_describe): plan[0..2] = its n-tiles a pass, its route and
// its shared memory bytes. Returns a cudaError_t.
int tg_int4_matmul_plan(int M, int IN, int OUT, int dtype, int split, int* plan) {
  if (M <= 0 || M > 32 || IN <= 0 || IN % 2 || (dtype != tg::kF32 && dtype != tg::kBF16))
    return cudaErrorInvalidValue;
  const tg::GemvArgs a =
      tg::plain_gemv_args(nullptr, nullptr, nullptr, nullptr, M, IN, IN, OUT, 0, 0);
  tg::gv_describe(a, split, dtype == tg::kF32 ? 3 : 1, plan);
  return cudaSuccess;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
