// x [M, IN] @ dequant(int8 layer `layer` of a stacked [L, IN, OUT] weight)
// → [M, OUT] in x's type, accumulated in fp32.
//
// Replaces the TPU kernels tinygpt_tpu/ops/quant_kernels.py::
// matmul_dequant_int8 (K3, _int8_kernel) and matmul_dequant_int8_stacked
// (K5a, _int8_kernel_stacked). K3 is layer 0 of a one-layer stack; the layer
// is a 64-bit pointer offset, so no layer's bytes are copied (a stacked
// gate_up of the Mistral-7B shape is 3.76 GB).
//
// Weight layout (tinygpt_tpu/ops/quant.py, kept byte for byte): data int8
// [L, IN, OUT], scales fp32 [L, IN/group, OUT]; w[i, o] = q[i, o] *
// scales[i / group, o]. int8 rows are never padded, so IN is any multiple
// of the group (group % 16 == 0), 896 (7 groups of 128) and 64 included.
//
// Two regimes, as on the TPU:
// - M <= 32 (decode, the lm_head of a prefill): a GEMV bound by the weight
//   bytes (one byte a weight plus the scales). Each warp reads one row's 256
//   contiguous bytes (8 columns, 8 bytes a lane) per load, 16 rows of one
//   group in flight, dequantizes in registers (q * s rounded once, the value
//   the plain version computes) and takes the MR activation rows from shared
//   memory as broadcasts. A block owns 256 columns; its 8 warps and a cluster
//   of 8 blocks split the rows in steps of 16, as evenly as IN / 16 allows
//   (some blocks get none when IN < 128), so any IN works. The block sums
//   its warps through shared memory, block 0 of the cluster sums the 8
//   blocks' tiles through distributed shared memory and rounds once. The TPU
//   kernel scales per-group partial sums to spare its vector unit; here the
//   scale is one multiply a weight beside the MR FMAs.
// - M > 32 (prefill, 4 x 512 rows): bound by operations (2 M operations a
//   weight byte). The mma.sync structure of the int4 kernel (int4_matmul.cu):
//   each block stages a 128-row x 64-column tile of activations (cp.async)
//   and the matching 64 rows x 128 columns of int8 weights, converted
//   exactly to bf16 (|q| <= 128 fits bf16's 8-bit significand), in shared
//   memory, and multiplies them with m16n8k16 bf16 -> fp32, two stages in
//   flight. Products are scaled per group in fp32 fragments, so no
//   dequantized weight is rounded (the TPU kernel's bm > 32 branch rounds
//   w * s to bf16 first). fp32 activations go in as two bf16 parts. A last
//   stage shorter than 64 rows (IN % 64 != 0) is zero-filled.
//   No wgmma or TMA yet.

#include "int4_common.cuh"

namespace {

using tg::cp_async16;
using tg::from_float;
using tg::ldsm_x4;
using tg::to_float;

// -- M <= 32 ----------------------------------------------------------------------

constexpr int GT = tg::GEMV_THREADS, GW = tg::GEMV_WARPS;
constexpr int GBN = tg::GEMV_BN;  // columns of a block: 8 a lane
constexpr int GRP = tg::GEMV_RP;  // rows a warp has in flight (one group's, group % 16 == 0)
constexpr int GCH = tg::GEMV_CH;  // rows staged at a time
constexpr int GSK = tg::GEMV_SK;  // blocks of a cluster, splitting the rows

template <int MR>
constexpr size_t gemv_smem_bytes() {
  return sizeof(float) * (MR * GCH + GW * MR * GBN + MR * GBN);
}

template <typename T, int MR>
__global__ void __cluster_dims__(1, GSK, 1) __launch_bounds__(GT)
    int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ W,
                     const float* __restrict__ Sc, T* __restrict__ out, int M, int IN, int OUT,
                     int group) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* xs = smem;              // [MR][GCH] staged activations
  float* red = xs + MR * GCH;    // [GW][MR][GBN] the warps' partial sums
  float* tile = red + GW * MR * GBN;  // [MR][GBN] this block's partial sums

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * GBN;
  const int col = col0 + lane * 8;
  const bool col_ok = col < OUT;
  const int m0 = blockIdx.z * MR;
  const int n16 = IN / GRP;  // 16-row steps, split over the cluster's blocks
  const int r0 = (int)((long long)blockIdx.y * n16 / GSK) * GRP;
  const int r1 = (int)((long long)(blockIdx.y + 1) * n16 / GSK) * GRP;

  float acc[MR][8];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int c0 = r0; c0 < r1; c0 += GCH) {
    __syncthreads();
    for (int i = tid; i < MR * GCH; i += GT) {
      const int m = i / GCH;
      const int c = c0 + i % GCH;
      xs[i] = (m0 + m < M && c < r1) ? to_float<T>(x[(size_t)(m0 + m) * IN + c]) : 0.f;
    }
    __syncthreads();
    const int p0 = c0 + warp * GRP;
    if (col_ok && p0 < r1) {  // r1 - p0 is a multiple of 16: all 16 rows are ours
      float s[8];
      const float4* sp = reinterpret_cast<const float4*>(Sc + (size_t)(p0 / group) * OUT + col);
      const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
      s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
      s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
      uint2 w[GRP];
#pragma unroll
      for (int r = 0; r < GRP; ++r)
        w[r] = __ldg(reinterpret_cast<const uint2*>(W + (size_t)(p0 + r) * OUT + col));
      const float* xw = xs + (p0 - c0);
#pragma unroll
      for (int r = 0; r < GRP; ++r) {
        float xm[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) xm[m] = xw[m * GCH + r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int8_t q = static_cast<int8_t>(((j < 4 ? w[r].x : w[r].y) >> (8 * (j & 3))) & 0xFFu);
          const float wf = static_cast<float>(q) * s[j];
#pragma unroll
          for (int m = 0; m < MR; ++m) acc[m][j] = fmaf(xm[m], wf, acc[m][j]);
        }
      }
    }
  }

  // sum the block's warps, then the cluster's blocks
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(warp * MR + m) * GBN + lane * 8 + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < MR * GBN; i += GT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < GW; ++w) s += red[w * MR * GBN + i];
    tile[i] = s;
  }
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = tid; i < MR * GBN; i += GT) {
      const int m = i / GBN, c = col0 + i % GBN;
      if (m0 + m >= M || c >= OUT) continue;
      float s = 0.f;
      for (int q = 0; q < GSK; ++q) s += cluster.map_shared_rank(tile, q)[i];
      out[(size_t)(m0 + m) * OUT + c] = from_float<T>(s);
    }
  }
  cluster.sync();  // every block's tile stays alive until block 0 has read it
}

template <typename T, int MR>
cudaError_t launch_int8_gemv(const T* x, const int8_t* W, const float* Sc, T* out, int M, int IN,
                        int OUT, int group, cudaStream_t stream) {
  constexpr size_t smem = gemv_smem_bytes<MR>();
  static const cudaError_t attr = tg::allow_smem(int8_gemv_kernel<T, MR>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((OUT + GBN - 1) / GBN, GSK, (M + MR - 1) / MR);
  int8_gemv_kernel<T, MR><<<grid, GT, smem, stream>>>(x, W, Sc, out, M, IN, OUT, group);
  return cudaGetLastError();
}

// -- M > 32 -----------------------------------------------------------------------

constexpr int BM = 128;  // rows of a block tile
constexpr int BN = 128;  // columns of a block tile
constexpr int KC = 64;   // weight rows a stage holds
constexpr int NTHREADS = 256;
constexpr int WPAD = 8;  // bf16 row padding of the weight tile, against bank conflicts
constexpr int WLD = KC + WPAD;
constexpr int SROWS = KC / 16;  // scale rows a stage reads: one per 16 rows

// Activations are staged as they are (bf16, or fp32 split into two bf16
// parts when a fragment is built); rows padded against bank conflicts.
template <typename T>
struct XTile {
  static constexpr int LD = KC + 16 / sizeof(T);   // elements a row
  static constexpr int VECS = KC * sizeof(T) / 16;  // 16-byte copies a row
  static constexpr int STAGE = BM * LD;             // elements
};

template <typename T>
constexpr size_t tc_smem_bytes() {
  return 2 * XTile<T>::STAGE * sizeof(T) + BN * WLD * sizeof(__nv_bfloat16) +
         2 * SROWS * BN * sizeof(float);
}

// Byte j of a (row k) and byte j of b (row k + 1), each a signed q, as the
// bf16 pair (q_a, q_b): exact, |q| <= 128.
__device__ __forceinline__ uint32_t int8_pair(uint32_t a, uint32_t b, int j) {
  const float lo = static_cast<float>(static_cast<int8_t>((a >> (8 * j)) & 0xFFu));
  const float hi = static_cast<float>(static_cast<int8_t>((b >> (8 * j)) & 0xFFu));
  return tg::pack_bf16x2(lo, hi);
}

// 8 warps as 2 (rows) x 4 (columns), each computing a 64 x 32 tile of the
// block's 128 x 128 output. W and Sc point at the layer. A two-stage
// pipeline: while a stage's 64 rows are multiplied, the next stage's
// activations and scale rows arrive by cp.async and its int8 weights into
// registers; the weights are converted to bf16 into shared memory between
// stages. Products go into one fp32 fragment set, which is scaled into the
// sums at every group boundary and at the end of the stage (scale * (a + b)
// = scale * a + scale * b within a group).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    int8_mm_tc_kernel(const T* __restrict__ x, const int8_t* __restrict__ W,
                      const float* __restrict__ Sc, T* __restrict__ out, int M, int IN, int OUT,
                      int group) {
  using X = XTile<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [2 stages][BM][X::LD]
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * X::STAGE * sizeof(T));  // [BN][WLD]
  float* ss = reinterpret_cast<float*>(ws + BN * WLD);  // [2 stages][SROWS][BN] scales

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_stages = (IN + KC - 1) / KC;

  auto issue_x = [&](int s, int p0) {
    T* dst = xs + (s % 2) * X::STAGE;
    for (int i = tid; i < BM * X::VECS; i += NTHREADS) {
      const int r = i / X::VECS;
      const int v = (i % X::VECS) * (16 / sizeof(T));
      const bool ok = m0 + r < M && p0 + v < IN;  // IN % 16 == 0: a copy is all in or out
      const T* src = x + (ok ? (size_t)(m0 + r) * IN + p0 + v : 0);
      cp_async16(dst + r * X::LD + v, src, ok);
    }
    // the scale row of each 16-row step of the stage (one 16-byte copy a
    // thread), so the group flushes below read shared memory
    for (int i = tid; i < SROWS * (BN / 4); i += NTHREADS) {
      const int row = i / (BN / 4);
      const int v = (i % (BN / 4)) * 4;
      const int k = p0 + row * 16;
      const bool ok = n0 + v < OUT && k < IN;
      cp_async16(ss + ((s % 2) * SROWS + row) * BN + v,
                 Sc + (ok ? (size_t)(k / group) * OUT + n0 + v : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n");
  };
  // this thread's 4 items of (2 rows x 4 columns) of a stage
  uint32_t wr[4][2];
  auto load_w = [&](int p0) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + it * NTHREADS;
      const int pr = (i % 8) + 8 * (i / 256);
      const int gc = n0 + ((i / 8) % 32) * 4;
      const int r = p0 + 2 * pr;
      wr[it][0] = wr[it][1] = 0u;  // q = 0 past OUT and past IN
      if (gc < OUT && r < IN) {    // IN is even: row r + 1 is in too
        wr[it][0] = __ldg(reinterpret_cast<const uint32_t*>(W + (size_t)r * OUT + gc));
        wr[it][1] = __ldg(reinterpret_cast<const uint32_t*>(W + (size_t)(r + 1) * OUT + gc));
      }
    }
  };
  auto store_w = [&]() {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + it * NTHREADS;
      const int pr = (i % 8) + 8 * (i / 256);
      const int c = ((i / 8) % 32) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&ws[(c + j) * WLD + 2 * pr]) =
            int8_pair(wr[it][0], wr[it][1], j);
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
    const T* xst = xs + (s % 2) * X::STAGE;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if (p0 + kk < IN) {
        uint32_t b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2)  // B fragments of two 8-column tiles
          ldsm_x4(&b[nt][0], &ws[(wn * 32 + nt * 8 + lane % 8 + (lane / 16) * 8) * WLD + kk +
                                 ((lane / 8) % 2) * 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          tg::MmaRows<T, X::LD>::run(xst + (wm * 64 + mt * 16) * X::LD + kk, lane, b, tmp[mt]);
        if ((p0 + kk + 16) % group == 0 || kk + 16 == KC) {  // scale into the sums
          const float* srow = ss + ((s % 2) * SROWS + kk / 16) * BN;
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
        if (row < M && c < OUT) out[(size_t)row * OUT + c] = from_float<T>(acc[mt][nt][f]);
      }
}

template <typename T>
cudaError_t launch(const void* xv, const int8_t* W, const float* Sc, void* outv, int M, int IN,
                   int OUT, int group, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  if (M <= 4) return launch_int8_gemv<T, 4>(x, W, Sc, out, M, IN, OUT, group, stream);
  if (M <= 32) return launch_int8_gemv<T, 8>(x, W, Sc, out, M, IN, OUT, group, stream);
  constexpr size_t smem = tc_smem_bytes<T>();
  static const cudaError_t attr = tg::allow_smem(int8_mm_tc_kernel<T>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((OUT + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_tc_kernel<T><<<grid, NTHREADS, smem, stream>>>(x, W, Sc, out, M, IN, OUT, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [M, OUT] = x [M, IN] @ dequant(layer `layer` of data int8 [L, IN, OUT]
// with scales fp32 [L, IN/group, OUT]), in x's type (dtype code: 0 fp32,
// 2 bf16). Needs OUT % 8 == 0, group % 16 == 0 and IN % group == 0.
// Returns the cudaError_t of the launch.
int tg_int8_matmul(const void* x, const void* data, const void* scales, void* out, int M, int IN,
                   int OUT, int group, int layer, int dtype, void* stream) {
  if (M <= 0 || IN <= 0 || OUT <= 0 || OUT % 8 || group <= 0 || group % 16 || IN % group)
    return cudaErrorInvalidValue;
  const int8_t* W = static_cast<const int8_t*>(data) + (size_t)layer * IN * OUT;
  const float* Sc = static_cast<const float*>(scales) + (size_t)layer * (IN / group) * OUT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tg::kF32: return launch<float>(x, W, Sc, out, M, IN, OUT, group, s);
    case tg::kBF16: return launch<__nv_bfloat16>(x, W, Sc, out, M, IN, OUT, group, s);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
