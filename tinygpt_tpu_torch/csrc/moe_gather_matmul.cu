// Gathered-expert matmuls of the MoE decode step: out[r] = x[r] @ W[layer,
// idx[r]] for rows r < R, with x [R, in_x] (bf16 or fp32), idx [R] int32,
// fp32 accumulation and one rounding to x's type.
//
// Replaces the TPU kernels tinygpt_tpu/ops/moe_kernels.py::
// moe_gather_matmul (K12, _kernel; bf16 or fp32 stacks [L, E, IN, OUT]),
// moe_gather_matmul_int8 (K11a, _int8_kernel_moe; int8 [L, E, IN, OUT] and
// fp32 scales [L, E, IN/group, OUT]) and moe_gather_matmul_int4 (K11b,
// _int4_kernel_moe; biased, half-split packed int4 [L, E, IN/2, OUT] with the
// same scales). The layer and the expert are pointer offsets into the stack:
// no expert's bytes are copied or gathered.
//
// Bound on an H100 by the bytes of the experts the rows are routed to (a
// decode step of 4 to 16 tokens, 2 experts each, does 2 to 32 operations a
// weight): each DISTINCT routed expert's bytes should be read once. The TPU
// kernel runs one grid row per routed row and so re-reads an expert for
// every row routed to it. Here the blocks are expert-major: grid z is the
// expert e, a block owns 256 output columns of W[layer, e], and it
// accumulates every row routed to e, found from idx by warp 0 (a ballot scan
// in row order). A block whose expert no row names reads nothing and exits.
// Rows are taken MR at a time (4 for R <= 8, else 8): for each group of MR
// rows the block streams its tile of the expert once, so an expert with more
// than MR rows is read again for each further group (the later reads partly
// from L2).
//
// The streaming: each warp reads RP
// contiguous rows of 256 columns at a time (8 columns a lane: 32 bytes of
// fp32, 16 of bf16, 8 of int8 or of packed int4), dequantizes in registers
// (q * s and (u - 8) * s rounded once, exactly the plain version's fp32
// weight) and takes the MR activation rows from shared memory as
// broadcasts. The block's 8 warps, and a cluster of 8 blocks where the
// experts' column tiles are few, split the expert's rows in RP-row steps;
// the block sums its warps through shared memory, and block 0 of the
// cluster sums the blocks' tiles through distributed shared memory and
// writes the rows. int4 x columns at and
// past in_x read as zeros, so a stack whose IN was row-padded at quantize
// time takes the unpadded x (the pad rows are zeros in the weight too).
// Expert ids outside [0, E) are clamped, as the plain version clamps them.
// No tensor cores, wgmma or TMA yet.

#include "int4_common.cuh"

namespace {

using tg::from_float;
using tg::to_float;

constexpr int NT = 256, NW = NT / 32;
constexpr int BN = 256;  // columns of a block: 8 a lane
// Blocks of a cluster, splitting an expert's rows: 8 when the column tiles
// of the experts are few (down: 16 tiles x 8 experts), 1 when they fill the
// card alone (gate_up: 112 x 8), where the split's reduction would cost as
// much as the block's share of the rows.
constexpr int SK_SPLIT = 8;
constexpr int MANY_BLOCKS = 4 * 132;

enum WKind : int { kBF16W = 0, kInt8W = 1, kInt4W = 2, kF32W = 3 };

struct MoeArgs {
  const void* x;      // [R, in_x]
  const void* w;      // the stack's data: [L, E, rows, OUT]
  const float* sc;    // [L, E, IN / group, OUT], null for float weights
  const int* idx;     // [R]
  void* out;          // [R, OUT]
  int R, in_x, rows, OUT, E, group, layer;
};

template <int WK>
struct WTraits {
  static constexpr bool FLOAT = WK == kBF16W || WK == kF32W;  // no scales, no groups
  static constexpr int RP = FLOAT ? 8 : 16;  // rows a warp has in flight
  static constexpr int PLANES = (WK == kInt4W) ? 2 : 1;
  static constexpr int ESIZE = WK == kF32W ? 4 : WK == kBF16W ? 2 : 1;  // bytes an element
  static constexpr int CH = NW * RP;                    // stored rows staged at a time
};

template <int WK, int MR>
constexpr size_t moe_smem_bytes() {
  using W = WTraits<WK>;
  return sizeof(float) * (MR * W::PLANES * W::CH + NW * MR * BN + MR * BN);
}

// 8 weights of stored row `r` at this lane's 8 columns, dequantized in fp32:
// wl the row (fp32, bf16, int8) or its low nibbles (int4), wh the high
// nibbles.
template <int WK>
struct RowLoad;

template <>
struct RowLoad<kBF16W> {
  uint4 v;
  __device__ __forceinline__ void load(const unsigned char* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void dq(const float*, const float*, float* wl, float*) const {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) wl[j] = __bfloat162float(e[j]);
  }
};

template <>
struct RowLoad<kF32W> {
  uint4 v[2];
  __device__ __forceinline__ void load(const unsigned char* p) {
    v[0] = __ldg(reinterpret_cast<const uint4*>(p));
    v[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  }
  __device__ __forceinline__ void dq(const float*, const float*, float* wl, float*) const {
    const float* e = reinterpret_cast<const float*>(v);
#pragma unroll
    for (int j = 0; j < 8; ++j) wl[j] = e[j];
  }
};

template <>
struct RowLoad<kInt8W> {
  uint2 v;
  __device__ __forceinline__ void load(const unsigned char* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void dq(const float* s, const float*, float* wl, float*) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wl[j] = static_cast<float>(
                  static_cast<int8_t>(((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xFFu)) *
              s[j];
  }
};

template <>
struct RowLoad<kInt4W> {
  uint2 v;
  __device__ __forceinline__ void load(const unsigned char* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void dq(const float* sl, const float* sh, float* wl,
                                     float* wh) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t b = ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xFFu;
      wl[j] = tg::dq(b & 0x0Fu, sl[j]);
      wh[j] = tg::dq(b >> 4, sh[j]);
    }
  }
};

__device__ __forceinline__ void load8(const float* p, float* s) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

template <typename T, int WK, int MR, int SK>
__global__ void __cluster_dims__(1, SK, 1) __launch_bounds__(NT)
    moe_gather_kernel(MoeArgs a) {
  using W = WTraits<WK>;
  constexpr int RP = W::RP, CH = W::CH, P = W::PLANES;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* xs = smem;                  // [MR][P][CH] staged activations
  float* red = xs + MR * P * CH;     // [NW][MR][BN] the warps' partial sums
  float* tile = red + NW * MR * BN;  // [MR][BN] this block's partial sums
  __shared__ int s_rows[MR];         // the rows of this group, routed to e
  __shared__ int s_n, s_next;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.z;
  const int col0 = blockIdx.x * BN;
  const int col = col0 + lane * 8;
  const bool col_ok = col < a.OUT;
  const int rows = a.rows;                    // stored rows (IN, or IN/2 packed)
  const int IN = rows * (WK == kInt4W ? 2 : 1);
  const int nstep = (rows + RP - 1) / RP;     // RP-row steps, split over the cluster
  const int r0 = (int)((long long)blockIdx.y * nstep / SK) * RP;
  const int r1 = min((int)((long long)(blockIdx.y + 1) * nstep / SK) * RP, rows);
  const size_t slab = (size_t)a.layer * a.E + e;
  const unsigned char* Wb =
      static_cast<const unsigned char*>(a.w) + slab * rows * a.OUT * W::ESIZE;
  const float* Sc = a.sc == nullptr ? nullptr : a.sc + slab * (IN / a.group) * a.OUT;
  const T* x = static_cast<const T*>(a.x);

  int next = 0;  // the first row not yet looked at
  for (;;) {
    if (warp == 0) {  // the next MR rows routed to e, in row order
      int n = 0, c = next;
      while (c < a.R && n < MR) {
        const int i = c + lane;
        const bool hit = i < a.R && min(max(a.idx[i], 0), a.E - 1) == e;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        const int before = __popc(m & ((1u << lane) - 1u));
        if (hit && n + before < MR) s_rows[n + before] = i;
        const int total = __popc(m);
        if (n + total > MR) {  // stop after the hit that fills the group
          unsigned mm = m;
          for (int t = 1; t < MR - n; ++t) mm &= mm - 1u;
          c += __ffs(mm);
          n = MR;
        } else {
          n += total;
          c += 32;
        }
      }
      if (lane == 0) {
        s_n = n;
        s_next = min(c, a.R);
      }
    }
    __syncthreads();
    const int n = s_n;
    next = s_next;
    if (n == 0) break;  // the same in every block of the cluster (same e, same idx)

    float acc[MR][8];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

    for (int c0 = r0; c0 < r1; c0 += CH) {
      __syncthreads();
      for (int i = tid; i < MR * P * CH; i += NT) {
        const int m = i / (P * CH);
        const int plane = (i / CH) % P;
        const int c = c0 + i % CH;
        const int xc = plane * rows + c;  // the x column of stored row c
        float v = 0.f;
        if (m < n && c < r1 && xc < a.in_x) v = to_float<T>(x[(size_t)s_rows[m] * a.in_x + xc]);
        xs[i] = v;
      }
      __syncthreads();
      const int p0 = c0 + warp * RP;
      if (col_ok && p0 < r1) {
        // the warp's RP rows lie inside one group (group % 16 == 0)
        float s_lo[8] = {}, s_hi[8] = {};
        if constexpr (!W::FLOAT) load8(Sc + (size_t)(p0 / a.group) * a.OUT + col, s_lo);
        if constexpr (WK == kInt4W)
          load8(Sc + (size_t)((rows + p0) / a.group) * a.OUT + col, s_hi);
        RowLoad<WK> w[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          if (!W::FLOAT || p0 + r < r1)  // a float stack's last step may be short
            w[r].load(Wb + ((size_t)(p0 + r) * a.OUT + col) * W::ESIZE);
          else
            w[r] = RowLoad<WK>{};
        }
        const float* xw = xs + (p0 - c0);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          float wl[8], wh[8];
          w[r].dq(s_lo, s_hi, wl, wh);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xl = xw[(m * P) * CH + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xl, wl[j], acc[m][j]);
            if constexpr (WK == kInt4W) {
              const float xh = xw[(m * P + 1) * CH + r];
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xh, wh[j], acc[m][j]);
            }
          }
        }
      }
    }

    // sum the block's warps, then the cluster's blocks
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(warp * MR + m) * BN + lane * 8 + j] = acc[m][j];
    __syncthreads();
    for (int i = tid; i < MR * BN; i += NT) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) s += red[q * MR * BN + i];
      tile[i] = s;
    }
    cluster.sync();
    if (cluster.block_rank() == 0) {
      T* out = static_cast<T*>(a.out);
      for (int i = tid; i < MR * BN; i += NT) {
        const int m = i / BN, c = col0 + i % BN;
        if (m >= n || c >= a.OUT) continue;
        float s = 0.f;
        for (int q = 0; q < SK; ++q) s += cluster.map_shared_rank(tile, q)[i];
        out[(size_t)s_rows[m] * a.OUT + c] = from_float<T>(s);
      }
    }
    cluster.sync();  // every tile (and s_rows) stays as it is until block 0 has read it
  }
}

template <typename T, int WK, int MR, int SK>
cudaError_t launch_sk(const MoeArgs& a, cudaStream_t stream) {
  constexpr size_t smem = moe_smem_bytes<WK, MR>();
  static const cudaError_t attr = tg::allow_smem(moe_gather_kernel<T, WK, MR, SK>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.OUT + BN - 1) / BN, SK, a.E);
  moe_gather_kernel<T, WK, MR, SK><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int WK, int MR>
cudaError_t launch_mr(const MoeArgs& a, cudaStream_t stream) {
  if ((long long)((a.OUT + BN - 1) / BN) * a.E >= MANY_BLOCKS)
    return launch_sk<T, WK, MR, 1>(a, stream);
  return launch_sk<T, WK, MR, SK_SPLIT>(a, stream);
}

template <int WK>
cudaError_t launch(const MoeArgs& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case tg::kF32:
      return a.R <= 8 ? launch_mr<float, WK, 4>(a, stream) : launch_mr<float, WK, 8>(a, stream);
    case tg::kBF16:
      return a.R <= 8 ? launch_mr<__nv_bfloat16, WK, 4>(a, stream)
                      : launch_mr<__nv_bfloat16, WK, 8>(a, stream);
  }
  return cudaErrorInvalidValue;
}

MoeArgs args(const void* x, const void* w, const void* scales, const void* idx, void* out, int R,
             int in_x, int rows, int OUT, int E, int group, int layer) {
  MoeArgs a{};
  a.x = x;
  a.w = w;
  a.sc = static_cast<const float*>(scales);
  a.idx = static_cast<const int*>(idx);
  a.out = out;
  a.R = R;
  a.in_x = in_x;
  a.rows = rows;
  a.OUT = OUT;
  a.E = E;
  a.group = group;
  a.layer = layer;
  return a;
}

bool bad_common(int R, int in_x, int rows, int OUT, int E, int layer) {
  return R <= 0 || in_x <= 0 || rows <= 0 || OUT <= 0 || OUT % 8 || E <= 0 || E > 65535 ||
         layer < 0;
}

}  // namespace

extern "C" {

// K12: out [R, OUT] = x [R, IN] @ w[layer, idx[r]] of a float stack [L, E,
// IN, OUT] (wdtype code 2: bf16, 0: fp32), in x's type (dtype code: 0 fp32,
// 2 bf16). Needs OUT % 8 == 0. Returns the cudaError_t of the launch.
int tg_moe_gather_float(const void* x, const void* w, const void* idx, void* out, int R,
                        int IN, int OUT, int E, int layer, int dtype, int wdtype,
                        void* stream) {
  if (bad_common(R, IN, IN, OUT, E, layer)) return cudaErrorInvalidValue;
  const MoeArgs a = args(x, w, nullptr, idx, out, R, IN, IN, OUT, E, 0, layer);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wdtype) {
    case tg::kBF16: return launch<kBF16W>(a, dtype, s);
    case tg::kF32: return launch<kF32W>(a, dtype, s);
  }
  return cudaErrorInvalidValue;
}

// K11a: the same for int8 data [L, E, IN, OUT] with fp32 scales [L, E,
// IN/group, OUT]. Needs group % 16 == 0, IN % group == 0, OUT % 8 == 0.
int tg_moe_gather_int8(const void* x, const void* data, const void* scales, const void* idx,
                       void* out, int R, int IN, int OUT, int E, int group, int layer, int dtype,
                       void* stream) {
  if (bad_common(R, IN, IN, OUT, E, layer) || group <= 0 || group % 16 || IN % group)
    return cudaErrorInvalidValue;
  return launch<kInt8W>(args(x, data, scales, idx, out, R, IN, IN, OUT, E, group, layer),
                        dtype, static_cast<cudaStream_t>(stream));
}

// K11b: the same for packed int4 data [L, E, IN/2, OUT] (biased nibbles, row
// p and row IN/2 + p in one byte) with fp32 scales [L, E, IN/group, OUT];
// x [R, in_x] with in_x <= IN (the columns past in_x are the zero pad rows of
// a row-padded stack). Needs group % 16 == 0, (IN/2) % group == 0,
// OUT % 8 == 0.
int tg_moe_gather_int4(const void* x, const void* data, const void* scales, const void* idx,
                       void* out, int R, int in_x, int IN, int OUT, int E, int group, int layer,
                       int dtype, void* stream) {
  const int half = IN / 2;
  if (bad_common(R, in_x, half, OUT, E, layer) || IN % 2 || in_x > IN || group <= 0 ||
      group % 16 || half % group)
    return cudaErrorInvalidValue;
  return launch<kInt4W>(args(x, data, scales, idx, out, R, in_x, half, OUT, E, group, layer),
                        dtype, static_cast<cudaStream_t>(stream));
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
