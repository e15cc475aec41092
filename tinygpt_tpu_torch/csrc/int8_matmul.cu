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
// - M <= 32 (decode, the lm_head of a prefill): a GEMV. What bounds it on an
//   H100 is the weight bytes, one byte a weight plus the fp32 scales, read
//   once (the Mistral-7B head: 134 MB, 0.0414 ms at 3.35 TB/s). At four
//   rows the card must also spend about six instructions a weight, close to
//   its issue rate at that byte rate, so the design reads at the memory's
//   rate with as few instructions as it can:
//   - Fill the card. A block owns 256 columns (8 a lane) of MR = 4 or 8
//     activation rows. The C blocks of a thread-block cluster split IN in
//     16-row units, C planned on the host from M, IN, OUT and the SM count
//     (ops/quant_kernels.gemv_split, up to a non-portable cluster of 16),
//     and the block's 8 warps split its units again. Blocks and warps that
//     get no rows hold zeros. The plan aims at about three blocks for four
//     SMs: on the H100 that beat two blocks an SM at every Mistral-7B
//     shape, as the cp.async ring beat TMA bulk copies, deeper rings and
//     16-row stages (PERF.md).
//   - Stage once, then stream. The block copies its slice of the MR
//     activation rows into shared memory as fp32, under one barrier, while
//     its first weight loads are in flight. Then each warp streams its rows
//     through its own ring of NS = 3 stages of 8 rows x 256 columns, 16-byte
//     cp.async (8-byte where OUT % 16 != 0 leaves rows unaligned), two
//     stages in flight, with no block barrier: cp.async.wait_group and a
//     __syncwarp order each stage for the warp that copied it.
//   - Few instructions a weight. A byte becomes a float by one byte permute
//     into the magic number 2^23 (0x4B0000uu, uu = q ^ 0x80, the float
//     2^23 + q + 128) and one subtraction of 2^23 + 128, exact for every q
//     in [-128, 127]. The MR products x * q are summed per group in fp32,
//     and each group's sum is multiplied by the group's scale once per
//     column and row, as _int8_kernel does; the scale row is fetched a group
//     ahead of its use.
//   - The block sums its warps through shared memory; the cluster's blocks
//     then reduce-scatter through distributed shared memory (rank r sums
//     the C tiles at its share of the columns and writes them, rounded
//     once).
//   This rounds differently from the plain version, which rounds q * s once
//   a weight and sums x * (q * s): here s * sum(x * q) is rounded once a
//   group. Both stay within the kernels' tolerance (fp32 1e-4, bf16 one
//   ulp of the largest output, chip_smoke.QUANT_TOL).
//   What is left: the small matrices (o, qkv) stream at well under the
//   memory's rate, their time the launch, the first loads' latency and
//   the cluster's reduction; why clusters of some sizes place slowly is
//   not known; tensor cores (mma.sync or wgmma on int8 converted to bf16)
//   at 8 to 32 rows, where the FMAs bound the kernel and MR = 8 re-reads
//   the weight for every 8 rows.
// - M > 32 (prefill, 4 x 512 rows, a verify round's 80): bound by
//   operations (2 M operations a weight byte). bf16 activations run the
//   wgmma + TMA kernel of dequant_mm_tc.cuh (shared with int4_matmul.cu):
//   each weight dequantized to bf16(q * s) in registers as wgmma's A
//   operand, x the B operand, the host's plan (tile, split) filling the
//   card. fp32 activations (no main path on the card runs them) keep the
//   mma.sync kernel below: each block stages a 128-row x 64-column tile of
//   activations (cp.async, split exactly into three bf16 parts, x = hi + mid +
//   lo, each multiplied) and the matching 64 rows x 128 columns of weights,
//   converted exactly to bf16 (|q| <= 128), and scales the fp32 fragments
//   per group, so no dequantized weight is rounded. A last stage shorter
//   than 64 rows (IN % 64 != 0) is zero-filled.


#include "dequant_mm_tc.cuh"

namespace {

using tg::cp_async16;
using tg::from_float;
using tg::ldsm_x4;
using tg::to_float;

// -- M <= 32 ----------------------------------------------------------------------

constexpr int GT = 256, GW = GT / 32;  // threads and warps of a block
constexpr int GBN = 256;               // columns of a block: 8 a lane
constexpr int UNIT = 16;               // rows of the split's unit (group % 16 == 0)
constexpr int SR = 8;                  // weight rows of a ring stage
constexpr int NS = 3;                  // stages of a warp's ring
constexpr int STAGE = SR * GBN;        // bytes of a stage
constexpr int MAX_SPLIT = 16;          // blocks of a cluster (above 8: non-portable)

template <int MR>
struct Gemv {
  static constexpr int RING = GW * NS * STAGE;   // the warps' rings
  static constexpr int RED = GW * MR * GBN * 4;  // the warps' sums, after the walk
  static constexpr int SCRATCH = RING > RED ? RING : RED;
  static constexpr int TILE = MR * GBN;          // floats of the block's sums
  // scratch, the block's tile, then its activation rows as fp32 [MR][rows]
  static size_t bytes(int rows) { return SCRATCH + 4 * ((size_t)TILE + (size_t)rows * MR); }
};

// An 8- or 16-byte copy into shared memory; zeros when !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async_z(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 8 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte J of `biased` (a weight byte q ^ 0x80 = q + 128) as a float: the
// permute makes the bits 0x4B0000uu, the float 2^23 + q + 128, and the
// subtraction leaves q, exactly.
template <int J>
__device__ __forceinline__ float int8_at(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | J)) - 8388736.f;
}

template <typename T, int MR, bool WIDE>
__global__ void __launch_bounds__(GT, MR == 4 ? 2 : 1)
    int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ W,
                     const float* __restrict__ Sc, T* __restrict__ out, int M, int IN, int OUT,
                     int group) {
  using G = Gemv<MR>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem + G::SCRATCH);  // [MR][GBN]
  float* xs = tile + G::TILE;                                  // [MR][rows]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = (blockIdx.x / C) * GBN;
  const int col = col0 + lane * 8;
  const bool col_ok = col < OUT;  // OUT % 8 == 0: a lane's 8 columns are all in or out
  const int m0 = blockIdx.y * MR;
  // the block's rows [k0, k0 + nk) and the warp's [r0, r1), in 16-row units
  const int n16 = IN / UNIT;
  const int u0 = (int)((long long)rank * n16 / C);
  const int nu = (int)((long long)(rank + 1) * n16 / C) - u0;
  const int k0 = u0 * UNIT, nk = nu * UNIT;
  const int r0 = k0 + (warp * nu / GW) * UNIT;
  const int n_st = ((warp + 1) * nu / GW - warp * nu / GW) * (UNIT / SR);

  // stage i of the warp's rows into slot i % NS of its ring
  unsigned char* ring = smem + warp * NS * STAGE;
  auto issue = [&](int i) {
    const int r = r0 + i * SR;
    unsigned char* dst = ring + (i % NS) * STAGE;
    if constexpr (WIDE) {  // 16 bytes a copy: two rows a warp instruction
#pragma unroll
      for (int c = 0; c < STAGE / 16 / 32; ++c) {
        const int row = 2 * c + lane / 16;
        const int cc = (lane % 16) * 16;
        const bool ok = col0 + cc < OUT;  // OUT % 16 == 0
        cp_async_z<16>(dst + row * GBN + cc, ok ? W + (size_t)(r + row) * OUT + col0 + cc : W,
                       ok);
      }
    } else {  // rows are only 8-byte aligned: each lane copies its own columns
#pragma unroll
      for (int row = 0; row < SR; ++row)
        cp_async_z<8>(dst + row * GBN + lane * 8, col_ok ? W + (size_t)(r + row) * OUT + col : W,
                      col_ok);
    }
  };
  // the scales of row r's group at this lane's 8 columns
  float s[8];
  auto fetch_scales = [&](int r) {
    if (col_ok) {
      const float4* sp = reinterpret_cast<const float4*>(Sc + (size_t)(r / group) * OUT + col);
      const float4 a = __ldg(sp), b = __ldg(sp + 1);
      s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
      s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = 0.f;
    }
  };

#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < n_st) issue(p);
    cp_commit();
  }
  if (n_st > 0) fetch_scales(r0);

  // the block's activation rows as fp32 [MR][nk], zeros past M, while the
  // weights fly: 16-byte loads (k0 and IN are multiples of 16 rows)
  constexpr int XV = 16 / sizeof(T);
  const int nv = nk / XV;
  for (int i = tid; i < MR * nv; i += GT) {
    const int m = i / nv, k = (i % nv) * XV;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + m < M) raw = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * IN + k0 + k));
    const T* e = reinterpret_cast<const T*>(&raw);
    float4* d = reinterpret_cast<float4*>(xs + (size_t)m * nk + k);
#pragma unroll
    for (int j = 0; j < XV / 4; ++j)
      d[j] = make_float4(to_float<T>(e[4 * j]), to_float<T>(e[4 * j + 1]),
                         to_float<T>(e[4 * j + 2]), to_float<T>(e[4 * j + 3]));
  }
  __syncthreads();

  float acc[MR][8], part[MR][8];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = part[m][j] = 0.f;

  for (int i = 0; i < n_st; ++i) {
    cp_wait<NS - 2>();  // stage i has landed (for this lane's copies)
    __syncwarp();       // ... and for the warp's; slot (i - 1) % NS is free
    if (i + NS - 1 < n_st) issue(i + NS - 1);
    cp_commit();
    const unsigned char* st = ring + (i % NS) * STAGE + lane * 8;
    const int r = r0 + i * SR;
#pragma unroll
    for (int r4 = 0; r4 < SR; r4 += 4) {  // the MR activations of 4 rows: MR broadcasts
      float4 xv[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m)
        xv[m] = *reinterpret_cast<const float4*>(xs + (size_t)m * nk + (r - k0) + r4);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const uint2 wv = *reinterpret_cast<const uint2*>(st + (r4 + rr) * GBN);
        const uint32_t lo = wv.x ^ 0x80808080u, hi = wv.y ^ 0x80808080u;
        float q[8];
        q[0] = int8_at<0>(lo); q[1] = int8_at<1>(lo); q[2] = int8_at<2>(lo); q[3] = int8_at<3>(lo);
        q[4] = int8_at<0>(hi); q[5] = int8_at<1>(hi); q[6] = int8_at<2>(hi); q[7] = int8_at<3>(hi);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float xm = rr == 0 ? xv[m].x : rr == 1 ? xv[m].y : rr == 2 ? xv[m].z : xv[m].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) part[m][j] = fmaf(xm, q[j], part[m][j]);
        }
      }
    }
    if ((r + SR) % group == 0 || i == n_st - 1) {  // the group ends: scale its sums once
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[m][j] = fmaf(s[j], part[m][j], acc[m][j]);
          part[m][j] = 0.f;
        }
      if (i + 1 < n_st) fetch_scales(r + SR);
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // sum the block's warps, then reduce-scatter the cluster's blocks
  float* red = reinterpret_cast<float*>(smem);  // [GW][MR][GBN]
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float4* d = reinterpret_cast<float4*>(red + (warp * MR + m) * GBN + lane * 8);
    d[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    d[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int i = tid; i < MR * GBN; i += GT) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GW; ++w) sum += red[w * MR * GBN + i];
    tile[i] = sum;
  }
  cluster.sync();
  const int c_lo = rank * GBN / C;
  const int nc = (rank + 1) * GBN / C - c_lo;
  for (int i = tid; i < MR * nc; i += GT) {
    const int m = i / nc, c = c_lo + i % nc;
    float v[MAX_SPLIT];  // every rank's value in flight at once, then summed in rank order
#pragma unroll
    for (int b = 0; b < MAX_SPLIT; ++b)
      v[b] = b < C ? cluster.map_shared_rank(tile, b)[m * GBN + c] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < MAX_SPLIT; ++b) sum += v[b];
    if (m0 + m < M && col0 + c < OUT) out[(size_t)(m0 + m) * OUT + col0 + c] = from_float<T>(sum);
  }
  cluster.sync();  // every block's tile stays alive until the cluster has read it
}

template <typename T, int MR, bool WIDE>
cudaError_t launch_int8_gemv(const T* x, const int8_t* W, const float* Sc, T* out, int M, int IN,
                             int OUT, int group, int split, cudaStream_t stream) {
  auto kernel = int8_gemv_kernel<T, MR, WIDE>;
  const size_t smem = Gemv<MR>::bytes((IN / UNIT + split - 1) / split * UNIT);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static const cudaError_t attr = [kernel] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((OUT + GBN - 1) / GBN * split, (M + MR - 1) / MR, 1);
  cfg.blockDim = dim3(GT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, W, Sc, out, M, IN, OUT, group);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int MR>
cudaError_t launch_gemv(const T* x, const int8_t* W, const float* Sc, T* out, int M, int IN,
                        int OUT, int group, int split, cudaStream_t stream) {
  if (OUT % 16 == 0)
    return launch_int8_gemv<T, MR, true>(x, W, Sc, out, M, IN, OUT, group, split, stream);
  return launch_int8_gemv<T, MR, false>(x, W, Sc, out, M, IN, OUT, group, split, stream);
}

// -- M > 32, fp32 activations -------------------------------------------------------

constexpr int BM = 128;  // rows of a block tile
constexpr int BN = 128;  // columns of a block tile
constexpr int KC = 64;   // weight rows a stage holds
constexpr int NTHREADS = 256;
constexpr int WPAD = 8;  // bf16 row padding of the weight tile, against bank conflicts
constexpr int WLD = KC + WPAD;
constexpr int SROWS = KC / 16;  // scale rows a stage reads: one per 16 rows
constexpr int XLD = KC + 4;     // floats a staged activation row (padded against bank conflicts)
constexpr int XSTAGE = BM * XLD;
constexpr size_t F32_SMEM = 2 * XSTAGE * sizeof(float) + BN * WLD * sizeof(__nv_bfloat16) +
                            2 * SROWS * BN * sizeof(float);

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
__global__ void __launch_bounds__(NTHREADS)
    int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ W,
                       const float* __restrict__ Sc, float* __restrict__ out, int M, int IN,
                       int OUT, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [2 stages][BM][XLD]
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * XSTAGE * sizeof(float));  // [BN][WLD]
  float* ss = reinterpret_cast<float*>(ws + BN * WLD);  // [2 stages][SROWS][BN] scales

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_stages = (IN + KC - 1) / KC;

  auto issue_x = [&](int s, int p0) {
    float* dst = xs + (s % 2) * XSTAGE;
    for (int i = tid; i < BM * (KC / 4); i += NTHREADS) {
      const int r = i / (KC / 4);
      const int v = (i % (KC / 4)) * 4;
      const bool ok = m0 + r < M && p0 + v < IN;  // IN % 16 == 0: a copy is all in or out
      const float* src = x + (ok ? (size_t)(m0 + r) * IN + p0 + v : 0);
      cp_async16(dst + r * XLD + v, src, ok);
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
    const float* xst = xs + (s % 2) * XSTAGE;
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
          tg::MmaRows<XLD>::run(xst + (wm * 64 + mt * 16) * XLD + kk, lane, b, tmp[mt]);
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
        if (row < M && c < OUT) out[(size_t)row * OUT + c] = acc[mt][nt][f];
      }
}

template <typename T>
cudaError_t launch(const void* xv, const int8_t* W, const float* Sc, void* outv, int M, int IN,
                   int OUT, int group, int split, int tile, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  if (M <= 32 && (split < 1 || split > MAX_SPLIT)) return cudaErrorInvalidValue;
  if (M <= 4) return launch_gemv<T, 4>(x, W, Sc, out, M, IN, OUT, group, split, stream);
  if (M <= 32) return launch_gemv<T, 8>(x, W, Sc, out, M, IN, OUT, group, split, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tg::dqmm::launch<tg::dqmm::Int8>(x, W, Sc, out, M, IN, OUT, group, split, tile,
                                             stream);
  } else {
    static const cudaError_t attr = tg::allow_smem(int8_mm_f32_kernel, F32_SMEM);
    if (attr != cudaSuccess) return attr;
    dim3 grid((OUT + BN - 1) / BN, (M + BM - 1) / BM);
    int8_mm_f32_kernel<<<grid, NTHREADS, F32_SMEM, stream>>>(x, W, Sc, out, M, IN, OUT, group);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// out [M, OUT] = x [M, IN] @ dequant(layer `layer` of data int8 [L, IN, OUT]
// with scales fp32 [L, IN/group, OUT]), in x's type (dtype code: 0 fp32,
// 2 bf16). Needs OUT % 8 == 0, group % 16 == 0 and IN % group == 0. At
// M <= 32, `split` (1 to 16) is the GEMV's blocks a cluster, splitting IN
// (ops/quant_kernels.gemv_split), and `tile` is not read; at M > 32 with
// bf16, `split` (1 to 8) and `tile` (128 or 256) are the wgmma kernel's
// plan (ops/quant_kernels.dequant_mm_plan); fp32 at M > 32 reads neither.
// Returns the cudaError_t of the launch.
int tg_int8_matmul(const void* x, const void* data, const void* scales, void* out, int M, int IN,
                   int OUT, int group, int layer, int dtype, int split, int tile, void* stream) {
  if (M <= 0 || IN <= 0 || OUT <= 0 || OUT % 8 || group <= 0 || group % 16 || IN % group)
    return cudaErrorInvalidValue;
  const int8_t* W = static_cast<const int8_t*>(data) + (size_t)layer * IN * OUT;
  const float* Sc = static_cast<const float*>(scales) + (size_t)layer * (IN / group) * OUT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tg::kF32: return launch<float>(x, W, Sc, out, M, IN, OUT, group, split, tile, s);
    case tg::kBF16:
      return launch<__nv_bfloat16>(x, W, Sc, out, M, IN, OUT, group, split, tile, s);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
