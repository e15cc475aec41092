// The prefill regime (M > 32, bf16 activations) of the dequant-matmul
// kernels K3/K5a (int8_matmul.cu) and K4/K5b (int4_matmul.cu): one kernel
// template on Hopper's wgmma, fed by TMA, parameterised on how a weight
// byte becomes bf16 (Int8, Int4 below).
//
// Replaces the bm > 32 branch (dequant_full) of the TPU kernels
// tinygpt_tpu/ops/quant_kernels.py::_int8_kernel_stacked and
// _int4_kernel_stacked, and computes what it computes: out[M, OUT] =
// x[M, IN] @ W with W[k, o] = bf16(q[k, o] * s[k / group, o]), each
// dequantized weight rounded to bf16 once (fp32 product, then bf16, as
// `wd.astype(mxu_dtype)` there), products summed in fp32, one rounding of
// the output. The weight layouts are the JAX package's, byte for byte.
//
// What bounds it on an H100: operations. The Mistral-7B prefill's four
// matmuls of a layer at M = 2048 do 893 GFLOP, 0.903 ms at 989 TFLOP/s,
// against 0.07 ms for their int8 bytes; at M = 80 (a verify round) the two
// bounds meet. So the products must run on wgmma, and the conversion of
// each weight (done M / N times in all) must hide under them.
//
// Design:
// - The product is taken transposed, out^T = W^T x^T: the weight is wgmma's
//   A operand, from registers. Each consumer thread converts the weights of
//   its own A fragment (two adjacent columns, rows k, k+1, k+8, k+9 of each
//   16-row step) from the raw bytes in shared memory straight into bf16
//   registers, scale included; no converted tile goes through shared
//   memory. The activations are the B operand: [N rows of x][64 k] tiles,
//   K-major, 128-byte swizzled; a block's N rows of x (128 or 256) are
//   wgmma's N.
// - A block owns 128 weight columns: two consumer warpgroups of 64, each a
//   m64nNk16 a 16-row step. A producer warpgroup, whose one thread issues
//   the copies, keeps a ring of stages in flight by TMA (mbarriers: full
//   with the copies' bytes, empty with one arrival a consumer warp). A
//   stage holds the x tile of 64 k (int4: two, one a nibble plane, at
//   columns p0 and IN/2 + p0), the raw weight tile, 64 rows x 128 bytes,
//   128-byte swizzled so that a warp's 16-bit fragment loads fall on 16
//   distinct banks, and the scale rows its 64 rows touch. Where OUT % 16
//   != 0 the weight rows are not 16-byte aligned for TMA: the producer warp
//   copies that tile with cp.async into the same swizzled layout, each
//   lane's copies arriving on the stage's barrier. Reads past M, OUT or IN
//   are zeros (TMA's fill, cp.async's zero fill).
// - The products go in commit groups of two wgmma (int4: one 16-row step,
//   its two planes; int8: two steps), NB = 4 / SUB groups a stage; a
//   warpgroup keeps up to NB - 1 groups in flight while its threads
//   convert the next group's fragments into another of NB buffers. The
//   conversion: the four 16-bit loads of a step combined by two byte
//   permutes; a byte (int8: q ^ 0x80) or nibble permuted into the float
//   2^23 + u, one subtraction (exact: q), one multiplication by the fp32
//   scale, and one rounding of two weights into a bf16 pair: about four
//   instructions a weight.
// - The plan (ops/quant_kernels.dequant_mm_plan) picks N and a split of
//   the stages over the C blocks of a thread-block cluster, so that small
//   M fills the card. The C fp32 partial tiles meet in shared memory: each
//   block sums its share of the rows over the cluster's blocks through
//   distributed shared memory, in rank order, and rounds once.
// - Registers go by whole warpgroups: the producer warpgroup drops to 40
//   (setmaxnreg), the two consumer warpgroups take 232 (128 fp32
//   accumulators a thread at N = 256).
// Measured on the H100 (PERF.md): scales read from global memory a
// step ahead, instead of with the stage, were the largest cost; TMA
// multicast of each x tile to two column tiles was no faster. What is
// left: the conversion overlaps the products only in part.
#pragma once

#include <cooperative_groups.h>

#include <cstring>

#include "hopper_common.cuh"
#include "int4_common.cuh"

namespace tg {
namespace {
namespace dqmm {

constexpr int BN = 128;                // weight columns of a block
constexpr int KT = 64;                 // weight rows (int8) or packed rows (int4) a stage
constexpr int NCONS = 256;             // threads of the two consumer warpgroups
constexpr int NTHREADS = NCONS + 128;  // and the producer warpgroup
constexpr int RAW = KT * BN;           // bytes of a stage's raw weight tile
constexpr int PART_LD = BN + 8;        // floats a row of a split's partial tile
constexpr int MAX_SPLIT = 8;           // blocks of a cluster
constexpr int SMEM_MAX = 227 * 1024;

// Shared memory: ns stages, then the barriers. A stage holds the x tile
// or tiles, the raw weight tile and the stage's scale rows (sr rows of 128
// fp32 a plane: the groups its 64 rows touch), every stage 1024-byte
// aligned for the 128-byte swizzle. The host sets sr and ns (stages());
// a split's partial tile [N][PART_LD] fp32 reuses the ring.
template <int PLANES, int N>
struct Layout {
  static constexpr int X = N * 128;  // an x tile: N rows of 64 bf16
  static constexpr int RAW_OFF = PLANES * X;
  static constexpr int SC_OFF = RAW_OFF + RAW;
  static constexpr int PART = N * PART_LD * 4;
  __host__ __device__ static int stage_bytes(int sr) {
    return (SC_OFF + PLANES * sr * BN * 4 + 1023) / 1024 * 1024;
  }
  // the ring's stages: as many as fit, at most 8
  static int stages(int sr) {
    const int ns = (SMEM_MAX - 1024 - 16 * 8) / stage_bytes(sr);
    return ns < 8 ? ns : 8;
  }
  static size_t bytes(int sr, int ns) { return 1024 + (size_t)ns * stage_bytes(sr) + 16 * ns; }
};

// The float 2^23 + u, u byte J of w, less `bias`.
template <int J>
__device__ __forceinline__ float magic(uint32_t w, float bias) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | J)) - bias;
}

// A thread's A fragment of one 16-row step from its four 16-bit loads:
// rows k, k+1, k+8, k+9 (L0..L3) at its columns (c, c+1), which are the
// fragment's rows g and g + 8. Register 0 holds (c; k, k+1), 1 (c+1; k,
// k+1), 2 (c; k+8, k+9), 3 (c+1; k+8, k+9), the lower k in the low half.
struct Int8 {
  static constexpr int PLANES = 1;
  static constexpr int SUB = 2;  // 16-row steps a wgmma group: two products a commit
  static __device__ __forceinline__ void frag(uint32_t L0, uint32_t L1, uint32_t L2, uint32_t L3,
                                              const float2 (&s)[1], uint32_t (&a)[1][4]) {
    constexpr float BIAS = 8388736.f;  // 2^23 + 128: q ^ 0x80 = q + 128
    // bytes (k, c), (k+1, c), (k, c+1), (k+1, c+1), each q + 128
    const uint32_t u = __byte_perm(L0, L1, 0x5140) ^ 0x80808080u;
    const uint32_t v = __byte_perm(L2, L3, 0x5140) ^ 0x80808080u;
    a[0][0] = pack_bf16x2(magic<0>(u, BIAS) * s[0].x, magic<1>(u, BIAS) * s[0].x);
    a[0][1] = pack_bf16x2(magic<2>(u, BIAS) * s[0].y, magic<3>(u, BIAS) * s[0].y);
    a[0][2] = pack_bf16x2(magic<0>(v, BIAS) * s[0].x, magic<1>(v, BIAS) * s[0].x);
    a[0][3] = pack_bf16x2(magic<2>(v, BIAS) * s[0].y, magic<3>(v, BIAS) * s[0].y);
  }
};

// int4: a packed byte holds the biased nibbles u = q + 8 of row p (low,
// plane 0) and row IN/2 + p (high, plane 1); s[plane] is that row's scale.
struct Int4 {
  static constexpr int PLANES = 2;
  static constexpr int SUB = 1;  // one step a group: its two planes are two products
  static __device__ __forceinline__ void frag(uint32_t L0, uint32_t L1, uint32_t L2, uint32_t L3,
                                              const float2 (&s)[2], uint32_t (&a)[2][4]) {
    constexpr float BIAS = 8388616.f;  // 2^23 + 8
    const uint32_t u = __byte_perm(L0, L1, 0x5140), v = __byte_perm(L2, L3, 0x5140);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t un = (p ? u >> 4 : u) & 0x0F0F0F0Fu;
      const uint32_t vn = (p ? v >> 4 : v) & 0x0F0F0F0Fu;
      a[p][0] = pack_bf16x2(magic<0>(un, BIAS) * s[p].x, magic<1>(un, BIAS) * s[p].x);
      a[p][1] = pack_bf16x2(magic<2>(un, BIAS) * s[p].y, magic<3>(un, BIAS) * s[p].y);
      a[p][2] = pack_bf16x2(magic<0>(vn, BIAS) * s[p].x, magic<1>(vn, BIAS) * s[p].x);
      a[p][3] = pack_bf16x2(magic<2>(vn, BIAS) * s[p].y, magic<3>(vn, BIAS) * s[p].y);
    }
  }
};

// D[64 x N] += A[64 x 16] B[16 x N]: A the register fragment, B K-major
// from shared memory (its descriptor db), fp32 accumulators.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Keeps a fragment's registers alive up to here: the wgmma that read them
// asynchronously has finished.
template <int P>
__device__ __forceinline__ void keep(const uint32_t (&a)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[p][j]) : "memory");
}

// out [M, OUT] = x [M, IN] @ dequant(W); W points at the layer's weight,
// `rows` is IN (int8) or IN/2 (int4). Grid: (M tiles x C, column tiles),
// clusters of C along x. tma_w: the raw weight tiles come by TMA (OUT % 16
// == 0), else by the producer warp's cp.async. map_s is the layer's scales
// [IN / group][OUT], sr rows a box; ns stages in the ring.
template <class Conv, int N>
__global__ void __launch_bounds__(NTHREADS, 1)
    dequant_mm_tc(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_s, const int8_t* __restrict__ W,
                  __nv_bfloat16* __restrict__ out, int M, int rows, int OUT, int group, int sr,
                  int ns, bool tma_w) {
  constexpr int P = Conv::PLANES;
  using L = Layout<P, N>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int stage_bytes = L::stage_bytes(sr);
  const uint32_t full0 = smem_u32(sm + ns * stage_bytes), empty0 = full0 + 8 * ns;
  const int m0 = (blockIdx.x / C) * N;
  const int n0 = blockIdx.y * BN;
  // this block's stages of the k walk: rank r of C takes [r n / C, (r + 1) n / C)
  const int n_all = (rows + KT - 1) / KT;
  const int st0 = rank * n_all / C;
  const int n_st = (rank + 1) * n_all / C - st0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full0 + 8 * s, tma_w ? 1 : 1 + 32);  // + the copying lanes' arrivals
      mbar_init(empty0 + 8 * s, NCONS / 32);         // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // the producer warpgroup: its first warp fills the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == NCONS / 32) {
      const int lane = threadIdx.x % 32;
      for (int i = 0; i < n_st; ++i) {
        const int slot = i % ns;
        const int k0 = (st0 + i) * KT;
        const uint32_t full = full0 + 8 * slot;
        uint8_t* st = sm + slot * stage_bytes;
        mbar_wait(empty0 + 8 * slot, ((i / ns) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, P * (L::X + sr * BN * 4) + (tma_w ? RAW : 0));
#pragma unroll
          for (int p = 0; p < P; ++p) {
            tma_load(st + p * L::X, &map_x, full, p * rows + k0, m0, 0);
            tma_load(st + L::SC_OFF + p * sr * BN * 4, &map_s, full, n0, (p * rows + k0) / group,
                     0);
          }
          if (tma_w) tma_load(st + L::RAW_OFF, &map_w, full, n0, k0, 0);
        }
        if (!tma_w) {
          // 8-byte pieces (OUT % 8 == 0), swizzled as TMA would: 16-byte
          // chunk c of row r at chunk c ^ (r % 8)
          uint8_t* raw = st + L::RAW_OFF;
          for (int j = lane; j < KT * (BN / 8); j += 32) {
            const int r = j / (BN / 8), c = (j % (BN / 8)) * 8;
            const bool ok = k0 + r < rows && n0 + c < OUT;
            const int8_t* src = ok ? W + (size_t)(k0 + r) * OUT + n0 + c : W;
            const uint32_t dst = smem_u32(raw + r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 8)));
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                         "r"(ok ? 8 : 0)
                         : "memory");
          }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(full)
                       : "memory");
        }
      }
    }
    if (C > 1) {  // the consumers' reduction over the cluster
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // the two consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x;
  const int wg = ct / 128, w = (ct / 32) % 4, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int lc = 64 * wg + 16 * w + 2 * g;  // this thread's columns of the block: lc, lc + 1
  const int c0 = n0 + lc;
  // the swizzled offsets of rows 2t (even) and 2t + 1 (odd) at these columns
  const int chunk = lc >> 4;
  const int off_e = 2 * t * 128 + ((chunk ^ (2 * t)) << 4) + 2 * g;
  const int off_o = (2 * t + 1) * 128 + ((chunk ^ (2 * t + 1)) << 4) + 2 * g;

  // The fragments of group ks (its SUB 16-row steps) of the stage at
  // `stage` into a. `gk` is a step's first row within its group of scales
  // and `gr` that group's row in the stage's scale box (the box starts at
  // the group of the stage's first row); both move on a step at a time.
  constexpr int SUB = Conv::SUB;
  constexpr int NB = 4 / SUB;  // groups of a stage, and fragment buffers
  int gk = (st0 * KT) % group, gr = 0;
  auto convert = [&](const uint8_t* stage, int ks, uint32_t (&a)[SUB][P][4]) {
    if (ks == 0) gr = 0;
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const uint8_t* r = stage + L::RAW_OFF + (ks * SUB + u) * 16 * 128;
      const float* sc = reinterpret_cast<const float*>(stage + L::SC_OFF) + gr * BN + lc;
      float2 s[P];
#pragma unroll
      for (int p = 0; p < P; ++p) s[p] = *reinterpret_cast<const float2*>(sc + p * sr * BN);
      Conv::frag(*reinterpret_cast<const uint16_t*>(r + off_e),
                 *reinterpret_cast<const uint16_t*>(r + off_o),
                 *reinterpret_cast<const uint16_t*>(r + 8 * 128 + off_e),
                 *reinterpret_cast<const uint16_t*>(r + 8 * 128 + off_o), s, a[u]);
      gk += 16;
      if (gk == group) {
        gk = 0;
        ++gr;
      }
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // NB fragment buffers, group i's in buffer i % NB (a stage is NB
  // groups): up to NB - 1 groups of products in flight while the next
  // group's fragments are converted
  uint32_t fa[NB][SUB][P][4] = {};
  const int total = n_st * NB;  // groups
  mbar_wait(full0, 0);
  convert(sm, 0, fa[0]);
  for (int st = 0, slot = 0, phase = 0; st < n_st; ++st) {
    const uint8_t* cur = sm + slot * stage_bytes;
    const int prev = slot == 0 ? ns - 1 : slot - 1;
    int next = slot + 1, next_phase = phase;
    if (next == ns) {
      next = 0;
      next_phase ^= 1;
    }
    // the x tile's descriptor; a step's k offset adds to its address field
    const uint64_t xd = sw128_desc(smem_u32(cur), 16);
#pragma unroll
    for (int ks = 0; ks < NB; ++ks) {
      const int i = st * NB + ks;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < SUB; ++u)
#pragma unroll
        for (int p = 0; p < P; ++p)
          Wgmma<N>::rs(acc, fa[ks][u][p], xd + ((p * L::X + (ks * SUB + u) * 32) >> 4));
      wgmma_commit();
      wgmma_wait<NB - 1>();  // group i - (NB - 1)'s products are done
#pragma unroll
      for (int u = 0; u < SUB; ++u) keep<P>(fa[(ks + 1) % NB][u]);
      // here the previous stage's last products are done: release it
      if (ks == NB - 2 && st > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      if (i + 1 < total) {
        if (ks < NB - 1) {
          convert(cur, ks + 1, fa[(ks + 1) % NB]);
        } else {
          mbar_wait(full0 + 8 * next, next_phase);
          convert(sm + next * stage_bytes, 0, fa[0]);
        }
      }
    }
    slot = next;
    phase = next_phase;
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator (nb, hf, e) is column c0 + hf of row m0 + nb * 8 + 2t + e
  if (C == 1) {
    if (c0 < OUT) {  // OUT % 8 == 0: c0 + 1 too
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + nb * 8 + 2 * t + e;
          if (m < M)
            *reinterpret_cast<uint32_t*>(out + (size_t)m * OUT + c0) =
                pack_bf16x2(acc[nb * 4 + e], acc[nb * 4 + 2 + e]);
        }
    }
    return;
  }
  // the split: every block's fp32 tile into its ring (both warpgroups'
  // products are done with it), then each block sums its share of the
  // rows over the cluster's blocks, in rank order, and rounds once
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
  float* part = reinterpret_cast<float*>(sm);  // [N][PART_LD]
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(part + (nb * 8 + 2 * t + e) * PART_LD + lc) =
          make_float2(acc[nb * 4 + e], acc[nb * 4 + 2 + e]);
  cluster.sync();
  const int r0 = rank * N / C, nr = (rank + 1) * N / C - r0;
  for (int i = ct; i < nr * (BN / 4); i += NCONS) {
    const int r = r0 + i / (BN / 4), c = (i % (BN / 4)) * 4;
    float4 v[MAX_SPLIT];  // every rank's value in flight at once, then summed in rank order
#pragma unroll
    for (int b = 0; b < MAX_SPLIT; ++b)
      v[b] = b < C ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, b) +
                                                      r * PART_LD + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s = v[0];
#pragma unroll
    for (int b = 1; b < MAX_SPLIT; ++b) {
      s.x += v[b].x;
      s.y += v[b].y;
      s.z += v[b].z;
      s.w += v[b].w;
    }
    if (m0 + r < M && n0 + c < OUT)  // OUT % 8 == 0: the 4 columns are all in
      *reinterpret_cast<uint2*>(out + (size_t)(m0 + r) * OUT + n0 + c) =
          make_uint2(pack_bf16x2(s.x, s.y), pack_bf16x2(s.z, s.w));
  }
  cluster.sync();  // every block's tile stays alive until the cluster has read it
}

template <class Conv, int N>
cudaError_t launch_n(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& ms,
                     const int8_t* W, __nv_bfloat16* out, int M, int rows, int OUT, int group,
                     int sr, int split, cudaStream_t stream) {
  using L = Layout<Conv::PLANES, N>;
  const int ns = L::stages(sr);
  if (ns < 2 || (split > 1 && L::PART > ns * L::stage_bytes(sr))) return cudaErrorInvalidValue;
  auto kernel = dequant_mm_tc<Conv, N>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + N - 1) / N * split, (OUT + BN - 1) / BN, 1);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = L::bytes(sr, ns);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const bool tma_w = OUT % 16 == 0;  // TMA takes rows of a multiple of 16 bytes
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, mx, mw, ms, W, out, M, rows, OUT,
                                             group, sr, ns, tma_w);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The bf16 prefill regime: x [M, IN] bf16, W the layer's rows x OUT bytes
// (rows = IN for int8, IN / 2 for int4), Sc its [IN / group, OUT] scales.
// `tile` (128 or 256: x rows a block) and `split` (1 to 8: blocks of a
// cluster, at most one a stage) are the host's plan.
template <class Conv>
cudaError_t launch(const void* x, const int8_t* W, const float* Sc, void* out, int M, int rows,
                   int OUT, int group, int split, int tile, cudaStream_t stream) {
  const int n_all = (rows + KT - 1) / KT;
  if (split < 1 || split > MAX_SPLIT || split > n_all || (tile != 128 && tile != 256))
    return cudaErrorInvalidValue;
  // the scale rows a stage's 64 rows touch, at most (a last stage shorter
  // than 64 rows reads zeros past IN, its scales too)
  int sr = 1;
  for (int k0 = 0; k0 < rows; k0 += KT) sr = max(sr, (k0 + KT - 1) / group - k0 / group + 1);
  const int IN = rows * Conv::PLANES;
  CUtensorMap mx, mw, ms;
  memset(&mw, 0, sizeof(mw));
  cudaError_t err = make_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, IN, M, 1, 64, tile,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map(&ms, Sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, OUT, IN / group, 1, BN, sr,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess && OUT % 16 == 0)  // TMA takes rows of a multiple of 16 bytes
    err = make_map(&mw, W, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, OUT, rows, 1, BN, KT,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (tile == 256)
    return launch_n<Conv, 256>(mx, mw, ms, W, o, M, rows, OUT, group, sr, split, stream);
  return launch_n<Conv, 128>(mx, mw, ms, W, o, M, rows, OUT, group, sr, split, stream);
}

}  // namespace dqmm
}  // namespace
}  // namespace tg
