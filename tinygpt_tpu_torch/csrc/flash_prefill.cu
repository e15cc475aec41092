// Causal GQA flash attention over the dense slot cache (prefill), on
// Hopper's tensor cores.
//
// Replaces the TPU kernel tinygpt_tpu/ops/attention_kernels.py::flash_prefill
// (_prefill_kernel). Same function: q [B, Nq, S, D] against the cache
// k/v [B, Nk, T, D]; query row r sits at slot q_slot + r and sees cache slot c
// when c <= q_slot + r, c > q_slot + r - window (window > 0) and valid[b, c].
// Online softmax in fp32; a row that sees no slot is written as zeros.
//
// What bounds it on an H100: at the main path's shape (B = 4, 32/8 heads of
// 128, S = 512, T = 576, left pads 0/112/212/384, bf16) the bytes, q + the
// seen K/V rows + out, 0.01166 ms at 3.35 TB/s; its operations, 4*D per
// visible (row, slot) pair, 4.3 GFLOP, take about 0.0044 ms on the 989
// TFLOP/s bf16 tensor cores. The products must run on the tensor cores to
// come near either: the fp32 FMA unit (67 TFLOP/s) alone needs 0.065 ms.
//
// Design (bf16 and fp16 q, over a cache of q's type or e4m3):
// - A block owns 64 query rows of one head: one consumer warpgroup and one
//   producer warp (160 threads). At 80 KB of shared memory (D = 128) two
//   blocks share an SM, so one block's loads and start overlap the other's
//   products. Blocks of the last query tiles (the most slots under the
//   causal limit) are launched first; the short ones fill the last wave.
// - Tiles come in by TMA (cp.async.bulk.tensor) into 128-byte-swizzled
//   shared memory, with the tensor maps made on the host for each call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
//   needs no -lcuda). Q is loaded once, while the producer scans `valid`; K
//   and V tiles of 64 slots go through a ring of NS = 2 stages with
//   mbarrier completion (full: the producer's expect_tx and the copy's
//   bytes; empty: every consumer thread's arrival), so the producer keeps
//   the next tile in flight while the consumers compute. TMA's zero fill
//   covers the ragged edges in S and T: no load reads past a tensor.
// - S = Q K^T is wgmma.mma_async m64n64k16 with both operands in shared
//   memory (K is the K-major B operand). The online softmax runs on the
//   fp32 accumulator fragment in registers: each row's 64 scores lie on the
//   four threads of a quad, so row max and row sum take two shuffles; the
//   max is taken on the raw scores and exp2((s - m) * scale * log2 e) is one
//   FMA and one ex2.approx; O is rescaled only when a max of the warp
//   moved. P is rounded to q's type in registers and is the register A
//   operand of O += P V (m64nDk16, V the MN-major B operand from shared
//   memory). Row max, row sum and O stay fp32.
// - Masks: a tile every row of the block sees whole is not masked; on
//   the others each row's visible columns (its causal and window range,
//   ANDed with the tile's 64 validity bits) are one 64-bit word, tested bit
//   by bit with constant shifts.
// - Skipped work: the producer warp scans valid[b] over the block's causal
//   and window range a tile at a time (a ballot a 32-slot half) and hands
//   each tile with a visible slot to the consumers in its stage (its index
//   and 64 validity bits) as it issues the tile's copies; a stage with index
//   -1 ends the tiles. It loads no tile that lies before the window's
//   start, past the causal limit or wholly in slots valid hides. A block
//   whose rows see no slot (the padded query tiles of left-padded rows)
//   gets no tile and stores zeros.
// - The output is rounded into the block's Q tile in shared memory (in the
//   swizzled layout) and leaves by one TMA store, which writes no row past S.
// - An e4m3 cache: TMA brings the tile's e4m3 bytes (no swizzle); the
//   consumer threads convert it to q's type (exactly) into a swizzled K/V
//   tile, fence it for the async proxy and then run the same products:
//   both wgmma operands are of q's type, and q is never rounded to e4m3.
//
// fp32 q (the tests' and the fp32 models' route, held to 1e-4, which TF32
// or bf16 inputs cannot hold) keeps the first design's FMA body: one block
// per (64-row query tile, head) stages each K/V tile in shared memory for
// all 64 rows and gives each thread a 4 x 4 block of scores.
//
// Registers, shared memory and spills: `-Xptxas -v` in the build log beside
// the library (cuda_build.build_log), printed by chip_smoke.py's build phase.
// Measured on the H100 and not kept (PERF.md): a software-pipelined
// loop (the next tile's Q K^T under this tile's softmax) and a persistent
// kernel (one block an SM walking its tiles, the next one's loads under
// this one's products) were no faster. Left for later: the e4m3 branch's
// conversion (it runs slower than bf16), and TMA multicast of a K/V tile to
// the blocks of one KV head's query heads.

#include "hopper_common.cuh"

namespace {

using tg::NEG_INF;

// -- the fp32 body: FMA ----------------------------------------------------

namespace fma {

constexpr int BQ = 64;         // query rows per block
constexpr int BT = 64;         // cache slots per KV tile
constexpr int NTHREADS = 256;  // thread (ty, tx), ty = tid / 16 owns rows 4ty..4ty+3

template <int D>
constexpr size_t smem_bytes() {
  // q [BQ][D+1], k [BT][D+1], v [BT][D], p [BQ][BT+1] as float
  return sizeof(float) * (BQ * (D + 1) + BT * (D + 1) + BT * D + BQ * (BT + 1));
}

// Copies rows [row0, row0 + nrows) of a [*, D] matrix of E into shared memory
// as float with leading dimension ld; rows at or past `limit` are zeros, so no
// byte past the end of the matrix is read.
template <typename E, int D>
__device__ __forceinline__ void load_rows(const E* __restrict__ src, int row0, int nrows,
                                          int limit, float* dst, int ld) {
  constexpr int VEC = tg::Vec<E>::N;  // elements per 16-byte load
  constexpr int VPR = D / VEC;        // vectors per row
  for (int i = threadIdx.x; i < nrows * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float f[VEC];
    if (row0 + r < limit) {
      tg::raw_to_float<E, VEC>(tg::load_raw<E, VEC>(src + (size_t)(row0 + r) * D + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * ld + c + e] = f[e];
  }
}

template <typename T, typename C, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k,
                         const C* __restrict__ v, const uint8_t* __restrict__ valid,
                         T* __restrict__ out, int Nq, int Nk, int S, int Tlen,
                         float scale, int q_slot, int window) {
  constexpr int DC = D / 16;  // output columns per thread: tx, tx+16, ...
  extern __shared__ float smem[];
  float* qs = smem;                // [BQ][D+1]
  float* ks = qs + BQ * (D + 1);   // [BT][D+1]
  float* vs = ks + BT * (D + 1);   // [BT][D]
  float* ps = vs + BT * D;         // [BQ][BT+1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Nq / Nk);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const T* qb = q + (size_t)(b * Nq + h) * S * D;
  const C* kb = k + (size_t)(b * Nk + kvh) * Tlen * D;
  const C* vb = v + (size_t)(b * Nk + kvh) * Tlen * D;
  const uint8_t* vld = valid + (size_t)b * Tlen;
  T* ob = out + (size_t)(b * Nq + h) * S * D;

  load_rows<T, D>(qb, q0, BQ, S, qs, D + 1);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal limit: the last row of the tile sees slots < q_slot + row_end
  const int row_end = min(q0 + BQ, S);
  const int t_stop = min(Tlen, q_slot + row_end);
  int t_begin = 0;
  if (window > 0) t_begin = max(0, q_slot + q0 - window + 1) / BT * BT;

  for (int t0 = t_begin; t0 < t_stop; t0 += BT) {
    __syncthreads();  // the previous tile's k/v/p are no longer read
    load_rows<C, D>(kb, t0, BT, Tlen, ks, D + 1);
    load_rows<C, D>(vb, t0, BT, Tlen, vs, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_slot + q0 + 4 * ty + i;  // slot of this query row
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx + 16 * j;
        ok[j] = col < Tlen && col <= row && (window <= 0 || col > row - window) &&
                vld[col] != 0;
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are one half warp: xor offsets < 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(4 * ty + i) * (BT + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * (BT + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = vs[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      ob[(size_t)r * D + tx + 16 * cc] = tg::from_float<T>(acc[i][cc] * inv);
  }
}

template <typename C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* out,
                   int B, int Nq, int Nk, int S, int T_, float scale, int q_slot, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = tg::allow_smem(flash_prefill_kernel<float, C, D>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((S + BQ - 1) / BQ, Nq, B);
  flash_prefill_kernel<float, C, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const C*>(k), static_cast<const C*>(v),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), Nq, Nk, S, T_, scale,
      q_slot, window);
  return cudaGetLastError();
}

}  // namespace fma

// -- the bf16 / fp16 body: TMA and wgmma -------------------------------------

namespace tc {

constexpr int BM = 64;                 // query rows of a block: its consumer warpgroup's
constexpr int MIN_BLOCKS = 2;          // blocks an SM: one's loads overlap the other's products
constexpr int BN = 64;                 // cache slots of a K/V tile
constexpr int NS = 2;                  // stages of the K/V ring
constexpr int NCONS = 128;             // consumer threads: one warpgroup
constexpr int NTHREADS = NCONS + 32;   // + the producer warp
constexpr int SWB = 128;               // bytes of a swizzled row: 64 elements of 16 bits
constexpr int BOX = SWB / 2;           // elements of a TMA box's inner dimension

// Shared-memory layout, every region 1024-byte aligned (the 128-byte
// swizzle repeats every 8 rows of 128 bytes). A 16-bit [rows][D] tile is
// kept as D / 64 column blocks of [rows][64], each row 128 swizzled bytes.
template <typename C, int D>
struct Layout {
  static constexpr bool F8 = std::is_same<C, tg::e4m3>::value;
  static constexpr int TILE = BN * D * 2;                         // a 16-bit K or V tile
  static constexpr int RAW = BN * D * static_cast<int>(sizeof(C));  // a tile as TMA brings it
  static constexpr int Q = BM * D * 2;
  static constexpr int OFF_K = Q;                  // NS raw K tiles
  static constexpr int OFF_V = OFF_K + NS * RAW;   // NS raw V tiles
  static constexpr int OFF_CK = OFF_V + NS * RAW;  // e4m3: the converted K and V tiles
  static constexpr int OFF_CV = OFF_CK + (F8 ? TILE : 0);
  static constexpr int OFF_BAR = OFF_CV + (F8 ? TILE : 0);  // full[NS], empty[NS], q
  // each stage's tile: its validity bits and its index (-1: no more tiles)
  static constexpr int OFF_BITS = OFF_BAR + 8 * (2 * NS + 1);
  static constexpr int OFF_J = OFF_BITS + 8 * NS;
  static constexpr size_t BYTES = 1024 + OFF_J + 4 * NS;  // + the alignment's slack
};

using tg::fence_regs;
using tg::make_map;
using tg::mbar_arrive;
using tg::mbar_expect_tx;
using tg::mbar_init;
using tg::mbar_wait;
using tg::smem_u32;
using tg::sw128_desc;
using tg::tma_load;
using tg::wgmma_commit;
using tg::wgmma_fence;
using tg::wgmma_wait_all;

// S[64 x 64] = A[64 x 16] B[16 x 64] (+ S when accumulate), A and B K-major
// from shared memory, fp32 accumulators.
template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// O[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows, two values a register), B MN-major
// from shared memory.
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// O[64 x 128] += A[64 x 16] B[16 x 128], as wgmma_rs.
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
}

// 2^x on the special-function unit; -inf gives 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to E and packed low, high into one register.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&r, &v, 4);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&r, &v, 4);
  }
  return r;
}

// The consumers turn a raw e4m3 tile [BN][D] (row-major bytes) into the
// swizzled 16-bit layout of q's type E; every e4m3 value is exact in bf16
// and fp16.
template <typename E, int D>
__device__ __forceinline__ void convert_tile(const uint8_t* raw, uint8_t* dst, int ct) {
  constexpr int CPR = D / 8;  // 16-byte output chunks a row
  for (int i = ct; i < BN * CPR; i += NCONS) {
    const int r = i / CPR;
    const int c8 = i % CPR;
    const uint2 in = *reinterpret_cast<const uint2*>(raw + r * D + c8 * 8);
    const tg::e4m3* e = reinterpret_cast<const tg::e4m3*>(&in);
    uint4 o;
    o.x = pack2<E>(tg::to_f32(e[0]), tg::to_f32(e[1]));
    o.y = pack2<E>(tg::to_f32(e[2]), tg::to_f32(e[3]));
    o.z = pack2<E>(tg::to_f32(e[4]), tg::to_f32(e[5]));
    o.w = pack2<E>(tg::to_f32(e[6]), tg::to_f32(e[7]));
    const int blk = c8 / 8, ch = c8 % 8;
    *reinterpret_cast<uint4*>(dst + blk * (BN * SWB) + r * SWB + ((ch ^ (r & 7)) << 4)) = o;
  }
}

template <typename T, typename C, int D>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
    flash_prefill_tc(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     const uint8_t* __restrict__ valid, int Nq, int Nk, int S, int Tlen,
                     float scale_log2, int q_slot, int window) {
  using L = Layout<C, D>;
  constexpr int NB = D / BOX;  // 64-column blocks of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* bits = reinterpret_cast<uint64_t*>(sm + L::OFF_BITS);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + NS);
  const uint32_t qbar = smem_u32(bars + 2 * NS);

  // the query tiles with the most slots first: the blocks of the last wave
  // are the short ones
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (Nq / Nk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_end = min(q0 + BM, S);
  // the block's slots: from the window's start for its first row to the
  // causal limit of its last
  const int t_hi = min(Tlen, q_slot + row_end);
  const int t_lo = window > 0 ? max(0, q_slot + q0 - window + 1) : 0;
  const int j_lo = t_lo / BN, j_hi = (t_hi + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, L::Q);
    for (int nb = 0; nb < NB; ++nb)
      tma_load(sm + nb * (BM * SWB), &map_q, qbar, nb * BOX, q0, b * Nq + h);
  }
  int* tile_j = reinterpret_cast<int*>(sm + L::OFF_J);
  __syncthreads();  // the barriers are set up

  if (warp == NCONS / 32) {
    // The producer warp scans `valid` (a ballot a 32-slot half tile) and,
    // for each tile with a visible slot, hands the consumers its index and
    // bits in the tile's stage and issues its K/V copies; a stage with
    // index -1 ends the block's tiles.
    const uint8_t* vb = valid + (size_t)b * Tlen;
    int stage = 0, phase = 0;
    auto publish = [&](int j, uint64_t vis) {  // j == j_hi: the end
      if (lane == 0) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        bits[stage] = vis;
        tile_j[stage] = j < j_hi ? j : -1;
        const uint32_t full = full0 + 8 * stage;
        if (j == j_hi) {
          mbar_arrive(full);  // publishes the end
        } else {
          mbar_expect_tx(full, 2 * L::RAW);  // publishes the tile with its bytes
          uint8_t* kt = sm + L::OFF_K + stage * L::RAW;
          uint8_t* vt = sm + L::OFF_V + stage * L::RAW;
          if constexpr (L::F8) {
            tma_load(kt, &map_k, full, 0, j * BN, b * Nk + kvh);
            tma_load(vt, &map_v, full, 0, j * BN, b * Nk + kvh);
          } else {
            for (int nb = 0; nb < NB; ++nb) {
              tma_load(kt + nb * (BN * SWB), &map_k, full, nb * BOX, j * BN, b * Nk + kvh);
              tma_load(vt + nb * (BN * SWB), &map_v, full, nb * BOX, j * BN, b * Nk + kvh);
            }
          }
        }
      }
      __syncwarp();
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    };
    // eight tiles' validity bytes are loaded together, then their ballots
    for (int j0 = j_lo; j0 < j_hi; j0 += 8) {
      bool v0[8], v1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = (j0 + u) * BN + lane;
        v0[u] = j0 + u < j_hi && t < Tlen && vb[t] != 0;
        v1[u] = j0 + u < j_hi && t + 32 < Tlen && vb[t + 32] != 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint64_t vis = static_cast<uint64_t>(__ballot_sync(0xffffffffu, v1[u])) << 32 |
                             __ballot_sync(0xffffffffu, v0[u]);
        if (vis != 0) publish(j0 + u, vis);
      }
    }
    publish(j_hi, 0);
    return;
  }

  // the consumer warpgroup: this thread's rows are q0 + ra and q0 + ra + 8
  const int ra = warp * 16 + lane / 4;
  const int qs0 = q_slot + q0;                // slot of the block's first row
  const int qs1 = q_slot + row_end - 1;       // and of its last
  const int cq = 2 * (lane % 4);              // this thread's first column of a block
  const uint32_t q_base = smem_u32(sm);

  float o[D / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  mbar_wait(qbar, 0);
  for (int stage = 0, phase = 0;; ) {
    mbar_wait(full0 + 8 * stage, phase);
    const int j = tile_j[stage];
    if (j < 0) break;  // no more tiles (a block whose rows see no slot has none)
    const uint64_t vis = bits[stage];
    const int t0 = j * BN;
    uint32_t k_base, v_base;
    if constexpr (L::F8) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");  // last tile read
      convert_tile<T, D>(sm + L::OFF_K + stage * L::RAW, sm + L::OFF_CK, threadIdx.x);
      convert_tile<T, D>(sm + L::OFF_V + stage * L::RAW, sm + L::OFF_CV, threadIdx.x);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");  // this tile written
      mbar_arrive(empty0 + 8 * stage);
      k_base = smem_u32(sm + L::OFF_CK);
      v_base = smem_u32(sm + L::OFF_CV);
    } else {
      k_base = smem_u32(sm + L::OFF_K + stage * L::RAW);
      v_base = smem_u32(sm + L::OFF_V + stage * L::RAW);
    }
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(s, sw128_desc(q_base + (kk / 4) * (BM * SWB) + (kk % 4) * 32, 16),
                      sw128_desc(k_base + (kk / 4) * (BN * SWB) + (kk % 4) * 32, 16),
                      kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // a tile every row of the block sees whole needs no mask
    const bool whole = vis == ~0ull && t0 + BN - 1 <= qs0 &&
                       (window <= 0 || t0 > qs1 - window);
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
      if (!whole) {
        // the row's visible columns of the tile: the causal and window
        // range, ANDed with the validity bits, shifted to this thread's
        // first column so that element (nb, e) is bit nb * 8 + e
        const int rs = qs0 + ra + 8 * hf;  // slot of this row
        const int hi_c = min(BN - 1, rs - t0);
        const int lo_c = window > 0 ? max(0, rs - window + 1 - t0) : 0;
        const uint64_t row = hi_c >= lo_c ? vis & (~0ull >> (63 - hi_c)) & (~0ull << lo_c)
                                          : 0ull;
        const uint64_t mine = row >> cq;
        const uint32_t w0 = static_cast<uint32_t>(mine), w1 = static_cast<uint32_t>(mine >> 32);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = nb * 4 + hf * 2 + e;
            const int bit = nb * 8 + e;
            const bool ok = ((bit < 32 ? w0 : w1) >> (bit & 31)) & 1u;
            s[i] = ok ? s[i] : -INFINITY;
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        mx = fmaxf(mx, s[nb * 4 + hf * 2]);
        mx = fmaxf(mx, s[nb * 4 + hf * 2 + 1]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // m in raw score units; exp2 of (s - m) * scale * log2(e), one FMA
      const float m_new = fmaxf(m[hf], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new * scale_log2;  // nothing seen yet
      alpha[hf] = ex2(fmaf(m[hf], scale_log2, -m_use));
      float rsum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = nb * 4 + hf * 2 + e;
          s[i] = ex2(fmaf(s[i], scale_log2, -m_use));
          rsum += s[i];
        }
      }
      l[hf] = l[hf] * alpha[hf] + rsum;  // this thread's part; the quad sums at the end
      m[hf] = m_new;
    }
    // rescale O only where a row's max moved (most tiles past the first
    // leave every max of the warp where it was)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        o[nb * 4 + 0] *= alpha[0];
        o[nb * 4 + 1] *= alpha[0];
        o[nb * 4 + 2] *= alpha[1];
        o[nb * 4 + 3] *= alpha[1];
      }
    }

    // O += P V: P as the register A operand, 16 slots a step
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<T>(o, pa[kk], sw128_desc(v_base + kk * 16 * SWB, BN * SWB));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if constexpr (!L::F8) mbar_arrive(empty0 + 8 * stage);
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }

  // O / l, rounded to T, into the block's Q tile (its products are done)
  // in the swizzled layout, then one TMA store of the 64 rows (rows past S
  // are not written)
  uint8_t* ot = sm;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    const int r = ra + 8 * hf;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int blk = nb / 8, ch = nb % 8;  // 64-column block, 16-byte chunk
      *reinterpret_cast<uint32_t*>(ot + blk * (BM * SWB) + r * SWB + ((ch ^ (r & 7)) << 4) +
                                   cq * 2) =
          pack2<T>(o[nb * 4 + hf * 2] * inv, o[nb * 4 + hf * 2 + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 2, %0;\n" ::"n"(NCONS) : "memory");  // the output tile written
  if (threadIdx.x == 0) {
    for (int nb = 0; nb < NB; ++nb)
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(&map_o)),
          "r"(smem_u32(ot + nb * (BM * SWB))), "r"(nb * BOX), "r"(q0), "r"(b * Nq + h)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before smem goes
  }
}

template <typename T, typename C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* out,
                   int B, int Nq, int Nk, int S, int T_, float scale, int q_slot, int window,
                   cudaStream_t stream) {
  using L = Layout<C, D>;
  const CUtensorMapDataType qt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = make_map(&mq, q, qt, 2, D, S, B * Nq, BOX, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map(&mo, out, qt, 2, D, S, B * Nq, BOX, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (L::F8) {  // raw bytes, whole rows; the consumers convert and swizzle
    if (err == cudaSuccess)
      err = make_map(&mk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, T_, B * Nk, D, BN,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = make_map(&mv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, T_, B * Nk, D, BN,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    if (err == cudaSuccess)
      err = make_map(&mk, k, qt, 2, D, T_, B * Nk, BOX, BN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = make_map(&mv, v, qt, 2, D, T_, B * Nk, BOX, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return err;
  // the largest shared memory a launch asks for; a launch asks for its T's
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_tc<T, C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(flash_prefill_tc<T, C, D>,
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   100);
  }();
  if (attr != cudaSuccess) return attr;
  constexpr size_t smem = L::BYTES;
  static_assert(smem <= 227 * 1024, "shared memory of a block");
  dim3 grid(Nq, B, (S + BM - 1) / BM);
  flash_prefill_tc<T, C, D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, mo, static_cast<const uint8_t*>(valid), Nq, Nk, S, T_,
      scale * 1.4426950408889634f, q_slot, window);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, typename C>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* valid,
                     void* out, int B, int Nq, int Nk, int S, int T_, float scale, int q_slot,
                     int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (D == 64)
      return fma::launch<C, 64>(q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot, window,
                                stream);
    if (D == 128)
      return fma::launch<C, 128>(q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot, window,
                                 stream);
  } else {
    if (D == 64)
      return tc::launch<T, C, 64>(q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot, window,
                                  stream);
    if (D == 128)
      return tc::launch<T, C, 128>(q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot,
                                   window, stream);
  }
  return cudaErrorInvalidValue;
}

// the cache is of q's type, or e4m3
template <typename T>
cudaError_t launch_c(int kv_dtype, int dtype, int D, const void* q, const void* k,
                     const void* v, const void* valid, void* out, int B, int Nq, int Nk, int S,
                     int T_, float scale, int q_slot, int window, cudaStream_t stream) {
  if (kv_dtype == dtype)
    return launch_d<T, T>(D, q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot, window,
                          stream);
  if (kv_dtype == tg::kE4M3)
    return launch_d<T, tg::e4m3>(D, q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot,
                                 window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [B, Nq, S, D] = causal attention of q [B, Nq, S, D] over k/v [B, Nk, T, D]
// with the per-slot validity bytes valid [B, T]. window <= 0 means no window.
// q and out are of `dtype`, k and v of `kv_dtype` (= dtype, or kE4M3).
// Returns the cudaError_t of the launch (0 on success).
int tg_flash_prefill(const void* q, const void* k, const void* v, const void* valid, void* out,
                     int B, int Nq, int Nk, int S, int T, int D, int dtype, int kv_dtype,
                     float scale, int q_slot, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tg::kF32:
      return launch_c<float>(kv_dtype, dtype, D, q, k, v, valid, out, B, Nq, Nk, S, T, scale,
                             q_slot, window, st);
    case tg::kF16:
      return launch_c<__half>(kv_dtype, dtype, D, q, k, v, valid, out, B, Nq, Nk, S, T, scale,
                              q_slot, window, st);
    case tg::kBF16:
      return launch_c<__nv_bfloat16>(kv_dtype, dtype, D, q, k, v, valid, out, B, Nq, Nk, S, T,
                                     scale, q_slot, window, st);
  }
  return cudaErrorInvalidValue;
}

const char* tg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
