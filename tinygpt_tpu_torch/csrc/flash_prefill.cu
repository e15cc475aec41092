// Causal GQA flash attention over the dense slot cache (prefill).
//
// Replaces the TPU kernel tinygpt_tpu/ops/attention_kernels.py::flash_prefill
// (_prefill_kernel). Same function: q [B, Nq, S, D] against the cache
// k/v [B, Nk, T, D]; query row r sits at slot q_slot + r and sees cache slot c
// when c <= q_slot + r, c > q_slot + r - window (window > 0) and valid[b, c].
// Online softmax in fp32; a row that sees no slot is written as zeros.
//
// What bounds it on an H100: the causal QK^T and PV products, 4*B*Nq*S*T*D/2
// operations, against q + k + v + out bytes that are a few MB. At prefill
// sizes it is bound by operations. This first version computes in fp32 FMA
// (67 TFLOP/s peak, far below the 989 TFLOP/s of the bf16 tensor cores);
// mma/wgmma is the later step. What the design does about the bound: one
// block per (64-row query tile, q head, batch row) walks the KV tiles of 64
// slots only up to the causal limit (and from the window's start), stages each
// K/V tile in shared memory once for all 64 rows with 16-byte coalesced loads,
// and gives each thread a 4 x 4 block of scores and a 4 x D/16 block of the
// output, so each shared-memory read feeds two or more FMAs. An e4m3 cache
// (kv_dtype = kE4M3; q and the output keep their type) is decoded to fp32 by
// the card's conversion as its tiles are staged.

#include "attention_common.cuh"

namespace {

using tg::NEG_INF;

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

template <typename T, typename C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* out,
                   int B, int Nq, int Nk, int S, int T_, float scale, int q_slot, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = tg::allow_smem(flash_prefill_kernel<T, C, D>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((S + BQ - 1) / BQ, Nq, B);
  flash_prefill_kernel<T, C, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), Nq, Nk, S, T_, scale, q_slot,
      window);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* valid,
                     void* out, int B, int Nq, int Nk, int S, int T_, float scale, int q_slot,
                     int window, cudaStream_t stream) {
  if (D == 64)
    return launch<T, C, 64>(q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot, window,
                            stream);
  if (D == 128)
    return launch<T, C, 128>(q, k, v, valid, out, B, Nq, Nk, S, T_, scale, q_slot, window,
                             stream);
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
