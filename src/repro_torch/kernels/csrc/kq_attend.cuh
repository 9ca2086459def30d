// Compressed-cache attention for Hopper in float32: the kernel body behind
// float32 K1, K3, K4 and K5 (decode) and float32 K2 (prefill-append), the
// reduced parity runs (kq_decode.cu holds K3's entry point, kq_paged.cu
// those of K1, K2, K4 and K5 and the split combine).  bfloat16 has bodies
// of its own on the tensor cores: kq_decode_tc.cuh for every decode call,
// kq_prefill.cuh for K2.
//
// For every (sequence b, kv group g, tile of up to M query rows) it runs an
// f32 online softmax of the rows' compressed queries qc (., Rk) against the
// cached kc rows each query may see and returns softmax(qc kc^T * scale) vc,
// shape (., Rv), in the query's type.  A query row sees the cache tokens
// t < lim, where lim = lengths[b] for a decode row (K1, K3) and
// lim = min(lengths[b], pos0[b] + s + 1) for query s of a prefill chunk
// (K2: causal within and across chunks; a bucket-padding query,
// pos0[b] + s >= lengths[b], sees the whole prefix).
//
// Where the cache rows live is the only difference between the cache kinds:
//   dense (K3)  kc (B, Hkv, T, R): token t of (b, g) is row (b*Hkv + g)*T + t;
//   paged (K1, K2) pools (P, Hkv, ps, R) and a block table (B, n_pages):
//               token t is row (block_table[b, t/ps]*Hkv + g)*ps + t%ps.
// Every token's R values are contiguous in both, so a tile staged token by
// token stays coalesced whatever the page size.
//
// Int8 pages (K5): the pools hold int8 codes and two pools (P, Hkv, ps, 1)
// of bf16 scales, one per token and side, at the token's own row index.
// Staging dequantizes in registers, code * scale in f32, before anything
// is dotted (the order of the TPU kernel and of the plain version), so
// device-memory reads stay int8.  A token's codes are R bytes (50 and 42
// at the calibrated ranks), not 4-byte aligned: they are loaded byte-wise,
// lanes across the row, never past its end.
//
// Split-KV (K4, and K5 split): a block owns one span of span * ps tokens,
// [s * span * ps, (s + 1) * span * ps), of its slot; it writes f32 partials
// out_s = acc / max(l, 1e-30) and lse_s = m + log(max(l, 1e-30)) instead
// of the output, and kq_combine_splits (kq_paged.cu) merges them.  A span
// past the sequence's length loads nothing and writes out = 0,
// lse = -1e30 + log(1e-30): its merge weight is exactly 0 beside any live
// span, and a slot of length 0 merges to 0, as the unsplit kernel gives.
//
// What bounds it: the cache bytes in decode, operations in a prefill chunk
// (S times the flops on the same bytes).  In float32 both run here, in
// true f32 on CUDA cores (the point of these runs is agreement with the
// CPU to float32 rounding, not speed).  The design:
//   * one block per (b, g, row tile); the block reads lengths[b] (and
//     pos0[b]) itself and loads no tile at or past its largest row limit,
//     so nothing past a sequence's length, and nothing the causal mask
//     removes from a whole tile, is read;
//   * the block's warps stride over 32-token tiles.  A warp looks up the
//     tile's cache rows once (lane t: token t, one block-table read, kept in
//     a register and handed to the other lanes by shuffles), stages the
//     tile's kc and vc rows into shared memory with coalesced loads, then
//     lane t scores token t against the M queries, the warp updates its own
//     running max / sum per row, and each lane accumulates its VT = Rv / 32
//     (rounded up) columns of p.v;
//   * a block moves so few bytes that device-memory latency, not bandwidth,
//     sets its pace: staging walks the tile kBatch tokens at a time, lanes
//     across each token's R contiguous values, and issues the batch's loads
//     before its first store to shared memory, so that many are in flight
//     at once; no division per element, and the row offsets come by
//     shuffle, not from shared memory (a load whose address came from
//     shared memory would wait for the store before it);
//   * rows at or past the limit of every query row are never staged, so
//     they add nothing (the TPU kernels zero them because 0 * garbage can
//     be NaN); a token a row may not see gets p = 0 for that row;
//   * the warps' (max, sum, acc) partials merge in shared memory at the
//     end; acc / max(sum, 1e-30) makes a row that saw nothing return 0.
// Known limits: unsplit decode has only B * Hkv blocks (32 at 8 slots of
// tinyllama) for 132 SMs, so it is latency-bound rather than
// bandwidth-bound; kq_decode_tc.cuh answers that for bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kq {

constexpr int kTile = 32;           // tokens per warp tile (one per lane)
constexpr int kMaxR = 256;          // largest Rk / Rv taken
constexpr int kMaxRows = 16;        // largest row tile (and GQA group)
constexpr int kBatch = 8;           // staging loads in flight per lane
constexpr int kMaxWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;  // per-block opt-in maximum on sm_90

// Where the cache rows live, and how to read them.
struct Cache {
  const int32_t* btab;  // (B, n_pages) block table; nullptr: dense cache
  int t_cap;            // tokens a sequence can hold: T, or n_pages * ps
  int ps;               // page size (paged)
  int n_pages;          // block-table width (paged)
  const __nv_bfloat16* kscale;  // (P, Hkv, ps, 1) per-token scales of
  const __nv_bfloat16* vscale;  // int8 pools; nullptr: fp pools
};

// Split-KV: which span of a slot's tokens a block owns, and where its
// partials go.  o_part == nullptr: one span covering every token, and the
// block writes the normalized output.
struct Split {
  float* o_part;        // (B * Hkv, n, m, Rv) f32 partial outputs
  float* lse;           // (B * Hkv, n, m) f32 partial log-sum-exp
  int n;                // splits
  int span;             // tokens per split (span pages * ps)
};

// Which query rows a block owns and what each may see.  The rows of
// (b, g) are ordered (m, S): row r is query r % S of head g*m + r / S,
// which is where qc (B, H, S, Rk) keeps it.
struct Rows {
  const int32_t* pos0;  // (B,) first query position; nullptr: decode
  int S;                // queries per head (1 for decode)
  int n_tiles;          // row tiles per (b, g)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy a tile's n cache rows of R values into shared memory (row stride
// `stride`), as f32.  The row of token t0 + l is lane l's `my_row`, handed
// out by shuffle; rows go kBatch at a time, lane l taking columns l,
// l + 32, ... of each, every load of the batch issued before the first
// store.  Int8 rows (C = int8_t) are dequantized on the way: code * the
// token's bf16 scale `sc[row]`, in f32.
template <typename C>
__device__ __forceinline__ void stage(float* __restrict__ dst, int stride,
                                      const C* __restrict__ src,
                                      const __nv_bfloat16* __restrict__ sc,
                                      int R, int n, int my_row, int lane) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  for (int r0 = 0; r0 < n; r0 += kBatch) {       // r0 + kBatch <= 32
    int row[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      row[u] = __shfl_sync(0xffffffffu, my_row, r0 + u);
    const int nb = min(kBatch, n - r0);
    float mul[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      mul[u] = kInt8 && u < nb ? __bfloat162float(sc[row[u]]) : 1.f;
    for (int c = lane; c < R; c += 32) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = u < nb ? to_f32(src[(size_t)row[u] * R + c]) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < nb) {
          if constexpr (kInt8) v[u] *= mul[u];
          dst[(r0 + u) * stride + c] = v[u];
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in 4-byte words:
//   q_s   [M][Rk]                 the tile's queries (rows past it are zero)
//   m_w   [nw][M], l_w [nw][M]    per-warp running max / sum, for the merge
//   per warp: k_s [32][ks], v_s [32][Rv], p_s [M][32]
//   lim_s [M] (int)               each row's key limit
// ks = Rk rounded up to an odd number, so lane t reading row t hits 32
// distinct banks.  After its last tile a warp writes its acc [M][Rv] over
// its own k_s/v_s (32 * (ks + Rv) >= M * Rv since M <= 16).
__host__ __device__ inline int odd_stride(int r) { return r | 1; }
__host__ __device__ inline size_t warp_floats(int M, int Rk, int Rv) {
  return (size_t)kTile * (odd_stride(Rk) + Rv) + (size_t)M * kTile;
}
__host__ inline size_t smem_bytes(int M, int Rk, int Rv, int nw) {
  return 4 * ((size_t)M * Rk + 2 * (size_t)nw * M +
              nw * warp_floats(M, Rk, Rv) + M);
}

// T: query and output type; C: cache element type (T, or int8_t with
// scales); M: query rows per block; VT: value columns per lane.
template <typename T, typename C, int M, int VT>
__global__ void attend_kernel(const T* __restrict__ qc, const C* __restrict__ kc,
                              const C* __restrict__ vc,
                              const int32_t* __restrict__ lengths,
                              T* __restrict__ out, int H, int Hkv, int Rk,
                              int Rv, int m, float scale, Cache cache,
                              Rows rows, Split split) {
  extern __shared__ float smem[];
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x % rows.n_tiles;
  const int sp = blockIdx.x / rows.n_tiles % split.n;   // split
  const int bg = blockIdx.x / rows.n_tiles / split.n;   // b * Hkv + g
  const int b = bg / Hkv;
  const int g = bg % Hkv;
  const int ks = odd_stride(Rk);
  const size_t wf = warp_floats(M, Rk, Rv);

  float* q_s = smem;
  float* m_w = q_s + M * Rk;
  float* l_w = m_w + nw * M;
  float* warps0 = l_w + nw * M;
  float* k_s = warps0 + warp * wf;
  float* v_s = k_s + kTile * ks;
  float* p_s = v_s + kTile * Rv;
  int* lim_s = reinterpret_cast<int*>(warps0 + nw * wf);

  const int r0 = tile * M;
  const int nr = min(M, m * rows.S - r0);        // query rows of this block
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cache.t_cap ? cache.t_cap : len);

  const size_t qrow0 = ((size_t)b * H + (size_t)g * m) * rows.S + r0;
  const T* qg = qc + qrow0 * Rk;
  for (int i = threadIdx.x; i < M * Rk; i += blockDim.x) {
    const int j = i / Rk;
    q_s[i] = j < nr ? to_f32(qg[i]) : 0.f;
  }
  if (threadIdx.x < M) {
    const int j = threadIdx.x;
    int lim = j < nr ? len : 0;
    if (j < nr && rows.pos0 != nullptr)          // keys t <= qpos
      lim = min(len, max(rows.pos0[b] + (r0 + j) % rows.S + 1, 0));
    lim_s[j] = lim;
  }
  __syncthreads();
  int bound = 0;                                 // the block's last key + 1
#pragma unroll
  for (int j = 0; j < M; ++j) bound = max(bound, lim_s[j]);
  const int t_lo = sp * split.span;              // this split's tokens
  const int t_hi = min(bound, t_lo + split.span);

  float m_run[M], l_run[M], acc[M][VT];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    m_run[j] = kNegInf;
    l_run[j] = 0.f;
#pragma unroll
    for (int i = 0; i < VT; ++i) acc[j][i] = 0.f;
  }

  for (int t0 = t_lo + warp * kTile; t0 < t_hi; t0 += nw * kTile) {
    const int n = min(kTile, t_hi - t0);         // staged rows of this tile
    int my_row = 0;                              // cache row of token t0+lane
    if (lane < n) {
      const int t = t0 + lane;
      my_row = cache.btab == nullptr
          ? bg * cache.t_cap + t
          : (cache.btab[(size_t)b * cache.n_pages + t / cache.ps] * Hkv + g) *
                    cache.ps + t % cache.ps;
    }
    stage(k_s, ks, kc, cache.kscale, Rk, n, my_row, lane);
    stage(v_s, Rv, vc, cache.vscale, Rv, n, my_row, lane);
    __syncwarp();

    // lane = token: its scores against the M queries
    float s[M];
#pragma unroll
    for (int j = 0; j < M; ++j) s[j] = 0.f;
    if (lane < n) {
      const float* krow = k_s + lane * ks;
      for (int r = 0; r < Rk; ++r) {
        const float kv = krow[r];
#pragma unroll
        for (int j = 0; j < M; ++j) s[j] += q_s[j * Rk + r] * kv;
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      // lane < n: a span may end before the row's limit (split-KV)
      const bool seen = lane < n && t0 + lane < lim_s[j];
      const float sj = seen ? s[j] * scale : kNegInf;
      const float m_new = fmaxf(m_run[j], warp_max(sj));
      const float p = seen ? expf(sj - m_new) : 0.f;
      const float corr = expf(m_run[j] - m_new);
      l_run[j] = l_run[j] * corr + warp_sum(p);
      m_run[j] = m_new;
      p_s[j * kTile + lane] = p;
#pragma unroll
      for (int i = 0; i < VT; ++i) acc[j][i] *= corr;
    }
    __syncwarp();

    // acc[j][c] += sum_t p[j][t] * v[t][c], lane owning columns lane + 32 i
    for (int t = 0; t < n; ++t) {
      const float* vrow = v_s + t * Rv;
      float vv[VT];
#pragma unroll
      for (int i = 0; i < VT; ++i) {
        const int c = lane + 32 * i;
        vv[i] = c < Rv ? vrow[c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float pj = p_s[j * kTile + t];
#pragma unroll
        for (int i = 0; i < VT; ++i) acc[j][i] += pj * vv[i];
      }
    }
    __syncwarp();
  }

  // publish this warp's partials (acc over its own staging area)
  float* acc_w = warps0 + warp * wf;
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int i = 0; i < VT; ++i) {
      const int c = lane + 32 * i;
      if (c < Rv) acc_w[j * Rv + c] = acc[j][i];
    }
    if (lane == 0) {
      m_w[warp * M + j] = m_run[j];
      l_w[warp * M + j] = l_run[j];
    }
  }
  __syncthreads();

  // merge the warps: rescale each to the common max, then acc / sum
  // (unsplit), or the split's partial acc / sum and its log-sum-exp
  for (int i = threadIdx.x; i < nr * Rv; i += blockDim.x) {
    const int j = i / Rv;
    const int c = i - j * Rv;
    float mx = kNegInf;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, m_w[w * M + j]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float e = expf(m_w[w * M + j] - mx);
      l += l_w[w * M + j] * e;
      a += warps0[w * wf + j * Rv + c] * e;
    }
    const float den = fmaxf(l, 1e-30f);
    if (split.o_part == nullptr) {
      store(out + qrow0 * Rv + i, a / den);
    } else {                                     // decode rows: S == 1
      const size_t prow = ((size_t)bg * split.n + sp) * m + r0 + j;
      split.o_part[prow * Rv + c] = a / den;
      if (c == 0) split.lse[prow] = mx + logf(den);
    }
  }
}

// One call's arguments, as the entry points pass them on.
struct Args {
  const void *qc, *kc, *vc, *lengths;
  void* out;
  int B, H, Hkv, Rk, Rv;
  float scale;
  Cache cache;
  Rows rows;
  Split split;
  cudaStream_t stream;
};

template <typename T, typename C, int M, int VT>
int launch(const Args& a) {
  int nw = kMaxWarps;
  while (nw > 1 && smem_bytes(M, a.Rk, a.Rv, nw) > kSmemLimit) --nw;
  const size_t smem = smem_bytes(M, a.Rk, a.Rv, nw);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attend_kernel<T, C, M, VT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attend_kernel<T, C, M, VT>
      <<<a.B * a.Hkv * a.split.n * a.rows.n_tiles, nw * 32, smem,
         a.stream>>>(
          static_cast<const T*>(a.qc), static_cast<const C*>(a.kc),
          static_cast<const C*>(a.vc), static_cast<const int32_t*>(a.lengths),
          static_cast<T*>(a.out), a.H, a.Hkv, a.Rk, a.Rv, a.H / a.Hkv, a.scale,
          a.cache, a.rows, a.split);
  return (int)cudaGetLastError();
}

// VT = the value columns each lane owns: Rv / 32, rounded up to 1, 2, 4, 8.
template <typename T, typename C, int M>
int dispatch_cols(const Args& a) {
  if (a.Rv <= 32) return launch<T, C, M, 1>(a);
  if (a.Rv <= 64) return launch<T, C, M, 2>(a);
  if (a.Rv <= 128) return launch<T, C, M, 4>(a);
  return launch<T, C, M, 8>(a);
}

// M = the row tile: n rows rounded up to a power of two, at most 16; int8
// pools are decode-only, so their row tiles stop at 8 (groups m <= 8) and
// the instantiations do not double.
template <typename T, typename C>
int dispatch_rows(int n, const Args& a) {
  if (n <= 1) return dispatch_cols<T, C, 1>(a);
  if (n <= 2) return dispatch_cols<T, C, 2>(a);
  if (n <= 4) return dispatch_cols<T, C, 4>(a);
  if (n <= 8) return dispatch_cols<T, C, 8>(a);
  if constexpr (std::is_same<C, int8_t>::value) {
    return (int)cudaErrorInvalidValue;
  } else {
    return dispatch_cols<T, C, 16>(a);
  }
}

// Checks the shapes every entry point shares, then launches in float32
// (`dtype` 0; bfloat16 runs kq_decode_tc.cuh or kq_prefill.cuh) with row
// tiles of min(m * S, 16) rows.  Int8 pools (cache.kscale set) are taken
// where kInt8Pages is true (the paged library) for decode (S == 1,
// m <= 8) only.
template <bool kInt8Pages>
int attend(int dtype, const void* qc, const void* kc, const void* vc,
           const void* lengths, void* out, int B, int H, int Hkv, int Rk,
           int Rv, float scale, Cache cache, const int32_t* pos0, int S,
           Split split, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRows || Rk < 1 ||
      Rk > kMaxR || Rv < 1 || Rv > kMaxR || cache.t_cap < 1 || S < 1 ||
      split.n < 1 || split.span < 1 ||
      (split.o_part == nullptr) != (split.lse == nullptr) ||
      (split.o_part == nullptr &&
       (split.n != 1 || split.span < cache.t_cap)) ||
      (split.o_part != nullptr && S != 1) ||
      (cache.kscale == nullptr) != (cache.vscale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_rows = H / Hkv * S;                // query rows per (b, g)
  const int tile = n_rows < kMaxRows ? n_rows : kMaxRows;
  const Args a{qc, kc, vc, lengths, out, B, H, Hkv, Rk, Rv, scale, cache,
               Rows{pos0, S, (n_rows + kMaxRows - 1) / kMaxRows}, split,
               static_cast<cudaStream_t>(stream)};
  if (cache.kscale != nullptr) {
    if constexpr (kInt8Pages) {
      if (S != 1) return (int)cudaErrorInvalidValue;
      if (dtype == 0) return dispatch_rows<float, int8_t>(tile, a);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch_rows<float, float>(tile, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace kq
