// K3: decode attention over the KQ-SVD-compressed dense cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_kq_decode_kernel`
// (src/repro/kernels/kq_decode/kq_decode.py:53, entry point
// `kq_decode_attention` at :98).  For every (sequence b, kv group g) it
// runs an f32 online softmax of the group's m compressed queries
// qc (m, Rk) against the cached kc rows t < lengths[b] and returns
// softmax(qc kc^T * scale) vc, shape (m, Rv), in the query's type.
//
// What bounds it: the cache bytes.  One call reads
// B * Hkv * len * (Rk + Rv) * itemsize bytes of kc/vc and does about
// 2 * m * (Rk + Rv) flops per cached row, i.e. about m / itemsize flops per
// byte (4 at bf16, m = 8): far below the ~295 flop/byte at which the
// H100's tensor cores, not its 3.35 TB/s, would be the limit.  So the
// design touches every live cache byte exactly once and nothing past a
// sequence's length:
//   * one block per (b, g); the block reads lengths[b] itself and only
//     tiles below it are ever loaded;
//   * the block's warps stride over 32-token tiles.  A warp stages its tile
//     of kc and vc into shared memory with coalesced loads of the
//     contiguous (32, R) slab (any Rk/Rv, nothing padded in memory), then
//     lane t scores token t against the m queries, the warp updates its own
//     running max / sum, and each lane accumulates Rv columns of p.v;
//   * rows at or past the length are never staged, so they add nothing
//     (the TPU kernel zeroes them because 0 * garbage can be NaN);
//   * the warps' (max, sum, acc) partials merge in shared memory at the
//     end; acc / max(sum, 1e-30) makes an empty sequence return 0.
// Known limit of this first version: one block per (b, g) gives only
// B * Hkv blocks (32 at 8 slots of tinyllama) for 132 SMs, so a call is
// latency-bound rather than bandwidth-bound.  Splitting a sequence across
// SMs, TMA staging and wgmma are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;           // tokens per warp tile (one per lane)
constexpr int kMaxR = 256;          // largest Rk / Rv taken
constexpr int kVt = kMaxR / 32;     // Rv columns per lane, at most
constexpr int kMaxWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;  // per-block opt-in maximum on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// Shared memory, in floats:
//   q_s   [M][Rk]                 the group's queries (rows >= m are zero)
//   m_w   [nw][M], l_w [nw][M]    per-warp running max / sum, for the merge
//   per warp: k_s [32][ks], v_s [32][Rv], p_s [M][32]
// ks = Rk rounded up to an odd number, so lane t reading row t hits 32
// distinct banks.  After its last tile a warp writes its acc [M][Rv] over
// its own k_s/v_s (32 * (ks + Rv) >= M * Rv since M <= 16).
__host__ __device__ inline int odd_stride(int r) { return r | 1; }
__host__ __device__ inline size_t warp_floats(int M, int Rk, int Rv) {
  return (size_t)kTile * (odd_stride(Rk) + Rv) + (size_t)M * kTile;
}
__host__ inline size_t smem_bytes(int M, int Rk, int Rv, int nw) {
  return sizeof(float) *
         ((size_t)M * Rk + 2 * (size_t)nw * M + nw * warp_floats(M, Rk, Rv));
}

template <typename T, int M>
__global__ void kq_decode_kernel(const T* __restrict__ qc, const T* __restrict__ kc,
                                 const T* __restrict__ vc,
                                 const int32_t* __restrict__ lengths,
                                 T* __restrict__ out, int H, int Hkv, int T_len,
                                 int Rk, int Rv, int m, float scale) {
  extern __shared__ float smem[];
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bg = blockIdx.x;            // b * Hkv + g
  const int b = bg / Hkv;
  const int g = bg % Hkv;
  const int ks = odd_stride(Rk);

  float* q_s = smem;
  float* m_w = q_s + M * Rk;
  float* l_w = m_w + nw * M;
  float* wbase = l_w + nw * M + (size_t)warp * warp_floats(M, Rk, Rv);
  float* k_s = wbase;
  float* v_s = k_s + kTile * ks;
  float* p_s = v_s + kTile * Rv;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T_len ? T_len : len);

  const T* qg = qc + ((size_t)b * H + (size_t)g * m) * Rk;
  for (int i = threadIdx.x; i < M * Rk; i += blockDim.x) {
    const int j = i / Rk;
    q_s[i] = j < m ? to_f32(qg[i]) : 0.f;
  }
  __syncthreads();

  const T* kbase = kc + (size_t)bg * T_len * Rk;
  const T* vbase = vc + (size_t)bg * T_len * Rv;

  float m_run[M], l_run[M], acc[M][kVt];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    m_run[j] = kNegInf;
    l_run[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kVt; ++i) acc[j][i] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < len; t0 += nw * kTile) {
    const int n = min(kTile, len - t0);   // live rows of this tile
    // stage the tile's live rows: the (n, R) slabs are contiguous
    const T* kt = kbase + (size_t)t0 * Rk;
    for (int i = lane; i < n * Rk; i += 32) {
      const int row = i / Rk;
      k_s[row * ks + (i - row * Rk)] = to_f32(kt[i]);
    }
    const T* vt = vbase + (size_t)t0 * Rv;
    for (int i = lane; i < n * Rv; i += 32) v_s[i] = to_f32(vt[i]);
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
      const float sj = lane < n ? s[j] * scale : kNegInf;
      const float m_new = fmaxf(m_run[j], warp_max(sj));
      const float p = lane < n ? expf(sj - m_new) : 0.f;
      const float corr = expf(m_run[j] - m_new);
      l_run[j] = l_run[j] * corr + warp_sum(p);
      m_run[j] = m_new;
      p_s[j * kTile + lane] = p;
#pragma unroll
      for (int i = 0; i < kVt; ++i) acc[j][i] *= corr;
    }
    __syncwarp();

    // acc[j][c] += sum_t p[j][t] * v[t][c], lane owning columns lane + 32 i
    for (int t = 0; t < n; ++t) {
      const float* vrow = v_s + t * Rv;
      float vv[kVt];
#pragma unroll
      for (int i = 0; i < kVt; ++i) {
        const int c = lane + 32 * i;
        vv[i] = c < Rv ? vrow[c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float pj = p_s[j * kTile + t];
#pragma unroll
        for (int i = 0; i < kVt; ++i) acc[j][i] += pj * vv[i];
      }
    }
    __syncwarp();
  }

  // publish this warp's partials (acc over its own staging area)
  float* acc_w = wbase;
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int i = 0; i < kVt; ++i) {
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
  T* og = out + ((size_t)b * H + (size_t)g * m) * Rv;
  for (int i = threadIdx.x; i < m * Rv; i += blockDim.x) {
    const int j = i / Rv;
    const int c = i - j * Rv;
    float mx = kNegInf;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, m_w[w * M + j]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float e = expf(m_w[w * M + j] - mx);
      l += l_w[w * M + j] * e;
      a += smem[(size_t)(M * Rk + 2 * nw * M) + w * warp_floats(M, Rk, Rv) +
                j * Rv + c] * e;
    }
    store(og + i, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int M>
int launch(const void* qc, const void* kc, const void* vc, const void* lengths,
           void* out, int B, int H, int Hkv, int T_len, int Rk, int Rv,
           float scale, cudaStream_t stream) {
  int nw = kMaxWarps;
  while (nw > 1 && smem_bytes(M, Rk, Rv, nw) > kSmemLimit) --nw;
  const size_t smem = smem_bytes(M, Rk, Rv, nw);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kq_decode_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kq_decode_kernel<T, M><<<B * Hkv, nw * 32, smem, stream>>>(
      static_cast<const T*>(qc), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), H, Hkv, T_len, Rk, Rv, H / Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_m(int m, const void* qc, const void* kc, const void* vc,
               const void* lengths, void* out, int B, int H, int Hkv, int T_len,
               int Rk, int Rv, float scale, cudaStream_t s) {
  if (m <= 1) return launch<T, 1>(qc, kc, vc, lengths, out, B, H, Hkv, T_len, Rk, Rv, scale, s);
  if (m <= 2) return launch<T, 2>(qc, kc, vc, lengths, out, B, H, Hkv, T_len, Rk, Rv, scale, s);
  if (m <= 4) return launch<T, 4>(qc, kc, vc, lengths, out, B, H, Hkv, T_len, Rk, Rv, scale, s);
  if (m <= 8) return launch<T, 8>(qc, kc, vc, lengths, out, B, H, Hkv, T_len, Rk, Rv, scale, s);
  return launch<T, 16>(qc, kc, vc, lengths, out, B, H, Hkv, T_len, Rk, Rv, scale, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: 0 = float32,
// 1 = bfloat16, the same for qc, kc, vc and out; lengths is int32.  All
// tensors contiguous: qc (B, H, Rk), kc (B, Hkv, T, Rk), vc (B, Hkv, T, Rv),
// out (B, H, Rv).  Returns the launch's cudaError_t (0 on success).
extern "C" int kq_decode_launch(const void* qc, const void* kc, const void* vc,
                                const void* lengths, void* out, int B, int H,
                                int Hkv, int T_len, int Rk, int Rv, float scale,
                                int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 16 || Rk < 1 ||
      Rk > kMaxR || Rv < 1 || Rv > kMaxR || T_len < 1)
    return (int)cudaErrorInvalidValue;
  const int m = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_m<float>(m, qc, kc, vc, lengths, out, B, H, Hkv, T_len, Rk, Rv, scale, s);
  if (dtype == 1)
    return dispatch_m<__nv_bfloat16>(m, qc, kc, vc, lengths, out, B, H, Hkv, T_len, Rk, Rv, scale, s);
  return (int)cudaErrorInvalidValue;
}
