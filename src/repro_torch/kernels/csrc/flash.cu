// K6: causal GQA flash attention with an optional sliding window, for Hopper.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash/flash.py:29, entry point `flash_attention` at
// :79).  q (B, H, S, D), k / v (B, Hkv, S, D) -> out (B, H, S, D) in q's
// type: query head h reads kv head h / m (m = H / Hkv); query s sees key t
// when t <= s (causal) and s - t < window (window > 0); the softmax
// statistics are f32 and a row ends as acc / max(l, 1e-30).  It runs under
// every exact-length prefill and every calibration batch of the port.
//
// What bounds it: operations, beyond a few hundred tokens.  Over the band
// the kernel does 4 D flops per (query, key) pair per head (2 D for q.k,
// 2 D for p.v) on q, k, v and out read or written once.  The flops grow
// with the band (S times the window) and the bytes with S alone: at
// tinyllama's calibration batch (S 512, D 64, bf16) the bytes at 3.35 TB/s
// and the flops at 989 TFLOP/s take about as long (5.6 and 4.4 us), at
// h2o-danube's 4608-token windowed prefill (D 80) the flops take 6 times
// as long as the bytes.  The design:
//   * one block of 4 warps per (b, kv head g, tile of 64 rows), where the
//     rows of (b, g) are its m query heads' rows flattened as (position,
//     head): row r is position r / m of head g m + r % m.  A block's rows
//     span 64 / m positions of every head of the group, so each K/V tile
//     staged in shared memory serves all m heads;
//   * the block walks the key tiles of 64 from the first key its first
//     position's window admits to its last position (the causal diagonal):
//     tiles above the diagonal or wholly before the window are never read,
//     so the work is the band's, not S^2.  A warp whose 16 rows need none of
//     a staged tile skips its products.  Tiles heavy with keys go first;
//   * each warp owns 16 rows and keeps the f32 online softmax of its rows in
//     registers in the layout of the m16n8k16 tensor-core product (lane
//     (g8, t4) holds rows g8 and g8 + 8 and, per 8-key slice, keys 2 t4 and
//     2 t4 + 1); masked scores never enter the max or the sum, boundary
//     tiles mask per element, keys past S are staged as zero;
//   * bfloat16: q.k and p.v run on the tensor cores as `mma.sync`
//     m16n8k16 with f32 accumulators; q comes straight from device memory
//     into fragments, K is staged row-major and V transposed, so every
//     fragment is one 32-bit shared-memory load.  p goes to the tensor
//     cores as bf16 hi + lo (p - hi rounded again), two products, so the
//     value sum keeps f32 precision: kernel and plain version (f32 softmax,
//     f32 p.v) then differ only by summation order, within two bf16 ulps of
//     the output;
//   * float32: true f32 on the CUDA cores (no TF32), the same register
//     layout: each lane dots its rows against its keys from shared memory,
//     and the p.v product hands each key's p to the quad by shuffle.
// Known limits of this first version: tiles are staged synchronously (no
// cp.async / TMA ring), `mma.sync` rather than `wgmma`, and a block of 64
// rows re-stages K/V that a larger row tile would share.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // flattened (position, head) rows a block
constexpr int kKeys = 64;           // keys per staged tile
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;                        // (B, H, S, D), contiguous
  long long qs_b, qs_h, qs_s;       // element strides; the last dim is 1
  long long ks_b, ks_h, ks_s;
  long long vs_b, vs_h, vs_s;
  int B, H, Hkv, m, S, window, causal;
  float scale;
  int n_tiles;                      // row tiles per (b, g)
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one block, in bytes.
//   bf16: k_s [kKeys][D + 8] bf16 (row-major), vt_s [D][kKeys + 8] bf16
//         (V transposed); the padding puts the 8 x 4 lanes of a fragment
//         load on 32 distinct banks.
//   f32:  q_s [kRows][D + 1], k_s [kKeys][D + 1], v_s [kKeys][D] f32.
template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  return sizeof(T) == 2
             ? 2 * (kKeys * (D + 8) + D * (kKeys + 8))
             : 4 * (kRows * (D + 1) + kKeys * (D + 1) + kKeys * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps) flash_kernel(Args a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int NT = kKeys / 8;     // 8-key slices of a tile
  constexpr int DT = D / 8;         // 8-column slices of the output
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g8 = lane >> 2;         // fragment row (and B column)
  const int t4 = lane & 3;          // fragment column pair

  // the heaviest row tiles (latest positions) are scheduled first
  const int n_bg = a.B * a.Hkv;
  const int tile = a.n_tiles - 1 - blockIdx.x / n_bg;
  const int bg = blockIdx.x % n_bg;
  const int b = bg / a.Hkv;
  const int g = bg % a.Hkv;
  const int m = a.m;
  const int S = a.S;
  const int W = a.window;
  const int nrows = S * m;
  const int r0 = tile * kRows;

  // the block's key range: from its first position's window start to its
  // last position (causal) or the end
  const int qlo = r0 / m;
  const int qhi = min(S - 1, (r0 + kRows - 1) / m);
  const int kend = a.causal ? qhi : S - 1;
  const int kbeg = W > 0 ? max(0, qlo - W + 1) : 0;
  // this warp's key range (empty when its rows are all past the end)
  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < nrows;
  const int wqlo = wr0 / m;
  const int wqhi = min(S - 1, (wr0 + 15) / m);
  const int wkend = a.causal ? wqhi : S - 1;
  const int wkbeg = W > 0 ? wqlo - W + 1 : 0;

  // this lane's two rows: warp rows g8 and g8 + 8
  int qpos[2], head[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr0 + g8 + 8 * i;
    live[i] = r < nrows;
    qpos[i] = live[i] ? r / m : 0;
    head[i] = g * m + (live[i] ? r % m : 0);
  }

  const T* kbase = static_cast<const T*>(a.k) + b * a.ks_b + g * a.ks_h;
  const T* vbase = static_cast<const T*>(a.v) + b * a.vs_b + g * a.vs_h;
  const T* qbase = static_cast<const T*>(a.q) + b * a.qs_b;

  // bf16: the rows' query fragments, loaded once (A of m16n8k16: reg 0 row
  // g8 cols 2t4.., reg 1 row g8+8, reg 2 row g8 cols 8+2t4.., reg 3 row g8+8)
  uint32_t qf[kBf16 ? D / 16 : 1][4];
  // f32: the block's rows staged once
  float* q_s = reinterpret_cast<float*>(smem);
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            qbase + head[i] * a.qs_h + (long long)qpos[i] * a.qs_s);
        qf[kk][i] = live[i] ? row[kk * 8 + t4] : 0u;
        qf[kk][2 + i] = live[i] ? row[kk * 8 + 4 + t4] : 0u;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
      const int rl = idx / D, d = idx % D;
      const int r = r0 + rl;
      float x = 0.f;
      if (r < nrows) {
        const T* row = qbase + (g * m + r % m) * a.qs_h +
                       (long long)(r / m) * a.qs_s;
        x = static_cast<float>(row[d]);
      }
      q_s[rl * (D + 1) + d] = x;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int nn = 0; nn < DT; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};       // this lane's part of the row sums

  for (int kt = kbeg; kt <= kend; kt += kKeys) {
    const int nk = min(kKeys, kend + 1 - kt);  // keys of this tile to stage
    __syncthreads();                 // the previous tile is consumed
    if constexpr (kBf16) {
      constexpr int KW = (D + 8) / 2;            // words per k_s row
      constexpr int VS = kKeys + 8;              // bf16 per vt_s row
      uint32_t* k_w = reinterpret_cast<uint32_t*>(smem);
      uint16_t* vt = reinterpret_cast<uint16_t*>(smem) + kKeys * (D + 8);
      for (int idx = threadIdx.x; idx < kKeys * (D / 2); idx += blockDim.x) {
        const int key = idx / (D / 2), w = idx % (D / 2);
        uint32_t kx = 0u, vx = 0u;
        if (key < nk) {
          const long long t = kt + key;
          kx = reinterpret_cast<const uint32_t*>(kbase + t * a.ks_s)[w];
          vx = reinterpret_cast<const uint32_t*>(vbase + t * a.vs_s)[w];
        }
        k_w[key * KW + w] = kx;
        vt[(2 * w) * VS + key] = static_cast<uint16_t>(vx & 0xffffu);
        vt[(2 * w + 1) * VS + key] = static_cast<uint16_t>(vx >> 16);
      }
    } else {
      float* k_s = q_s + kRows * (D + 1);
      float* v_s = k_s + kKeys * (D + 1);
      for (int idx = threadIdx.x; idx < kKeys * D; idx += blockDim.x) {
        const int key = idx / D, d = idx % D;
        float kx = 0.f, vx = 0.f;
        if (key < nk) {
          const long long t = kt + key;
          kx = static_cast<float>(kbase[t * a.ks_s + d]);
          vx = static_cast<float>(vbase[t * a.vs_s + d]);
        }
        k_s[key * (D + 1) + d] = kx;
        v_s[key * D + d] = vx;
      }
    }
    __syncthreads();
    if (!warp_live || kt > wkend || kt + kKeys - 1 < wkbeg) continue;

    // scores of the tile: s[n][e] is row g8 + 8 (e >> 1), key
    // kt + 8 n + 2 t4 + (e & 1)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (kBf16) {
      constexpr int KW = (D + 8) / 2;
      const uint32_t* k_w = reinterpret_cast<const uint32_t*>(smem);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t* krow = k_w + (n * 8 + g8) * KW;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[n], qf[kk], krow[kk * 8 + t4], krow[kk * 8 + 4 + t4]);
      }
    } else {
      const float* k_s = q_s + kRows * (D + 1);
      const float* qa = q_s + (warp * 16 + g8) * (D + 1);
      const float* qb = qa + 8 * (D + 1);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float xa = qa[d], xb = qb[d];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float ka = k_s[(n * 8 + 2 * t4) * (D + 1) + d];
          const float kb = k_s[(n * 8 + 2 * t4 + 1) * (D + 1) + d];
          s[n][0] = fmaf(xa, ka, s[n][0]);
          s[n][1] = fmaf(xa, kb, s[n][1]);
          s[n][2] = fmaf(xb, ka, s[n][2]);
          s[n][3] = fmaf(xb, kb, s[n][3]);
        }
      }
    }

    // mask, scale and the online softmax update of both rows
    uint32_t ok = 0u;                // bit 4 n + e: score (n, e) is seen
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int t = kt + n * 8 + 2 * t4 + (e & 1);
        const bool seen = live[i] && t <= kend && t < S &&
                          (!a.causal || t <= qpos[i]) &&
                          (W <= 0 || qpos[i] - t < W);
        s[n][e] *= a.scale;
        if (seen) {
          ok |= 1u << (4 * n + e);
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
      corr[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = (ok >> (4 * n + e)) & 1u ? expf(s[n][e] - m_run[i])
                                                 : 0.f;
        s[n][e] = p;
        l_run[i] += p;
      }
    }
#pragma unroll
    for (int nn = 0; nn < DT; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nn][e] *= corr[e >> 1];

    // acc += p v
    if constexpr (kBf16) {
      constexpr int VW = (kKeys + 8) / 2;        // words per vt_s row
      const uint32_t* vt_w = reinterpret_cast<const uint32_t*>(smem) +
                             kKeys * (D + 8) / 2;
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // reg r: slice 2 j + (r >> 1), row g8 + 8 (r & 1)
          const float p0 = s[2 * j + (r >> 1)][2 * (r & 1)];
          const float p1 = s[2 * j + (r >> 1)][2 * (r & 1) + 1];
          const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
          const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
          hi[r] = pack_bf16(h0, h1);
          lo[r] = pack_bf16(p0 - h0, p1 - h1);
        }
#pragma unroll
        for (int nn = 0; nn < DT; ++nn) {
          const uint32_t* vrow = vt_w + (nn * 8 + g8) * VW + j * 8;
          const uint32_t b0 = vrow[t4], b1 = vrow[4 + t4];
          mma_bf16(acc[nn], hi, b0, b1);
          mma_bf16(acc[nn], lo, b0, b1);
        }
      }
    } else {
      const float* v_s = q_s + kRows * (D + 1) + kKeys * (D + 1);
      const int quad = lane & ~3;
#pragma unroll
      for (int key = 0; key < kKeys; ++key) {
        const int n = key >> 3, w = key & 7;
        const int src = quad | (w >> 1);
        const float pa = __shfl_sync(0xffffffffu, s[n][w & 1], src);
        const float pb = __shfl_sync(0xffffffffu, s[n][2 + (w & 1)], src);
        const float* vrow = v_s + key * D + 2 * t4;
#pragma unroll
        for (int nn = 0; nn < DT; ++nn) {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + nn * 8);
          acc[nn][0] = fmaf(pa, vv.x, acc[nn][0]);
          acc[nn][1] = fmaf(pa, vv.y, acc[nn][1]);
          acc[nn][2] = fmaf(pb, vv.x, acc[nn][2]);
          acc[nn][3] = fmaf(pb, vv.y, acc[nn][3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), rows g8 and g8 + 8, columns 8 nn + 2 t4 + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(quad_sum(l_run[i]), 1e-30f);
    if (!warp_live || !live[i]) continue;
    T* orow = static_cast<T*>(a.out) +
              (((long long)b * a.H + head[i]) * S + qpos[i]) * D + 2 * t4;
#pragma unroll
    for (int nn = 0; nn < DT; ++nn) {
      const float x0 = acc[nn][2 * i] * inv, x1 = acc[nn][2 * i + 1] * inv;
      if constexpr (kBf16) {
        *reinterpret_cast<uint32_t*>(orow + nn * 8) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + nn * 8) = make_float2(x0, x1);
      }
    }
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>();
  if (bytes > 48 * 1024) {          // the opt-in is per device: set it here
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (long long)a.B * a.Hkv * a.n_tiles;
  if (blocks <= 0) return 0;
  flash_kernel<T, D><<<(unsigned)blocks, 32 * kWarps, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash

// Plain C entry point (loaded with ctypes).  dtype: 0 = float32,
// 1 = bfloat16, the same for q, k, v and out.  q (B, H, S, D) and k, v
// (B, Hkv, S, D) with the given element strides (the last dim contiguous;
// for bfloat16, even strides and 4-byte aligned bases); out (B, H, S, D)
// contiguous.  D in {16, 64, 80, 128}: the reduced configs, tinyllama,
// h2o-danube and llama2-7b.  window 0: no window; causal 0:
// every key up to the window.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out, long long qs_b, long long qs_h,
                            long long qs_s, long long ks_b, long long ks_h,
                            long long ks_s, long long vs_b, long long vs_h,
                            long long vs_s, int B, int H, int Hkv, int S,
                            int D, int window, int causal, float scale,
                            int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash::Args a{q,    k,    v,    out,  qs_b, qs_h,  qs_s,   ks_b,
                ks_h, ks_s, vs_b, vs_h, vs_s, B,     H,      Hkv,
                H / Hkv, S, window, causal, scale, 0};
  a.n_tiles = (S * a.m + flash::kRows - 1) / flash::kRows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return flash::dispatch<float>(a, D, st);
  if (dtype == 1) return flash::dispatch<__nv_bfloat16>(a, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
