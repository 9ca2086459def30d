// K7: the Mamba-2 SSD chunk scan, for Hopper: float32 on this file's
// first body, bf16 on the chunk-parallel tensor-core body of ssd_tc.cuh
// (its header says what bounds it and how that design answers it).
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd/ssd.py:26, entry point `ssd_chunk_scan` at :64).
// x (Bsz, nh, S, hd), a = dt * A and dt (Bsz, nh, S) f32, B / C
// (Bsz, G, S, n); head h reads group h / (nh / G).  For each (b, head) the
// block walks the chunks in order and carries the state h (n, hd) in f32.
// Per chunk of L tokens, with cum the chunk's running sum of a:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i h,
//   h  <- h exp(cum_last) + sum_j B_j^T exp(cum_last - cum_j) dt_j x_j.
// Two additions the TPU kernel lacks, both needed by the model path: an
// optional initial state h0 and the final state as an output.  Any S >= 1:
// a short last chunk is zero-staged past its end, and its state update
// uses cum at its last real token.  It runs under every prefill of an SSM
// layer (`ssm_forward`).
//
// What bounds it: operations.  Per chunk and head the work is the causal
// half of the chunk's pairs times (2 n + 2 hd) flops for C.B^T and w.x,
// plus 2 L n hd each for the carried term and the state update, on x, B, C,
// a, dt and y moved once.  At mamba2-2.7b's prefill of 4096 tokens (80
// heads, hd 64, n 128, chunk 256) that is about 27 GFLOP against about
// 180 MB in f32: some 0.4 ms at the CUDA cores' f32 rate, the ceiling of
// true f32 arithmetic.  The float32 body does all arithmetic in f32 on the
// CUDA cores, and one block per (b, head) fills 80 of 132 SMs at batch 1.
// The design:
//   * one block of 256 threads per (b, head), looping over the chunks in
//     order: the loop takes the place of the TPU's sequential grid axis,
//     and h (n x hd f32, 32 KB at full width) stays in shared memory for
//     the whole sequence;
//   * the chunk is tiled into 64-row query tiles against 64-key tiles
//     j <= i, the way K6 walks its band, so the L x L score matrix is
//     never held: one 64 x 64 tile of w = (C.B^T) exp(cum_i - cum_j) dt_j
//     at a time, masked BEFORE exp (above the diagonal the exponent is
//     positive and overflows; the decay is never factored as
//     exp(cum_i) exp(-cum_j));
//   * cum is a block-wide prefix sum (warp shuffles, then the warp
//     totals) in f64, rounded to f32: the plain version sums in f64 too,
//     so the two orders of addition (and torch.cumsum's) give the same f32
//     cum, where an f32 sum over a chunk of 256 would drift by some 1e-4
//     (cum reaches hundreds) and move y by some 1e-3 through the exps;
//   * the last query tile of a chunk sees every key tile, so the state
//     update is accumulated in registers during that tile's key loop and
//     applied after it: each key tile is staged once per query tile;
//   * inputs are staged to shared memory, read through their strides
//     (the model's (B, S, nh, hd) views need no copy); B and C rows are
//     padded by one float so the 16 lanes reading 16 rows hit 16 banks.
// Known limits of the float32 body: f32 on the CUDA cores (true f32 is
// what a float32 call asks for), tiles staged synchronously, one block per
// (b, head) with no split of the scan over chunks, and C.B^T computed per
// head where the heads of a group could share it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace ssd {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kMaxChunk = 256;     // longest chunk the cum arrays hold
static_assert(kThreads == kMaxChunk, "one thread per chunk position");

struct Args {
  const void* x;
  const float* a;
  const float* dt;
  const void* B;
  const void* C;
  const float* h0;                 // (Bsz, nh, n, hd) f32 or null
  void* y;                         // f32 or x's type
  float* h_out;                    // (Bsz, nh, n, hd) f32
  long long xs_b, xs_h, xs_s;      // element strides; the last dim is 1
  long long as_b, as_h, as_s;
  long long ds_b, ds_h, ds_s;
  long long bs_b, bs_g, bs_s;
  long long cs_b, cs_g, cs_s;
  long long ys_b, ys_h, ys_s;
  int nh, G, S, chunk, y_f32;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int HD, int N>
struct Shape {
  static constexpr int TCOL = HD >= 16 ? 16 : HD;  // threads across hd
  static constexpr int TROW = kThreads / TCOL;     // threads across rows
  static constexpr int CPT = HD / TCOL;            // hd columns a thread
  static constexpr int RPT = kTile / TROW;         // query rows a thread
  static constexpr int KPT = (N + TROW - 1) / TROW;  // state rows a thread
  static constexpr int NP = N + 1;                 // padded B / C row
  static constexpr int WP = kTile + 1;             // padded w row
  static_assert(HD % TCOL == 0 && kTile % TROW == 0, "thread layout");
  // shared memory, in floats:
  //   c_s [kTile][NP], b_s [kTile][NP], x_s [kTile][HD], w_s [kTile][WP],
  //   h_s [N][HD], cum_s / dt_s / wj_s / ecum_s [kMaxChunk], tot_s [32]
  //   (8 doubles; the offset is even, so 8-byte aligned)
  static constexpr int kFloats = 2 * kTile * NP + kTile * HD + kTile * WP +
                                 N * HD + 4 * kMaxChunk + 32;
  static constexpr int kBytes = 4 * kFloats;
};

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args p) {
  using Sh = Shape<HD, N>;
  constexpr int TCOL = Sh::TCOL, TROW = Sh::TROW, CPT = Sh::CPT;
  constexpr int RPT = Sh::RPT, KPT = Sh::KPT, NP = Sh::NP, WP = Sh::WP;
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;
  float* b_s = c_s + kTile * NP;
  float* x_s = b_s + kTile * NP;
  float* w_s = x_s + kTile * HD;
  float* h_s = w_s + kTile * WP;
  float* cum_s = h_s + N * HD;
  float* dt_s = cum_s + kMaxChunk;
  float* wj_s = dt_s + kMaxChunk;    // exp(cum_last - cum_j) dt_j
  float* ecum_s = wj_s + kMaxChunk;  // exp(cum_i)
  double* tot_s = reinterpret_cast<double*>(ecum_s + kMaxChunk);  // scan

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;         // b * nh + head
  const int b = bh / p.nh;
  const int hh = bh % p.nh;
  const int g = hh / (p.nh / p.G);
  const T* xg = static_cast<const T*>(p.x) + b * p.xs_b + hh * p.xs_h;
  const T* Bg = static_cast<const T*>(p.B) + b * p.bs_b + g * p.bs_g;
  const T* Cg = static_cast<const T*>(p.C) + b * p.cs_b + g * p.cs_g;
  const float* ag = p.a + b * p.as_b + hh * p.as_h;
  const float* dg = p.dt + b * p.ds_b + hh * p.ds_h;
  const long long yoff = b * p.ys_b + hh * p.ys_h;
  // the y tile and the state: thread (ty, tx) holds rows ty + TROW r and
  // columns tx + TCOL c; the 64 x 64 score tile: thread (sy, sx) holds
  // rows sy + 16 r and keys sx + 16 c, r, c < 4
  const int tx = tid % TCOL;
  const int ty = tid / TCOL;
  const int sx = tid & 15;
  const int sy = tid >> 4;

  for (int e = tid; e < N * HD; e += kThreads) {
    h_s[e] = p.h0 != nullptr ? p.h0[(long long)bh * N * HD + e] : 0.f;
  }

  for (int c0 = 0; c0 < p.S; c0 += p.chunk) {
    const int L = min(p.chunk, p.S - c0);
    __syncthreads();                 // the last chunk is done with its arrays
    // cum: inclusive prefix sum of a over the chunk in f64, rounded to f32
    // (0 past its end, so cum there stays at the last real token's)
    double v = 0.0;
    float dv = 0.f;
    if (tid < L) {
      v = ag[(long long)(c0 + tid) * p.as_s];
      dv = dg[(long long)(c0 + tid) * p.ds_s];
    }
    dt_s[tid] = dv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) tot_s[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += tot_s[w];
    cum_s[tid] = __double2float_rn(v);
    __syncthreads();
    const float cl = cum_s[L - 1];
    wj_s[tid] = tid < L ? expf(cl - cum_s[tid]) * dt_s[tid] : 0.f;
    ecum_s[tid] = expf(cum_s[tid]);
    const float decay_last = expf(cl);
    const int n_tiles = (L + kTile - 1) / kTile;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const bool last = it == n_tiles - 1;
      __syncthreads();               // c_s is free; wj_s, ecum_s are seen
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N;
        const int k = e % N;
        c_s[r * NP + k] =
            i0 + r < L ? to_f(Cg[(long long)(c0 + i0 + r) * p.cs_s + k]) : 0.f;
      }
      __syncthreads();

      // the carried state: y_i = exp(cum_i) C_i h
      float yacc[RPT][CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) yacc[r][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float hv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) hv[c] = h_s[k * HD + tx + TCOL * c];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float cv = c_s[(ty + TROW * r) * NP + k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) yacc[r][c] += cv * hv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float ec = ecum_s[i0 + ty + TROW * r];
#pragma unroll
        for (int c = 0; c < CPT; ++c) yacc[r][c] *= ec;
      }

      float hacc[KPT][CPT];          // the state update (last tile only)
#pragma unroll
      for (int r = 0; r < KPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) hacc[r][c] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();             // b_s, x_s, w_s are free
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N;
          const int k = e % N;
          b_s[r * NP + k] =
              j0 + r < L ? to_f(Bg[(long long)(c0 + j0 + r) * p.bs_s + k])
                         : 0.f;
        }
        for (int e = tid; e < kTile * HD; e += kThreads) {
          const int r = e / HD;
          const int d = e % HD;
          x_s[r * HD + d] =
              j0 + r < L ? to_f(xg[(long long)(c0 + j0 + r) * p.xs_s + d])
                         : 0.f;
        }
        __syncthreads();

        // w = (C.B^T) exp(cum_i - cum_j) dt_j for j <= i, masked before exp
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = c_s[(sy + 16 * r) * NP + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = b_s[(sx + 16 * c) * NP + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] += cv[r] * bv[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + sy + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + sx + 16 * c;
            const float w = (j <= i && j < L)
                                ? s[r][c] * expf(cum_s[i] - cum_s[j]) * dt_s[j]
                                : 0.f;
            w_s[(sy + 16 * r) * WP + sx + 16 * c] = w;
          }
        }
        __syncthreads();

        // y += w x; in the chunk's last query tile also the state update
        const int jn = min(kTile, L - j0);
        for (int j = 0; j < jn; ++j) {
          float xv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) xv[c] = x_s[j * HD + tx + TCOL * c];
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float wv = w_s[(ty + TROW * r) * WP + j];
#pragma unroll
            for (int c = 0; c < CPT; ++c) yacc[r][c] += wv * xv[c];
          }
          if (last) {
            const float wjv = wj_s[j0 + j];
#pragma unroll
            for (int r = 0; r < KPT; ++r) {
              const int k = ty + TROW * r;
              if (k < N) {
                const float bw = b_s[j * NP + k] * wjv;
#pragma unroll
                for (int c = 0; c < CPT; ++c) hacc[r][c] += bw * xv[c];
              }
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = i0 + ty + TROW * r;
        if (i < L) {
          const long long row = yoff + (long long)(c0 + i) * p.ys_s;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int d = tx + TCOL * c;
            if (p.y_f32) {
              store(static_cast<float*>(p.y) + row + d, yacc[r][c]);
            } else {
              store(static_cast<T*>(p.y) + row + d, yacc[r][c]);
            }
          }
        }
      }
      if (last) {
        // every thread read h_s (the carried term) before the key loop's
        // first barrier, and each state element has one owner
#pragma unroll
        for (int r = 0; r < KPT; ++r) {
          const int k = ty + TROW * r;
          if (k < N) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              float* hp = h_s + k * HD + tx + TCOL * c;
              *hp = *hp * decay_last + hacc[r][c];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * HD; e += kThreads) {
    p.h_out[(long long)bh * N * HD + e] = h_s[e];
  }
}

template <typename T, int HD, int N>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int bytes = Shape<HD, N>::kBytes;
  if (bytes > 48 * 1024) {           // the opt-in is per device: set it here
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks <= 0) return 0;
  ssd_kernel<T, HD, N><<<blocks, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int blocks, int hd, int n, cudaStream_t stream) {
  // (hd, n): the reference kernel sweep and test shapes, the reduced
  // configs, mamba2-2.7b and jamba's
  if (hd == 8 && n == 8) return launch<T, 8, 8>(a, blocks, stream);
  if (hd == 8 && n == 16) return launch<T, 8, 16>(a, blocks, stream);
  if (hd == 16 && n == 8) return launch<T, 16, 8>(a, blocks, stream);
  if (hd == 16 && n == 16) return launch<T, 16, 16>(a, blocks, stream);
  if (hd == 64 && n == 128) return launch<T, 64, 128>(a, blocks, stream);
  if (hd == 128 && n == 64) return launch<T, 128, 64>(a, blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ssd

// Plain C entry points (loaded with ctypes).  Element strides of x
// (Bsz, nh, S, hd), a and dt (Bsz, nh, S), B and C (Bsz, G, S, n) and y
// (Bsz, nh, S, hd); the last dim of x, B, C and y is contiguous.  h0 (null:
// zeros) and h_out are (Bsz, nh, n, hd) float32, contiguous, 16-byte
// aligned.  1 <= chunk <= 256.  Each returns the first failing launch's
// cudaError_t (0 on success).
//
// ssd_launch: the float32 body: x, B, C, a, dt and y float32.
extern "C" int ssd_launch(
    const void* x, const void* a, const void* dt, const void* B,
    const void* C, const void* h0, void* y, void* h_out, long long xs_b,
    long long xs_h, long long xs_s, long long as_b, long long as_h,
    long long as_s, long long ds_b, long long ds_h, long long ds_s,
    long long bs_b, long long bs_g, long long bs_s, long long cs_b,
    long long cs_g, long long cs_s, long long ys_b, long long ys_h,
    long long ys_s, int Bsz, int nh, int G, int S, int hd, int n, int chunk,
    void* stream) {
  if (G <= 0 || nh % G != 0 || S < 0 || chunk < 1 ||
      chunk > ssd::kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd::Args args{x,    static_cast<const float*>(a),
                 static_cast<const float*>(dt), B, C,
                 static_cast<const float*>(h0), y,
                 static_cast<float*>(h_out),
                 xs_b, xs_h, xs_s, as_b, as_h, as_s, ds_b, ds_h, ds_s,
                 bs_b, bs_g, bs_s, cs_b, cs_g, cs_s, ys_b, ys_h, ys_s,
                 nh,   G,    S,    chunk, 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ssd::dispatch<float>(args, Bsz * nh, hd, n, st);
}

// ssd_tc_launch: the bf16 body (ssd_tc.cuh).  x, B and C bfloat16, a and
// dt float32; y float32 when y_f32 is 1, else bfloat16.  cum (Bsz, nh, S)
// and st (Bsz, nh, ceil(S / chunk), n, hd) are float32 scratch,
// contiguous, that the call overwrites.
extern "C" int ssd_tc_launch(
    const void* x, const void* a, const void* dt, const void* B,
    const void* C, const void* h0, void* y, void* h_out, void* cum,
    void* st, long long xs_b, long long xs_h, long long xs_s,
    long long as_b, long long as_h, long long as_s, long long ds_b,
    long long ds_h, long long ds_s, long long bs_b, long long bs_g,
    long long bs_s, long long cs_b, long long cs_g, long long cs_s,
    long long ys_b, long long ys_h, long long ys_s, int Bsz, int nh, int G,
    int S, int hd, int n, int chunk, int y_f32, void* stream) {
  if (Bsz < 0 || nh < 1 || G <= 0 || nh % G != 0 || S < 0 || chunk < 1 ||
      chunk > ssd_tc::kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd_tc::Args args{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const float*>(a),
                    static_cast<const float*>(dt),
                    static_cast<const __nv_bfloat16*>(B),
                    static_cast<const __nv_bfloat16*>(C),
                    static_cast<const float*>(h0), y,
                    static_cast<float*>(h_out), static_cast<float*>(cum),
                    static_cast<float*>(st),
                    xs_b, xs_h, xs_s, as_b, as_h, as_s, ds_b, ds_h, ds_s,
                    bs_b, bs_g, bs_s, cs_b, cs_g, cs_s, ys_b, ys_h, ys_s,
                    Bsz, nh, G, S, chunk,
                    (S + chunk - 1) / chunk, y_f32,
                    ssd_tc::granule(x, xs_b, xs_h, xs_s),
                    ssd_tc::granule(B, bs_b, bs_g, bs_s),
                    ssd_tc::granule(C, cs_b, cs_g, cs_s)};
  return ssd_tc::dispatch(args, hd, n, static_cast<cudaStream_t>(stream));
}
