// Compressed-cache decode in bfloat16 on Hopper's tensor cores: the body
// behind every bf16 decode call, K3 (kq_decode.cu), K1, K4, K5 and K5 split
// (kq_paged.cu).  float32 decode and float32 K2 (the reduced parity runs)
// stay on kq_attend.cuh, in true f32; bf16 K2 has kq_prefill.cuh.
//
// It replaces the Pallas TPU kernels `_kq_decode_kernel`
// (src/repro/kernels/kq_decode/kq_decode.py:53), `_kq_decode_paged_kernel`
// (paged.py:63) and `_kq_decode_paged_split_kernel` (paged.py:120), with
// and without quant=True.  For every (slot b, kv group g) it runs an f32
// online softmax of the group's m <= 16 compressed queries qc (m, Rk)
// over the cached rows t < lengths[b] (clamped to the slot's capacity) and
// returns softmax(qc kc^T * scale) vc, (m, Rv), in bf16; a slot of length
// 0 gives a zero row.  Cache rows live where kq_attend.cuh says: dense
// (B, Hkv, T, R), or pools (P, Hkv, ps, R) read through the block table.
// Int8 pools hold codes with bf16 per-token scales (P, Hkv, ps, 1).  Split
// (K4, K5 split): the span [s * span, (s + 1) * span) of each slot gives
// f32 partials out_s = acc / max(l, 1e-30) and lse_s = m + log(max(l,
// 1e-30)) (an empty span: out 0, lse -1e30 + log(1e-30)), and the last
// CTA of each (b, g) to finish merges them into the output in the same
// launch (below); the partials alone, for kq_combine_splits, when no
// output is given.
//
// What bounds it: bytes.  A decode call reads each live cache row once,
// (Rk + Rv) itemsize bytes a token per kv head, and does 2 m (Rk + Rv)
// flops on it, m / itemsize flops a byte, far below the ~295 where the
// tensor cores would be the limit.  At 8 slots of tinyllama (Hkv 4, Rk 50,
// Rv 42, 3,421 live tokens) that is 2.6 MB, 0.77 us at 3.35 TB/s.  So the
// design is about latency: many bytes in flight early, and a short chain
// after they land.
//   * A cluster of C CTAs per (b, g) (per (b, g, span) when split),
//     C = clamp(ceil(tokens / 128), 1, 8) from the shapes alone (tokens:
//     the slot's capacity, or the span): 256 CTAs at 8 slots of 1,024
//     tokens, where one block per (b, g) made 32 for 132 SMs.  Each CTA
//     reads lengths[b] itself and takes the r-th of C equal runs of
//     16-token tiles of [lo, min(len, hi)); the host never reads lengths.
//     The CTAs' (max, sum, acc) partials merge through distributed shared
//     memory: each publishes its own, cluster.sync(), each CTA merges a
//     C-th of the group's outputs from all peers' shared memory and
//     writes it, and a second cluster.sync() keeps every CTA alive until
//     its peers have read it.  Unsplit, no partial goes to device memory;
//     split, the spans' partials merge in the same launch (below).
//   * Four warps a CTA, each with its own tiles (the CTA's tiles w, w + 4,
//     ...), its own ring of `stages` tile slots and its own running max and
//     sum: no block barrier until the merge.  A warp stages a tile with
//     `cp.async` into its slot, all of its tiles at once where shared
//     memory allows (two a warp at the main shape).  A tile's 16 rows are
//     copied packed, as they lie in the pool: a page's rows of one kv head
//     are one contiguous block of ps R itemsize bytes, so the tile is
//     16 / gcd(16, ps) contiguous segments, each copied in the widest
//     granule (16, 8 or 4 bytes; bytes through registers where none
//     divides) that the segment starts and the pool's base allow.  At
//     pages of 16 and the calibrated ranks every copy is 16 bytes, for
//     int8 pages too, where a row is 50 bytes.  Rows at or past the span's
//     end are zero-filled (cp.async's src-size), never read: p = 0 times
//     a NaN would still be NaN.  Each segment's pool row is one
//     block-table read by one lane, handed out by shuffle.
//   * Both products on the tensor cores, `mma.sync.m16n8k16` bf16 -> f32,
//     in FlashAttention-2's register layout.  The group's queries are the
//     16 rows of A, zero-padded, built once per CTA into fragment order in
//     shared memory (one 16-byte load a lane per 16 ranks).  S = Q K^T
//     runs over ceil(Rk / 16) rank steps, two 8-token column blocks a
//     step; the score accumulator is p's A fragment in registers, with no
//     shuffle, and p goes in as bf16 hi + lo (hi p truncated, lo = p - hi
//     rounded), two products, so the value sum keeps 16 bits of p and the
//     output stays within two bf16 ulps of the plain version, as in K2 and
//     K6.  O += P V runs over ceil(Rv / 8) column blocks of the p.v width
//     N, the smallest of KQ_DECODE_PV_WIDTHS at or above Rv (eight
//     instantiations a cache type; the group is always 16 rows, so none
//     depends on m or Rk).  B fragments are read from the packed rows two
//     values at a time; the pad columns past Rk and Rv read finite values
//     (the next row, or the zeroed tail after a tile) that meet zero
//     queries or columns never stored.  `wgmma` would take 64 rows, four
//     times the widest group; the synchronous `mma` also keeps its A
//     operands' registers to itself.
//   * Int8 pages on the same tensor cores, exactly: a code in [-127, 127]
//     is a bf16 value, so codes enter the products unchanged; the K scale
//     multiplies the token's score after Q K^T, the V scale multiplies p
//     before it is split into hi + lo, both in f32.  That is the plain
//     version's dequantize-then-dot up to f32 rounding, and device reads
//     stay int8.
//   * Scores in log2 units (scale * log2 e folded in once), exponentials
//     as single `ex2` ops; the running max starts at -1e30, so a row that
//     sees nothing keeps max -1e30, sum 0, acc 0 through every merge and
//     returns 0 (split: lse -1e30 + log(1e-30), as kq_attend.cuh writes).
//   * Split spans merge in the launch that computes them.  A span's
//     cluster cannot see the other spans' (n of them, C CTAs each, not
//     all resident at once: a CTA never waits on another through device
//     memory, or the launch could hang).  So every CTA writes its share
//     of its span's f32 partial (it stays in L2) and arrives: after the
//     cluster barrier, thread 0 adds 1 to an int32 counter of its (b, g)
//     with an atomic of acquire-release order at device scope, whose
//     release publishes what the barrier ordered before it.  Each (b, g)
//     has a 128-byte line of its own (kCountStride counters apart), so
//     the groups' atomics, which come all at once when the slots are of
//     one length, do not queue on one line.  The CTA that
//     sees n C - 1 is the last; it reads all n partials of its (b, g)
//     through L2 (`ld.global.cg`: L1 is not coherent across SMs), merges
//     the m Rv values, a thread each, with merge_value, which
//     kq_combine_splits runs too, so the output is bit for bit the two
//     launches' whichever CTA is last, and stores 0 back into the
//     counter: the buffer is zero before and after every launch, and
//     nothing outside the kernel resets it.  Every CTA arrives, those of
//     empty spans and slots too; the others leave.  This takes the merge
//     kernel's launch, its grid of tiny blocks and a DRAM round trip of
//     the partials off every split decode call.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py), as part
//             of kq_decode.cu and kq_paged.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <numeric>
#include <type_traits>
#include <utility>

// The p.v widths N the body is built for; Rv runs on the smallest N at or
// above it.  Multiples of 16 that together cover every Rv from 1 to 256
// (MAX_RANK); the wrapper's tests read this list.
#define KQ_DECODE_PV_WIDTHS(X) \
  X(16) X(32) X(48) X(64) X(96) X(128) X(192) X(256)

namespace kq_tc {

namespace cg = cooperative_groups;

constexpr int kTok = 16;             // tokens a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kRunTokens = 128;      // tokens a CTA the cluster size aims at
constexpr int kMaxStages = 8;        // tile slots a warp
constexpr int kTail = 32;            // zero bytes after a staged tile
constexpr int kMaxR = 256;
constexpr int kMaxGroup = 16;
constexpr int kMaxGroupInt8 = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kSmemBudget = 110 * 1024;   // two CTAs an SM
constexpr int kCountStride = 32;     // int32s a group's arrival counter owns

struct Params {
  const __nv_bfloat16* q;            // (B, H, Rk)
  const unsigned char* k;            // cache or pool rows of Rk codes
  const unsigned char* v;            // ... of Rv
  const unsigned char* ks;           // (P, Hkv, ps, 1) bf16 scales of
  const unsigned char* vs;           // int8 pools; nullptr: bf16 pools
  const int32_t* lengths;            // (B,)
  const int32_t* btab;               // (B, n_pages); nullptr: dense
  __nv_bfloat16* out;                // (B, H, Rv); split: may be nullptr
  float* o_part;                     // (B, Hkv, n, m, Rv), split
  float* lse;                        // (B, Hkv, n, m), split
  int* count;                        // (B * Hkv * kCountStride) zero
                                     // arrival counters, split with out
                                     // (merged in-launch)
  int H, Hkv, m, Rk, Rv;
  int t_cap;                         // tokens a slot holds (T, n_pages ps)
  int ps, n_pages;
  int seg;                           // tokens a contiguous segment
  int n_splits, span;                // spans a slot, tokens a span
  int C;                             // cluster size
  int stages;                        // tile slots a warp
  int gk, gv, gs;                    // copy granules of K, V, scale rows
  int nk;                            // 16-rank steps of q.k
  int k_bytes, v_bytes, slot_bytes;  // a slot: K tile, V tile, [scales]
  int warp_bytes;                    // a warp's ring (or its partial)
  float sl2;                         // scale * log2(e)
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float ex2(float x) {   // one MUFU op, ftz
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cp.async of G bytes of which the first `sz` are read and the rest
// zero-filled (src must still be a valid, aligned address); 16-byte copies
// bypass L1.
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int sz) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(sz) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(G), "r"(sz) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n (< kMaxStages) groups are pending
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

// A warp copies `bytes` contiguous bytes of which the first `valid` are
// read and the rest zeroed, in granules of G (G divides dst, src and
// bytes); G = 1 goes through registers.
template <int G>
__device__ __forceinline__ void copy_g(unsigned char* dst,
                                       const unsigned char* src,
                                       const unsigned char* any, int bytes,
                                       int valid, int lane) {
  for (int o = lane * G; o < bytes; o += 32 * G) {
    const int sz = min(G, max(0, valid - o));
    if constexpr (G >= 4)
      cp_async<G>(dst + o, sz > 0 ? src + o : any, sz);
    else
      dst[o] = sz > 0 ? __ldg(src + o) : static_cast<unsigned char>(0);
  }
}
__device__ __forceinline__ void copy_seg(int G, unsigned char* dst,
                                         const unsigned char* src,
                                         const unsigned char* any, int bytes,
                                         int valid, int lane) {
  switch (G) {
    case 16: copy_g<16>(dst, src, any, bytes, valid, lane); break;
    case 8: copy_g<8>(dst, src, any, bytes, valid, lane); break;
    case 4: copy_g<4>(dst, src, any, bytes, valid, lane); break;
    default: copy_g<1>(dst, src, any, bytes, valid, lane); break;
  }
}

// Two cache values *p0 (low half) and *p1 (high half) as a bf16 pair:
// bf16 rows as they are, int8 codes converted (exactly).
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p0,
                                         const __nv_bfloat16* p1) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p0)) |
         static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p1))
             << 16;
}
__device__ __forceinline__ uint32_t pair(const int8_t* p0, const int8_t* p1) {
  return pack_bf16(static_cast<float>(*p0), static_cast<float>(*p1));
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) . B (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split merge of one output value: out = sum_s w_s o_s / max(sum_s
// w_s, 1e-30), w_s = exp(lse_s - max_s lse_s), summed over the spans in
// order.  lse: its row's lse in span 0, spans `ls` apart; op: its partial
// in span 0, spans `os` apart.  The loads of the first kMergeBatch spans
// are issued together (one L2 round trip for up to 8 spans, which is
// every split the engines make), spans past them one at a time.  Loads go
// through L2 (`ld.global.cg`), so a partial written by another SM in the
// same launch is never read from a stale L1 line.  kq_combine_splits
// (kq_paged.cu) and the fused tail of decode_tc_kernel both run this, so
// their outputs are the same bits; each value's operations are those of a
// lane walking the spans in order (the max is exact in any order).
constexpr int kMergeBatch = 8;

__device__ __forceinline__ float merge_value(const float* lse,
                                             const float* op, int n, int ls,
                                             int os) {
  float l[kMergeBatch], o[kMergeBatch];
#pragma unroll
  for (int u = 0; u < kMergeBatch; ++u) {
    l[u] = u < n ? __ldcg(lse + (size_t)u * ls)
                 : __int_as_float(0xff800000);        // -inf
    o[u] = u < n ? __ldcg(op + (size_t)u * os) : 0.f;
  }
  float mx = l[0];
#pragma unroll
  for (int u = 1; u < kMergeBatch; ++u) mx = fmaxf(mx, l[u]);
#pragma unroll 1
  for (int s = kMergeBatch; s < n; ++s)
    mx = fmaxf(mx, __ldcg(lse + (size_t)s * ls));
  float den = 0.f, acc = 0.f;
#pragma unroll
  for (int u = 0; u < kMergeBatch; ++u) {
    if (u < n) {
      const float w = expf(l[u] - mx);
      den += w;
      acc = fmaf(w, o[u], acc);
    }
  }
#pragma unroll 1
  for (int s = kMergeBatch; s < n; ++s) {
    const float w = expf(__ldcg(lse + (size_t)s * ls) - mx);
    den += w;
    acc = fmaf(w, __ldcg(op + (size_t)s * os), acc);
  }
  return acc / fmaxf(den, 1e-30f);
}

// *c += 1 with acquire-release order at device scope; returns the old value
__device__ __forceinline__ int arrive(int* c) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(c) : "memory");
  return old;
}

// The last CTA of (b, g) merges its m Rv outputs, a thread a value at a
// time.  lse, o_part: the (b, g)'s span 0 (B, Hkv, n, m[, Rv]); out: its
// first row (b, g m) of (B, H, Rv).  Out of line, so that the body's
// registers are allocated as if it were not there, and short: it runs
// once a launch from a cold instruction cache, where in a decode step its
// code costs more than its loads (on an H100, a version that overlapped
// each value's loads with the one before took 0.9 us more a call there).
__device__ __noinline__ void merge_spans(const float* lse,
                                         const float* o_part,
                                         __nv_bfloat16* out, int n, int m,
                                         int Rv) {
  for (int i = threadIdx.x; i < m * Rv; i += kThreads)
    out[i] = __float2bfloat16(merge_value(lse + i / Rv, o_part + i, n, m,
                                          m * Rv));
}

// Shared memory: the queries' A fragments [nk][32 lanes][4 x 32 bits]; a
// region of warp_bytes a warp (its ring of `stages` slots, then its
// partial m[16], l[16], acc[16][Rv] f32); the CTA's partial (the same
// layout), which the cluster's peers read.  A slot: the K tile (16 packed
// rows, zero to k_bytes), the V tile (to v_bytes), and for int8 pools the
// 16 K scales and 16 V scales (bf16).
// C: the cache element type (bf16, or int8 with scales); N: p.v width.
template <typename C, int N>
__global__ void __launch_bounds__(kThreads)
    decode_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int isz = sizeof(C);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / p.C;
  const int sp = cl % p.n_splits;
  const int bg = cl / p.n_splits;              // b * Hkv + g
  const int b = bg / p.Hkv;
  const int g = bg % p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int m = p.m, Rk = p.Rk, Rv = p.Rv;

  uint4* qf = reinterpret_cast<uint4*>(smem);
  unsigned char* wreg = smem + p.nk * 32 * 16;
  unsigned char* ring = wreg + warp * p.warp_bytes;
  float* part = reinterpret_cast<float*>(wreg + kWarps * p.warp_bytes);

  int len = p.lengths[b];
  // the queries' A fragments, zero past m rows and Rk ranks: register q
  // of lane (g8, t4) at step kk holds row g8 + 8 (q & 1), ranks
  // 16 kk + 8 (q >> 1) + 2 t4 and + 1
  const __nv_bfloat16* qg = p.q + ((size_t)b * p.H + (size_t)g * m) * Rk;
  for (int i = tid; i < p.nk * 32; i += kThreads) {
    const int kk = i / 32, ln = i % 32;
    uint32_t a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = (ln >> 2) + 8 * (q & 1);
      const int col = 16 * kk + 8 * (q >> 1) + 2 * (ln & 3);
      const unsigned short* qr =
          reinterpret_cast<const unsigned short*>(qg + (size_t)row * Rk);
      const uint32_t lo = row < m && col < Rk ? __ldg(qr + col) : 0u;
      const uint32_t hi = row < m && col + 1 < Rk ? __ldg(qr + col + 1) : 0u;
      a[q] = lo | hi << 16;
    }
    qf[i] = make_uint4(a[0], a[1], a[2], a[3]);
  }
  // the pads after each slot's tiles, which copies never write, are zero
  for (int s = 0; s < p.stages; ++s) {
    unsigned char* slot = ring + s * p.slot_bytes;
    for (int o = kTok * Rk * isz + lane; o < p.k_bytes; o += 32) slot[o] = 0;
    for (int o = kTok * Rv * isz + lane; o < p.v_bytes; o += 32)
      slot[p.k_bytes + o] = 0;
  }

  // this CTA's tiles: the rank-th of C equal runs of the span's 16-token
  // tiles below the slot's length; this warp's are tiles w, w + 4, ...
  len = min(max(len, 0), p.t_cap);
  const int lo = sp * p.span;
  const int hi = min(len, lo + p.span);
  const int n_t = hi > lo ? (hi - lo + kTok - 1) / kTok : 0;
  const int per = (n_t + p.C - 1) / p.C;
  const int j0 = min(n_t, rank * per) + warp;
  const int j1 = min(n_t, (rank + 1) * per);
  const int n_my = j1 > j0 ? (j1 - j0 + kWarps - 1) / kWarps : 0;
  auto tile_t0 = [&](int i) { return lo + kTok * (j0 + kWarps * i); };

  // stage this warp's i-th tile into slot i % stages: 16 / seg segments of
  // seg tokens, each contiguous in the pool
  const unsigned char* any_k = p.k;
  const unsigned char* any_v = p.v;
  auto stage = [&](int i) {
    const int t0 = tile_t0(i);
    unsigned char* slot = ring + (i % p.stages) * p.slot_bytes;
    const int nseg = kTok / p.seg;
    int my_row = 0;
    if (lane < nseg) {
      const int t = t0 + lane * p.seg;
      if (t < hi)
        my_row = p.btab == nullptr
            ? bg * p.t_cap + t
            : (p.btab[(size_t)b * p.n_pages + t / p.ps] * p.Hkv + g) * p.ps +
                  t % p.ps;
    }
    for (int sg = 0; sg < nseg; ++sg) {
      const size_t row = static_cast<size_t>(
          __shfl_sync(0xffffffffu, my_row, sg));
      const int nv = min(p.seg, max(0, hi - t0 - sg * p.seg));
      const int rk = Rk * isz, rv = Rv * isz;
      copy_seg(p.gk, slot + sg * p.seg * rk, p.k + row * rk, any_k,
               p.seg * rk, nv * rk, lane);
      copy_seg(p.gv, slot + p.k_bytes + sg * p.seg * rv, p.v + row * rv,
               any_v, p.seg * rv, nv * rv, lane);
      if constexpr (kInt8) {
        unsigned char* sc = slot + p.k_bytes + p.v_bytes + sg * p.seg * 2;
        copy_seg(p.gs, sc, p.ks + row * 2, p.ks, p.seg * 2, nv * 2, lane);
        copy_seg(p.gs, sc + 2 * kTok, p.vs + row * 2, p.vs, p.seg * 2,
                 nv * 2, lane);
      }
    }
  };

  __syncthreads();                 // the query fragments and pads are in
  for (int i = 0; i < p.stages; ++i) {
    if (i < n_my) stage(i);
    cp_commit();
  }

  float acc[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};      // this lane's part of the row sums

  for (int i = 0; i < n_my; ++i) {
    cp_wait_n(p.stages - 1);
    __syncwarp();                   // tile i is in for the whole warp
    const int t0 = tile_t0(i);
    const unsigned char* slot = ring + (i % p.stages) * p.slot_bytes;
    const C* kt = reinterpret_cast<const C*>(slot);
    const C* vt = reinterpret_cast<const C*>(slot + p.k_bytes);

    // s[n][e]: row g8 + 8 (e >> 1), token 8 n + 2 t4 + (e & 1)
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kk = 0; kk < p.nk; ++kk) {
      const uint4 af = qf[kk * 32 + lane];
      const uint32_t a[4] = {af.x, af.y, af.z, af.w};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const C* kr = kt + (8 * n + g8) * Rk + 16 * kk + 2 * t4;
        mma(s[n], a, pair(kr, kr + 1), pair(kr + 8, kr + 9));
      }
    }

    // scale (and the K scale), mask tokens past the span, online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * n + 2 * t4 + (e & 1);
        float x = s[n][e] * p.sl2;
        if constexpr (kInt8)
          x *= __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
              slot + p.k_bytes + p.v_bytes)[tok]);
        x = t0 + tok < hi ? x : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      corr[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // p (times the V scale) as bf16 hi + lo in P's A fragments: register
    // q holds row g8 + 8 (q & 1), tokens 8 (q >> 1) + 2 t4 and + 1, i.e.
    // s[q >> 1][2 (q & 1)] and + 1
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = q >> 1, r = q & 1;
      float p0 = ex2(s[n][2 * r] - m_run[r]);
      float p1 = ex2(s[n][2 * r + 1] - m_run[r]);
      l_run[r] += p0 + p1;
      if constexpr (kInt8) {
        const __nv_bfloat16* vsc = reinterpret_cast<const __nv_bfloat16*>(
            slot + p.k_bytes + p.v_bytes + 2 * kTok);
        p0 *= __bfloat162float(vsc[8 * n + 2 * t4]);
        p1 *= __bfloat162float(vsc[8 * n + 2 * t4 + 1]);
      }
      // hi: p truncated to bf16 (its upper half); lo = p - hi is exact in
      // f32 and rounded to bf16, so hi + lo keeps 16 bits of p
      const uint32_t b0 = __float_as_uint(p0) & 0xffff0000u;
      const uint32_t b1 = __float_as_uint(p1) & 0xffff0000u;
      ph[q] = __byte_perm(b0, b1, 0x7632);
      pl[q] = pack_bf16(p0 - __uint_as_float(b0), p1 - __uint_as_float(b1));
    }
    // O += P V: column block n, tokens 2 t4 (+1) and 2 t4 + 8 (+1) of
    // column 8 n + g8
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      if (8 * n < Rv) {
        const C* vc = vt + 2 * t4 * Rv + 8 * n + g8;
        const uint32_t b0 = pair(vc, vc + Rv);
        const uint32_t b1 = pair(vc + 8 * Rv, vc + 9 * Rv);
        mma(acc[n], ph, b0, b1);
        mma(acc[n], pl, b0, b1);
      }
    }
    __syncwarp();                   // slot i % stages read by every lane
    if (i + p.stages < n_my) stage(i + p.stages);
    cp_commit();
  }
  cp_wait<0>();
  __syncwarp();

  // this warp's partial, over its ring: m[16], l[16], acc[16][Rv]
  float* wp = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    if (t4 == 0) {
      wp[g8 + 8 * r] = m_run[r];
      wp[kTok + g8 + 8 * r] = l;
    }
  }
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * n + 2 * t4 + (e & 1);
      if (col < Rv) wp[2 * kTok + (g8 + 8 * (e >> 1)) * Rv + col] = acc[n][e];
    }
  __syncthreads();

  // the CTA's partial: the warps' rescaled to their common max
  for (int i = tid; i < m * Rv; i += kThreads) {
    const int j = i / Rv;
    const int c = i - j * Rv;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mw = fmaxf(mw, reinterpret_cast<const float*>(wreg +
                                                    w * p.warp_bytes)[j]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* x = reinterpret_cast<const float*>(wreg + w * p.warp_bytes);
      const float f = ex2(x[j] - mw);
      l += x[kTok + j] * f;
      a += x[2 * kTok + i] * f;
    }
    part[2 * kTok + i] = a;
    if (c == 0) {
      part[j] = mw;
      part[kTok + j] = l;
    }
  }
  cluster.sync();                   // every CTA's partial is published

  // the cluster's merge: this CTA takes outputs rank, rank + C, ... (in
  // units of kThreads), reading every peer's partial
  for (int i = rank * kThreads + tid; i < m * Rv; i += p.C * kThreads) {
    const int j = i / Rv;
    const int c = i - j * Rv;
    float mc = kNegInf;
    for (int r = 0; r < p.C; ++r)
      mc = fmaxf(mc, cluster.map_shared_rank(part, r)[j]);
    float l = 0.f, a = 0.f;
    for (int r = 0; r < p.C; ++r) {
      const float* x = cluster.map_shared_rank(part, r);
      const float f = ex2(x[j] - mc);
      l += x[kTok + j] * f;
      a += x[2 * kTok + i] * f;
    }
    const float den = fmaxf(l, 1e-30f);
    if (p.o_part == nullptr) {
      p.out[((size_t)b * p.H + (size_t)g * m + j) * Rv + c] =
          __float2bfloat16(a / den);
    } else {
      const size_t prow = ((size_t)bg * p.n_splits + sp) * m + j;
      p.o_part[prow * Rv + c] = a / den;
      if (c == 0)
        p.lse[prow] = (mc == kNegInf ? kNegInf : mc * kLn2) + logf(den);
    }
  }
  cluster.sync();                   // no CTA leaves while a peer reads it
  if (p.o_part == nullptr || p.out == nullptr) return;

  // split with an output: every CTA arrives; the barrier above orders
  // all its threads' partial stores before thread 0's release, which
  // publishes them device-wide (the pattern of a grid-wide sync)
  __shared__ int last;
  int* count = p.count + (size_t)bg * kCountStride;
  if (tid == 0) last = arrive(count) == p.n_splits * p.C - 1;
  __syncthreads();                  // thread 0's acquire, for every thread
  if (!last) return;
  const size_t row0 = (size_t)bg * p.n_splits * m;      // (b, g, span 0)
  merge_spans(p.lse + row0, p.o_part + row0 * Rv,
              p.out + ((size_t)b * p.H + (size_t)g * m) * Rv, p.n_splits, m,
              Rv);
  if (tid == 0) *count = 0;         // zero again for the next launch
}

// The cluster size for a span of `tokens` tokens: about kRunTokens a CTA,
// at most kMaxCluster.
inline int cluster_size(int tokens) {
  const int c = (tokens + kRunTokens - 1) / kRunTokens;
  return c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
}

// The widest copy granule, 16, 8 or 4 bytes (else 1), that divides the
// base address and both byte counts.
inline int granule(const void* base, long long a, long long b) {
  const unsigned long long x = reinterpret_cast<uintptr_t>(base) |
                               static_cast<unsigned long long>(a) |
                               static_cast<unsigned long long>(b) | 16ull;
  const int g = static_cast<int>(x & (~x + 1));
  return g >= 4 ? g : 1;
}

template <typename C, int N>
int launch(const Params& p, int grid, size_t smem, cudaStream_t stream) {
  auto* kernel = decode_tc_kernel<C, N>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));      // the opt-in is per device: set it here
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// bf16 decode: checks what the body takes (groups m <= 16, int8 m <= 8;
// ranks 1..256), lays out the launch and runs the instantiation of the
// smallest p.v width >= Rv.  btab == nullptr: a dense cache (B, Hkv, t_cap,
// R) and ps ignored; else pools (P, Hkv, ps, R) and a table (B, n_pages),
// t_cap = n_pages ps.  kscale / vscale: int8 pools.  o_part / lse: the
// split partials of n_splits spans of `span` tokens, merged into `out` in
// the launch when out is given too, with `count` B * Hkv * kCountStride
// int32 counters that are zero (and left zero); nullptr: the output,
// unsplit.
inline int decode_bf16(const void* qc, const void* kc, const void* vc,
                       const void* kscale, const void* vscale,
                       const void* lengths, const void* btab, void* out,
                       void* o_part, void* lse, void* count, int B, int H,
                       int Hkv, int Rk, int Rv, int t_cap, int ps,
                       int n_pages, int span, int n_splits, float scale,
                       void* stream) {
  const bool int8 = kscale != nullptr;
  if (B < 1 || Hkv < 1 || H % Hkv != 0 ||
      H / Hkv > (int8 ? kMaxGroupInt8 : kMaxGroup) || Rk < 1 || Rk > kMaxR ||
      Rv < 1 || Rv > kMaxR || t_cap < 1 || ps < 1 || n_splits < 1 ||
      span < 1 || (kscale == nullptr) != (vscale == nullptr) ||
      (o_part == nullptr) != (lse == nullptr) ||
      (o_part == nullptr && (n_splits != 1 || span < t_cap ||
                             out == nullptr || count != nullptr)) ||
      (o_part != nullptr && (out == nullptr) != (count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int isz = int8 ? 1 : 2;
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(qc);
  p.k = static_cast<const unsigned char*>(kc);
  p.v = static_cast<const unsigned char*>(vc);
  p.ks = static_cast<const unsigned char*>(kscale);
  p.vs = static_cast<const unsigned char*>(vscale);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.btab = static_cast<const int32_t*>(btab);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_part = static_cast<float*>(o_part);
  p.lse = static_cast<float*>(lse);
  p.count = static_cast<int*>(count);
  p.H = H;
  p.Hkv = Hkv;
  p.m = H / Hkv;
  p.Rk = Rk;
  p.Rv = Rv;
  p.t_cap = t_cap;
  p.ps = ps;
  p.n_pages = n_pages;
  p.n_splits = n_splits;
  p.span = o_part == nullptr ? t_cap : span;
  p.nk = (Rk + 15) / 16;
  p.sl2 = scale * 1.4426950408889634f;
  // segments: a page's rows are contiguous, and a tile starts at a
  // multiple of gcd(16, ps) tokens into a page (spans start on pages);
  // a dense slot is one block of t_cap rows
  const long long rk = (long long)Rk * isz, rv = (long long)Rv * isz;
  if (btab == nullptr) {
    p.seg = kTok;
    p.gk = granule(kc, kTok * rk, t_cap * rk);
    p.gv = granule(vc, kTok * rv, t_cap * rv);
    p.gs = 1;
  } else {
    p.seg = std::gcd(kTok, ps);
    p.gk = granule(kc, p.seg * rk, 0);
    p.gv = granule(vc, p.seg * rv, 0);
    p.gs = int8 ? granule(kscale, 2 * p.seg, 0) : 1;
    if (int8) {
      const int g2 = granule(vscale, 2 * p.seg, 0);
      p.gs = g2 < p.gs ? g2 : p.gs;
    }
  }
  p.C = cluster_size(p.span);
  // a slot: the tiles' rows, padded to 16 bytes, then a zero tail that
  // the pad columns of the last row read (under 16 ranks, 8 columns)
  p.k_bytes = static_cast<int>((kTok * rk + 15) / 16 * 16 + kTail);
  p.v_bytes = static_cast<int>((kTok * rv + 15) / 16 * 16 + kTail);
  p.slot_bytes = p.k_bytes + p.v_bytes + (int8 ? 4 * kTok : 0);
  const int part_bytes = (2 * kTok + kTok * Rv) * 4;
  const int tiles = (p.span + kTok - 1) / kTok;
  const int per_warp = ((tiles + p.C - 1) / p.C + kWarps - 1) / kWarps;
  p.stages = per_warp < 1 ? 1 : (per_warp > kMaxStages ? kMaxStages
                                                       : per_warp);
  auto smem_of = [&](int stages) {
    const int ring = stages * p.slot_bytes;
    const int wb = ((ring > part_bytes ? ring : part_bytes) + 15) / 16 * 16;
    return std::make_pair(wb, (size_t)p.nk * 32 * 16 +
                                  (size_t)kWarps * wb + part_bytes);
  };
  while (p.stages > 1 && smem_of(p.stages).second > kSmemBudget) --p.stages;
  p.warp_bytes = smem_of(p.stages).first;
  const size_t smem = smem_of(p.stages).second;
  const long long grid = (long long)B * Hkv * n_splits * p.C;
  const auto st = static_cast<cudaStream_t>(stream);
#define KQ_DECODE_CASE(n)                                              \
  if (Rv <= n)                                                         \
    return int8 ? launch<int8_t, n>(p, (int)grid, smem, st)            \
                : launch<__nv_bfloat16, n>(p, (int)grid, smem, st);
  KQ_DECODE_PV_WIDTHS(KQ_DECODE_CASE)
#undef KQ_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace kq_tc
