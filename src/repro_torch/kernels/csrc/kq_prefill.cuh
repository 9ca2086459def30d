// K2, the paged prefill-append, in bf16: a body of its own on Hopper's
// tensor cores.  (float32 K2 stays on the shared CUDA-core body,
// kq_attend.cuh, in true f32; K1, K3, K4 and K5 too.)
//
// Replaces the Pallas TPU kernel `_kq_prefill_paged_kernel`
// (src/repro/kernels/kq_decode/paged.py:292, entry point
// `kq_prefill_paged_attention` at :342).  qc (B, H, S, Rk), pools
// kc (P, Hkv, ps, Rk) and vc (P, Hkv, ps, Rv), block_table (B, n_pages),
// lengths and pos0 (B,) -> out (B, H, S, Rv), all bf16 but the int32
// metadata: query s of head h (kv group g = h / m) sees cache token t when
// t <= pos0[b] + s and t < lengths[b], token t living in pool row
// (block_table[b, t / ps] * Hkv + g) * ps + t % ps; a bucket-padding query
// (pos0[b] + s >= lengths[b]) sees the whole prefix; the softmax
// statistics are f32, and a row that sees nothing returns 0.
//
// What bounds it: operations, on tensor cores.  A chunk of S queries over
// a prefix of L tokens does 2 (Rk + Rv) flops per (query, key) pair per
// head on under a megabyte of cache: at tinyllama's last 256-token chunk
// of a 1000-token prompt (H 32, Hkv 4, Rk 50, Rv 42) about 1.35 GFLOP,
// 1.4 us at 989 TFLOP/s against 0.7 us for its 2.2 MB of queries, cache
// and output at 3.35 TB/s.  The design:
//   * row tiles of 64 flattened (position, head) rows of one (b, kv
//     group), as K6 (flash.cu): row r is position r / m of head
//     g m + r % m, so each staged K/V tile serves all m heads of the group
//     and 64 / m positions; qc (B, H, S, Rk) is read through that map.
//     At the main shape (m 8, S 256) the 2,048 rows of a group make 32
//     blocks, 128 in all for 132 SMs, where K6's 128-row blocks would leave
//     half the card idle.  One warpgroup a block would leave an SM 4 warps
//     to hide every latency with (one block an SM at that shape), so a
//     block runs two: each takes 32 of a staged tile's 64 keys for all 64
//     rows with its own online softmax, and warpgroup 1 hands its (max,
//     sum, acc) to warpgroup 0 through shared memory at the end.  Up to
//     Rv 64 two blocks share an SM when the grid is larger.  The heaviest
//     row tiles (latest positions) are scheduled first;
//   * both products on `wgmma` (sm_90a).  S = Q.K^T is m64n32k16 with a
//     runtime loop over ceil(Rk / 16) depth steps: Q and K are staged
//     zero-padded to a multiple of 16 columns, so no instantiation
//     depends on Rk.  O += P.V is m64nNk16, N the smallest of
//     KQ_PREFILL_PV_WIDTHS at or above Rv (eight instantiations cover
//     every Rv from 1 to 256; V's pad columns are zero and never stored).
//     p goes in as bf16 hi + lo (hi p truncated, lo = p - hi rounded), two
//     products, so the value sum keeps 16 bits of p and the output stays
//     within two bf16 ulps of the plain version, as in K6;
//   * staging through the block table.  A pool row is R bf16 values, 100
//     bytes at Rk 50 and 84 at Rv 42: at the calibrated ranks no row is
//     16-byte aligned, so K6's 16-byte copies do not carry over.  Each
//     operand is copied in the widest granule its rows and base allow:
//     16-byte `cp.async` when R is a multiple of 8, 8-byte at R = 4 mod 8,
//     4-byte at other even R, and at odd R (2-byte rows) loads through
//     registers.  Shared tiles keep wgmma's unswizzled core-matrix layout
//     ([16-byte chunk][row][16 bytes]); a warp's copies of one granule
//     size land on whole 128-byte lines of it, free of bank conflicts.
//     Tiles of 64 keys span 64 / ps pages (16 at ps 4): each key's pool
//     row is looked up once per tile, three tiles ahead, into a small
//     table in shared memory (the block-table read is issued at the top of
//     an iteration and stored after the products, so its latency hides
//     behind them), and K/V tiles go through a ring of kStages, filled two
//     tiles ahead under cp.async commit/wait groups with one block barrier
//     a tile, as in K6.  The pool layout is the one K1, K3-K5 and the page
//     layouts read.  The price: at the calibrated ranks a warp's 4-byte
//     copies touch 8 pool rows, so the refill costs many more L1
//     transactions than its bytes; a swizzled layout that lets a warp copy
//     along rows is later work;
//   * the band alone.  A block reads keys [0, lim(last row)) with
//     lim(r) = min(lengths[b], max(pos0[b] + r / m + 1, 0)), which is
//     non-decreasing in r, and nothing beyond; tiles below lim(first row)
//     skip the per-element mask.  Rows past m S, pad columns of Q, K and V
//     and keys past the band are zero-filled, so 0 x garbage never makes
//     a NaN (the reference zeroes dead rows for that reason,
//     paged.py:328-331);
//   * the output, whose rows of Rv bf16 are no 16-byte units either, is
//     stored from the accumulators, two values a store where Rv is even.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py), as part
//             of kq_paged.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The p.v widths N the bf16 body is built for; Rv runs on the smallest N
// at or above it.  Each is a multiple of 8 up to 256, as wgmma takes, and
// together they cover every Rv from 1 to 256 (MAX_RANK); the wrapper's
// tests read this list.
#define KQ_PREFILL_PV_WIDTHS(X) \
  X(16) X(32) X(48) X(64) X(96) X(128) X(192) X(256)

namespace kq_prefill {

constexpr int kRows = 64;           // flattened query rows a block
constexpr int kKeys = 64;           // keys a staged tile
constexpr int kThreads = 256;       // two warpgroups: a tile's key halves
constexpr int kStages = 3;          // K/V ring depth: kStages - 1 tiles in flight
constexpr int kMaxR = 256;
constexpr size_t kSmemLimit = 232448;  // per-block opt-in maximum on sm_90

struct Args {
  const __nv_bfloat16* q;           // (B, H, S, Rk)
  const __nv_bfloat16* k;           // (P, Hkv, ps, Rk)
  const __nv_bfloat16* v;           // (P, Hkv, ps, Rv)
  const int32_t* lengths;           // (B,)
  const int32_t* pos0;              // (B,)
  const int32_t* btab;              // (B, n_pages)
  __nv_bfloat16* out;               // (B, H, S, Rv)
  int B, H, Hkv, m, S, ps, n_pages, Rk, Rv;
  int kchunks;                      // 16-byte chunks of a Q / K row, padded
  int gq, gk, gv;                   // copy granule in bytes: 16, 8, 4 or 2
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

// wgmma's shared-memory matrix descriptor, unswizzled: core matrices of
// 8 rows x 16 bytes, `lbo` bytes apart along the reduction (K) dim and
// `sbo` bytes apart along M / N.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

// cp.async of G bytes, zero-filled when !ok (src must still be a valid
// address); 16-byte copies bypass L1.
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(G), "r"(ok ? G : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ float ex2(float x) {   // one MUFU op, ftz
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// keeps the compiler from touching accumulators while wgmma owns them
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// An A fragment in registers must not change until the wgmma that reads it
// has completed, and ptxas does not guard those registers (it does the
// accumulators): a register-A batch builds all of its fragments, issues,
// waits, and then "uses" the fragments here, so that none of their
// registers is reused while a wgmma may still read it.
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

// S (64 rows x 32 keys, f32) = Q (64 x 16) . K (32 x 16)^T, both K-major
// in shared memory; scale_d 0 overwrites S, 1 accumulates.
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t qd, uint64_t kd,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(qd), "l"(kd), "r"(scale_d));
}

// O (64 x N, f32) += P (64 x 16 keys, bf16 in registers) . V (16 keys x N),
// V N-major in shared memory (trans-b 1).
template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t vd);

template <>
__device__ __forceinline__ void wgmma_pv<16>(float* d, const uint32_t* a,
                                          uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<32>(float* d, const uint32_t* a,
                                          uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<48>(float* d, const uint32_t* a,
                                          uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float* d, const uint32_t* a,
                                          uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<96>(float* d, const uint32_t* a,
                                          uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float* d, const uint32_t* a,
                                           uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<192>(float* d, const uint32_t* a,
                                           uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<256>(float* d, const uint32_t* a,
                                           uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd), "r"(1));
}


// Copies kRows rows of `chunks` 16-byte chunks (R bf16 values a row, the
// rest zero) into the core-matrix layout [chunk][row][16 bytes], in
// granules of G bytes (G divides 2 R and the source's alignment).  A unit
// is the 8 rows x 16 bytes of one chunk (128 contiguous bytes of shared
// memory), copied by 8 * 16 / G threads, granule fastest.  A thread keeps
// to the same rows (one, or 8 / kPar when fewer than 8 units run in
// parallel) across the chunks, so `src(row)`, row `row`'s first value or
// nullptr for a row to zero-fill, is asked once a row.  G == 2 (odd R)
// goes through registers: cp.async takes no 2-byte copies.
template <int G, typename Src>
__device__ __forceinline__ void stage_g(unsigned char* dst, int chunks,
                                        int R, const __nv_bfloat16* any,
                                        Src src) {
  constexpr int kPer = 16 / G;            // granules a chunk
  constexpr int kUnit = 8 * kPer;         // threads a unit
  constexpr int kPar = kThreads / kUnit;  // units in parallel
  constexpr int kRG = kPar >= 8 ? 1 : 8 / kPar;     // row groups a thread
  constexpr int kStep = kPar >= 8 ? kPar / 8 : 1;   // its chunk stride
  const int sub = threadIdx.x % kUnit;
  const int us = threadIdx.x / kUnit;
  const int u = sub % kPer;
  int row[kRG];
  const __nv_bfloat16* p[kRG];
#pragma unroll
  for (int i = 0; i < kRG; ++i) {
    row[i] = (us % 8 + i * kPar) * 8 + sub / kPer;
    p[i] = src(row[i]);
  }
#pragma unroll 4
  for (int c = kPar >= 8 ? us / 8 : 0; c < chunks; c += kStep) {
    const int col = 8 * c + u * (G / 2);
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      const bool ok = p[i] != nullptr && col < R;
      unsigned char* d = dst + (c * kRows + row[i]) * 16 + u * G;
      if constexpr (G == 2) {
        *reinterpret_cast<unsigned short*>(d) =
            ok ? __ldg(reinterpret_cast<const unsigned short*>(p[i] + col))
               : static_cast<unsigned short>(0);
      } else {
        cp_async<G>(d, ok ? p[i] + col : any, ok);
      }
    }
  }
}

template <typename Src>
__device__ __forceinline__ void stage(int g, unsigned char* dst, int chunks,
                                      int R, const __nv_bfloat16* any,
                                      Src src) {
  switch (g) {
    case 16: stage_g<16>(dst, chunks, R, any, src); break;
    case 8: stage_g<8>(dst, chunks, R, any, src); break;
    case 4: stage_g<4>(dst, chunks, R, any, src); break;
    default: stage_g<2>(dst, chunks, R, any, src); break;
  }
}

// Shared memory: Q [kchunks][kRows][16 B]; kStages ring stages of
// K [kchunks][kKeys][16 B] and V [N / 8][kKeys][16 B]; the row table
// [kStages][kKeys] int32.
template <int N>
__host__ __device__ inline size_t smem_bytes(int kchunks) {
  return (size_t)16 * kchunks * kRows +
         kStages * ((size_t)16 * kchunks * kKeys + (size_t)2 * N * kKeys) +
         (size_t)4 * kStages * kKeys;
}

template <int N>
__global__ void __launch_bounds__(kThreads, N <= 64 ? 2 : 1)
    prefill_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kbytes = 16 * a.kchunks * kKeys;
  const int stage_bytes = kbytes + 2 * N * kKeys;
  unsigned char* q_s = smem;
  unsigned char* ring = smem + 16 * a.kchunks * kRows;
  int* rtab = reinterpret_cast<int*>(ring + kStages * stage_bytes);
  const int tid = threadIdx.x;
  const int wg = tid / 128;         // keys 32 wg .. 32 wg + 31 of each tile
  const int warp = (tid / 32) % 4;  // rows 16 warp .. 16 warp + 15
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;

  // the heaviest row tiles (latest positions) are scheduled first
  const int n_bg = a.B * a.Hkv;
  const int tile = a.n_tiles - 1 - blockIdx.x / n_bg;
  const int bg = blockIdx.x % n_bg;
  const int b = bg / a.Hkv;
  const int g = bg % a.Hkv;
  const int m = a.m;
  const int nrows = m * a.S;
  const int r0 = tile * kRows;
  const int t_cap = a.ps * a.n_pages;
  const int len = min(max(a.lengths[b], 0), t_cap);
  const int p0 = a.pos0[b];
  // the keys row r sees: [0, lim(r)), non-decreasing in r
  auto lim_of = [&](int r) { return min(len, max(p0 + r / m + 1, 0)); };
  const int t_hi = lim_of(min(r0 + kRows, nrows) - 1);   // the block's band
  // keys every row of the block sees (0 when some rows are past the end)
  const int t_all = r0 + kRows <= nrows ? lim_of(r0) : 0;
  const int n_kt = (t_hi + kKeys - 1) / kKeys;
  const int32_t* btab = a.btab + (size_t)b * a.n_pages;

  // the pool row of key t (-1 past the band)
  auto key_row = [&](int t, int page) {
    return t < t_hi ? (page * a.Hkv + g) * a.ps + t % a.ps : -1;
  };
  auto page_of = [&](int t) { return t < t_hi ? btab[t / a.ps] : 0; };

  // the block's queries, once: rows past the end zero-filled
  stage(a.gq, q_s, a.kchunks, a.Rk, a.q,
        [&](int row) -> const __nv_bfloat16* {
          const int r = r0 + row;
          if (r >= nrows) return nullptr;
          return a.q + (((size_t)b * a.H + g * m + r % m) * a.S + r / m) *
                           a.Rk;
        });
  // the first kStages tiles' pool rows
  if (tid < kKeys) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      const int t = j * kKeys + tid;
      rtab[j * kKeys + tid] = key_row(t, page_of(t));
    }
  }
  __syncthreads();
  auto load = [&](int j) {
    unsigned char* k_s = ring + (j % kStages) * stage_bytes;
    const int* rt = rtab + (j % kStages) * kKeys;
    stage(a.gk, k_s, a.kchunks, a.Rk, a.k,
          [&](int key) -> const __nv_bfloat16* {
            const int row = rt[key];
            return row < 0 ? nullptr : a.k + (size_t)row * a.Rk;
          });
    stage(a.gv, k_s + kbytes, N / 8, a.Rv, a.v,
          [&](int key) -> const __nv_bfloat16* {
            const int row = rt[key];
            return row < 0 ? nullptr : a.v + (size_t)row * a.Rv;
          });
  };
  // the ring: groups are Q + tile 0, tile 1, ..., tile kStages - 2, then
  // one a tile (empty groups past the last), so tile j is in once all but
  // kStages - 2 have landed
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_kt) load(j);
    cp_commit();
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};      // this lane's part of the row sums
  int lim[2];                       // rows 16 warp + g8 and + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + g8 + 8 * r;
    lim[r] = row < nrows ? lim_of(row) : 0;
  }
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2
  const int nkk = a.kchunks / 2;    // 16-deep q.k steps

  for (int j = 0; j < n_kt; ++j) {
    cp_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                // tile j in; tile j - 1 consumed
    if (j + kStages - 1 < n_kt) load(j + kStages - 1);
    cp_commit();
    // tile j + kStages's pool rows go into tile j's table slot (read by
    // load(j) kStages - 1 iterations ago); the block-table read is issued
    // here and stored after the products
    const int t_next = (j + kStages) * kKeys + tid;
    const int page_next = tid < kKeys ? page_of(t_next) : 0;

    // this warpgroup's keys: [kw, kw + 32) of tile j
    const int kw = j * kKeys + 32 * wg;
    const bool live = kw < t_hi;
    uint32_t pa[2][2][4];           // p's A fragments: [step][hi, lo][register]
    const unsigned char* k_s = ring + (j % kStages) * stage_bytes;
    const unsigned char* v_s = k_s + kbytes;
    if (live) {
      // s[4 n + e]: row 16 warp + g8 + 8 (e >> 1), key kw + 8 n + 2 t4 +
      // (e & 1)
      float s[16];
      wg_fence();
#pragma unroll 1
      for (int kk = 0; kk < nkk; ++kk)
        wgmma_qk(s, desc(q_s + 2 * kk * kRows * 16, kRows * 16, 128),
                 desc(k_s + 2 * kk * kKeys * 16 + 32 * wg * 16, kKeys * 16,
                      128), kk);
      wg_commit();
      wg_wait();
      fence_regs<16>(s);

      // mask (unless every row sees all 32 keys), scale
      float mx[2] = {-INFINITY, -INFINITY};
      if (kw + 32 <= t_all) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s[i] *= sl2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = (i >> 1) & 1;
          const int t = kw + 8 * (i >> 2) + 2 * t4 + (i & 1);
          s[i] = t < lim[r] ? s[i] * sl2 : -INFINITY;
          mx[r] = fmaxf(mx[r], s[i]);
        }
      }
      float base[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        base[r] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
        corr[r] = ex2(m_run[r] - base[r]);
        m_run[r] = m_new;
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      fence_regs<N / 2>(acc);
      // p as bf16 hi + lo in the A fragments of each 16-key step k
      // (register q: row g8 + 8 (q & 1), keys 16 k + 8 (q >> 1) + 2 t4 and
      // + 1, i.e. s[8 k + 2 q] and + 1), all made before the first product
      // is issued
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 8 * k + 2 * q, r = q & 1;
          const float p0v = ex2(s[i] - base[r]);
          const float p1v = ex2(s[i + 1] - base[r]);
          l_run[r] += p0v + p1v;
          // hi: p truncated to bf16 (its upper half); lo = p - hi is
          // exact in f32 and rounded to bf16, so hi + lo keeps 16 bits
          const uint32_t b0 = __float_as_uint(p0v) & 0xffff0000u;
          const uint32_t b1 = __float_as_uint(p1v) & 0xffff0000u;
          pa[k][0][q] = __byte_perm(b0, b1, 0x7632);
          pa[k][1][q] = pack_bf16(p0v - __uint_as_float(b0),
                                  p1v - __uint_as_float(b1));
        }
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        // V keys 32 wg + 16 k ..: two core matrices along keys, 128 bytes
        // apart; column chunks kKeys * 16 bytes apart
        const uint64_t vd = desc(v_s + (4 * wg + 2 * k) * 128, 128,
                                 kKeys * 16);
        wgmma_pv<N>(acc, pa[k][0], vd);
        wgmma_pv<N>(acc, pa[k][1], vd);
      }
      wg_commit();
    }
    if (tid < kKeys)
      rtab[(j % kStages) * kKeys + tid] = key_row(t_next, page_next);
    if (live) {
      wg_wait();
      fence_regs<N / 2>(acc);
      keep_regs<16>(&pa[0][0][0]);
    }
  }
  cp_wait<0>();
  __syncthreads();                  // every tile consumed: reuse the ring

  // merge the two key halves: warpgroup 1 hands its (max, sum, acc) to
  // the thread of warpgroup 0 that holds the same rows and columns
  float* xs = reinterpret_cast<float*>(ring);
  const int tl = tid % 128;
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xs[r * 128 + tl] = m_run[r];
      xs[(2 + r) * 128 + tl] = l_run[r];
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) xs[(4 + i) * 128 + tl] = acc[i];
  }
  __syncthreads();
  if (wg == 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xs[r * 128 + tl];
    const float mx = fmaxf(m_run[r], m1);
    const float base = mx == -INFINITY ? 0.f : mx;
    c0[r] = ex2(m_run[r] - base);
    c1[r] = ex2(m1 - base);
    l_run[r] = l_run[r] * c0[r] + xs[(2 + r) * 128 + tl] * c1[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    acc[i] = acc[i] * c0[r] + xs[(4 + i) * 128 + tl] * c1[r];
  }

  // out = acc / max(l, 1e-30): rows 16 warp + g8 and + 8, columns
  // 8 n + 2 t4 and + 1 below Rv
  const bool pairs = (a.Rv & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
    const int row = r0 + 16 * warp + g8 + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* orow =
        a.out + (((size_t)b * a.H + g * m + row % m) * a.S + row / m) * a.Rv;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      const float x0 = acc[4 * n + 2 * r] * inv;
      const float x1 = acc[4 * n + 2 * r + 1] * inv;
      if (pairs) {
        if (col < a.Rv)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x0, x1);
      } else {
        if (col < a.Rv) orow[col] = __float2bfloat16(x0);
        if (col + 1 < a.Rv) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int N>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<N>(a.kchunks);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);                  // the opt-in is per device: set it here
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.B * a.Hkv * a.n_tiles;
  if (blocks <= 0) return 0;
  prefill_kernel<N><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The widest granule, 16, 8, 4 or 2 bytes, that divides a row of R bf16
// values and the base address p.
inline int granule(const void* p, int R) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(p) | (uintptr_t)(2 * R);
  return x % 16 == 0 ? 16 : x % 8 == 0 ? 8 : x % 4 == 0 ? 4 : 2;
}

// bf16 K2: checks what the body takes (groups m <= 16, ranks 1..256) and
// launches the instantiation of the smallest p.v width >= Rv.
inline int prefill_bf16(const void* qc, const void* kc, const void* vc,
                        const void* lengths, const void* pos0,
                        const void* btab, void* out, int B, int H, int Hkv,
                        int S, int ps, int n_pages, int Rk, int Rv,
                        float scale, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 || S < 1 ||
      ps < 1 || n_pages < 1 || Rk < 1 || Rk > kMaxR || Rv < 1 || Rv > kMaxR)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(qc),
         static_cast<const __nv_bfloat16*>(kc),
         static_cast<const __nv_bfloat16*>(vc),
         static_cast<const int32_t*>(lengths),
         static_cast<const int32_t*>(pos0),
         static_cast<const int32_t*>(btab),
         static_cast<__nv_bfloat16*>(out),
         B, H, Hkv, H / Hkv, S, ps, n_pages, Rk, Rv,
         (Rk + 15) / 16 * 2,
         granule(qc, Rk), granule(kc, Rk), granule(vc, Rv),
         scale, 0};
  a.n_tiles = (a.m * S + kRows - 1) / kRows;
  const auto st = static_cast<cudaStream_t>(stream);
#define KQ_PREFILL_CASE(n) \
  if (Rv <= n) return launch<n>(a, st);
  KQ_PREFILL_PV_WIDTHS(KQ_PREFILL_CASE)
#undef KQ_PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace kq_prefill
