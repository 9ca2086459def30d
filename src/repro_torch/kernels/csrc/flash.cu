// K6: causal GQA flash attention with an optional sliding window, for Hopper.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash/flash.py:29, entry point `flash_attention` at
// :79).  q (B, H, S, DH), k (B, Hkv, S, DH), v (B, Hkv, S, DV) -> out
// (B, H, S, DV) in q's type: query head h reads kv head h / m
// (m = H / Hkv); query s sees key t when t <= s (causal) and s - t <
// window (window > 0); the softmax statistics are f32, masked scores never
// enter the max or the sum, and a row ends as acc / max(l, 1e-30).  It
// runs under every exact-length prefill and every calibration batch of the
// port.  The (DH, DV) pairs it is built for are FLASH_PAIRS below; the
// wrapper's table (repro_torch/kernels/flash/flash.py) is checked against
// it by tests/test_torch_flash.py.
//
// What bounds it: operations, beyond a few hundred tokens.  Over the band
// the kernel does 2 (DH + DV) flops per (query, key) pair per head on q,
// k, v and out read or written once; the flops grow with the band (S times
// the window), the bytes with S.  At tinyllama's calibration batch (S 512,
// D 64, bf16) bytes and flops take about as long at 3.35 TB/s and 989
// TFLOP/s; at h2o-danube's 6000-token windowed prefill (D 80) the flops
// take 7 times as long.  The bf16 design, against that bound:
//   * tensor cores at Hopper's rate: both products are `wgmma` (sm_90a).
//     S = Q.K^T (m64n64k16) reads Q and K from shared memory, K-major as
//     stored; O += P.V reads P from registers and V from shared memory in
//     its stored row-major layout through wgmma's transpose of B, so no
//     thread transposes V.  p goes in as bf16 hi + lo (hi p truncated,
//     lo = p - hi rounded), two products, so the value sum keeps 16 bits
//     of p: kernel and plain version (f32 softmax, f32 p.v) then differ
//     by little more than summation order, within two bf16 ulps of the
//     output.  The online
//     softmax runs in wgmma's accumulator layout (lane (g8, t4) of warp w
//     holds rows 16 w + g8 and + 8, keys 8 n + 2 t4 and + 1), its
//     exponentials are single `ex2` ops, and a tile's p fragments are all
//     made before its p.v products are issued and kept alive past their
//     wait (ptxas guards only the accumulators of an asynchronous wgmma);
//   * large row tiles: a block of two consumer warpgroups holds 128
//     flattened (position, head) rows of one (b, kv group) -- row r is
//     position r / m of head g m + r % m, so each staged K/V tile serves
//     all m heads of the group and 128 / m positions;
//   * loads in flight behind the products: K and V tiles of 64 keys go
//     through a ring of kStages in dynamic shared memory, filled two tiles
//     ahead with 16-byte `cp.async` (zero-filled past the band) under
//     commit/wait groups, one block barrier per tile; Q is staged once
//     per block the same way.  Shared tiles use wgmma's unswizzled
//     core-matrix layout (8 rows x 16 bytes contiguous), which fits every
//     width that is a multiple of 8; a warp's copies land on 8 rows of
//     one 16-byte column, so the stores are free of bank conflicts, and
//     read 64 contiguous bytes of each of 8 rows from memory.  A DH that
//     is no multiple of 16 (8, 24) is staged zero-padded to one;
//   * the band alone: the block walks the key tiles from its first
//     position's window start to its last position (the causal
//     diagonal); tiles outside the band are never read, a warpgroup skips
//     the products of a tile none of its rows sees, tiles wholly inside
//     the band skip the per-element mask, and the heaviest row tiles are
//     scheduled first;
//   * fixed costs hidden: a short prompt gives a block few tiles, so its
//     prologue (Q and the first tiles from memory) and epilogue weigh.
//     Up to DV 64 two blocks share an SM (128 registers a thread), so one
//     block's prologue overlaps the other's products; the output leaves
//     through shared memory in 16-byte stores, a row contiguous.
// float32 (the reduced parity runs) stays on the CUDA cores in true f32
// (no TF32): blocks of 4 warps and 64 rows, staged synchronously, each lane
// dots its rows against its keys from shared memory and the p.v product
// hands each key's p to the quad by shuffle.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The (DH, DV) pairs K6 is built for, in bf16 and f32: the reference
// kernel's sweep (8, 16, 32; 16 is also the reduced configs'), tinyllama
// 64, h2o-danube 80, phi-3-vision 96, llama2-7b 128, and MLA's pairs,
// reduced (24, 16) and deepseek-v2-lite's (192, 128).
#define FLASH_PAIRS(X)                                                  \
  X(8, 8) X(16, 16) X(32, 32) X(64, 64) X(80, 80) X(96, 96) X(128, 128) \
  X(24, 16) X(192, 128)

namespace flash {

constexpr int kKeys = 64;           // keys per staged tile
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;                        // (B, H, S, DV), contiguous
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

// The block's key range and one warp(group)'s: rows [r0, r0 + n) of the
// flattened (position, head) rows see keys [kbeg, kend] at most.
struct Band {
  int qlo, qhi, kbeg, kend;
  __device__ Band(const Args& a, int r0, int n) {
    qlo = r0 / a.m;
    qhi = min(a.S - 1, (r0 + n - 1) / a.m);
    kend = a.causal ? qhi : a.S - 1;
    kbeg = a.window > 0 ? max(0, qlo - a.window + 1) : 0;
  }
};

// ---------------------------------------------------------------- bf16 --

namespace hopper {

constexpr int kRows = 128;          // flattened rows a block: 2 warpgroups
constexpr int kThreads = 256;
constexpr int kStages = 3;          // K/V ring depth: two tiles in flight

template <int DH, int DV>
struct Shape {
  static constexpr int DHP = (DH + 15) / 16 * 16;   // q.k depth, padded
  static constexpr int QC = DH / 8;                 // 16-byte chunks a row
  static constexpr int VC = DV / 8;
  static constexpr int kQBytes = kRows * DHP * 2;
  static constexpr int kKBytes = kKeys * DHP * 2;
  static constexpr int kStageBytes = kKBytes + kKeys * DV * 2;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes;
  // two blocks an SM (at most 128 registers a thread), so that one
  // block's prologue and epilogue overlap the other's products
  static constexpr bool kPair = DV <= 64;
};

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

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
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

// S (64 x 64 keys, f32) = Q (64 x 16) . K (64 x 16)^T, both K-major in
// shared memory; scale_d 0 overwrites S, 1 accumulates.
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t qd, uint64_t kd,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(qd), "l"(kd), "r"(scale_d));
}

// O (64 x N, f32) += P (64 x 16 keys, bf16 in registers) . V (16 keys x N),
// V N-major in shared memory (trans-b 1).
template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t vd);
template <>
__device__ __forceinline__ void wgmma_pv<8>(float* d, const uint32_t* a,
                                             uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd),
        "r"(1));
}

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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<32>(float* d, const uint32_t* a,
                                             uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float* d, const uint32_t* a,
                                             uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<80>(float* d, const uint32_t* a,
                                             uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<96>(float* d, const uint32_t* a,
                                             uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float* d, const uint32_t* a,
                                             uint64_t vd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vd),
        "r"(1));
}

// Copies `rows` rows of `chunks` 16-byte chunks into the core-matrix
// layout [chunk][row][16 bytes] (a chunk's rows 16 bytes apart).  Item i:
// row 8 (i / 8 / chunks) + i % 8, chunk (i / 8) % chunks, so the 8 lanes
// of a store phase write 128 contiguous bytes.  `src(row, chunk)` gives
// the source, or nullptr for a row to zero-fill.
// ROLLED keeps the loop rolled, which the two-blocks-an-SM instantiations
// need to stay within 128 registers.
template <int ROWS, int CHUNKS, bool ROLLED, typename Src>
__device__ __forceinline__ void stage(unsigned char* dst, const void* any,
                                      Src src) {
  auto copy = [&](int i) {
    const int rest = i / 8;
    const int c = rest % CHUNKS;
    const int row = (rest / CHUNKS) * 8 + i % 8;
    const void* p = src(row, c);
    cp16(dst + (c * ROWS + row) * 16, p ? p : any, p != nullptr);
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) copy(i);
  } else {
    for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) copy(i);
  }
}

template <int DH, int DV>
__global__ void __launch_bounds__(kThreads, Shape<DH, DV>::kPair ? 2 : 1)
    flash_bf16_kernel(Args a) {
  using Sh = Shape<DH, DV>;
  constexpr int DHP = Sh::DHP;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  const int tid = threadIdx.x;
  const int wg = tid / 128;         // rows 64 wg .. 64 wg + 63 of the block
  const int warp = (tid % 128) / 32;
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
  const int S = a.S;
  const int W = a.window;
  const int nrows = S * m;
  const int r0 = tile * kRows;
  const Band blk(a, r0, kRows);
  const int wr0 = r0 + 64 * wg;     // this warpgroup's rows
  const bool wg_live = wr0 < nrows;
  const bool wg_full = wr0 + 63 < nrows;
  const Band wb(a, wr0, 64);

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs_b;
  // the group's K and V rows; with two blocks an SM they are made
  // afresh for each tile rather than kept live
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks_b + g * a.ks_h;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs_b + g * a.vs_h;

  // a DH of 8 or 24: the pad chunk of q's and every stage's k rows is
  // zero once; the copies never touch it
  if constexpr (DHP != DH) {
    for (int i = tid; i < kRows; i += kThreads)
      *reinterpret_cast<uint4*>(q_s + ((DHP / 8 - 1) * kRows + i) * 16) =
          make_uint4(0, 0, 0, 0);
    for (int i = tid; i < kStages * kKeys; i += kThreads) {
      unsigned char* k_s = smem + Sh::kQBytes +
                           (i / kKeys) * Sh::kStageBytes;
      *reinterpret_cast<uint4*>(
          k_s + ((DHP / 8 - 1) * kKeys + i % kKeys) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }

  // Q, once: rows past the end zero-filled
  stage<kRows, Sh::QC, Sh::kPair>(
      q_s, qbase, [&](int row, int c) -> const void* {
        const int r = r0 + row;
        if (r >= nrows) return nullptr;
        return qbase + (g * m + r % m) * a.qs_h +
               (long long)(r / m) * a.qs_s + 8 * c;
      });

  const int n_kt = blk.kend >= blk.kbeg
                       ? (blk.kend - blk.kbeg + kKeys) / kKeys : 0;
  auto load = [&](int j) {
    const int kt = blk.kbeg + j * kKeys;
    const int nk = min(kKeys, blk.kend + 1 - kt);
    const __nv_bfloat16* kb = kbase;
    const __nv_bfloat16* vb = vbase;
    if constexpr (Sh::kPair) {
      kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks_b + g * a.ks_h;
      vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs_b + g * a.vs_h;
    }
    kb += (long long)kt * a.ks_s;
    vb += (long long)kt * a.vs_s;
    unsigned char* k_s = smem + Sh::kQBytes + (j % kStages) *
                                                  Sh::kStageBytes;
    stage<kKeys, Sh::QC, Sh::kPair>(
        k_s, kb, [&](int key, int c) -> const void* {
          return key < nk ? kb + key * a.ks_s + 8 * c : nullptr;
        });
    stage<kKeys, Sh::VC, Sh::kPair>(
        k_s + Sh::kKBytes, vb, [&](int key, int c) -> const void* {
          return key < nk ? vb + key * a.vs_s + 8 * c : nullptr;
        });
  };
  // the ring: groups are Q + tile 0, tile 1, then one a tile (empty
  // groups past the last), so tile j is in once all but one have landed
  if (n_kt > 0) load(0);
  cp_commit();
  if (n_kt > 1) load(1);
  cp_commit();

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};      // this lane's part of the row sums
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2

  for (int j = 0; j < n_kt; ++j) {
    cp_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                // tile j in; tile j - 1 consumed
    if (j + 2 < n_kt) load(j + 2);
    cp_commit();

    const int kt = blk.kbeg + j * kKeys;
    if (!wg_live || kt > wb.kend || kt + kKeys - 1 < wb.kbeg) continue;
    const int nk = min(kKeys, blk.kend + 1 - kt);
    const unsigned char* k_s = smem + Sh::kQBytes +
                               (j % kStages) * Sh::kStageBytes;
    const unsigned char* v_s = k_s + Sh::kKBytes;

    // s[4 n + e]: row 16 warp + g8 + 8 (e >> 1), key kt + 8 n + 2 t4 +
    // (e & 1)
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)
      wgmma_qk(s, desc(q_s + 64 * wg * 16 + 2 * kk * kRows * 16,
                       kRows * 16, 128),
               desc(k_s + 2 * kk * kKeys * 16, kKeys * 16, 128), kk);
    wg_commit();
    wg_wait();
    fence_regs<32>(s);

    // mask (unless the tile lies inside the band for every row), scale
    float mx[2] = {-INFINITY, -INFINITY};
    const bool inside = wg_full && nk == kKeys &&
                        (!a.causal || kt + kKeys - 1 <= wb.qlo) &&
                        (W <= 0 || wb.qhi - kt < W);
    if (inside) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] *= sl2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      // this lane's two rows: 16 warp + g8 and + 8 of the warpgroup
      bool live[2];
      int qpos[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wr0 + 16 * warp + g8 + 8 * r;
        live[r] = row < nrows;
        qpos[r] = row / m;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int t = kt + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const bool seen = live[r] && t < kt + nk &&
                          (!a.causal || t <= qpos[r]) &&
                          (W <= 0 || qpos[r] - t < W);
        s[i] = seen ? s[i] * sl2 : -INFINITY;
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
    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    fence_regs<DV / 2>(acc);
    // p as bf16 hi + lo in the A fragments of each 16-key step k (register
    // q: row g8 + 8 (q & 1), keys 16 k + 8 (q >> 1) + 2 t4 and + 1, i.e.
    // s[8 k + 2 q] and + 1), all made before the first product is issued
    uint32_t pa[kKeys / 16][2][4];  // [step][hi, lo][register]
#pragma unroll
    for (int k = 0; k < kKeys / 16; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * k + 2 * q, r = q & 1;
        const float p0 = ex2(s[i] - base[r]);
        const float p1 = ex2(s[i + 1] - base[r]);
        l_run[r] += p0 + p1;
        // hi: p truncated to bf16 (its upper half); lo = p - hi is exact
        // in f32 and rounded to bf16, so hi + lo keeps 16 bits of p
        const uint32_t b0 = __float_as_uint(p0) & 0xffff0000u;
        const uint32_t b1 = __float_as_uint(p1) & 0xffff0000u;
        pa[k][0][q] = __byte_perm(b0, b1, 0x7632);
        pa[k][1][q] =
            pack_bf16(p0 - __uint_as_float(b0), p1 - __uint_as_float(b1));
      }
    }
    wg_fence();
#pragma unroll
    for (int k = 0; k < kKeys / 16; ++k) {
      // V rows 16 k .. 16 k + 15: two core matrices along keys, 128 bytes
      // apart; column chunks kKeys * 16 bytes apart
      const uint64_t vd = desc(v_s + 2 * k * 128, 128, kKeys * 16);
      wgmma_pv<DV>(acc, pa[k][0], vd);
      wgmma_pv<DV>(acc, pa[k][1], vd);
    }
    wg_commit();
    wg_wait();
    fence_regs<DV / 2>(acc);
    keep_regs<kKeys / 16 * 8>(&pa[0][0][0]);
  }
  cp_wait<0>();
  __syncthreads();                  // every tile consumed: reuse the ring

  // out = acc / max(l, 1e-30), through shared memory (rows of DV + 8
  // bf16, so the quad stores land on distinct banks) and out to memory in
  // 16-byte stores, each row's DV values contiguous there
  constexpr int OS = DV + 8;
  static_assert(kRows * OS * 2 <= kStages * Sh::kStageBytes,
                "the output tile fits in the ring");
  __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(smem + Sh::kQBytes);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
    const int row = 64 * wg + 16 * warp + g8 + 8 * r;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<uint32_t*>(o_s + row * OS + 8 * n + 2 * t4) =
          pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
  }
  __syncthreads();
  for (int i = tid; i < kRows * (DV / 8); i += kThreads) {
    const int row = i / (DV / 8), c = i % (DV / 8);
    const int r = r0 + row;
    if (r >= nrows) continue;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.out) +
                          (((long long)b * a.H + g * m + r % m) * S + r / m) *
                              DV;
    *reinterpret_cast<uint4*>(orow + 8 * c) =
        *reinterpret_cast<const uint4*>(o_s + row * OS + 8 * c);
  }
}

template <int DH, int DV>
int launch(Args a, cudaStream_t stream) {
  constexpr int bytes = Shape<DH, DV>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DH, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);                       // the opt-in is per device: set it here
  if (err != cudaSuccess) return static_cast<int>(err);
  a.n_tiles = (a.S * a.m + kRows - 1) / kRows;
  const long long blocks = (long long)a.B * a.Hkv * a.n_tiles;
  if (blocks <= 0) return 0;
  flash_bf16_kernel<DH, DV><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

// ----------------------------------------------------------------- f32 --

namespace cores {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // flattened (position, head) rows a block

// shared memory: q_s [kRows][DH + 1], k_s [kKeys][DH + 1], v_s [kKeys][DV]
template <int DH, int DV>
constexpr int smem_bytes() {
  return 4 * (kRows * (DH + 1) + kKeys * (DH + 1) + kKeys * DV);
}

// four blocks an SM up to DV 64, three above (at most 128 and 168
// registers a thread; a minimum of one lets ptxas take 238 at DV 80)
template <int DH, int DV>
__global__ void __launch_bounds__(32 * kWarps, DV <= 64 ? 4 : 3)
    flash_f32_kernel(Args a) {
  constexpr int NT = kKeys / 8;     // 8-key slices of a tile
  constexpr int DT = DV / 8;        // 8-column slices of the output
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g8 = lane >> 2;         // the lane's rows g8, g8 + 8
  const int t4 = lane & 3;          // and keys 2 t4, 2 t4 + 1 of a slice

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
  const Band blk(a, r0, kRows);
  // this warp's key range (empty when its rows are all past the end)
  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < nrows;
  const Band wb(a, wr0, 16);

  int qpos[2], head[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr0 + g8 + 8 * i;
    live[i] = r < nrows;
    qpos[i] = live[i] ? r / m : 0;
    head[i] = g * m + (live[i] ? r % m : 0);
  }

  const float* kbase = static_cast<const float*>(a.k) + b * a.ks_b +
                       g * a.ks_h;
  const float* vbase = static_cast<const float*>(a.v) + b * a.vs_b +
                       g * a.vs_h;
  const float* qbase = static_cast<const float*>(a.q) + b * a.qs_b;

  // the block's rows staged once
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kRows * (DH + 1);
  float* v_s = k_s + kKeys * (DH + 1);
  for (int idx = threadIdx.x; idx < kRows * DH; idx += blockDim.x) {
    const int rl = idx / DH, d = idx % DH;
    const int r = r0 + rl;
    float x = 0.f;
    if (r < nrows)
      x = qbase[(g * m + r % m) * a.qs_h + (long long)(r / m) * a.qs_s + d];
    q_s[rl * (DH + 1) + d] = x;
  }

  float acc[DT][4];
#pragma unroll
  for (int nn = 0; nn < DT; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};       // this lane's part of the row sums

  for (int kt = blk.kbeg; kt <= blk.kend; kt += kKeys) {
    const int nk = min(kKeys, blk.kend + 1 - kt);  // keys of this tile
    __syncthreads();                 // the previous tile is consumed
    // one pass over both, so each thread has a k and a v load in flight
    constexpr int DM = DH > DV ? DH : DV;
    for (int idx = threadIdx.x; idx < kKeys * DM; idx += blockDim.x) {
      const int key = idx / DM, d = idx % DM;
      float kx = 0.f, vx = 0.f;
      if (key < nk) {
        const long long t = kt + key;
        if (d < DH) kx = kbase[t * a.ks_s + d];
        if (d < DV) vx = vbase[t * a.vs_s + d];
      }
      if (d < DH) k_s[key * (DH + 1) + d] = kx;
      if (d < DV) v_s[key * DV + d] = vx;
    }
    __syncthreads();
    if (!warp_live || kt > wb.kend || kt + kKeys - 1 < wb.kbeg) continue;

    // scores of the tile: s[n][e] is row g8 + 8 (e >> 1), key
    // kt + 8 n + 2 t4 + (e & 1)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const float* qa = q_s + (warp * 16 + g8) * (DH + 1);
    const float* qb = qa + 8 * (DH + 1);
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float xa = qa[d], xb = qb[d];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float ka = k_s[(n * 8 + 2 * t4) * (DH + 1) + d];
        const float kb = k_s[(n * 8 + 2 * t4 + 1) * (DH + 1) + d];
        s[n][0] = fmaf(xa, ka, s[n][0]);
        s[n][1] = fmaf(xa, kb, s[n][1]);
        s[n][2] = fmaf(xb, ka, s[n][2]);
        s[n][3] = fmaf(xb, kb, s[n][3]);
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
        const bool seen = live[i] && t < kt + nk &&
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

    // acc += p v: each key's p handed to the quad by shuffle
    const int quad = lane & ~3;
#pragma unroll
    for (int key = 0; key < kKeys; ++key) {
      const int n = key >> 3, w = key & 7;
      const int src = quad | (w >> 1);
      const float pa = __shfl_sync(0xffffffffu, s[n][w & 1], src);
      const float pb = __shfl_sync(0xffffffffu, s[n][2 + (w & 1)], src);
      const float* vrow = v_s + key * DV + 2 * t4;
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

  // out = acc / max(l, 1e-30), rows g8 and g8 + 8, columns 8 nn + 2 t4 + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(quad_sum(l_run[i]), 1e-30f);
    if (!warp_live || !live[i]) continue;
    float* orow = static_cast<float*>(a.out) +
                  (((long long)b * a.H + head[i]) * S + qpos[i]) * DV +
                  2 * t4;
#pragma unroll
    for (int nn = 0; nn < DT; ++nn)
      *reinterpret_cast<float2*>(orow + nn * 8) =
          make_float2(acc[nn][2 * i] * inv, acc[nn][2 * i + 1] * inv);
  }
}

template <int DH, int DV>
int launch(Args a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH, DV>();
  if (bytes > 48 * 1024) {          // the opt-in is per device: set it here
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<DH, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.n_tiles = (a.S * a.m + kRows - 1) / kRows;
  const long long blocks = (long long)a.B * a.Hkv * a.n_tiles;
  if (blocks <= 0) return 0;
  flash_f32_kernel<DH, DV><<<(unsigned)blocks, 32 * kWarps, bytes,
                             stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cores

}  // namespace flash

// Plain C entry point (loaded with ctypes).  dtype: 0 = float32,
// 1 = bfloat16, the same for q, k, v and out.  q (B, H, S, DH), k
// (B, Hkv, S, DH) and v (B, Hkv, S, DV) with the given element strides
// (the last dim contiguous; for bfloat16, bases 16-byte aligned and
// strides multiples of 8); out (B, H, S, DV) contiguous.  (DH, DV) one of
// FLASH_PAIRS.  window 0: no window; causal 0: every key up to the
// window.  Returns the launch's cudaError_t (0 on success).
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out, long long qs_b, long long qs_h,
                            long long qs_s, long long ks_b, long long ks_h,
                            long long ks_s, long long vs_b, long long vs_h,
                            long long vs_s, int B, int H, int Hkv, int S,
                            int DH, int DV, int window, int causal,
                            float scale, int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || S < 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const flash::Args a{q,    k,    v,    out,  qs_b, qs_h,  qs_s,   ks_b,
                      ks_h, ks_s, vs_b, vs_h, vs_s, B,     H,      Hkv,
                      H / Hkv, S, window, causal, scale, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(dh, dv)                                  \
  if (DH == dh && DV == dv)                                 \
    return dtype == 0 ? flash::cores::launch<dh, dv>(a, st) \
                      : flash::hopper::launch<dh, dv>(a, st);
  FLASH_PAIRS(FLASH_CASE)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
