// K7 in bf16: the Mamba-2 SSD chunk scan split over chunks, on Hopper's
// tensor cores.  (float32 K7 stays on ssd.cu's first body, in true f32.)
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd/ssd.py:26, entry point `ssd_chunk_scan` at :64)
// for bf16 x, B and C; a and dt f32, the state f32, y f32 or bf16.  It
// computes what `ssd_chunk_scan_plain` (kernels/ssd/ref.py) computes: per
// chunk of L tokens, with cum the chunk's running sum of a,
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i h_in,
//   h  <- h_in exp(cum_last) + sum_j B_j^T exp(cum_last - cum_j) dt_j x_j.
//
// What bounds it: bytes, by a little.  At mamba2-2.7b's prefill of 4096
// tokens (80 heads, hd 64, n 128, chunk 256) the work is some 27 GFLOP,
// 27 us at the tensor cores' bf16 rate, against some 133 MB of x, B, C,
// a, dt, y and the final state, 40 us at the memory rate; the bf16 parts
// below bring the tensor-core work to some 65 GFLOP, and the scratch adds
// some 170 MB of traffic.  The first body (ssd.cu) walks a head's chunks
// in order in one block, so 80 blocks run on 132 SMs, and does every
// product in f32 on the CUDA cores.  This one:
//
//   * splits the scan over chunks, in three kernels on one stream (one
//     call of the wrapper launches all three):
//     1. ssd_state_kernel, one block per (b, head, chunk), 1280 at S 4096
//        where the first body has 80: the chunk's cum (the first body's
//        f64 block scan, rounded to f32), written to scratch so the later
//        kernels read the same values, and the chunk-local state
//        S_c = (B o wj)^T x, wj = exp(cum_last - cum_j) dt_j, on `wgmma`
//        (M d_state in 64-row warpgroup tiles, N head_dim, K the chunk's
//        keys), its 64-key tiles through a two-stage `cp.async` ring, so
//        a block holds some 48 KB and two share an SM;
//     2. ssd_pass_kernel, one thread per four state elements: walks the
//        chunks in order, h_in[c] = h, h = h exp(cum_last_c) + S_c,
//        writing h_in[c] over S_c and the final state to h_out (from h0,
//        or zeros).  Elementwise, on f32 scratch of n hd per chunk (42 MB
//        at S 4096);
//     3. ssd_scan_kernel, one block of four warpgroups per (b, head,
//        chunk), warpgroup i on the 64-row query tile i: the whole chunk's
//        C, B and x (tokens by features), cum and dt are staged once, in
//        two `cp.async` groups (all of C and tokens 0 .. 127 of B and x,
//        then the rest, waited for only by the two warpgroups that read
//        it), while h_in is split into bf16 parts beside them.  A tile
//        first takes the carried term, exp(cum_i) (C_i . h_in), into its
//        accumulator; then for each 64-key tile j <= i: s = C_i . B_j^T
//        on `wgmma` (both operands K-major in shared memory, depth d_state
//        zero-padded to 16), W = s exp(cum_i - cum_j) dt_j, and y += W x_j
//        on `wgmma` with W from registers.  On the diagonal tile the decay
//        is masked BEFORE exp (above the diagonal the exponent is positive
//        and overflows); below it, with cum non-increasing (a = dt A with
//        A < 0; checked a block), it factors through the key tile's last
//        token into two exps of at most 1, one a row and one a key, the
//        key's staged once a block: 2 exps a thread a tile, not 32.
//        One block a chunk stages C and h_in once, not once a query tile,
//        and four warpgroups give an SM enough warps to hide the exps'
//        and the products' latency;
//   * precision.  x, B and C are bf16, so their products are exact.  The
//     f32 operands W, B o wj and h_in go in as three bf16 parts each
//     (hi + mid + lo, each the remainder so far rounded; three products),
//     which keeps some 24 bits: a float32 y is held to 1e-4 + 1e-4 |ref|.
//     Two parts hold that bar at mamba2's law (dt up to 0.1) only for W
//     and B o wj, and miss it at the reference sweep's (dt up to some 3,
//     so W reaches tens); h_in needs three at either.  The tests emulate
//     this arithmetic on the CPU (tests/test_torch_ssd.py);
//   * register A operands.  A fragment must not change until the wgmma
//     that reads it has completed, and ptxas guards only the accumulators:
//     a loop that rebuilt its fragments while the last step's products
//     ran gave NaN once unrolled differently.  Every register-A batch
//     builds all its fragments and descriptors, issues, waits, and keeps
//     the fragments alive past the wait (keep_regs);
//   * staging.  Every tile is tokens by features, copied into `wgmma`'s
//     unswizzled core-matrix layout [feature / 8][token][16 B] in the
//     widest granule (16, 8, 4 bytes by `cp.async`, 2 by registers) that
//     the view's base and strides allow, so the model's strided views of
//     the conv output need no copy.  Neighbouring threads copy the two
//     16-byte halves of a 32-byte row segment, so a warp reads whole
//     sectors.  Tokens past the chunk's end are zero-filled.
// Known limits: C.B^T is computed per head, where the heads of a group
// could share it (a development variant on an H100 put all of C.B^T at
// some 0.02 ms at S 4096); y is stored from the accumulators, not through shared memory;
// one scan block fills an SM's shared memory at mamba2's shape, so a
// block's first copies are not hidden behind another block's products;
// the scan's query tiles are uneven (warpgroup 3 takes four key tiles,
// warpgroup 0 one); at head width 128 (jamba's head) the scan runs out of
// registers and ptxas serializes its wgmmas.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py), as part
//             of ssd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd_tc {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;            // query rows and keys of a tile
constexpr int kMaxChunk = 256;       // longest chunk
constexpr int kStateThreads = 256;   // one per chunk position
constexpr int kScanThreads = 512;    // four warpgroups
constexpr int kPassThreads = 256;
static_assert(kStateThreads == kMaxChunk, "one thread per chunk position");

struct Args {
  const bf16* x;
  const float* a;
  const float* dt;
  const bf16* B;
  const bf16* C;
  const float* h0;                   // (Bsz, nh, n, hd) f32 or null
  void* y;                           // f32 or bf16
  float* h_out;                      // (Bsz, nh, n, hd) f32
  float* cum;                        // scratch (Bsz, nh, S) f32
  float* st;                         // scratch (Bsz, nh, nc, n, hd) f32
  long long xs_b, xs_h, xs_s;        // element strides; the last dim is 1
  long long as_b, as_h, as_s;
  long long ds_b, ds_h, ds_s;
  long long bs_b, bs_g, bs_s;
  long long cs_b, cs_g, cs_s;
  long long ys_b, ys_h, ys_s;
  int Bsz, nh, G, S, chunk;
  int nc;                            // chunks: ceil(S / chunk)
  int y_f32;
  int gx, gb, gc;                    // copy granules of x, B, C in bytes
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (v0, v1) as bf16 hi + lo pairs: hi rounded, lo = v - hi (exact in f32)
// rounded
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - __uint_as_float(hi << 16),
                 v1 - __uint_as_float(hi & 0xffff0000u));
}
// (v0, v1) in three bf16 parts, each the remainder so far rounded: some
// 24 bits of each value
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  split2(v0 - __uint_as_float(hi << 16),
         v1 - __uint_as_float(hi & 0xffff0000u), mid, lo);
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
// shared-memory writes (by threads or cp.async) made visible to wgmma
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// threadIdx.x / 128, known to the compiler to be warp-uniform, so that
// branches on it do not make ptxas serialize the wgmmas inside them
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
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

// S (64 rows x 64 keys, f32) = C (64 x 16) . B (64 x 16)^T, both K-major
// in shared memory; scale_d 0 overwrites S, 1 accumulates.
__device__ __forceinline__ void wgmma_cb(float* d, uint64_t ad, uint64_t bd,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(ad), "l"(bd), "r"(scale_d));
}

// D (64 x N, f32) = A (64 x 16, bf16 in registers) . B (16 x N) + D if
// scale_d, B N-major in shared memory (trans-b 1).  N is the head dim.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t bd, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a,
                                         uint64_t bd, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                          uint64_t bd, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                          uint64_t bd, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                           uint64_t bd, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(scale_d));
}

// Copies the 64 tokens of a tile of R bf16 features a token (R a multiple
// of 8) into the core-matrix layout [R / 8][rows][16 B]: token t from
// src + t * stride, zero-filled from token `valid` on, in granules of G
// bytes (G divides the view's base and strides), by NT threads of which
// this one is number `first`.  Neighbouring threads take the granules of
// one token's 32-byte segment (two 16-byte chunks), then the next
// token's, so a warp reads whole sectors.  (The token count is a constant
// so that no index takes a run-time division.)
template <int G, int R, int NT>
__device__ __forceinline__ void stage_g(unsigned char* dst, int rows,
                                        const bf16* src, long long stride,
                                        int valid, int first) {
  constexpr int kPer = 16 / G;               // granules a 16-byte chunk
  constexpr int kPair = R >= 16 ? 2 : 1;     // chunks a segment
  constexpr int kSeg = kPair * kPer;         // granules a segment
  constexpr int kTotal = kTile * (R / 8) * kPer;
#pragma unroll 4
  for (int e = first; e < kTotal; e += NT) {
    const int u = e % kSeg;
    const int rest = e / kSeg;
    const int t = rest % kTile;
    const int chunk = (rest / kTile) * kPair + u / kPer;
    const int off = (u % kPer) * G;          // bytes into the chunk
    unsigned char* d = dst + (chunk * rows + t) * 16 + off;
    const bool ok = t < valid;
    const bf16* s = ok ? src + t * stride + chunk * 8 + off / 2 : src;
    if constexpr (G == 2) {
      *reinterpret_cast<unsigned short*>(d) =
          ok ? __ldg(reinterpret_cast<const unsigned short*>(s))
             : static_cast<unsigned short>(0);
    } else {
      cp_async<G>(d, s, ok);
    }
  }
}

// Tokens [t0, t0 + 64) of a view (base src, token stride `stride`) into
// rows t0 .. of a [R / 8][rows][16 B] tile, zero-filled from token L on,
// by NT threads of which this one is number `first`.
template <int R, int NT>
__device__ __forceinline__ void stage(int g, unsigned char* dst, int rows,
                                      int t0, const bf16* src,
                                      long long stride, int L,
                                      int first = threadIdx.x) {
  dst += t0 * 16;
  src += t0 * stride;
  const int valid = L - t0;
  switch (g) {
    case 16: stage_g<16, R, NT>(dst, rows, src, stride, valid, first); break;
    case 8: stage_g<8, R, NT>(dst, rows, src, stride, valid, first); break;
    case 4: stage_g<4, R, NT>(dst, rows, src, stride, valid, first); break;
    default: stage_g<2, R, NT>(dst, rows, src, stride, valid, first); break;
  }
}

// -- 1. the chunk-local states ------------------------------------------------

// Shared memory: a ring of two 64-key stages, each B [N / 8][64][16 B] and
// x [HD / 8][64][16 B]; wj [256] f32, the scan's warp totals [8] f64 and
// cum_last.  Some 48 KB at mamba2's shape: a tile's copies run under the
// last tile's products, and blocks share an SM as registers allow.
template <int HD, int N>
struct StateSmem {
  static constexpr int kB = N * 2 * kTile;
  static constexpr int kStage = kB + HD * 2 * kTile;
  static constexpr int kBytes = 2 * kStage + 4 * kMaxChunk + 8 * 8 + 16;
};

template <int HD, int N>
__global__ void __launch_bounds__(kStateThreads, 2)
    ssd_state_kernel(Args p) {
  using Sm = StateSmem<HD, N>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* wj_s = reinterpret_cast<float*>(smem + 2 * Sm::kStage);
  double* tot_s = reinterpret_cast<double*>(wj_s + kMaxChunk);
  float* cl_s = reinterpret_cast<float*>(tot_s + 8);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;  // b * nh + head
  const int b = bh / p.nh;
  const int hh = bh % p.nh;
  const int g = hh / (p.nh / p.G);
  const int c0 = c * p.chunk;
  const int L = min(p.chunk, p.S - c0);
  const int n_kt = (L + kTile - 1) / kTile;

  // 64-key tile t of B and x, zero-filled from L on, into stage t % 2
  const bf16* Bg = p.B + b * p.bs_b + g * p.bs_g + (long long)c0 * p.bs_s;
  const bf16* xg = p.x + b * p.xs_b + hh * p.xs_h + (long long)c0 * p.xs_s;
  auto load = [&](int t) {
    unsigned char* st = smem + (t & 1) * Sm::kStage;
    stage<N, kStateThreads>(p.gb, st, kTile, 0, Bg + t * kTile * p.bs_s,
                            p.bs_s, L - t * kTile);
    stage<HD, kStateThreads>(p.gx, st + Sm::kB, kTile, 0,
                             xg + t * kTile * p.xs_s, p.xs_s, L - t * kTile);
  };
  load(0);
  cp_commit();

  // cum: inclusive prefix sum of a over the chunk in f64, rounded to f32,
  // as the first body and the plain version take it
  double v = 0.0;
  float dv = 0.f;
  if (tid < L) {
    v = p.a[b * p.as_b + hh * p.as_h + (long long)(c0 + tid) * p.as_s];
    dv = p.dt[b * p.ds_b + hh * p.ds_h + (long long)(c0 + tid) * p.ds_s];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) tot_s[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += tot_s[w];
  const float cum = __double2float_rn(v);
  if (tid < L) p.cum[(long long)bh * p.S + c0 + tid] = cum;
  if (tid == L - 1) *cl_s = cum;
  __syncthreads();
  wj_s[tid] = tid < L ? expf(*cl_s - cum) * dv : 0.f;

  // S_c (N x HD) = (B o wj)^T x: warpgroup wg takes state rows
  // 64 wg .. 64 wg + 63 (rows past N are zero; a warpgroup with none only
  // keeps the barriers)
  const int wg = warpgroup();
  const bool active = N >= 128 || wg * 64 < N;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = wg * 64 + 16 * (warp & 3) + g8;   // rows m0 and m0 + 8
  constexpr int kBatch = HD >= 128 ? 2 : 4;         // 16-key steps a batch
  float acc[HD / 2];                 // set by the first product
  for (int t = 0; t < n_kt; ++t) {
    // tile t in; every product on tile t - 1 done, so its stage is free
    cp_wait<0>();
    fence_async();
    __syncthreads();                 // (the first also: wj seen)
    if (t + 1 < n_kt) load(t + 1);
    cp_commit();
    if (!active) continue;
    const unsigned char* b_s = smem + (t & 1) * Sm::kStage;
    const unsigned char* x_s = b_s + Sm::kB;
    // the tile's four 16-key steps in batches of kBatch (keys past L have
    // wj 0 and zero rows)
#pragma unroll
    for (int k0 = 0; k0 < 4; k0 += kBatch) {
      uint32_t a[kBatch][3][4];      // [step][part][fragment register]
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        // A fragment q: row m0 + 8 (q & 1), keys 16 (k0 + k) + 8 (q >> 1)
        // + 2 t4 and + 1 of the tile: B[key][m] wj[key] in three parts
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + 8 * (q & 1);
          const int key = 16 * (k0 + k) + 8 * (q >> 1) + 2 * t4;
          const float* wj = wj_s + t * kTile + key;
          float v0 = 0.f, v1 = 0.f;
          if (m < N) {
            const bf16* bp = reinterpret_cast<const bf16*>(
                b_s + ((m >> 3) * kTile + key) * 16) + (m & 7);
            v0 = __bfloat162float(bp[0]) * wj[0];
            v1 = __bfloat162float(bp[8]) * wj[1];
          }
          split3(v0, v1, a[k][0][q], a[k][1][q], a[k][2][q]);
        }
      }
      // x keys 16 (k0 + k) ..: two core matrices along keys, 128 bytes
      // apart; column chunks kTile * 16 bytes apart (computed before the
      // batch, so nothing new needs a register until its wait)
      uint64_t xd[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        xd[k] = desc(x_s + (k0 + k) * 256, 128, kTile * 16);
      const int first = t > 0 || k0 > 0;
      wg_fence();
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          wgmma_rs<HD>(acc, a[k][part], xd[k], first || k > 0 || part > 0);
      wg_commit();
      wg_wait();
      fence_regs<HD / 2>(acc);
      keep_regs<kBatch * 12>(&a[0][0][0]);
    }
  }
  if (!active) return;

  float* out = p.st + ((long long)bh * p.nc + c) * (N * HD);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + 8 * r;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(out + m * HD + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// -- 2. the state pass --------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(Args p,
                                                               int nhd) {
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= nhd) return;
  const long long bh = blockIdx.y;
  float4 h = p.h0 != nullptr
                 ? *reinterpret_cast<const float4*>(p.h0 + bh * nhd + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float* st = p.st + bh * p.nc * nhd + e;
  const float* cum = p.cum + bh * p.S;
  float4 s = p.nc > 0 ? *reinterpret_cast<const float4*>(st)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < p.nc; ++c) {
    // the next chunk's S_c is read before this one's h_in is written
    float4 sn = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c + 1 < p.nc)
      sn = *reinterpret_cast<const float4*>(st + (long long)(c + 1) * nhd);
    const float d = expf(cum[min(p.S, (c + 1) * p.chunk) - 1]);
    *reinterpret_cast<float4*>(st + (long long)c * nhd) = h;
    h.x = h.x * d + s.x;
    h.y = h.y * d + s.y;
    h.z = h.z * d + s.z;
    h.w = h.w * d + s.w;
    s = sn;
  }
  *reinterpret_cast<float4*>(p.h_out + bh * nhd + e) = h;
}

// -- 3. the scan --------------------------------------------------------------

// Shared memory, the whole chunk: C and B [NP / 8][256][16 B], x
// [HD / 8][256][16 B], h_in's three parts [3][HD / 8][NP][16 B] (B operands
// N-major), cum, dt and the keys' decay factors kd [256] f32.  NP is
// d_state zero-padded to wgmma's depth of 16.
template <int HD, int N>
struct ScanSmem {
  static constexpr int NP = N < 16 ? 16 : N;
  static constexpr int kC = NP * 2 * kMaxChunk;
  static constexpr int kX = HD * 2 * kMaxChunk;
  static constexpr int kPart = HD * NP * 2;
  static constexpr int kBytes = 2 * kC + kX + 3 * kPart + 3 * 4 * kMaxChunk;
};

// One 64-row query tile `it` of a chunk of L tokens, by one warpgroup
// (warp w4 of it): y = exp(cum_i) C_i h_in + sum_{j <= it} W_j x_j, the
// carried term first, in the same accumulator.  Key tiles from 2 on wait
// for the second copy group (named barrier 1, the two warpgroups of query
// tiles 2 and 3).
template <int HD, int N>
__device__ __forceinline__ void scan_tile(
    const Args& p, int it, int L, const unsigned char* c_s,
    const unsigned char* b_s, const unsigned char* x_s,
    const unsigned char* h_s, const float* cum_s, const float* dt_s,
    const float* kd_s, bool mono, int w4, int g8, int t4, long long yrow0) {
  using Sm = ScanSmem<HD, N>;
  constexpr int NP = Sm::NP;
  constexpr int kRows = kMaxChunk * 16;       // a 16-byte plane of 256 rows
  constexpr int kBatch = HD >= 128 ? 2 : 4;   // 16-key steps a batch
  const int i0 = it * kTile;
  int ri[2];
  float ci[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ri[r] = i0 + 16 * w4 + g8 + 8 * r;
    ci[r] = ri[r] < L ? cum_s[ri[r]] : -INFINITY;   // no row past L
  }

  // acc = exp(cum_i) (C_i . h_in), C from shared memory into registers:
  // A fragment [ks][q], row i0 + 16 w4 + g8 + 8 (q & 1), depth 16 ks +
  // 8 (q >> 1) + 2 t4 and + 1
  float acc[HD / 2];                 // set by the first product
  uint32_t ca[NP / 16][4];
#pragma unroll
  for (int ks = 0; ks < NP / 16; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ca[ks][q] = *reinterpret_cast<const uint32_t*>(
          c_s + (2 * ks + (q >> 1)) * kRows +
          (i0 + 16 * w4 + g8 + 8 * (q & 1)) * 16 + 4 * t4);
  // h_in part k, depth 16 ks ..: its descriptor is hd0 plus the byte
  // offset / 16 (the address field does not carry)
  const uint64_t hd0 = desc(h_s, 128, NP * 16);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < NP / 16; ++ks)
#pragma unroll
    for (int part = 0; part < 3; ++part)
      wgmma_rs<HD>(acc, ca[ks], hd0 + (part * Sm::kPart + ks * 256) / 16,
                   ks > 0 || part > 0);
  wg_commit();
  wg_wait();
  fence_regs<HD / 2>(acc);
  keep_regs<NP / 4>(&ca[0][0]);
  const float ec[2] = {expf(ci[0]), expf(ci[1])};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= ec[(i >> 1) & 1];

  for (int j = 0; j <= it; ++j) {
    if (j == 2) {                    // keys 128 ..: the second group
      cp_wait<0>();
      fence_async();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
    const int j0 = j * kTile;
    // s[4 n + 2 r + e]: row ri[r], key j0 + 8 n + 2 t4 + e
    float s[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks)
      wgmma_cb(s, desc(c_s + 2 * ks * kRows + i0 * 16, kRows, 128),
               desc(b_s + 2 * ks * kRows + j0 * 16, kRows, 128), ks);
    wg_commit();
    wg_wait();
    fence_regs<32>(s);

    // W = s exp(cum_i - cum_j) dt_j where key <= row < L.  Below the
    // diagonal tile, with cum non-increasing over the chunk, the decay
    // factors through the key tile's last token (the anchor) into two
    // exps of at most 1: exp(cum_i - anchor) per row and kd_j =
    // exp(anchor - cum_j) dt_j per key, staged once a block.  Otherwise
    // it is masked BEFORE exp.
    if (j < it && mono) {
      const float anchor = cum_s[j0 + kTile - 1];
      const float rf[2] = {expf(ci[0] - anchor), expf(ci[1] - anchor)};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] *= rf[(i >> 1) & 1] * kd_s[j0 + 8 * (i >> 2) + 2 * t4 + (i & 1)];
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int key = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = (key <= ri[r] && ri[r] < L)
                   ? s[i] * expf(ci[r] - cum_s[key]) * dt_s[key]
                   : 0.f;
      }
    }
    // y += W x_j (past L, W is 0 and x zero-filled; no step is skipped,
    // since a wgmma under a branch ptxas cannot prove uniform is
    // serialized), W as A fragments [k][part][q]: s[8 ks + 2 q] and + 1
    // in three bf16 parts, in batches of kBatch 16-key steps
#pragma unroll
    for (int k0 = 0; k0 < 4; k0 += kBatch) {
      uint32_t a[kBatch][3][4];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split3(s[8 * (k0 + k) + 2 * q], s[8 * (k0 + k) + 2 * q + 1],
                 a[k][0][q], a[k][1][q], a[k][2][q]);
      // x keys j0 + 16 (k0 + k) ..: two core matrices along keys, 128
      // bytes apart; column chunks a plane apart (computed before the
      // batch)
      uint64_t xd[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        xd[k] = desc(x_s + (j0 + 16 * (k0 + k)) * 16, 128, kRows);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          wgmma_rs<HD>(acc, a[k][part], xd[k], 1);
      wg_commit();
      wg_wait();
      fence_regs<HD / 2>(acc);
      keep_regs<kBatch * 12>(&a[0][0][0]);
    }
  }

  // rows ri[r], columns 8 n + 2 t4 and + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ri[r] >= L) continue;
    const long long row = yrow0 + (long long)ri[r] * p.ys_s;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float y0 = acc[4 * n + 2 * r];
      const float y1 = acc[4 * n + 2 * r + 1];
      const int col = 8 * n + 2 * t4;
      if (p.y_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.y) + row + col) =
            make_float2(y0, y1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.y) + row + col) =
            pack_bf16(y0, y1);
      }
    }
  }
}

// One block of four warpgroups per (b, head, chunk), warpgroup i on query
// tile i.  The chunk is staged once, in two cp.async groups: C, cum and dt
// of every token and B and x of tokens 0 .. 127 (by all threads), then B
// and x of tokens 128 .. 255 (by warpgroups 2 and 3, which alone read
// them); the keys' decay factors and h_in's three parts are made
// meanwhile.
template <int HD, int N>
__global__ void __launch_bounds__(kScanThreads, 1) ssd_scan_kernel(Args p) {
  using Sm = ScanSmem<HD, N>;
  constexpr int NP = Sm::NP;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* c_s = smem;
  unsigned char* b_s = c_s + Sm::kC;
  unsigned char* x_s = b_s + Sm::kC;
  unsigned char* h_s = x_s + Sm::kX;
  float* cum_s = reinterpret_cast<float*>(h_s + 3 * Sm::kPart);
  float* dt_s = cum_s + kMaxChunk;
  float* kd_s = dt_s + kMaxChunk;

  const int tid = threadIdx.x;
  const int wg = warpgroup();
  const int w4 = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int b = bh / p.nh;
  const int hh = bh % p.nh;
  const int g = hh / (p.nh / p.G);
  const int c0 = c * p.chunk;
  const int L = min(p.chunk, p.S - c0);
  const int Lq = (L + kTile - 1) / kTile * kTile;   // rows staged
  const int nqt = Lq / kTile;
  const bf16* xg = p.x + b * p.xs_b + hh * p.xs_h + (long long)c0 * p.xs_s;
  const bf16* Bg = p.B + b * p.bs_b + g * p.bs_g + (long long)c0 * p.bs_s;
  const bf16* Cg = p.C + b * p.cs_b + g * p.cs_g + (long long)c0 * p.cs_s;
  const float* cumg = p.cum + (long long)bh * p.S + c0;
  const float* dtg = p.dt + b * p.ds_b + hh * p.ds_h + (long long)c0 * p.ds_s;
  const float* hin = p.st + ((long long)bh * p.nc + c) * (N * HD);

  if constexpr (NP > N) {            // d_state 8: zero depth 8 .. 15
    for (int e = tid; e < (NP - N) / 8 * kMaxChunk; e += kScanThreads) {
      const int off = (N / 8 * kMaxChunk + e) * 16;
      *reinterpret_cast<uint4*>(c_s + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(b_s + off) = make_uint4(0, 0, 0, 0);
    }
  }
  // the first group: C, cum and dt of every token, B and x of tokens
  // 0 .. 127
  for (int t0 = 0; t0 < Lq; t0 += kTile) {
    stage<N, kScanThreads>(p.gc, c_s, kMaxChunk, t0, Cg, p.cs_s, L);
    if (t0 < 2 * kTile) {
      stage<N, kScanThreads>(p.gb, b_s, kMaxChunk, t0, Bg, p.bs_s, L);
      stage<HD, kScanThreads>(p.gx, x_s, kMaxChunk, t0, xg, p.xs_s, L);
    }
  }
  for (int t = tid; t < Lq; t += kScanThreads) {
    const bool ok = t < L;
    cp_async<4>(cum_s + t, ok ? cumg + t : cumg, ok);
    cp_async<4>(dt_s + t, ok ? dtg + t * p.ds_s : dtg, ok);
  }
  cp_commit();
  // the second, B and x of tokens 128 .., by warpgroups 2 and 3
  if (wg >= 2) {
    constexpr int kHalf = kScanThreads / 2;
    for (int t0 = 2 * kTile; t0 < Lq; t0 += kTile) {
      stage<N, kHalf>(p.gb, b_s, kMaxChunk, t0, Bg, p.bs_s, L, tid - kHalf);
      stage<HD, kHalf>(p.gx, x_s, kMaxChunk, t0, xg, p.xs_s, L, tid - kHalf);
    }
  }
  cp_commit();

  // each key's decay to the last token of its 64-key tile, times dt, and
  // whether cum is non-increasing over the chunk (a <= 0, as a = dt A with
  // A < 0 makes it): the factored decay of scan_tile needs both factors
  // at most 1
  bool down = true;
  for (int t = tid; t < Lq; t += kScanThreads) {
    float kd = 0.f;
    if (t < L) {
      const float ct = cumg[t];
      kd = expf(cumg[min(t | (kTile - 1), L - 1)] - ct) * dtg[t * p.ds_s];
      down = down && (t == 0 || ct <= cumg[t - 1]);
    }
    kd_s[t] = kd;
  }

  // h_in (N x HD f32) as three bf16 parts, B operands N-major: part k at
  // h_s + k kPart, [HD / 8][NP][16 B].  Every load is issued before the
  // first split, so their latencies overlap.
  constexpr int kUnits = NP * (HD / 8);        // 8 values of a state row
  constexpr int kIter = (kUnits + kScanThreads - 1) / kScanThreads;
  float4 u[kIter][2];
#pragma unroll
  for (int k = 0; k < kIter; ++k) {
    const int e = tid + k * kScanThreads;
    const int m = e / (HD / 8);
    const float* src = hin + m * HD + 8 * (e % (HD / 8));
    const bool ok = e < kUnits && m < N;
    u[k][0] = ok ? *reinterpret_cast<const float4*>(src)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    u[k][1] = ok ? *reinterpret_cast<const float4*>(src + 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kIter; ++k) {
    const int e = tid + k * kScanThreads;
    if (e >= kUnits) break;
    const int m = e / (HD / 8);
    const float v[8] = {u[k][0].x, u[k][0].y, u[k][0].z, u[k][0].w,
                        u[k][1].x, u[k][1].y, u[k][1].z, u[k][1].w};
    uint32_t w[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split3(v[2 * i], v[2 * i + 1], w[0][i], w[1][i], w[2][i]);
#pragma unroll
    for (int part = 0; part < 3; ++part)
      *reinterpret_cast<uint4*>(h_s + part * Sm::kPart +
                                ((e % (HD / 8)) * NP + m) * 16) =
          make_uint4(w[part][0], w[part][1], w[part][2], w[part][3]);
  }

  cp_wait<1>();
  fence_async();
  // the first group in; h_in split; kd staged
  const bool mono = __syncthreads_and(down);
  const long long yrow0 = b * p.ys_b + hh * p.ys_h + (long long)c0 * p.ys_s;
  if (wg < nqt) {
    scan_tile<HD, N>(p, wg, L, c_s, b_s, x_s, h_s, cum_s, dt_s, kd_s, mono,
                     w4, g8, t4, yrow0);
  } else if (wg == 3 && nqt == 3) {  // the barrier query tile 2 waits at
    cp_wait<0>();
    fence_async();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
}

// -- launch -------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {  // the opt-in is per device: set it here
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD, int N>
int run(const Args& a, cudaStream_t st) {
  const long long bhc = (long long)a.Bsz * a.nh * a.nc;
  int err;
  if (bhc > 0) {
    constexpr int bytes = StateSmem<HD, N>::kBytes;
    if ((err = set_smem(ssd_state_kernel<HD, N>, bytes))) return err;
    ssd_state_kernel<HD, N><<<(unsigned)bhc, kStateThreads, bytes, st>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if ((long long)a.Bsz * a.nh > 0) {
    const int nhd = N * HD;
    const dim3 grid((nhd / 4 + kPassThreads - 1) / kPassThreads,
                    a.Bsz * a.nh);
    ssd_pass_kernel<<<grid, kPassThreads, 0, st>>>(a, nhd);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (bhc > 0) {
    constexpr int bytes = ScanSmem<HD, N>::kBytes;
    if ((err = set_smem(ssd_scan_kernel<HD, N>, bytes))) return err;
    ssd_scan_kernel<HD, N><<<(unsigned)bhc, kScanThreads, bytes, st>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  return 0;
}

// The widest granule, 16, 8, 4 or 2 bytes, that divides the base address
// of a bf16 view and its three outer strides (in elements).
inline int granule(const void* p, long long s0, long long s1, long long s2) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(p) |
                      static_cast<uintptr_t>(2 * s0) |
                      static_cast<uintptr_t>(2 * s1) |
                      static_cast<uintptr_t>(2 * s2);
  return x % 16 == 0 ? 16 : x % 8 == 0 ? 8 : x % 4 == 0 ? 4 : 2;
}

// bf16 K7: (hd, n) the reference kernel sweep and test shapes, the
// reduced configs, mamba2-2.7b and jamba's; `SHAPES` in the wrapper.
inline int dispatch(const Args& a, int hd, int n, cudaStream_t st) {
  if (hd == 8 && n == 8) return run<8, 8>(a, st);
  if (hd == 8 && n == 16) return run<8, 16>(a, st);
  if (hd == 16 && n == 8) return run<16, 8>(a, st);
  if (hd == 16 && n == 16) return run<16, 16>(a, st);
  if (hd == 64 && n == 128) return run<64, 128>(a, st);
  if (hd == 128 && n == 64) return run<128, 64>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ssd_tc
