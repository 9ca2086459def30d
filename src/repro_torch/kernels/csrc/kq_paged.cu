// K1, K2, K4 and K5: attention over the KQ-SVD-compressed paged cache, and
// the merge of split-KV partials, for Hopper.
//
// K1, paged decode, replaces the Pallas TPU kernel `_kq_decode_paged_kernel`
// (src/repro/kernels/kq_decode/paged.py:63, entry point
// `kq_decode_paged_attention` at :436, num_splits = 1, no scales): for
// every (slot b, kv group g) an f32 online softmax of the group's m
// compressed queries over the slot's tokens t < lengths[b], read through
// block_table[b, .].
//
// K4, split-KV paged decode, replaces `_kq_decode_paged_split_kernel`
// (paged.py:120, launched by `_kq_decode_paged_split` at :216): the
// slot's page chain is cut into n spans of `span` pages, one block per
// (b, g, span) instead of per (b, g) (256 blocks instead of 32 at 8 slots,
// 4 kv heads and 8 splits), each writing an f32 partial (out_s, lse_s),
// merged into the output as `combine_split_partials` (paged.py:196) does
// in the reference: in bfloat16 by the last CTA of each (b, g) inside the
// same launch (kq_decode_tc.cuh), in float32 by kq_combine_splits below.
//
// K5, int8 pages, replaces the same two kernels with quant=True
// (paged.py:63-117, :120-193): int8 code pools plus bf16 per-token scale
// pools (P, Hkv, ps, 1): in bf16 the codes enter the tensor cores as they
// are and the scales multiply scores and p; in float32 they are
// dequantized in registers while staging.
//
// K2, paged prefill-append, replaces `_kq_prefill_paged_kernel`
// (paged.py:292, entry point `kq_prefill_paged_attention` at :342): a
// chunk of S queries per head attends the pages already written, its own
// included; query s sees t <= pos0[b] + s and t < lengths[b].  Its m * S
// rows per (b, g) (2,048 at full width) make it bound by operations, so
// bf16 K2 has a body of its own on the tensor cores (`wgmma`, 64-row
// tiles, a cp.async ring staged through the block table): see
// kq_prefill.cuh.  float32 K2 (the reduced parity runs) stays on the
// shared body of kq_attend.cuh, in true f32 on CUDA cores, in tiles of 16
// rows, one block each, a tile stopping at min(lengths[b], its last
// position + 1).
//
// None carries the TPU design over: the TPU kernels walk one page per
// grid step with the softmax state in VMEM scratch and the block table in
// scalar prefetch.  In bfloat16, K1, K4 and K5 run kq_decode_tc.cuh (shared
// with K3, kq_decode.cu): a thread-block cluster per (slot, kv group), or
// per split span, each CTA staging its run of 16-token tiles straight from
// the pages with cp.async, both products on mma.sync tensor cores, and the
// CTAs' partials merged through distributed shared memory.  In float32
// they and K2 run kq_attend.cuh (a block walks its slot's or span's tokens
// in 32-token warp tiles on CUDA cores).  Each header says what bounds its
// kernels and how the design answers that.
//
// The combine is bound by nothing but its launch: it reads n * m * Rv
// floats per (b, g) (a few hundred KB at full width) and does a few flops
// per value.  A thread per output value, each issuing its spans' loads
// together; no shared memory.  Its merge, kq_tc::merge_value, is the one
// bf16 split decode runs inside its own launch, so the two routes give the
// same bits; float32 split decode (the reduced parity runs) and callers
// of the partials still launch it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include "kq_attend.cuh"
#include "kq_decode_tc.cuh"
#include "kq_prefill.cuh"

namespace {

constexpr int kCombineThreads = 128;

// out[r, c] = sum_s w_s o_part[s, c] / max(sum_s w_s, 1e-30), w_s =
// exp(lse_s - max_s lse_s), for r = (b * Hkv + g) * m + j, which is head
// g * m + j of slot b in out (B, H, Rv).
template <typename T>
__global__ void combine_kernel(const float* __restrict__ o_part,
                               const float* __restrict__ lse,
                               T* __restrict__ out, int n_rows, int n, int m,
                               int Rv) {
  const long long e = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (e >= (long long)n_rows * Rv) return;
  const int r = static_cast<int>(e / Rv);
  const int c = static_cast<int>(e - (long long)r * Rv);
  const int bg = r / m;
  const size_t row = (size_t)bg * n * m + (r - bg * m);
  kq::store(out + e, kq_tc::merge_value(lse + row, o_part + row * Rv + c, n,
                                        m, m * Rv));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  dtype: 0 = float32,
// 1 = bfloat16, the type of qc and out (and of fp pools); lengths, pos0
// and block_table are int32.  All tensors contiguous: pools
// (P, Hkv, ps, R), block_table (B, n_pages) of physical page ids below P.
// Each returns the launch's cudaError_t (0 on success).

// K1, K4, K5: qc (B, H, Rk) -> out (B, H, Rv), or split partials;
// bfloat16 runs the tensor-core body (kq_decode_tc.cuh), float32 the
// shared one.
//   kscale/vscale: nullptr for fp pools of `dtype` (K1, K4); else the
//     pools are int8 and these are their (P, Hkv, ps, 1) bf16 scales (K5).
//   o_part/lse: nullptr for the unsplit kernel (n_splits 1), which writes
//     out; else (B, Hkv, n_splits, m, Rv) and (B, Hkv, n_splits, m) f32
//     partials of spans of span_pages pages (K4, K5 split).
//   count: nullptr but for a bfloat16 split with out, which merges the
//     partials into out in this launch: B * Hkv * 32 int32 arrival
//     counters (one a 128-byte line), zero before the launch and left
//     zero.  A float32 split leaves out untouched (kq_combine_splits
//     merges).
extern "C" int kq_decode_paged_launch(const void* qc, const void* kc_pool,
                                      const void* vc_pool, const void* kscale,
                                      const void* vscale, const void* lengths,
                                      const void* block_table, void* out,
                                      void* o_part, void* lse, void* count,
                                      int B, int H, int Hkv, int ps,
                                      int n_pages, int Rk, int Rv,
                                      int span_pages, int n_splits,
                                      float scale, int dtype, void* stream) {
  if (ps < 1 || n_pages < 1 || span_pages < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return kq_tc::decode_bf16(qc, kc_pool, vc_pool, kscale, vscale, lengths,
                              block_table, out, o_part, lse, count, B, H,
                              Hkv, Rk, Rv, ps * n_pages, ps, n_pages,
                              o_part == nullptr ? ps * n_pages
                                                : span_pages * ps,
                              n_splits, scale, stream);
  if (count != nullptr) return (int)cudaErrorInvalidValue;
  const kq::Cache cache{static_cast<const int32_t*>(block_table),
                        ps * n_pages, ps, n_pages,
                        static_cast<const __nv_bfloat16*>(kscale),
                        static_cast<const __nv_bfloat16*>(vscale)};
  const kq::Split split{static_cast<float*>(o_part), static_cast<float*>(lse),
                        n_splits,
                        o_part == nullptr ? ps * n_pages : span_pages * ps};
  return kq::attend<true>(dtype, qc, kc_pool, vc_pool, lengths, out, B, H,
                          Hkv, Rk, Rv, scale, cache, nullptr, 1, split,
                          stream);
}

// K2: qc (B, H, S, Rk), pos0 (B,) -> out (B, H, S, Rv); fp pools.
// bfloat16 runs the tensor-core body (kq_prefill.cuh), float32 the shared
// one.
extern "C" int kq_prefill_paged_launch(const void* qc, const void* kc_pool,
                                       const void* vc_pool, const void* lengths,
                                       const void* pos0, const void* block_table,
                                       void* out, int B, int H, int Hkv, int S,
                                       int ps, int n_pages, int Rk, int Rv,
                                       float scale, int dtype, void* stream) {
  if (ps < 1 || n_pages < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return kq_prefill::prefill_bf16(qc, kc_pool, vc_pool, lengths, pos0,
                                    block_table, out, B, H, Hkv, S, ps,
                                    n_pages, Rk, Rv, scale, stream);
  const kq::Cache cache{static_cast<const int32_t*>(block_table),
                        ps * n_pages, ps, n_pages, nullptr, nullptr};
  return kq::attend<true>(dtype, qc, kc_pool, vc_pool, lengths, out, B, H,
                          Hkv, Rk, Rv, scale, cache,
                          static_cast<const int32_t*>(pos0), S,
                          kq::Split{nullptr, nullptr, 1, ps * n_pages},
                          stream);
}

// The split merge: o_part (B, Hkv, n, m, Rv) and lse (B, Hkv, n, m) f32
// -> out (B, Hkv * m, Rv) in `dtype`.
extern "C" int kq_combine_splits_launch(const void* o_part, const void* lse,
                                        void* out, int B, int Hkv, int n,
                                        int m, int Rv, int dtype,
                                        void* stream) {
  if (B < 1 || Hkv < 1 || n < 1 || m < 1 || Rv < 1 || Rv > kq::kMaxR)
    return (int)cudaErrorInvalidValue;
  const int n_rows = B * Hkv * m;
  const dim3 grid(static_cast<unsigned>(
      ((long long)n_rows * Rv + kCombineThreads - 1) / kCombineThreads));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const float*>(o_part);
  const auto* ls = static_cast<const float*>(lse);
  if (dtype == 0)
    combine_kernel<float><<<grid, kCombineThreads, 0, st>>>(
        op, ls, static_cast<float*>(out), n_rows, n, m, Rv);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<grid, kCombineThreads, 0, st>>>(
        op, ls, static_cast<__nv_bfloat16*>(out), n_rows, n, m, Rv);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The cluster size bf16 decode (kq_decode_tc.cuh) runs with over a span of
// `tokens` tokens: a slot's capacity, or a split's span.
extern "C" int kq_decode_cluster_size(int tokens) {
  return kq_tc::cluster_size(tokens);
}
