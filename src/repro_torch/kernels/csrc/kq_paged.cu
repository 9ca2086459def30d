// K1 and K2: attention over the KQ-SVD-compressed paged cache, for Hopper.
//
// K1, paged decode, replaces the Pallas TPU kernel `_kq_decode_paged_kernel`
// (src/repro/kernels/kq_decode/paged.py:63, entry point
// `kq_decode_paged_attention` at :436, num_splits = 1, no scales): for
// every (slot b, kv group g) an f32 online softmax of the group's m
// compressed queries over the slot's tokens t < lengths[b], read through
// block_table[b, .].
//
// K2, paged prefill-append, replaces `_kq_prefill_paged_kernel`
// (paged.py:292, entry point `kq_prefill_paged_attention` at :342): a
// chunk of S queries per head attends the pages already written, its own
// included; query s sees t <= pos0[b] + s and t < lengths[b].  Its m * S
// rows per (b, g) (2,048 at full width) do not fit one block's registers,
// so they are cut into tiles of 16 rows, one block each, and a tile stops
// reading keys at min(lengths[b], its largest query position + 1).
//
// Neither carries the TPU design over: the TPU kernels walk one page per
// grid step with the softmax state in VMEM scratch and the block table in
// scalar prefetch.  Here a block walks its slot's tokens in 32-token warp
// tiles, looking a tile's pages up in the table itself; each token's R
// values are contiguous in the pool, so staging stays coalesced at any page
// size.  The kernel body, what bounds it and how its design answers that
// are in kq_attend.cuh, shared with K3 (kq_decode.cu).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include "kq_attend.cuh"

// Plain C entry points (loaded with ctypes).  dtype: 0 = float32,
// 1 = bfloat16, the same for qc, the pools and out; lengths, pos0 and
// block_table are int32.  All tensors contiguous: pools (P, Hkv, ps, R),
// block_table (B, n_pages) of physical page ids below P.  Each returns the
// launch's cudaError_t (0 on success).

// K1: qc (B, H, Rk) -> out (B, H, Rv).
extern "C" int kq_decode_paged_launch(const void* qc, const void* kc_pool,
                                      const void* vc_pool, const void* lengths,
                                      const void* block_table, void* out, int B,
                                      int H, int Hkv, int ps, int n_pages,
                                      int Rk, int Rv, float scale, int dtype,
                                      void* stream) {
  if (ps < 1 || n_pages < 1) return (int)cudaErrorInvalidValue;
  const kq::Cache cache{static_cast<const int32_t*>(block_table),
                        ps * n_pages, ps, n_pages};
  return kq::attend(dtype, qc, kc_pool, vc_pool, lengths, out, B, H, Hkv, Rk,
                    Rv, scale, cache, nullptr, 1, stream);
}

// K2: qc (B, H, S, Rk), pos0 (B,) -> out (B, H, S, Rv).
extern "C" int kq_prefill_paged_launch(const void* qc, const void* kc_pool,
                                       const void* vc_pool, const void* lengths,
                                       const void* pos0, const void* block_table,
                                       void* out, int B, int H, int Hkv, int S,
                                       int ps, int n_pages, int Rk, int Rv,
                                       float scale, int dtype, void* stream) {
  if (ps < 1 || n_pages < 1) return (int)cudaErrorInvalidValue;
  const kq::Cache cache{static_cast<const int32_t*>(block_table),
                        ps * n_pages, ps, n_pages};
  return kq::attend(dtype, qc, kc_pool, vc_pool, lengths, out, B, H, Hkv, Rk,
                    Rv, scale, cache, static_cast<const int32_t*>(pos0), S,
                    stream);
}
