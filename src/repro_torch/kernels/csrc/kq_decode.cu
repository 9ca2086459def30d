// K3: decode attention over the KQ-SVD-compressed dense cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_kq_decode_kernel`
// (src/repro/kernels/kq_decode/kq_decode.py:53, entry point
// `kq_decode_attention` at :98).  For every (sequence b, kv group g) it runs
// an f32 online softmax of the group's m compressed queries qc (m, Rk)
// against the cached kc rows t < lengths[b] and returns
// softmax(qc kc^T * scale) vc, shape (m, Rv), in the query's type.
//
// The kernel bodies, what bounds them and how their designs answer that
// are in kq_decode_tc.cuh (bfloat16, on the tensor cores) and kq_attend.cuh
// (float32), shared with the paged kernels (kq_paged.cu): here the cache is
// dense, (B, Hkv, T, R), one row per query head of the group.
//
// The span entry point (kq_decode_span_launch) runs the same bodies over a
// rank's span of a sequence-cut cache (a sequence-parallel decode on a
// device mesh): it writes the split-KV form of the output, the f32 rows
// acc / max(l, 1e-30) and their log-sum-exp m + log(max(l, 1e-30)), as
// one split covering the span, so that the ranks' spans merge by the rule
// of combine_split_partials.  A span wholly past the sequence (length 0)
// gives a zero row and an LSE of -1e30 + log(1e-30): weight 0 beside any
// live span.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include "kq_attend.cuh"
#include "kq_decode_tc.cuh"

// Plain C entry point (loaded with ctypes).  dtype: 0 = float32,
// 1 = bfloat16, the same for qc, kc, vc and out; lengths is int32.  All
// tensors contiguous: qc (B, H, Rk), kc (B, Hkv, T, Rk), vc (B, Hkv, T, Rv),
// out (B, H, Rv).  Returns the launch's cudaError_t (0 on success).
extern "C" int kq_decode_launch(const void* qc, const void* kc, const void* vc,
                                const void* lengths, void* out, int B, int H,
                                int Hkv, int T_len, int Rk, int Rv, float scale,
                                int dtype, void* stream) {
  if (dtype == 1)
    return kq_tc::decode_bf16(qc, kc, vc, nullptr, nullptr, lengths, nullptr,
                              out, nullptr, nullptr, nullptr, B, H, Hkv, Rk,
                              Rv, T_len, 1, 1, T_len, 1, scale, stream);
  const kq::Cache cache{nullptr, T_len, 1, 1, nullptr, nullptr};
  return kq::attend<false>(dtype, qc, kc, vc, lengths, out, B, H, Hkv, Rk, Rv,
                           scale, cache, nullptr, 1,
                           kq::Split{nullptr, nullptr, 1, T_len}, stream);
}

// K3 over a span, with its LSE.  qc (B, H, Rk), kc (B, Hkv, T, Rk),
// vc (B, Hkv, T, Rv) of `dtype` -> o_part (B, H, Rv) and lse (B, H), both
// f32; lengths (B,) int32 counts the span's live entries.
extern "C" int kq_decode_span_launch(const void* qc, const void* kc,
                                     const void* vc, const void* lengths,
                                     void* o_part, void* lse, int B, int H,
                                     int Hkv, int T_len, int Rk, int Rv,
                                     float scale, int dtype, void* stream) {
  if (o_part == nullptr || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return kq_tc::decode_bf16(qc, kc, vc, nullptr, nullptr, lengths, nullptr,
                              nullptr, o_part, lse, nullptr, B, H, Hkv, Rk,
                              Rv, T_len, 1, 1, T_len, 1, scale, stream);
  const kq::Cache cache{nullptr, T_len, 1, 1, nullptr, nullptr};
  return kq::attend<false>(
      dtype, qc, kc, vc, lengths, nullptr, B, H, Hkv, Rk, Rv, scale, cache,
      nullptr, 1,
      kq::Split{static_cast<float*>(o_part), static_cast<float*>(lse), 1,
                T_len},
      stream);
}
