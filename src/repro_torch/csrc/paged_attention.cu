// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/attention.py:paged_flash_decode_pallas
// (body _paged_attn_kernel = _tree_attn_kernel): GQA attention of T queries
// per row over a K/V pool of fixed-size blocks addressed through the row's
// block table, under a per-query validity mask (paper Eq. 8), with an fp32
// online softmax.  Fully masked query rows return 0.
//
// What bounds it on the H100: the bytes of the K/V blocks a row attends to
// (a few FLOPs per byte, far below the ~295 FLOP/byte ridge).  The body is
// flash_decode.cuh's split-key kernel with kPaged = true: the key splits of
// kernels/attention.py:split_plan put several CTAs per (row, KV head) in
// flight, each reading the block-table entries of the blocks its key range
// crosses (clamped to [0, P)) and prefetching 32-key K/V chunks with 16-byte
// cp.async copies; chunks no query of the tile attends to (unallocated
// entries, rolled-back or future slots) are never copied.  With more than
// one split a second kernel merges the fp32 partials in split order.
//
// Layouts (all contiguous): q, out (B, T, H, D); k_pool, v_pool (P*bs, Hkv, D);
// table (B, R) int32, -1 = unallocated (clamped, and masked by the caller);
// mask (B, T, R*bs) bytes; ml (B*T*H, splits, 2) and acc (B*T*H, splits, D)
// fp32 scratch, unused (may be null) when splits = 1.

#include "flash_decode.cuh"

// dtype: 0 = float32, 1 = bfloat16.  splits key ranges of cps chunks each.
// Returns the cudaError_t of the launches (0 = success);
// cudaErrorInvalidValue for an unsupported dtype/head dim or plan.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* mask, void* out, void* ml,
                                      void* acc, int B, int T, int H, int Hkv,
                                      int D, int P, int bs, int R, int splits,
                                      int cps, float scale, int dtype,
                                      void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const int*>(table),
               static_cast<const uint8_t*>(mask), out, static_cast<float*>(ml),
               static_cast<float*>(acc), T, H, Hkv, P, bs, R, splits, cps, scale};
  if (P <= 0) return (int)cudaErrorInvalidValue;
  return launch<true>(a, B, D, dtype, static_cast<cudaStream_t>(stream));
}
