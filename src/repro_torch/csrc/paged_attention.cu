// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/attention.py:paged_flash_decode_pallas
// (body _paged_attn_kernel = _tree_attn_kernel): GQA attention of T queries
// per row over a K/V pool of fixed-size blocks addressed through the row's
// block table, under a per-query validity mask (paper Eq. 8), with an fp32
// online softmax.  Fully masked query rows return 0.
//
// What bounds it on the H100: the bytes of the K/V blocks a row attends to.
// Decode and verify blocks do a few FLOPs per K/V byte, far below the
// card's ~295 FLOP/byte ridge, so the kernel is memory-bound.  The design
// keeps each K/V chunk's read shared by every query row of one KV head: a
// CTA owns (batch row, KV head, tile of 16 query rows = (t, group head)
// pairs), stages a 32-key chunk of K and V in shared memory once, and every
// warp reuses it for its rows.  Chunks that no row of the CTA attends to
// (unallocated table entries, rolled-back or future slots) are skipped
// without touching K/V.  Each CTA reads its own block-table entries: there
// is no gathered per-row view.  The kernel body is flash_decode.cuh's
// flash_decode_kernel<T, D, kPaged = true>.
//
// Layouts (all contiguous): q, out (B, T, H, D); k_pool, v_pool (P*bs, Hkv, D);
// table (B, R) int32, -1 = unallocated (clamped, and masked by the caller);
// mask (B, T, R*bs) bytes.  fp32 accumulation; inputs fp32 or bf16.

#include "flash_decode.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 = success); cudaErrorInvalidValue for an unsupported dtype/head dim.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* mask, void* out, int B, int T,
                                      int H, int Hkv, int D, int P, int bs, int R,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) {
    launch<float, 64, true>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else if (dtype == 0 && D == 128) {
    launch<float, 128, true>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else if (dtype == 1 && D == 64) {
    launch<__nv_bfloat16, 64, true>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else if (dtype == 1 && D == 128) {
    launch<__nv_bfloat16, 128, true>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
