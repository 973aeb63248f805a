// Masked flash-decode attention over a contiguous KV cache for Hopper
// (sm_90a), plain C interface.  Two entry points:
//
//   masked_decode_attention_launch  replaces the TPU kernel
//     repro/kernels/attention.py:masked_decode_attention_pallas (_attn_kernel):
//     one query token per row, q (B, H, D), mask (B, S) validity;
//   masked_tree_attention_launch    replaces
//     repro/kernels/attention.py:masked_tree_attention_pallas (_tree_attn_kernel):
//     T query tokens per row, q (B, T, H, D), mask (B, T, S) per-query rows
//     (validity-causal, with ancestor-or-self rows over a token-tree region).
//
// k, v are one layer of the contiguous state, (B, S, Hkv, D); GQA with
// H = g * Hkv; out has q's shape.  Scores are scaled by 1/sqrt(D) by the
// caller; fully masked query rows return 0.
//
// What bounds them on the H100: the bytes of the K/V rows a query attends
// to (a few FLOPs per byte, far below the ~295 FLOP/byte ridge), as for the
// paged kernel.  Both run flash_decode.cuh's kernel with the identity table
// (kPaged = false: R = 1 block of bs = S slots, block id = batch row), so a
// row's keys are read in 32-key chunks straight from its cache rows, the last
// chunk cut at S (no padding of S to a tile, unlike the TPU wrapper's 512),
// and chunks no query row attends to (rolled-back tails, unused capacity) are
// skipped.  The decode kernel is the T = 1 launch; the TPU likewise made the
// decode kernel the tree kernel's T = 1 case.

#include "flash_decode.cuh"

namespace {

int launch_contiguous(const void* q, const void* k, const void* v,
                      const void* mask, void* out, int B, int T, int H,
                      int Hkv, int D, int S, float scale, int dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  // identity table: P = B blocks of bs = S slots, R = 1 block per row
  if (dtype == 0 && D == 64) {
    launch<float, 64, false>(q, k, v, nullptr, mask, out, B, T, H, Hkv, B, S, 1, scale, st);
  } else if (dtype == 0 && D == 128) {
    launch<float, 128, false>(q, k, v, nullptr, mask, out, B, T, H, Hkv, B, S, 1, scale, st);
  } else if (dtype == 1 && D == 64) {
    launch<__nv_bfloat16, 64, false>(q, k, v, nullptr, mask, out, B, T, H, Hkv, B, S, 1, scale, st);
  } else if (dtype == 1 && D == 128) {
    launch<__nv_bfloat16, 128, false>(q, k, v, nullptr, mask, out, B, T, H, Hkv, B, S, 1, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of the
// launch (0 = success); cudaErrorInvalidValue for an unsupported dtype/head dim.
extern "C" int masked_decode_attention_launch(const void* q, const void* k,
                                              const void* v, const void* mask,
                                              void* out, int B, int H, int Hkv,
                                              int D, int S, float scale,
                                              int dtype, void* stream) {
  return launch_contiguous(q, k, v, mask, out, B, 1, H, Hkv, D, S, scale, dtype, stream);
}

extern "C" int masked_tree_attention_launch(const void* q, const void* k,
                                            const void* v, const void* mask,
                                            void* out, int B, int T, int H,
                                            int Hkv, int D, int S, float scale,
                                            int dtype, void* stream) {
  return launch_contiguous(q, k, v, mask, out, B, T, H, Hkv, D, S, scale, dtype, stream);
}
