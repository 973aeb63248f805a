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
// paged kernel.  Both run flash_decode.cuh's split-key kernel with the
// identity table (kPaged = false: R = 1 block of bs = S slots, block id =
// batch row), so the key splits of kernels/attention.py:split_plan cut each
// row's single block into chunk-aligned ranges, the last chunk cut at S (no
// padding of S to a tile, unlike the TPU wrapper's 512).  Chunks no query row
// attends to (rolled-back tails, unused capacity) are never copied.  The
// decode kernel is the T = 1 launch, with the one-row tile; the TPU likewise
// made the decode kernel the tree kernel's T = 1 case.  ml and acc are the
// fp32 split partials, (B*T*H, splits, 2) and (B*T*H, splits, D), unused
// (may be null) when splits = 1.

#include "flash_decode.cuh"

namespace {

int launch_contiguous(const void* q, const void* k, const void* v,
                      const void* mask, void* out, void* ml, void* acc, int B,
                      int T, int H, int Hkv, int D, int S, int splits, int cps,
                      float scale, int dtype, void* stream) {
  // identity table: P = B blocks of bs = S slots, R = 1 block per row
  const Args a{q, k, v, nullptr, static_cast<const uint8_t*>(mask), out,
               static_cast<float*>(ml), static_cast<float*>(acc), T, H, Hkv,
               B, S, 1, splits, cps, scale};
  return launch<false>(a, B, D, dtype, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; splits key ranges of cps chunks each.
// Each returns the cudaError_t of the launches (0 = success);
// cudaErrorInvalidValue for an unsupported dtype/head dim or plan.
extern "C" int masked_decode_attention_launch(const void* q, const void* k,
                                              const void* v, const void* mask,
                                              void* out, void* ml, void* acc,
                                              int B, int H, int Hkv, int D,
                                              int S, int splits, int cps,
                                              float scale, int dtype,
                                              void* stream) {
  return launch_contiguous(q, k, v, mask, out, ml, acc, B, 1, H, Hkv, D, S,
                           splits, cps, scale, dtype, stream);
}

extern "C" int masked_tree_attention_launch(const void* q, const void* k,
                                            const void* v, const void* mask,
                                            void* out, void* ml, void* acc,
                                            int B, int T, int H, int Hkv,
                                            int D, int S, int splits, int cps,
                                            float scale, int dtype,
                                            void* stream) {
  return launch_contiguous(q, k, v, mask, out, ml, acc, B, T, H, Hkv, D, S,
                           splits, cps, scale, dtype, stream);
}
