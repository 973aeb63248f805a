// Vocabulary-row kernels for Hopper (sm_90a), plain C interface, on the
// cluster-split row body of row_reduce.cuh.  Four entry points:
//
//   row_stats_launch  replaces the TPU kernel
//     repro/kernels/verify.py:verify_stats_pallas (_verify_kernel): per row,
//     argmax (first maximal index), max, sumexp rescaled to the max and the
//     logit at the row's candidate token, in one read of the row;
//   row_topk_launch   replaces repro/kernels/verify.py:topk_pallas
//     (_topk_kernel, _select_topk): per row the k best (value, index) pairs,
//     values descending, ties to the smaller index, k <= 8;
//   row_softmax_stats_launch  replaces repro/kernels/dtv.py:softmax_stats
//     (_stats_kernel): per row (max, sumexp rescaled to the max);
//   row_dtv_launch    replaces repro/kernels/dtv.py:dtv_pallas (_dtv_kernel
//     and its two softmax_stats calls): per row pair, all of paper Eq. 5,
//     0.5 * sum |softmax(a) - softmax(b)|, in one launch.
//
// What bounds them on the H100: one read of the logits (fp32 or bf16); see
// row_reduce.cuh for the design.  DTV reads each logit once where a CTA's
// slices stay in registers between its two passes (one batch per thread,
// the probe's V = 32000), and once more from L2 otherwise.  For the
// statistics and top-k, row r of R starts at element (r / T1) * sb +
// (r % T1) * st of x with unit column stride, so a (B, T1, V) view of a
// verify block is read in place; the softmax statistics and DTV take (R, V)
// rows with any row stride.  Outputs are contiguous: am, m, s, cl (R,) for
// the verify statistics; vals (R, k) fp32 and idx (R, k) int32 for the
// top-k; m, s (R,) for the softmax statistics; out (R,) for DTV.  C CTAs
// per row (a cluster), per columns each.

#include "row_reduce.cuh"

using rowred::PairArgs;
using rowred::RowArgs;
using rowred::launch_rows;

namespace {

template <int K>
int topk_k(const RowArgs& a, int R, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_rows<float, K, false>(a, R, stream);
  return launch_rows<__nv_bfloat16, K, false>(a, R, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 =
// success); cudaErrorInvalidValue for an unsupported dtype, k or plan.
extern "C" int row_stats_launch(const void* x, const void* cand, void* am, void* m, void* s,
                                void* cl, int R, int V, int T1, long long sb, long long st, int C,
                                int per, int dtype, void* stream) {
  const RowArgs a{x, static_cast<const int*>(cand), static_cast<int*>(am), nullptr,
                  static_cast<float*>(m), static_cast<float*>(s), static_cast<float*>(cl),
                  V, T1, sb, st, C, per};
  if (!rowred::plan_ok(a, R)) return (int)cudaErrorInvalidValue;
  const auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rows<float, 1, true>(a, R, strm);
  if (dtype == 1) return launch_rows<__nv_bfloat16, 1, true>(a, R, strm);
  return (int)cudaErrorInvalidValue;
}

extern "C" int row_topk_launch(const void* x, void* vals, void* idx, int R, int V, int T1,
                               long long sb, long long st, int k, int C, int per, int dtype,
                               void* stream) {
  const RowArgs a{x, nullptr, static_cast<int*>(idx), static_cast<float*>(vals), nullptr,
                  nullptr, nullptr, V, T1, sb, st, C, per};
  if (!rowred::plan_ok(a, R) || k > V || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const auto strm = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return topk_k<1>(a, R, dtype, strm);
    case 2: return topk_k<2>(a, R, dtype, strm);
    case 3: return topk_k<3>(a, R, dtype, strm);
    case 4: return topk_k<4>(a, R, dtype, strm);
    case 5: return topk_k<5>(a, R, dtype, strm);
    case 6: return topk_k<6>(a, R, dtype, strm);
    case 7: return topk_k<7>(a, R, dtype, strm);
    case 8: return topk_k<8>(a, R, dtype, strm);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int row_softmax_stats_launch(const void* x, void* m, void* s, int R, int V,
                                        long long st, int C, int per, int dtype, void* stream) {
  const PairArgs a{x, nullptr, nullptr, static_cast<float*>(m), static_cast<float*>(s),
                   V, st, 0, C, per};
  const auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rowred::launch_softmax<float>(a, R, strm);
  if (dtype == 1) return rowred::launch_softmax<__nv_bfloat16>(a, R, strm);
  return (int)cudaErrorInvalidValue;
}

extern "C" int row_dtv_launch(const void* a, const void* b, void* out, int R, int V,
                              long long sa, long long sb, int C, int per, int dtype,
                              void* stream) {
  const PairArgs p{a, b, static_cast<float*>(out), nullptr, nullptr, V, sa, sb, C, per};
  const auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rowred::launch_dtv<float>(p, R, strm);
  if (dtype == 1) return rowred::launch_dtv<__nv_bfloat16>(p, R, strm);
  return (int)cudaErrorInvalidValue;
}
