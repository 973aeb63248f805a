// Vocabulary-row reductions for Hopper (sm_90a): one body for the verify row
// statistics and the tree-draft top-k (row_kernels.cu), meant to carry the
// softmax-stats and DTV reductions too.
//
// Replaces the TPU kernels repro/kernels/verify.py:verify_stats_pallas (body
// _verify_kernel) and topk_pallas (_topk_kernel, _select_topk): per logits
// row, in one read of the row, the top K entries under the total order
// (value descending, index ascending) -- K = 1 is the argmax with ties to the
// first maximal index, as jnp.argmax -- and, for the statistics, the row max,
// the sumexp rescaled to it and the logit at the row's candidate token.
//
// What bounds it: one read of the (R, V) logits.  There is no matrix
// product; a few operations per element.  The main path has few rows (4-20
// rows of V = 32000), so one CTA per row would leave most of the 132 SMs
// idle and walk each row in one long chain of loads.  The design:
//
// 1. A row per thread-block cluster.  Each row is cut into C contiguous
//    slices (C in {1, 2, 4, 8}, kernels/verify.py:row_split_plan: at least
//    one CTA per SM where the rows allow, slices of at least 4 KB), one CTA
//    of the row's cluster per slice.  Slice starts fall on 16-byte
//    boundaries of the row (the plan's slice width is a multiple of 16
//    bytes of elements).
// 2. Loads in flight.  A CTA reads its slice in 16-byte units, neighbouring
//    threads on neighbouring units, kBatch units per thread per batch; the
//    next batch's loads are issued before the current batch is reduced, so
//    at V = 32000 every load of a slice is issued before any reduction, and
//    at long vocabularies a batch (32 KB a CTA) stays in flight while one
//    is reduced.  (A cp.async ring holding three batches in flight per
//    thread measured no faster on the H100: a CTA's stream rate is capped
//    either way, so the split over SMs is what sets the rate.)
//    The part of a slice before its first 16-byte aligned address and after
//    its last one (a row of odd length such as V = 32001, or a strided
//    view) is read one element per thread: no vector load is misaligned.
// 3. Reductions under a total order, so the answer does not depend on the
//    reduction tree: each thread keeps its K best (value, index) pairs in a
//    sorted register list (an empty slot has index kNone >= V and ranks
//    below every real entry, so -inf logits stay selectable), and lists
//    are merged by K rounds of a warp-wide maximum in which the lane
//    holding the winner pops it.  The selected indices and values equal a
//    stable descending sort's exactly.  The sumexp is a float sum, so its
//    order is fixed: per-thread partials in index order (rescaled once per
//    batch to the running max); in each warp, every lane's partial rescaled
//    to the warp's max (the top-1 selection has it) and added in a fixed
//    xor-shuffle tree; then the cluster's C * 8 warp partials, two per lane
//    of one warp in (rank, warp) order, the same way.
// 4. Merge through distributed shared memory, one cluster barrier.  Each
//    warp stores its partial into rank 0's shared memory (map_shared_rank)
//    once a relaxed arrival made at the kernel's start shows that every
//    CTA of the cluster runs; after one cluster.sync() one warp of rank 0
//    merges the partials from its own shared memory and writes the row's
//    outputs, while the other warps and CTAs exit.  No second kernel, no
//    atomics, no global scratch: a repeat launch gives the same bits.  The
//    candidate's index is read as the kernel starts and its logit loaded
//    once the first batch's loads are out, so the two dependent loads
//    overlap the slice's.  (Taking the logit from the loaded units instead
//    measured slower: it adds a compare to every element.)
//
// Rows: row r of R starts at element (r / T1) * sb + (r % T1) * st of x, so
// a (R, V) matrix with row stride st (T1 = R, sb = 0) and a (B, T1, V) view
// with batch and row strides (sb, st) are both read in place; the column
// stride is 1.  Elements are fp32 or bf16, reduced in fp32.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rowred {
namespace {  // internal linkage: each library keeps its own kernels

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;              // 16-byte units per thread per batch
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kNone = 0x7fffffff;      // index of an empty slot
constexpr float kLog2e = 1.4426950408889634f;

// (v, i) ranks above (w, j): larger value, then smaller index
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// 2^x in one MUFU op (-inf -> 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// e^(x - m) for a running max m >= x; 0 where x = -inf
__device__ __forceinline__ float exp_below(float x, float m) {
  return fast_exp2(__fmul_rn(__fsub_rn(x, m), kLog2e));
}

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kPerUnit = 4;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kPerUnit = 8;
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// What a thread, a warp, a CTA and a cluster each reduce a row to: the K
// best entries, sorted, and (kSum) the max and the sumexp rescaled to it.
template <int K>
struct Part {
  float v[K];
  int i[K];
  float m, s;
};

template <int K, bool kSum>
struct RowAcc {
  float v[K];
  int i[K];
  float m, s;

  __device__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = -INFINITY;
      i[j] = kNone;
    }
    m = -INFINITY;
    s = 0.f;
  }

  __device__ void load(const Part<K>& p) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = p.v[j];
      i[j] = p.i[j];
    }
    m = p.m;
    s = p.s;
  }

  __device__ void store(Part<K>& p) const {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      p.v[j] = v[j];
      p.i[j] = i[j];
    }
    p.m = m;
    p.s = s;
  }

  // insert one entry into the sorted list
  __device__ __forceinline__ void push(float x, int c) {
    if (!better(x, c, v[K - 1], i[K - 1])) return;
    v[K - 1] = x;
    i[K - 1] = c;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (better(v[j], i[j], v[j - 1], i[j - 1])) {
        const float tv = v[j];
        v[j] = v[j - 1];
        v[j - 1] = tv;
        const int ti = i[j];
        i[j] = i[j - 1];
        i[j - 1] = ti;
      }
    }
  }

  // (m, s) <- (m, s) (+) (pm, ps): the same bits whichever side is which.
  // An empty side (max -inf, sum 0) adds e^-inf * 0 = 0.
  __device__ __forceinline__ void merge_sum(float pm, float ps) {
    const float mn = fmaxf(m, pm);
    if (mn == -INFINITY) return;  // nothing but -inf so far
    s = __fadd_rn(__fmul_rn(s, exp_below(m, mn)), __fmul_rn(ps, exp_below(pm, mn)));
    m = mn;
  }

  // The warp's K best entries, in every lane: K rounds of a warp-wide
  // maximum of the lanes' list heads; the lane whose head won pops it.
  // Real entries have distinct indices, so one lane pops; several lanes
  // pop only empty slots, which are all alike.
  __device__ void select_warp() {
    float ov[K];
    int oi[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float bv = v[0];
      int bi = i[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float pv = __shfl_xor_sync(0xffffffffu, bv, off);
        const int pi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(pv, pi, bv, bi)) {
          bv = pv;
          bi = pi;
        }
      }
      ov[r] = bv;
      oi[r] = bi;
      if (i[0] == bi) {
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          v[j] = v[j + 1];
          i[j] = i[j + 1];
        }
        v[K - 1] = -INFINITY;
        i[K - 1] = kNone;
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = ov[j];
      i[j] = oi[j];
    }
  }

  // The warp's (m, s) in every lane, once select_warp() has put the warp's
  // max in v[0]: each lane's sum rescaled to it, then a fixed xor tree.
  __device__ void sum_warp() {
    const float mx = v[0];
    float t = mx == -INFINITY ? 0.f : __fmul_rn(s, exp_below(m, mx));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
    m = mx;
    s = t;
  }

  // fold another partial into this one
  __device__ void fold(const Part<K>& p) {
#pragma unroll
    for (int j = 0; j < K; ++j) push(p.v[j], p.i[j]);
    if constexpr (kSum) merge_sum(p.m, p.s);
  }
};

// Cluster barrier halves (PTX): a relaxed arrival, a wait, and a full
// release/acquire barrier.  Every thread of the cluster calls each.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// One batch: kBatch 16-byte units per thread, unit j of thread t at unit
// index (b * kBatch + j) * kThreads + t of the slice's aligned part.
__device__ __forceinline__ void load_batch(const uint4* __restrict__ p, int n_units, int b,
                                           uint4 (&u)[kBatch]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = (b * kBatch + j) * kThreads + threadIdx.x;
    u[j] = k < n_units ? __ldg(p + k) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int K, bool kSum>
__device__ __forceinline__ void reduce_batch(const uint4 (&u)[kBatch], int n_units, int b,
                                             int col0, RowAcc<K, kSum>& acc) {
  constexpr int E = Elt<T>::kPerUnit;
  float bmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = (b * kBatch + j) * kThreads + threadIdx.x;
    if (k < n_units) {
      float f[E];
      Elt<T>::unpack(u[j], f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc.push(f[e], col0 + k * E + e);
        bmax = fmaxf(bmax, f[e]);
      }
    }
  }
  if constexpr (kSum) {
    const float mn = fmaxf(acc.m, bmax);
    if (mn == -INFINITY) return;
    float s = __fmul_rn(acc.s, exp_below(acc.m, mn));
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = (b * kBatch + j) * kThreads + threadIdx.x;
      if (k < n_units) {
        float f[E];
        Elt<T>::unpack(u[j], f);
#pragma unroll
        for (int e = 0; e < E; ++e) s = __fadd_rn(s, exp_below(f[e], mn));
      }
    }
    acc.m = mn;
    acc.s = s;
  }
}

// Columns [lo, hi) of a row into this thread's partial: the unaligned head
// one element per thread, the 16-byte aligned body in batches with the next
// batch's loads in flight, then the unaligned tail.  Each thread meets its
// columns in increasing order.  ``issued`` runs once the first batch's
// loads are out.
template <typename T, int K, bool kSum, typename F>
__device__ void reduce_slice(const T* __restrict__ row, int lo, int hi, RowAcc<K, kSum>& acc,
                             F&& issued) {
  constexpr int E = Elt<T>::kPerUnit;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row + lo);
  const int a0 = min(hi, lo + (int)(((16u - (addr & 15u)) & 15u) / sizeof(T)));
  const int n_units = (hi - a0) / E;
  const int a1 = a0 + n_units * E;
  const int t = threadIdx.x;
  // the head and tail elements' loads go out with the first batch's
  const bool head = lo + t < a0, tail = a1 + t < hi;
  const float hx = head ? Elt<T>::load(row + lo + t) : 0.f;
  const float tx = tail ? Elt<T>::load(row + a1 + t) : 0.f;
  const uint4* p = reinterpret_cast<const uint4*>(row + a0);
  const int n_batches = (n_units + kBatch * kThreads - 1) / (kBatch * kThreads);
  uint4 cur[kBatch];
  load_batch(p, n_units, 0, cur);
  issued();
  if (head) {
    acc.push(hx, lo + t);
    if constexpr (kSum) acc.merge_sum(hx, 1.f);
  }
  for (int b = 0; b < n_batches; ++b) {
    uint4 nxt[kBatch];
    load_batch(p, n_units, b + 1, nxt);  // nothing past the last batch
    reduce_batch<T, K, kSum>(cur, n_units, b, a0, acc);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) cur[j] = nxt[j];
  }
  if (tail) {
    acc.push(tx, a1 + t);
    if constexpr (kSum) acc.merge_sum(tx, 1.f);
  }
}

struct RowArgs {
  const void* x;      // logits, fp32 or bf16
  const int* cand;    // (R,) candidate per row (kSum)
  int* out_i;         // (R, K) indices: the argmax (kSum) or the top-k
  float* out_v;       // (R, K) top-k values (unused for kSum)
  float* out_m;       // (R,) max (kSum)
  float* out_s;       // (R,) sumexp (kSum)
  float* out_cl;      // (R,) candidate logit (kSum)
  int V, T1;          // row length; rows per batch entry
  long long sb, st;   // batch and row strides, elements
  int C, per;         // CTAs per row (the cluster), columns per CTA
};

// Grid: R * C CTAs in clusters of C along x; cluster r reduces row r.
template <typename T, int K, bool kSum>
__global__ void __launch_bounds__(kThreads, 2) row_reduce_kernel(const RowArgs a) {
  cluster_arrive_relaxed();  // once all arrived, every CTA of the cluster runs
  __shared__ Part<K> parts[kMaxCluster * kWarps];  // rank 0's: (rank, warp)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / a.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* row = static_cast<const T*>(a.x) + (long long)(r / a.T1) * a.sb +
                 (long long)(r % a.T1) * a.st;
  const int lo = min(a.V, rank * a.per), hi = min(a.V, lo + a.per);

  // the candidate logit: one load, by the CTA whose slice holds it (rank 0
  // writes NaN for a candidate outside the row)
  int cand = 0;
  if constexpr (kSum) {
    if (threadIdx.x == 0) cand = __ldg(a.cand + r);
  }
  float cl = 0.f;
  bool has_cl = false;
  RowAcc<K, kSum> acc;
  acc.clear();
  reduce_slice<T, K, kSum>(row, lo, hi, acc, [&] {
    if constexpr (kSum) {
      if (threadIdx.x == 0 && cand >= lo && cand < hi) {
        cl = Elt<T>::load(row + cand);
        has_cl = true;
      } else if (threadIdx.x == 0 && rank == 0 && (cand < 0 || cand >= a.V)) {
        cl = NAN;
        has_cl = true;
      }
    }
  });
  if (has_cl) a.out_cl[r] = cl;

  // every warp's partial goes straight to rank 0's shared memory
  acc.select_warp();
  if constexpr (kSum) acc.sum_warp();
  cluster_wait();
  if (lane == 0) acc.store(*cluster.map_shared_rank(&parts[rank * kWarps + warp], 0));
  cluster_sync();  // every partial is in rank 0's shared memory
  if (rank != 0 || warp != 0) return;

  // rank 0, warp 0: lane l folds partials 2l and 2l + 1, then the warp
  const int n = a.C * kWarps;
  acc.clear();
  if (2 * lane < n) acc.load(parts[2 * lane]);
  if (2 * lane + 1 < n) acc.fold(parts[2 * lane + 1]);
  acc.select_warp();
  if constexpr (kSum) {
    acc.sum_warp();
    if (lane == 0) {
      a.out_i[r] = acc.i[0];
      a.out_m[r] = acc.m;
      a.out_s[r] = acc.s;
    }
  } else if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      a.out_v[(size_t)r * K + j] = acc.v[j];
      a.out_i[(size_t)r * K + j] = acc.i[j];
    }
  }
}

// Launch R rows in clusters of C CTAs.  Returns a cudaError_t (0 = success).
template <typename T, int K, bool kSum>
int launch_rows(const RowArgs& a, int R, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)R * (unsigned)a.C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, row_reduce_kernel<T, K, kSum>, a);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller raises
  return (int)err;
}

// Shared checks of a launch's plan and row geometry.
inline bool plan_ok(const RowArgs& a, int R) {
  return R > 0 && a.V > 0 && a.T1 > 0 && R % a.T1 == 0 && a.C >= 1 && a.C <= kMaxCluster &&
         a.per > 0 && (long long)a.C * a.per >= a.V;
}

}  // namespace
}  // namespace rowred
