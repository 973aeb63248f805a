// Vocabulary-row reductions for Hopper (sm_90a): one body for the verify row
// statistics, the tree-draft top-k, the softmax statistics and the DTV of
// the SimScore probe (entry points in row_kernels.cu).
//
// Replaces the TPU kernels repro/kernels/verify.py:verify_stats_pallas (body
// _verify_kernel) and topk_pallas (_topk_kernel, _select_topk): per logits
// row, in one read of the row, the top K entries under the total order
// (value descending, index ascending) -- K = 1 is the argmax with ties to the
// first maximal index, as jnp.argmax -- and, for the statistics, the row max,
// the sumexp rescaled to it and the logit at the row's candidate token; and
// repro/kernels/dtv.py:softmax_stats (_stats_kernel) and dtv_pallas
// (_dtv_kernel): per row (max, sumexp), and per row pair 0.5 * sum |softmax(a)
// - softmax(b)| (paper Eq. 5), which the TPU computes in three launches.
//
// What bounds it: one read of the (R, V) logits (of both (R, V) inputs for
// DTV).  There is no matrix product; a few operations per element.  The main
// path has few rows (4-20 rows of V = 32000 to verify, 1 or 4 row pairs per
// probe), so one CTA per row would leave most of the 132 SMs idle and walk
// each row in one long chain of loads.  The design:
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
// 5. DTV in one launch (row_dtv_kernel).  Cluster r owns row r of a and of
//    b, cut into the same C slices.  Pass 1 reduces the CTA's slice of both
//    rows to (max, sumexp) partials as above; lane c of each warp stores the
//    warp's partials into CTA c's shared memory, and after one cluster
//    barrier every warp of every CTA merges the same C * 8 partials in
//    (rank, warp) order, so every CTA holds the same normalizers.  Pass 2
//    sums |e^(a - ma) / sa - e^(b - mb) / sb| over the slice in the same
//    per-thread order, and the warp sums meet in rank 0 after a second
//    barrier; rank 0 writes 0.5 * sum.  Two cluster barriers, no atomics,
//    no global scratch.  Pass 2 reads no logit from device memory again
//    where a slice is one batch per thread (launch_dtv picks this from the
//    plan): the units loaded in pass 1 stay in registers across the
//    barrier (every fp32 row up to V = 65536 at C = 8, bf16 up to 131072:
//    the probe's V = 32000).  Longer slices (V = 151936 and 262144, fp32
//    and bf16) are read again from L2, where the pair (at most 2 MB) still
//    lies; keeping them in shared memory instead measured no faster on the
//    H100.  Where the two rows' slices start at different 16-byte phases
//    (rows of odd length or strided views whose phases differ), unit k of
//    a and of b would hold different columns, so pass 2 goes column by
//    column from L2.  Both ways visit each thread's units in the same
//    order, so the result does not depend on the way.
//
// Rows: row r of R starts at element (r / T1) * sb + (r % T1) * st of x, so
// a (R, V) matrix with row stride st (T1 = R, sb = 0) and a (B, T1, V) view
// with batch and row strides (sb, st) are both read in place (the softmax
// statistics and DTV take (R, V) rows with any row stride); the column
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

// (m, s) <- (m, s) (+) (pm, ps): the same bits whichever side is which.
// An empty side (max -inf, sum 0) adds e^-inf * 0 = 0.
__device__ __forceinline__ void merge_stat(float& m, float& s, float pm, float ps) {
  const float mn = fmaxf(m, pm);
  if (mn == -INFINITY) return;  // nothing but -inf so far
  s = __fadd_rn(__fmul_rn(s, exp_below(m, mn)), __fmul_rn(ps, exp_below(pm, mn)));
  m = mn;
}

// a warp-wide sum in a fixed xor tree, in every lane
__device__ __forceinline__ float warp_add(float t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
  return t;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The warp's sumexp at its max mx, in every lane: each lane's (m, s)
// rescaled to mx, then a fixed xor tree.
__device__ __forceinline__ float warp_sum_at(float mx, float m, float s) {
  return warp_add(mx == -INFINITY ? 0.f : __fmul_rn(s, exp_below(m, mx)));
}

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

  __device__ __forceinline__ void merge_sum(float pm, float ps) { merge_stat(m, s, pm, ps); }

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
    s = warp_sum_at(v[0], m, s);
    m = v[0];
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

// One batch: NB 16-byte units per thread, unit j of thread t at unit
// index (b * NB + j) * kThreads + t of the slice's aligned part.
template <int NB>
__device__ __forceinline__ void load_batch(const uint4* __restrict__ p, int n_units, int b,
                                           uint4 (&u)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int k = (b * NB + j) * kThreads + threadIdx.x;
    u[j] = k < n_units ? __ldg(p + k) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A batch whose largest element is bmax into (m, s): the sum rescaled once
// to the new running max, then each element added in index order.
template <typename T>
__device__ __forceinline__ void sum_batch(const uint4 (&u)[kBatch], int n_units, int b,
                                          float bmax, float& m, float& s) {
  constexpr int E = Elt<T>::kPerUnit;
  const float mn = fmaxf(m, bmax);
  if (mn == -INFINITY) return;
  float t = __fmul_rn(s, exp_below(m, mn));
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = (b * kBatch + j) * kThreads + threadIdx.x;
    if (k < n_units) {
      float f[E];
      Elt<T>::unpack(u[j], f);
#pragma unroll
      for (int e = 0; e < E; ++e) t = __fadd_rn(t, exp_below(f[e], mn));
    }
  }
  m = mn;
  s = t;
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
  if constexpr (kSum) sum_batch<T>(u, n_units, b, bmax, acc.m, acc.s);
}

// The columns [lo, hi) of one CTA in a row: the part before the first
// 16-byte aligned address (the head, fewer than one unit), n_units 16-byte
// units from a0, and the tail [a1, hi).  Thread t reads head column lo + t
// and tail column a1 + t where they exist.
template <typename T>
struct Slice {
  const T* row;
  int lo, hi, a0, a1, n_units;

  __device__ Slice(const T* r, int l, int h) : row(r), lo(l), hi(h) {
    constexpr int E = Elt<T>::kPerUnit;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(row + lo);
    a0 = min(hi, lo + (int)(((16u - (addr & 15u)) & 15u) / sizeof(T)));
    n_units = (hi - a0) / E;
    a1 = a0 + n_units * E;
  }
  __device__ const uint4* units() const { return reinterpret_cast<const uint4*>(row + a0); }
  __device__ int n_batches() const { return (n_units + kBatch * kThreads - 1) / (kBatch * kThreads); }
  __device__ bool head() const { return lo + (int)threadIdx.x < a0; }
  __device__ bool tail() const { return a1 + (int)threadIdx.x < hi; }
};

// Columns [lo, hi) of a row into this thread's partial: the unaligned head
// one element per thread, the 16-byte aligned body in batches with the next
// batch's loads in flight, then the unaligned tail.  Each thread meets its
// columns in increasing order.  ``issued`` runs once the first batch's
// loads are out.
template <typename T, int K, bool kSum, typename F>
__device__ void reduce_slice(const T* __restrict__ row, int lo, int hi, RowAcc<K, kSum>& acc,
                             F&& issued) {
  const Slice<T> sl(row, lo, hi);
  const int a0 = sl.a0, a1 = sl.a1, n_units = sl.n_units;
  const int t = threadIdx.x;
  // the head and tail elements' loads go out with the first batch's
  const bool head = sl.head(), tail = sl.tail();
  const float hx = head ? Elt<T>::load(row + lo + t) : 0.f;
  const float tx = tail ? Elt<T>::load(row + a1 + t) : 0.f;
  const uint4* p = sl.units();
  const int n_batches = sl.n_batches();
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
template <typename Args>
int launch_clusters(void (*kernel)(Args), const Args& a, int R, int C, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)R * (unsigned)C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller raises
  return (int)err;
}

template <typename T, int K, bool kSum>
int launch_rows(const RowArgs& a, int R, cudaStream_t stream) {
  return launch_clusters(row_reduce_kernel<T, K, kSum>, a, R, a.C, stream);
}

// Shared checks of a launch's plan and row geometry.
inline bool plan_ok(const RowArgs& a, int R) {
  return R > 0 && a.V > 0 && a.T1 > 0 && R % a.T1 == 0 && a.C >= 1 && a.C <= kMaxCluster &&
         a.per > 0 && (long long)a.C * a.per >= a.V;
}


// ---------------------------------------------------------------------------
// Softmax statistics (row_softmax_kernel) and DTV (row_dtv_kernel)
// ---------------------------------------------------------------------------
// Both run pass 1 of the statistics above with no top-k list: each thread's
// (max, sumexp) in index order with a running max per batch, a xor tree per
// warp, the cluster's warp partials merged in (rank, warp) order.  On the
// same rows and plan their (max, sumexp) are the verify statistics' bits.

constexpr int kRereadBatch = 4;  // units per thread per batch when pass 2 re-reads

struct PairArgs {
  const void* a;      // rows, fp32 or bf16 (the statistics' input)
  const void* b;      // the other distribution's rows (DTV)
  float* out;         // (R,) DTV
  float* out_m;       // (R,) max (statistics)
  float* out_s;       // (R,) sumexp (statistics)
  int V;              // row length
  long long sa, sb;   // row strides of a and b, elements
  int C, per;         // CTAs per row (the cluster), columns per CTA
};

template <typename T>
__device__ __forceinline__ float batch_max(const uint4 (&u)[kBatch], int n_units, int b) {
  constexpr int E = Elt<T>::kPerUnit;
  float bmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = (b * kBatch + j) * kThreads + threadIdx.x;
    if (k < n_units) {
      float f[E];
      Elt<T>::unpack(u[j], f);
#pragma unroll
      for (int e = 0; e < E; ++e) bmax = fmaxf(bmax, f[e]);
    }
  }
  return bmax;
}

// This thread's head and tail elements of a slice (-inf where it has none).
template <typename T>
__device__ __forceinline__ void slice_ends(const Slice<T>& sl, float& hx, float& tx) {
  hx = sl.head() ? Elt<T>::load(sl.row + sl.lo + threadIdx.x) : -INFINITY;
  tx = sl.tail() ? Elt<T>::load(sl.row + sl.a1 + threadIdx.x) : -INFINITY;
}

// Pass 1 over a slice held in one batch (u, loaded): head, batch, tail.
template <typename T>
__device__ __forceinline__ void stat_one_batch(const Slice<T>& sl, float hx, float tx,
                                               const uint4 (&u)[kBatch], float& m, float& s) {
  m = -INFINITY;
  s = 0.f;
  if (sl.head()) merge_stat(m, s, hx, 1.f);
  sum_batch<T>(u, sl.n_units, 0, batch_max<T>(u, sl.n_units, 0), m, s);
  if (sl.tail()) merge_stat(m, s, tx, 1.f);
}

// Pass 1 over a slice of any length: the batches stream with the next one's
// loads in flight.
template <typename T>
__device__ void stat_slice(const Slice<T>& sl, float& hx, float& tx, float& m, float& s) {
  slice_ends(sl, hx, tx);
  const uint4* p = sl.units();
  uint4 cur[kBatch];
  load_batch(p, sl.n_units, 0, cur);
  m = -INFINITY;
  s = 0.f;
  if (sl.head()) merge_stat(m, s, hx, 1.f);
  const int n_batches = sl.n_batches();
  for (int b = 0; b < n_batches; ++b) {
    uint4 nxt[kBatch];
    load_batch(p, sl.n_units, b + 1, nxt);  // nothing past the last batch
    sum_batch<T>(cur, sl.n_units, b, batch_max<T>(cur, sl.n_units, b), m, s);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) cur[j] = nxt[j];
  }
  if (sl.tail()) merge_stat(m, s, tx, 1.f);
}

// The cluster's n warp partials (m, s) in (rank, warp) order, merged as the
// verify statistics merge theirs: lane l folds partials 2l and 2l + 1, then
// the warp.  Every lane returns the row's (max, sumexp).
__device__ __forceinline__ float2 merge_parts(const float2* parts, int n) {
  const int lane = threadIdx.x % 32;
  float m = -INFINITY, s = 0.f;
  if (2 * lane < n) {
    m = parts[2 * lane].x;
    s = parts[2 * lane].y;
  }
  if (2 * lane + 1 < n) merge_stat(m, s, parts[2 * lane + 1].x, parts[2 * lane + 1].y);
  const float mx = warp_max(m);
  return make_float2(mx, warp_sum_at(mx, m, s));
}

// Grid: R * C CTAs in clusters of C along x; cluster r reduces row r of a
// to (max, sumexp).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) row_softmax_kernel(const PairArgs a) {
  cluster_arrive_relaxed();  // once all arrived, every CTA of the cluster runs
  __shared__ float2 parts[kMaxCluster * kWarps];  // rank 0's: (rank, warp)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / a.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = min(a.V, rank * a.per), hi = min(a.V, lo + a.per);
  const Slice<T> sl(static_cast<const T*>(a.a) + (long long)r * a.sa, lo, hi);
  float hx, tx, m, s;
  stat_slice(sl, hx, tx, m, s);
  const float mx = warp_max(m);
  s = warp_sum_at(mx, m, s);
  cluster_wait();
  if (lane == 0) *cluster.map_shared_rank(&parts[rank * kWarps + warp], 0) = make_float2(mx, s);
  cluster_sync();  // every partial is in rank 0's shared memory
  if (rank != 0 || warp != 0) return;
  const float2 row = merge_parts(parts, a.C * kWarps);
  if (lane == 0) {
    a.out_m[r] = row.x;
    a.out_s[r] = row.y;
  }
}

// Pass 2's normalizers: e^(x - ma) * ia is softmax(a) at x, likewise for b.
struct Norm {
  float ma, ia, mb, ib;
  __device__ __forceinline__ float diff(float x, float y) const {
    return fabsf(__fsub_rn(__fmul_rn(exp_below(x, ma), ia), __fmul_rn(exp_below(y, mb), ib)));
  }
};

// |softmax(a) - softmax(b)| over one batch of paired units, added to t in
// index order.
template <typename T, int NB>
__device__ __forceinline__ void diff_batch(const uint4 (&ua)[NB], const uint4 (&ub)[NB],
                                           int n_units, int b, const Norm& nm, float& t) {
  constexpr int E = Elt<T>::kPerUnit;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int k = (b * NB + j) * kThreads + threadIdx.x;
    if (k < n_units) {
      float fa[E], fb[E];
      Elt<T>::unpack(ua[j], fa);
      Elt<T>::unpack(ub[j], fb);
#pragma unroll
      for (int e = 0; e < E; ++e) t = __fadd_rn(t, nm.diff(fa[e], fb[e]));
    }
  }
}

// Grid: R * C CTAs in clusters of C along x; cluster r computes
// 0.5 * sum |softmax(a_r) - softmax(b_r)| over slices of both rows.  With
// kInRegisters (a slice is one batch per thread) pass 1's units wait in
// registers for pass 2 when the two slices have the same 16-byte phase (so
// unit k of a and unit k of b hold the same columns); else pass 2 re-reads.
template <typename T, bool kInRegisters>
__global__ void __launch_bounds__(kThreads, 2) row_dtv_kernel(const PairArgs a) {
  cluster_arrive_relaxed();
  __shared__ float2 stat_a[kMaxCluster * kWarps];  // every CTA's: (rank, warp)
  __shared__ float2 stat_b[kMaxCluster * kWarps];
  __shared__ float sums[kMaxCluster * kWarps];     // rank 0's: pass 2 partials
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / a.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = min(a.V, rank * a.per), hi = min(a.V, lo + a.per);
  const Slice<T> sla(static_cast<const T*>(a.a) + (long long)r * a.sa, lo, hi);
  const Slice<T> slb(static_cast<const T*>(a.b) + (long long)r * a.sb, lo, hi);
  const bool paired = sla.a0 == slb.a0;

  // pass 1: both rows' (max, sumexp) partials
  float hxa, txa, hxb, txb, ma, sa, mb, sb;
  uint4 ua[kBatch], ub[kBatch];  // kInRegisters: the whole slices
  if constexpr (kInRegisters) {
    slice_ends(sla, hxa, txa);
    slice_ends(slb, hxb, txb);
    load_batch(sla.units(), sla.n_units, 0, ua);  // every load out before any sum
    load_batch(slb.units(), slb.n_units, 0, ub);
    stat_one_batch(sla, hxa, txa, ua, ma, sa);
    stat_one_batch(slb, hxb, txb, ub, mb, sb);
  } else {
    stat_slice(sla, hxa, txa, ma, sa);
    stat_slice(slb, hxb, txb, mb, sb);
  }
  {
    const float wa = warp_max(ma), wb = warp_max(mb);
    sa = warp_sum_at(wa, ma, sa);
    sb = warp_sum_at(wb, mb, sb);
    ma = wa;
    mb = wb;
  }

  // merge: lane c stores the warp's partials into CTA c; after one cluster
  // barrier every warp of every CTA merges the same list in the same order
  cluster_wait();
  if (lane < a.C) {
    *cluster.map_shared_rank(&stat_a[rank * kWarps + warp], lane) = make_float2(ma, sa);
    *cluster.map_shared_rank(&stat_b[rank * kWarps + warp], lane) = make_float2(mb, sb);
  }
  cluster_sync();
  const int n = a.C * kWarps;
  const float2 ra = merge_parts(stat_a, n), rb = merge_parts(stat_b, n);
  const Norm nm{ra.x, __frcp_rn(ra.y), rb.x, __frcp_rn(rb.y)};

  // pass 2: this thread's sum of |p - q| in index order
  float t = 0.f;
  if (paired) {
    if (sla.head()) t = __fadd_rn(t, nm.diff(hxa, hxb));
    const int nu = sla.n_units;
    if constexpr (kInRegisters) {
      diff_batch<T>(ua, ub, nu, 0, nm, t);
    } else {  // re-read from L2 with the next batch in flight
      constexpr int NB = kRereadBatch;
      const int n_batches = (nu + NB * kThreads - 1) / (NB * kThreads);
      uint4 ca[NB], cb[NB];
      load_batch(sla.units(), nu, 0, ca);
      load_batch(slb.units(), nu, 0, cb);
      for (int b = 0; b < n_batches; ++b) {
        uint4 na[NB], nb[NB];
        load_batch(sla.units(), nu, b + 1, na);
        load_batch(slb.units(), nu, b + 1, nb);
        diff_batch<T>(ca, cb, nu, b, nm, t);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          ca[j] = na[j];
          cb[j] = nb[j];
        }
      }
    }
    if (sla.tail()) t = __fadd_rn(t, nm.diff(txa, txb));
  } else {  // different phases: column by column, re-read from L2
    for (int c = lo + threadIdx.x; c < hi; c += kThreads)
      t = __fadd_rn(t, nm.diff(Elt<T>::load(sla.row + c), Elt<T>::load(slb.row + c)));
  }
  t = warp_add(t);
  if (lane == 0) *cluster.map_shared_rank(&sums[rank * kWarps + warp], 0) = t;
  cluster_sync();  // every pass 2 partial is in rank 0's shared memory
  if (rank != 0 || warp != 0) return;
  float u = 2 * lane < n ? sums[2 * lane] : 0.f;
  if (2 * lane + 1 < n) u = __fadd_rn(u, sums[2 * lane + 1]);
  u = warp_add(u);
  if (lane == 0) a.out[r] = 0.5f * u;
}

// Checks of a pair launch's plan.
inline bool pair_plan_ok(const PairArgs& a, int R) {
  return R > 0 && a.V > 0 && a.C >= 1 && a.C <= kMaxCluster && a.per > 0 &&
         (long long)a.C * a.per >= a.V;
}

template <typename T>
int launch_softmax(const PairArgs& a, int R, cudaStream_t stream) {
  if (!pair_plan_ok(a, R)) return (int)cudaErrorInvalidValue;
  return launch_clusters(row_softmax_kernel<T>, a, R, a.C, stream);
}

// Pass 2 keeps the slices in registers where a CTA's slice is one batch
// per thread, else re-reads them.
template <typename T>
int launch_dtv(const PairArgs& a, int R, cudaStream_t stream) {
  if (!pair_plan_ok(a, R)) return (int)cudaErrorInvalidValue;
  if (a.per / Elt<T>::kPerUnit <= kBatch * kThreads)
    return launch_clusters(row_dtv_kernel<T, true>, a, R, a.C, stream);
  return launch_clusters(row_dtv_kernel<T, false>, a, R, a.C, stream);
}

}  // namespace
}  // namespace rowred
