// Split-key flash-decode attention for Hopper (sm_90a), shared by the paged
// kernel (paged_attention.cu) and the contiguous-cache kernels
// (masked_attention.cu).
//
// Replaces the TPU kernels repro/kernels/attention.py:paged_flash_decode_pallas,
// masked_decode_attention_pallas and masked_tree_attention_pallas (bodies
// _paged_attn_kernel, _attn_kernel, _tree_attn_kernel): GQA attention of T
// queries per row over the row's cached keys under per-query validity masks,
// fp32 online softmax, fully masked query rows -> 0.
//
// What bounds it: the bytes of the K/V a row attends to.  Decode, verify and
// tree blocks do a few FLOPs per K/V byte, far below the H100's ~295
// FLOP/byte ridge, so the design's job is to keep enough bytes in flight:
//
// 1. Split over keys (flash-decoding).  The grid is (row tiles x key splits,
//    Hkv, B).  The split plan (kernels/attention.py:split_plan) depends on
//    (B, Hkv, S, bs) and the SM count only, never on T, so a query row meets
//    the same reduction order in a decode, a verify block and a tree block.
//    A CTA owns a chunk-aligned key range; with more than one split it writes
//    fp32 partials (m, l, acc[D]) to scratch and combine_kernel merges the
//    splits in split order (no atomics: bitwise the same from run to run).
//    With one split the CTA writes the output and no combine launches.
// 2. 16-byte loads, K/V kept in their own dtype.  A key's D values per KV
//    head are contiguous (128-512 B); a chunk of 32 keys is copied 16 bytes
//    per thread, neighbouring threads on neighbouring addresses, into shared
//    memory in the input dtype, converted to fp32 at use.  16-byte unit u of
//    key j is stored at unit u ^ swz(j % 8) of its row: the QK reads (4 lanes
//    per key, two keys per quarter-warp) and the PV reads are bank-conflict
//    free.
// 3. Asynchronous prefetch.  A ring of 3 chunk stages is filled with
//    cp.async (zero-fill past the block's end), so later chunks' bytes are on
//    their way while one is computed; one __syncthreads per chunk.  Which
//    chunks to copy is decided before any copy is issued: the CTA reads the
//    mask rows of its tile 16 bytes at a time over a window of up to kWin
//    chunks, turns them into one 32-bit word per (query t, chunk), and
//    compacts the chunks some row attends to into a list the ring walks.
// 4. Row tiles sized to T*g: a CTA holds kRows in {1, 2, 4, 5, 6, 8, 12,
//    16} query rows ((t, group head) pairs), the least that holds n_rows =
//    T*g (llama-2-7b: 1 for decode, 5 or 6 for a verify block, 12 for a 10-
//    or 11-node tree).  Inside the CTA the four warps split each
//    chunk's keys (warp w takes keys 8w..8w+7), not the rows: every warp
//    works on every chunk even for one query row.  Each warp keeps (m, l,
//    acc) for all rows of the tile and updates them in straight-line
//    phases over all rows, so the rows' dependent chains interleave.  The
//    shuffle unit is the scarce one, so a row's running max is reduced
//    over the warp's keys only when a vote says some score passed it, l is
//    kept per lane (summed once at the end) and the probabilities reach the
//    PV product through shared memory: two shuffles per row and chunk in
//    the steady state.  The warps are merged in warp order at the end.
// 5. No tensor cores.  llama-2-7b's decode, verify and tree tiles hold 1-12
//    query rows per (row, KV head), far below the ridge, and a query row
//    must get the same arithmetic in every tile.  Where mma.sync (m16n8k16)
//    would pay is the 16-row tile (tinyllama's 40-88-row blocks, prefill),
//    which phase 3 of chip_smoke.py shows compute-paced at long context;
//    that is left to a later change.  All arithmetic is fp32 with explicit
//    rounding (__fmaf_rn, __fadd_rn, ...), so a row's result does not
//    depend on the tile it sits in.
//
// Addressing.  Keys of a row are R blocks of bs slots; block rb of row b
// lives at pool block pid = table[b, rb] (kPaged, clamped to [0, P)) and slot
// s of it at K/V row pid * bs + s of a (P * bs, Hkv, D) tensor.  A contiguous
// (B, S, Hkv, D) cache is the same with an identity table: R = 1, bs = S,
// pid = b.  Chunks are 32 slots from each block's start, the last cut at the
// block's end; chunk c is (rb, off) = (c / cpb, 32 * (c % cpb)), cpb =
// ceil(bs / 32).  A split is a range of chunks, so contiguous rows split
// inside their single block.
//
// Layouts (all contiguous): q, out (B, T, H, D); mask (B, T, R * bs) bytes;
// table (B, R) int32, -1 = unallocated (clamped; its mask columns are 0);
// partials ml (B*T*H, splits, 2: max in log2 units, sum) and acc
// (B*T*H, splits, D) fp32.  fp32 accumulation; inputs fp32 or bf16; D in
// {64, 128}; q, k, v 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;        // keys per chunk: 8 per warp
constexpr int kKeysPerWarp = kChunk / kWarps;
constexpr int kWin = 32;          // chunks whose mask words are held at once
constexpr int kStages = 3;        // chunks in the prefetch ring

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// the 16 bytes of a unit as floats: 4 (fp32) or 8 (bf16)
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// swizzle of key j's 16-byte units: keys 2i and 2i+1 differ in bit 2
__device__ __forceinline__ int swz(int j) { return ((j & 1) << 2) | ((j >> 1) & 3); }

// 2^x in one MUFU op (the hardware's approximation; -inf -> 0, results
// below the normal range -> 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <typename T, int D, int kRows>
struct Smem {
  static constexpr int kUnits = D * (int)sizeof(T) / 16;       // 16-byte units per key
  static constexpr int kStageBytes = 2 * kChunk * kUnits * 16;  // K then V
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kMerge = kWarps * kRows * (D + 2) * 4;   // aliases the ring
  static constexpr int kRingBytes = kRing > kMerge ? kRing : kMerge;
  static constexpr int kQ = kRows * D * 4;
  static constexpr int kBits = kRows * kWin * 4;
  static constexpr int kP = kWarps * kRows * kKeysPerWarp * 4;  // probabilities
  static constexpr int kBytes = kRingBytes + kQ + kP + kBits + (kWin + 4 + kRows) * 4;
};

struct Args {
  const void* q; const void* k; const void* v; const int* table;
  const uint8_t* mask; void* out; float* ml; float* acc;
  int n_q, H, Hkv, P, bs, R, splits, cps;
  float scale;
};

template <typename T, int D, int kRows, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Args a) {
  using L = Smem<T, D, kRows>;
  constexpr int U = L::kUnits;
  constexpr int E = 16 / (int)sizeof(T);   // elements per unit
  constexpr int DV = D / 32;               // PV dims per lane
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + L::kRingBytes);
  float* pbuf = reinterpret_cast<float*>(smem + L::kRingBytes + L::kQ);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::kRingBytes + L::kQ + L::kP);
  int* act = reinterpret_cast<int*>(smem + L::kRingBytes + L::kQ + L::kP + L::kBits);
  int* roff = act + kWin + 4;  // row r's mask words: bits[roff[r] + chunk]

  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int g = a.H / a.Hkv, n_rows = a.n_q * g, row0 = tile * kRows;
  const int S = a.R * a.bs, cpb = (a.bs + kChunk - 1) / kChunk;
  const int c_lo = split * a.cps, c_hi = min(a.R * cpb, c_lo + a.cps);
  const int t_lo = row0 / g;
  const int nt = min(a.n_q, (row0 + kRows - 1) / g + 1) - t_lo;   // query tokens of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // scores in the log2 domain: softmax by exp2, scale * log2(e) folded into q
  const float qscale = __fmul_rn(a.scale, 1.4426950408889634f);
  {  // q rows of the tile, 16 bytes a load, all loads in flight at once
    constexpr int kQUnits = kRows * U, kQPer = (kQUnits + kThreads - 1) / kThreads;
    uint4 qv[kQPer];
#pragma unroll
    for (int x = 0; x < kQPer; ++x) {
      const int i = threadIdx.x + x * kThreads, r = row0 + i / U;
      qv[x] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kQUnits && r < n_rows) {
        const int t = r / g, h = kvh * g + r % g;
        qv[x] = *reinterpret_cast<const uint4*>(q + (((size_t)b * a.n_q + t) * a.H + h) * D + (i % U) * E);
      }
    }
#pragma unroll
    for (int x = 0; x < kQPer; ++x) {
      const int i = threadIdx.x + x * kThreads;
      if (i < kQUnits) {
        float f[E];
        unpack(qv[x], f, T());
#pragma unroll
        for (int e = 0; e < E; ++e) q_s[i * E + e] = __fmul_rn(f[e], qscale);
      }
    }
  }

  if (threadIdx.x < kRows) roff[threadIdx.x] = ((row0 + threadIdx.x) / g - t_lo) * kWin;

  float m_i[kRows], l_i[kRows], acc[kRows][DV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[r][i] = 0.f;
  }

  // chunk c -> (first K/V row of the chunk, keys in it)
  auto chunk_src = [&](int c, int& nk) -> size_t {
    const int rb = a.R == 1 ? 0 : (cpb == 1 ? c : c / cpb), off = (c - rb * cpb) * kChunk;
    nk = min(kChunk, a.bs - off);
    int pid = b;
    if constexpr (kPaged) {
      pid = a.table[b * a.R + rb];
      pid = pid < 0 ? 0 : (pid >= a.P ? a.P - 1 : pid);
    }
    return (size_t)pid * a.bs + off;
  };
  // thread i copies unit cu = i % U of keys cj0 + kStep * x (x < kHalf) of
  // K and of V; its 32-bit source offsets within a key row block and its
  // shared-memory offsets are the same for every chunk
  constexpr int kHalf = kChunk * U / kThreads, kStep = kThreads / U;
  const int cu = threadIdx.x % U, cj0 = threadIdx.x / U;
  const int src0 = (cj0 * a.Hkv + kvh) * D + cu * E, src_step = kStep * a.Hkv * D;
  const int first_key = kvh * D + cu * E;  // key 0: the address a cut-off copy names
  auto issue = [&](int c, int stage) {
    int nk;
    const size_t rbase = chunk_src(c, nk) * a.Hkv * D;
    unsigned char* st = ring + stage * L::kStageBytes;
#pragma unroll
    for (int x = 0; x < kHalf; ++x) {
      const int j = cj0 + kStep * x;
      const int off = j < nk ? src0 + x * src_step : first_key;
      const int n = j < nk ? 16 : 0;  // 0: zero-fill, read nothing
      unsigned char* dst = st + j * U * 16 + ((cu ^ swz(j & 7)) * 16);
      cp_async16(dst, kp + rbase + off, n);
      cp_async16(dst + kChunk * U * 16, vp + rbase + off, n);
    }
  };

  const int jl = lane >> 2, s4 = lane & 3, jk = warp * kKeysPerWarp + jl;
  const uint8_t* mask_b = a.mask + (size_t)b * a.n_q * S;

  for (int w0 = c_lo; w0 < c_hi; w0 += kWin) {
    const int wn = min(kWin, c_hi - w0);
    for (int i = threadIdx.x; i < kRows * kWin; i += kThreads) bits[i] = 0u;
    __syncthreads();
    // mask rows of the tile's tokens over the window's slots, 16 bytes a load
    int nk_last;
    chunk_src(w0 + wn - 1, nk_last);
    const int slot_lo = (w0 / cpb) * a.bs + (w0 % cpb) * kChunk;
    const int slot_hi = ((w0 + wn - 1) / cpb) * a.bs + ((w0 + wn - 1) % cpb) * kChunk + nk_last;
    const int n_groups = (slot_hi - slot_lo + 15) / 16 + 1;
    constexpr int kScanPer = 4;  // mask loads in flight per thread
    for (int i0 = 0; i0 < nt * n_groups; i0 += kScanPer * kThreads) {
      uint4 mv[kScanPer];
#pragma unroll
      for (int x = 0; x < kScanPer; ++x) {
        const int i = i0 + x * kThreads + threadIdx.x, tt = i / n_groups;
        mv[x] = make_uint4(0u, 0u, 0u, 0u);
        if (i < nt * n_groups) {
          const uint8_t* rowp = mask_b + (size_t)(t_lo + tt) * S;
          const uintptr_t first = reinterpret_cast<uintptr_t>(rowp + slot_lo) & ~(uintptr_t)15;
          const uint8_t* gp = reinterpret_cast<const uint8_t*>(first) + 16 * (i % n_groups);
          if (gp < rowp + slot_hi) mv[x] = *reinterpret_cast<const uint4*>(gp);
        }
      }
#pragma unroll
      for (int x = 0; x < kScanPer; ++x) {
        const int i = i0 + x * kThreads + threadIdx.x, tt = i / n_groups;
        if (i >= nt * n_groups || (mv[x].x | mv[x].y | mv[x].z | mv[x].w) == 0u) continue;
        const uint8_t* rowp = mask_b + (size_t)(t_lo + tt) * S;
        const uintptr_t first = reinterpret_cast<uintptr_t>(rowp + slot_lo) & ~(uintptr_t)15;
        const int s0 = (int)(reinterpret_cast<const uint8_t*>(first) + 16 * (i % n_groups) - rowp);
        const int sx = max(s0, slot_lo);
        int rb = sx / a.bs, o = sx - rb * a.bs;  // slot sx = block rb, offset o
        const uint32_t w4[4] = {mv[x].x, mv[x].y, mv[x].z, mv[x].w};
        int cur = -1;
        uint32_t word = 0u;
#pragma unroll
        for (int y = 0; y < 16; ++y) {
          const int s = s0 + y;
          if (s < sx || s >= slot_hi) continue;
          if ((w4[y >> 2] >> (8 * (y & 3))) & 0xffu) {
            const int c = rb * cpb + o / kChunk - w0;
            if (c != cur) {
              if (cur >= 0) atomicOr(&bits[tt * kWin + cur], word);
              cur = c;
              word = 0u;
            }
            word |= 1u << (o % kChunk);
          }
          if (++o == a.bs) {
            o = 0;
            ++rb;
          }
        }
        if (cur >= 0) atomicOr(&bits[tt * kWin + cur], word);
      }
    }
    __syncthreads();
    if (warp == 0) {  // compact the chunks some query of the tile attends to
      int n = 0;
      for (int c0 = 0; c0 < wn; c0 += 32) {
        const int c = c0 + lane;
        uint32_t any = 0u;
        if (c < wn)
          for (int tt = 0; tt < nt; ++tt) any |= bits[tt * kWin + c];
        const unsigned ball = __ballot_sync(0xffffffffu, any != 0u);
        if (any) act[n + __popc(ball & ((1u << lane) - 1u))] = c;
        n += __popc(ball);
      }
      if (lane == 0) act[kWin] = n;
    }
    __syncthreads();
    const int n_act = act[kWin];

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_act) issue(w0 + act[i], i);
      cp_async_commit();
    }
    for (int i = 0; i < n_act; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (i + kStages - 1 < n_act) issue(w0 + act[i + kStages - 1], (i + kStages - 1) % kStages);
      cp_async_commit();

      const int cc = act[i];
      const unsigned char* st = ring + (i % kStages) * L::kStageBytes;
      const unsigned char* k_st = st + jk * U * 16;
      // K: this lane's quarter of key jk (units s4, s4 + 4, ...), as fp32
      float kf[U / 4][E];
#pragma unroll
      for (int x = 0; x < U / 4; ++x)
        unpack(*reinterpret_cast<const uint4*>(k_st + (((s4 + 4 * x) ^ swz(jk & 7)) * 16)),
               kf[x], T());
      // V: this lane's DV dims of the warp's 8 keys
      float vreg[kKeysPerWarp][DV];
      {
        constexpr int kLaneBytes = DV * (int)sizeof(T);
        const int ub = lane * kLaneBytes, u = ub / 16, ob = ub % 16;
#pragma unroll
        for (int jj = 0; jj < kKeysPerWarp; ++jj) {
          const int j = warp * kKeysPerWarp + jj;
          const unsigned char* p = st + kChunk * U * 16 + j * U * 16 + ((u ^ swz(j & 7)) * 16) + ob;
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (kLaneBytes == 16) {
            raw = *reinterpret_cast<const uint4*>(p);
          } else if constexpr (kLaneBytes == 8) {
            const uint2 h = *reinterpret_cast<const uint2*>(p);
            raw.x = h.x;
            raw.y = h.y;
          } else {
            raw.x = *reinterpret_cast<const uint32_t*>(p);
          }
          float f[E];
          unpack(raw, f, T());
#pragma unroll
          for (int d = 0; d < DV; ++d) vreg[jj][d] = f[d];
        }
      }
      // Every row of the tile in straight-line phases, so the rows' FMA
      // and shuffle chains interleave.  A row with none of this warp's keys
      // (or past n_rows: its mask words are 0) gets p = 0 and a rescale
      // factor of exactly 1, which leaves its state bit for bit as it was.
      // 1. scores: this lane's quarter of key jk's dot product, summed over
      //    the key's four lanes
      float sc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qr = q_s + r * D;
        float dot = 0.f;
#pragma unroll
        for (int x = 0; x < U / 4; ++x) {
          const float4* q4 = reinterpret_cast<const float4*>(qr + (s4 + 4 * x) * E);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qv = q4[e4];
            dot = __fmaf_rn(qv.x, kf[x][4 * e4], dot);
            dot = __fmaf_rn(qv.y, kf[x][4 * e4 + 1], dot);
            dot = __fmaf_rn(qv.z, kf[x][4 * e4 + 2], dot);
            dot = __fmaf_rn(qv.w, kf[x][4 * e4 + 3], dot);
          }
        }
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 1));
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 2));
        sc[r] = (bits[roff[r] + cc] >> jk) & 1u ? dot : -INFINITY;
      }
      // 2. the warp's new running max, reduced over the 8 keys only when
      //    some score passes the old one, and then l and acc rescaled to it
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (__any_sync(0xffffffffu, sc[r] > m_i[r])) {  // warp-uniform
          float mc = sc[r];
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 4));
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 8));
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 16));
          const float m_new = fmaxf(m_i[r], mc);
          const float f = m_i[r] == -INFINITY ? 0.f : fast_exp2(m_i[r] - m_new);
          l_i[r] = __fmul_rn(l_i[r], f);
#pragma unroll
          for (int d = 0; d < DV; ++d) acc[r][d] = __fmul_rn(acc[r][d], f);
          m_i[r] = m_new;
        }
      }
      // 3. probabilities and this lane's share of l; the 8 keys'
      //    probabilities go to shared memory for the PV product
      float* pw = pbuf + warp * kRows * kKeysPerWarp;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sc[r] == -INFINITY ? 0.f : fast_exp2(sc[r] - m_i[r]);
        l_i[r] = __fadd_rn(l_i[r], p);
        if (s4 == 0) pw[r * kKeysPerWarp + jl] = p;
      }
      __syncwarp();
      // 4. acc += P V over the warp's 8 keys
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p0 = reinterpret_cast<const float4*>(pw + r * kKeysPerWarp)[0];
        const float4 p1 = reinterpret_cast<const float4*>(pw + r * kKeysPerWarp)[1];
        const float pj[kKeysPerWarp] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int jj = 0; jj < kKeysPerWarp; ++jj)
#pragma unroll
          for (int d = 0; d < DV; ++d) acc[r][d] = __fmaf_rn(pj[jj], vreg[jj][d], acc[r][d]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // merge the four warps' states per row, in warp order
  float* mw = reinterpret_cast<float*>(ring);             // [warp][row]
  float* lw = mw + kWarps * kRows;                        // [warp][row]
  float* aw = lw + kWarps * kRows;                        // [warp][row][D]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // each lane holds the l of its key: sum the warp's 8 keys
    float l = l_i[r];
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 4));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 8));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 16));
    if (lane == 0) {
      mw[warp * kRows + r] = m_i[r];
      lw[warp * kRows + r] = l;
    }
#pragma unroll
    for (int d = 0; d < DV; ++d) aw[(warp * kRows + r) * D + lane * DV + d] = acc[r][d];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, rr = row0 + r;
    if (rr >= n_rows) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mw[w * kRows + r]);
    float Ls = 0.f, As = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mv = mw[w * kRows + r];
      const float e = mv == -INFINITY ? 0.f : fast_exp2(mv - M);
      Ls = __fmaf_rn(lw[w * kRows + r], e, Ls);
      As = __fmaf_rn(aw[(w * kRows + r) * D + d], e, As);
    }
    const int t = rr / g, h = kvh * g + rr % g;
    const size_t orow = ((size_t)b * a.n_q + t) * a.H + h;
    if (a.splits == 1) {
      const float inv = Ls > 0.f ? 1.f / Ls : 0.f;
      store_f32(static_cast<T*>(a.out) + orow * D + d, __fmul_rn(As, inv));
    } else {
      a.acc[(orow * a.splits + split) * D + d] = As;
      if (d == 0) {
        a.ml[(orow * a.splits + split) * 2] = M;
        a.ml[(orow * a.splits + split) * 2 + 1] = Ls;
      }
    }
  }
}

// Merge the key splits of each query row, in split order: one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ml, const float* __restrict__ acc,
               T* __restrict__ out, int n_out_rows, int splits) {
  constexpr int DV = D / 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n_out_rows) return;
  const float* mlr = ml + (size_t)row * splits * 2;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, mlr[2 * s]);
  float Ls = 0.f, As[DV];
#pragma unroll
  for (int d = 0; d < DV; ++d) As[d] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float mv = mlr[2 * s];
    const float e = mv == -INFINITY ? 0.f : fast_exp2(mv - M);
    Ls = __fmaf_rn(mlr[2 * s + 1], e, Ls);
    const float* ar = acc + ((size_t)row * splits + s) * D + lane * DV;
#pragma unroll
    for (int d = 0; d < DV; ++d) As[d] = __fmaf_rn(ar[d], e, As[d]);
  }
  const float inv = Ls > 0.f ? 1.f / Ls : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d) store_f32(out + (size_t)row * D + lane * DV + d, __fmul_rn(As[d], inv));
}

template <typename T, int D, int kRows, bool kPaged>
int launch_rows(const Args& a, int B, cudaStream_t stream) {
  constexpr int kBytes = Smem<T, D, kRows>::kBytes;
  auto* kernel = flash_decode_kernel<T, D, kRows, kPaged>;
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != 0) return attr;
  const int n_rows = a.n_q * (a.H / a.Hkv);
  dim3 grid(((n_rows + kRows - 1) / kRows) * a.splits, a.Hkv, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(a);
  int err = (int)cudaGetLastError();
  if (err != 0 || a.splits == 1) return err;
  const int n_out = B * a.n_q * a.H;
  combine_kernel<T, D><<<(n_out + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      a.ml, a.acc, static_cast<T*>(a.out), n_out, a.splits);
  return (int)cudaGetLastError();
}

// Row tile from n_rows = T*g (kernels/attention.py:ROW_TILES): the least
// of 1, 2, 4, 5, 6, 8, 12 and 16 that holds them, else 16.
template <typename T, int D, bool kPaged>
int launch_tiles(const Args& a, int B, cudaStream_t stream) {
  const int n_rows = a.n_q * (a.H / a.Hkv);
  if (n_rows <= 1) return launch_rows<T, D, 1, kPaged>(a, B, stream);
  if (n_rows <= 2) return launch_rows<T, D, 2, kPaged>(a, B, stream);
  if (n_rows <= 4) return launch_rows<T, D, 4, kPaged>(a, B, stream);
  if (n_rows <= 5) return launch_rows<T, D, 5, kPaged>(a, B, stream);
  if (n_rows <= 6) return launch_rows<T, D, 6, kPaged>(a, B, stream);
  if (n_rows <= 8) return launch_rows<T, D, 8, kPaged>(a, B, stream);
  if (n_rows <= 12) return launch_rows<T, D, 12, kPaged>(a, B, stream);
  return launch_rows<T, D, 16, kPaged>(a, B, stream);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for an unsupported dtype, head dim or split plan.
template <bool kPaged>
int launch(const Args& a, int B, int D, int dtype, cudaStream_t stream) {
  if (B <= 0 || a.n_q <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.bs <= 0 || a.R <= 0 ||
      a.splits <= 0 || a.cps <= 0 || (a.splits > 1 && (a.ml == nullptr || a.acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return launch_tiles<float, 64, kPaged>(a, B, stream);
  if (dtype == 0 && D == 128) return launch_tiles<float, 128, kPaged>(a, B, stream);
  if (dtype == 1 && D == 64) return launch_tiles<__nv_bfloat16, 64, kPaged>(a, B, stream);
  if (dtype == 1 && D == 128) return launch_tiles<__nv_bfloat16, 128, kPaged>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
