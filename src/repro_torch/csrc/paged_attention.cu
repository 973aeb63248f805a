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
// is no gathered per-row view.
//
// Layouts (all contiguous): q, out (B, T, H, D); k_pool, v_pool (P*bs, Hkv, D);
// table (B, R) int32, -1 = unallocated (clamped, and masked by the caller);
// mask (B, T, R*bs) bytes.  fp32 accumulation; inputs fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunk = 32;  // keys staged per step: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ table,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       int n_q, int H, int Hkv, int P, int bs, int R, float scale) {
  constexpr int kDimsPerLane = D / 32;
  __shared__ float q_s[kRowsPerBlock][D];
  __shared__ float k_s[kChunk][D + 1];  // +1: lane j reads row j, no bank conflicts
  __shared__ float v_s[kChunk][D];

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = H / Hkv;
  const int n_rows = n_q * g;  // query rows of this (b, kvh): (t, group head)
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int S = R * bs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint8_t* mask_b = mask + (size_t)b * n_q * S;

  for (int i = threadIdx.x; i < kRowsPerBlock * D; i += kThreads) {
    const int lr = i / D, d = i % D, r = row0 + lr;
    float val = 0.f;
    if (r < n_rows) {
      const int t = r / g, h = kvh * g + r % g;
      val = to_f32(q[(((size_t)b * n_q + t) * H + h) * D + d]) * scale;
    }
    q_s[lr][d] = val;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m_i[j] = -INFINITY;
    l_i[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[j][i] = 0.f;
  }
  __syncthreads();

  for (int rb = 0; rb < R; ++rb) {
    int pid = table[b * R + rb];
    pid = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
    for (int c0 = 0; c0 < bs; c0 += kChunk) {
      const int s0 = rb * bs + c0;  // first row-local slot of the chunk
      const int nk = min(kChunk, bs - c0);
      int any = 0;
      for (int i = threadIdx.x; i < kRowsPerBlock * kChunk; i += kThreads) {
        const int r = row0 + i / kChunk, j = i % kChunk;
        if (r < n_rows && j < nk) any |= mask_b[(size_t)(r / g) * S + s0 + j];
      }
      if (!__syncthreads_or(any)) continue;  // block-uniform

      for (int i = threadIdx.x; i < kChunk * D; i += kThreads) {
        const int j = i / D, d = i % D;
        float kv = 0.f, vv = 0.f;
        if (j < nk) {
          const size_t off = (((size_t)pid * bs + c0 + j) * Hkv + kvh) * D + d;
          kv = to_f32(k_pool[off]);
          vv = to_f32(v_pool[off]);
        }
        k_s[j][d] = kv;
        v_s[j][d] = vv;
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int lr = j * kWarps + warp;  // interleaved: small T*g spreads over warps
        const int r = row0 + lr;
        if (r >= n_rows) continue;  // warp-uniform
        const bool ok = lane < nk && mask_b[(size_t)(r / g) * S + s0 + lane] != 0;
        float s = -INFINITY;
        if (ok) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += q_s[lr][d] * k_s[lane][d];
          s = dot;
        }
        const float m_c = warp_max(s);
        if (m_c == -INFINITY) continue;  // warp-uniform: no key for this row here
        const float m_new = fmaxf(m_i[j], m_c);
        const float corr = m_i[j] == -INFINITY ? 0.f : expf(m_i[j] - m_new);
        const float p = ok ? expf(s - m_new) : 0.f;
        l_i[j] = l_i[j] * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[j][i] *= corr;
#pragma unroll 8
        for (int jj = 0; jj < kChunk; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
          for (int i = 0; i < kDimsPerLane; ++i) acc[j][i] += pj * v_s[jj][lane + 32 * i];
        }
        m_i[j] = m_new;
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = row0 + j * kWarps + warp;
    if (r >= n_rows) continue;
    const int t = r / g, h = kvh * g + r % g;
    const float inv = l_i[j] > 0.f ? 1.f / l_i[j] : 0.f;
    T* o = out + (((size_t)b * n_q + t) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) store_f32(o + lane + 32 * i, acc[j][i] * inv);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* table,
            const void* mask, void* out, int B, int n_q, int H, int Hkv, int P,
            int bs, int R, float scale, cudaStream_t stream) {
  const int n_rows = n_q * (H / Hkv);
  dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, Hkv, B);
  paged_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(table), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), n_q, H, Hkv, P, bs, R, scale);
}

}  // namespace

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
    launch<float, 64>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else if (dtype == 0 && D == 128) {
    launch<float, 128>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else if (dtype == 1 && D == 64) {
    launch<__nv_bfloat16, 64>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else if (dtype == 1 && D == 128) {
    launch<__nv_bfloat16, 128>(q, k_pool, v_pool, table, mask, out, B, T, H, Hkv, P, bs, R, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
