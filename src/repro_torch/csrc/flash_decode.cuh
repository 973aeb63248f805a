// Flash-decode attention core shared by the paged kernel
// (paged_attention.cu) and the contiguous-cache kernels (masked_attention.cu).
//
// One CTA owns (batch row, KV head, tile of 16 query rows = (t, group head)
// pairs).  It walks the row's keys in 32-key chunks, stages each chunk of K
// and V in shared memory once for all of its query rows, and keeps an fp32
// online softmax (m, l, acc) per query row.  Chunks that no query row of the
// CTA attends to are skipped without touching K/V.  Fully masked query rows
// return 0.
//
// Addressing.  Keys of a row are R blocks of bs slots; block rb of row b
// lives at pool block pid = table[b, rb] (kPaged) and slot s of it at K/V
// row pid * bs + s of a (P * bs, Hkv, D) tensor.  A contiguous (B, S, Hkv, D)
// cache is the same thing with an identity table: R = 1, bs = S, pid = b
// (kPaged = false, no table read).  The last chunk of a block is cut to the
// block's end, so S needs no padding.
//
// Layouts (all contiguous): q, out (B, T, H, D); mask (B, T, R * bs) bytes;
// table (B, R) int32, -1 = unallocated (clamped; its mask columns are 0).
// fp32 accumulation; inputs fp32 or bf16; D in {64, 128}.

#pragma once

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

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
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
    int pid = b;
    if constexpr (kPaged) {
      pid = table[b * R + rb];
      pid = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
    }
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

template <typename T, int D, bool kPaged>
void launch(const void* q, const void* k, const void* v, const void* table,
            const void* mask, void* out, int B, int n_q, int H, int Hkv, int P,
            int bs, int R, float scale, cudaStream_t stream) {
  const int n_rows = n_q * (H / Hkv);
  dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, Hkv, B);
  flash_decode_kernel<T, D, kPaged><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(table), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), n_q, H, Hkv, P, bs, R, scale);
}

}  // namespace
