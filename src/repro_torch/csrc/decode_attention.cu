// Flash decoding: one query token per sequence against its KV cache, with
// the G query heads of one kv head computed together.  Slots with
// slot <= pos are valid (a full ring cache, or a cache that never grew past
// its prompt, is all valid).  Optional int8 K/V with per-slot f32 scales.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_kernel, pallas_call at :105), whose sequential kv-block
// grid axis carried (m, l, acc) in VMEM scratch per (b, kv head).
//
// Bound on an H100: decoding reads the whole valid cache once for a handful
// of operations per byte, so device memory bandwidth bounds it: the least
// time is (q + valid K/V (+ scales) + o bytes) / 3.35 TB/s.
// Design: one block per (b, kv head); 4 warps share each tile of 32 cache
// slots, which the block loads once (int8 slots are dequantized with their
// per-slot scale in registers on the way into shared memory) and every
// query head of the group reads from shared memory.  Warp w owns query heads
// w, w + 4, ...; within a warp a lane scores one slot, the warp reduces max
// and sum with shuffles, and each lane accumulates hd/32 output dimensions.
// Only the valid prefix of the cache is streamed.  Split-K over the cache
// with a combine pass comes later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 32;                 // cache slots per tile: one per lane
constexpr int MAX_HD = 128;
constexpr int MAX_G = 16;              // query heads per kv head
constexpr int HPW = MAX_G / WARPS;     // heads per warp
constexpr int DPL = MAX_HD / 32;       // output dims per lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, TQ* __restrict__ o,
                        int H, int kvH, int Sc, int hd, int pos, float scale) {
  __shared__ float qs[MAX_G][MAX_HD];
  __shared__ float ks[BK][MAX_HD + 1];
  __shared__ float vs[BK][MAX_HD];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / kvH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool quantized = k_scale != nullptr;

  const TQ* qb = q + (static_cast<int64_t>(b) * H + kh * G) * hd;
  const int64_t cache_row = static_cast<int64_t>(b) * kvH + kh;
  const TKV* kb = k + cache_row * Sc * hd;
  const TKV* vb = v + cache_row * Sc * hd;
  TQ* ob = o + (static_cast<int64_t>(b) * H + kh * G) * hd;

  for (int i = threadIdx.x; i < G * hd; i += THREADS) qs[i / hd][i % hd] = to_f(qb[i]);

  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int r = 0; r < HPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }

  // slots <= pos are valid; a cache that is full (pos >= Sc) is all valid
  const int n_valid = pos < 0 ? 0 : min(Sc, pos + 1);
  for (int st = 0; st < n_valid; st += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < BK * hd; i += THREADS) {
      const int j = i / hd, d = i % hd;
      const int slot = st + j;
      float kx = 0.f, vx = 0.f;
      if (slot < n_valid) {
        const int64_t off = static_cast<int64_t>(slot) * hd + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
        if (quantized) {  // dequantize in registers with the slot's scale
          kx *= k_scale[cache_row * Sc + slot];
          vx *= v_scale[cache_row * Sc + slot];
        }
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    const bool valid = st + lane < n_valid;
#pragma unroll
    for (int r = 0; r < HPW; ++r) {
      const int g = warp + r * WARPS;
      if (g >= G) break;  // uniform across the warp
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[g][d], ks[lane][d], s);
      s *= scale;
      const float m_new = fmaxf(m[r], warp_max(valid ? s : NEG_INF));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[r][t] *= corr;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (d < hd) acc[r][t] = fmaf(pj, vs[j][d], acc[r][t]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < HPW; ++r) {
    const int g = warp + r * WARPS;
    if (g >= G) break;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) ob[static_cast<int64_t>(g) * hd + d] = from_f<TQ>(acc[r][t] * inv);
    }
  }
}

template <typename TQ, typename TKV>
void launch(const void* q, const void* k, const void* v, const float* ks,
            const float* vs, void* o, int B, int H, int kvH, int Sc, int hd,
            int pos, float scale, cudaStream_t s) {
  dim3 grid(kvH, B);
  decode_attention_kernel<TQ, TKV><<<grid, THREADS, 0, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, static_cast<TQ*>(o), H, kvH, Sc, hd,
      pos, scale);
}

template <typename TQ>
int dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                const float* ks, const float* vs, void* o, int B, int H,
                int kvH, int Sc, int hd, int pos, float scale, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: launch<TQ, float>(q, k, v, nullptr, nullptr, o, B, H, kvH, Sc, hd, pos, scale, s); break;
    case 1: launch<TQ, __nv_bfloat16>(q, k, v, nullptr, nullptr, o, B, H, kvH, Sc, hd, pos, scale, s); break;
    case 2:
      if (ks == nullptr || vs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      launch<TQ, int8_t>(q, k, v, ks, vs, o, B, H, kvH, Sc, hd, pos, scale, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale / v_scale required).
extern "C" int rt_decode_attention(int q_dtype, int kv_dtype, const void* q,
                                   const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   void* o, int B, int H, int kvH, int Sc,
                                   int hd, int pos, float scale, void* stream) {
  if (hd > MAX_HD || hd <= 0 || kvH <= 0 || H % kvH != 0 || H / kvH > MAX_G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (q_dtype == 0) {
    return dispatch_kv<float>(kv_dtype, q, k, v, ks, vs, o, B, H, kvH, Sc, hd, pos, scale, s);
  }
  if (q_dtype == 1) {
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, ks, vs, o, B, H, kvH, Sc, hd, pos, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
