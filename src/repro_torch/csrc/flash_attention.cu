// Causal (optionally sliding-window) flash attention with an online softmax
// in f32, for prefill.  GQA: query head h reads kv head h / (H / kvH).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, pallas_call at :92), whose sequential kv grid axis
// carried (m, l, acc) in VMEM scratch and which asserted that S divides into
// its blocks.
//
// Bound on an H100: at the serving path's prompts (S = 4..16, hd = 64) the
// work is a few MFLOP, so the least time is set by bytes (q, k, v read once,
// o written once) and the kernel is launch-bound.  At long S the bound is the
// f32 operations (4 * B * H * S^2 * hd / 2 causal, on CUDA cores).
// Design: one block per (b, h, tile of 16 query rows); 4 warps, each owning
// 4 rows.  The kv loop runs inside the block over tiles of 32 keys staged in
// shared memory, one key per lane: a lane computes its key's score from
// shared q and k rows (k rows padded by one float, so the 32 lanes hit 32
// banks), the warp reduces the tile's max and sum with shuffles, and each
// lane accumulates hd/32 output dimensions in registers.  Ragged tails are
// masked (rows and keys at or past S), never asserted away, and causal /
// window limits bound the kv loop.  Simple and exact first: wgmma and TMA
// come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16;               // query rows per block
constexpr int ROWS = BQ / WARPS;     // rows per warp
constexpr int BK = 32;               // keys per tile: one per lane
constexpr int MAX_HD = 128;
constexpr int DPL = MAX_HD / 32;     // output dims per lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int kvH, int S, int hd, int causal, int window,
                       float scale) {
  __shared__ float qs[BQ][MAX_HD];
  __shared__ float ks[BK][MAX_HD + 1];
  __shared__ float vs[BK][MAX_HD];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / kvH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qb = q + (static_cast<int64_t>(b) * H + h) * S * hd;
  const T* kb = k + (static_cast<int64_t>(b) * kvH + kh) * S * hd;
  const T* vb = v + (static_cast<int64_t>(b) * kvH + kh) * S * hd;
  T* ob = o + (static_cast<int64_t>(b) * H + h) * S * hd;

  for (int i = threadIdx.x; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    qs[r][d] = q0 + r < S ? to_f(qb[static_cast<int64_t>(q0 + r) * hd + d]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;  // exclusive
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % BK;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < BK * hd; i += THREADS) {
      const int j = i / hd, d = i % hd;
      const bool in = kt + j < S;
      const int64_t off = static_cast<int64_t>(kt + j) * hd + d;
      ks[j][d] = in ? to_f(kb[off]) : 0.f;
      vs[j][d] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = warp * ROWS + r;
      const int qpos = q0 + row;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[row][d], ks[lane][d], s);
      s *= scale;
      bool valid = kpos < S && qpos < S;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && qpos - kpos < window;
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
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= S) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) ob[static_cast<int64_t>(qpos) * hd + d] = from_f<T>(acc[r][t] * inv);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, int B, int H,
            int kvH, int S, int hd, int causal, int window, float scale,
            cudaStream_t s) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, kvH, S, hd, causal,
      window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
extern "C" int rt_flash_attention(int dtype, const void* q, const void* k,
                                  const void* v, void* o, int B, int H, int kvH,
                                  int S, int hd, int causal, int window,
                                  float scale, void* stream) {
  if (hd > MAX_HD || hd <= 0 || kvH <= 0 || H % kvH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, k, v, o, B, H, kvH, S, hd, causal, window, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, o, B, H, kvH, S, hd, causal, window, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
