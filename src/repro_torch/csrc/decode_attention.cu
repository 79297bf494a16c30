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
// time is (q + valid K/V (+ scales) + o bytes) / 3.35 TB/s.  No tensor
// cores: the work is a few FMAs per byte read.
// Design: split-K.  The valid prefix [0, n_valid) is cut into `splits`
// ranges of whole 64-slot tiles (the wrapper's split_plan picks the count so
// that about two blocks run per SM; one split for a cache of a tile or two),
// and one block of 4 warps handles one (split, kv head, b).  16-byte
// cp.async loads stage K and V tiles (and int8 scales) in a two-stage ring
// in shared memory, so the next tile's load overlaps this tile's math.
// Inside a tile the warps split the SLOTS (16 each), so that G = 1 keeps all
// four busy: two lanes score one slot for every query head of the group
// (half the head dim each), the warp keeps an online softmax per head, and
// each lane accumulates hd/32 output dims of every head.  int8 slots are
// dequantized in registers: the score and the softmax weight take the
// slot's K and V scale.  At the end the warps' (m, l, acc) combine through
// shared memory; with one split the block writes the output, otherwise it
// writes its partial (m, l, acc) and a second small kernel folds the splits.
// Head dims: compiled for 64, 128, 192 and 256 (the wrapper zero-pads any
// other up to 256).  Where two stages of f32 K and V tiles would pass a
// block's 227 KB of shared memory (hd 256), the ring has one stage and a
// tile's load waits for the previous tile's math.  At hd 256 the
// accumulators of 16 heads would pass 255 registers, so a group of 9-16
// heads goes to two blocks of at most 8 heads each (both read the cache).
// Above 256 a generic instance takes the head dim as a runtime argument (the
// reference blocks over the full head dim at any width): one block per
// (b, head, its one query row) walks the whole valid prefix in tiles of 32
// slots; each warp scores 8 slots, its lanes striding over the head dim (so
// the reduction runs in chunks of 256 per pass of a warp's 32 lanes x 8
// values), the online softmax runs on one warp, and the output accumulator
// (hd f32) lives in shared memory, each thread owning a column stride of it.
// int8 slots take their K scale on the score and their V scale on the
// weight, as in the compiled instances.  Simple: no split-K, no staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 64;             // cache slots per tile, 16 per warp
constexpr int SPW = BK / WARPS;    // slots per warp
constexpr int MAX_G = 16;          // query heads per kv head
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;   // the shared memory one block can have on sm_90

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // null unless the cache is int8
  const float* v_scale;
  void* o;
  float* part;           // splits > 1: acc (R, G, hd), then m (R, G), l (R, G); R = B kvH splits
  int H, kvH, Sc, n_valid, tiles_per_split, splits;
  int q_bf16;            // q and o: 0 float32, 1 bfloat16
  float scale_log2;      // softmax scale * log2(e): scores live in base 2
  int chunks = 1;        // blocks a group of heads is cut into, GB heads each
};

// The values packed in one 32-bit word of a K/V row, as floats.
template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int N = 1;
  __device__ static void unpack(uint32_t w, float* out) { out[0] = __uint_as_float(w); }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int N = 2;
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct Word<int8_t> {
  static constexpr int N = 4;
  __device__ static void unpack(uint32_t w, float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
  }
};

// N consecutive values of a row in shared memory (N * sizeof(T) bytes,
// aligned to the largest power of two up to 16 that divides their size) as
// floats, in vector loads of that size.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float* out) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  constexpr int C = BYTES % 16 == 0 ? 16 : BYTES % 8 == 0 ? 8 : BYTES % 4 == 0 ? 4 : 2;
  constexpr int VPL = C / static_cast<int>(sizeof(T));  // values per load
#pragma unroll
  for (int i = 0; i < BYTES / C; ++i) {
    const unsigned char* src = p + i * C;
    float* dst = out + i * VPL;
    if constexpr (C == 2) {  // two int8 values
      const uint32_t w = *reinterpret_cast<const uint16_t*>(src);
      float t[4];
      Word<T>::unpack(w, t);
      dst[0] = t[0];
      dst[1] = t[1];
    } else {
      uint32_t w[C / 4];
      if constexpr (C == 16) {
        const uint4 x = *reinterpret_cast<const uint4*>(src);
        w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
      } else if constexpr (C == 8) {
        const uint2 x = *reinterpret_cast<const uint2*>(src);
        w[0] = x.x; w[1] = x.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(src);
      }
#pragma unroll
      for (int j = 0; j < C / 4; ++j) Word<T>::unpack(w[j], dst + j * Word<T>::N);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename TKV, int HD, int GB>
struct Layout {
  static constexpr int ROW = HD * static_cast<int>(sizeof(TKV));
  static constexpr int KROW = ROW + 16;           // padded: a phase's 8 slots hit 8 bank quads
  static constexpr int PSTR = GB == 1 ? 1 : GB + 4;  // P row of one slot (padded)
  static constexpr int Q = GB * HD * 4;
  static constexpr int P = WARPS * SPW * PSTR * 4;
  static constexpr int SCALES = 2 * 2 * BK * 4;   // [stage][k, v][slot]
  static constexpr int TILE = BK * KROW;           // one K or V tile
  // ring stages: two where they fit beside the rest, else one (f32, hd 256)
  static constexpr int NST = Q + P + SCALES + 2 * 2 * TILE <= SMEM_MAX ? 2 : 1;
  static constexpr int RING = NST * 2 * TILE;      // [stage][k, v]
  static constexpr int COMB = WARPS * GB * (HD + 2) * 4;
  static constexpr int bytes = Q + P + SCALES + (RING > COMB ? RING : COMB);
  static_assert(bytes <= SMEM_MAX, "decode tiles exceed a block's shared memory");
};

template <typename TKV, int HD, int GB>
__device__ __forceinline__ void load_tile(unsigned char* ring, float* scales, int stage,
                                          const TKV* kg, const TKV* vg, const float* ksg,
                                          const float* vsg, int t, int t_end) {
  using L = Layout<TKV, HD, GB>;
  constexpr int CPR = L::ROW / 16;  // 16-byte chunks per row
  unsigned char* kd = ring + stage * 2 * L::TILE;
  unsigned char* vd = kd + L::TILE;
  for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool in = t + r < t_end;
    const long long off = static_cast<long long>(in ? t + r : 0) * HD;
    const int doff = r * L::KROW + c * 16;
    cp_async16(kd + doff, reinterpret_cast<const unsigned char*>(kg + off) + c * 16, in);
    cp_async16(vd + doff, reinterpret_cast<const unsigned char*>(vg + off) + c * 16, in);
  }
  if (ksg != nullptr) {
    const int r = threadIdx.x % BK;
    const bool in = t + r < t_end;
    const float* src = threadIdx.x < BK ? ksg : vsg;
    cp_async4(scales + (stage * 2 + threadIdx.x / BK) * BK + r, src + (in ? t + r : 0), in);
  }
}

__device__ __forceinline__ float load_q(const Params& p, long long i) {
  return p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[i])
                  : static_cast<const float*>(p.q)[i];
}
__device__ __forceinline__ void store_o(const Params& p, long long i, float x) {
  if (p.q_bf16) {
    static_cast<__nv_bfloat16*>(p.o)[i] = __float2bfloat16(x);
  } else {
    static_cast<float*>(p.o)[i] = x;
  }
}

// GB: the group size G rounded up to a power of two (8 for a group of 9-16
// at hd 256: a block takes heads [g0, g0 + gn) of it).  Heads gn..GB-1 are
// zero queries whose results are never written, so no loop over heads
// carries a guard and the heads' shuffle chains interleave.
template <typename TKV, int HD, int GB>
__global__ void __launch_bounds__(THREADS, 1) decode_attention_kernel(Params p) {
  using L = Layout<TKV, HD, GB>;
  constexpr int EPC = 16 / static_cast<int>(sizeof(TKV));  // K values per 16-byte chunk
  constexpr int CH = HD / EPC / 2;                         // chunks per half row
  constexpr int DPL = HD / 32;                             // output dims per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + L::Q);
  float* scales = reinterpret_cast<float*>(smem + L::Q + L::P);
  unsigned char* ring = smem + L::Q + L::P + L::SCALES;

  const int split = blockIdx.x, kh = blockIdx.y / p.chunks, b = blockIdx.z;
  const int G = p.H / p.kvH;
  const int g0 = blockIdx.y % p.chunks * GB, gn = min(GB, G - g0);  // this block's heads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sl = lane & 15, half = lane >> 4;  // this lane's slot in the warp, and head-dim half
  const bool quantized = p.k_scale != nullptr;

  const long long row = static_cast<long long>(b) * p.kvH + kh;  // (b, kv head)
  const TKV* kg = static_cast<const TKV*>(p.k) + row * p.Sc * HD;
  const TKV* vg = static_cast<const TKV*>(p.v) + row * p.Sc * HD;
  const float* ksg = quantized ? p.k_scale + row * p.Sc : nullptr;
  const float* vsg = quantized ? p.v_scale + row * p.Sc : nullptr;
  const int t_begin = split * p.tiles_per_split * BK;
  const int t_end = min(p.n_valid, t_begin + p.tiles_per_split * BK);

  load_tile<TKV, HD, GB>(ring, scales, 0, kg, vg, ksg, vsg, t_begin, t_end);
  cp_async_commit();
  const long long q0 = (static_cast<long long>(b) * p.H + kh * G + g0) * HD;
  for (int i = threadIdx.x; i < GB * HD; i += THREADS) qs[i] = i < gn * HD ? load_q(p, q0 + i) : 0.f;

  // m is the warp's running max of each head; l and acc are this lane's
  // share (its slots' weights, its output dims), rescaled as m moves
  float m[GB], l[GB], acc[GB][DPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }
  float* pw = ps + warp * SPW * L::PSTR;

  int stage = 0;
  for (int t = t_begin; t < t_end; t += BK, stage ^= L::NST - 1) {
    if constexpr (L::NST == 1) {  // the tile loads once the last one is consumed
      if (t != t_begin) {
        load_tile<TKV, HD, GB>(ring, scales, 0, kg, vg, ksg, vsg, t, t_end);
        cp_async_commit();
      }
      cp_async_wait<0>();
    } else if (t + BK < t_end) {  // the next tile's load overlaps this tile's math
      load_tile<TKV, HD, GB>(ring, scales, stage ^ 1, kg, vg, ksg, vsg, t + BK, t_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt = ring + stage * 2 * L::TILE;
    const unsigned char* vt = kt + L::TILE;
    const int ws = warp * SPW;  // the warp's first slot in the tile
    const bool valid = t + ws + sl < t_end;
    if (t + ws < t_end) {  // the warp has a valid slot
      float s[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] = 0.f;
      const unsigned char* krow = kt + (ws + sl) * L::KROW + half * (L::ROW / 2);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float x[EPC];
        load_vals<TKV, EPC>(krow + c * 16, x);
        const int d0 = half * (HD / 2) + c * EPC;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int e = 0; e < EPC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * HD + d0 + e);
            s[g] = fmaf(qv.x, x[e], s[g]);
            s[g] = fmaf(qv.y, x[e + 1], s[g]);
            s[g] = fmaf(qv.z, x[e + 2], s[g]);
            s[g] = fmaf(qv.w, x[e + 3], s[g]);
          }
        }
      }
      const float* sc = scales + stage * 2 * BK;
      const float kscale = (quantized ? sc[ws + sl] : 1.f) * p.scale_log2;
      const float vscale = quantized ? sc[BK + ws + sl] : 1.f;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = s[g] + __shfl_xor_sync(FULL, s[g], 16);  // the two halves of the row
        x = valid ? x * kscale : NEG_INF;
        float mx = x;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float corr = exp2f(m[g] - m_new);
        const float pr = valid ? exp2f(x - m_new) : 0.f;
        l[g] = l[g] * corr + pr;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
        s[g] = pr * vscale;  // int8: V's slot scale rides on the weight
      }
      if (half == 0) {
        if constexpr (GB % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GB; g += 4)
            *reinterpret_cast<float4*>(pw + sl * L::PSTR + g) =
                make_float4(s[g], s[g + 1], s[g + 2], s[g + 3]);
        } else {
#pragma unroll
          for (int g = 0; g < GB; ++g) pw[sl * L::PSTR + g] = s[g];
        }
      }
      __syncwarp();
      const unsigned char* vrow = vt + ws * L::KROW + lane * DPL * static_cast<int>(sizeof(TKV));
      const int n = min(SPW, t_end - t - ws);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float vv[DPL];
        load_vals<TKV, DPL>(vrow + j * L::KROW, vv);
        float pj[GB];
        if constexpr (GB % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GB; g += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pw + j * L::PSTR + g);
            pj[g] = p4.x;
            pj[g + 1] = p4.y;
            pj[g + 2] = p4.z;
            pj[g + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GB; ++g) pj[g] = pw[j * L::PSTR + g];
        }
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pj[g], vv[e], acc[g][e]);
      }
      __syncwarp();  // P is read before the next tile overwrites it
    }
    __syncthreads();  // the ring slot is consumed before it is refilled
  }

  // the four warps' (m, l, acc) of every head fold through shared memory
  float* cm = reinterpret_cast<float*>(ring);
  float* cl = cm + WARPS * GB;
  float* cacc = cl + WARPS * GB;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float lsum = l[g];  // the 16 slots of a half; both halves hold the same
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) lsum += __shfl_xor_sync(FULL, lsum, o);
    if (lane == 0) {
      cm[warp * GB + g] = m[g];
      cl[warp * GB + g] = lsum;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) cacc[(warp * GB + g) * HD + lane * DPL + e] = acc[g][e];
  }
  __syncthreads();
  const long long prow = (row * p.splits + split) * G;  // this block's partial rows
  for (int i = threadIdx.x; i < gn * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, cm[w * GB + g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(cm[w * GB + g] - M);
      Ls = fmaf(cl[w * GB + g], f, Ls);
      A = fmaf(cacc[(w * GB + g) * HD + d], f, A);
    }
    if (p.splits == 1) {
      store_o(p, (static_cast<long long>(b) * p.H + kh * G + g0 + g) * HD + d, A / Ls);
    } else {
      const long long R = static_cast<long long>(gridDim.z) * p.kvH * p.splits;
      p.part[(prow + g0 + g) * HD + d] = A;
      if (d == 0) {
        p.part[R * G * HD + prow + g0 + g] = M;
        p.part[R * G * HD + R * G + prow + g0 + g] = Ls;
      }
    }
  }
}

// One block per (head, b), one thread per output dim: folds the splits'
// partials, o = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M).  The split
// weights are computed once, in parallel, into shared memory.
__global__ void decode_combine_kernel(Params p, int B, int hd) {
  extern __shared__ float f[];  // [splits] weights, then [32] for reductions
  float* red = f + p.splits;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = p.H / p.kvH, kh = h / G, g = h % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const long long R = static_cast<long long>(B) * p.kvH * p.splits;
  const float* pm = p.part + R * G * hd;
  const float* pl = pm + R * G;
  const long long r0 = (static_cast<long long>(b) * p.kvH + kh) * p.splits;

  float mx = NEG_INF;
  for (int s = d; s < p.splits; s += blockDim.x) mx = fmaxf(mx, pm[(r0 + s) * G + g]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float M = NEG_INF;
  for (int w = 0; w < nw; ++w) M = fmaxf(M, red[w]);
  float ls = 0.f;
  for (int s = d; s < p.splits; s += blockDim.x) {
    const long long r = (r0 + s) * G + g;
    const float w = exp2f(pm[r] - M);
    f[s] = w;
    ls = fmaf(pl[r], w, ls);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(FULL, ls, o);
  __syncthreads();  // every reader of red is past it, and f is written
  if (lane == 0) red[warp] = ls;
  __syncthreads();
  float Ls = 0.f;
  for (int w = 0; w < nw; ++w) Ls += red[w];
  const float* acc = p.part + (r0 * G + g) * hd + d;
  float A = 0.f;
#pragma unroll 8
  for (int s = 0; s < p.splits; ++s) A = fmaf(acc[static_cast<long long>(s) * G * hd], f[s], A);
  store_o(p, (static_cast<long long>(b) * p.H + h) * hd + d, A / Ls);
}

template <typename TKV, int HD, int GB>
int launch(Params p, int B, cudaStream_t s) {
  using L = Layout<TKV, HD, GB>;
  auto kernel = decode_attention_kernel<TKV, HD, GB>;
  static unsigned long long done = 0;  // bit d: device d allows the shared memory
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(done >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e == cudaSuccess) done |= 1ull << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  p.chunks = (p.H / p.kvH + GB - 1) / GB;
  kernel<<<dim3(p.splits, p.kvH * p.chunks, B), THREADS, L::bytes, s>>>(p);
  if (p.splits > 1) {
    decode_combine_kernel<<<dim3(p.H, B), HD, (p.splits + 32) * 4, s>>>(p, B, HD);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, int HD>
int dispatch_group(const Params& p, int B, cudaStream_t s) {
  const int G = p.H / p.kvH;
  if (G == 1) return launch<TKV, HD, 1>(p, B, s);
  if (G == 2) return launch<TKV, HD, 2>(p, B, s);
  if (G <= 4) return launch<TKV, HD, 4>(p, B, s);
  if constexpr (HD > 192) {
    return launch<TKV, HD, 8>(p, B, s);  // 9-16 heads: two blocks
  } else {
    if (G <= 8) return launch<TKV, HD, 8>(p, B, s);
    return launch<TKV, HD, MAX_G>(p, B, s);
  }
}



// ------------------------------------------------- generic head dim (> 256)
constexpr int GS = 32;  // cache slots per tile of the generic instance

// f32 words of the generic kernel's shared memory at head dim hd: the query
// row, the accumulator, the tile's weights and V-scaled weights, and the
// rescale.  csrc and the wrapper (kernels/native.py) compute it alike.
__host__ __device__ constexpr int generic_smem_floats(int hd) { return 2 * hd + 2 * GS + 1; }

// element i of a K or V row as a float (int8: before its slot's scale)
__device__ __forceinline__ float val(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float val(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float val(const int8_t* p, long long i) {
  return static_cast<float>(p[i]);
}

template <typename TKV>
__global__ void __launch_bounds__(THREADS) decode_generic_kernel(Params p, int hd) {
  extern __shared__ __align__(16) float gsm[];
  float* qs = gsm;            // [hd]
  float* acc = qs + hd;       // [hd]
  float* ws = acc + hd;       // [GS]: scores, then softmax weights (for l)
  float* wv = ws + GS;        // [GS]: weights times V's slot scale (for acc)
  float* cs = wv + GS;        // [1]: this tile's rescale

  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (p.H / p.kvH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool quantized = p.k_scale != nullptr;
  const long long row = static_cast<long long>(b) * p.kvH + kh;
  const TKV* kg = static_cast<const TKV*>(p.k) + row * p.Sc * hd;
  const TKV* vg = static_cast<const TKV*>(p.v) + row * p.Sc * hd;
  const float* ksg = quantized ? p.k_scale + row * p.Sc : nullptr;
  const float* vsg = quantized ? p.v_scale + row * p.Sc : nullptr;
  const long long qo = (static_cast<long long>(b) * p.H + h) * hd;
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    qs[d] = load_q(p, qo + d);
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;  // held by warp 0
  for (int t = 0; t < p.n_valid; t += GS) {
    __syncthreads();  // q is loaded, and the last tile's weights are consumed
    // warp w scores slots w, w + 4, ...: lanes stride over the head dim
    for (int j = warp; j < GS; j += WARPS) {
      const int slot = t + j;
      float x = 0.f;
      if (slot < p.n_valid) {
        const TKV* kr = kg + static_cast<long long>(slot) * hd;
        for (int d = lane; d < hd; d += 32) x = fmaf(qs[d], val(kr, d), x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
      if (lane == 0) {
        const float ksc = quantized && slot < p.n_valid ? ksg[slot] : 1.f;
        ws[j] = slot < p.n_valid ? x * ksc * p.scale_log2 : NEG_INF;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int slot = t + lane;
      const float x = ws[lane];
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      const float pr = x > 0.5f * NEG_INF ? exp2f(x - m_new) : 0.f;
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      l = l * corr + sum;
      m = m_new;
      wv[lane] = quantized && slot < p.n_valid ? pr * vsg[slot] : pr;
      if (lane == 0) cs[0] = corr;
    }
    __syncthreads();
    const int n = min(GS, p.n_valid - t);
    const float corr = cs[0];
    for (int d = threadIdx.x; d < hd; d += THREADS) {
      float a = acc[d] * corr;
      for (int j = 0; j < n; ++j) a = fmaf(wv[j], val(vg, static_cast<long long>(t + j) * hd + d), a);
      acc[d] = a;
    }
  }
  if (threadIdx.x == 0) cs[0] = 1.f / l;  // thread 0 is lane 0 of warp 0
  __syncthreads();
  const float inv = cs[0];
  for (int d = threadIdx.x; d < hd; d += THREADS) store_o(p, qo + d, acc[d] * inv);
}

template <typename TKV>
int launch_generic(Params p, int B, int hd, cudaStream_t s) {
  auto kernel = decode_generic_kernel<TKV>;
  const int smem = generic_smem_floats(hd) * 4;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // the attribute follows the head dim, so it is set before every launch
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(p.H, B), THREADS, smem, s>>>(p, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int dispatch_shape(const Params& p, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 64: return dispatch_group<TKV, 64>(p, B, s);
    case 128: return dispatch_group<TKV, 128>(p, B, s);
    case 192: return dispatch_group<TKV, 192>(p, B, s);
    case 256: return dispatch_group<TKV, 256>(p, B, s);
    default: return launch_generic<TKV>(p, B, hd, s);  // above 256
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale / v_scale required).  hd 64, 128, 192 or 256, or above 256
// (the generic instance, one split, while its shared memory fits); every
// tensor contiguous.  The first n_valid slots are read, in `splits` ranges of
// tiles_per_split 64-slot tiles; splits > 1 needs `part`, B * kvH * splits
// * G * (hd + 2) floats.
extern "C" int rt_decode_attention(int q_dtype, int kv_dtype, const void* q, const void* k,
                                   const void* v, const void* k_scale, const void* v_scale,
                                   void* o, void* part, int B, int H, int kvH, int Sc, int hd,
                                   int n_valid, int splits, int tiles_per_split, float scale,
                                   void* stream) {
  if ((hd != 64 && hd != 128 && hd != 192 && hd < 256) || (hd > 256 && splits != 1) ||
      kvH <= 0 || H % kvH != 0 || H / kvH > MAX_G || splits < 1 || n_valid < 1 || n_valid > Sc || tiles_per_split < 1 ||
      (splits - 1) * tiles_per_split * BK >= n_valid || splits * tiles_per_split * BK < n_valid ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  if (q_dtype != 0 && q_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 o, static_cast<float*>(part), H, kvH, Sc, n_valid, tiles_per_split, splits,
                 q_dtype, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return dispatch_shape<float>(p, B, hd, s);
    case 1: return dispatch_shape<__nv_bfloat16>(p, B, hd, s);
    case 2:
      if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_shape<int8_t>(p, B, hd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
