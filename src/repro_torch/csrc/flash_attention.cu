// Causal (optionally sliding-window) flash attention with an online softmax
// in f32, for prefill.  GQA: query head h reads kv head h / (H / kvH).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, pallas_call at :92), whose sequential kv grid axis
// carried (m, l, acc) in VMEM scratch and which asserted that S divides into
// its blocks.
//
// Bound on an H100: at the serving path's prompts (S = 4..16, hd = 64) the
// least time is set by bytes (q, k, v read once, o written once) and a launch
// costs more than the work.  At long S the bound is the operations
// (4 * B * H * S^2 * hd / 2 causal): f32 on the CUDA cores (67 TFLOP/s; TF32
// would break the 2e-5 tolerance), bf16 on the tensor cores (989 TFLOP/s).
//
// Design, shared by both dtypes: a block of 4 warps works on 64 query rows
// of one (b, h) at a time, each warp owning 16; a warp whose rows all lie
// past S (a short prompt) only helps load.  Each block takes two q tiles,
// the i-th longest and the i-th shortest, so causal blocks do equal work.  The kv loop runs inside the block over
// tiles of 64 keys (32 in f32 at hd above 128), bounded by the causal and window limits; 16-byte
// cp.async loads fill a two-stage ring in shared memory, so the next
// tile's load overlaps this tile's math (one barrier a tile).  A
// warp computes only the keys its rows can see (the causal limit and S cut
// a tile short), and a tile whose keys are all valid for all its rows runs
// a variant without masks or guards.  Inputs are (B, H, S, hd) views with
// any element strides and a contiguous last dimension; ragged S is masked
// (zero-filled loads, masked scores), never asserted away.
// - f32: register-tiled on the CUDA cores.  A lane holds a 4 x 8 micro-tile
//   of scores (rows r4*4.., keys c8 + 8j) and 4 rows x hd/8 dims of the
//   output, so each 16-byte shared-memory load feeds 8-32 FMAs.  P goes
//   through a per-warp shared tile (padded rows: conflict-free) to P.V.
// - bf16: QK^T and P.V on the tensor cores with mma.sync.m16n8k16 (f32
//   accumulation); Q's fragments stay in registers for the whole kv loop,
//   K and V fragments come from ldmatrix (V transposed), and P is re-packed
//   to bf16 in registers as the A operand of the second product.
// Head dims: compiled for 64, 128, 192 and 256 (the wrapper zero-pads any
// other up to 256).  Above 128 the f32 kernel takes 32-key tiles, so that
// Q and two stages of K and V fit a block's 227 KB of shared memory, and the
// bf16 kernel reads Q's fragments from shared memory at each tile instead of
// keeping them in registers beside the wider output accumulators.
// Above 256 a generic instance takes the head dim as a runtime argument
// (the reference blocks over the full head dim at any width): one block per
// (b, h, 16 query rows), scores over 32-key tiles reduced over the head dim
// in chunks of 256 staged in shared memory, the online softmax's output
// accumulator (16 rows x hd f32) in shared memory, V read straight from
// device memory by columns.  Simple, on the CUDA cores in f32 for both
// dtypes; no configuration of the repo has such a head dim.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 64;   // query rows per block, 16 per warp
constexpr int BK = 64;   // keys per tile (f32 above hd 128: F32Smem::BK)
constexpr int NST = 2;   // stages of the K/V ring
constexpr int PROW = 20; // f32 P tile row: 16 rows + 4 pad (conflict-free)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // the shared memory one block can have on sm_90

struct Strides {  // element strides of the (B, H, S, hd) views
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides st;
  int H, kvH, S, causal, window;
  float scale_log2;  // softmax scale * log2(e): scores live in base 2
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows [r0, r0 + ROWS) of one (b, head) slice into a shared tile of
// `pitch` elements per row; rows at or past S are zero-filled.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* src, long long row_stride,
                                          int r0, int S) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;        // chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < S;
    const T* g = src + (in ? (r0 + r) : 0) * row_stride + c * EPC;
    cp_async16(dst + r * pitch + c * EPC, g, in);
  }
}

__device__ __forceinline__ bool key_valid(int kpos, int qpos, int S, int causal, int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// The block's kv range [k_begin, k_end) (k_begin a multiple of the tile's
// TK keys), and whether warp-row range [w0, w1] needs the tile at kt.
template <int TK>
__device__ __forceinline__ void kv_range(const Params& p, int q0, int* k_begin, int* k_end) {
  const int q_last = min(q0 + BQ, p.S) - 1;
  *k_end = p.causal ? q_last + 1 : p.S;
  int kb = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *k_begin = kb - kb % TK;
}
template <int TK>
__device__ __forceinline__ bool tile_needed(const Params& p, int kt, int w0, int w1) {
  if (w0 >= p.S) return false;                                   // empty warp
  if (p.causal && kt > w1) return false;                         // all keys in the future
  if (p.window > 0 && kt + TK - 1 < w0 - p.window + 1) return false;  // all too old
  return true;
}
// How many of the tile's keys rows [w0, w1] can see (the causal limit and
// S cut the rest, which are neither multiplied nor summed), and whether
// every one of those keys is valid for every row (then nothing is masked).
template <int TK>
__device__ __forceinline__ int tile_keys(const Params& p, int kt, int w0, int w1, bool* full) {
  int keys = min(TK, p.S - kt);
  if (p.causal) keys = min(keys, w1 - kt + 1);
  bool f = keys == TK;
  if (p.causal) f = f && kt + TK - 1 <= w0;
  if (p.window > 0) f = f && w1 - kt < p.window;
  *full = f;
  return keys;
}

__device__ __forceinline__ float quad_max(float x) {  // over the 4 lanes of a quad
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}
__device__ __forceinline__ float oct_max(float x) {  // over 8 neighbouring lanes
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 4));
}
__device__ __forceinline__ float oct_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x + __shfl_xor_sync(FULL, x, 4);
}

// ------------------------------------------------------------------ f32
template <int HD>
struct F32Smem {
  // keys per tile: at hd 192 / 256 two stages of 64 would need 269 / 351 KB
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int NJ = BK / 8;  // a lane's key columns c8 + 8j
  static constexpr int KP = HD + 4;  // padded q/k row: the 8 keys of a phase hit 8 bank quads
  static constexpr int floats = BQ * KP + NST * BK * (KP + HD) + WARPS * BK * PROW;
  static constexpr int bytes = floats * 4;
  static_assert(bytes <= SMEM_MAX, "f32 tiles exceed a block's shared memory");
};

// The rows [q0, q0 + 64) of one (b, h): the f32 kernel's work for one q tile.
template <int HD>
__device__ __forceinline__ void flash_f32_rows(const Params& p, float* smem, int q0) {
  using L = F32Smem<HD>;
  constexpr int KP = L::KP;
  constexpr int TK = L::BK;    // keys per tile
  constexpr int NJ = L::NJ;
  constexpr int DG = HD / 32;  // float4 dim groups per lane and row
  float* qs = smem;
  float* ks = qs + BQ * KP;
  float* vs = ks + NST * TK * KP;
  float* ps = vs + NST * TK * HD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.kvH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r4 = lane >> 3, c8 = lane & 7;
  const Strides& st = p.st;
  const float* qg = static_cast<const float*>(p.q) + b * st.qb + h * st.qh;
  const float* kg = static_cast<const float*>(p.k) + b * st.kb + kh * st.kh;
  const float* vg = static_cast<const float*>(p.v) + b * st.vb + kh * st.vh;
  float* og = static_cast<float*>(p.o) + b * st.ob + h * st.oh;

  int k_begin, k_end;
  kv_range<TK>(p, q0, &k_begin, &k_end);
  const int w0 = q0 + warp * 16, w1 = min(w0 + 15, p.S - 1);
  const int row0 = warp * 16 + r4 * 4;  // this lane's first row in the block
  float* pw = ps + warp * TK * PROW;

  // cp.async groups: Q, then one per tile; tile i sits in ring stage i % NST
  load_tile<float, HD, BQ>(qs, KP, qg, st.qs, q0, p.S);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (k_begin + i * TK < k_end) {
      load_tile<float, HD, TK>(ks + i * TK * KP, KP, kg, st.ks, k_begin + i * TK, p.S);
      load_tile<float, HD, TK>(vs + i * TK * HD, HD, vg, st.vs, k_begin + i * TK, p.S);
    }
    cp_async_commit();
  }

  float m[4], l[4], acc[4][DG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  int it = 0;
  for (int kt = k_begin; kt < k_end; kt += TK, ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile `it` has landed, and every warp is done with tile it - 1
    {
      // refill the stage tile it - 1 used: the load overlaps this tile's math
      const int nt = kt + (NST - 1) * TK, st_ = (it + NST - 1) % NST;
      if (nt < k_end) {
        load_tile<float, HD, TK>(ks + st_ * TK * KP, KP, kg, st.ks, nt, p.S);
        load_tile<float, HD, TK>(vs + st_ * TK * HD, HD, vg, st.vs, nt, p.S);
      }
      cp_async_commit();
    }
    if (!tile_needed<TK>(p, kt, w0, w1)) continue;
    bool full;
    const int keys = tile_keys<TK>(p, kt, w0, w1, &full);
    // ALL: every key of the tile is computed and none is masked (the
    // interior tiles of a long prompt), so no loop carries a guard
    auto tile = [&](auto all) {
      constexpr bool ALL = decltype(all)::value;
      const int nj = ALL ? NJ : (keys + 7) / 8;  // key columns c8 + 8j, j < nj, are computed
      const int nk = ALL ? TK : keys;
      const float* kb = ks + (it % NST) * TK * KP;
      const float* vb = vs + (it % NST) * TK * HD;
      float s[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (row0 + i) * KP + d);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (ALL || j < nj) {
            const float4 kv = *reinterpret_cast<const float4*>(kb + (c8 + 8 * j) * KP + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
              s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
              s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
              s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + row0 + i;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const bool ok = ALL || key_valid(kt + c8 + 8 * j, qpos, p.S, p.causal, p.window);
          s[i][j] = ok ? s[i][j] * p.scale_log2 : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], oct_max(mx));
        const float corr = exp2f(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = s[i][j] > 0.5f * NEG_INF ? exp2f(s[i][j] - m_new) : 0.f;
          sum += s[i][j];
        }
        l[i] = l[i] * corr + oct_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int g = 0; g < DG; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<float4*>(pw + (c8 + 8 * j) * PROW + r4 * 4) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncwarp();
#pragma unroll 4
      for (int key = 0; key < nk; ++key) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + key * PROW + r4 * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vb + key * HD + c8 * 4 + 32 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g][0] = fmaf(pr[i], vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pr[i], vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pr[i], vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pr[i], vv.w, acc[i][g][3]);
          }
        }
      }
      __syncwarp();  // P is read before the next tile overwrites it
    };
    if (full) {
      tile(std::true_type{});
    } else {
      tile(std::false_type{});
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= p.S) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int g = 0; g < DG; ++g)
      *reinterpret_cast<float4*>(og + qpos * st.os + c8 * 4 + 32 * g) =
          make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv, acc[i][g][2] * inv,
                      acc[i][g][3] * inv);
  }
}

// ----------------------------------------------------------------- bf16
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
struct Bf16Smem {
  static constexpr int P = HD + 8;  // padded row: ldmatrix's 8 rows hit 8 bank quads
  static constexpr int bytes = (BQ * P + 2 * NST * BK * P) * 2;
  static_assert(bytes <= SMEM_MAX, "bf16 tiles exceed a block's shared memory");
};

// The rows [q0, q0 + 64) of one (b, h): the bf16 kernel's work for one q tile.
template <int HD>
__device__ __forceinline__ void flash_bf16_rows(const Params& p, unsigned char* smem_raw,
                                                int q0) {
  using T = __nv_bfloat16;
  constexpr int P = Bf16Smem<HD>::P;
  constexpr int KS = HD / 16;  // k16 steps over the head dim
  constexpr int NT = HD / 8;   // n8 tiles of the output
  // Q's A fragments live in registers for the whole kv loop up to hd 128;
  // above, beside the wider accumulators, they are read again at each tile
  constexpr bool QREG = HD <= 128;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BQ * P;
  T* vs = ks + NST * BK * P;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.kvH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Strides& st = p.st;
  const T* qg = static_cast<const T*>(p.q) + b * st.qb + h * st.qh;
  const T* kg = static_cast<const T*>(p.k) + b * st.kb + kh * st.kh;
  const T* vg = static_cast<const T*>(p.v) + b * st.vb + kh * st.vh;
  T* og = static_cast<T*>(p.o) + b * st.ob + h * st.oh;

  int k_begin, k_end;
  kv_range<BK>(p, q0, &k_begin, &k_end);
  const int w0 = q0 + warp * 16, w1 = min(w0 + 15, p.S - 1);
  // accumulator layout of m16n8: rows lane/4 and lane/4 + 8, cols 2 * (lane % 4) + {0, 1}
  const int ra = w0 + (lane >> 2), rb = ra + 8;
  const int cq = 2 * (lane & 3);

  // cp.async groups: Q, then one per tile; tile i sits in ring stage i % NST
  load_tile<T, HD, BQ>(qs, P, qg, st.qs, q0, p.S);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (k_begin + i * BK < k_end) {
      load_tile<T, HD, BK>(ks + i * BK * P, P, kg, st.ks, k_begin + i * BK, p.S);
      load_tile<T, HD, BK>(vs + i * BK * P, P, vg, st.vs, k_begin + i * BK, p.S);
    }
    cp_async_commit();
  }

  const T* qrow = qs + (warp * 16 + (lane & 15)) * P + (lane >> 4) * 8;  // this lane's ldmatrix row
  uint32_t qa[QREG ? KS : 1][4];
  cp_async_wait<NST - 1>();
  __syncthreads();
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk], qrow + kk * 16);
  }

  float o[NT][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int it = 0;
  for (int kt = k_begin; kt < k_end; kt += BK, ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile `it` has landed, and every warp is done with tile it - 1
    {
      const int nt = kt + (NST - 1) * BK, st_ = (it + NST - 1) % NST;
      if (nt < k_end) {
        load_tile<T, HD, BK>(ks + st_ * BK * P, P, kg, st.ks, nt, p.S);
        load_tile<T, HD, BK>(vs + st_ * BK * P, P, vg, st.vs, nt, p.S);
      }
      cp_async_commit();
    }
    if (!tile_needed<BK>(p, kt, w0, w1)) continue;
    bool full;
    const int keys = tile_keys<BK>(p, kt, w0, w1, &full);
    auto tile = [&](auto all) {  // ALL: as in the f32 kernel
      constexpr bool ALL = decltype(all)::value;
      const int n16 = ALL ? BK / 16 : (keys + 15) / 16;  // 16-key chunks that are computed
      const T* kb = ks + (it % NST) * BK * P;
      const T* vb = vs + (it % NST) * BK * P;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      // S = Q K^T: K rows are B's columns; one ldmatrix.x4 gives two n8 tiles
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
        } else {
          ldsm_x4(qf, qrow + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (ALL || np < n16) {
            uint32_t r[4];
            const int mi = lane >> 3;
            ldsm_x4(r, kb + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * P + kk * 16 + (mi & 1) * 8);
            mma_bf16(s[2 * np], qf, r[0], r[1]);
            mma_bf16(s[2 * np + 1], qf, r[2], r[3]);
          }
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;  // row ra or rb
          const bool ok = ALL || key_valid(kt + n * 8 + cq + (e & 1), hf ? rb : ra, p.S,
                                           p.causal, p.window);
          s[n][e] = ok ? s[n][e] * p.scale_log2 : NEG_INF;
          mx[hf] = fmaxf(mx[hf], s[n][e]);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        corr[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          s[n][e] = s[n][e] > 0.5f * NEG_INF ? exp2f(s[n][e] - m[hh]) : 0.f;
          sum[hh] += s[n][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + quad_sum(sum[hh]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += P V: two n8 score tiles are one m16k16 A fragment; V rows are
      // B's k, read transposed
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (ALL || kk < n16) {
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < NT / 2; ++dp) {
            uint32_t r[4];
            const int mi = lane >> 3;
            ldsm_x4_trans(r, vb + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * P + dp * 16 +
                                 (mi >> 1) * 8);
            mma_bf16(o[2 * dp], pa, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
          }
        }
      }
    };
    if (full) {
      tile(std::true_type{});
    } else {
      tile(std::false_type{});
    }
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = hh ? rb : ra;
    if (qpos >= p.S) continue;
    T* orow = og + qpos * st.os + cq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * hh] * inv[hh], o[n][2 * hh + 1] * inv[hh]);
  }
}

// Causal balance: block x takes q tile n - 1 - x (the longest rows first),
// then q tile x, so every block does about the same work and one wave of
// blocks ends together.
template <typename F>
__device__ __forceinline__ void for_each_q_tile(const Params& p, F&& rows) {
  const int n = (p.S + BQ - 1) / BQ;
  const int a = n - 1 - blockIdx.x, c = blockIdx.x;
  rows(a * BQ);
  if (c < a) {
    __syncthreads();  // the first tile's shared memory is free again
    rows(c * BQ);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_f32_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  for_each_q_tile(p, [&](int q0) { flash_f32_rows<HD>(p, smem, q0); });
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for_each_q_tile(p, [&](int q0) { flash_bf16_rows<HD>(p, smem_raw, q0); });
}

// Above 48 KB a block's shared memory must be asked for, once per kernel
// and device (`done`: bit d set once device d allows it).
template <typename K>
int launch(K kernel, int smem, unsigned long long& done, const Params& p, int B,
           cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(done >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) done |= 1ull << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(((p.S + BQ - 1) / BQ + 1) / 2, p.H, B);  // two q tiles a block
  kernel<<<grid, THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- generic head dim (> 256)
constexpr int GQ = 16;         // query rows per block, 4 per warp
constexpr int GK = 32;         // keys per tile, one per lane
constexpr int GCH = 256;       // head-dim chunk of the score products
constexpr int GP = GCH + 1;    // padded chunk row: a warp's 32 key rows hit 32 banks

// f32 words of the generic kernel's shared memory at head dim hd: q and k
// chunks, P, the per-row rescale and 1 / l, and the output accumulator.
// csrc and the wrapper (kernels/native.py) compute it alike.
__host__ __device__ constexpr int generic_smem_floats(int hd) {
  return GQ * GP + GK * GP + GQ * GK + GQ + GQ * hd;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* d, float x) { *d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* d, float x) { *d = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_generic_kernel(Params p, int hd) {
  extern __shared__ __align__(16) float gsm[];
  float* qs = gsm;            // [GQ][GP]
  float* ks = qs + GQ * GP;   // [GK][GP]
  float* ps = ks + GK * GP;   // [GQ][GK]: scores, then the softmax weights
  float* cs = ps + GQ * GK;   // [GQ]: this tile's rescale of each row, at the end 1 / l
  float* acc = cs + GQ;       // [GQ][hd]

  const int q0 = blockIdx.x * GQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.kvH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Strides& st = p.st;
  const T* qg = static_cast<const T*>(p.q) + b * st.qb + h * st.qh;
  const T* kg = static_cast<const T*>(p.k) + b * st.kb + kh * st.kh;
  const T* vg = static_cast<const T*>(p.v) + b * st.vb + kh * st.vh;
  T* og = static_cast<T*>(p.o) + b * st.ob + h * st.oh;

  for (int i = threadIdx.x; i < GQ * hd; i += THREADS) acc[i] = 0.f;
  // the warp's rows warp * 4 + rr: every lane holds their m and l
  float m[4], l[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
  }
  const int q_last = min(q0 + GQ, p.S) - 1;
  const int k_end = p.causal ? q_last + 1 : p.S;
  const int kb0 = p.window > 0 ? max(0, q0 - p.window + 1) : 0;

  for (int kt = kb0 - kb0 % GK; kt < k_end; kt += GK) {
    // scores: thread t computes the pairs (r, j) = divmod(t + 128 e, 32)
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < hd; c0 += GCH) {
      const int cw = min(GCH, hd - c0);
      __syncthreads();  // the last chunk (and the last tile's P) is consumed
      for (int i = threadIdx.x; i < GQ * cw; i += THREADS) {
        const int r = i / cw, d = i % cw;
        qs[r * GP + d] = q0 + r < p.S ? to_f(qg[(q0 + r) * st.qs + c0 + d]) : 0.f;
      }
      for (int i = threadIdx.x; i < GK * cw; i += THREADS) {
        const int j = i / cw, d = i % cw;
        ks[j * GP + d] = kt + j < p.S ? to_f(kg[(kt + j) * st.ks + c0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (threadIdx.x + THREADS * e) / GK, j = lane;
        const float* qr = qs + r * GP;
        const float* kr = ks + j * GP;
        float x = s[e];
        for (int d = 0; d < cw; ++d) x = fmaf(qr[d], kr[d], x);
        s[e] = x;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (threadIdx.x + THREADS * e) / GK;
      const int qpos = q0 + r;
      const bool ok = qpos < p.S && key_valid(kt + lane, qpos, p.S, p.causal, p.window);
      ps[r * GK + lane] = ok ? s[e] * p.scale_log2 : NEG_INF;
    }
    __syncthreads();
    // online softmax: warp w owns rows 4w..4w+3, lane j key j
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp * 4 + rr;
      const float x = ps[r * GK + lane];
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[rr], mx);
      const float corr = exp2f(m[rr] - m_new);
      const float pr = x > 0.5f * NEG_INF ? exp2f(x - m_new) : 0.f;
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      l[rr] = l[rr] * corr + sum;
      m[rr] = m_new;
      ps[r * GK + lane] = pr;
      if (lane == 0) cs[r] = corr;
    }
    __syncthreads();
    // acc = acc * corr + P V, one output column per thread at a time
    const int nk = min(GK, p.S - kt);
    for (int d = threadIdx.x; d < hd; d += THREADS) {
      float vv[GK];
#pragma unroll
      for (int j = 0; j < GK; ++j) vv[j] = j < nk ? to_f(vg[(kt + j) * st.vs + d]) : 0.f;
#pragma unroll 4
      for (int r = 0; r < GQ; ++r) {
        float a = acc[r * hd + d] * cs[r];
#pragma unroll
        for (int j = 0; j < GK; ++j) a = fmaf(ps[r * GK + j], vv[j], a);
        acc[r * hd + d] = a;
      }
    }
  }
  __syncthreads();  // every column is done with cs
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) cs[warp * 4 + rr] = 1.f / l[rr];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    if (q0 + r < p.S) from_f(og + (q0 + r) * st.os + d, acc[i] * cs[r]);
  }
}

template <typename T>
int launch_generic(const Params& p, int B, int hd, cudaStream_t s) {
  auto kernel = flash_generic_kernel<T>;
  const int smem = generic_smem_floats(hd) * 4;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // the attribute follows the head dim, so it is set before every launch
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((p.S + GQ - 1) / GQ, p.H, B), THREADS, smem, s>>>(p, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One head dim's two kernels (f32, bf16).
template <int HD>
int launch_hd(int dtype, const Params& p, int B, cudaStream_t s) {
  static unsigned long long done[2] = {0, 0};
  if (dtype == 0) return launch(flash_f32_kernel<HD>, F32Smem<HD>::bytes, done[0], p, B, s);
  if (dtype == 1) return launch(flash_bf16_kernel<HD>, Bf16Smem<HD>::bytes, done[1], p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16; hd 64, 128, 192 or 256, or above 256 (the
// generic instance, while its shared memory fits).  Strides are in elements
// (q, k, v, o, each batch, head, row); the last dimension is contiguous and,
// for the compiled head dims, every row starts 16-byte aligned.  window <= 0
// means no window.
extern "C" int rt_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* o, long long qb, long long qh, long long qs,
                                  long long kb, long long kh, long long ks, long long vb,
                                  long long vh, long long vs, long long ob, long long oh,
                                  long long os, int B, int H, int kvH, int S, int hd,
                                  int causal, int window, float scale, void* stream) {
  if ((hd != 64 && hd != 128 && hd != 192 && hd < 256) || kvH <= 0 || H % kvH != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return 0;
  const Params p{q, k, v, o, {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os},
                 H, kvH, S, causal, window, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_hd<64>(dtype, p, B, s);
    case 128: return launch_hd<128>(dtype, p, B, s);
    case 192: return launch_hd<192>(dtype, p, B, s);
    case 256: return launch_hd<256>(dtype, p, B, s);
    default:
      return dtype == 0 ? launch_generic<float>(p, B, hd, s)
                        : launch_generic<__nv_bfloat16>(p, B, hd, s);
  }
}
