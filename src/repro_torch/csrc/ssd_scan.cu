// Mamba2 SSD scan: y and the final state of the selective state-space
// recurrence, per (batch, head), for x (B, S, H, P) already times dt,
// a = dt * A (B, H, S) f32, and B / C (B, S, G, N) with head h reading group
// h / (H / G).  y comes out in x's type (contiguous), the state (B, H, P, N)
// in f32.  Inputs are views with any element strides whose last dimension
// (p of x, n of B and C) is contiguous; a takes any strides.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_kernel, pallas_call at :88), whose sequential chunk grid axis
// carried the (P, N) state in VMEM scratch and computed each chunk in the
// chunked (matrix) form: y = ((C B^T) o L) x + (C state^T) exp(cumsum a),
// state <- state exp(sum a) + x^T (B decay).
//
// Design: the same chunked form, cut so that the chunks run in parallel and
// only a P x N elementwise pass stays sequential.  The kernel's own chunk
// is L = 64 tokens, whatever the caller's chunk (re-chunking moves y and the
// state by ~1e-5 in f32); the last chunk is zero-padded, and a zero token
// (a = 0, x = B = C = 0) changes neither the state nor any real token's y.
// a's cumsum is taken per chunk, as the plain form takes it.
//   A. chunk states, grid (chunk x p tile x n tile, h, b): the chunk's local
//      state x_c^T (B_c o exp(acs[-1] - acs)) into a (B, nc, H, P, N) f32
//      scratch, and the chunk's total decay acs[-1] into (B, H, nc).
//   B. state passing, four state values of (b, h) a thread (one where P N
//      is not a multiple of 4), in place: s_in[c] = run; run = run
//      exp(sum a_c) + state_c; the final state once.
//   C. chunk output, grid (chunk x p tile, h, b):
//      y = ((C B^T) o exp(segsum a)) x + (C s_in^T) o exp(acs), accumulated
//      in f32 and written once; C B^T sub-tiles above the diagonal are never
//      computed, and chunk 0 (s_in = 0) skips the second term.
// With one chunk (S <= 64, the serving prompts) phase C alone runs, one
// launch that also writes the state: no scratch, no phase A or B.
// Every product is register-tiled on the CUDA cores in f32 (bf16 inputs are
// widened on the way into shared memory): a lane owns a 4 x 4 tile of
// outputs and each 16-byte shared-memory load feeds 4-16 FMAs.  In C, lane
// (ty, tx) owns element (ty, tx) of each 16 x 16 sub-tile (rows 16 r + ty,
// columns 16 q + tx), so the causal skip is a compile-time one over (r, q),
// and rows read along k as float4 at a pitch of 4 banks (mod 32) fall in
// distinct banks.  f32 tiles stream in by cp.async (16-byte copies where
// every row is 16-byte aligned, 4-byte ones elsewhere): phase C's B, C and
// s_in slabs of 32 columns through a two-stage ring (four stages, all of N
// <= 128 at once, with one chunk), each block's load of a issued first and
// its cumsum taken while the tiles are in flight.
//
// Bound on an H100: at serving prompts (S = 16) the bytes of x, y, B, C and
// the f32 state bound it and one block's chain of latencies sets the time;
// at long prompts the f32 operations do (4 B S H P N for the recurrence at
// 67 TFLOP/s).  The chunked form does about L (N + P) / (4 P N) more (1.4x
// at P 64, N 128) and moves the scratch (4 P N floats a chunk and head)
// through phases A-C, in exchange for nc-fold parallelism over the
// sequence.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int L = 64;        // the kernel's chunk (tokens)
constexpr int TP = 64;       // p rows of a block's tile
constexpr int TA = 64;       // n columns of a phase-A tile
constexpr int TN = 32;       // n columns of a phase-C slab
constexpr int LD = 68;       // pitch of the 64-wide shared tiles (floats)
constexpr int LDN = 36;      // pitch of phase C's 32-wide slabs
constexpr int THREADS = 256;
constexpr int MAX_N = 256;
constexpr unsigned FULL = 0xffffffffu;
// 16 x 16 lanes; a lane's rows and columns read along k as float4 with a
// pitch of 4 (mod 32) banks, so 8 lanes of a quarter warp hit 8 distinct
// 16-byte bank groups
static_assert(L == 64 && TP == 64 && THREADS == 256 && LD % 32 == 4 && LDN % 32 == 4, "layout");

struct Params {
  const void* x;
  const float* a;
  const void* Bm;
  const void* Cm;
  void* y;
  float* state;        // (B, H, P, N)
  float* chunk_state;  // (B, nc, H, P, N); the state, unused, when nc == 1
  float* chunk_sum;    // (B, H, nc); unused when nc == 1
  long long xb, xs, xh, ab, ah, as, bb, bs, bg, cb, cs, cg;  // element strides
  int S, H, G, P, N, nc;
  bool vec;  // f32 rows of x, B, C start 16-byte aligned; P, N multiples of 4
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;  // 0 source bytes: the word is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most n (0..3) of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 3) {
    cp_async_wait<3>();
  } else if (n == 2) {
    cp_async_wait<2>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// A 64 x W tile into shared memory as f32: dst[r * PITCH + c] = src[r * rs
// + c] for r < rows and c < cols, 0 elsewhere.  f32 goes by cp.async (the
// caller commits and waits): 16-byte copies when `vec` (every row start
// 16-byte aligned, cols a multiple of 4), else 4-byte ones.  bf16 is
// loaded, every load of the tile before the first store, and widened.  A
// warp covers neighbouring columns of a row; a thread keeps one column (or
// 16-byte chunk) and steps down the rows.
template <typename T, int W, int PITCH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long rs, int rows,
                                          int cols, bool vec) {
  const int t = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int CPR = W / 4;             // chunks a row
      constexpr int RSTEP = THREADS / CPR;   // rows between a thread's chunks
      const int r0 = t / CPR, c = t % CPR * 4;
      const bool col_in = c < cols;
#pragma unroll
      for (int k = 0; k < 64 / RSTEP; ++k) {
        const int r = r0 + k * RSTEP;
        const bool in = col_in && r < rows;
        cp_async16(dst + r * PITCH + c, in ? src + r * rs + c : src, in);
      }
      return;
    }
  }
  constexpr int RSTEP = THREADS / W;
  const int r0 = t / W, c = t % W;
  const bool col_in = c < cols;
  const T* g = src + r0 * rs + c;
  float* d = dst + r0 * PITCH + c;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int k = 0; k < 64 / RSTEP; ++k) {
      const bool in = col_in && r0 + k * RSTEP < rows;
      cp_async4(d + k * RSTEP * PITCH, in ? g + k * RSTEP * rs : src, in);
    }
  } else {
    float v[64 / RSTEP];
#pragma unroll
    for (int k = 0; k < 64 / RSTEP; ++k) {
      v[k] = col_in && r0 + k * RSTEP < rows ? to_f(g[k * RSTEP * rs]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 64 / RSTEP; ++k) d[k * RSTEP * PITCH] = v[k];
  }
}

// a at chunk token threadIdx.x (0 past len): loaded before the tiles are
// asked for, so its latency is not queued behind theirs.
__device__ __forceinline__ float load_a(const Params& p, int b, int h, int t0, int len) {
  const int t = threadIdx.x;
  return t < len ? p.a[b * p.ab + h * p.ah + (t0 + t) * p.as] : 0.f;
}

// The inclusive cumsum over the chunk of the values v of threads 0..L-1
// (load_a's), into acs[0..L).  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(float v, float* acs) {
  const int t = threadIdx.x;
  if (t < L) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, v, o);
      if ((t & 31) >= o) v += u;
    }
    acs[t] = v;
  }
  __syncthreads();
  if (t >= 32 && t < L) acs[t] += acs[31];
  __syncthreads();
}

// Phase A: state_c[p][n] = sum_t x[t][p] exp(acs[L-1] - acs[t]) B[t][n] for
// one chunk, 64 p rows and 64 n columns.  Lane (ty, tx) owns rows 4 ty..,
// columns 4 tx.. (float4 loads along the row, broadcast / conflict-free).
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_state_kernel(Params p) {
  __shared__ __align__(16) float xs[L * LD];  // x, [t][p]
  __shared__ __align__(16) float bs[L * LD];  // B, [t][n]
  __shared__ float acs[L], dec[L];

  const int ntiles = (p.N + TA - 1) / TA, ptiles = (p.P + TP - 1) / TP;
  const int n0 = blockIdx.x % ntiles * TA;
  const int p0 = blockIdx.x / ntiles % ptiles * TP;
  const int c = blockIdx.x / ntiles / ptiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * L, len = min(L, p.S - t0);

  const float av = load_a(p, b, h, t0, len);
  load_tile<T, TA, LD>(xs, static_cast<const T*>(p.x) + b * p.xb + t0 * p.xs + h * p.xh + p0,
                       p.xs, len, p.P - p0, p.vec);
  load_tile<T, TA, LD>(bs, static_cast<const T*>(p.Bm) + b * p.bb + t0 * p.bs + g * p.bg + n0,
                       p.bs, len, p.N - n0, p.vec);
  cp_async_commit();
  chunk_cumsum(av, acs);  // while the tiles are in flight
  const float last = acs[L - 1];
  if (threadIdx.x < L) dec[threadIdx.x] = expf(last - acs[threadIdx.x]);
  cp_async_wait<0>();
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
#pragma unroll 8
  for (int t = 0; t < L; ++t) {  // rows past len are zero
    const float4 xv = ld4(xs + t * LD + 4 * ty);
    const float4 bv = ld4(bs + t * LD + 4 * tx);
    const float d = dec[t];
    const float xr[4] = {xv.x * d, xv.y * d, xv.z * d, xv.w * d};
    const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xr[r], bq[q], acc[r][q]);
  }

  float* out = p.chunk_state + ((static_cast<long long>(b) * p.nc + c) * p.H + h) * p.P * p.N;
  const int n = n0 + 4 * tx;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pp = p0 + 4 * ty + r;
    if (pp >= p.P || n >= p.N) break;
    float* row = out + static_cast<long long>(pp) * p.N + n;
    if (p.N % 4 == 0) {  // 16-byte aligned: n and the row start are multiples of 4
      *reinterpret_cast<float4*>(row) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < p.N) row[q] = acc[r][q];
    }
  }
  if (n0 == 0 && p0 == 0 && threadIdx.x == 0) {
    p.chunk_sum[(static_cast<long long>(b) * p.H + h) * p.nc + c] = last;
  }
}

// Phase B: VEC state values of (b, h) per thread, over the chunks in
// order: s_in[c] = run (in place; s_in[0] = 0 is never read, so not
// written), run = run exp(sum a_c) + state_c; the final state once.  Loads
// go out sixteen chunks at a time: their round trips bound the pass.
template <int VEC>
__global__ void __launch_bounds__(THREADS) ssd_state_pass_kernel(Params p) {
  constexpr int BATCH = 16;
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const long long pn = static_cast<long long>(p.P) * p.N;
  const long long e = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long step = p.H * pn;  // from chunk c to c + 1
  float* sp = p.chunk_state + (static_cast<long long>(b) * p.nc * p.H + h) * pn + e;
  const float* csum = p.chunk_sum + (static_cast<long long>(b) * p.H + h) * p.nc;
  float run[VEC] = {};
  for (int c0 = 0; c0 < p.nc; c0 += BATCH) {
    V v[BATCH];
    float d[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const bool in = c0 + j < p.nc;
      v[j] = in ? *reinterpret_cast<const V*>(sp + (c0 + j) * step) : V{};
      d[j] = in ? expf(csum[c0 + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (c0 + j >= p.nc) break;
      const float* vj = reinterpret_cast<const float*>(&v[j]);
      if (c0 + j > 0) {
        V out;
        float* o = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = run[i];
        *reinterpret_cast<V*>(sp + (c0 + j) * step) = out;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) run[i] = fmaf(run[i], d[j], vj[i]);
    }
  }
  V out;
  float* o = reinterpret_cast<float*>(&out);
#pragma unroll
  for (int i = 0; i < VEC; ++i) o[i] = run[i];
  *reinterpret_cast<V*>(p.state + (static_cast<long long>(b) * p.H + h) * pn + e) = out;
}

// Phase C's shared memory: x [t][p], the masked scores [i][j], a ring of
// 32-column slabs (C [t][n], B [t][n] and, past chunk 0, s_in [p][n]), acs
// and the decay.  With one chunk (STATE) there is no s_in and four stages
// hold N <= 128 whole, so every slab is in flight at once.
constexpr int SLAB = 64 * LDN;
template <bool STATE>
struct OutLayout {
  static constexpr int NST = STATE ? 4 : 2;    // ring stages
  static constexpr int TILES = STATE ? 2 : 3;  // slabs a stage
  static constexpr int bytes = (2 * 64 * LD + NST * TILES * SLAB + 2 * L) * 4;
};

// Phase C: y for one chunk and 64 p columns.  Lane (ty, tx) owns rows
// 16 r + ty (r < 4) and columns 16 q + tx of y, and element (ty, tx) of each
// score sub-tile (r, q) with q <= r: sc[r (r + 1) / 2 + q].  STATE (one
// chunk, so no s_in): the block also writes its 64 rows of the final state,
// sum_t x[t][p] exp(acs[L-1] - acs[t]) B[t][n], slab by slab, and phases
// A and B do not run.
template <typename T, bool STATE>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_out_kernel(Params p) {
  using Lay = OutLayout<STATE>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // x, [t][p]
  float* scs = xs + L * LD;      // exp(segsum) o C B^T, [i][j]
  float* ring = scs + L * LD;    // NST stages of C, B (, s_in) slabs
  float* acs = ring + Lay::NST * Lay::TILES * SLAB;
  float* dec = acs + L;

  const int ptiles = (p.P + TP - 1) / TP;
  const int p0 = blockIdx.x % ptiles * TP;
  const int c = blockIdx.x / ptiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * L, len = min(L, p.S - t0);
  const int live = (len + 15) / 16;  // row groups r holding a real token
  const bool carry = !STATE && c > 0;  // s_in[0] = 0: chunk 0 has no second term
  const int ns = (p.N + TN - 1) / TN;

  const T* cg = static_cast<const T*>(p.Cm) + b * p.cb + t0 * p.cs + g * p.cg;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.bb + t0 * p.bs + g * p.bg;
  const float* sg = p.chunk_state + ((static_cast<long long>(b) * p.nc + c) * p.H + h) * p.P * p.N +
                    static_cast<long long>(p0) * p.N;
  auto issue = [&](int s) {  // slab s into stage s % NST, one commit group
    float* st = ring + s % Lay::NST * Lay::TILES * SLAB;
    const int n0 = s * TN, cols = min(TN, p.N - n0);
    load_tile<T, TN, LDN>(st, cg + n0, p.cs, len, cols, p.vec);
    load_tile<T, TN, LDN>(st + SLAB, bg + n0, p.bs, len, cols, p.vec);
    if (carry) load_tile<float, TN, LDN>(st + 2 * SLAB, sg + n0, p.N, p.P - p0, cols, p.vec);
    cp_async_commit();
  };
  const float av = load_a(p, b, h, t0, len);
  load_tile<T, 64, LD>(xs, static_cast<const T*>(p.x) + b * p.xb + t0 * p.xs + h * p.xh + p0,
                       p.xs, len, p.P - p0, p.vec);
  for (int s = 0; s < min(ns, Lay::NST); ++s) issue(s);  // x goes with slab 0's group
  chunk_cumsum(av, acs);
  if (STATE && threadIdx.x < L) dec[threadIdx.x] = expf(acs[L - 1] - acs[threadIdx.x]);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[10] = {};
  float yo[4][4] = {};
  for (int s = 0; s < ns; ++s) {
    cp_async_wait_pending(min(ns - s - 1, Lay::NST - 1));  // slab s has landed
    __syncthreads();
    const float* cs = ring + s % Lay::NST * Lay::TILES * SLAB;
    const float* bs = cs + SLAB;
    const float* ss = bs + SLAB;
#pragma unroll
    for (int k = 0; k < TN; k += 4) {  // columns past N are zero
      float4 cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (16 * r + ty) * LDN + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= live) break;  // sub-tiles (r >= q, q) of rows past the chunk's tokens
        const float4 bv = ld4(bs + (16 * q + tx) * LDN + k);
#pragma unroll
        for (int r = q; r < 4; ++r) sc[r * (r + 1) / 2 + q] = dot4(cv[r], bv, sc[r * (r + 1) / 2 + q]);
      }
      if (carry) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 sv = ld4(ss + (16 * q + tx) * LDN + k);
#pragma unroll
          for (int r = 0; r < 4; ++r) yo[r][q] = dot4(cv[r], sv, yo[r][q]);
        }
      }
    }
    if (STATE) {  // lane: state rows p0 + 16 r + ty, columns 2 tx, 2 tx + 1 of the slab
      float st[4][2] = {};
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + t * LDN + 2 * tx);
        const float d = dec[t];
        const float b0 = bv.x * d, b1 = bv.y * d;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xv = xs[t * LD + 16 * r + ty];
          st[r][0] = fmaf(xv, b0, st[r][0]);
          st[r][1] = fmaf(xv, b1, st[r][1]);
        }
      }
      const int n = s * TN + 2 * tx;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pp = p0 + 16 * r + ty;
        if (pp >= p.P) break;
        float* row = p.state + ((static_cast<long long>(b) * p.H + h) * p.P + pp) * p.N;
        if (n < p.N) row[n] = st[r][0];
        if (n + 1 < p.N) row[n + 1] = st[r][1];
      }
    }
    __syncthreads();  // stage s % NST is read: slab s + NST may go there
    if (s + Lay::NST < ns) issue(s + Lay::NST);
  }

  // the scores times exp(segsum): exp(acs[i] - acs[j]) for j <= i, else 0;
  // the second term's row decay exp(acs[i])
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 16 * r + ty;
    const float ai = acs[i];
#pragma unroll
    for (int q = 0; q <= r; ++q) {
      const int j = 16 * q + tx;
      scs[i * LD + j] = j <= i ? sc[r * (r + 1) / 2 + q] * expf(ai - acs[j]) : 0.f;
    }
    if (carry) {
      const float e = expf(ai);
#pragma unroll
      for (int q = 0; q < 4; ++q) yo[r][q] *= e;
    }
  }
  __syncthreads();

  // y += scores x, over the key blocks jb <= r only
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    if (16 * jb >= len) break;
#pragma unroll
    for (int k = 16 * jb; k < 16 * jb + 16; k += 4) {
      float4 xv[4];  // xv[q]: x[k..k+3][16 q + tx]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* col = xs + k * LD + 16 * q + tx;
        xv[q] = make_float4(col[0], col[LD], col[2 * LD], col[3 * LD]);
      }
#pragma unroll
      for (int r = jb; r < 4; ++r) {
        const float4 sv = ld4(scs + (16 * r + ty) * LD + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) yo[r][q] = dot4(sv, xv[q], yo[r][q]);
      }
    }
  }

  T* yb = static_cast<T*>(p.y) + ((static_cast<long long>(b) * p.S + t0) * p.H + h) * p.P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = 16 * r + ty;
    if (t >= len) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = p0 + 16 * q + tx;
      if (pp < p.P) yb[static_cast<long long>(t) * p.H * p.P + pp] = from_f<T>(yo[r][q]);
    }
  }
}

// Above 48 KB a block's shared memory must be asked for, once per kernel
// and device (`done`: bit d set once device d allows it).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(done >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) done |= 1ull << dev;
  }
  return e;
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t s) {
  static unsigned long long done[2] = {0, 0};
  const int ptiles = (p.P + TP - 1) / TP;
  if (p.nc == 1) {  // one chunk: phase C alone, with the state
    constexpr int bytes = OutLayout<true>::bytes;
    const cudaError_t e = allow_smem(ssd_chunk_out_kernel<T, true>, bytes, done[0]);
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_chunk_out_kernel<T, true><<<dim3(ptiles, p.H, B), THREADS, bytes, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int bytes = OutLayout<false>::bytes;
  const cudaError_t e = allow_smem(ssd_chunk_out_kernel<T, false>, bytes, done[1]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntiles = (p.N + TA - 1) / TA;
  ssd_chunk_state_kernel<T><<<dim3(p.nc * ptiles * ntiles, p.H, B), THREADS, 0, s>>>(p);
  const long long pn = static_cast<long long>(p.P) * p.N;
  if (pn % 4 == 0) {
    const unsigned blocks = static_cast<unsigned>((pn / 4 + THREADS - 1) / THREADS);
    ssd_state_pass_kernel<4><<<dim3(blocks, p.H, B), THREADS, 0, s>>>(p);
  } else {
    const unsigned blocks = static_cast<unsigned>((pn + THREADS - 1) / THREADS);
    ssd_state_pass_kernel<1><<<dim3(blocks, p.H, B), THREADS, 0, s>>>(p);
  }
  ssd_chunk_out_kernel<T, false><<<dim3(p.nc * ptiles, p.H, B), THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  a and the state are
// float32.  Strides are in elements: x (batch, token, head), a (batch,
// head, token), B and C (batch, token, group); the last dimension of x, B
// and C is contiguous, y is contiguous (B, S, H, P).  With nc = ceil(S / 64)
// chunks above 1, chunk_state holds B * nc * H * P * N floats and chunk_sum
// B * H * nc; with one chunk both may be null.
extern "C" int rt_ssd_scan(int dtype, const void* x, const void* a, const void* Bm,
                           const void* Cm, void* y, void* state, void* chunk_state,
                           void* chunk_sum, long long xb, long long xs, long long xh,
                           long long ab, long long ah, long long as, long long bb, long long bs,
                           long long bg, long long cb, long long cs, long long cg, int B, int S,
                           int H, int G, int P, int N, void* stream) {
  if (S <= 0 || N <= 0 || N > MAX_N || P <= 0 || G <= 0 || H % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = (S + L - 1) / L;
  if (nc > 1 && (chunk_state == nullptr || chunk_sum == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0) return 0;
  float* sf = static_cast<float*>(state);
  auto al = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool vec = dtype == 0 && al(x) && al(Bm) && al(Cm) && P % 4 == 0 && N % 4 == 0 &&
                   (xb | xs | xh | bb | bs | bg | cb | cs | cg) % 4 == 0;
  const Params p{x, static_cast<const float*>(a), Bm, Cm, y, sf,
                 nc > 1 ? static_cast<float*>(chunk_state) : sf, static_cast<float*>(chunk_sum),
                 xb, xs, xh, ab, ah, as, bb, bs, bg, cb, cs, cg, S, H, G, P, N, nc, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
