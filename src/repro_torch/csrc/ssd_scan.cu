// Mamba2 SSD scan: y and the final state of the selective state-space
// recurrence, per (batch, head), for x (B, S, H, P) already times dt,
// a = dt * A (B, H, S) f32, and B / C (B, S, G, N) with head h reading group
// h / (H / G).  y comes out in x's type, the state (B, H, P, N) in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_kernel, pallas_call at :88), whose sequential chunk grid axis
// carried the (P, N) state in VMEM scratch and computed each chunk in the
// chunked (matrix) form: y = ((C B^T) o L) x + (C state^T) exp(cumsum a),
// state <- state exp(sum a) + x^T (B decay).
//
// Design: the recurrence that chunked form expands,
//   h_t = exp(a_t) h_{t-1} + x_t B_t^T,   y_t = C_t . h_t   (per row p of h),
// token by token.  It does the fewest operations (4 P N per token and head,
// against 2 l (N + P) + 4 N P for the chunked form at chunk l), needs no
// cumsum and no exp of segment sums, and carries the state in registers
// from the first token to the last, so the chunk only keeps the reference's
// divisibility contract.  One block per (b, h, 16 state rows); each of its 4
// warps owns 4 rows, and a lane holds N / 32 state values of each row (4 at
// N = 128).  The block stages a tile of 16 tokens' B and C rows (shared by
// all rows of the head), x and exp(a) in shared memory, all loads of a tile
// in flight at once.  A lane keeps its partial C_t . h_t per row and token
// of the tile in registers, and the warp sums 32 of them at a time with one
// transpose-reduction (31 shuffles), so no shuffle sits on the token loop's
// dependency chain.  The state is written once, at the end.  bf16 inputs
// are widened to f32 on the way into shared memory.
//
// Bound on an H100: at serving prompts (S = 16) the bytes of x, y, B, C and
// the f32 state bound it; at long prompts the f32 operations do (4 B S H P N
// at 67 TFLOP/s).  The token loop is sequential per block, so at B = 1 the
// card holds H * P / 16 blocks; the chunked form on tensor cores is the
// later redesign for long prompts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;                  // state rows per warp
constexpr int ROWS = WARPS * RPW;       // state rows per block
constexpr int TILE = 16;                // tokens staged in shared memory
constexpr int MAX_N = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sums v[k] over the warp for 32 values at once: lane k ends with the sum
// of every lane's v[k].  Each round halves the values a lane holds (lanes
// above the round's bit keep the upper half, the others the lower half and
// add what the partner sends), so 32 sums take 31 shuffles, not 32 x 5.
// Both halves are read into scalars before the select: a select between
// two array elements compiles to a computed address, which puts v in
// local memory (it did, and the local-memory traffic took most of the
// kernel's time).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = lane & half;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float lo = v[i], hi = v[i + half];
      const float send = upper ? lo : hi;
      const float keep = upper ? hi : lo;
      v[i] = keep + __shfl_xor_sync(FULL, send, half);
    }
  }
  return v[0];
}

// NPL: state values per lane and row (N <= 32 * NPL)
template <typename T, int NPL>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                T* __restrict__ y, float* __restrict__ state_out,
                int S, int H, int G, int P, int N) {
  static_assert(TILE == 16 && RPW % 2 == 0, "2 rows x 16 tokens per transpose-sum");
  __shared__ float bs[TILE][MAX_N];
  __shared__ float cs[TILE][MAX_N];
  __shared__ float xs[TILE][ROWS];
  __shared__ float ys[TILE][ROWS];
  __shared__ float da[TILE];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.z * ROWS;             // first state row of the block
  const int rows = min(ROWS, P - p0);
  const int g = h / (H / G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // x[b, t, h, p] and y alike: base + t * H * P + p
  const int64_t x_step = static_cast<int64_t>(H) * P;
  const T* xb = x + (static_cast<int64_t>(b) * S * H + h) * P + p0;
  T* yb = y + (static_cast<int64_t>(b) * S * H + h) * P + p0;
  // B[b, t, g, n]: base + t * G * N + n
  const int64_t bc_step = static_cast<int64_t>(G) * N;
  const T* bb = Bm + (static_cast<int64_t>(b) * S * G + g) * N;
  const T* cb = Cm + (static_cast<int64_t>(b) * S * G + g) * N;
  const float* ab = a + (static_cast<int64_t>(b) * H + h) * S;

  float st[RPW][NPL];  // row warp + WARPS * r, columns lane + 32 * j
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < NPL; ++j) st[r][j] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int nt = min(TILE, S - t0);
    __syncthreads();  // the previous tile's y is written out
    // Every load of the tile is issued before the first store, with no
    // branch between them (indices past the tile are clamped to its last
    // token or row, whose copies no one reads), so a tile pays one memory
    // latency and not one per element.  A thread loads whole columns of B
    // and C, two (token, row) cells of x and, below TILE, one exp(a).
    static_assert(TILE * ROWS == 2 * THREADS, "two x cells per thread");
    const int last = nt - 1;
    const int xe0 = threadIdx.x, xe1 = threadIdx.x + THREADS;
    const float x0 = to_f(xb[(t0 + min(xe0 / ROWS, last)) * x_step + min(xe0 % ROWS, rows - 1)]);
    const float x1 = to_f(xb[(t0 + min(xe1 / ROWS, last)) * x_step + min(xe1 % ROWS, rows - 1)]);
    const float a0 = ab[t0 + min(static_cast<int>(threadIdx.x) % TILE, last)];
    for (int n = threadIdx.x; n < N; n += THREADS) {
      float bt[TILE], ct[TILE];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const int64_t off = (t0 + min(t, last)) * bc_step + n;
        bt[t] = to_f(bb[off]);
        ct[t] = to_f(cb[off]);
      }
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        bs[t][n] = bt[t];
        cs[t][n] = ct[t];
      }
    }
    xs[xe0 / ROWS][xe0 % ROWS] = x0;
    xs[xe1 / ROWS][xe1 % ROWS] = x1;
    if (threadIdx.x < TILE) da[threadIdx.x] = expf(a0);
    __syncthreads();

    // the recurrence; each lane keeps its partial C_t . h_t per row and
    // token, and the warp sums them once per tile
    float part[RPW][TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      if (t < nt) {
        const float decay = da[t];
        float bv[NPL], cv[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int n = lane + 32 * j;
          bv[j] = n < N ? bs[t][n] : 0.f;  // columns past N stay 0
          cv[j] = n < N ? cs[t][n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int p = warp + WARPS * r;
          const float xv = p < rows ? xs[t][p] : 0.f;  // rows past P stay 0
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < NPL; ++j) {
            st[r][j] = fmaf(decay, st[r][j], xv * bv[j]);
            acc = fmaf(cv[j], st[r][j], acc);
          }
          part[r][t] = acc;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RPW; ++r) part[r][t] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < RPW / 2; ++q) {  // rows 2q, 2q + 1 x 16 tokens
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = part[2 * q + k / TILE][k % TILE];
      const float sum = warp_transpose_sum(v, lane);
      const int t = lane % TILE;
      const int p = warp + WARPS * (2 * q + lane / TILE);
      if (t < nt && p < rows) ys[t][p] = sum;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt * rows; i += THREADS) {
      const int t = i / rows, p = i % rows;
      yb[(t0 + t) * x_step + p] = from_f<T>(ys[t][p]);
    }
  }

  float* so = state_out + ((static_cast<int64_t>(b) * H + h) * P + p0) * N;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int p = warp + WARPS * r;
    if (p >= rows) break;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = lane + 32 * j;
      if (n < N) so[static_cast<int64_t>(p) * N + n] = st[r][j];
    }
  }
}

template <typename T, int NPL>
void launch(const void* x, const float* a, const void* Bm, const void* Cm,
            void* y, float* state, int B, int S, int H, int G, int P, int N,
            cudaStream_t s) {
  dim3 grid(H, B, (P + ROWS - 1) / ROWS);
  ssd_scan_kernel<T, NPL><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, S, H, G, P, N);
}

template <typename T>
int dispatch_n(const void* x, const float* a, const void* Bm, const void* Cm,
               void* y, float* state, int B, int S, int H, int G, int P, int N,
               cudaStream_t s) {
  if (N <= 32) {
    launch<T, 1>(x, a, Bm, Cm, y, state, B, S, H, G, P, N, s);
  } else if (N <= 64) {
    launch<T, 2>(x, a, Bm, Cm, y, state, B, S, H, G, P, N, s);
  } else if (N <= 128) {
    launch<T, 4>(x, a, Bm, Cm, y, state, B, S, H, G, P, N, s);
  } else {
    launch<T, 8>(x, a, Bm, Cm, y, state, B, S, H, G, P, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  a and the state are
// float32.  Every tensor is contiguous in the layout named above.
extern "C" int rt_ssd_scan(int dtype, const void* x, const void* a,
                           const void* Bm, const void* Cm, void* y,
                           void* state, int B, int S, int H, int G, int P,
                           int N, void* stream) {
  if (S <= 0 || N <= 0 || N > MAX_N || P <= 0 || G <= 0 || H % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  if (dtype == 0) return dispatch_n<float>(x, af, Bm, Cm, y, sf, B, S, H, G, P, N, s);
  if (dtype == 1) {
    return dispatch_n<__nv_bfloat16>(x, af, Bm, Cm, y, sf, B, S, H, G, P, N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
