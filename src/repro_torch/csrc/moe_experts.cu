// K5, the grouped expert MLP of a dropless MoE layer: for each (token,
// choice) pair routed to an expert held here, sorted by expert,
//   out[tok[r]] += gate[r] * (silu(x[tok[r]] W_g,e) * x[tok[r]] W_u,e) W_d,e
// with x (T, d), the weights (E, d, f), (E, d, f), (E, f, d), f32 throughout.
// offsets (E + 1, int32) cuts the sorted pairs by expert; the pairs past
// offsets[E] (routed to experts held on other chips) are not read.
//
// Replaces no TPU kernel: the JAX package's MoE (src/repro/models/moe.py)
// pads every expert to a capacity and drops the pairs past it, in jnp.  It
// was added for Granite's dropless layer, where no single PyTorch call
// computes a grouped MLP over tokens sorted by expert, and padding each of
// the held experts to a dropless capacity does ~7x the useful work.
//
// Design: two launches, each a grouped f32 GEMM over 64-pair row tiles
// (a tile never spans two experts) and 64-column output tiles, BK = 16,
// 256 threads a block with a 4 x 4 register tile each, f32 FMAs on the CUDA
// cores (IEEE products, no TF32).  The routing's counts never reach the
// host: each block finds its tiles from offsets, walking the row tiles of
// all experts with a stride of gridDim.x, so the grid is sized from a bound
// on the pairs and a block past the last tile returns at once.
//   gate_up: A = x's rows gathered through tok, B = W_g,e and W_u,e, two
//     accumulators; epilogue silu(g) * u into the (pairs, f) scratch h.
//     Block (0, 0) adds offsets[E] to the held-pairs counter.
//   down: A = h's rows, B = W_d,e; epilogue times the pair's gate,
//     atomically added into out's token row (a token's held pairs lie in
//     different experts, so in different blocks: the order of those few
//     additions is not fixed, within f32 rounding).
// Tiles stream through registers: the next k-slab is loaded from device
// memory while the current one is multiplied out of shared memory.
//
// Bound on an H100: at a prefill of thousands of tokens the 6 d f flops a
// pair at 67 TFLOP/s; at a decode step of a few tokens the weights of the
// experts that have a pair (3 d f floats each) at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // pairs a row tile
constexpr int BN = 64;   // output columns a tile
constexpr int BK = 16;   // reduction slab
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;  // pitch of the transposed A slab (floats)
constexpr int MAX_ROW_BLOCKS_GATE_UP = 96;  // blocks along the row tiles (x f / BN)
constexpr int MAX_ROW_BLOCKS_DOWN = 24;     // (x d / BN)

struct Params {
  const float* x;        // (T, d)
  const int* tok;        // (rows,) token of each sorted pair
  const float* gate;     // (rows,)
  const int* off;        // (E + 1,)
  const float* wg;       // (E, d, f)
  const float* wu;       // (E, d, f)
  const float* wd;       // (E, f, d)
  float* h;              // (rows, f) scratch
  float* out;            // (T, d)
  unsigned long long* held;  // pairs computed here, added to once a call
  int d, f, E;
};

// The row tile `slot` of the grouped problem: its expert and pair range.
// Returns false past the last tile.
__device__ __forceinline__ bool locate(const int* off, int E, int slot, int* e, int* r0,
                                       int* r1) {
  int acc = 0;
  for (int i = 0; i < E; ++i) {
    const int a = off[i], b = off[i + 1];
    const int t = (b - a + BM - 1) / BM;
    if (slot < acc + t) {
      *e = i;
      *r0 = a + (slot - acc) * BM;
      *r1 = min(*r0 + BM, b);
      return true;
    }
    acc += t;
  }
  return false;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(THREADS) moe_experts_gate_up_kernel(Params p) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && p.held != nullptr) {
    atomicAdd(p.held, static_cast<unsigned long long>(p.off[p.E]));
  }
  __shared__ __align__(16) float As[BK][LDA];
  __shared__ __align__(16) float Bg[BK][BN];
  __shared__ __align__(16) float Bu[BK][BN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int la = tid >> 2, lk = (tid & 3) * 4;   // A loader: row, k quad
  const int lb = tid >> 4, ln = (tid & 15) * 4;  // B loader: k row, column quad
  const int n0 = blockIdx.y * BN;
  const int d = p.d, f = p.f;
  int e, r0, r1;
  for (int slot = blockIdx.x; locate(p.off, p.E, slot, &e, &r0, &r1); slot += gridDim.x) {
    const float* arow = r0 + la < r1 ? p.x + static_cast<long long>(p.tok[r0 + la]) * d : nullptr;
    const long long wbase = static_cast<long long>(e) * d * f + n0 + ln;
    const float* wg = p.wg + wbase;
    const float* wu = p.wu + wbase;
    float ag[4][4] = {}, au[4][4] = {};
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ra = arow ? *reinterpret_cast<const float4*>(arow + lk) : zero;
    float4 rg = *reinterpret_cast<const float4*>(wg + static_cast<long long>(lb) * f);
    float4 ru = *reinterpret_cast<const float4*>(wu + static_cast<long long>(lb) * f);
    for (int k0 = 0; k0 < d; k0 += BK) {
      __syncthreads();  // the previous slab (or tile) is multiplied out
      As[lk + 0][la] = ra.x;
      As[lk + 1][la] = ra.y;
      As[lk + 2][la] = ra.z;
      As[lk + 3][la] = ra.w;
      *reinterpret_cast<float4*>(&Bg[lb][ln]) = rg;
      *reinterpret_cast<float4*>(&Bu[lb][ln]) = ru;
      __syncthreads();
      const int k1 = k0 + BK;
      if (k1 < d) {
        ra = arow ? *reinterpret_cast<const float4*>(arow + k1 + lk) : zero;
        rg = *reinterpret_cast<const float4*>(wg + static_cast<long long>(k1 + lb) * f);
        ru = *reinterpret_cast<const float4*>(wu + static_cast<long long>(k1 + lb) * f);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        fma4x4(ag, a, *reinterpret_cast<const float4*>(&Bg[kk][tx * 4]));
        fma4x4(au, a, *reinterpret_cast<const float4*>(&Bu[kk][tx * 4]));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r < r1) {
        float4 v;
        v.x = silu(ag[i][0]) * au[i][0];
        v.y = silu(ag[i][1]) * au[i][1];
        v.z = silu(ag[i][2]) * au[i][2];
        v.w = silu(ag[i][3]) * au[i][3];
        *reinterpret_cast<float4*>(p.h + static_cast<long long>(r) * f + n0 + tx * 4) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) moe_experts_down_kernel(Params p) {
  __shared__ __align__(16) float As[BK][LDA];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int la = tid >> 2, lk = (tid & 3) * 4;
  const int lb = tid >> 4, ln = (tid & 15) * 4;
  const int n0 = blockIdx.y * BN;
  const int d = p.d, f = p.f;
  int e, r0, r1;
  for (int slot = blockIdx.x; locate(p.off, p.E, slot, &e, &r0, &r1); slot += gridDim.x) {
    const float* arow = r0 + la < r1 ? p.h + static_cast<long long>(r0 + la) * f : nullptr;
    const float* w = p.wd + static_cast<long long>(e) * f * d + n0 + ln;
    float acc[4][4] = {};
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ra = arow ? *reinterpret_cast<const float4*>(arow + lk) : zero;
    float4 rb = *reinterpret_cast<const float4*>(w + static_cast<long long>(lb) * d);
    for (int k0 = 0; k0 < f; k0 += BK) {
      __syncthreads();
      As[lk + 0][la] = ra.x;
      As[lk + 1][la] = ra.y;
      As[lk + 2][la] = ra.z;
      As[lk + 3][la] = ra.w;
      *reinterpret_cast<float4*>(&Bs[lb][ln]) = rb;
      __syncthreads();
      const int k1 = k0 + BK;
      if (k1 < f) {
        ra = arow ? *reinterpret_cast<const float4*>(arow + k1 + lk) : zero;
        rb = *reinterpret_cast<const float4*>(w + static_cast<long long>(k1 + lb) * d);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        fma4x4(acc, *reinterpret_cast<const float4*>(&As[kk][ty * 4]),
               *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r < r1) {
        const float g = p.gate[r];
        float* o = p.out + static_cast<long long>(p.tok[r]) * d + n0 + tx * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(o + j, g * acc[i][j]);
      }
    }
  }
}

}  // namespace

// Pointers to contiguous f32 tensors (tok and offsets int32); d and f are
// multiples of 64; rows bounds the held pairs (h holds rows x f floats).
// Two launches on `stream`; returns the first CUDA error.
extern "C" int rt_moe_experts(const void* x, const void* tok, const void* gate,
                              const void* offsets, const void* wg, const void* wu,
                              const void* wd, void* h, void* out, void* held, int d, int f, int E,
                              int rows, void* stream) {
  if (d <= 0 || f <= 0 || E <= 0 || rows < 0 || d % BN != 0 || f % BN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Params p{static_cast<const float*>(x), static_cast<const int*>(tok),
                 static_cast<const float*>(gate), static_cast<const int*>(offsets),
                 static_cast<const float*>(wg), static_cast<const float*>(wu),
                 static_cast<const float*>(wd), static_cast<float*>(h), static_cast<float*>(out),
                 static_cast<unsigned long long*>(held), d, f, E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every expert may end on a partial tile: at most rows / BM + E row tiles
  const int tiles = (rows + BM - 1) / BM + E;
  moe_experts_gate_up_kernel<<<dim3(min(tiles, MAX_ROW_BLOCKS_GATE_UP), f / BN), THREADS, 0,
                               s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_experts_down_kernel<<<dim3(min(tiles, MAX_ROW_BLOCKS_DOWN), d / BN), THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
