// Overlay patch: materialize a restored tensor on the device from a
// device-resident BASE image, a compact array of PRIVATE pages uploaded from
// the snapshot, and implicit ZERO pages, by a per-page classification table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/overlay_patch/kernel.py
// (overlay_patch_kernel, pallas_call at :63), where a scalar-prefetched page
// table chose which private page each grid step streamed into VMEM.
//
// Bound on an H100: pure data movement, so device memory bandwidth.  The
// least time is (bytes written + BASE and PRIVATE bytes read) / 3.35 TB/s.
// Design: one block per page (grid-stride over pages when there are more
// pages than blocks); each block reads its own kinds[i] and src[i], then
// copies the page with 16-byte vector loads and stores, neighbouring threads
// on neighbouring addresses.  A ZERO page is written without reading
// anything.  The kernel works on bytes, so one instance serves f32, bf16 and
// int8 alike; a byte-wise instance covers pages or pointers that are not
// 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_BASE = 1;
constexpr int KIND_PRIVATE = 2;
constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

template <typename V>
__global__ void __launch_bounds__(THREADS)
overlay_patch_kernel(const V* __restrict__ base, const V* __restrict__ priv,
                     const int32_t* __restrict__ kinds,
                     const int32_t* __restrict__ src, V* __restrict__ out,
                     int64_t n_pages, int64_t page_vecs, int64_t n_priv) {
  for (int64_t page = blockIdx.x; page < n_pages; page += gridDim.x) {
    const int kind = kinds[page];
    V* dst = out + page * page_vecs;
    const V* from = nullptr;
    if (kind == KIND_BASE) {
      from = base + page * page_vecs;
    } else if (kind == KIND_PRIVATE && n_priv > 0) {
      int64_t s = src[page];
      s = s < 0 ? 0 : (s > n_priv - 1 ? n_priv - 1 : s);
      from = priv + s * page_vecs;
    }
    if (from != nullptr) {
#pragma unroll 4
      for (int64_t i = threadIdx.x; i < page_vecs; i += THREADS) dst[i] = from[i];
    } else {  // ZERO page (or PRIVATE with no private pages: a zero dummy)
      const V zero{};
#pragma unroll 4
      for (int64_t i = threadIdx.x; i < page_vecs; i += THREADS) dst[i] = zero;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int rt_overlay_patch(const void* base, const void* priv,
                                const void* kinds, const void* src, void* out,
                                long long n_pages, long long page_bytes,
                                long long n_priv, void* stream) {
  if (n_pages <= 0) return 0;
  const int blocks = static_cast<int>(n_pages < MAX_BLOCKS ? n_pages : MAX_BLOCKS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = page_bytes % 16 == 0 && aligned16(base) && aligned16(out) &&
                   (n_priv == 0 || aligned16(priv));
  if (vec) {
    overlay_patch_kernel<uint4><<<blocks, THREADS, 0, s>>>(
        static_cast<const uint4*>(base), static_cast<const uint4*>(priv),
        static_cast<const int32_t*>(kinds), static_cast<const int32_t*>(src),
        static_cast<uint4*>(out), n_pages, page_bytes / 16, n_priv);
  } else {
    overlay_patch_kernel<uint8_t><<<blocks, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(base), static_cast<const uint8_t*>(priv),
        static_cast<const int32_t*>(kinds), static_cast<const int32_t*>(src),
        static_cast<uint8_t*>(out), n_pages, page_bytes, n_priv);
  }
  return static_cast<int>(cudaGetLastError());
}
