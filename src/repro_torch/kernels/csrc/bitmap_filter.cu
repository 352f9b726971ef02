// Fused multi-predicate range filter -> int8 bitmap.
//
// Replaces src/repro/kernels/bitmap_filter.py::bitmap_filter (the Pallas
// kernel _bitmap_kernel): out[i] = AND over j of lo_j <= cols[i, j] <= hi_j,
// inclusive, as 0/1 int8.  A NaN value fails its check, as in numpy.
//
// What bounds it on Hopper: bytes.  It reads 4*c bytes and writes one byte
// per row and does 2*c compares, so it is one grid-stride pass, a thread
// per row, with the c bounds read through the cache; neighbouring threads
// read neighbouring rows, so each warp's loads and stores are contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitmap_filter_kernel(const float* __restrict__ cols,
                     const float* __restrict__ bounds,
                     int8_t* __restrict__ out, long long n, int c) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    bool ok = true;
    for (int j = 0; j < c; ++j) {
      const float v = cols[i * c + j];
      ok = ok && (v >= __ldg(bounds + 2 * j)) && (v <= __ldg(bounds + 2 * j + 1));
    }
    out[i] = ok ? 1 : 0;
  }
}

}  // namespace

// cols (n, c) fp32 row-major; bounds (c, 2) fp32 [lo, hi]; out (n,) int8.
extern "C" int bitmap_filter_launch(const float* cols, const float* bounds,
                                    int8_t* out, long long n, int c,
                                    int max_blocks, void* stream) {
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  bitmap_filter_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(cols, bounds,
                                                              out, n, c);
  return (int)cudaGetLastError();
}
