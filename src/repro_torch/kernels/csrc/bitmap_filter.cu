// Fused multi-predicate range filter -> int8 bitmap, in two entry points.
//
// Replaces src/repro/kernels/bitmap_filter.py::bitmap_filter (the Pallas
// kernel _bitmap_kernel): out[i] = AND over j of lo_j <= cols[i, j] <= hi_j,
// inclusive, as 0/1 int8.  A NaN value fails its check, as in numpy.
//
// bitmap_filter_kernel takes a whole (n, c) column tile: the per-block
// call of the JAX package's range_bitmap, and the port's whole-column and
// memtable callers.
//
// bitmap_filter_blocks_kernel is the spatial index's range probe in one
// launch: the JAX package's ZOrderIndex.bitmap calls the Pallas kernel
// once per 128-row block whose zone map overlaps the rectangle
// (src/repro/core/index/spatial.py, bitmap) and scatters each block's
// bits through the index's row ids on the host.  Here the segment's
// Z-ordered points and row ids stay on the card, and one launch walks the
// whole list of overlapping blocks and sets out[rows[i]] = 1 for every
// point i inside the bounds, so a query costs one launch instead of one
// round trip per block.  rows is a permutation, so no two threads write
// the same byte and no atomics are needed; out is zeroed by the caller on
// the stream before the launch.
//
// What bounds both on Hopper: bytes.  A point costs 4*c bytes of values
// (plus 4 of row id in the list kernel) and 2*c compares, so each is one
// pass in which neighbouring threads read neighbouring points (coalesced
// loads), with the c bounds read through the read-only cache.  At a
// query's few hundred listed blocks the list kernel moves well under a
// megabyte, so its launch latency and the caller's memset and copy of the
// mask back to the host cost more than the pass itself.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kListThreads = 128;   // one block of threads per list entry

__device__ __forceinline__ bool inside(const float* __restrict__ row,
                                       const float* __restrict__ bounds,
                                       int c) {
  bool ok = true;
  for (int j = 0; j < c; ++j) {
    const float v = row[j];
    ok = ok && (v >= __ldg(bounds + 2 * j)) && (v <= __ldg(bounds + 2 * j + 1));
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
bitmap_filter_kernel(const float* __restrict__ cols,
                     const float* __restrict__ bounds,
                     int8_t* __restrict__ out, long long n, int c) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    out[i] = inside(cols + i * c, bounds, c) ? 1 : 0;
  }
}

// Each block of threads takes list entries blockIdx.x, blockIdx.x +
// gridDim.x, ...; its threads walk the entry's block_rows points.  A
// block id outside [0, ceil(n / block_rows)) and a row id outside
// [0, n_out) are skipped, as the plain version skips them.
__global__ void __launch_bounds__(kListThreads)
bitmap_filter_blocks_kernel(const float* __restrict__ cols,
                            const int* __restrict__ rows,
                            const int* __restrict__ blocks,
                            const float* __restrict__ bounds,
                            int8_t* __restrict__ out, long long n, int nb,
                            int c, int block_rows, long long n_out) {
  for (int e = blockIdx.x; e < nb; e += gridDim.x) {
    const long long b = __ldg(blocks + e);
    const long long lo = b * block_rows;
    if (b < 0 || lo >= n) continue;
    const long long hi = lo + block_rows < n ? lo + block_rows : n;
    for (long long i = lo + threadIdx.x; i < hi; i += kListThreads) {
      if (!inside(cols + i * c, bounds, c)) continue;
      const long long r = __ldg(rows + i);
      if (r >= 0 && r < n_out) out[r] = 1;
    }
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

// cols (n, c) fp32 row-major and rows (n,) int32, a segment's points in
// index order and each one's segment row; blocks (nb,) int32 block ids of
// block_rows points each; bounds (c, 2) fp32 [lo, hi]; out (n_out,) int8,
// zeroed before the launch.
extern "C" int bitmap_filter_blocks_launch(const float* cols, const int* rows,
                                           const int* blocks,
                                           const float* bounds, int8_t* out,
                                           long long n, int nb, int c,
                                           int block_rows, long long n_out,
                                           int max_blocks, void* stream) {
  if (nb == 0 || n == 0) return 0;
  const int grid = nb < max_blocks ? nb : max_blocks;
  bitmap_filter_blocks_kernel<<<(unsigned)grid, kListThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      cols, rows, blocks, bounds, out, n, nb, c, block_rows, n_out);
  return (int)cudaGetLastError();
}
