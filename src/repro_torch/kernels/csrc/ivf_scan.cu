// Dense squared-L2 distance matrix.
//
// Replaces src/repro/kernels/ivf_scan.py::ivf_scan (the Pallas kernel
// _ivf_scan_kernel): out[i, j] = (||q_i||^2 - 2 q_i.x_j) + ||x_j||^2 in
// fp32, the same expansion and evaluation order.  Rows the host pads with
// 1e30 overflow ||x_j||^2 to +inf and come out +inf, as in the reference.
//
// What bounds it on Hopper: at the main path's shapes, neither bytes nor
// flops but the launch.  Its callers (k-means assignment at flush, IVF
// centroid scoring, posting-list and memtable distances) hand it small
// matrices many times, so it is a plain one-pass tiled kernel with no
// set-up: a 256-thread block computes a 64 x 64 output tile, staging 16
// features of each operand in shared memory per step, each thread
// accumulating a 4 x 4 sub-tile plus the row norms it needs in fp32 FMA
// (no TF32, no tensor cores).  Tiles at the ragged edges are masked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTm = 64;       // query rows per block
constexpr int kTn = 64;       // x rows per block
constexpr int kTk = 16;       // features per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int nq, int n, int d) {
  __shared__ float qs[kTk][kTm + 1];
  __shared__ float xs[kTk][kTn + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * kTm;
  const long long n0 = (long long)blockIdx.x * kTn;

  float acc[4][4] = {};
  float qn[4] = {}, xn[4] = {};
  for (int k0 = 0; k0 < d; k0 += kTk) {
#pragma unroll
    for (int u = 0; u < (kTm * kTk) / kThreads; ++u) {
      const int e = tid + kThreads * u;
      const int row = e / kTk, kk = e % kTk;
      const long long gm = m0 + row, gn = n0 + row;
      const int gk = k0 + kk;
      qs[kk][row] = (gm < nq && gk < d) ? q[gm * d + gk] : 0.f;
      xs[kk][row] = (gn < n && gk < d) ? x[gn * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qn[i] = fmaf(a[i], a[i], qn[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) xn[j] = fmaf(b[j], b[j], xn[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gn = n0 + tx + 16 * j;
      if (gn < n) out[gm * n + gn] = (qn[i] - 2.f * acc[i][j]) + xn[j];
    }
  }
}

}  // namespace

// q (nq, d), x (n, d), out (nq, n); all fp32, row-major, contiguous.
extern "C" int ivf_scan_launch(const float* q, const float* x, float* out,
                               int nq, int n, int d, void* stream) {
  if (nq == 0 || n == 0) return 0;
  const dim3 grid((n + kTn - 1) / kTn, (nq + kTm - 1) / kTm);
  ivf_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, x, out, nq, n, d);
  return (int)cudaGetLastError();
}
