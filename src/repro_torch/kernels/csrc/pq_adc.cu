// Single-query PQ asymmetric distance (ADC) over a code matrix.
//
// Replaces src/repro/kernels/pq_adc.py::pq_adc (the Pallas kernel
// _pq_adc_kernel): out[i] = sum_{j = 0 .. m-1} lut[j, codes[i, j]], summed
// over j in order, in fp32, from 0 — the order of the TPU kernel's one-hot
// contraction, which adds one exact term per j (no fast-math: the sum
// must not be reassociated).
//
// What bounds it on Hopper: at the main path's shapes, the launch.  Its one
// caller is the IVF-PQ probe (one call per probed segment and query, a few
// thousand rows each), so the kernel is plain: the (m, 256) LUT goes to
// shared memory, and each thread sums one row at a time (grid-stride),
// reading its m uint8 codes directly.  At large n it would be bound by
// bytes (m bytes of codes in, 4 bytes out per row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCodes = 256;     // codewords per subquantizer
constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ lut, float* __restrict__ out,
              long long n, int m) {
  extern __shared__ float lut_s[];                      // [m][256]
  for (int i = threadIdx.x; i < m * kCodes; i += kThreads) lut_s[i] = lut[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint8_t* c = codes + i * m;
    float acc = 0.f;
    for (int j = 0; j < m; ++j)
      acc = __fadd_rn(acc, lut_s[j * kCodes + c[j]]);    // in j order
    out[i] = acc;
  }
}

}  // namespace

// codes (n, m) uint8, lut (m, 256) fp32, out (n,) fp32; all contiguous.
extern "C" int pq_adc_launch(const uint8_t* codes, const float* lut,
                             float* out, long long n, int m, void* stream) {
  if (n == 0) return 0;
  const size_t smem = (size_t)m * kCodes * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pq_adc_kernel<<<(int)blocks, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(codes, lut, out, n, m);
  return (int)cudaGetLastError();
}
