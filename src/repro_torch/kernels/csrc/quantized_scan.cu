// Fused PQ-ADC scan -> per-query top-k' over the packed code matrix.
//
// Replaces src/repro/kernels/quantized_scan.py::quantized_scan_topk (the
// Pallas kernel _quantized_scan_topk_kernel).  Same result contract: for
// each query the KMAX smallest ADC distances
//     adc(q, i) = sum_{j = 0 .. m-1} lut[q, j, code[i, j]]
// over the rows its uint8 mask admits, ordered by (adc, pk, row), with the
// row reported as its position in the kept-block list (kept index *
// BLOCK_N + offset), and empty slots (+inf, SENTINEL, SENTINEL).  The sum
// runs over j in order, in fp32, from 0: the TPU kernel's one-hot
// contraction adds one exact term per j in that order, so the same
// inputs give the same bits (this file must not be built with fast-math,
// which would let the compiler reassociate it).
//
// What bounds it on Hopper: bytes.  A row costs m bytes of codes, one
// byte of bitmap per query and 4 bytes of pk, against m shared-memory
// lookups and adds per admitted (query, row) pair; at the main path's
// shape (8 queries x 2 M rows, m = 8) that is ~16 MB of codes and ~16 MB
// of bitmap read once.  The random LUT gathers conflict in shared-memory
// banks; that is left for a later change.
//
// Design, the two passes of fused_scan.cu:
//   pass 1: grid (query tiles of 8, chunks of kept blocks).  The tile's 8
//           LUTs (8 x m x 256 fp32, 64 KB at m = 8) sit in dynamic shared
//           memory for the whole chunk.  For each 256-row slice of a kept
//           block the codes are staged as uint8 in shared memory (read
//           through the kept block ids over the device-resident codes:
//           no compacted copy is made), thread t sums row t's ADC for the
//           8 queries whose mask admits it, and warp w offers query w's
//           admitted candidates to its register top-128 list
//           (topk_list.cuh).  Blocks the occupancy grid marks empty are
//           skipped.
//   pass 2: topk_list.cuh's merge of the chunks' sorted lists.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int kBlockQ = 8;      // queries per tile (BLOCK_Q)
constexpr int kBlockN = 512;    // rows per kept block id (BLOCK_N)
constexpr int kSlice = 256;     // rows per staged slice: one per thread
constexpr int kThreads = 256;   // 8 warps: warp w owns query w's list
constexpr int kCodes = 256;     // codewords per subquantizer

// dynamic shared memory: the size of pass 1's carve-out below.  The
// wrapper states the same sum (quantized_scan.py's smem_bytes), refuses an
// m whose need exceeds the card's per-block limit, and hands its sum to the
// launcher, which refuses it unless it equals this one.
inline size_t smem_bytes(int m) {
  return (size_t)kBlockQ * m * kCodes * sizeof(float)   // lut_s
         + (size_t)kBlockQ * kSlice * sizeof(float)     // dist_s
         + (size_t)kSlice * m                           // codes_s
         + (size_t)kBlockQ * kSlice;                    // ok_s
}

__global__ void __launch_bounds__(kThreads)
quantized_scan_pass1(const float* __restrict__ lut,
                     const uint8_t* __restrict__ codes,
                     const uint8_t* __restrict__ mask,
                     const int* __restrict__ pks,
                     const int* __restrict__ keep,
                     const int* __restrict__ occ, float* __restrict__ part_d,
                     int* __restrict__ part_p, int* __restrict__ part_r,
                     int m, long long n_mask, int nkeep,
                     int blocks_per_chunk, int n_chunks) {
  extern __shared__ float smem[];
  const int lut_w = m * kCodes;
  float* lut_s = smem;                                  // [kBlockQ][m*256]
  float* dist_s = lut_s + kBlockQ * lut_w;              // [kBlockQ][kSlice]
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(dist_s + kBlockQ * kSlice);
  uint8_t* ok_s = codes_s + kSlice * m;                 // [kBlockQ][kSlice]

  const int qt = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q0 = (long long)qt * kBlockQ;

  const float* lut_t = lut + q0 * lut_w;
  for (int i = tid; i < kBlockQ * lut_w; i += kThreads) lut_s[i] = lut_t[i];
  __syncthreads();

  WarpList L;
  list_init(L);
  float wd = INFINITY;
  int wp = kSentinel, wr = kSentinel;

  const int b_lo = chunk * blocks_per_chunk;
  const int b_hi = min(nkeep, b_lo + blocks_per_chunk);
  for (int kb = b_lo; kb < b_hi; ++kb) {
    if (occ[(long long)qt * nkeep + kb] == 0) continue;  // uniform
    const long long blk_row = (long long)keep[kb] * kBlockN;
    for (int s0 = 0; s0 < kBlockN; s0 += kSlice) {
      const long long row0 = blk_row + s0;
      const uint8_t* src = codes + row0 * m;
      for (int i = tid; i < kSlice * m; i += kThreads) codes_s[i] = src[i];
      __syncthreads();
      const long long prow = row0 + tid;
      const bool in_range = prow < n_mask;
      const uint8_t* my = codes_s + tid * m;
#pragma unroll
      for (int qq = 0; qq < kBlockQ; ++qq) {
        const bool ok = in_range && mask[(q0 + qq) * n_mask + prow] != 0;
        float acc = 0.f;
        if (ok) {
          const float* lq = lut_s + qq * lut_w;
          for (int j = 0; j < m; ++j)
            acc = __fadd_rn(acc, lq[j * kCodes + my[j]]);   // in j order
        }
        dist_s[qq * kSlice + tid] = acc;
        ok_s[qq * kSlice + tid] = ok ? 1 : 0;
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < kSlice / 32; ++h) {
        const int rr = lane + 32 * h;
        const bool v = ok_s[warp * kSlice + rr] != 0;
        const int cp = v ? pks[row0 + rr] : kSentinel;
        const int cr = kb * kBlockN + s0 + rr;
        offer(L, v, dist_s[warp * kSlice + rr], cp, cr, lane, wd, wp, wr);
      }
      __syncthreads();
    }
  }
  list_store(L, part_d, part_p, part_r,
             ((q0 + warp) * n_chunks + chunk) * kK, lane);
}

}  // namespace

// lut (nq, m*256) fp32 with nq a multiple of 8; codes (rows, m) uint8 with
// rows a multiple of 512 covering every kept block; mask (nq, n_mask)
// uint8; pks (rows,) int32; keep (nkeep,) int32 block ids; occ (nq / 8,
// nkeep) int32; part_* (nq, n_chunks, 128) scratch; out_* (nq, 128);
// smem_wrapper the wrapper's shared-memory sum for this m.
extern "C" int quantized_scan_topk_launch(
    const float* lut, const uint8_t* codes, const uint8_t* mask,
    const int* pks, const int* keep, const int* occ, float* part_d,
    int* part_p, int* part_r, float* out_d, int* out_p, int* out_r, int nq,
    int m, long long n_mask, int nkeep, int blocks_per_chunk, int n_chunks,
    long long smem_wrapper, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(m);
  if (smem_wrapper != (long long)smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quantized_scan_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid1(nq / kBlockQ, n_chunks);
  quantized_scan_pass1<<<grid1, kThreads, smem, s>>>(
      lut, codes, mask, pks, keep, occ, part_d, part_p, part_r, m, n_mask,
      nkeep, blocks_per_chunk, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_merge_chunks(part_d, part_p, part_r, out_d, out_p,
                                  out_r, nq, n_chunks, s);
}
