// Fused masked scan -> per-query top-k over the packed superbatch.
//
// Replaces src/repro/kernels/fused_scan.py::fused_scan_topk (the Pallas
// kernel _fused_scan_topk_kernel).  Same result contract: for each query
// the KMAX smallest squared-L2 distances ||q||^2 - 2 q.x + ||x||^2 over the
// rows its uint8 mask admits, ordered by (d2, pk, row), with the row
// reported as its position in the kept-block list (kept index * BLOCK_N +
// offset), and empty slots (+inf, SENTINEL, SENTINEL).
//
// What bounds it on Hopper: reading x.  Every admitted row is read once
// (4*d bytes) and costs 2*d flops per query, so at an 8-query tile the
// scan is memory bound (~4 flops/byte); the top-k bookkeeping is a small
// per-warp cost once each list is full, because a candidate is compared
// with the list's current worst before anything moves.
//
// Design.  The TPU kernel walks the posting dimension sequentially and
// re-sorts (K + BLOCK_N) lanes per tile.  Hopper's blocks run in parallel
// and in no order, so the work is split in two passes:
//   pass 1: grid (query tiles, chunks of kept blocks).  A block stages 64
//           rows x 64 features of x in shared memory at a time (coalesced
//           loads, reading x through the kept block ids: no compacted
//           copy of x is ever made), computes the 8 x 64 distances, and
//           warp w offers query w's admitted candidates to a sorted
//           top-128 list held in the warp's registers (4 entries a lane).
//           A candidate that beats the list's worst entry is inserted with
//           one warp-wide count and one shift (shfl_up); the rest cost a
//           compare.  Blocks the occupancy grid marks empty are skipped.
//   pass 2: one warp per query merges the chunks' sorted lists the same
//           way; a list is abandoned at its first entry that does not
//           beat the current worst (everything after it is larger).
// The order is exact: ties on d2 break by pk, then row.  The list and
// the merge pass live in topk_list.cuh, shared with quantized_scan.cu.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int kBlockQ = 8;      // queries per tile (BLOCK_Q)
constexpr int kBlockN = 512;    // rows per kept block id (BLOCK_N)
constexpr int kStage = 64;      // rows of x staged in shared memory
constexpr int kDk = 64;         // features of x staged at a time
constexpr int kThreads = 256;   // 8 warps: warp w owns query w's list

__global__ void __launch_bounds__(kThreads)
fused_scan_pass1(const float* __restrict__ q, const float* __restrict__ x,
                 const uint8_t* __restrict__ mask,
                 const int* __restrict__ pks, const int* __restrict__ keep,
                 const int* __restrict__ occ, float* __restrict__ part_d,
                 int* __restrict__ part_p, int* __restrict__ part_r, int d,
                 long long n_mask, int nkeep, int blocks_per_chunk,
                 int n_chunks) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // [kBlockQ][d]
  float* x_s = smem + kBlockQ * d;        // [kStage][kDk + 1]
  __shared__ float dist_s[kBlockQ][kStage];
  __shared__ unsigned char ok_s[kBlockQ][kStage];
  __shared__ float qn_s[kBlockQ];

  const int qt = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q0 = (long long)qt * kBlockQ;

  for (int i = tid; i < kBlockQ * d; i += kThreads) q_s[i] = q[q0 * d + i];
  __syncthreads();
  if (tid < kBlockQ) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(q_s[tid * d + k], q_s[tid * d + k], s);
    qn_s[tid] = s;
  }
  __syncthreads();

  WarpList L;
  list_init(L);
  float wd = INFINITY;
  int wp = kSentinel, wr = kSentinel;

  // thread -> (staged row r, queries qa and qa + 4)
  const int r = tid % kStage;
  const int qa = tid / kStage;
  const int b_lo = chunk * blocks_per_chunk;
  const int b_hi = min(nkeep, b_lo + blocks_per_chunk);
  for (int kb = b_lo; kb < b_hi; ++kb) {
    if (occ[(long long)qt * nkeep + kb] == 0) continue;  // uniform
    const long long blk_row = (long long)keep[kb] * kBlockN;
    for (int s0 = 0; s0 < kBlockN; s0 += kStage) {
      const long long row0 = blk_row + s0;
      float dot0 = 0.f, dot1 = 0.f, xn = 0.f;
      for (int k0 = 0; k0 < d; k0 += kDk) {
        const int kw = min(kDk, d - k0);
        for (int i = tid; i < kStage * kw; i += kThreads) {
          const int rr = i / kw, kk = i - rr * kw;
          x_s[rr * (kDk + 1) + kk] = x[(row0 + rr) * d + k0 + kk];
        }
        __syncthreads();
        const float* xr = x_s + r * (kDk + 1);
        const float* qr0 = q_s + qa * d + k0;
        const float* qr1 = q_s + (qa + 4) * d + k0;
        for (int kk = 0; kk < kw; ++kk) {
          const float xv = xr[kk];
          xn = fmaf(xv, xv, xn);
          dot0 = fmaf(qr0[kk], xv, dot0);
          dot1 = fmaf(qr1[kk], xv, dot1);
        }
        __syncthreads();
      }
      const long long prow = row0 + r;
      const bool in_range = prow < n_mask;
      const int qq0 = qa, qq1 = qa + 4;
      ok_s[qq0][r] = in_range && mask[(q0 + qq0) * n_mask + prow] != 0;
      ok_s[qq1][r] = in_range && mask[(q0 + qq1) * n_mask + prow] != 0;
      dist_s[qq0][r] = (qn_s[qq0] - 2.f * dot0) + xn;
      dist_s[qq1][r] = (qn_s[qq1] - 2.f * dot1) + xn;
      __syncthreads();
#pragma unroll
      for (int h = 0; h < kStage / 32; ++h) {
        const int rr = lane + 32 * h;
        const bool v = ok_s[warp][rr] != 0;
        const int cp = v ? pks[row0 + rr] : kSentinel;
        const int cr = kb * kBlockN + s0 + rr;
        offer(L, v, dist_s[warp][rr], cp, cr, lane, wd, wp, wr);
      }
      __syncthreads();
    }
  }
  list_store(L, part_d, part_p, part_r,
             ((q0 + warp) * n_chunks + chunk) * kK, lane);
}

}  // namespace

// q (nq, d) with nq a multiple of 8; x (rows, d) with rows a multiple of
// 512 covering every kept block; mask (nq, n_mask) uint8; pks (rows,)
// int32; keep (nkeep,) int32 block ids; occ (nq / 8, nkeep) int32;
// part_* (nq, n_chunks, 128) scratch; out_* (nq, 128).
extern "C" int fused_scan_topk_launch(
    const float* q, const float* x, const uint8_t* mask, const int* pks,
    const int* keep, const int* occ, float* part_d, int* part_p,
    int* part_r, float* out_d, int* out_p, int* out_r, int nq, int d,
    long long n_mask, int nkeep, int blocks_per_chunk, int n_chunks,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(kBlockQ * d + kStage * (kDk + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_scan_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid1(nq / kBlockQ, n_chunks);
  fused_scan_pass1<<<grid1, kThreads, smem, s>>>(
      q, x, mask, pks, keep, occ, part_d, part_p, part_r, d, n_mask, nkeep,
      blocks_per_chunk, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_merge_chunks(part_d, part_p, part_r, out_d, out_p,
                                  out_r, nq, n_chunks, s);
}
