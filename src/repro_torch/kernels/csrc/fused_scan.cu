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
// The order is exact: ties on d2 break by pk, then row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 8;      // queries per tile (BLOCK_Q)
constexpr int kBlockN = 512;    // rows per kept block id (BLOCK_N)
constexpr int kK = 128;         // list capacity (KMAX)
constexpr int kStage = 64;      // rows of x staged in shared memory
constexpr int kDk = 64;         // features of x staged at a time
constexpr int kThreads = 256;   // 8 warps: warp w owns query w's list
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// (d, pk, row) lexicographic order; NaN sorts after every number
__device__ __forceinline__ bool key_less(float ad, int ap, int ar,
                                         float bd, int bp, int br) {
  const bool an = isnan(ad), bn = isnan(bd);
  if (an != bn) return bn;
  if (!an && ad != bd) return ad < bd;
  if (ap != bp) return ap < bp;
  return ar < br;
}

// A sorted list of kK entries spread over one warp: lane l holds list
// positions 4l .. 4l+3.
struct WarpList {
  float d[4];
  int p[4];
  int r[4];
};

__device__ __forceinline__ void list_init(WarpList& L) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    L.d[j] = INFINITY;
    L.p[j] = kSentinel;
    L.r[j] = kSentinel;
  }
}

__device__ __forceinline__ void list_worst(const WarpList& L, float& wd,
                                           int& wp, int& wr) {
  wd = __shfl_sync(kFull, L.d[3], 31);
  wp = __shfl_sync(kFull, L.p[3], 31);
  wr = __shfl_sync(kFull, L.r[3], 31);
}

// Insert (cd, cp, cr), the same on every lane, into the sorted list; the
// old last entry falls off.  The caller has checked that it beats it.
__device__ __forceinline__ void list_insert(WarpList& L, float cd, int cp,
                                            int cr, int lane) {
  unsigned cnt = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cnt += key_less(L.d[j], L.p[j], L.r[j], cd, cp, cr) ? 1u : 0u;
  const int pos = (int)__reduce_add_sync(kFull, cnt);
  const float pd = __shfl_up_sync(kFull, L.d[3], 1);
  const int pp = __shfl_up_sync(kFull, L.p[3], 1);
  const int pr = __shfl_up_sync(kFull, L.r[3], 1);
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    const int idx = 4 * lane + j;
    if (idx > pos) {
      if (j > 0) {
        L.d[j] = L.d[j - 1];
        L.p[j] = L.p[j - 1];
        L.r[j] = L.r[j - 1];
      } else {
        L.d[0] = pd;
        L.p[0] = pp;
        L.r[0] = pr;
      }
    } else if (idx == pos) {
      L.d[j] = cd;
      L.p[j] = cp;
      L.r[j] = cr;
    }
  }
}

// Offer each lane's candidate (when `valid`) to the warp's list, lowest
// lane first.  Returns the ballot of lanes whose candidate beat the worst
// entry at entry, which pass 2 uses to stop early.
__device__ __forceinline__ unsigned offer(WarpList& L, bool valid, float cd,
                                          int cp, int cr, int lane,
                                          float& wd, int& wp, int& wr) {
  const unsigned first =
      __ballot_sync(kFull, valid && key_less(cd, cp, cr, wd, wp, wr));
  unsigned pend = first;
  while (pend) {
    const int src = __ffs(pend) - 1;
    pend &= pend - 1;
    const float bd = __shfl_sync(kFull, cd, src);
    const int bp = __shfl_sync(kFull, cp, src);
    const int br = __shfl_sync(kFull, cr, src);
    if (key_less(bd, bp, br, wd, wp, wr)) {  // the same on every lane
      list_insert(L, bd, bp, br, lane);
      list_worst(L, wd, wp, wr);
    }
  }
  return first;
}

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
  const long long base = ((q0 + warp) * n_chunks + chunk) * kK + 4 * lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    part_d[base + j] = L.d[j];
    part_p[base + j] = L.p[j];
    part_r[base + j] = L.r[j];
  }
}

__global__ void fused_scan_pass2(const float* __restrict__ part_d,
                                 const int* __restrict__ part_p,
                                 const int* __restrict__ part_r,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_p,
                                 int* __restrict__ out_r, int nq,
                                 int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= nq) return;  // the whole warp leaves together
  WarpList L;
  list_init(L);
  float wd = INFINITY;
  int wp = kSentinel, wr = kSentinel;
  for (int c = 0; c < n_chunks; ++c) {
    const long long base = ((long long)qi * n_chunks + c) * kK;
    for (int j0 = 0; j0 < kK; j0 += 32) {
      const long long at = base + j0 + lane;
      const unsigned won = offer(L, true, part_d[at], part_p[at],
                                 part_r[at], lane, wd, wp, wr);
      // each list is sorted: past its first loser nothing can win
      if (won != kFull) break;
    }
  }
  const long long base = (long long)qi * kK + 4 * lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out_d[base + j] = L.d[j];
    out_p[base + j] = L.p[j];
    out_r[base + j] = L.r[j];
  }
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
  const int warps = 8;
  fused_scan_pass2<<<(nq + warps - 1) / warps, warps * 32, 0, s>>>(
      part_d, part_p, part_r, out_d, out_p, out_r, nq, n_chunks);
  return (int)cudaGetLastError();
}
