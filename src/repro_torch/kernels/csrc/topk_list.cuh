// Per-warp running top-k list shared by the scan -> top-k kernels
// (fused_scan.cu, quantized_scan.cu), which take it for a chunk whose
// candidates overflow their region (the rescan).
//
// A sorted list of kK = KMAX entries is spread over one warp's registers:
// lane l holds list positions 4l .. 4l+3.  Entries are ordered by the
// exact key (d, pk, row), NaN after every number; empty slots are
// (+inf, SENTINEL, SENTINEL).  A candidate is compared with the list's
// current worst entry before anything moves, so once a list is full most
// candidates cost one compare; a winner is inserted with one warp-wide
// count and one shift (shfl_up).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;         // list capacity (KMAX)
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
// entry at entry.
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

}  // namespace
