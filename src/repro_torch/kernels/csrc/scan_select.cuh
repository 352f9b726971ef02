// The witness threshold and the select shared by the two scan -> top-k
// kernels (fused_scan.cu, quantized_scan.cu), generic over the scores.
//
// A scan keeps, per query, only the rows whose score is at or under a
// threshold tau, and a select sorts what was kept:
//   witnesses: each scan block scores a sample of its rows and publishes
//           per query its kWit smallest admitted scores as order-
//           preserving keys (publish_witnesses; a sampled row is one
//           block's, so the witnesses are distinct rows);
//   topk_threshold: tau >= the 128th smallest witness of the query, +inf
//           with fewer than 128.  128 distinct admitted rows score at or
//           under tau, so a row scoring above it cannot be among the 128
//           best, while one scoring tau still can (by pk): the scans'
//           filter is score <= tau, which a NaN score never passes;
//   topk_select: one block a query sorts its candidates by the exact
//           (score, pk, row) key.
// Scores compare as the keys ord_key gives them; the key of -0 is that
// of +0, negative scores (a squared distance rounded below 0) order
// before them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int kBlockN = 512;    // rows per kept block id (BLOCK_N)
constexpr int kMaxWitnesses = 1024;   // witnesses a query, at most
constexpr int kTauThreads = 256;   // 8 warps: one query each
constexpr int kSelect = 2048;   // select's sort tile
constexpr int kSelectThreads = 256;
constexpr int kRegKeys = 32;    // select: candidates a thread holds
constexpr unsigned kNone = 0xffffffffu;   // "no witness" key
constexpr unsigned kInfKey = 0xff800000u; // the key of +inf
// A threshold search stops once its bracket spans at most this many keys:
// the bound it returns then lies within 2^-11 (relative) of the exact
// k-th value, which only lets a few more candidates through.
constexpr unsigned kSlack = 4096;

// float -> uint32 with the same order (-0 taken as +0)
__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A warp publishes the kWit smallest of one query's kSample keys
// (key_s, in shared memory), smallest first, to out[0, kWit) (kNone where
// fewer are keys).
template <int kSample, int kWit>
__device__ __forceinline__ void publish_witnesses(const unsigned* key_s,
                                                  unsigned* out, int lane) {
  constexpr int kPer = kSample / 32;
  unsigned v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = key_s[i * 32 + lane];
  for (int round = 0; round < kWit; ++round) {
    unsigned mn = kNone;
    int at = -1;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (v[i] < mn) {
        mn = v[i];
        at = i;
      }
    const unsigned wmin = __reduce_min_sync(kFull, mn);
    const unsigned who = __ballot_sync(kFull, at >= 0 && mn == wmin);
    if (who && lane == __ffs(who) - 1) {   // take one instance of it
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (i == at) v[i] = kNone;
    }
    if (lane == 0) out[round] = wmin;
  }
}

template <int N>
__device__ __forceinline__ int count_le(const unsigned (&v)[N], unsigned k) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) c += v[i] <= k ? 1 : 0;
  return (int)__reduce_add_sync(kFull, (unsigned)c);
}

// tau[q] >= the 128th smallest witness of query q (a witness key bound,
// as a float), +inf when it has fewer than 128: one warp a query, its
// nwit <= kMaxWitnesses witnesses in registers, a binary search between
// the least and the largest witness for a K with kK witnesses <= K,
// stopped at kSlack keys.
__global__ void __launch_bounds__(kTauThreads)
topk_threshold(const unsigned* __restrict__ wit, float* __restrict__ tau,
               int nq, int nwit) {
  constexpr int kPer = kMaxWitnesses / 32;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (kTauThreads / 32) + (threadIdx.x >> 5);
  if (q >= nq) return;              // the whole warp leaves together
  unsigned v[kPer];
  unsigned lo = kNone, hi = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int at = i * 32 + lane;
    v[i] = at < nwit ? __ldg(wit + (long long)q * nwit + at) : kNone;
    if (v[i] != kNone) {
      lo = min(lo, v[i]);
      hi = max(hi, v[i]);
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (count_le(v, kInfKey) < kK) {  // fewer than 128 witnesses
    if (lane == 0) tau[q] = INFINITY;
    return;
  }
  while (hi - lo > kSlack) {        // count(<= hi) >= kK throughout
    const unsigned mid = lo + (hi - lo) / 2;
    if (count_le(v, mid) >= kK)
      hi = mid;
    else
      lo = mid + 1;
  }
  if (lane == 0) tau[q] = key_float(hi);
}

// The pk of kept-block position kpos (kept index * kBlockN + offset).
__device__ __forceinline__ int pk_of(const int* __restrict__ pks,
                                     const int* __restrict__ keep, int kpos) {
  return pks[(long long)keep[kpos / kBlockN] * kBlockN + kpos % kBlockN];
}

// Sort sd/sp/sr[0, P) ascending by (score, pk, row); P a power of two.
__device__ void bitonic_sort(float* sd, int* sp, int* sr, int P, int tid) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < P / 2; t += kSelectThreads) {
        const int i = 2 * t - (t & (j - 1));      // t with a 0 bit at j
        const int l = i + j;
        const bool up = (i & k) == 0;
        const float ad = sd[i], bd = sd[l];
        const int ap = sp[i], bp = sp[l], ar = sr[i], br = sr[l];
        const bool swap = up ? key_less(bd, bp, br, ad, ap, ar)
                             : key_less(ad, ap, ar, bd, bp, br);
        if (swap) {
          sd[i] = bd;
          sd[l] = ad;
          sp[i] = bp;
          sp[l] = ap;
          sr[i] = br;
          sr[l] = ar;
        }
      }
      __syncthreads();
    }
  }
}

// out_*[q] = the kK smallest of query q's candidates by (score, pk, row),
// then (+inf, SENTINEL, SENTINEL).  The candidates are the scan's list of
// (score, kept row) pairs, cand_n[q] of them in the query's n_chunks * kK
// slots; pks are fetched here.  Up to 8,192 candidates: the block finds a
// K at or just above the kK-th smallest score (a binary search over keys,
// the candidates in registers, stopped at kSlack keys) and sorts only
// those with score <= K (every row of the answer is one of them).  Above
// that, or when more than 2,048 lie at or under K: sort all, 2,048 at a
// time, keeping the best 128.
__global__ void __launch_bounds__(kSelectThreads)
topk_select(const float* __restrict__ cand_d, const int* __restrict__ cand_r,
            const int* __restrict__ cand_n, const int* __restrict__ pks,
            const int* __restrict__ keep, int n_chunks,
            float* __restrict__ out_d, int* __restrict__ out_p,
            int* __restrict__ out_r) {
  constexpr int kSWarps = kSelectThreads / 32;
  __shared__ float sd[kSelect];
  __shared__ int sp[kSelect];
  __shared__ int sr[kSelect];
  __shared__ unsigned part[2][kSWarps];
  __shared__ int picked;
  const int q = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)q * n_chunks * kK;
  const int n = min(cand_n[q], n_chunks * kK);

  bool done = false;
  if (n <= kSelectThreads * kRegKeys) {
    unsigned key[kRegKeys];
#pragma unroll
    for (int i = 0; i < kRegKeys; ++i) {
      const int f = i * kSelectThreads + tid;
      key[i] = f < n ? ord_key(cand_d[base + f]) : kNone;
    }
    unsigned K = kNone - 1u;          // n <= kK: every candidate
    if (n > kK) {                     // K >= the kK-th smallest key
      unsigned lo = kNone, hi = 0;
#pragma unroll
      for (int i = 0; i < kRegKeys; ++i)
        if (key[i] != kNone) {
          lo = min(lo, key[i]);
          hi = max(hi, key[i]);
        }
      lo = __reduce_min_sync(kFull, lo);
      hi = __reduce_max_sync(kFull, hi);
      if (lane == 0) {
        part[0][warp] = lo;
        part[1][warp] = hi;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kSWarps; ++w) {
        lo = min(lo, part[0][w]);
        hi = max(hi, part[1][w]);
      }
      __syncthreads();
      for (int it = 0; hi - lo > kSlack; ++it) {
        const unsigned mid = lo + (hi - lo) / 2;
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < kRegKeys; ++i) cnt += key[i] <= mid ? 1 : 0;
        cnt = (int)__reduce_add_sync(kFull, (unsigned)cnt);
        if (lane == 0) part[it & 1][warp] = (unsigned)cnt;
        __syncthreads();
        int total = 0;
#pragma unroll
        for (int w = 0; w < kSWarps; ++w) total += (int)part[it & 1][w];
        if (total >= kK)
          hi = mid;
        else
          lo = mid + 1;
      }
      K = hi;
    }
    if (tid == 0) picked = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRegKeys; ++i) {
      const bool sel = key[i] <= K;
      const unsigned b = __ballot_sync(kFull, sel);
      if (!b) continue;
      int at = 0;
      if (lane == __ffs(b) - 1) at = atomicAdd(&picked, __popc(b));
      at = __shfl_sync(kFull, at, __ffs(b) - 1)
           + __popc(b & ((1u << lane) - 1u));
      if (sel && at < kSelect) {
        const long long f = base + i * kSelectThreads + tid;
        const int row = cand_r[f];
        sd[at] = cand_d[f];
        sr[at] = row;
        sp[at] = pk_of(pks, keep, row);
      }
    }
    __syncthreads();
    const int c_sel = picked;
    if (c_sel <= kSelect) {
      int P = kK;
      while (P < c_sel) P <<= 1;
      for (int i = c_sel + tid; i < P; i += kSelectThreads) {
        sd[i] = INFINITY;
        sp[i] = kSentinel;
        sr[i] = kSentinel;
      }
      __syncthreads();
      bitonic_sort(sd, sp, sr, P, tid);
      done = true;
    }
  }
  if (!done) {
    int next = 0;
    int lo = 0;                     // slots below lo hold the best so far
    do {
      for (int i = lo + tid; i < kSelect; i += kSelectThreads) {
        const int f = next + i - lo;
        if (f < n) {
          const long long src = base + f;
          const int row = cand_r[src];
          sd[i] = cand_d[src];
          sr[i] = row;
          sp[i] = pk_of(pks, keep, row);
        } else {
          sd[i] = INFINITY;
          sp[i] = kSentinel;
          sr[i] = kSentinel;
        }
      }
      next += kSelect - lo;
      lo = kK;
      __syncthreads();
      bitonic_sort(sd, sp, sr, kSelect, tid);
    } while (next < n);
  }
  if (tid < kK) {
    out_d[(long long)q * kK + tid] = sd[tid];
    out_p[(long long)q * kK + tid] = sp[tid];
    out_r[(long long)q * kK + tid] = sr[tid];
  }
}

}  // namespace
