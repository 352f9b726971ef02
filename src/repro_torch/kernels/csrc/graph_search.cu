// Batched beam search over the packed CSR graph -> per-query top-beam.
//
// Replaces src/repro/kernels/graph_search.py::graph_search_topk (the
// Pallas kernel _graph_search_kernel).  Same result contract: seed from
// every entry row (all of them visited), then `hops` times expand the
// whole traversal beam's neighbour lists, drop -1 padding, dead lanes and
// rows already visited, dedup by row, and merge the fresh rows into two
// beam-wide lists by (d2, pk): the traversal beam takes every fresh row
// (routing walks through rows the predicate rejects), the result beam only
// mask-admitted ones.  Outputs: the result beam's (d2, pk, row), empty
// slots (+inf, SENTINEL, SENTINEL), and the visited bitmask (n / 32 words
// per query), whose popcount is the rows-gathered statistic.
//
// Order, as the Pallas kernel's stable lax.sort on (d2, pk) over
// [beam || this hop's fresh rows in row order]: fresh rows are sorted by
// (d2, pk, row) and merged behind the old beam entries they tie with.  The
// seed sorts the entries by (d2, pk, entry position).  d2 is the
// difference form summed over the features in order 0..d-1, with one
// round-to-nearest per operation (__fsub_rn, __fmul_rn, __fadd_rn: no FMA
// contraction), the order of the plain version in ref.py, so the two agree
// bit for bit.
//
// What bounds it on Hopper: latency, not bytes.  A query touches
// ~beam * R * hops rows (a few MB over a batch against a few GB/s of
// gathers in flight per block) and each hop is a chain of block-wide steps
// (gather, score, sort, two merges) with barriers between them.
//
// Design.  One block per query.  The visited set (n / 32 words a query, up
// to 256 KB at 2 M rows) does not fit shared memory, so it lives in the
// output tensor in global memory, owned by the query's block: an atomicOr
// test-and-set per candidate is the "not yet visited" check and the in-hop
// dedup in one step — a row seen in an earlier hop, or reached twice in
// this hop, enters once, exactly the Pallas kernel's fresh set.  The
// fresh rows (at most beam * R) are appended to shared memory, scored one
// row a thread, bitonic-sorted by (d2, pk, row), and merged into each
// beam by rank: an old entry lands at its index plus the number of fresh
// rows strictly below it, a fresh row at its index plus the number of old
// entries at or below it (binary searches); the result merge counts only
// admitted fresh rows through a block-wide prefix sum.  The -1 padding
// and dead lanes are guarded before any gather.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// (d, pk) order; NaN after every number
__device__ __forceinline__ bool less_dp(float ad, int ap, float bd, int bp) {
  const bool an = isnan(ad), bn = isnan(bd);
  if (an != bn) return bn;
  if (!an && ad != bd) return ad < bd;
  return ap < bp;
}

__device__ __forceinline__ bool less_dpk(float ad, int ap, int ak, float bd,
                                         int bp, int bk) {
  if (less_dp(ad, ap, bd, bp)) return true;
  if (less_dp(bd, bp, ad, ap)) return false;
  return ak < bk;
}

// number of the first n entries of the (d, pk)-sorted (d, p) strictly
// below (kd, kp), or, with `or_equal`, at or below it
__device__ __forceinline__ int rank_of(const float* d, const int* p, int n,
                                       float kd, int kp, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool below = or_equal ? !less_dp(kd, kp, d[mid], p[mid])
                                : less_dp(d[mid], p[mid], kd, kp);
    if (below) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Lists {
  float* q;                    // [d]
  float *bd, *rd, *nd;         // traversal beam, result beam, merge output
  int *bp, *bi, *rp, *ri, *np, *ni;
  float* cd;                   // [P] fresh rows: d2, pk, row, sort key,
  int *cp, *cr, *ck, *cf;      //     admitted flag -> prefix ([P + 1])
};

__device__ void block_sort(Lists& L, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kThreads) {
        const int o = i ^ j;
        if (o <= i) continue;
        const bool up = (i & k) == 0;
        const bool gt = less_dpk(L.cd[o], L.cp[o], L.ck[o], L.cd[i], L.cp[i],
                                 L.ck[i]);
        if (gt == up) {
          float td = L.cd[i]; L.cd[i] = L.cd[o]; L.cd[o] = td;
          int t = L.cp[i]; L.cp[i] = L.cp[o]; L.cp[o] = t;
          t = L.cr[i]; L.cr[i] = L.cr[o]; L.cr[o] = t;
          t = L.ck[i]; L.ck[i] = L.ck[o]; L.ck[o] = t;
          t = L.cf[i]; L.cf[i] = L.cf[o]; L.cf[o] = t;
        }
      }
      __syncthreads();
    }
  }
}

// cf[0..n) flags -> exclusive prefix sums, cf[n] = total
__device__ void block_scan(int* cf, int n, int* warp_s) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += cf[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_s[w];
  for (int i = lo; i < hi; ++i) {
    const int v = cf[i];
    cf[i] = run;
    run += v;
  }
  if (threadIdx.x == kThreads - 1) cf[n] = run;
  __syncthreads();
}

// rank merge of the nc sorted fresh rows into one beam; `admitted` counts
// only rows whose flag is set (cf holds the prefix sums)
__device__ void merge_beam(Lists& L, float* od, int* op, int* oi, int beam,
                           int nc, bool admitted) {
  for (int i = threadIdx.x; i < beam; i += kThreads) {
    const int below = rank_of(L.cd, L.cp, nc, od[i], op[i], false);
    const int pos = i + (admitted ? L.cf[below] : below);
    if (pos < beam) {
      L.nd[pos] = od[i]; L.np[pos] = op[i]; L.ni[pos] = oi[i];
    }
  }
  for (int j = threadIdx.x; j < nc; j += kThreads) {
    if (admitted && L.cf[j + 1] == L.cf[j]) continue;
    const int pos = (admitted ? L.cf[j] : j) +
                    rank_of(od, op, beam, L.cd[j], L.cp[j], true);
    if (pos < beam) {
      L.nd[pos] = L.cd[j]; L.np[pos] = L.cp[j]; L.ni[pos] = L.cr[j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < beam; i += kThreads) {
    od[i] = L.nd[i]; op[i] = L.np[i]; oi[i] = L.ni[i];
  }
  __syncthreads();
}

// score the nc fresh rows in cr (sort keys in ck), sort them, merge them
// into the traversal beam and (the admitted ones) into the result beam
__device__ void score_and_merge(Lists& L, const float* __restrict__ x,
                                const int* __restrict__ pks,
                                const uint8_t* __restrict__ mask_q, int d,
                                int beam, int nc, int* warp_s) {
  int n2 = 1;
  while (n2 < nc) n2 <<= 1;
  for (int s = threadIdx.x; s < n2; s += kThreads) {
    if (s < nc) {
      const long long c = L.cr[s];
      const float* xr = x + c * d;
      float acc = 0.f;
      for (int j = 0; j < d; ++j) {
        const float diff = __fsub_rn(xr[j], L.q[j]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      L.cd[s] = acc;
      L.cp[s] = pks[c];
      L.cf[s] = mask_q[c] != 0;
    } else {
      L.cd[s] = INFINITY; L.cp[s] = kSentinel; L.cr[s] = kSentinel;
      L.ck[s] = kSentinel; L.cf[s] = 0;
    }
  }
  __syncthreads();
  block_sort(L, n2);
  block_scan(L.cf, nc, warp_s);
  merge_beam(L, L.bd, L.bp, L.bi, beam, nc, false);
  merge_beam(L, L.rd, L.rp, L.ri, beam, nc, true);
}

__global__ void __launch_bounds__(kThreads)
graph_search_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    const int* __restrict__ nbrs,
                    const int* __restrict__ entries,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ pks, float* __restrict__ out_d,
                    int* __restrict__ out_p, int* __restrict__ out_r,
                    int* __restrict__ vis, int d, long long n, int r_deg,
                    int n_ent, int beam, int hops, int cap) {
  extern __shared__ float smem[];
  __shared__ int nc_s;
  __shared__ int warp_s[kWarps];
  Lists L;
  L.q = smem;
  L.bd = L.q + d; L.rd = L.bd + beam; L.nd = L.rd + beam;
  L.cd = L.nd + beam;
  int* ip = reinterpret_cast<int*>(L.cd + cap);
  L.bp = ip; L.bi = L.bp + beam; L.rp = L.bi + beam; L.ri = L.rp + beam;
  L.np = L.ri + beam; L.ni = L.np + beam;
  L.cp = L.ni + beam; L.cr = L.cp + cap; L.ck = L.cr + cap;
  L.cf = L.ck + cap;                               // [cap + 1]

  const long long qrow = blockIdx.x;
  unsigned* vis_q = reinterpret_cast<unsigned*>(vis) + qrow * (n / 32);
  const uint8_t* mask_q = mask + qrow * n;
  for (int j = threadIdx.x; j < d; j += kThreads) L.q[j] = q[qrow * d + j];
  for (int i = threadIdx.x; i < beam; i += kThreads) {
    L.bd[i] = L.rd[i] = INFINITY;
    L.bp[i] = L.bi[i] = L.rp[i] = L.ri[i] = kSentinel;
  }
  if (threadIdx.x == 0) nc_s = 0;
  __syncthreads();

  // seed: every entry row, visited, sorted by (d2, pk, entry position)
  for (int t = threadIdx.x; t < n_ent; t += kThreads) {
    const int e = entries[t];
    if (e == kSentinel || e < 0 || e >= n) continue;
    atomicOr(vis_q + (e >> 5), 1u << (e & 31));
    const int slot = atomicAdd(&nc_s, 1);
    L.cr[slot] = e;
    L.ck[slot] = t;
  }
  __syncthreads();
  score_and_merge(L, x, pks, mask_q, d, beam, nc_s, warp_s);

  for (int h = 0; h < hops; ++h) {
    if (threadIdx.x == 0) nc_s = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < beam * r_deg; t += kThreads) {
      const int f = L.bi[t / r_deg];
      if (f == kSentinel) continue;                 // dead frontier lane
      const int c = nbrs[(long long)f * r_deg + t % r_deg];
      if (c < 0) continue;                          // -1 out-degree padding
      const unsigned bit = 1u << (c & 31);
      if (atomicOr(vis_q + (c >> 5), bit) & bit) continue;   // seen
      const int slot = atomicAdd(&nc_s, 1);
      L.cr[slot] = c;
      L.ck[slot] = c;
    }
    __syncthreads();
    const int nc = nc_s;
    if (nc == 0) continue;                          // uniform
    score_and_merge(L, x, pks, mask_q, d, beam, nc, warp_s);
  }
  for (int i = threadIdx.x; i < beam; i += kThreads) {
    out_d[qrow * beam + i] = L.rd[i];
    out_p[qrow * beam + i] = L.rp[i];
    out_r[qrow * beam + i] = L.ri[i];
  }
}

}  // namespace

// q (nq, d) fp32; x (n, d) fp32 with n a multiple of 32; nbrs (n, r_deg)
// int32, -1 padded; entries (n_ent,) int32, SENTINEL padded; mask (nq, n)
// uint8; pks (n,) int32; out_* (nq, beam); vis (nq, n / 32) int32, zeroed
// by the caller.  cap: a power of two >= max(beam * r_deg, n_ent), the
// fresh-row capacity.  smem_bytes: the caller's sum of the layout below,
// which must equal the launcher's.
extern "C" int graph_search_topk_launch(
    const float* q, const float* x, const int* nbrs, const int* entries,
    const uint8_t* mask, const int* pks, float* out_d, int* out_p,
    int* out_r, int* vis, int nq, int d, long long n, int r_deg, int n_ent,
    int beam, int hops, int cap, long long smem_bytes, void* stream) {
  if (nq == 0 || beam == 0) return 0;
  if (cap < beam * r_deg || cap < n_ent || (cap & (cap - 1)) || n % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(d + 9 * beam + 5 * cap + 1) * sizeof(float);
  if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  graph_search_kernel<<<nq, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      q, x, nbrs, entries, mask, pks, out_d, out_p, out_r, vis, d, n, r_deg,
      n_ent, beam, hops, cap);
  return (int)cudaGetLastError();
}
