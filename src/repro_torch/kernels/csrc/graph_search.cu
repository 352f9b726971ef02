// Batched beam search over the packed CSR graph -> per-query top-beam.
//
// Replaces src/repro/kernels/graph_search.py::graph_search_topk (the
// Pallas kernel _graph_search_kernel).  Same result contract: seed from
// every entry row (all of them visited), then `hops` times expand the
// traversal beam's neighbour lists, drop -1 padding, dead lanes and rows
// already visited, dedup by row, and merge the fresh rows into two
// beam-wide lists by (d2, pk): the traversal beam takes every fresh row
// (routing walks through rows the predicate rejects), the result beam only
// mask-admitted ones.  Outputs: the result beam's (d2, pk, row), empty
// slots (+inf, SENTINEL, SENTINEL), and the visited bitmask (n / 32 words
// per query), whose popcount is the rows-gathered statistic.
//
// Order, as the Pallas kernel's stable lax.sort on (d2, pk) over
// [beam || this hop's fresh rows in row order]: fresh rows rank by (d2,
// pk, row) behind the old beam entries they tie with; the seed ranks the
// entries by (d2, pk, entry position).  d2 is the difference form summed
// over the features in order 0..d-1, with one round-to-nearest per
// operation (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), the
// order of the plain version in ref.py, so the two agree bit for bit.
// That order is why no tensor core is used: an MMA sums its products in
// an order of its own.
//
// What bounds it on Hopper: latency, not bytes.  A query gathers ~1,000
// rows of 512 bytes over the seed and 8 hops at TRACY's GRAPH shape, and
// each round (the seed or a hop) is a chain of dependent block-wide steps
// — read the new entries' neighbour lists, test the visited set, gather
// and score the fresh rows, rank the survivors, merge — each a memory
// round trip or a few barriers.
//
// Design: one block per query, each step of a round cut to what can
// change the answer.  Every step below is exact.
// - Only the rows that entered the traversal beam in the previous round
//   are expanded.  A row enters at most once (only never-visited rows are
//   merged in, and a row that drops out is never fresh again), and its
//   first expansion marks every neighbour visited, so re-expanding it
//   gathers nothing.  The merge lists the rows that entered (`front`);
//   when none did, every later hop is empty and the walk stops.
// - The visited set lives in shared memory when its n / 32 words fit
//   (test-and-set by shared atomics, written out coalesced at the end);
//   else in the output tensor in global memory, which the block zeroes
//   itself.  The test-and-set is the in-hop dedup too.
// - Fresh rows are gathered into shared memory by 16-byte cp.async copies
//   (a half-warp a row, consecutive lanes on consecutive bytes; 4-byte
//   copies by a warp when d % 4 != 0), in tiles of up to 256 rows x 64
//   features padded to an odd number of float4s (no bank conflict when a
//   thread reads its own row), two tiles in flight; one thread runs one
//   row's chain, carrying it across a row's tiles.  A tile holds fewer
//   rows (128, 64 or 32: the launcher's `tile_rows`) when the lists of a
//   large capacity leave no room for 256.
// - A fresh row can enter the traversal beam only if it is strictly below
//   the beam's last entry by (d2, pk) (else `beam` old entries sort at or
//   before it), and the result beam only if admitted and strictly below
//   that beam's last entry.  Rows that can enter neither are dropped as
//   they are scored: they sort after every kept row and below no old
//   entry, so no other rank changes.
// - The survivors, as 16-byte records whose (d2, pk) compares as one
//   64-bit key, are bitonic-sorted by (d2, pk, key): the substages below
//   32 run in registers over warp shuffles (one pass and one barrier per
//   block size), the wider ones through shared memory; a ballot word per
//   32 sorted records counts the result candidates.  Each beam is then a
//   rank merge into the other half of a double buffer: an old entry lands
//   at its index plus the survivors strictly below it, a survivor at its
//   rank plus the old entries at or below it (binary searches).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;     // one block a query
constexpr int kDc = 64;           // features of a staged tile
constexpr int kXs = kDc + 4;      // staged row stride: 17 16-byte units
constexpr int kSlots = 2;         // staged tiles in flight
constexpr int kExpand = 4;        // neighbour ids a thread loads at once
constexpr int kWarps = kThreads / 32;
constexpr int kHeader = 4;        // words of the counts (16-byte aligned)
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kDc == 64, "a half-warp stages a tile row: 16 x 16 bytes");

// 4-byte words of the shared memory of one block, all of it dynamic (the
// wrapper's smem_bytes / 4): staged tiles of tile_rows rows (between
// rounds: the seed's warp counts, the sorted groups' flag words and
// counts), the counts, the query (d rounded up to 4), the survivor records
// (4 words each), both beams twice (d2, pk, row), the entered rows, the
// fresh rows, and with `shared_vis` the visited words
__host__ __device__ inline long long smem_words(int d, int beam, int cap,
                                                long long n, bool shared_vis,
                                                int tile_rows) {
  return (long long)kSlots * tile_rows * kXs + kHeader + ((d + 3) & ~3)
         + 5LL * cap + 13LL * beam + (shared_vis ? n / 32 : 0);
}

// (d, pk) order; NaN after every number
__device__ __forceinline__ bool less_dp(float ad, int ap, float bd, int bp) {
  const bool an = isnan(ad), bn = isnan(bd);
  if (an != bn) return bn;
  if (!an && ad != bd) return ad < bd;
  return ap < bp;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float step(float acc, float x, float q) {
  const float diff = __fsub_rn(x, q);
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

// Pointers into the dynamic shared memory; each beam array holds two
// halves of `beam` slots (the merge writes the half it does not read).
// Kept in registers: every function that takes it is inlined and nothing
// indexes it at run time.
struct Smem {
  float* stage;                 // [kSlots][tile_rows][kXs]
  float* q;                     // [(d + 3) & ~3]
  float *bd, *rd;               // [2][beam] traversal and result beams
  int *bp, *bi, *rp, *ri;
  int* front;                   // [beam] rows that entered the traversal beam
  int* fr;                      // [cap] fresh rows (the seed's in position order)
  int4* rec;                    // [cap] survivor records (see dp_key)
};

struct Counts {
  int nc;                       // fresh rows of the round
  int ns;                       // survivors
  int nf;                       // rows that entered the traversal beam
};

// rows[0 .. nr), features [c0, c0 + len), into a tile: a
// half-warp a row, one 16-byte copy a lane (d % 4 == 0 and x 16-byte
// aligned), else a warp a row, 4 bytes a lane
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ x,
                                           const int* rows, int nr, int c0,
                                           int len, int d, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (vec) {
    const int k = 4 * (lane & 15);
    if (k < len)
      for (int r = 2 * warp + (lane >> 4); r < nr; r += 2 * kWarps)
        cp_async16(dst + r * kXs + k, x + (long long)rows[r] * d + c0 + k);
  } else {
    for (int r = warp; r < nr; r += kWarps)
      for (int k = lane; k < len; k += 32)
        cp_async4(dst + r * kXs + k, x + (long long)rows[r] * d + c0 + k);
  }
}

// tile t of the round (row group t / nch, feature chunk t % nch) into its
// slot, then one commit (an empty group past the last tile)
__device__ __forceinline__ void stage_next(const Smem& S,
                                           const float* __restrict__ x,
                                           int t, int tiles, int nch, int nc,
                                           int d, int tr, bool vec) {
  if (t < tiles) {
    const int g = t / nch, c0 = (t - g * nch) * kDc;
    const int r0 = g * tr;
    stage_tile(S.stage + (t % kSlots) * tr * kXs, x, S.fr + r0,
               min(tr, nc - r0), c0, min(kDc, d - c0), d, vec);
  }
  cp_async_commit();
}

// Score the nc fresh rows fr and keep the survivors: rows that can enter
// the traversal beam (strictly below its last entry) or, if admitted, the
// result beam (strictly below its last entry; flag set).  A row's tie key
// is its row id, a seed's its index in fr (the entries' position order).
// Tiles of tr rows: thread i < tr scores row i of each.  Ends with a block
// barrier; C.ns holds the survivor count after it.
__device__ __forceinline__ void score_round(const Smem& S, Counts& C,
                                            int cur,
                                            const float* __restrict__ x,
                                            const int* __restrict__ pks,
                                            const uint8_t* __restrict__ mask_q,
                                            int d, int beam, int nc, int tr,
                                            bool seed, bool vec) {
  const int last = cur * beam + beam - 1;
  const float bdl = S.bd[last], rdl = S.rd[last];
  const int bpl = S.bp[last], rpl = S.rp[last];
  const int nch = d > 0 ? (d + kDc - 1) / kDc : 1;
  const int tiles = (nc + tr - 1) / tr * nch;
  stage_next(S, x, 0, tiles, nch, nc, d, tr, vec);
  stage_next(S, x, 1, tiles, nch, nc, d, tr, vec);
  float acc = 0.f;
  int row = 0, key = 0, pk = 0;
  bool adm = false;
  for (int t = 0; t < tiles; ++t) {
    const int g = t / nch, c = t - g * nch, c0 = c * kDc;
    const int r = g * tr + (int)threadIdx.x;
    const bool mine = (int)threadIdx.x < tr && r < nc;
    if (c == 0 && mine) {       // a new row: its pk and mask bit in flight
      acc = 0.f;                // while its tile lands and its chain runs
      row = S.fr[r];
      key = seed ? r : row;
      pk = pks[row];
      adm = mask_q[row] != 0;
    }
    cp_async_wait1();           // this thread's copies of tile t landed
    __syncthreads();            // everyone's
    if (mine) {
      const float* xr = S.stage + (t % kSlots) * tr * kXs
                        + threadIdx.x * kXs;
      const float* qc = S.q + c0;
      const int len = min(kDc, d - c0);
      int j = 0;
      for (; j + 4 <= len; j += 4) {          // features in order
        const float4 xv = *reinterpret_cast<const float4*>(xr + j);
        const float4 qv = *reinterpret_cast<const float4*>(qc + j);
        acc = step(acc, xv.x, qv.x);
        acc = step(acc, xv.y, qv.y);
        acc = step(acc, xv.z, qv.z);
        acc = step(acc, xv.w, qv.w);
      }
      for (; j < len; ++j) acc = step(acc, xr[j], qc[j]);
      if (c == nch - 1) {
        const bool to_b = less_dp(acc, pk, bdl, bpl);
        const bool to_r = adm && less_dp(acc, pk, rdl, rpl);
        if (to_b || to_r)
          S.rec[atomicAdd(&C.ns, 1)] = make_int4(
              pk ^ 0x80000000, __float_as_int(acc),
              static_cast<int>(static_cast<unsigned>(key) << 1 | to_r), row);
      }
    }
    __syncthreads();            // tile t read: its slot may be refilled
    stage_next(S, x, t + 2, tiles, nch, nc, d, tr, vec);
  }
  __syncthreads();
}

// A survivor as one 16-byte record: x = pk ^ 0x80000000, y = the bits of
// d2, z = key << 1 | result-candidate flag, w = row.  A survivor's d2 is
// never NaN or negative (it is strictly below a beam entry, and beams
// hold no NaN; a sum of squares is >= +0), so (d2, pk) orders as the
// 64-bit key (y, x) and (d2, pk, key) as (y, x, z).
__device__ __forceinline__ unsigned long long dp_key(float d2, int pk) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32)
         | static_cast<unsigned>(pk ^ 0x80000000);
}

__device__ __forceinline__ unsigned long long rec_key(int4 r) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(r.y)) << 32)
         | static_cast<unsigned>(r.x);
}

__device__ __forceinline__ bool rec_less(int4 a, int4 b) {
  const unsigned long long ka = rec_key(a), kb = rec_key(b);
  return ka < kb || (ka == kb && static_cast<unsigned>(a.z)
                                     < static_cast<unsigned>(b.z));
}

// the substages j = jmax .. 1 of bitonic block size k on one record a lane
// (index i): shuffles, no barrier
__device__ __forceinline__ int4 warp_stages(int4 v, int i, int k, int jmax) {
  for (int j = jmax; j > 0; j >>= 1) {
    int4 o;
    o.x = __shfl_xor_sync(kFull, v.x, j);
    o.y = __shfl_xor_sync(kFull, v.y, j);
    o.z = __shfl_xor_sync(kFull, v.z, j);
    o.w = __shfl_xor_sync(kFull, v.w, j);
    // the lower index of an ascending pair keeps the smaller record
    const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
    if (keep_min ? rec_less(o, v) : rec_less(v, o)) v = o;
  }
  return v;
}

// one warp pass over every group of 32 records: the substages below 32
// of block size k; after the last (k == n2), each group's result flags as
// a ballot word gm[g]
__device__ __forceinline__ void warp_pass(int4* rec, int* gm, int n2, int k) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < n2 / 32; g += kWarps) {
    const int i = g * 32 + lane;
    int4 v = rec[i];
    if (k <= 32) {              // every block size up to k
      for (int kk = 2; kk <= k; kk <<= 1) v = warp_stages(v, i, kk, kk >> 1);
    } else {
      v = warp_stages(v, i, k, 16);
    }
    rec[i] = v;
    if (k == n2) {
      const unsigned m = __ballot_sync(kFull, v.z & 1);
      if (lane == 0) gm[g] = static_cast<int>(m);
    }
  }
}

// Sort the n2 (a power of two >= 32) records ascending: a bitonic network
// whose substages below 32 run in registers over shuffles, one warp pass
// and one barrier per block size, and whose wider substages exchange
// through shared memory, one barrier each.  Then gp[g]: the result
// candidates of the groups before g.  Ends with a block barrier.
__device__ __forceinline__ void sort_survivors(int4* rec, int* gm, int* gp,
                                               int n2) {
  warp_pass(rec, gm, n2, min(n2, 32));
  __syncthreads();
  for (int k = 64; k <= n2; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int p = threadIdx.x; p < n2 / 2; p += kThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1)), o = i | j;
        const int4 a = rec[i], b = rec[o];
        if (rec_less(b, a) == ((i & k) == 0)) { rec[i] = b; rec[o] = a; }
      }
      __syncthreads();
    }
    warp_pass(rec, gm, n2, k);
    __syncthreads();
  }
  if (threadIdx.x < 32) {       // exclusive prefix of the groups' counts
    const int groups = n2 / 32;
    int carry = 0;
    for (int g0 = 0; g0 < groups; g0 += 32) {
      const int g = g0 + (int)threadIdx.x;
      const int c = g < groups ? __popc(static_cast<unsigned>(gm[g])) : 0;
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if ((int)threadIdx.x >= off) incl += v;
      }
      if (g < groups) gp[g] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();
}

// result candidates among the first b sorted records
__device__ __forceinline__ int flagged_below(const int* gm, const int* gp,
                                             int groups, int b) {
  const int g = b >> 5;
  if (g >= groups)
    return gp[groups - 1] + __popc(static_cast<unsigned>(gm[groups - 1]));
  const unsigned m = static_cast<unsigned>(gm[g]);
  return gp[g] + __popc(m & ((1u << (b & 31)) - 1u));
}

// sorted records (the first n) whose (d2, pk) is strictly below `key`
__device__ __forceinline__ int recs_below(const int4* rec, int n,
                                          unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rec_key(rec[mid]) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// beam entries (d, p) at or below `key`
__device__ __forceinline__ int beam_at_or_below(const float* d, const int* p,
                                                int n,
                                                unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dp_key(d[mid], p[mid]) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge the ns survivors into both beams, from half `cur` into the other;
// the survivors that enter the traversal beam are listed in front.  Ends
// with a block barrier.
__device__ __forceinline__ void merge_round(const Smem& S, Counts& C,
                                            int cur, int beam, int ns) {
  int n2 = 32;
  while (n2 < ns) n2 <<= 1;
  // the staged tiles are spent (no copy in flight): the groups' words
  int* gm = reinterpret_cast<int*>(S.stage);
  int* gp = gm + n2 / 32;
  if (ns > 0) {
    for (int s = ns + threadIdx.x; s < n2; s += kThreads)
      S.rec[s] = make_int4(-1, -1, -2, kSentinel);     // sorts last
    __syncthreads();
    sort_survivors(S.rec, gm, gp, n2);
  }
  const int groups = n2 / 32;
  const int o = cur * beam, nx = (cur ^ 1) * beam;   // read, written half
  const float *bd = S.bd + o, *rd = S.rd + o;
  const int *bp = S.bp + o, *bi = S.bi + o, *rp = S.rp + o, *ri = S.ri + o;
  for (int w = threadIdx.x; w < ns + 2 * beam; w += kThreads) {
    if (w < ns) {               // a survivor, at its rank w
      const int4 v = S.rec[w];
      const unsigned long long key = rec_key(v);
      const float d2 = __uint_as_float(static_cast<unsigned>(v.y));
      const int pk = v.x ^ 0x80000000;
      const int pos = w + beam_at_or_below(bd, bp, beam, key);
      if (pos < beam) {
        S.bd[nx + pos] = d2; S.bp[nx + pos] = pk; S.bi[nx + pos] = v.w;
        S.front[atomicAdd(&C.nf, 1)] = v.w;
      }
      if (v.z & 1) {
        const int rpos = flagged_below(gm, gp, groups, w)
                         + beam_at_or_below(rd, rp, beam, key);
        if (rpos < beam) {
          S.rd[nx + rpos] = d2; S.rp[nx + rpos] = pk; S.ri[nx + rpos] = v.w;
        }
      }
    } else {                    // an old entry of either beam
      const bool res = w - ns >= beam;
      const int i = res ? w - ns - beam : w - ns;
      const float od = res ? rd[i] : bd[i];
      const int op = res ? rp[i] : bp[i];
      int below = 0;
      if (ns > 0) {
        below = recs_below(S.rec, ns, dp_key(od, op));
        if (res) below = flagged_below(gm, gp, groups, below);
      }
      const int pos = i + below;
      if (pos < beam) {
        if (res) {
          S.rd[nx + pos] = od; S.rp[nx + pos] = op; S.ri[nx + pos] = ri[i];
        } else {
          S.bd[nx + pos] = od; S.bp[nx + pos] = op; S.bi[nx + pos] = bi[i];
        }
      }
    }
  }
  if (threadIdx.x == 0) C.nc = 0;     // for the next hop's expansion
  __syncthreads();
}

template <bool kSharedVis>
__global__ void __launch_bounds__(kThreads)
graph_search_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    const int* __restrict__ nbrs,
                    const int* __restrict__ entries,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ pks, float* __restrict__ out_d,
                    int* __restrict__ out_p, int* __restrict__ out_r,
                    int* __restrict__ vis, int d, long long n, int r_deg,
                    int n_ent, int beam, int hops, int cap, int tr,
                    bool vec) {
  extern __shared__ __align__(16) float smem[];
  Smem S;
  S.stage = smem;
  Counts& C = *reinterpret_cast<Counts*>(S.stage + kSlots * tr * kXs);
  S.q = S.stage + kSlots * tr * kXs + kHeader;
  S.rec = reinterpret_cast<int4*>(S.q + ((d + 3) & ~3));
  S.bd = reinterpret_cast<float*>(S.rec + cap);
  S.rd = S.bd + 2 * beam;
  S.bp = reinterpret_cast<int*>(S.rd + 2 * beam);
  S.bi = S.bp + 2 * beam; S.rp = S.bi + 2 * beam; S.ri = S.rp + 2 * beam;
  S.front = S.ri + 2 * beam;
  S.fr = S.front + beam;
  const long long nw = n / 32;
  const long long qrow = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* vis_q = kSharedVis
      ? reinterpret_cast<unsigned*>(S.fr + cap)
      : reinterpret_cast<unsigned*>(vis) + qrow * nw;
  const uint8_t* mask_q = mask + qrow * n;

  for (long long w = threadIdx.x; w < nw; w += kThreads) vis_q[w] = 0u;
  for (int j = threadIdx.x; j < ((d + 3) & ~3); j += kThreads)
    S.q[j] = j < d ? q[qrow * d + j] : 0.f;
  for (int i = threadIdx.x; i < beam; i += kThreads) {
    S.bd[i] = S.rd[i] = INFINITY;
    S.bp[i] = S.bi[i] = S.rp[i] = S.ri[i] = kSentinel;
  }
  if (threadIdx.x == 0) { C.nc = 0; C.ns = 0; C.nf = 0; }
  __syncthreads();

  // seed: every entry row, visited, listed in position order (so a
  // seed's index in fr orders its ties as its position does)
  int* wc = reinterpret_cast<int*>(S.stage);   // the warps' counts
  int nc = 0;
  for (int t0 = 0; t0 < n_ent; t0 += kThreads) {
    const int t = t0 + (int)threadIdx.x;
    const int e = t < n_ent ? entries[t] : kSentinel;
    const bool ok = e != kSentinel && e >= 0 && e < n;
    const unsigned b = __ballot_sync(kFull, ok);
    if (lane == 0) wc[warp] = __popc(b);
    __syncthreads();
    int base = nc;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) base += wc[w];
      nc += wc[w];
    }
    if (ok) {
      atomicOr(vis_q + (e >> 5), 1u << (e & 31));
      S.fr[base + __popc(b & ((1u << lane) - 1u))] = e;
    }
    __syncthreads();            // wc read before the next batch sets it
  }
  int cur = 0;
  for (int h = 0; h <= hops && beam > 0; ++h) {   // beam 0: seeds only
    if (h > 0) {
      // expand the rows that entered the traversal beam last round
      const int nf = C.nf;
      __syncthreads();          // everyone read nf before it is reset
      if (nf == 0) break;       // no row entered: every later hop is empty
      if (threadIdx.x == 0) { C.ns = 0; C.nf = 0; }
      const int slots = nf * r_deg;
      for (int t0 = 0; t0 < slots; t0 += kThreads * kExpand) {
        int c[kExpand];       // every load in flight before any test
#pragma unroll
        for (int u = 0; u < kExpand; ++u) {
          const int t = t0 + u * kThreads + (int)threadIdx.x;
          c[u] = t < slots
              ? nbrs[(long long)S.front[t / r_deg] * r_deg + t % r_deg] : -1;
        }
#pragma unroll
        for (int u = 0; u < kExpand; ++u) {
          if (c[u] < 0) continue;                     // -1 padding
          const unsigned bit = 1u << (c[u] & 31);
          if (atomicOr(vis_q + (c[u] >> 5), bit) & bit) continue;   // seen
          S.fr[atomicAdd(&C.nc, 1)] = c[u];
        }
      }
      __syncthreads();
      nc = C.nc;
      if (nc == 0) break;       // nothing fresh: no row can enter
    } else {
      if (threadIdx.x == 0) { C.ns = 0; C.nf = 0; }
      __syncthreads();
    }
    score_round(S, C, cur, x, pks, mask_q, d, beam, nc, tr, h == 0, vec);
    merge_round(S, C, cur, beam, C.ns);
    cur ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if (kSharedVis) {
    unsigned* out_v = reinterpret_cast<unsigned*>(vis) + qrow * nw;
    __syncthreads();
    for (long long w = threadIdx.x; w < nw; w += kThreads) out_v[w] = vis_q[w];
  }
  for (int i = threadIdx.x; i < beam; i += kThreads) {
    out_d[qrow * beam + i] = S.rd[cur * beam + i];
    out_p[qrow * beam + i] = S.rp[cur * beam + i];
    out_r[qrow * beam + i] = S.ri[cur * beam + i];
  }
}

}  // namespace

// q (nq, d) fp32; x (n, d) fp32 with n a multiple of 32; nbrs (n, r_deg)
// int32, -1 padded; entries (n_ent,) int32, SENTINEL padded; mask (nq, n)
// uint8; pks (n,) int32; out_* (nq, beam); vis (nq, n / 32) int32, which
// the kernel writes whole (no zeroing by the caller).  cap: a power of two
// >= max(beam * r_deg, n_ent, 32), the fresh-row and survivor capacity
// (whole groups of 32).  tile_rows: rows of a staged tile, 256, 128, 64
// or 32.  shared_vis: keep the visited words in shared memory.
// smem_bytes: the caller's sum of the layout (smem_words), which must
// equal the launcher's.
extern "C" int graph_search_topk_launch(
    const float* q, const float* x, const int* nbrs, const int* entries,
    const uint8_t* mask, const int* pks, float* out_d, int* out_p,
    int* out_r, int* vis, int nq, int d, long long n, int r_deg, int n_ent,
    int beam, int hops, int cap, int tile_rows, int shared_vis,
    long long smem_bytes, void* stream) {
  if (nq == 0) return 0;
  if (cap < beam * r_deg || cap < n_ent || cap < 32 || (cap & (cap - 1))
      || n % 32 || d < 0 || hops < 0
      || (tile_rows != 256 && tile_rows != 128 && tile_rows != 64
          && tile_rows != 32))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_words(d, beam, cap, n, shared_vis != 0,
                                         tile_rows) * sizeof(float);
  if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static size_t set_shared[kDevices], set_global[kDevices];
  cudaError_t e;
  if (shared_vis) {
    e = allow_smem(graph_search_kernel<true>, smem, set_shared);
    if (e != cudaSuccess) return (int)e;
    graph_search_kernel<true><<<nq, kThreads, smem, s>>>(
        q, x, nbrs, entries, mask, pks, out_d, out_p, out_r, vis, d, n,
        r_deg, n_ent, beam, hops, cap, tile_rows, vec);
  } else {
    e = allow_smem(graph_search_kernel<false>, smem, set_global);
    if (e != cudaSuccess) return (int)e;
    graph_search_kernel<false><<<nq, kThreads, smem, s>>>(
        q, x, nbrs, entries, mask, pks, out_d, out_p, out_r, vis, d, n,
        r_deg, n_ent, beam, hops, cap, tile_rows, vec);
  }
  return (int)cudaGetLastError();
}
