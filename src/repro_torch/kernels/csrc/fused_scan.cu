// Fused masked scan -> per-query top-k over the packed superbatch.
//
// Replaces src/repro/kernels/fused_scan.py::fused_scan_topk (the Pallas
// kernel _fused_scan_topk_kernel, its pallas_call at :111).  Same result
// contract: for each query the KMAX smallest squared-L2 distances over the
// rows its uint8 mask admits, ordered by (d2, pk, row), with the row
// reported as its position in the kept-block list (kept index * BLOCK_N +
// offset), and empty slots (+inf, SENTINEL, SENTINEL).
//
// Numerics: per query qn is one fmaf chain of q_k * q_k from 0 over k in
// order; per row xn = fmaf(x_k, x_k, xn) and per (query, row) dot =
// fmaf(q_k, x_k, dot), k in order from 0; d2 = (qn - 2 dot) + xn
// (dist2).  Every launch below that scores a row runs exactly these
// operations (no fast-math, TF32 or tensor cores), so a row has the same
// d2 in each of them and in the first CUDA port of this kernel, whose
// results these are bit for bit.
//
// What bounds it on Hopper: the bytes of x, 4 d of them for each row some
// query admits (1 GB at t6's 8 queries x 2,097,152 rows, d 128: 0.32 ms
// at 3.35 TB/s); its ~4 flops a byte are well under the ~20 at which the
// fp32 FMA pipes would bound it.  The earlier design (a register top-128
// list per (query, chunk of kept blocks) over 512 chunks, then one warp
// per query merging the 512 lists) ran at 16 % of that bound: its pass 1
// had one ~16 KB load a block in flight, two block barriers per tile, and
// lists that started empty in every chunk; its merge walked 512 lists one
// after another, whatever the row count (PERF.md §6 breaks it down).
// This one reads each admitted 32-row group once (and a 1/32 sample of
// rows twice), in four launches, and on the card (PERF.md §6) its scan
// runs within 5 % of its own copy path, which streams x at ~82 % of the
// card's rate:
//   witness (fscan_witness): grid (query tiles of 8, chunks of 32-row
//           groups).  Each block scores a sample, the first 8 rows of one
//           group in 8 of its chunk (1/32 of the rows, at most 1,024), for
//           the rows some query of the tile admits, and publishes per
//           query its 2 smallest admitted d2 as order-preserving keys
//           (publish_witnesses); the first chunk zeroes the tile's
//           candidate counts.
//   threshold (topk_threshold, scan_select.cuh): tau >= the 128th
//           smallest witness of the query, +inf with fewer than 128.
//   scan (fscan_scan): grid (query tiles, chunks), two 256-thread blocks
//           an SM, no block barrier in the loop.  The chunks split the
//           kept blocks' groups evenly; warp w takes groups w, w + 8, ...
//           of its chunk.  It reads each group's mask bytes a group ahead
//           and skips a group that no query of the tile admits (its x is
//           never read), so an exact re-rank reads only the groups of its
//           few rows.  Each admitted group's rows stream through the
//           warp's two-slot ring (32 rows x 32 features a slot, one slot
//           in flight while the other is used: 16 warps x 4.6 KB an SM;
//           16-byte cp.async copies, d % 4 != 0: 4-byte) into rows padded
//           to 36 floats, whose float4 reads conflict in no bank; lane
//           (g, r) holds the 2 x 4 distances of rows r, r + 16 and
//           queries 4g .. 4g + 3 in registers, each shared-memory word
//           feeding 4 or 8 FMAs.  A row with d2 <= tau goes to its
//           query's region of the chunk (128 slots, a shared count); if
//           more arrive, that query's warp rescans the chunk through a
//           register top-128 list (topk_list.cuh).  Each region is then
//           appended to the query's candidate list.
//   select (topk_select, scan_select.cuh): one block per query sorts the
//           candidates by the exact (d2, pk, row) key, pks fetched there.
// The candidates hold every row of the true top-128 (the filter drops none
// of them: 128 distinct admitted rows score at or under tau; and each is
// among its chunk's 128 best), so the result is the earlier kernel's.
//
// Edge semantics, those of the TPU kernel's lax.sort on (d2, pk) and of
// the first CUDA port's key_less: a NaN d2 never enters the answer (no
// filter passes it and the rescan's list starts with empty slots that
// order before it).  An admitted row whose d2 overflows to +inf orders
// before an empty slot, by pk: it passes a tau of +inf, which a query
// with fewer than 128 finite witnesses gets (a +inf witness counts), so
// it comes back when fewer than 128 finite rows are admitted.  Rows past
// n_mask are never admitted.  A row at d2 == tau passes (ties break by pk,
// then row).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_select.cuh"
#include "smem_limit.cuh"
#include "topk_list.cuh"

namespace {

constexpr int kBlockQ = 8;      // queries per tile (BLOCK_Q)
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;       // rows of a group: one warp step
constexpr int kGroups = kBlockN / kRows;   // groups of a kept block
constexpr int kDk = 32;         // features of a staged tile
constexpr int kXs = kDk + 4;    // staged row stride: 9 16-byte units
constexpr int kStage = kRows * kXs;        // floats of a ring slot
constexpr int kSlots = 2;       // ring slots a warp: one in flight
constexpr int kScanBlocks = 2;  // scan blocks an SM
constexpr int kWit = 2;         // witnesses per (chunk, query)
constexpr int kSampleRows = 8;  // sampled rows of a sampled group
constexpr int kSampleEvery = 8;      // a chunk samples one group in 8
constexpr int kSampleGroups = 128;   // sampled groups a chunk, at most
constexpr int kSample = kSampleRows * kSampleGroups;   // 4 rows a thread
constexpr int kMaxChunks = 512;
static_assert(kMaxChunks * kWit <= kMaxWitnesses, "topk_threshold's "
              "witness registers");

// Row stride of the query tile in shared memory: d rounded up to a float4,
// plus one float4 when that is a multiple of 8 of them, so that the two
// query groups' float4 reads fall in different banks.
__host__ __device__ inline int q_stride(int d) {
  const int d4 = (d + 3) & ~3;
  return (d4 & 7) ? d4 : d4 + 4;
}

// What a ring slot holds: a group's k-tile kt (of its kept-block
// position kpos0), whether it is the group's last, whether it is any.
struct Slot {
  int kt;
  int kpos0;
  int last;
  int valid;
};

// Dynamic shared memory of a scan block at d features: the query tile,
// the rings, the slots' meta and admit bits, the queries' norms, and a
// count and an overflow flag per query.  The wrapper states the same sum
// (fused_scan.py's smem_bytes), refuses a d whose need exceeds the card's
// per-block limit, and hands its sum to the launcher, which refuses it
// unless it equals this.
inline size_t smem_bytes(int d) {
  return (size_t)kBlockQ * q_stride(d) * sizeof(float)        // q_s
         + (size_t)kWarps * kSlots * kStage * sizeof(float)   // rings
         + (size_t)kWarps * kSlots * sizeof(Slot)             // slot meta
         + (size_t)kWarps * kSlots * 32                       // admit bits
         + (size_t)kBlockQ * sizeof(float)                    // qn_s
         + (size_t)2 * kBlockQ * sizeof(int);                 // counts
}

// The first group of chunk c of n_chunks over ng groups (c = n_chunks:
// ng): the groups split as evenly as integers allow.
__device__ __forceinline__ int chunk_start(int c, int n_chunks, int ng) {
  return (int)((long long)c * ng / n_chunks);
}

__device__ __forceinline__ float dist2(float qn, float dot, float xn) {
  return (qn - 2.f * dot) + xn;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The tile's queries into q_s (rows of q_stride(d)) and their norms into
// qn_s; ends with a block barrier.
__device__ __forceinline__ void load_queries(float* q_s, float* qn_s,
                                             const float* __restrict__ qt,
                                             int d, int qs, int tid) {
  for (int i = tid; i < kBlockQ * d; i += kThreads)
    q_s[(i / d) * qs + i % d] = qt[i];
  __syncthreads();
  if (tid < kBlockQ) {
    float s = 0.f;
    for (int k = 0; k < d; ++k)
      s = fmaf(q_s[tid * qs + k], q_s[tid * qs + k], s);
    qn_s[tid] = s;
  }
  __syncthreads();
}

// d2 of one row (read from global memory, 16-byte aligned when kVec) for
// the tile's 8 queries.
template <bool kVec>
__device__ __forceinline__ void row_d2(const float* __restrict__ xr,
                                       const float* q_s, int qs, int d,
                                       const float* qn_s,
                                       float (&d2)[kBlockQ]) {
  float xn = 0.f, dot[kBlockQ];
#pragma unroll
  for (int q = 0; q < kBlockQ; ++q) dot[q] = 0.f;
  int k = 0;
  if (kVec) {
    for (; k + 4 <= d; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + k));
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xn = fmaf(xv[c], xv[c], xn);
#pragma unroll
        for (int q = 0; q < kBlockQ; ++q)
          dot[q] = fmaf(q_s[q * qs + k + c], xv[c], dot[q]);
      }
    }
  }
  for (; k < d; ++k) {
    const float xv = __ldg(xr + k);
    xn = fmaf(xv, xv, xn);
#pragma unroll
    for (int q = 0; q < kBlockQ; ++q)
      dot[q] = fmaf(q_s[q * qs + k], xv, dot[q]);
  }
#pragma unroll
  for (int q = 0; q < kBlockQ; ++q) d2[q] = dist2(qn_s[q], dot[q], xn);
}

// ------------------------------------------------------------- witness

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fscan_witness(const float* __restrict__ q, const float* __restrict__ x,
              const uint8_t* __restrict__ mask, const int* __restrict__ keep,
              const int* __restrict__ occ, unsigned* __restrict__ wit,
              int* __restrict__ cand_n, int d, long long n_mask, int nkeep,
              int n_chunks) {
  extern __shared__ __align__(16) float q_s[];     // [kBlockQ][q_stride(d)]
  __shared__ unsigned key_s[kBlockQ * kSample];
  __shared__ float qn_s[kBlockQ];
  const int qt = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = (long long)qt * kBlockQ;
  if (chunk == 0 && tid < kBlockQ) cand_n[q0 + tid] = 0;
  const int qs = q_stride(d);
  load_queries(q_s, qn_s, q + q0 * d, d, qs, tid);

  const int g_lo = chunk_start(chunk, n_chunks, nkeep * kGroups);
  const int n_grp = chunk_start(chunk + 1, n_chunks, nkeep * kGroups) - g_lo;
  const int ns = min(kSampleGroups,
                     (n_grp + kSampleEvery - 1) / kSampleEvery);
  for (int s = tid; s < kSample; s += kThreads) {
    unsigned key[kBlockQ];
#pragma unroll
    for (int i = 0; i < kBlockQ; ++i) key[i] = kNone;
    const int gi = s / kSampleRows;
    const int j = g_lo + (int)((long long)gi * n_grp / ns);
    const int kb = j / kGroups;
    if (gi < ns && occ[(long long)qt * nkeep + kb] != 0) {
      const long long prow = (long long)keep[kb] * kBlockN
                             + (j % kGroups) * kRows + s % kSampleRows;
      uint32_t ok = 0;
      if (prow < n_mask) {
#pragma unroll
        for (int i = 0; i < kBlockQ; ++i)
          ok |= (__ldg(mask + (q0 + i) * n_mask + prow) != 0 ? 1u : 0u) << i;
      }
      if (ok) {
        float d2[kBlockQ];
        row_d2<kVec>(x + prow * d, q_s, qs, d, qn_s, d2);
#pragma unroll
        for (int i = 0; i < kBlockQ; ++i)
          if (((ok >> i) & 1u) && !isnan(d2[i])) key[i] = ord_key(d2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBlockQ; ++i) key_s[i * kSample + s] = key[i];
  }
  __syncthreads();
  // warp w: the kWit smallest keys of query w's sample, smallest first
  publish_witnesses<kSample, kWit>(
      key_s + warp * kSample,
      wit + (q0 + warp) * ((long long)n_chunks * kWit)
          + (long long)chunk * kWit,
      lane);
}

// ---------------------------------------------------------------- scan

// Admit bits of a group for lane (g, r): bit 2i + h for query qb + i and
// row prow + 16 h.
__device__ __forceinline__ uint32_t group_ok(const uint8_t* __restrict__ mask,
                                             long long prow, long long n_mask,
                                             long long qb) {
  uint32_t ok = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long p = prow + 16 * h;
    if (p < n_mask) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ok |= (__ldg(mask + (qb + i) * n_mask + p) != 0 ? 1u : 0u)
              << (2 * i + h);
    }
  }
  return ok;
}

// A warp's place in its chunk: group j (kept-block position 32 j), its
// first row of x and the lane's admit bits.
struct Cursor {
  int j;
  uint32_t ok;
  long long row0;
};

// The warp's first group at or after j (j, j + 8, ...) below g_hi of a
// kept block the tile occupies (j >= g_hi if none), with its lane's admit
// bits, whose loads stay in flight until the bits are read.
__device__ __forceinline__ Cursor peek(int j, int g_hi,
                                       const int* __restrict__ occ_t,
                                       const int* __restrict__ keep,
                                       const uint8_t* __restrict__ mask,
                                       long long n_mask, long long qb,
                                       int r) {
  while (j < g_hi && occ_t[j / kGroups] == 0) j += kWarps;   // uniform
  Cursor c{j, 0u, 0};
  if (j < g_hi) {
    c.row0 = (long long)keep[j / kGroups] * kBlockN + (j % kGroups) * kRows;
    c.ok = group_ok(mask, c.row0 + r, n_mask, qb);
  }
  return c;
}

// A group's k-tile kt (32 rows x up to 32 features from global row prow0)
// into a ring slot, rows kXs floats apart: 16-byte copies (kVec: d % 4 ==
// 0 and x 16-byte aligned, so every row segment is), else 4-byte ones.
template <bool kVec>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ x,
                                          long long prow0, int d, int kt,
                                          int lane) {
  const int k0 = kt * kDk, kw = min(kDk, d - k0);
  const float* src = x + prow0 * d + k0;
  if (kVec) {
    const int cpr = kw >> 2;        // 16-byte pieces a row
    for (int c = lane; c < kRows * cpr; c += 32) {
      const int rr = cpr == kDk / 4 ? c >> 3 : c / cpr;
      const int ch = c - rr * cpr;
      cp_async16(dst + rr * kXs + 4 * ch, src + (long long)rr * d + 4 * ch);
    }
  } else {
    for (int c = lane; c < kRows * kw; c += 32) {
      const int rr = c / kw, kk = c - rr * kw;
      cp_async4(dst + rr * kXs + kk, src + (long long)rr * d + kk);
    }
  }
}

// Four features (k .. k + 3 of the slot's rows a and b, of the queries'
// rows qb at stride qs) into lane (g, r)'s chains, in feature order.
__device__ __forceinline__ void fma4(const float* a, const float* b,
                                     const float* qb, int qs, int k,
                                     float (&dot)[2][4], float (&xn)[2]) {
  const float4 a4 = *reinterpret_cast<const float4*>(a + k);
  const float4 b4 = *reinterpret_cast<const float4*>(b + k);
  float qf[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(qb + i * qs + k);
    qf[i][0] = v.x;
    qf[i][1] = v.y;
    qf[i][2] = v.z;
    qf[i][3] = v.w;
  }
  const float av[4] = {a4.x, a4.y, a4.z, a4.w};
  const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    xn[0] = fmaf(av[c], av[c], xn[0]);
    xn[1] = fmaf(bv[c], bv[c], xn[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dot[0][i] = fmaf(qf[i][c], av[c], dot[0][i]);
      dot[1][i] = fmaf(qf[i][c], bv[c], dot[1][i]);
    }
  }
}

// One k-tile of kw features into lane (g, r)'s chains: rows r and r + 16
// of the slot, queries 4g .. 4g + 3 (qb: their rows of q_s at the tile's
// first feature), features in order.
__device__ __forceinline__ void accumulate(const float* xs, const float* qb,
                                           int qs, int kw, int r,
                                           float (&dot)[2][4],
                                           float (&xn)[2]) {
  const float* x0 = xs + r * kXs;
  const float* x1 = xs + (r + 16) * kXs;
  if (kw == kDk) {
#pragma unroll
    for (int k = 0; k < kDk; k += 4) fma4(x0, x1, qb, qs, k, dot, xn);
    return;
  }
  int k = 0;
  for (; k + 4 <= kw; k += 4) fma4(x0, x1, qb, qs, k, dot, xn);
  for (; k < kw; ++k) {
    const float a = x0[k], b = x1[k];
    xn[0] = fmaf(a, a, xn[0]);
    xn[1] = fmaf(b, b, xn[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dot[0][i] = fmaf(qb[i * qs + k], a, dot[0][i]);
      dot[1][i] = fmaf(qb[i * qs + k], b, dot[1][i]);
    }
  }
}

// Query w's candidates of the chunk again, by warp w, through a register
// top-128 list (x read from global memory, pks fetched for the rows that
// reach it): the chunk's kK best among admitted rows with d2 <= t.  Its
// entries go to the region at reg; returns their count.
template <bool kVec>
__device__ int rescan(const float* __restrict__ x, const float* qw, float qn,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ pks,
                      const int* __restrict__ keep,
                      const int* __restrict__ occ_t, long long qi, float t,
                      int g_lo, int g_hi, int d, long long n_mask,
                      float* __restrict__ reg_d, int* __restrict__ reg_r,
                      long long reg, int lane) {
  WarpList L;
  list_init(L);
  float wd = INFINITY;
  int wp = kSentinel, wr = kSentinel;
  for (int j = g_lo; j < g_hi; ++j) {
    const int kb = j / kGroups;
    if (occ_t[kb] == 0) continue;
    const int kpos = kb * kBlockN + (j % kGroups) * kRows + lane;
    const long long prow = (long long)keep[kb] * kBlockN
                           + (j % kGroups) * kRows + lane;
    const bool ok = prow < n_mask && mask[qi * n_mask + prow] != 0;
    if (!__any_sync(kFull, ok)) continue;
    float d2 = 0.f;
    if (ok) {
      const float* xr = x + prow * d;
      float xn = 0.f, dot = 0.f;
      int k = 0;
      if (kVec) {
        for (; k + 4 <= d; k += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xr + k));
          xn = fmaf(v.x, v.x, xn);
          dot = fmaf(qw[k], v.x, dot);
          xn = fmaf(v.y, v.y, xn);
          dot = fmaf(qw[k + 1], v.y, dot);
          xn = fmaf(v.z, v.z, xn);
          dot = fmaf(qw[k + 2], v.z, dot);
          xn = fmaf(v.w, v.w, xn);
          dot = fmaf(qw[k + 3], v.w, dot);
        }
      }
      for (; k < d; ++k) {
        const float xv = __ldg(xr + k);
        xn = fmaf(xv, xv, xn);
        dot = fmaf(qw[k], xv, dot);
      }
      d2 = dist2(qn, dot, xn);
    }
    const float lim = wr != kSentinel ? fminf(t, wd) : t;
    const bool pass = ok && d2 <= lim;
    offer(L, pass, d2, pass ? pk_of(pks, keep, kpos) : kSentinel, kpos,
          lane, wd, wp, wr);
  }
  int real = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {     // real entries come first
    if (L.r[j] == kSentinel) continue;
    reg_d[reg + 4 * lane + j] = L.d[j];
    reg_r[reg + 4 * lane + j] = L.r[j];
    ++real;
  }
  return (int)__reduce_add_sync(kFull, (unsigned)real);
}

// Each warp streams its admitted groups with no block barrier: a group's
// mask bytes are read a group before its first tile is issued, its tiles
// flow through the warp's two-slot ring (one in flight), and after a
// group's last tile each lane filters its 8 distances by tau into the
// queries' regions (a shared count each; one past kK flags the query,
// and once the chunk is done its warp redoes it by rescan).  Each region
// then goes to its query's candidate list (cand_n counts it).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kScanBlocks)
fscan_scan(const float* __restrict__ q, const float* __restrict__ x,
           const uint8_t* __restrict__ mask, const int* __restrict__ pks,
           const int* __restrict__ keep, const int* __restrict__ occ,
           const float* __restrict__ tau, float* __restrict__ reg_d,
           int* __restrict__ reg_r, float* __restrict__ cand_d,
           int* __restrict__ cand_r, int* __restrict__ cand_n, int d,
           long long n_mask, int nkeep, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int qs = q_stride(d);
  float* q_s = smem;                                  // [8][qs]
  float* ring = q_s + kBlockQ * qs;                // [warp][slot][kStage]
  Slot* slot_s = reinterpret_cast<Slot*>(ring + kWarps * kSlots * kStage);
  uint8_t* okb_s = reinterpret_cast<uint8_t*>(slot_s + kWarps * kSlots);
  float* qn_s = reinterpret_cast<float*>(okb_s + kWarps * kSlots * 32);
  int* cnt_s = reinterpret_cast<int*>(qn_s + kBlockQ);
  int* ovf_s = cnt_s + kBlockQ;

  const int qt = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 4, r = lane & 15;
  const long long q0 = (long long)qt * kBlockQ;
  const long long cap = (long long)n_chunks * kK;
  if (tid < kBlockQ) {
    cnt_s[tid] = 0;
    ovf_s[tid] = 0;
  }
  load_queries(q_s, qn_s, q + q0 * d, d, qs, tid);
  float thr[4], qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    thr[i] = __ldg(tau + q0 + 4 * g + i);
    qn[i] = qn_s[4 * g + i];
  }
  const float* qb = q_s + 4 * g * qs;

  const int* occ_t = occ + (long long)qt * nkeep;
  const int g_lo = chunk_start(chunk, n_chunks, nkeep * kGroups);
  const int g_hi = chunk_start(chunk + 1, n_chunks, nkeep * kGroups);
  const int ntiles = (d + kDk - 1) / kDk;
  float* my_ring = ring + warp * kSlots * kStage;
  Slot* my_slot = slot_s + warp * kSlots;
  uint8_t* my_ok = okb_s + warp * kSlots * 32;

  // the fetch cursor: group cur (cur.j >= g_hi once done) and its tile
  // ft; the next occupied group's mask bytes are read a group ahead
  const long long qb4 = q0 + 4 * g;
  Cursor next = peek(g_lo + warp, g_hi, occ_t, keep, mask, n_mask, qb4, r);
  Cursor cur;
  auto advance = [&]() {              // cur = the next admitted group
    cur = next;
    while (cur.j < g_hi && !__any_sync(kFull, cur.ok != 0))
      cur = peek(cur.j + kWarps, g_hi, occ_t, keep, mask, n_mask, qb4, r);
    next = peek(cur.j + kWarps, g_hi, occ_t, keep, mask, n_mask, qb4, r);
  };
  advance();
  int ft = 0;
  auto fetch = [&](int sl) {
    if (cur.j < g_hi) {
      copy_tile<kVec>(my_ring + sl * kStage, x, cur.row0, d, ft, lane);
      if (lane == 0)
        my_slot[sl] = Slot{ft, cur.j * kRows, ft == ntiles - 1, 1};
      my_ok[sl * 32 + lane] = (uint8_t)cur.ok;
      if (++ft == ntiles) {
        ft = 0;
        advance();
      }
    } else if (lane == 0) {
      my_slot[sl] = Slot{0, 0, 0, 0};
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kSlots - 1; ++i) fetch(i);

  float dot[2][4], xn[2];
  for (int p = 0;; ++p) {
    const int sl = p % kSlots;
    fetch((p + kSlots - 1) % kSlots);   // the slot consumed last iteration
    cp_async_wait<kSlots - 1>();    // slot sl's copies have landed
    __syncwarp();
    const Slot m = my_slot[sl];
    if (!m.valid) break;            // the same on every lane
    if (m.kt == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xn[h] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dot[h][i] = 0.f;
      }
    }
    accumulate(my_ring + sl * kStage, qb + m.kt * kDk, qs,
               min(kDk, d - m.kt * kDk), r, dot, xn);
    if (m.last) {
      const uint32_t ok = my_ok[sl * 32 + lane];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = 4 * g + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d2 = dist2(qn[i], dot[h][i], xn[h]);
          const bool pass = ((ok >> (2 * i + h)) & 1u) && d2 <= thr[i];
          const unsigned b = __ballot_sync(kFull, pass);
          if (!b) continue;
          const unsigned mine = g ? b >> 16 : b & 0xffffu;
          // append to region qq: one shared atomic per half-warp
          const int leader = mine ? g * 16 + __ffs(mine) - 1 : lane;
          int at = 0;
          if (lane == leader && mine)
            at = atomicAdd(&cnt_s[qq], __popc(mine));
          at = __shfl_sync(kFull, at, leader)
               + __popc(mine & ((1u << r) - 1u));
          if (pass) {
            if (at < kK) {
              const long long reg = (q0 + qq) * cap + (long long)chunk * kK;
              reg_d[reg + at] = d2;
              reg_r[reg + at] = m.kpos0 + r + 16 * h;
            } else {
              ovf_s[qq] = 1;
            }
          }
        }
      }
    }
    __syncwarp();                   // slot sl is refilled next iteration
  }
  cp_async_wait<0>();
  __syncthreads();
  // warp w settles query w: its region as filled or, past kK, refilled
  // by a rescan; then appended to the query's candidate list
  const long long qi = q0 + warp;
  const long long reg = qi * cap + (long long)chunk * kK;
  int n = min(cnt_s[warp], kK);
  if (ovf_s[warp])
    n = rescan<kVec>(x, q_s + warp * qs, qn_s[warp], mask, pks, keep, occ_t,
                     qi, __ldg(tau + qi), g_lo, g_hi, d, n_mask, reg_d,
                     reg_r, reg, lane);
  __syncwarp();
  if (n == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(&cand_n[qi], n);
  base = __shfl_sync(kFull, base, 0);
  for (int i = lane; i < n; i += 32) {
    cand_d[qi * cap + base + i] = reg_d[reg + i];
    cand_r[qi * cap + base + i] = reg_r[reg + i];
  }
}

template <bool kVec>
cudaError_t launch_all(const float* q, const float* x, const uint8_t* mask,
                       const int* pks, const int* keep, const int* occ,
                       unsigned* wit, float* tau, float* reg_d, int* reg_r,
                       float* cand_d, int* cand_r, int* cand_n, float* out_d,
                       int* out_p, int* out_r, int nq, int d,
                       long long n_mask, int nkeep, int n_chunks,
                       cudaStream_t s) {
  static size_t scan_set[kDevices], wit_set[kDevices];
  const size_t smem = smem_bytes(d);
  cudaError_t e = allow_smem(fscan_scan<kVec>, smem, scan_set);
  if (e != cudaSuccess) return e;
  const size_t wsmem = (size_t)kBlockQ * q_stride(d) * sizeof(float);
  e = allow_smem(fscan_witness<kVec>, wsmem, wit_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(nq / kBlockQ, n_chunks);
  fscan_witness<kVec><<<grid, kThreads, wsmem, s>>>(
      q, x, mask, keep, occ, wit, cand_n, d, n_mask, nkeep, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_threshold<<<(nq + kTauThreads / 32 - 1) / (kTauThreads / 32),
                   kTauThreads, 0, s>>>(wit, tau, nq, n_chunks * kWit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fscan_scan<kVec><<<grid, kThreads, smem, s>>>(
      q, x, mask, pks, keep, occ, tau, reg_d, reg_r, cand_d, cand_r, cand_n,
      d, n_mask, nkeep, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_select<<<nq, kSelectThreads, 0, s>>>(cand_d, cand_r, cand_n, pks,
                                            keep, n_chunks, out_d, out_p,
                                            out_r);
  return cudaGetLastError();
}

}  // namespace

// q (nq, d) with nq a multiple of 8; x (rows, d) with rows a multiple of
// 512 covering every kept block; mask (nq, n_mask) uint8; pks (rows,)
// int32; keep (nkeep,) int32 block ids; occ (nq / 8, nkeep) int32;
// scratch: wit (nq, n_chunks * 2) uint32, tau (nq,) fp32, reg_d/reg_r and
// cand_d/cand_r (nq, n_chunks * 128), cand_n (nq,) int32; out_* (nq, 128).
// Chunk c holds the 32-row groups [c G / n_chunks, (c + 1) G / n_chunks)
// of the G = 16 nkeep groups of the kept blocks (group j: rows 32 (j % 16)
// .. of kept block j / 16); n_chunks <= min(512, G).  smem_wrapper: the
// wrapper's shared-memory sum for d.
extern "C" int fused_scan_topk_launch(
    const float* q, const float* x, const uint8_t* mask, const int* pks,
    const int* keep, const int* occ, void* wit, float* tau, float* reg_d,
    int* reg_r, float* cand_d, int* cand_r, int* cand_n, float* out_d,
    int* out_p, int* out_r, int nq, int d, long long n_mask, int nkeep,
    int n_chunks, long long smem_wrapper, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_wrapper != (long long)smem_bytes(d))
    return (int)cudaErrorInvalidValue;
  if (n_chunks < 1 || n_chunks > kMaxChunks
      || (long long)n_chunks > (long long)nkeep * kGroups)
    return (int)cudaErrorInvalidValue;
  unsigned* w = static_cast<unsigned*>(wit);
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return (int)launch_all<true>(q, x, mask, pks, keep, occ, w, tau, reg_d,
                                 reg_r, cand_d, cand_r, cand_n, out_d, out_p,
                                 out_r, nq, d, n_mask, nkeep, n_chunks, s);
  return (int)launch_all<false>(q, x, mask, pks, keep, occ, w, tau, reg_d,
                                reg_r, cand_d, cand_r, cand_n, out_d, out_p,
                                out_r, nq, d, n_mask, nkeep, n_chunks, s);
}
