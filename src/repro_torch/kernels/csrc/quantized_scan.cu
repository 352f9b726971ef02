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
// which would let the compiler reassociate it).  A row whose ADC is NaN
// never enters the answer: every filter below keeps adc <= tau only, as
// the TPU kernel's running list, which starts with KMAX empty slots that
// order before NaN, never takes one.  (The TPU kernel's one-hot
// contraction also makes a NaN LUT entry NaN for every row of its query,
// NaN * 0 being NaN; this file sums only the entries a row's codes pick.
// ref.quantized_topk_ref, one sort over every kept row, returns NaN rows
// after the empty slots of the unadmitted ones.)
//
// What bounds it on Hopper: bytes (~16 MB of codes and ~16 MB of bitmap at
// the main path's 8 queries x 2 M rows, m = 8) and, above them, the
// shared-memory LUT gathers, whose random codes conflict in banks.  The
// earlier design (a register top-128 list per 8-block chunk and query,
// then one warp per query merging 512 chunk lists) spent its time, as
// measured on the card (PERF.md), on the lists' serialized inserts (14 %
// of all candidates: every list started empty) and on the merge walking
// its lists one after another.  This one keeps almost every candidate
// away from any list, in four launches:
//   witness: grid (query tiles of 8, chunks of kept blocks).  Each block
//           computes the ADC of a sample (32 rows of each of the chunk's
//           first 16 kept blocks) from the LUTs in global memory and
//           publishes, per query, its 2 smallest admitted values as
//           order-preserving keys; it also writes its share of the tile's
//           LUTs in the scan's shared-memory layout.
//   threshold (topk_threshold, scan_select.cuh, shared with the fused
//           scan): one warp per query: tau >= the 128th smallest witness
//           (a binary search over keys), +inf with fewer than 128.  128
//           distinct admitted rows have adc <= tau, so a row with adc >
//           tau cannot be among the 128 best, while a row with adc == tau
//           still can (by pk): the filter below is adc <= tau.
//   scan:   grid (query tiles, chunks), 3 blocks an SM at m = 8, no block
//           barrier in the loop.  The tile's LUTs sit in shared memory as
//           [j][code][query] (one 16-byte cp.async copy), so a row's 8
//           lookups for a j are two float4 reads; each warp streams 32 rows
//           of every 256-row slice, its codes through a two-slot cp.async
//           ring and its bitmap bytes one slice ahead in registers.  A row
//           with adc <= tau goes to its query's region of the chunk (128
//           slots); if more arrive, that query's warp rescans the chunk
//           through a register top-128 list (topk_list.cuh).  Each region
//           is then appended to the query's candidate list.
//   select (topk_select, scan_select.cuh): one block per query: a K at
//           or just above the 128th smallest candidate ADC (a binary
//           search), then a bitonic sort of the candidates with adc <= K
//           by the exact (adc, pk, row) key, pks fetched here (past 2,048
//           of them: all, 2,048 at a time).
// The candidates hold every row of the true top-128 (the filter drops none
// of them, and each is among its chunk's 128 best), so the result is the
// earlier kernel's bit for bit.  With fewer than 128 witnesses tau is +inf
// and every chunk with more than 128 admitted rows takes the rescan: the
// earlier kernel's list behaviour, still exact.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_select.cuh"
#include "topk_list.cuh"

namespace {

constexpr int kBlockQ = 8;      // queries per tile (BLOCK_Q)
constexpr int kSlice = 256;     // rows per scan slice: one per thread
constexpr int kThreads = 256;   // 8 warps, 32 rows of a slice each
constexpr int kWarps = kThreads / 32;
constexpr int kCodes = 256;     // codewords per subquantizer
constexpr int kWit = 2;         // witnesses per (chunk, query)
constexpr int kSampleRows = 32;     // sampled rows of a kept block
constexpr int kSampleBlocks = 16;   // kept blocks sampled per chunk
constexpr int kSample = kSampleRows * kSampleBlocks;   // 2 rows a thread
constexpr int kMaxChunks = 512;
static_assert(kMaxChunks * kWit <= kMaxWitnesses, "topk_threshold's "
              "witness registers");

// Dynamic shared memory of a scan block: the tile's LUTs, each warp's
// two-slot ring of its 32 rows' codes, and per query a candidate count
// and an overflow flag.  The wrapper states the same sum
// (quantized_scan.py's smem_bytes), refuses an m whose need exceeds the
// card's per-block limit, and hands its sum to the launcher, which
// refuses it unless it equals this one.
inline size_t smem_bytes(int m) {
  return (size_t)kBlockQ * m * kCodes * sizeof(float)        // lut_s
         + (size_t)kWarps * 2 * 32 * m                       // code rings
         + (size_t)2 * kBlockQ * sizeof(int);                // counts, flags
}

// Where lut[q, j, code] sits in shared memory: entry jc = j * 256 + code
// holds the 8 queries' values in 32 bytes, its two float4 halves swapped
// when bit 2 of the code is set, so that the first float4 reads of a warp
// spread over all 8 16-byte bank groups instead of 4.
__device__ __forceinline__ int lut_pos(int jc, int q) {
  return jc * kBlockQ + ((((q >> 2) ^ (jc >> 2)) & 1) << 2) + (q & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The tile's LUTs, already laid out at lut_pos in global memory (8 * m *
// 256 floats, 16-byte aligned), into shared memory: 16-byte cp.async
// copies, all in flight at once.
__device__ __forceinline__ void stage_lut(float* lut_s,
                                          const float* __restrict__ lut_g,
                                          int m, int tid) {
  const int n4 = kBlockQ * m * kCodes / 4;
  for (int i = tid; i < n4; i += kThreads)
    cp_async16(lut_s + 4 * i, lut_g + 4 * i);
  cp_async_commit();
  cp_async_wait<0>();
}

// One row's codes and admit bits: the codes of M in {4, 8, 16} in one
// vector load (M = 0: any m, read byte by byte in adc8), bit q of ok set
// when the mask admits the row for query q0 + q.
struct RowIn {
  uint32_t cw[4];
  uint32_t ok;
};

__device__ __forceinline__ uint32_t load_ok(const uint8_t* __restrict__ mask,
                                            long long prow, long long n_mask,
                                            long long q0) {
  uint32_t ok = 0;
  if (prow < n_mask) {
#pragma unroll
    for (int q = 0; q < kBlockQ; ++q)
      ok |= (__ldg(mask + (q0 + q) * n_mask + prow) != 0 ? 1u : 0u) << q;
  }
  return ok;
}

template <int M>
__device__ __forceinline__ void load_row(RowIn& r,
                                         const uint8_t* __restrict__ codes,
                                         const uint8_t* __restrict__ mask,
                                         long long prow, long long n_mask,
                                         long long q0) {
  if (M == 4) {
    r.cw[0] = __ldg(reinterpret_cast<const uint32_t*>(codes) + prow);
  } else if (M == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(codes) + prow);
    r.cw[0] = v.x;
    r.cw[1] = v.y;
  } else if (M == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes) + prow);
    r.cw[0] = v.x;
    r.cw[1] = v.y;
    r.cw[2] = v.z;
    r.cw[3] = v.w;
  }
  r.ok = load_ok(mask, prow, n_mask, q0);
}

// acc[q] = sum_j lut[q, j, code_j] over j in order, from 0 (__fadd_rn).
template <int M>
__device__ __forceinline__ void adc8(const float* lut_s, const RowIn& r,
                                     const uint8_t* crow, int m,
                                     float (&acc)[kBlockQ]) {
#pragma unroll
  for (int q = 0; q < kBlockQ; ++q) acc[q] = 0.f;
  const int mm = M ? M : m;
#pragma unroll
  for (int j = 0; j < mm; ++j) {
    const int c = M ? (int)((r.cw[j >> 2] >> (8 * (j & 3))) & 0xffu)
                    : (int)crow[j];
    const float* e = lut_s + (j * kCodes + c) * kBlockQ;
    const int sw = (c >> 2) & 1;      // lut_pos's half swap
    const float4 a = *reinterpret_cast<const float4*>(e + 4 * sw);
    const float4 b = *reinterpret_cast<const float4*>(e + 4 * (sw ^ 1));
    acc[0] = __fadd_rn(acc[0], a.x);
    acc[1] = __fadd_rn(acc[1], a.y);
    acc[2] = __fadd_rn(acc[2], a.z);
    acc[3] = __fadd_rn(acc[3], a.w);
    acc[4] = __fadd_rn(acc[4], b.x);
    acc[5] = __fadd_rn(acc[5], b.y);
    acc[6] = __fadd_rn(acc[6], b.z);
    acc[7] = __fadd_rn(acc[7], b.w);
  }
}

// acc[q] as adc8 sums it, reading the tile's row-major LUTs (8 x m*256)
// from global memory.
template <int M>
__device__ __forceinline__ void adc8_global(const float* __restrict__ lut_t,
                                            const RowIn& r,
                                            const uint8_t* __restrict__ crow,
                                            int m, float (&acc)[kBlockQ]) {
#pragma unroll
  for (int q = 0; q < kBlockQ; ++q) acc[q] = 0.f;
  const int mm = M ? M : m;
  const long long w = (long long)m * kCodes;
#pragma unroll
  for (int j = 0; j < mm; ++j) {
    const int c = M ? (int)((r.cw[j >> 2] >> (8 * (j & 3))) & 0xffu)
                    : (int)__ldg(crow + j);
#pragma unroll
    for (int q = 0; q < kBlockQ; ++q)
      acc[q] = __fadd_rn(acc[q], __ldg(lut_t + q * w + j * kCodes + c));
  }
}

// ------------------------------------------------------------- witness

// Also writes the tile's share of the LUTs at lut_pos into lut_g (the
// chunks of a tile split its m * 256 entries), for the scan's copy, and
// zeroes the tile's candidate counts.
template <int M>
__global__ void __launch_bounds__(kThreads)
qscan_witness(const float* __restrict__ lut,
              const uint8_t* __restrict__ codes,
              const uint8_t* __restrict__ mask, const int* __restrict__ keep,
              unsigned* __restrict__ wit, float* __restrict__ lut_g,
              int* __restrict__ cand_n, int m, long long n_mask, int nkeep,
              int per, int n_chunks) {
  __shared__ unsigned key_s[kBlockQ * kSample];
  const int qt = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = (long long)qt * kBlockQ;
  if (chunk == 0 && tid < kBlockQ) cand_n[q0 + tid] = 0;
  const int w = m * kCodes;
  const float* lut_t = lut + q0 * w;
  {
    const int per_jc = (w + n_chunks - 1) / n_chunks;
    const int jc0 = chunk * per_jc, njc = min(per_jc, w - jc0);
    float* g = lut_g + (long long)qt * kBlockQ * w;
    for (int t = tid; t < kBlockQ * njc; t += kThreads) {
      const int q = t % kBlockQ, jc = jc0 + t / kBlockQ;
      g[lut_pos(jc, q)] = __ldg(lut_t + (long long)q * w + jc);
    }
  }

  const int b_lo = chunk * per;
  const int nb = min(min(per, kSampleBlocks), nkeep - b_lo);
  for (int s = tid; s < kSample; s += kThreads) {
    const int bi = s / kSampleRows;
    unsigned key[kBlockQ];
#pragma unroll
    for (int q = 0; q < kBlockQ; ++q) key[q] = kNone;
    if (bi < nb) {
      const long long prow =
          (long long)keep[b_lo + bi] * kBlockN + s % kSampleRows;
      RowIn r;
      load_row<M>(r, codes, mask, prow, n_mask, q0);
      float acc[kBlockQ];
      adc8_global<M>(lut_t, r, codes + prow * m, m, acc);
#pragma unroll
      for (int q = 0; q < kBlockQ; ++q)
        if (((r.ok >> q) & 1u) && !isnan(acc[q])) key[q] = ord_key(acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kBlockQ; ++q) key_s[q * kSample + s] = key[q];
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

// The first slice index in [s, end) whose kept block the tile occupies.
__device__ __forceinline__ int next_slice(const int* __restrict__ occ_t,
                                          int s, int end) {
  while (s < end && occ_t[s >> 1] == 0) s = (s | 1) + 1;
  return s;
}

// A warp's 32 rows of codes from row0 (32 m bytes; 16-byte aligned, as
// the codes are and 32 m is a multiple of 16) into its ring slot.
__device__ __forceinline__ void ring_load(uint8_t* slot,
                                          const uint8_t* __restrict__ codes,
                                          long long row0, int m, int lane) {
  const uint8_t* src = codes + row0 * m;
  for (int c = lane; c < 2 * m; c += 32)
    cp_async16(slot + 16 * c, src + 16 * c);
}

template <int M>
__device__ __forceinline__ void ring_codes(RowIn& r, const uint8_t* crow) {
  if (M == 4) {
    r.cw[0] = *reinterpret_cast<const uint32_t*>(crow);
  } else if (M == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(crow);
    r.cw[0] = v.x;
    r.cw[1] = v.y;
  } else if (M == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(crow);
    r.cw[0] = v.x;
    r.cw[1] = v.y;
    r.cw[2] = v.z;
    r.cw[3] = v.w;
  }
}

// Query q's candidates of the chunk again, by one warp, through a
// register top-128 list (pks fetched for the rows that reach it): the
// chunk's kK best among rows with adc <= t.  Its entries go to the
// region at reg; returns their count.
__device__ int rescan(const float* lut_s, const uint8_t* __restrict__ codes,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ pks,
                      const int* __restrict__ keep,
                      const int* __restrict__ occ_t, int q, long long q0,
                      float t, int begin, int end, int m, long long n_mask,
                      float* __restrict__ reg_d, int* __restrict__ reg_r,
                      long long reg, int lane) {
  WarpList L;
  list_init(L);
  float wd = INFINITY;
  int wp = kSentinel, wr = kSentinel;
  const long long mrow = (q0 + q) * n_mask;
  for (int s = next_slice(occ_t, begin, end); s < end;
       s = next_slice(occ_t, s + 1, end)) {
    const long long base =
        (long long)keep[s >> 1] * kBlockN + (s & 1) * kSlice;
    for (int h = 0; h < kSlice / 32; ++h) {
      const int rin = h * 32 + lane;
      const long long prow = base + rin;
      const bool ok = prow < n_mask && mask[mrow + prow] != 0;
      float acc = 0.f;
      for (int j = 0; j < m; ++j)
        acc = __fadd_rn(acc, lut_s[lut_pos(j * kCodes + codes[prow * m + j],
                                           q)]);
      const float lim = wr != kSentinel ? fminf(t, wd) : t;
      const bool pass = ok && acc <= lim;
      const int kpos = (s >> 1) * kBlockN + (s & 1) * kSlice + rin;
      offer(L, pass, acc, pass ? pk_of(pks, keep, kpos) : kSentinel, kpos,
            lane, wd, wp, wr);
    }
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

// Each warp streams its 32 rows of every slice of the chunk with no block
// barrier: the codes through its ring (the next slice's copy in flight),
// the bitmap bytes one slice ahead in registers.  A candidate with
// adc <= tau is written to its query's region of the chunk (kK slots, a
// shared count); one past kK flags the query, and once the chunk is done
// its warp redoes it by rescan.  Each region then goes to its query's
// candidate list (cand_n counts it).
template <int M>
__global__ void __launch_bounds__(kThreads, 3)
qscan_scan(const float* __restrict__ lut_g,
           const uint8_t* __restrict__ codes,
           const uint8_t* __restrict__ mask, const int* __restrict__ pks,
           const int* __restrict__ keep, const int* __restrict__ occ,
           const float* __restrict__ tau, float* __restrict__ reg_d,
           int* __restrict__ reg_r, float* __restrict__ cand_d,
           int* __restrict__ cand_r, int* __restrict__ cand_n, int m,
           long long n_mask, int nkeep, int per, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* lut_s = smem;                                   // [m*256][8]
  uint8_t* ring = reinterpret_cast<uint8_t*>(lut_s + kBlockQ * m * kCodes);
  int* cnt_s = reinterpret_cast<int*>(ring + kWarps * 2 * 32 * m);
  int* ovf_s = cnt_s + kBlockQ;

  const int qt = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = (long long)qt * kBlockQ;
  const long long cap = (long long)n_chunks * kK;
  stage_lut(lut_s, lut_g + q0 * m * kCodes, m, tid);
  if (tid < kBlockQ) {
    cnt_s[tid] = 0;
    ovf_s[tid] = 0;
  }
  float thr[kBlockQ];
#pragma unroll
  for (int q = 0; q < kBlockQ; ++q) thr[q] = __ldg(tau + q0 + q);
  __syncthreads();

  const int* occ_t = occ + (long long)qt * nkeep;
  const int begin = 2 * chunk * per;
  const int end = 2 * min(nkeep, chunk * per + per);
  uint8_t* slot0 = ring + warp * 2 * 32 * m;
  int s = next_slice(occ_t, begin, end);
  uint32_t ok = 0;
  if (s < end) {
    const long long r0 = (long long)keep[s >> 1] * kBlockN
                         + (s & 1) * kSlice + warp * 32;
    ring_load(slot0, codes, r0, m, lane);
    ok = load_ok(mask, r0 + lane, n_mask, q0);
  }
  cp_async_commit();
  int st = 0;
  while (s < end) {                 // s is the same on every thread
    const int sn = next_slice(occ_t, s + 1, end);
    uint32_t ok_n = 0;
    if (sn < end) {                 // the next slice, in flight
      const long long r0 = (long long)keep[sn >> 1] * kBlockN
                           + (sn & 1) * kSlice + warp * 32;
      ring_load(slot0 + (st ^ 1) * 32 * m, codes, r0, m, lane);
      ok_n = load_ok(mask, r0 + lane, n_mask, q0);
    }
    cp_async_commit();
    cp_async_wait<1>();             // this slice's codes have landed
    __syncwarp();
    const uint8_t* crow = slot0 + st * 32 * m + lane * m;
    RowIn r;
    r.ok = ok;
    ring_codes<M>(r, crow);
    float acc[kBlockQ];
    adc8<M>(lut_s, r, crow, m, acc);
    const int kpos = (s >> 1) * kBlockN + (s & 1) * kSlice + warp * 32 + lane;
#pragma unroll
    for (int q = 0; q < kBlockQ; ++q) {
      const bool pass = ((ok >> q) & 1u) && acc[q] <= thr[q];
      const unsigned b = __ballot_sync(kFull, pass);
      if (b) {                      // warp-aggregated append to region q
        int at = 0;
        if (lane == __ffs(b) - 1) at = atomicAdd(&cnt_s[q], __popc(b));
        at = __shfl_sync(kFull, at, __ffs(b) - 1)
             + __popc(b & ((1u << lane) - 1u));
        if (pass) {
          if (at < kK) {
            const long long reg = (q0 + q) * cap + (long long)chunk * kK;
            reg_d[reg + at] = acc[q];
            reg_r[reg + at] = kpos;
          } else {
            ovf_s[q] = 1;
          }
        }
      }
    }
    __syncwarp();                   // slot st is refilled next iteration
    st ^= 1;
    ok = ok_n;
    s = sn;
  }
  cp_async_wait<0>();
  __syncthreads();
  // warp w settles query w: its region as filled or, past kK, refilled
  // by a rescan; then appended to the query's candidate list
  const long long qi = q0 + warp;
  const long long reg = qi * cap + (long long)chunk * kK;
  int n = min(cnt_s[warp], kK);
  if (ovf_s[warp])
    n = rescan(lut_s, codes, mask, pks, keep, occ_t, warp, q0, thr[warp],
               begin, end, m, n_mask, reg_d, reg_r, reg, lane);
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

template <int M>
cudaError_t launch_all(const float* lut, const uint8_t* codes,
                       const uint8_t* mask, const int* pks, const int* keep,
                       const int* occ, unsigned* wit, float* tau,
                       float* lut_g, float* reg_d, int* reg_r, float* cand_d,
                       int* cand_r, int* cand_n,
                       float* out_d, int* out_p, int* out_r, int nq, int m,
                       long long n_mask, int nkeep, int per, int n_chunks,
                       size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(qscan_scan<M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nq / kBlockQ, n_chunks);
  qscan_witness<M><<<grid, kThreads, 0, s>>>(
      lut, codes, mask, keep, wit, lut_g, cand_n, m, n_mask, nkeep, per,
      n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_threshold<<<(nq + kTauThreads / 32 - 1) / (kTauThreads / 32),
                   kTauThreads, 0, s>>>(wit, tau, nq, n_chunks * kWit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  qscan_scan<M><<<grid, kThreads, smem, s>>>(
      lut_g, codes, mask, pks, keep, occ, tau, reg_d, reg_r, cand_d, cand_r,
      cand_n, m, n_mask, nkeep, per, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_select<<<nq, kSelectThreads, 0, s>>>(cand_d, cand_r, cand_n, pks,
                                            keep, n_chunks, out_d, out_p,
                                            out_r);
  return cudaGetLastError();
}

}  // namespace

// lut (nq, m*256) fp32, 16-byte aligned, with nq a multiple of 8; codes
// (rows, m) uint8 with rows a multiple of 512 covering every kept block;
// mask (nq, n_mask) uint8; pks (rows,) int32; keep (nkeep,) int32 block
// ids; occ (nq / 8, nkeep) int32; scratch: wit (nq, n_chunks * 2) uint32,
// tau (nq,) fp32, lut_g (nq, m*256) fp32 16-byte aligned, reg_d/reg_r and
// cand_d/cand_r (nq, n_chunks * 128), cand_n (nq,) int32; codes 16-byte
// aligned; out_* (nq, 128); smem_wrapper the wrapper's
// shared-memory sum for this m.  Chunk c holds kept blocks [c * per,
// (c + 1) * per); n_chunks <= 512.
extern "C" int quantized_scan_topk_launch(
    const float* lut, const uint8_t* codes, const uint8_t* mask,
    const int* pks, const int* keep, const int* occ, void* wit, float* tau,
    float* lut_g, float* reg_d, int* reg_r, float* cand_d, int* cand_r,
    int* cand_n, float* out_d, int* out_p, int* out_r, int nq, int m,
    long long n_mask, int nkeep, int per, int n_chunks,
    long long smem_wrapper, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(m);
  if (smem_wrapper != (long long)smem) return (int)cudaErrorInvalidValue;
  if (n_chunks > kMaxChunks || (long long)per * n_chunks < nkeep)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(lut_g) % 16 != 0
      || reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  unsigned* w = static_cast<unsigned*>(wit);
#define QSCAN_LAUNCH(MM)                                                  \
  return (int)launch_all<MM>(lut, codes, mask, pks, keep, occ, w, tau,    \
                             lut_g, reg_d, reg_r, cand_d, cand_r, cand_n, \
                             out_d, out_p, out_r, nq, m, n_mask, nkeep,   \
                             per, n_chunks, smem, s)
  if (m == 8) QSCAN_LAUNCH(8);
  if (m == 4) QSCAN_LAUNCH(4);
  if (m == 16) QSCAN_LAUNCH(16);
  QSCAN_LAUNCH(0);
#undef QSCAN_LAUNCH
}
