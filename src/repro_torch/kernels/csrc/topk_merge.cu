// Top-k merges of candidate lists: the cross-shard merge of a query batch
// and the single-list merge.
//
// Replaces src/repro/kernels/topk_merge.py:
//   batched_topk_merge (the Pallas kernel _batched_merge_kernel): per query
//     the k smallest of s * kk candidates in (score, id) order; consumed
//     and padded slots both carry (+inf, SENTINEL), so slots past the real
//     candidates come back as (+inf, SENTINEL);
//   topk_merge (the Pallas kernel _topk_merge_kernel): the k smallest of
//     one (s, kk) list, ties broken by flattened position; ids are payload,
//     carried at the width the caller gives (int32 or int64).
//
// What bounds it on Hopper: the launch.  The sharded path merges s = 4
// lists of k = 10 per query (a few hundred bytes a query), so the bytes
// (each candidate read once, each winner written once) take nanoseconds
// and the k rounds of a block-wide min take a few microseconds.
//
// Design.  One block per query (one block for topk_merge).  Round j finds
// the smallest candidate whose key is strictly greater than the key of
// round j-1's winner, where the key is (score, id, position) for the batch
// merge and (score, position) for the single list: positions make the
// order total, so the rounds enumerate the candidates in key order with
// nothing marked consumed and no scratch copy.  A thread scans its strided
// positions, then a warp shuffle and a pass over the warps' winners give
// the block's.  The candidates are staged in dynamic shared memory when
// they fit (the wrapper passes the size it checked against the block's
// opt-in limit); otherwise each round reads them from global memory, where
// the inputs stay in L2.  k has no built-in limit.  NaN sorts after every
// number, as in the other kernels.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// (d, id, pos) lexicographic order; NaN after every number
__device__ __forceinline__ bool key_less(float ad, int ai, long long ap,
                                         float bd, int bi, long long bp) {
  const bool an = isnan(ad), bn = isnan(bd);
  if (an != bn) return bn;
  if (!an && ad != bd) return ad < bd;
  if (ai != bi) return ai < bi;
  return ap < bp;
}

struct Key {
  float d;
  int id;         // 0 for the single-list merge (order by position only)
  long long pos;  // -1: no candidate
};

__device__ __forceinline__ bool better(const Key& a, const Key& b) {
  if (a.pos < 0) return false;
  if (b.pos < 0) return true;
  return key_less(a.d, a.id, a.pos, b.d, b.id, b.pos);
}

__device__ __forceinline__ Key shfl(const Key& k, int src) {
  Key o;
  o.d = __shfl_sync(kFull, k.d, src);
  o.id = __shfl_sync(kFull, k.id, src);
  o.pos = __shfl_sync(kFull, k.pos, src);
  return o;
}

// The block's smallest candidate with key > prev.  Every thread returns it.
template <bool kUseId>
__device__ Key block_next(const float* d, const int* ids, long long c,
                          const Key& prev, Key* warp_s) {
  Key best{INFINITY, 0, -1};
  for (long long i = threadIdx.x; i < c; i += kThreads) {
    const Key cand{d[i], kUseId ? ids[i] : 0, i};
    if (prev.pos >= 0 &&
        !key_less(prev.d, prev.id, prev.pos, cand.d, cand.id, cand.pos))
      continue;
    if (better(cand, best)) best = cand;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = shfl(best, (threadIdx.x & 31) ^ off);
    if (better(o, best)) best = o;
  }
  if ((threadIdx.x & 31) == 0) warp_s[threadIdx.x >> 5] = best;
  __syncthreads();
  Key out = warp_s[0];
  for (int w = 1; w < kWarps; ++w)
    if (better(warp_s[w], out)) out = warp_s[w];
  __syncthreads();    // warp_s is reused by the next round
  return out;
}

template <bool kUseId>
__device__ void stage(const float* d_g, const int* i_g, long long c,
                      bool use_smem, const float** d, const int** ids) {
  extern __shared__ unsigned char smem_raw[];
  if (!use_smem) {
    *d = d_g;
    *ids = i_g;
    return;
  }
  float* d_s = reinterpret_cast<float*>(smem_raw);
  int* i_s = reinterpret_cast<int*>(d_s + c);
  for (long long i = threadIdx.x; i < c; i += kThreads) {
    d_s[i] = d_g[i];
    if (kUseId) i_s[i] = i_g[i];
  }
  __syncthreads();
  *d = d_s;
  *ids = i_s;
}

__global__ void __launch_bounds__(kThreads)
batched_topk_merge_kernel(const float* __restrict__ d_in,
                          const int* __restrict__ i_in,
                          float* __restrict__ out_d, int* __restrict__ out_i,
                          long long c, int k, int use_smem) {
  __shared__ Key warp_s[kWarps];
  const long long qrow = blockIdx.x;
  const float* d;
  const int* ids;
  stage<true>(d_in + qrow * c, i_in + qrow * c, c, use_smem != 0, &d, &ids);
  Key prev{INFINITY, 0, -1};
  for (int j = 0; j < k; ++j) {
    Key w{INFINITY, kSentinel, -1};
    if (prev.pos < c) w = block_next<true>(d, ids, c, prev, warp_s);
    if (threadIdx.x == 0) {
      out_d[qrow * k + j] = w.pos >= 0 ? w.d : INFINITY;
      out_i[qrow * k + j] = w.pos >= 0 ? w.id : kSentinel;
    }
    // exhausted: every later round finds nothing either
    prev = w.pos >= 0 ? w : Key{INFINITY, 0, c};
  }
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ d_in,
                  const IdT* __restrict__ i_in, float* __restrict__ out_d,
                  IdT* __restrict__ out_i, long long c, int k, int use_smem) {
  __shared__ Key warp_s[kWarps];
  const float* d;
  const int* unused;
  stage<false>(d_in, nullptr, c, use_smem != 0, &d, &unused);
  Key prev{INFINITY, 0, -1};
  for (int j = 0; j < k; ++j) {       // the wrapper keeps k <= c
    const Key w = block_next<false>(d, nullptr, c, prev, warp_s);
    if (threadIdx.x == 0) {
      out_d[j] = w.d;
      out_i[j] = i_in[w.pos];
    }
    prev = w;
  }
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// dists (nq, c) fp32 and ids (nq, c) int32, c = s * kk, contiguous; out_d
// (nq, k) fp32, out_i (nq, k) int32.  smem_bytes: 0 to read the candidates
// from global memory, else c * 8, which the caller checked fits a block.
extern "C" int batched_topk_merge_launch(const float* dists, const int* ids,
                                         float* out_d, int* out_i, int nq,
                                         long long c, int k,
                                         long long smem_bytes, void* stream) {
  if (nq == 0 || k == 0) return 0;
  const size_t smem = (size_t)smem_bytes;
  cudaError_t e = allow_smem((const void*)batched_topk_merge_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  batched_topk_merge_kernel<<<nq, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      dists, ids, out_d, out_i, c, k, smem > 0);
  return (int)cudaGetLastError();
}

// dists (c,) fp32 and ids (c,) of id_bytes (4 or 8) each, contiguous;
// out_d (k,) fp32, out_i (k,) of the ids' width; 0 < k <= c.  smem_bytes:
// 0 to read from global memory, else c * 4.
extern "C" int topk_merge_launch(const float* dists, const void* ids,
                                 float* out_d, void* out_i, long long c,
                                 int k, int id_bytes, long long smem_bytes,
                                 void* stream) {
  if (k == 0) return 0;
  const size_t smem = (size_t)smem_bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (id_bytes == 8) {
    e = allow_smem((const void*)topk_merge_kernel<long long>, smem);
    if (e != cudaSuccess) return (int)e;
    topk_merge_kernel<long long><<<1, kThreads, smem, s>>>(
        dists, static_cast<const long long*>(ids), out_d,
        static_cast<long long*>(out_i), c, k, smem > 0);
  } else if (id_bytes == 4) {
    e = allow_smem((const void*)topk_merge_kernel<int>, smem);
    if (e != cudaSuccess) return (int)e;
    topk_merge_kernel<int><<<1, kThreads, smem, s>>>(
        dists, static_cast<const int*>(ids), out_d, static_cast<int*>(out_i),
        c, k, smem > 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
