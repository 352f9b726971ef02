// Dense squared-L2 distance matrix.
//
// Replaces src/repro/kernels/ivf_scan.py::ivf_scan (the Pallas kernel
// _ivf_scan_kernel): out[i, j] = (||q_i||^2 - 2 q_i.x_j) + ||x_j||^2 in
// fp32, the same expansion and evaluation order.  Rows the host pads with
// 1e30 overflow ||x_j||^2 to +inf and come out +inf, as in the reference.
//
// Numerics, the same in both launch paths: q_i.x_j, ||q_i||^2 and
// ||x_j||^2 are each one fmaf chain from 0 over the features in order,
// continued with zero terms up to the next multiple of 16 (kBK), and the
// output is (qn - 2 acc) + xn.  Every output is computed by exactly these
// operations, whatever the shape and whichever path computes it, so a
// distance does not depend on what it is batched with (no fast-math, no
// TF32, no tensor cores).
//
// Its callers hand it two kinds of shape, and the wrapper (ivf_scan.py's
// launch_path) picks a path for each:
//   skinny (nq <= 8: one query padded to 8 rows by ops, IVF centroid and
//     posting-list scoring, memtable and VectorRange distances): bound by
//     the bytes of x.  A 64-thread block owns 64 rows of x; each thread
//     streams its row once through 16-byte loads (64 bytes ahead of the
//     arithmetic) and runs one chain per query (the queries sit in shared
//     memory, read as float4 broadcasts) plus the row's norm, so no FMA is
//     spent on a query row the caller did not pass.
//   wide (k-means assignment at flush, 2048 x 512 at d 128): bound by fp32
//     operations.  A 256-thread block computes a 128 x 64 output tile (8 x
//     4 a thread), 128 tiles at 2048 x 512, one per SM, or a 64 x 64 one
//     (4 x 4) where 128-row tiles would leave a ragged last wave (2,056
//     rows: 136 tiles on 132 SMs); the 16-feature k-slices of both
//     operands arrive through a three-slot cp.async ring (two slices in
//     flight; 16-byte copies, zero-filled past the ragged edges) in
//     row-major shared memory padded to a 20-float stride, which the
//     float4 reads of the product loop take without bank conflicts; each
//     tile row's norm is one thread's chain over the same slices.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 16;         // features per k-slice (and zero padding)

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------- wide

// A wide tile is (16 TM) x (16 kTN) outputs, TM x kTN a thread: TM = 8
// (128-row tiles) or 4 (64-row tiles), the wrapper's choice by shape.
constexpr int kTN = 4;          // x rows a thread
constexpr int kBN = 16 * kTN;   // x rows per tile
constexpr int kLd = kBK + 4;    // shared row stride (floats)
constexpr int kWide = 256;      // 16 x 16 threads; (ty, tx) owns query rows
                                // ty + 16 i (i < TM), x rows tx + 16 j
constexpr int kRing = 3;        // ring slots: two k-slices in flight

// Issue the copies of k-slice k0 of the tile's query rows (slot rows
// 0..kBM-1) and x rows (kBM..kBM+kBN-1); out-of-range elements read 0.
template <int TM, bool VEC>
__device__ __forceinline__ void load_slice(float* st, const float* q,
                                           const float* x, long long m0,
                                           long long n0, int nq, int n,
                                           int d, int k0, int tid) {
  constexpr int kPer = VEC ? 4 : 1;
  constexpr int kBM = 16 * TM;
#pragma unroll
  for (int c = tid; c < (kBM + kBN) * (kBK / kPer); c += kWide) {
    const int r = c / (kBK / kPer);
    const int kc = (c % (kBK / kPer)) * kPer;
    const bool isq = r < kBM;
    const long long g = isq ? m0 + r : n0 + (r - kBM);
    const bool ok = (isq ? g < nq : g < n) && k0 + kc < d;
    const float* base = isq ? q : x;
    const float* src = ok ? base + g * d + k0 + kc : base;
    if (VEC)
      cp_async16(st + r * kLd + kc, src, ok ? 16 : 0);
    else
      cp_async4(st + r * kLd + kc, src, ok ? 4 : 0);
  }
}

template <int TM, bool VEC>
__global__ void __launch_bounds__(kWide, 2)
ivf_scan_wide(const float* __restrict__ q, const float* __restrict__ x,
              float* __restrict__ out, int nq, int n, int d) {
  constexpr int kBM = 16 * TM;  // query rows per tile
  constexpr int kStage = (kBM + kBN) * kLd;   // floats per ring slot
  __shared__ __align__(16) float ring[kRing * kStage];
  __shared__ float qn_s[kBM];
  __shared__ float xn_s[kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * kBM;
  const long long n0 = (long long)blockIdx.x * kBN;
  const int slices = (d + kBK - 1) / kBK;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;                  // row tid's norm (tid < kBM + kBN)

  // one commit group per slice (empty past the last), slice t + 2 in
  // flight while slice t is multiplied
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < slices)
      load_slice<TM, VEC>(ring + t * kStage, q, x, m0, n0, nq, n, d,
                          t * kBK, tid);
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    const int ahead = t + kRing - 1;
    if (ahead < slices)
      load_slice<TM, VEC>(ring + (ahead % kRing) * kStage, q, x, m0, n0,
                          nq, n, d, ahead * kBK, tid);
    cp_async_commit();
    cp_async_wait<kRing - 1>();     // slice t's group has landed
    __syncthreads();
    const float* as = ring + (t % kRing) * kStage;
    const float* bs = as + kBM * kLd;
    if (tid < kBM + kBN) {          // one row's norm a thread
      const float* r = as + tid * kLd;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + kk);
        nrm = fmaf(v.x, v.x, nrm);
        nrm = fmaf(v.y, v.y, nrm);
        nrm = fmaf(v.z, v.z, nrm);
        nrm = fmaf(v.w, v.w, nrm);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[TM], b[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kLd + kk);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kLd + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(lane4(a[i], u), lane4(b[j], u), acc[i][j]);
    }
    __syncthreads();                // the slot is refilled next iteration
  }
  if (tid < kBM)
    qn_s[tid] = nrm;
  else if (tid < kBM + kBN)
    xn_s[tid - kBM] = nrm;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= nq) continue;
    const float qn = qn_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long gn = n0 + tx + 16 * j;
      if (gn < n)
        out[gm * n + gn] = (qn - 2.f * acc[i][j]) + xn_s[tx + 16 * j];
    }
  }
}

// -------------------------------------------------------------- skinny

constexpr int kSkinny = 64;     // x rows (threads) per block
constexpr int kSkinnyQ = 8;     // most queries the skinny path takes

inline int padded_dim(int d) { return (d + kBK - 1) / kBK * kBK; }

inline size_t skinny_smem(int nq, int d) {
  return (size_t)nq * padded_dim(d) * sizeof(float);
}

// 16 features of row xr from k0 (zero past d) as four float4s.
template <bool VEC>
__device__ __forceinline__ void load_row16(float4 (&v)[4],
                                           const float* __restrict__ xr,
                                           int k0, int d) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = k0 + 4 * c;
    if (VEC) {
      v[c] = k < d ? __ldg(reinterpret_cast<const float4*>(xr + k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v[c].x = k < d ? __ldg(xr + k) : 0.f;
      v[c].y = k + 1 < d ? __ldg(xr + k + 1) : 0.f;
      v[c].z = k + 2 < d ? __ldg(xr + k + 2) : 0.f;
      v[c].w = k + 3 < d ? __ldg(xr + k + 3) : 0.f;
    }
  }
}

template <int NQ, bool VEC>
__global__ void __launch_bounds__(kSkinny)
ivf_scan_skinny(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int n, int d) {
  extern __shared__ __align__(16) float qs[];      // [NQ][dpad]
  __shared__ float qn_s[kSkinnyQ];
  const int tid = threadIdx.x;
  const int dpad = (d + kBK - 1) / kBK * kBK;
  for (int i0 = 0; i0 < NQ * dpad; i0 += 8 * kSkinny) {   // 8 loads in flight
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kSkinny + tid;
      const int r = i / dpad, k = i - r * dpad;
      v[u] = (i < NQ * dpad && k < d) ? __ldg(q + (long long)r * d + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kSkinny + tid;
      if (i < NQ * dpad) qs[i] = v[u];
    }
  }
  __syncthreads();
  if (tid < NQ) {                    // each query's norm: one thread's chain
    const float* r = qs + tid * dpad;
    float s = 0.f;
    for (int k = 0; k < dpad; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(r + k);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
    qn_s[tid] = s;
  }
  const long long row = (long long)blockIdx.x * kSkinny + tid;
  float acc[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) acc[i] = 0.f;
  float xn = 0.f;
  if (row < n) {
    const float* xr = x + row * d;
    float4 cur[4], nxt[4];
    load_row16<VEC>(cur, xr, 0, d);
    for (int k0 = 0; k0 < dpad; k0 += kBK) {
      if (k0 + kBK < dpad) load_row16<VEC>(nxt, xr, k0 + kBK, d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float4 qv[NQ];
#pragma unroll
        for (int i = 0; i < NQ; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + i * dpad + k0 + 4 * c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv = lane4(cur[c], u);
          xn = fmaf(xv, xv, xn);
#pragma unroll
          for (int i = 0; i < NQ; ++i)
            acc[i] = fmaf(lane4(qv[i], u), xv, acc[i]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) cur[c] = nxt[c];
    }
  }
  __syncthreads();
  if (row < n) {
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      out[(long long)i * n + row] = (qn_s[i] - 2.f * acc[i]) + xn;
  }
}

template <int NQ, bool VEC>
cudaError_t launch_skinny(const float* q, const float* x, float* out, int n,
                          int d, cudaStream_t s) {
  const size_t smem = skinny_smem(NQ, d);   // <= 48 KB (the wrapper's rule)
  const unsigned blocks = (unsigned)((n + kSkinny - 1) / kSkinny);
  ivf_scan_skinny<NQ, VEC><<<blocks, kSkinny, smem, s>>>(q, x, out, n, d);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t skinny_by_nq(const float* q, const float* x, float* out, int nq,
                         int n, int d, cudaStream_t s) {
  switch (nq) {
    case 1: return launch_skinny<1, VEC>(q, x, out, n, d, s);
    case 2: return launch_skinny<2, VEC>(q, x, out, n, d, s);
    case 3: return launch_skinny<3, VEC>(q, x, out, n, d, s);
    case 4: return launch_skinny<4, VEC>(q, x, out, n, d, s);
    case 5: return launch_skinny<5, VEC>(q, x, out, n, d, s);
    case 6: return launch_skinny<6, VEC>(q, x, out, n, d, s);
    case 7: return launch_skinny<7, VEC>(q, x, out, n, d, s);
    case 8: return launch_skinny<8, VEC>(q, x, out, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

template <int TM>
cudaError_t launch_wide(const float* q, const float* x, float* out, int nq,
                        int n, int d, bool vec, cudaStream_t s) {
  const dim3 grid((n + kBN - 1) / kBN, (nq + 16 * TM - 1) / (16 * TM));
  if (vec)
    ivf_scan_wide<TM, true><<<grid, kWide, 0, s>>>(q, x, out, nq, n, d);
  else
    ivf_scan_wide<TM, false><<<grid, kWide, 0, s>>>(q, x, out, nq, n, d);
  return cudaGetLastError();
}

// q (nq, d), x (n, d), out (nq, n); all fp32, row-major, contiguous.
// path: the wrapper's launch_path, 0 = wide with 128-row tiles, 1 =
// skinny (nq <= 8), 2 = wide with 64-row tiles; skinny_smem_limit the most
// dynamic shared memory the wrapper lets the skinny path take (refused
// above it; at most 48 KB, which needs no opt-in).
extern "C" int ivf_scan_launch(const float* q, const float* x, float* out,
                               int nq, int n, int d, int path,
                               long long skinny_smem_limit, void* stream) {
  if (nq == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (path == 1) {
    if (nq > kSkinnyQ || (long long)skinny_smem(nq, d) > skinny_smem_limit)
      return (int)cudaErrorInvalidValue;
    return (int)(vec ? skinny_by_nq<true>(q, x, out, nq, n, d, s)
                     : skinny_by_nq<false>(q, x, out, nq, n, d, s));
  }
  if (path == 2) return (int)launch_wide<4>(q, x, out, nq, n, d, vec, s);
  if (path == 0) return (int)launch_wide<8>(q, x, out, nq, n, d, vec, s);
  return (int)cudaErrorInvalidValue;
}
