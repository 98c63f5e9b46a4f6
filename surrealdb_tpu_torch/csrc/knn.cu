// Exact kNN kernels for Hopper (sm_90a): pairwise distance (K1) and the
// masked min-k selection (K2), behind a plain C interface loaded with ctypes
// by surrealdb_tpu_torch/ops/_cuda.py.
//
// K1 knn_pairwise replaces surrealdb_tpu/ops/distances.py:pairwise_distance
// (the jitted [Q,D]x[N,D] -> [Q,N] distance program). What bounds it: at the
// main path's shapes (Q <= 64, N = 2^20, D = 768, bf16 corpus) the corpus read
// is 1.5 GB and the work is 2*Q*N*D flops, i.e. Q flops per corpus byte, far
// below the card's ~295 flops/byte ridge, so the bound is the corpus read
// (plus the [Q,N] f32 distances it writes). Design: one block owns 256
// corpus rows (one a thread) and QT in {1, 8, 16} queries; it walks D in
// chunks of 32 columns, staging the row chunk (16-byte loads, upcast to f32)
// and the query chunk (transposed, read as float4 broadcasts) in shared
// memory; each thread keeps its QT sums in registers, in f32 on the CUDA
// cores. Blocks that share a row tile are numbered next to each other, so
// the corpus tile is fetched from HBM once and the other query tiles hit L2.
// The norms the reference's formulas need (euclidean, cosine, pearson) are
// accumulated in the same pass, so the corpus is read once; pearson first
// centres rows with a row-mean pass (knn_row_mean), so it is cosine over
// centred rows, as the reference computes it. Formulas follow the
// reference, not the textbook: euclidean sqrt(max(|q|^2 + |x|^2 - 2 q.x, 0));
// cosine/pearson normalise by max(|.|, 1e-30); jaccard
// 1 - sum(min) / max(sum(max), 1e-30).
//
// K2 knn_select replaces the selection half of
// surrealdb_tpu/ops/distances.py:knn_search (mask as +inf, then
// lax.top_k(-d, k)). What bounds it: it reads the [Q,N] f32 distances K1
// wrote (4 MB a query at N = 2^20). Design: an exact radix select over the
// order-preserving u32 image of the f32 bits (four 8-bit histogram passes
// with warp-aggregated shared atomics) finds the k-th key, one ordered
// compaction keeps every key below it plus the lowest-position ties, and a
// bitonic sort of the k (key << 32 | position) pairs gives lax.top_k's
// order: distance, then lower index. For k <= 256 over a large corpus the
// select runs twice: first on 4096-column chunks, one block each (so the
// whole card reads the row once, and the later passes hit L1), then one
// block a query over the chunks' picks. Chunks are in column order and each
// chunk's picks are sorted, so position order among equal keys is index
// order and the merge keeps the lowest-index ties. Otherwise one block a
// query selects alone, sorting in shared memory while the pairs fit and in
// a global scratch buffer above, so every k in 1..N is served.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "metric.cuh"

namespace {

// ------------------------------------------------------------------ K1

constexpr int PW_THREADS = 256;  // = corpus rows a block, one row a thread
constexpr int DK = 32;           // columns staged a step

// One block: PW_THREADS corpus rows x QT queries; thread r owns row r0 + r
// and all QT queries of the block (QT accumulators in registers). The row
// chunk is staged with 16-byte loads when the corpus allows (`vec`), the
// query chunk is staged transposed so a thread reads four queries' values
// with one 16-byte shared-memory broadcast.
template <int METRIC, typename T, int QT>
__global__ void __launch_bounds__(PW_THREADS)
pairwise_kernel(const float* __restrict__ q, const T* __restrict__ x, int Q,
                long long N, int D, float p, const float* __restrict__ qmean,
                const float* __restrict__ xmean, float* __restrict__ out, int vec) {
  constexpr int TN = PW_THREADS;
  constexpr bool DOT = is_dot_metric<METRIC>();
  constexpr int V = 16 / (int)sizeof(T);  // corpus values in 16 bytes
  __shared__ float xs[TN][DK + 1];  // +1: conflict-free row reads
  __shared__ __align__(16) float qs[DK][QT];
  __shared__ float qnorm[QT];

  const long long nqt = (Q + QT - 1) / QT;
  const long long bid = blockIdx.x;
  const int q0 = (int)(bid % nqt) * QT;  // blocks of one row tile are adjacent:
  const long long r0 = (bid / nqt) * TN;  // the tile is read from HBM once
  const int r = threadIdx.x;
  const long long row = r0 + r;

  float acc[QT];
  float acc2[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    acc[j] = 0.f;
    acc2[j] = 0.f;
  }
  float xss = 0.f;  // sum of squares of this thread's row
  float qss = 0.f;  // sum of squares of query q0 + r (r < QT)

  for (int d0 = 0; d0 < D; d0 += DK) {
    if (vec) {
      for (int e = r; e < TN * (DK / V); e += PW_THREADS) {
        const int rr = e / (DK / V), cc = (e % (DK / V)) * V;
        const long long xr = r0 + rr;
        const int col = d0 + cc;
        float v[V];
        if (xr < N && col < D) {  // D % V == 0: the whole vector is in range
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + xr * D + col));
          const T* t = reinterpret_cast<const T*>(&raw);
          const float m = METRIC == M_PEARSON ? xmean[xr] : 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = to_f(t[j]) - m;
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) xs[rr][cc + j] = v[j];
      }
    } else {
      for (int e = r; e < TN * DK; e += PW_THREADS) {
        const int rr = e / DK, cc = e % DK;
        const long long xr = r0 + rr;
        const int col = d0 + cc;
        float v = 0.f;
        if (xr < N && col < D) {
          v = to_f(x[xr * D + col]);
          if (METRIC == M_PEARSON) v -= xmean[xr];
        }
        xs[rr][cc] = v;
      }
    }
    for (int e = r; e < QT * DK; e += PW_THREADS) {
      const int qq = e / DK, cc = e % DK;
      const int qi = q0 + qq, col = d0 + cc;
      float v = 0.f;
      if (qi < Q && col < D) {
        v = q[(long long)qi * D + col];
        if (METRIC == M_PEARSON) v -= qmean[qi];
      }
      qs[cc][qq] = v;
    }
    __syncthreads();
    if (DOT && r < QT) {
#pragma unroll 8
      for (int c = 0; c < DK; ++c) qss = fmaf(qs[c][r], qs[c][r], qss);
    }
#pragma unroll 4
    for (int c = 0; c < DK; ++c) {
      const float xv = xs[r][c];
      if (DOT) xss = fmaf(xv, xv, xss);
      if constexpr (QT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < QT; j += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(&qs[c][j]);
          pw_step<METRIC>(q4.x, xv, p, acc[j], acc2[j]);
          pw_step<METRIC>(q4.y, xv, p, acc[j + 1], acc2[j + 1]);
          pw_step<METRIC>(q4.z, xv, p, acc[j + 2], acc2[j + 2]);
          pw_step<METRIC>(q4.w, xv, p, acc[j + 3], acc2[j + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < QT; ++j) pw_step<METRIC>(qs[c][j], xv, p, acc[j], acc2[j]);
      }
    }
    __syncthreads();
  }
  if (DOT) {
    if (r < QT) qnorm[r] = qss;
    __syncthreads();
  }
  if (row >= N) return;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int qi = q0 + j;
    if (qi >= Q) continue;
    const float v = pw_finish<METRIC>(qnorm[j], xss, acc[j], acc2[j], p);
    out[(long long)qi * N + row] = v;
  }
}

template <typename T>
__global__ void row_mean_kernel(const T* __restrict__ x, long long N, int D,
                                float* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(x[row * D + c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s / (float)D;
}

template <int M, typename T>
void launch_pairwise(const float* q, const T* x, int Q, long long N, int D,
                     float p, const float* qmean, const float* xmean,
                     float* out, cudaStream_t stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (D % (16 / (int)sizeof(T)) == 0);
  const long long row_tiles = (N + PW_THREADS - 1) / PW_THREADS;
  if (Q == 1) {
    pairwise_kernel<M, T, 1><<<(unsigned)row_tiles, PW_THREADS, 0, stream>>>(
        q, x, Q, N, D, p, qmean, xmean, out, vec);
  } else if (Q <= 8) {
    pairwise_kernel<M, T, 8><<<(unsigned)row_tiles, PW_THREADS, 0, stream>>>(
        q, x, Q, N, D, p, qmean, xmean, out, vec);
  } else {
    pairwise_kernel<M, T, 16><<<(unsigned)(row_tiles * ((Q + 15) / 16)), PW_THREADS, 0, stream>>>(
        q, x, Q, N, D, p, qmean, xmean, out, vec);
  }
}

template <typename T>
int pairwise_dispatch(int metric, const float* q, const T* x, int Q,
                      long long N, int D, float p, const float* qmean,
                      const float* xmean, float* out, cudaStream_t stream) {
  switch (metric) {
    case M_EUCLIDEAN: launch_pairwise<M_EUCLIDEAN, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    case M_COSINE: launch_pairwise<M_COSINE, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    case M_MANHATTAN: launch_pairwise<M_MANHATTAN, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    case M_CHEBYSHEV: launch_pairwise<M_CHEBYSHEV, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    case M_HAMMING: launch_pairwise<M_HAMMING, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    case M_JACCARD: launch_pairwise<M_JACCARD, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    case M_PEARSON: launch_pairwise<M_PEARSON, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    case M_MINKOWSKI: launch_pairwise<M_MINKOWSKI, T>(q, x, Q, N, D, p, qmean, xmean, out, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K2

// pairs sorted in shared memory up to this count (64 KB of u64)
constexpr int SEL_SMEM_PAIRS = 8192;
// two-stage selection: blocks of SEL_CHUNK_THREADS select the k best of
// each SEL_CHUNK columns, then one block a query merges the chunks' picks
constexpr long long SEL_CHUNK = 4096;
constexpr int SEL_CHUNK_THREADS = 256;
constexpr int SEL_MERGE_THREADS = 1024;
constexpr int SEL_CHUNK_MAX_K = 256;
constexpr unsigned INF_KEY = 0xFF800000u;  // key of +inf
constexpr unsigned PAD_KEY = 0xFFFFFFFFu;  // above every float key

__device__ __forceinline__ unsigned f2key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0, as a float compare
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// One block selects the k smallest (key, position) pairs of one chunk of
// one row: block b takes row b / nchunks, columns [c0, c0 + len) with
// c0 = (b % nchunks) * chunk. Column i's key is +inf where mask[i] == 0
// (mask may be null). The chosen position p maps to idxmap[row, c0 + p]
// when idxmap is given, else to the column c0 + p. A chunk shorter than k
// pads with PAD_KEY entries (index -1, distance NaN), which sort after
// every real key and so are never chosen by a merge over >= k real ones.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
select_kernel(const float* __restrict__ dist, long long row_stride,
              const unsigned char* __restrict__ mask, const int* __restrict__ idxmap,
              long long N, long long chunk, int k, float* __restrict__ out_d,
              int* __restrict__ out_i, unsigned long long* cand, long long cand_stride) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ unsigned long long smem_pairs[];
  __shared__ unsigned hist[256];
  __shared__ unsigned warp_tot[WARPS];
  __shared__ unsigned s_prefix, s_need, s_lt, s_tie;

  const long long nchunks = (N + chunk - 1) / chunk;
  const long long row = blockIdx.x / nchunks;
  const long long c0 = (blockIdx.x % nchunks) * chunk;
  const long long len = min(chunk, N - c0);
  const long long span = max(len, (long long)k);
  const float* d = dist + row * row_stride + c0;
  const unsigned char* m = mask == nullptr ? nullptr : mask + c0;
  auto key_at = [&](long long i) -> unsigned {
    if (i >= len) return PAD_KEY;
    return (m != nullptr && !m[i]) ? INF_KEY : f2key(d[i]);
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;

  // ---- radix select: the k-th smallest key, 8 bits a pass
  unsigned prefix = 0u, pmask = 0u, need = (unsigned)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) hist[i] = 0u;
    __syncthreads();
    for (long long base = 0; base < span; base += THREADS) {
      const long long i = base + tid;
      unsigned digit = 256u;
      if (i < span) {
        const unsigned key = key_at(i);
        if ((key & pmask) == prefix) digit = (key >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < 256u && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      unsigned cum = 0u;
      int b = 0;
      for (; b < 255; ++b) {
        const unsigned c = hist[b];
        if (cum + c >= need) break;
        cum += c;
      }
      s_prefix = prefix | ((unsigned)b << shift);
      s_need = need - cum;
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    pmask |= 255u << shift;
  }
  // prefix is now the k-th key; `need` of its ties belong to the top k

  // ---- ordered compaction: keys below the k-th, then the lowest-position ties
  const unsigned kth = prefix;
  const unsigned n_lt = (unsigned)k - need;
  const int n2 = k <= 1 ? 1 : 1 << (32 - __clz(k - 1));
  const bool in_smem = n2 <= SEL_SMEM_PAIRS;
  unsigned long long* buf = in_smem ? smem_pairs : cand + (long long)blockIdx.x * cand_stride;
  if (tid == 0) {
    s_lt = 0u;
    s_tie = 0u;
  }
  __syncthreads();
  for (long long base = 0; base < span; base += THREADS) {
    const long long i = base + tid;
    const unsigned key = i < span ? key_at(i) : PAD_KEY;
    const bool lt = i < span && key < kth;
    const bool tie = i < span && key == kth;
    const unsigned blt = __ballot_sync(0xffffffffu, lt);
    unsigned lt_base = 0u;
    if (lane == 0 && blt) lt_base = atomicAdd(&s_lt, (unsigned)__popc(blt));
    lt_base = __shfl_sync(0xffffffffu, lt_base, 0);
    if (lt) buf[lt_base + __popc(blt & lane_lt)] = ((unsigned long long)key << 32) | (unsigned)i;
    const unsigned taken = s_tie;  // uniform: written by tid 0 before a barrier
    if (taken < need) {
      const unsigned bt = __ballot_sync(0xffffffffu, tie);
      if (lane == 0) warp_tot[warp] = (unsigned)__popc(bt);
      __syncthreads();
      unsigned before = 0u;
      for (int w = 0; w < warp; ++w) before += warp_tot[w];
      if (tie) {
        const unsigned rank = taken + before + __popc(bt & lane_lt);
        if (rank < need) buf[n_lt + rank] = ((unsigned long long)key << 32) | (unsigned)i;
      }
      __syncthreads();
      if (tid == 0) {
        unsigned tot = 0u;
        for (int w = 0; w < WARPS; ++w) tot += warp_tot[w];
        s_tie = taken + tot;
      }
    }
    __syncthreads();
  }

  // ---- bitonic sort of the k pairs by (key, position)
  for (int i = k + tid; i < n2; i += THREADS) buf[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = buf[i], b = buf[j];
          const bool asc = (i & size) == 0;
          if ((a > b) == asc) {
            buf[i] = b;
            buf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const long long o = (long long)blockIdx.x * k;
  for (int i = tid; i < k; i += THREADS) {
    const unsigned long long v = buf[i];
    const long long p = (long long)(v & 0xFFFFFFFFull);
    out_d[o + i] = key2f((unsigned)(v >> 32));
    out_i[o + i] = p >= len ? -1 : idxmap != nullptr ? idxmap[row * row_stride + c0 + p] : (int)(c0 + p);
  }
}

// Elements of each of the two-stage path's intermediate buffers (the
// chunks' picks, [Q, nchunks, k]); 0 when one block a query selects alone
// (k too large for the chunk pass, or too few columns to split).
long long select_mid_elems(int Q, long long N, int k) {
  if (k > SEL_CHUNK_MAX_K || N < 4 * SEL_CHUNK) return 0;
  return (long long)Q * ((N + SEL_CHUNK - 1) / SEL_CHUNK) * k;
}

}  // namespace

extern "C" {

// q [Q,D] f32, x [N,D] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), out [Q,N] f32.
// qmean [Q] / xmean [N] are read only for pearson (from knn_row_mean).
int knn_pairwise(const void* q, const void* x, int x_bf16, int Q, long long N,
                 int D, int metric, float p, const void* qmean,
                 const void* xmean, void* out, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* qm = (const float*)qmean;
  const float* xm = (const float*)xmean;
  float* o = (float*)out;
  if (x_bf16)
    return pairwise_dispatch<__nv_bfloat16>(metric, qf, (const __nv_bfloat16*)x, Q, N, D, p, qm, xm, o, s);
  return pairwise_dispatch<float>(metric, qf, (const float*)x, Q, N, D, p, qm, xm, o, s);
}

// out[r] = mean of row r of x [N,D] (f32 or bf16), one warp a row.
int knn_row_mean(const void* x, int x_bf16, long long N, int D, void* out,
                 void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((N * 32 + 255) / 256);
  if (x_bf16)
    row_mean_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>((const __nv_bfloat16*)x, N, D, (float*)out);
  else
    row_mean_kernel<float><<<blocks, 256, 0, s>>>((const float*)x, N, D, (float*)out);
  return (int)cudaGetLastError();
}

// dist [Q,N] f32, mask [N] u8 (0 = row excluded, read as +inf);
// out_d [Q,k] f32, out_i [Q,k] i32 in (distance, index) order.
// mid_d (f32) / mid_i (i32): knn_select_mid_elems(Q, N, k) elements each,
// the two-stage path's per-chunk picks (null when that is 0).
// cand: [Q, cand_stride] u64 scratch with cand_stride >= next_pow2(k),
// needed only when next_pow2(k) > knn_select_smem_pairs().
int knn_select(const void* dist, const void* mask, int Q, long long N, int k,
               void* out_d, void* out_i, void* mid_d, void* mid_i, void* cand,
               long long cand_stride, void* stream) {
  if (Q <= 0 || N <= 0 || k <= 0 || (long long)k > N) return (int)cudaErrorInvalidValue;
  int n2 = 1;
  while (n2 < k) n2 <<= 1;
  const bool in_smem = n2 <= SEL_SMEM_PAIRS;
  if (!in_smem && (cand == nullptr || cand_stride < n2)) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? (size_t)n2 * sizeof(unsigned long long) : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(select_kernel<SEL_MERGE_THREADS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SEL_SMEM_PAIRS * (int)sizeof(unsigned long long));
  if (e != cudaSuccess) return (int)e;
  const long long mid = select_mid_elems(Q, N, k);
  if (mid == 0) {
    select_kernel<SEL_MERGE_THREADS><<<Q, SEL_MERGE_THREADS, smem, s>>>(
        (const float*)dist, N, (const unsigned char*)mask, nullptr, N, N, k,
        (float*)out_d, (int*)out_i, (unsigned long long*)cand, cand_stride);
    return (int)cudaGetLastError();
  }
  if (mid_d == nullptr || mid_i == nullptr) return (int)cudaErrorInvalidValue;
  const long long nchunks = (N + SEL_CHUNK - 1) / SEL_CHUNK;
  select_kernel<SEL_CHUNK_THREADS><<<(unsigned)(Q * nchunks), SEL_CHUNK_THREADS, smem, s>>>(
      (const float*)dist, N, (const unsigned char*)mask, nullptr, N, SEL_CHUNK, k,
      (float*)mid_d, (int*)mid_i, nullptr, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long m = nchunks * k;  // one merge row a query: the chunks' picks
  select_kernel<SEL_MERGE_THREADS><<<Q, SEL_MERGE_THREADS, smem, s>>>(
      (const float*)mid_d, m, nullptr, (const int*)mid_i, m, m, k,
      (float*)out_d, (int*)out_i, nullptr, 0);
  return (int)cudaGetLastError();
}

long long knn_select_mid_elems(int Q, long long N, int k) { return select_mid_elems(Q, N, k); }

int knn_select_smem_pairs(void) { return SEL_SMEM_PAIRS; }

const char* knn_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

}  // extern "C"
