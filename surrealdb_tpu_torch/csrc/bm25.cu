// Okapi BM25 scoring for Hopper (sm_90a), behind the same plain C interface
// as knn.cu, ivf.cu and graph.cu (one library, loaded with ctypes by
// surrealdb_tpu_torch/ops/_cuda.py). Two entries share one score function:
//
// K9 bm25_scores replaces surrealdb_tpu/ops/bm25.py bm25_scores (and, with
// `negate` and K2's knn_select after it, bm25_topk): for each candidate
// document i of a query's AND-matched set,
//   score[i] = sum_t idf[t] * (tf[i,t] * (k1 + 1)) / (tf[i,t] + k1 * norm[i]),
//   idf[t]   = log1p((n - df[t] + 0.5) / (df[t] + 0.5)),
//   norm[i]  = 1 - b + b * (len[i] / avg_len),
// with n = max(doc_count, 1) and avg_len = max(total_len / n, 1e-6) in f32.
// The reference's order of operations is kept, each step rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn: no contraction into FMAs), and the T
// terms are added left to right, so two candidates with the same tf row and
// length get bit-identical scores (the engine ranks with a stable argsort)
// and the plain PyTorch version agrees to the rounding of log1pf. Design: a
// thread a candidate row, looping over T; the idf values are computed once
// a block into shared memory, IDF_CHUNK terms at a time, so any T >= 1 is
// served. tf is read as f32 or int32 (templated). What bounds it: bytes
// (16 bytes a candidate at T = 2), at a query's usual N its one launch.
//
// K9 bm25_match_scores replaces the AND-match of surrealdb_tpu/idx/ft_mirror.py
// search (:420) with the scoring after it, over postings that live on the
// card (FtMirror.device_postings: indptr int64, dids int32 ascending within
// a term, tf and document lengths f32). The query's T term ids come rarest
// first (ties in query order), as search orders them; the matches are the
// rarest list's dids found in every other list (numpy searchsorted's first
// equal position, so the reference's tf is read), written in the rarest
// list's ascending order with their scores, and their count, all on the card.
// A match's score is bm25_term summed left to right over the T terms in that
// order, with the same idf and k1 * norm steps as bm25_kernel, so the two
// entries give the same bits for the same tf row. Design (bm25_match_kernel):
// - a block takes a tile of MS_THREADS dids of the rarest list, a thread each;
// - for each other list in turn, two warps find the window of the list that
//   spans the tile's did range (a 32-way search: four dependent loads at
//   10^5 entries), the block stages the window in shared memory, MS_STAGE
//   dids a step with 16-byte loads, and each live thread binary-searches its
//   did there; each posting of a window is read once. A thread whose did is
//   missing drops out, and a tile with no live thread stops;
// - the matches take their ranks in one pass (lookback.cuh: block scan,
//   decoupled look-back over the tiles), and the last block writes the count.
// What bounds it: reading the rarest list and the other lists' windows
// (bytes), a few hundred KB a query; in practice its one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int BM_THREADS = 256;  // candidate rows a block, one a thread
constexpr int IDF_CHUNK = 256;   // idf values staged in shared memory a step

// The score function both entries use, step by step as the reference.
__device__ __forceinline__ float bm25_avg_len(float nd, float total_len) {
  return fmaxf(__fdiv_rn(total_len, nd), 1e-6f);
}

__device__ __forceinline__ float bm25_idf(float nd, float d) {
  return log1pf(__fdiv_rn(__fadd_rn(__fsub_rn(nd, d), 0.5f), __fadd_rn(d, 0.5f)));
}

// k1 * norm of a document of length len
__device__ __forceinline__ float bm25_kn(float len, float avg_len, float k1, float b,
                                         float one_minus_b) {
  return __fmul_rn(k1, __fadd_rn(one_minus_b, __fmul_rn(b, __fdiv_rn(len, avg_len))));
}

// one term's share of a score: idf * (f * (k1 + 1)) / (f + k1 * norm)
__device__ __forceinline__ float bm25_term(float idf, float f, float k1p1, float kn) {
  return __fdiv_rn(__fmul_rn(idf, __fmul_rn(f, k1p1)), __fadd_rn(f, kn));
}

template <typename TF>
__global__ void __launch_bounds__(BM_THREADS)
bm25_kernel(const TF* __restrict__ tf, const float* __restrict__ df,
            const float* __restrict__ doc_len, long long n, int t, float doc_count,
            float total_len, float k1, float b, float k1p1, float one_minus_b, int negate,
            float* __restrict__ out) {
  __shared__ float idf[IDF_CHUNK];
  const float nd = fmaxf(doc_count, 1.0f);
  const float avg_len = bm25_avg_len(nd, total_len);
  const long long row = (long long)blockIdx.x * BM_THREADS + threadIdx.x;
  const bool live = row < n;
  const float kn = live ? bm25_kn(doc_len[row], avg_len, k1, b, one_minus_b) : 0.0f;
  float acc = 0.0f;
  for (int c0 = 0; c0 < t; c0 += IDF_CHUNK) {
    const int cn = min(IDF_CHUNK, t - c0);
    __syncthreads();  // the previous chunk's idf values are no longer read
    for (int j = threadIdx.x; j < cn; j += BM_THREADS) idf[j] = bm25_idf(nd, df[c0 + j]);
    __syncthreads();
    if (live) {
      const TF* r = tf + row * t + c0;
      for (int j = 0; j < cn; ++j) {
        const float s = bm25_term(idf[j], (float)r[j], k1p1, kn);
        acc = (c0 + j == 0) ? s : __fadd_rn(acc, s);
      }
    }
  }
  if (live) out[row] = negate ? -acc : acc;
}

// ------------------------------------------------------------ the match

constexpr int MS_THREADS = 256;  // dids of the rarest list a tile, one a thread
constexpr int MS_STAGE = 2048;   // dids of another list's window staged a step
constexpr int MS_MAX_T = 256;    // distinct query terms a launch

// the query's terms, rarest first, passed by value (2 KB of parameters)
struct MatchTerms {
  int tid[MS_MAX_T];
  float df[MS_MAX_T];
};

// The position in a[lo, hi) of the first element >= key (upper: > key), by
// one warp: each round splits the range into 32 parts and keeps the part
// holding it, so 10^5 entries take four dependent loads. The warp's lanes
// all return it.
__device__ __forceinline__ long long warp_bound(const int* __restrict__ a, long long lo,
                                                long long hi, int key, bool upper) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (long long)(lane + 1) * step - 1;  // the last of part `lane`
    const bool below = p < hi && (upper ? a[p] <= key : a[p] < key);
    const long long k = __popc(__ballot_sync(0xffffffffu, below));
    lo += k * step;
    hi = min(hi, lo + step);
  }
  const long long p = lo + lane;
  const bool below = p < hi && (upper ? a[p] <= key : a[p] < key);
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// stage[0, ...) = a[a0, a0 + 4 nv) for a0 a multiple of 4: nv 16-byte loads
// over the block (the dids array is padded so they stay inside it)
__device__ __forceinline__ void stage_dids(int* stage, const int* __restrict__ a, long long a0,
                                           int nv) {
  const int4* src = reinterpret_cast<const int4*>(a + a0);
  int4* dst = reinterpret_cast<int4*>(stage);
  for (int v = threadIdx.x; v < nv; v += MS_THREADS) dst[v] = __ldg(src + v);
}

// out[0].x = the number of matches; out[1 + r] = (did, score bits) of match
// r in the rarest list's order. state: lookback.cuh's, zero.
__global__ void __launch_bounds__(MS_THREADS)
bm25_match_kernel(const long long* __restrict__ indptr, const int* __restrict__ dids,
                  const float* __restrict__ tfs, const float* __restrict__ doc_len,
                  MatchTerms terms, int t, float doc_count, float total_len, float k1, float b,
                  float k1p1, float one_minus_b, int tiles, unsigned long long* state,
                  int2* __restrict__ out) {
  __shared__ float idf[MS_MAX_T];
  __shared__ __align__(16) int stage[MS_STAGE + 8];
  __shared__ long long win[2];
  __shared__ int span[2];  // the tile's first and last did
  const int tile = lb_tile(state);
  const float nd = fmaxf(doc_count, 1.0f);
  const float avg_len = bm25_avg_len(nd, total_len);
  for (int j = threadIdx.x; j < t; j += MS_THREADS) idf[j] = bm25_idf(nd, terms.df[j]);
  const long long s0 = indptr[terms.tid[0]], n0 = indptr[terms.tid[0] + 1] - s0;
  const long long first = (long long)tile * MS_THREADS, i = first + threadIdx.x;
  bool live = i < n0;
  const int d = live ? dids[s0 + i] : 0;
  const float f0 = live ? tfs[s0 + i] : 0.0f;
  if (threadIdx.x == 0) {
    span[0] = dids[s0 + first];
    span[1] = dids[s0 + min(n0, first + MS_THREADS) - 1];
  }
  __syncthreads();
  float acc = 0.0f, kn = 0.0f;
  for (int j = 1; j < t; ++j) {
    if (__syncthreads_count(live) == 0) break;  // the whole tile is out
    const long long sj = indptr[terms.tid[j]], ej = indptr[terms.tid[j] + 1];
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const long long r = warp_bound(dids, sj, ej, span[warp], warp == 1);
      if ((threadIdx.x & 31) == 0) win[warp] = r;
    }
    __syncthreads();
    const long long lo = win[0], hi = win[1];
    long long pos = -1;
    for (long long c0 = lo; c0 < hi; c0 += MS_STAGE) {
      const int cn = (int)min((long long)MS_STAGE, hi - c0);
      const long long a0 = c0 & ~3ll;  // the staged vectors start 16-byte aligned
      const int sh = (int)(c0 - a0);
      stage_dids(stage, dids, a0, (sh + cn + 3) / 4);
      __syncthreads();
      const int* w = stage + sh;
      if (live && pos < 0 && d >= w[0] && d <= w[cn - 1]) {
        int l = 0, h = cn;  // the first w[l] >= d
        while (l < h) {
          const int m = (l + h) >> 1;
          if (w[m] < d) l = m + 1; else h = m;
        }
        if (w[l] == d) pos = c0 + l;
      }
      __syncthreads();  // the stage is free for the next step
    }
    if (live) {
      if (pos < 0) {
        live = false;
      } else {
        if (j == 1) {
          kn = bm25_kn(doc_len[d], avg_len, k1, b, one_minus_b);
          acc = bm25_term(idf[0], f0, k1p1, kn);
        }
        acc = __fadd_rn(acc, bm25_term(idf[j], tfs[pos], k1p1, kn));
      }
    }
  }
  if (live && t == 1) acc = bm25_term(idf[0], f0, k1p1, bm25_kn(doc_len[d], avg_len, k1, b,
                                                                   one_minus_b));
  unsigned count;
  const unsigned rank = block_scan<MS_THREADS>(live ? 1u : 0u, &count) - (live ? 1u : 0u);
  const unsigned long long before = lb_offset(state, tile, count);
  if (live) out[1 + before + rank] = make_int2(d, __float_as_int(acc));
  lb_finish(state, tiles, reinterpret_cast<unsigned*>(&out[0].x));
}

}  // namespace

extern "C" {

// K9. tf [n, t] row-major, f32 (tf_int = 0) or int32 (tf_int = 1); df [t]
// f32; doc_len [n] f32; out [n] f32 (the negated scores when `negate`).
// k1p1 = k1 + 1 and one_minus_b = 1 - b come rounded from the caller's
// doubles, as the reference's Python scalars reach its f32 arrays. n = 0
// launches nothing.
int bm25_scores(const void* tf, int tf_int, const void* df, const void* doc_len, long long n,
                int t, float doc_count, float total_len, float k1, float b, float k1p1,
                float one_minus_b, int negate, void* out, void* stream) {
  if (n < 0 || t <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((n + BM_THREADS - 1) / BM_THREADS);
  if (tf_int)
    bm25_kernel<int><<<grid, BM_THREADS, 0, s>>>((const int*)tf, (const float*)df,
                                                 (const float*)doc_len, n, t, doc_count,
                                                 total_len, k1, b, k1p1, one_minus_b, negate,
                                                 (float*)out);
  else
    bm25_kernel<float><<<grid, BM_THREADS, 0, s>>>((const float*)tf, (const float*)df,
                                                   (const float*)doc_len, n, t, doc_count,
                                                   total_len, k1, b, k1p1, one_minus_b,
                                                   negate, (float*)out);
  return (int)cudaGetLastError();
}

int bm25_match_max_terms() { return MS_MAX_T; }

// The state entries (unsigned long long) bm25_match_scores needs for a
// rarest list of n0 dids.
long long bm25_match_state_entries(long long n0) { return 2 + (n0 + MS_THREADS - 1) / MS_THREADS; }

// K9, the match. Postings on the card: indptr [terms + 1] int64, dids int32
// (padded by 4 past its last posting), tfs f32, doc_len f32 (one a did).
// tids / df: the query's t terms on the host, rarest first, each list
// non-empty (n0 = the first's length). state: bm25_match_state_entries(n0)
// zeroed entries, left zeroed; out: 1 + n0 int2 on the card. One launch,
// then the count and the first min(count, first) matches are copied into
// `host` (pinned, 1 + first int2) and the stream is synchronised; matches
// past `first` follow in a second copy (host then holds 1 + n0). Returns
// the count, or -(the CUDA error); with no `host`, the launch alone and 0.
long long bm25_match_scores(const void* indptr, const void* dids, const void* tfs,
                            const void* doc_len, const int* tids, const float* df, int t,
                            long long n0, float doc_count, float total_len, float k1, float b,
                            float k1p1, float one_minus_b, void* state, void* out, void* host,
                            long long first, void* stream) {
  if (t <= 0 || t > MS_MAX_T || n0 <= 0 || first < 0) return -(long long)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  MatchTerms terms;
  for (int j = 0; j < t; ++j) {
    terms.tid[j] = tids[j];
    terms.df[j] = df[j];
  }
  const long long tiles = (n0 + MS_THREADS - 1) / MS_THREADS;
  bm25_match_kernel<<<(unsigned)tiles, MS_THREADS, 0, s>>>(
      (const long long*)indptr, (const int*)dids, (const float*)tfs, (const float*)doc_len,
      terms, t, doc_count, total_len, k1, b, k1p1, one_minus_b, (int)tiles,
      (unsigned long long*)state, (int2*)out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return -(long long)e;
  if (host == nullptr) return 0;  // the launch alone (timing): the count stays in out[0]
  const long long head = 1 + (first < n0 ? first : n0);
  if ((e = cudaMemcpyAsync(host, out, (size_t)head * sizeof(int2), cudaMemcpyDeviceToHost, s)) !=
          cudaSuccess ||
      (e = cudaStreamSynchronize(s)) != cudaSuccess)
    return -(long long)e;
  const long long count = ((const int2*)host)[0].x;
  if (count + 1 > head) {
    if ((e = cudaMemcpyAsync((int2*)host + head, (const int2*)out + head,
                             (size_t)(count + 1 - head) * sizeof(int2), cudaMemcpyDeviceToHost,
                             s)) != cudaSuccess ||
        (e = cudaStreamSynchronize(s)) != cudaSuccess)
      return -(long long)e;
  }
  return count;
}

}  // extern "C"
