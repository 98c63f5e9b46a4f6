// Okapi BM25 scoring for Hopper (sm_90a), behind the same plain C interface
// as knn.cu, ivf.cu and graph.cu (one library, loaded with ctypes by
// surrealdb_tpu_torch/ops/_cuda.py).
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
// and the plain PyTorch version agrees to the rounding of log1pf.
//
// What bounds it: bytes. Each candidate reads its tf row (4T bytes) and its
// length and writes its score: 16 bytes at T = 2, 16 MB at N = 2^20, 5 us
// of HBM. At a query's usual N (hundreds to ~10^4) it is bound by its one
// launch. Design: a thread a candidate row, looping over T; the idf values
// are computed once a block into shared memory, IDF_CHUNK terms at a time,
// so any T >= 1 is served. tf is read as f32 or int32 (templated), so an
// integer tf needs no separate cast pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM_THREADS = 256;  // candidate rows a block, one a thread
constexpr int IDF_CHUNK = 256;   // idf values staged in shared memory a step

template <typename TF>
__global__ void __launch_bounds__(BM_THREADS)
bm25_kernel(const TF* __restrict__ tf, const float* __restrict__ df,
            const float* __restrict__ doc_len, long long n, int t, float doc_count,
            float total_len, float k1, float b, float k1p1, float one_minus_b, int negate,
            float* __restrict__ out) {
  __shared__ float idf[IDF_CHUNK];
  const float nd = fmaxf(doc_count, 1.0f);
  const float avg_len = fmaxf(__fdiv_rn(total_len, nd), 1e-6f);
  const long long row = (long long)blockIdx.x * BM_THREADS + threadIdx.x;
  const bool live = row < n;
  float kn = 0.0f;  // k1 * norm of this row
  if (live) {
    const float norm = __fadd_rn(one_minus_b, __fmul_rn(b, __fdiv_rn(doc_len[row], avg_len)));
    kn = __fmul_rn(k1, norm);
  }
  float acc = 0.0f;
  for (int c0 = 0; c0 < t; c0 += IDF_CHUNK) {
    const int cn = min(IDF_CHUNK, t - c0);
    __syncthreads();  // the previous chunk's idf values are no longer read
    for (int j = threadIdx.x; j < cn; j += BM_THREADS) {
      const float d = df[c0 + j];
      idf[j] = log1pf(__fdiv_rn(__fadd_rn(__fsub_rn(nd, d), 0.5f), __fadd_rn(d, 0.5f)));
    }
    __syncthreads();
    if (live) {
      const TF* r = tf + row * t + c0;
      for (int j = 0; j < cn; ++j) {
        const float f = (float)r[j];
        const float s = __fdiv_rn(__fmul_rn(idf[j], __fmul_rn(f, k1p1)), __fadd_rn(f, kn));
        acc = (c0 + j == 0) ? s : __fadd_rn(acc, s);
      }
    }
  }
  if (live) out[row] = negate ? -acc : acc;
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

}  // extern "C"
