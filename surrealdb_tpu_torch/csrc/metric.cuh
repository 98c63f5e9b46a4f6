// Per-pair distance arithmetic shared by the exact distance kernel (K1,
// knn.cu) and the IVF rerank (K3, ivf.cu), so both compute the reference's
// formulas (surrealdb_tpu/ops/distances.py) the same way:
//   euclidean  sqrt(max(|q|^2 + |x|^2 - 2 q.x, 0))
//   cosine     1 - q.x / max(|q|, 1e-30) / max(|x|, 1e-30)
//   pearson    cosine over rows centred on their means
//   manhattan, chebyshev, hamming: sum |q-x|, max |q-x|, count q != x
//   jaccard    1 - sum(min) / max(sum(max), 1e-30)
//   minkowski  (sum |q-x|^p)^(1/p)
// A kernel accumulates with pw_step over the columns (plus the squared
// norms for the dot metrics) and ends with pw_finish. Include after
// <cuda_runtime.h> and <cuda_bf16.h>.
#pragma once

namespace {

enum Metric {
  M_EUCLIDEAN = 0,
  M_COSINE = 1,
  M_MANHATTAN = 2,
  M_CHEBYSHEV = 3,
  M_HAMMING = 4,
  M_JACCARD = 5,
  M_PEARSON = 6,
  M_MINKOWSKI = 7,
};

// metrics computed from a dot product and the two squared norms
template <int METRIC>
__host__ __device__ constexpr bool is_dot_metric() {
  return METRIC == M_EUCLIDEAN || METRIC == M_COSINE || METRIC == M_PEARSON;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// one column of one (query, row) pair into the accumulators
template <int METRIC>
__device__ __forceinline__ void pw_step(float qv, float xv, float p, float& acc, float& acc2) {
  if (is_dot_metric<METRIC>()) {
    acc = fmaf(qv, xv, acc);
  } else if (METRIC == M_MANHATTAN) {
    acc += fabsf(qv - xv);
  } else if (METRIC == M_CHEBYSHEV) {
    acc = fmaxf(acc, fabsf(qv - xv));
  } else if (METRIC == M_HAMMING) {
    acc += (qv != xv) ? 1.f : 0.f;
  } else if (METRIC == M_JACCARD) {
    acc += fminf(qv, xv);
    acc2 += fmaxf(qv, xv);
  } else {  // M_MINKOWSKI
    acc += powf(fabsf(qv - xv), p);
  }
}

// the distance from the accumulators; qss / xss are the squared norms of
// the query and the row (read by the dot metrics only)
template <int METRIC>
__device__ __forceinline__ float pw_finish(float qss, float xss, float acc, float acc2, float p) {
  if (METRIC == M_EUCLIDEAN) return sqrtf(fmaxf(qss + xss - 2.f * acc, 0.f));
  // divide twice: max(.,1e-30)^2 underflows f32 for two zero vectors
  if (METRIC == M_COSINE || METRIC == M_PEARSON)
    return 1.f - acc / fmaxf(sqrtf(qss), 1e-30f) / fmaxf(sqrtf(xss), 1e-30f);
  if (METRIC == M_JACCARD) return 1.f - acc / fmaxf(acc2, 1e-30f);
  if (METRIC == M_MINKOWSKI) return powf(acc, 1.f / p);
  return acc;
}

}  // namespace
