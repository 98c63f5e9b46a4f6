// The exact kNN's streaming tier over bf16 rows (K1 and K2, knn.cuh) for
// euclidean, cosine, manhattan and chebyshev: half of its metrics, instantiated in a source
// of its own so that nvcc builds the two halves beside knn.cu and
// knn_f32.cu. The main path's corpus rows are bf16 at Q <= 8.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "metric.cuh"
#include "mma.cuh"
#include "rowstream.cuh"
#include "knn.cuh"

int knn_stream_bf16_lo(bool fused, int metric, const KnnPlan& pl, const float* q,
                       const __nv_bfloat16* x, int Q, long long N, int D, float p,
                       const float* qmean, const float* xmean, const unsigned char* mask, int k,
                       float* out, unsigned char* scratch, cudaStream_t s) {
  return stream_dispatch<__nv_bfloat16, M_EUCLIDEAN, KNN_BF16_LO_LAST>(fused, metric, pl, q, x, Q, N, D, p, qmean,
                                                   xmean, mask, k, out, scratch, s);
}
