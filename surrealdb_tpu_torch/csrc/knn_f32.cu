// The exact kNN's streaming tier over f32 rows (K1 and K2, knn.cuh),
// instantiated in a source of its own so that nvcc builds it beside knn.cu's
// bf16 kernels. On the main path f32 rows are only the IVF probe's
// centroids.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "metric.cuh"
#include "mma.cuh"
#include "rowstream.cuh"
#include "knn.cuh"

int knn_stream_f32(bool fused, int metric, const KnnPlan& pl, const float* q, const float* x,
                   int Q, long long N, int D, float p, const float* qmean, const float* xmean,
                   const unsigned char* mask, int k, float* out, unsigned char* scratch,
                   cudaStream_t s) {
  return stream_dispatch<float>(fused, metric, pl, q, x, Q, N, D, p, qmean, xmean, mask, k, out,
                                scratch, s);
}
