// Mesh kernels for Hopper (sm_90a), behind the same plain C interface as
// knn.cu (one library, loaded with ctypes by surrealdb_tpu_torch/ops/_cuda.py).
// They serve surrealdb_tpu_torch/parallel/mesh.py, the port of
// surrealdb_tpu/parallel/mesh.py, whose shard_map programs run one launch
// sequence a shard here: a shard is a view of one tensor when the shards
// share a card, a copy on its own card otherwise.
//
// mesh_topk_merge is the merge of K11 sharded_knn, K12 sharded_knn_2d and
// K13 _ivf_searcher: after the all-gather of every shard's kk candidates
// into d_all / i_all [Q, S*kk] (shard order), lax.top_k(-d_all, k_out) and
// the take of the ids, with the id arithmetic done here: a candidate at
// position p belongs to shard p / kk, and its global id is its local id +
// shard * shard_rows (K11, K12: always, so a shard's +inf picks keep their
// ids, as the reference returns them; K13: only where the distance is
// finite, else -1). Order is lax.top_k's: distance, then the lower
// position. What bounds it: nothing on this card (S*kk <= 512 candidates a
// query at the mesh path's shapes, a few KB); its time is the launch.
// Design: one block a query; each thread ranks its candidates against all
// of the query's candidates (the count of smaller keys plus equal keys at
// lower positions), O((S*kk)^2) compares, staged in shared memory when
// they fit; the rank is the output slot, so no sort and no second pass.
//
// mesh_partial_sqdist is K12's per-shard distance step: for one (row shard,
// feature shard) block of the corpus and the matching feature slice of the
// queries, the reference's |q|^2 + |x|^2 - 2 q.x over the slice in f32 (its
// formula, not K1's), added into a [Q, rows] f32 accumulator: the first
// feature shard writes, the rest add, in feature-shard order, which is the
// psum over `model`; `finish` on the last applies sqrt(max(d2, 0)) and sets
// masked rows to +inf. What bounds it: reading the corpus slice (bytes;
// 2*Q FMAs a bf16 element, far below the ridge). Design: one block owns 256
// rows (a thread a row) and 8 queries; it walks the slice's columns 32 at a
// time, staging the rows (any row stride: a feature shard is a strided view)
// and the query chunk in shared memory; blocks of one row tile are adjacent,
// so the tile is read from HBM once and the other query tiles hit L2.
//
// mesh_frontier_hop is K14 sharded_frontier_hop's per-shard gather: for
// each (frontier row f, offset o < max_degree), start = indptr[fr],
// deg = indptr[fr + 1] - start, valid = o < deg && mask[f], and the
// neighbour indices[clip(start + o, 0, E - 1)], with JAX's gather index
// rule for fr and fr + 1 (a negative index wraps once, then clamps into
// [0, V]) so padded frontier entries read what the reference reads. One
// thread an output. Bound: the bytes it touches (launch-bound here).
//
// mesh_dedup_frontier is K15 dedup_frontier: marks = zeros(n_nodes + 1),
// marks[where(mask, nodes, n_nodes)] = 1 with JAX's scatter rule (a negative
// index wraps once; one still out of range is dropped), marks[n_nodes] = 0,
// then the ascending ids of the marked nodes, size F, padded with n_nodes,
// and their mask (id < n_nodes): a scatter kernel, then the ordered
// compaction of compact.cuh over the n_nodes marks. Bound: reading the
// frontier and writing F ids (bytes); in practice the compaction's scan of
// the n_nodes marks and the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "compact.cuh"

namespace {

// ------------------------------------------------------------------ merge

constexpr int MG_THREADS = 256;
constexpr int MG_SMEM_KEYS = 12288;  // 48 KB of keys: static shared-memory limit

// the order-preserving u32 image of an f32 (-0.0 ties with +0.0)
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(MG_THREADS)
topk_merge_kernel(const float* __restrict__ d_all, const int* __restrict__ i_all, int M, int kk,
                  long long shard_rows, int k_out, int finite_only, float* __restrict__ out_d,
                  int* __restrict__ out_i) {
  extern __shared__ unsigned keys_smem[];
  const long long row = blockIdx.x;
  const float* d = d_all + row * M;
  const int* ids = i_all + row * M;
  const bool staged = M <= MG_SMEM_KEYS;
  if (staged)
    for (int j = threadIdx.x; j < M; j += MG_THREADS) keys_smem[j] = order_key(d[j]);
  __syncthreads();
  for (int p = threadIdx.x; p < M; p += MG_THREADS) {
    const unsigned kp = staged ? keys_smem[p] : order_key(d[p]);
    int rank = 0;
    for (int j = 0; j < M && rank < k_out; ++j) {
      const unsigned kj = staged ? keys_smem[j] : order_key(d[j]);
      rank += (kj < kp) || (kj == kp && j < p);
    }
    if (rank < k_out) {
      const float dv = d[p];
      const long long shard = p / kk;
      const bool finite = dv < __uint_as_float(0x7f800000u);  // below +inf
      const long long gid = (long long)ids[p] + shard * shard_rows;
      out_d[row * k_out + rank] = dv;
      out_i[row * k_out + rank] = (finite_only && !finite) ? -1 : (int)gid;
    }
  }
}

// ------------------------------------------------------------------ K12

constexpr int PS_THREADS = 256;  // rows a block, one a thread
constexpr int PS_QT = 8;         // queries a block
constexpr int PS_DK = 32;        // columns staged a step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(PS_THREADS)
partial_sqdist_kernel(const float* __restrict__ q, long long q_stride, int Q,
                      const T* __restrict__ x, long long x_stride, long long rows, int Dm,
                      float* __restrict__ acc, int first, int finish,
                      const unsigned char* __restrict__ mask) {
  __shared__ float xs[PS_THREADS][PS_DK + 1];  // +1: conflict-free row reads
  __shared__ float qs[PS_DK][PS_QT];
  __shared__ float qq_s[PS_QT];

  const long long nqt = (Q + PS_QT - 1) / PS_QT;
  const int q0 = (int)(blockIdx.x % nqt) * PS_QT;  // blocks of one row tile are adjacent
  const long long r0 = (long long)(blockIdx.x / nqt) * PS_THREADS;
  const int t = threadIdx.x;
  const long long row = r0 + t;

  float dot[PS_QT];
  for (int i = 0; i < PS_QT; ++i) dot[i] = 0.f;
  float xx = 0.f, qq = 0.f;  // qq: thread t < PS_QT sums query q0 + t

  for (int c0 = 0; c0 < Dm; c0 += PS_DK) {
    for (int e = t; e < PS_THREADS * PS_DK; e += PS_THREADS) {
      const int r = e / PS_DK, c = e % PS_DK;
      const long long gr = r0 + r;
      xs[r][c] = (gr < rows && c0 + c < Dm) ? to_f32(x[gr * x_stride + c0 + c]) : 0.f;
    }
    for (int e = t; e < PS_DK * PS_QT; e += PS_THREADS) {
      const int c = e / PS_QT, qi = e % PS_QT;
      qs[c][qi] = (q0 + qi < Q && c0 + c < Dm) ? q[(long long)(q0 + qi) * q_stride + c0 + c] : 0.f;
    }
    __syncthreads();
    if (t < PS_QT)
      for (int c = 0; c < PS_DK; ++c) qq += qs[c][t] * qs[c][t];
    for (int c = 0; c < PS_DK; ++c) {
      const float xv = xs[t][c];
      xx += xv * xv;
#pragma unroll
      for (int i = 0; i < PS_QT; ++i) dot[i] += qs[c][i] * xv;
    }
    __syncthreads();
  }
  if (t < PS_QT) qq_s[t] = qq;
  __syncthreads();
  if (row >= rows) return;
  const bool live = mask == nullptr || mask[row] != 0;
  for (int i = 0; i < PS_QT && q0 + i < Q; ++i) {
    float* a = acc + (long long)(q0 + i) * rows + row;
    float d2 = qq_s[i] + xx - 2.0f * dot[i];
    if (!first) d2 = *a + d2;
    if (finish) d2 = live ? sqrtf(fmaxf(d2, 0.f)) : __uint_as_float(0x7f800000u);
    *a = d2;
  }
}

// ------------------------------------------------------------------ K14

// JAX's gather rule for one index into n entries: a negative index wraps
// once, then the result clamps into [0, n - 1]
__device__ __forceinline__ long long gather_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__global__ void __launch_bounds__(CP_THREADS)
frontier_hop_kernel(const int* __restrict__ indptr, long long V1, const int* __restrict__ indices,
                    long long E, const int* __restrict__ frontier,
                    const unsigned char* __restrict__ fmask, long long F, int max_degree,
                    int* __restrict__ out_nb, unsigned char* __restrict__ out_valid) {
  const long long total = F * max_degree;
  for (long long i = (long long)blockIdx.x * CP_THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * CP_THREADS) {
    const long long f = i / max_degree;
    const int o = (int)(i % max_degree);
    const int fr = frontier[f];
    const int start = indptr[gather_index(fr, V1)];
    // int32 arithmetic wraps as the reference's does
    const int end = indptr[gather_index((int)((unsigned)fr + 1u), V1)];
    const int deg = (int)((unsigned)end - (unsigned)start);
    const int take = (int)((unsigned)start + (unsigned)o);
    const long long safe = take < 0 ? 0 : (take > E - 1 ? E - 1 : take);
    out_nb[i] = indices[safe];
    out_valid[i] = (o < deg && fmask[f] != 0) ? 1 : 0;
  }
}

// ------------------------------------------------------------------ K15

// marks[v] = 1 for v = where(mask, nodes, n_nodes) under JAX's scatter rule
// over n_nodes + 1 slots; slot n_nodes is left 0 (the reference clears it)
__global__ void __launch_bounds__(CP_THREADS)
dedup_mark_kernel(const int* __restrict__ nodes, const unsigned char* __restrict__ mask,
                  long long F, int n_nodes, unsigned* __restrict__ marks) {
  for (long long i = (long long)blockIdx.x * CP_THREADS + threadIdx.x; i < F;
       i += (long long)gridDim.x * CP_THREADS) {
    long long v = mask[i] ? (long long)nodes[i] : (long long)n_nodes;
    if (v < 0) v += (long long)n_nodes + 1;
    if (v >= 0 && v < n_nodes) marks[v] = 1u;
  }
}

}  // namespace

extern "C" {

// d_all [Q, M] f32, i_all [Q, M] i32 (local ids; shard of position p is
// p / kk); out_d [Q, k_out] f32, out_i [Q, k_out] i32.
int mesh_topk_merge(const void* d_all, const void* i_all, int Q, int M, int kk,
                    long long shard_rows, int k_out, int finite_only, void* out_d, void* out_i,
                    void* stream) {
  if (Q <= 0 || M <= 0 || kk <= 0 || k_out <= 0 || k_out > M || M % kk != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = M <= MG_SMEM_KEYS ? (size_t)M * sizeof(unsigned) : 0;
  topk_merge_kernel<<<Q, MG_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)d_all, (const int*)i_all, M, kk, shard_rows, k_out, finite_only,
      (float*)out_d, (int*)out_i);
  return (int)cudaGetLastError();
}

// q: the feature slice of [Q, *] f32 queries (row stride q_stride); x: the
// [rows, Dm] block of the corpus (f32, or bf16 with x_bf16 = 1; row stride
// x_stride); acc [Q, rows] f32; mask [rows] u8, read only with finish.
int mesh_partial_sqdist(const void* q, long long q_stride, int Q, const void* x, int x_bf16,
                        long long x_stride, long long rows, int Dm, void* acc, int first,
                        int finish, const void* mask, void* stream) {
  if (Q <= 0 || rows <= 0 || Dm <= 0) return (int)cudaErrorInvalidValue;
  const long long nqt = (Q + PS_QT - 1) / PS_QT;
  const long long blocks = ((rows + PS_THREADS - 1) / PS_THREADS) * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* m = finish ? (const unsigned char*)mask : nullptr;
  if (x_bf16)
    partial_sqdist_kernel<__nv_bfloat16><<<(unsigned)blocks, PS_THREADS, 0, s>>>(
        (const float*)q, q_stride, Q, (const __nv_bfloat16*)x, x_stride, rows, Dm, (float*)acc,
        first, finish, m);
  else
    partial_sqdist_kernel<float><<<(unsigned)blocks, PS_THREADS, 0, s>>>(
        (const float*)q, q_stride, Q, (const float*)x, x_stride, rows, Dm, (float*)acc, first,
        finish, m);
  return (int)cudaGetLastError();
}

// indptr [V1] i32, indices [E] i32, frontier [F] i32, fmask [F] u8;
// out_nb / out_valid [F * max_degree] i32 / u8.
int mesh_frontier_hop(const void* indptr, long long V1, const void* indices, long long E,
                      const void* frontier, const void* fmask, long long F, int max_degree,
                      void* out_nb, void* out_valid, void* stream) {
  if (V1 <= 0 || E <= 0 || F < 0 || max_degree <= 0) return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  frontier_hop_kernel<<<grid_for(F * max_degree), CP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)indptr, V1, (const int*)indices, E, (const int*)frontier,
      (const unsigned char*)fmask, F, max_degree, (int*)out_nb, (unsigned char*)out_valid);
  return (int)cudaGetLastError();
}

// nodes [F] i32, mask [F] u8; marks [n_nodes + 1] u32 and blk
// [mesh_dedup_blocks(n_nodes)] i32 scratch; out_nodes [F] i32, out_mask [F] u8.
int mesh_dedup_frontier(const void* nodes, const void* mask, int F, int n_nodes, void* marks,
                        void* blk, void* out_nodes, void* out_mask, void* stream) {
  if (F <= 0 || n_nodes < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(marks, 0, ((size_t)n_nodes + 1) * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  dedup_mark_kernel<<<grid_for(F), CP_THREADS, 0, s>>>((const int*)nodes,
                                                       (const unsigned char*)mask, F, n_nodes,
                                                       (unsigned*)marks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  compact_fill<unsigned char><<<grid_for(F), CP_THREADS, 0, s>>>((int*)out_nodes,
                                                                 (unsigned char*)out_mask, F,
                                                                 n_nodes);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)compact_run<unsigned char>((const unsigned*)marks, n_nodes, (int*)blk, F,
                                         (int*)out_nodes, (unsigned char*)out_mask, s);
}

long long mesh_dedup_blocks(long long n_nodes) { return compact_blocks(n_nodes); }

}  // extern "C"
