// Mesh kernels for Hopper (sm_90a), behind the same plain C interface as
// knn.cu (one library, loaded with ctypes by surrealdb_tpu_torch/ops/_cuda.py).
// They serve surrealdb_tpu_torch/parallel/mesh.py, the port of
// surrealdb_tpu/parallel/mesh.py, whose shard_map programs run here as one
// launch a shard, or (K13) one launch over all the shards a card holds: a
// shard is a view of one tensor when the shards share a card, a copy on its
// own card otherwise.
//
// mesh_topk_merge is the merge of K11 sharded_knn, K12 sharded_knn_2d and
// K13 _ivf_searcher: after the all-gather of every shard's kk candidates
// into d_all / i_all [Q, S*kk] (shard order), lax.top_k(-d_all, k_out) and
// the take of the ids, with the id arithmetic done here: a candidate at
// position p belongs to shard p / kk, and its global id is its local id +
// shard * shard_rows (K11, K12: always, so a shard's +inf picks keep their
// ids, as the reference returns them; K13: only where the distance is
// finite, else -1). Order is lax.top_k's: distance, then the lower
// position. What bounds it: nothing on this card (a few thousand
// candidates a query at most, a few KB); its time should be the launch.
// Design: one block a query; for k_out <= 256 each warp keeps a running
// top-k_out of its share (knn.cuh's warp lists, keyed (key << 32 |
// position)) and warp 0 merges them; above, each thread ranks its
// candidates against all of the query's (O(M^2) compares: at K13's M =
// 5,280 this alone took most of a Q=1 call on the H100, PERF.md §6, so it
// serves only the large k_out the lists cannot hold); the rank is the
// output slot.
//
// mesh_knn_2d is K12's step for one (row shard, feature shard) block of the
// corpus, or on one card for a feature shard of every row shard at once,
// and the matching feature slice of the queries (strided views):
// the reference's |q|^2 + |x|^2 - 2 q.x over the slice in f32, the psum
// over `model` as an accumulator [Q, rows] that the first feature shard
// writes and the next ones add to, in feature-shard order; the last applies
// sqrt(max(d2, 0)) and the mask and takes the row shard's top-kk in
// (distance, lower row) order. What bounds it: reading the corpus slice
// (bytes) at Q <= 8; at Q = 64 the products (the corpus read once against
// 64 queries). Design: K1/K2's cores (knn.cuh's streaming tier at Q <= 8,
// and at Q > 8 over f32 rows; knn_tq.cuh's tensor tier at Q > 8 over bf16
// rows: three bf16 limbs of the queries on mma.sync, a block a whole
// 64-query tile), so each feature shard's rows are read from HBM once at
// every Q, with their accumulator epilogue: a non-last shard's pass writes
// or adds its partial into acc (K1's epilogue), the last one reads acc,
// finishes and offers the keys straight to K2's running top-k, and the
// merge below, over the blocks' picks, gives the row shard's kk: the
// finished [Q, rows] distances never reach HBM, and no selection over
// them follows. Its
// instances (euclidean; f32 and bf16 rows at query tiles 1 and 8; the
// tensor tier, both epilogues) build here, beside knn.cu.
//
// mesh_ivf_rerank is K13's rerank of every shard a card holds, one launch:
// per shard, the probed lists' members that are listed (list_mask) and
// slot_ok, ranked by `metric` in (distance, position pr * L + j) order,
// top-kk, slots local to the shard. What bounds it: reading the candidate
// rows (bytes), and at small Q the latency of a warp's row reads. Design:
// a block a (query, shard, probe rank, contiguous range of the list's
// extent), the ranges chosen so the launch has about four blocks an SM; a
// warp reads its chunk's 32 mask bytes and offers nothing, reading no row,
// where none is live; live rows are read as ivf.cu's gather reads them (a
// warp a row, 16-byte loads, metric.cuh's formulas), four rows at once, and
// their keys go straight to the warp's running top-k (knn.cuh's
// warp_offer); the block writes its sorted picks with the slots mapped, so
// no [Q, nprobe * L] scratch is written and no slot-mapping launch follows.
// The picks lie in (shard, position) order, so mesh_topk_merge (with kk the
// picks a shard) finishes with the reference's order.
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

#include <atomic>

#include "launch.cuh"
#include "metric.cuh"
#include "mma.cuh"
#include "rowstream.cuh"
#include "knn.cuh"
#include "knn_tq.cuh"
#include "compact.cuh"

namespace {

// ------------------------------------------------------------------ merge

constexpr int MG_THREADS = 256;
constexpr int MG_WARPS = MG_THREADS / 32;
constexpr int MG_SMEM_KEYS = 12288;  // 48 KB of keys: static shared-memory limit

// the pick at position p of a query's candidates d / ids, to out_d / out_i
__device__ __forceinline__ void merge_pick(const float* __restrict__ d, const int* __restrict__ ids,
                                           int p, int kk, long long shard_rows, int finite_only,
                                           float* out_d, int* out_i) {
  const float dv = d[p];
  const long long shard = p / kk;
  const bool finite = dv < __uint_as_float(0x7f800000u);  // below +inf
  const long long gid = (long long)ids[p] + shard * shard_rows;
  *out_d = dv;
  *out_i = (finite_only && !finite) ? -1 : (int)gid;
}

// k_out <= KNN_FUSED_MAX_K: each warp keeps the k_out least (key << 32 |
// position) pairs of its share of the query's candidates (knn.cuh's running
// top-k), then warp 0 merges the warps' lists and writes them in order: a
// candidate costs a compare and a ballot once the lists are good.
__global__ void __launch_bounds__(MG_THREADS)
topk_merge_lists_kernel(const float* __restrict__ d_all, const int* __restrict__ i_all, int M,
                        int kk, long long shard_rows, int k_out, int finite_only,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned long long mg_lists[];  // [MG_WARPS][k_out]
  const long long row = blockIdx.x;
  const float* d = d_all + row * M;
  const int* ids = i_all + row * M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* kept = mg_lists + warp * k_out;
  for (int e = lane; e < k_out; e += 32) kept[e] = PAD_PAIR;
  __syncwarp();
  unsigned long long theta = PAD_PAIR;
  for (int p0 = warp * 32; p0 < M; p0 += MG_THREADS) {
    const int p = p0 + lane;
    theta = warp_offer(kept, k_out, theta, p < M ? pair_of(f2key(d[p]), p) : PAD_PAIR);
  }
  __syncthreads();  // every warp's list is complete
  if (warp != 0) return;
  for (int w = 1; w < MG_WARPS; ++w) {
    const unsigned long long* other = mg_lists + w * k_out;
    for (int c0 = 0; c0 < k_out; c0 += 32)
      theta = warp_offer(kept, k_out, theta, c0 + lane < k_out ? other[c0 + lane] : PAD_PAIR);
  }
  for (int r = lane; r < k_out; r += 32)  // M >= k_out: every entry a candidate
    merge_pick(d, ids, (int)(unsigned)(kept[r] & 0xFFFFFFFFull), kk, shard_rows, finite_only,
               out_d + row * k_out + r, out_i + row * k_out + r);
}

// k_out above it: each thread ranks its candidates against all of the
// query's candidates (the count of smaller keys plus equal keys at lower
// positions), staged in shared memory when they fit; the rank is the
// output slot.
__global__ void __launch_bounds__(MG_THREADS)
topk_merge_rank_kernel(const float* __restrict__ d_all, const int* __restrict__ i_all, int M,
                       int kk, long long shard_rows, int k_out, int finite_only,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned keys_smem[];
  const long long row = blockIdx.x;
  const float* d = d_all + row * M;
  const int* ids = i_all + row * M;
  const bool staged = M <= MG_SMEM_KEYS;
  if (staged)
    for (int j = threadIdx.x; j < M; j += MG_THREADS) keys_smem[j] = f2key(d[j]);
  __syncthreads();
  for (int p = threadIdx.x; p < M; p += MG_THREADS) {
    const unsigned kp = staged ? keys_smem[p] : f2key(d[p]);
    int rank = 0;
    for (int j = 0; j < M && rank < k_out; ++j) {
      const unsigned kj = staged ? keys_smem[j] : f2key(d[j]);
      rank += (kj < kp) || (kj == kp && j < p);
    }
    if (rank < k_out)
      merge_pick(d, ids, p, kk, shard_rows, finite_only, out_d + row * k_out + rank,
                 out_i + row * k_out + rank);
  }
}

// ------------------------------------------------------------------ K12

// One (row shard, feature shard) step on K1/K2's cores with the
// accumulator epilogue (ACC): fused (kk > 0, the last feature shard) offers
// the finished keys to K2's running top-k, else K1's pass writes the
// accumulator. Euclidean only; f32 and bf16 rows at query tiles 1 and 8,
// the tensor tier at Q > 8 over bf16 rows.
template <bool FUSED>
int knn2d_launch(const KnnPlan& pl, const float* q, const void* x, int x_bf16, int Q,
                 long long rows, int Dm, const KnnView& view, const unsigned char* mask, int k,
                 float* out, unsigned char* scratch, cudaStream_t s) {
  constexpr int E = M_EUCLIDEAN;
  if (pl.tq)
    return launch_tq<E, FUSED, true>(pl, q, (const unsigned short*)x, Q, rows, Dm, view, mask, k,
                                     out, scratch, s);
  if (x_bf16) {
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    return pl.qt == 1 ? launch_stream_qt<E, __nv_bfloat16, 1, true>(
                            FUSED, pl, q, xb, Q, rows, Dm, view, 0.f, nullptr, nullptr, mask, k,
                            out, scratch, s)
                      : launch_stream_qt<E, __nv_bfloat16, 8, true>(
                            FUSED, pl, q, xb, Q, rows, Dm, view, 0.f, nullptr, nullptr, mask, k,
                            out, scratch, s);
  }
  const float* xf = (const float*)x;
  return pl.qt == 1 ? launch_stream_qt<E, float, 1, true>(FUSED, pl, q, xf, Q, rows, Dm, view,
                                                          0.f, nullptr, nullptr, mask, k, out,
                                                          scratch, s)
                    : launch_stream_qt<E, float, 8, true>(FUSED, pl, q, xf, Q, rows, Dm, view,
                                                          0.f, nullptr, nullptr, mask, k, out,
                                                          scratch, s);
}

// ------------------------------------------------------------------ K13

constexpr int IR_THREADS = 256;
constexpr int IR_WARPS = IR_THREADS / 32;
constexpr int IR_ROWS = 4;  // member rows a warp reads at once

// positions a block covers at most: a list of L positions split in G
// contiguous ranges, rounded up to whole 32-position chunks
__host__ __device__ inline int ir_span(int n, int G) { return ((n + G - 1) / G + 31) / 32 * 32; }

int ir_smem_bytes(int D, int kkb) { return (D * 4 + 15) / 16 * 16 + IR_WARPS * kkb * 8; }

// The distances of the query (qs [D] in shared memory, centred for
// pearson; qss its squared norm) to up to IR_ROWS member rows xr[r] at
// once (src[r] < 0: none; uniform in the warp), a warp a row as ivf.cu's
// gather reads them: 16-byte loads (vec) or one value a lane, then a
// shuffle reduction, so every lane holds every distance.
template <int METRIC, typename T>
__device__ __forceinline__ void member_distances(const T* const (&xr)[IR_ROWS],
                                                 const int (&src)[IR_ROWS],
                                                 const float* __restrict__ qs, int D, float p,
                                                 float qss, int vec, float (&out)[IR_ROWS]) {
  constexpr bool DOT = is_dot_metric<METRIC>();
  constexpr int V = 16 / (int)sizeof(T);  // row values in 16 bytes
  const int lane = threadIdx.x & 31;
  float acc[IR_ROWS], acc2[IR_ROWS], xss[IR_ROWS], xm[IR_ROWS];
#pragma unroll
  for (int r = 0; r < IR_ROWS; ++r) acc[r] = acc2[r] = xss[r] = xm[r] = 0.f;
  if (METRIC == M_PEARSON) {
#pragma unroll
    for (int r = 0; r < IR_ROWS; ++r) {
      if (src[r] < 0) continue;  // uniform
      float t = 0.f;
      for (int c = lane; c < D; c += 32) t += to_f(xr[r][c]);
      xm[r] = wsum(t) / (float)D;
    }
  }
  if (vec) {
    for (int c0 = lane * V; c0 < D; c0 += 32 * V) {
      uint4 raw[IR_ROWS];
#pragma unroll
      for (int r = 0; r < IR_ROWS; ++r)  // every row's load in flight before the arithmetic
        if (src[r] >= 0) raw[r] = __ldg(reinterpret_cast<const uint4*>(xr[r] + c0));
#pragma unroll
      for (int r = 0; r < IR_ROWS; ++r) {
        if (src[r] < 0) continue;
        const T* tv = reinterpret_cast<const T*>(&raw[r]);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float xv = to_f(tv[u]) - xm[r];
          pw_step<METRIC>(qs[c0 + u], xv, p, acc[r], acc2[r]);
          if (DOT) xss[r] = fmaf(xv, xv, xss[r]);
        }
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
#pragma unroll
      for (int r = 0; r < IR_ROWS; ++r) {
        if (src[r] < 0) continue;
        const float xv = to_f(xr[r][c]) - xm[r];
        pw_step<METRIC>(qs[c], xv, p, acc[r], acc2[r]);
        if (DOT) xss[r] = fmaf(xv, xv, xss[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < IR_ROWS; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oa = __shfl_xor_sync(FULL, acc[r], off);
      acc[r] = METRIC == M_CHEBYSHEV ? fmaxf(acc[r], oa) : acc[r] + oa;
      acc2[r] += __shfl_xor_sync(FULL, acc2[r], off);
      xss[r] += __shfl_xor_sync(FULL, xss[r], off);
    }
    out[r] = pw_finish<METRIC>(qss, xss[r], acc[r], acc2[r], p);
  }
}

// Block b = (((query * S + shard) * P + probe rank) * G + g): query qi
// against the members of list probes[qi, pr] in shard s (tables [S, C, L],
// rows [S * cap, D], slot_ok [S * cap] or null: every slot) that lie in the
// g-th of G contiguous ranges of the list's extent (one past its last
// listed position). Warp w takes the range's 32-position chunks w, w + 8,
// ...: a lane reads its position's mask byte, row and slot_ok byte; a chunk
// with no live member reads no row and offers nothing; live rows are read a
// warp a row, IR_ROWS at once; the chunk's keys (f2key(d) << 32 | position)
// go to the warp's running top-kkb (warp_offer). At the end warp 0 merges
// the warps' lists and writes the block's kkb picks, sorted: the distance
// and the row's slot (list_rows, local to the shard), +inf and -1 past the
// candidates, to out [Q, S, P, G, kkb], so a query's picks lie in (shard,
// position) order among equal distances.
template <int METRIC, typename T>
__global__ void __launch_bounds__(IR_THREADS)
ivf_rerank_kernel(const float* __restrict__ q, int D, float p, const int* __restrict__ probes,
                  int P, const T* __restrict__ x, long long cap,
                  const int* __restrict__ list_rows, const unsigned char* __restrict__ list_mask,
                  int C, int L, const unsigned char* __restrict__ slot_ok, int S, int G, int kkb,
                  int vec, float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr bool DOT = is_dot_metric<METRIC>();
  // the query [D] (centred for pearson), then the warps' lists [IR_WARPS][kkb]
  extern __shared__ __align__(16) unsigned char ir_smem[];
  __shared__ float s_red[IR_WARPS];
  __shared__ int s_last[IR_WARPS];
  __shared__ float s_qmean, s_qss;
  float* qs = reinterpret_cast<float*>(ir_smem);
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(ir_smem + (D * 4 + 15) / 16 * 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = (int)(blockIdx.x % G);
  const long long qsp = blockIdx.x / G;  // (query * S + shard) * P + probe rank
  const int pr = (int)(qsp % P);
  const int s = (int)(qsp / P % S);
  const int qi = (int)(qsp / P / S);
  const long long lb = ((long long)s * C + probes[(long long)qi * P + pr]) * L;
  const int* lr = list_rows + lb;
  const unsigned char* lm = list_mask + lb;
  const T* xs = x + (long long)s * cap * D;
  const unsigned char* ok = slot_ok == nullptr ? nullptr : slot_ok + (long long)s * cap;

  float part = 0.f;
  for (int c = tid; c < D; c += IR_THREADS) {
    const float v = q[(long long)qi * D + c];
    qs[c] = v;
    part += v;
  }
  if (METRIC == M_PEARSON) {
    part = wsum(part);
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < IR_WARPS; ++w) t += s_red[w];
      s_qmean = t / (float)D;
    }
    __syncthreads();
    for (int c = tid; c < D; c += IR_THREADS) qs[c] -= s_qmean;
  }
  __syncthreads();
  if (DOT) {
    float t = 0.f;
    for (int c = tid; c < D; c += IR_THREADS) t = fmaf(qs[c], qs[c], t);
    t = wsum(t);
    if (lane == 0) s_red[warp] = t;
    __syncthreads();
    if (tid == 0) {
      float u = 0.f;
      for (int w = 0; w < IR_WARPS; ++w) u += s_red[w];
      s_qss = u;
    }
  }
  // the list's extent; the warp's list starts empty
  int last = -1;
  for (int j = tid; j < L; j += IR_THREADS)
    if (lm[j]) last = j;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(FULL, last, o));
  if (lane == 0) s_last[warp] = last;
  unsigned long long* kept = lists + warp * kkb;
  for (int e = lane; e < kkb; e += 32) kept[e] = PAD_PAIR;
  __syncthreads();
  const float qss = DOT ? s_qss : 0.f;
  int ext = 0;
  for (int w = 0; w < IR_WARPS; ++w) ext = max(ext, s_last[w] + 1);
  const int span = ir_span(ext, G);
  const int lo = g * span, hi = min(ext, lo + span);
  unsigned long long theta = PAD_PAIR;
  for (int c0 = lo + warp * 32; c0 < hi; c0 += IR_THREADS) {
    const int j = c0 + lane;
    bool live = j < hi && lm[j] != 0;
    long long row = 0;
    if (live) {
      row = lr[j];
      row = row < 0 ? 0 : (row >= cap ? cap - 1 : row);
      live = ok == nullptr || ok[row] != 0;
    }
    unsigned todo = __ballot_sync(FULL, live);
    if (todo == 0u) continue;  // uniform: no row read, nothing offered
    float mine = 0.f;
    while (todo != 0u) {  // uniform
      int src[IR_ROWS];
      const T* xr[IR_ROWS];
#pragma unroll
      for (int r = 0; r < IR_ROWS; ++r) {
        src[r] = todo != 0u ? __ffs((int)todo) - 1 : -1;
        todo &= todo - 1u;
        xr[r] = xs + __shfl_sync(FULL, row, src[r] < 0 ? 0 : src[r]) * D;
      }
      float dist[IR_ROWS];
      member_distances<METRIC, T>(xr, src, qs, D, p, qss, vec, dist);
#pragma unroll
      for (int r = 0; r < IR_ROWS; ++r)
        if (lane == src[r]) mine = dist[r];
    }
    theta = warp_offer(kept, kkb, theta, live ? pair_of(f2key(mine), j) : PAD_PAIR);
  }
  __syncthreads();  // every warp's list is complete
  if (warp != 0) return;
  unsigned long long th = kept[kkb - 1];
  for (int w = 1; w < IR_WARPS; ++w) {
    const unsigned long long* other = lists + w * kkb;
    for (int c0 = 0; c0 < kkb; c0 += 32)
      th = warp_offer(kept, kkb, th, c0 + lane < kkb ? other[c0 + lane] : PAD_PAIR);
  }
  // the picks' place: a query's row, by shard, then probe rank, then range
  const long long o = (qsp * G + g) * kkb;
  for (int i = lane; i < kkb; i += 32) {
    const unsigned long long v = kept[i];
    const bool real = v != PAD_PAIR;
    out_d[o + i] = real ? key2f((unsigned)(v >> 32)) : __uint_as_float(0x7f800000u);
    out_i[o + i] = real ? lr[(unsigned)(v & 0xFFFFFFFFull)] : -1;
  }
}

template <int M, typename T>
int launch_rerank(const float* q, int Q, int D, float p, const int* probes, int P, const T* x,
                  long long cap, const int* list_rows, const unsigned char* list_mask, int C,
                  int L, const unsigned char* slot_ok, int S, int G, int kkb, float* out_d,
                  int* out_i, cudaStream_t s) {
  static std::atomic<unsigned> seen{0};
  const int smem = ir_smem_bytes(D, kkb);
  if (smem > SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  if (int err = opt_in_smem(ivf_rerank_kernel<M, T>, smem > 48 * 1024 ? SMEM_OPT_IN : smem, seen))
    return err;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (D % (16 / (int)sizeof(T)) == 0);
  const long long blocks = (long long)Q * S * P * G;
  ivf_rerank_kernel<M, T><<<(unsigned)blocks, IR_THREADS, smem, s>>>(
      q, D, p, probes, P, x, cap, list_rows, list_mask, C, L, slot_ok, S, G, kkb, vec, out_d,
      out_i);
  return (int)cudaGetLastError();
}

template <typename T>
int rerank_dispatch(int metric, const float* q, int Q, int D, float p, const int* probes, int P,
                    const T* x, long long cap, const int* list_rows,
                    const unsigned char* list_mask, int C, int L, const unsigned char* slot_ok,
                    int S, int G, int kkb, float* out_d, int* out_i, cudaStream_t s) {
#define IR_CASE(M)                                                                         \
  case M:                                                                                  \
    return launch_rerank<M, T>(q, Q, D, p, probes, P, x, cap, list_rows, list_mask, C, L, \
                               slot_ok, S, G, kkb, out_d, out_i, s);
  switch (metric) {
    IR_CASE(M_EUCLIDEAN)
    IR_CASE(M_COSINE)
    IR_CASE(M_MANHATTAN)
    IR_CASE(M_CHEBYSHEV)
    IR_CASE(M_HAMMING)
    IR_CASE(M_JACCARD)
    IR_CASE(M_PEARSON)
    IR_CASE(M_MINKOWSKI)
    default: return (int)cudaErrorInvalidValue;
  }
#undef IR_CASE
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (k_out <= KNN_FUSED_MAX_K) {
    topk_merge_lists_kernel<<<Q, MG_THREADS, (size_t)MG_WARPS * k_out * 8, s>>>(
        (const float*)d_all, (const int*)i_all, M, kk, shard_rows, k_out, finite_only,
        (float*)out_d, (int*)out_i);
    return (int)cudaGetLastError();
  }
  const size_t smem = M <= MG_SMEM_KEYS ? (size_t)M * sizeof(unsigned) : 0;
  topk_merge_rank_kernel<<<Q, MG_THREADS, smem, s>>>(
      (const float*)d_all, (const int*)i_all, M, kk, shard_rows, k_out, finite_only,
      (float*)out_d, (int*)out_i);
  return (int)cudaGetLastError();
}

// K12's step for one (row shard, feature shard): q the feature slice of
// [Q, *] f32 queries (q_stride elements between queries); x the [rows, Dm]
// block of the corpus (f32, or bf16 with x_bf16 = 1; rows x_stride
// elements apart); acc [Q, rows] f32, read unless `first`; mask [rows] u8
// (0: the row reads as +inf), read with `finish`. kk = 0: acc = (first ? 0
// : acc) + the slice's |q|^2 + |x|^2 - 2 q.x, with `finish` sqrt(max(., 0))
// and the mask (K1's pass). kk > 0 (needs finish; kk <= knn_search_max_k(),
// <= rows): the kk nearest rows of the finished distances, in (distance,
// row) order, to out_d [Q, kk] f32 / out_i [Q, kk] i32 (K2's fused pass,
// then mesh_topk_merge's kernel over the blocks' picks); acc is not
// written. scratch:
// mesh_knn_2d_scratch_bytes(Q, rows, Dm, kk, x_bf16) bytes, null when 0.
int mesh_knn_2d(const void* q, long long q_stride, int Q, const void* x, int x_bf16,
                long long x_stride, long long rows, int Dm, void* acc, int first, int finish,
                const void* mask, int kk, void* scratch, long long scratch_bytes, void* out_d,
                void* out_i, void* stream) {
  if (Q <= 0 || rows <= 0 || Dm <= 0 || kk < 0 || kk > KNN_FUSED_MAX_K || kk > rows ||
      (kk > 0 && !finish) || q_stride < Dm || x_stride < Dm || q_stride > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool fused = kk > 0;
  const KnnPlan pl = make_plan(Q, rows, Dm, fused ? kk : 1, x_bf16, M_EUCLIDEAN, fused);
  if (pl.bytes > 0 && (scratch == nullptr || scratch_bytes < pl.bytes))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const KnnView view{x_stride, (int)q_stride, first ? nullptr : (const float*)acc, finish};
  const unsigned char* m = finish ? (const unsigned char*)mask : nullptr;
  unsigned char* sc = (unsigned char*)scratch;
  if (!fused)
    return knn2d_launch<false>(pl, (const float*)q, x, x_bf16, Q, rows, Dm, view, m, 1,
                               (float*)acc, sc, s);
  const int err = knn2d_launch<true>(pl, (const float*)q, x, x_bf16, Q, rows, Dm, view, m, kk,
                                     nullptr, sc, s);
  if (err != 0) return err;
  // the blocks' picks [Q, nblk * kk] lie in row order among equal keys:
  // the merge as one shard of local ids
  return mesh_topk_merge(sc + pl.picks_d, sc + pl.picks_i, Q, (int)(pl.nblk * kk),
                         (int)(pl.nblk * kk), 0, kk, 0, out_d, out_i, stream);
}

long long mesh_knn_2d_scratch_bytes(int Q, long long rows, int Dm, int kk, int x_bf16) {
  if (Q <= 0 || rows <= 0 || Dm <= 0 || kk < 0) return 0;
  return make_plan(Q, rows, Dm, kk > 0 ? kk : 1, x_bf16, M_EUCLIDEAN, kk > 0).bytes;
}

// K13's rerank over S shards of one device, one launch: q [Q, D] f32;
// probes [Q, P] i32 (list ids); x [S * cap, D] f32 / bf16 (shard s's rows
// from s * cap); list_rows [S, C, L] i32 (slots local to the shard) and
// list_mask [S, C, L] u8; slot_ok [S * cap] u8 or null (every slot); G
// ranges a list (mesh_ivf_rerank_groups), kkb picks a block
// (mesh_ivf_rerank_picks). out_d / out_i [Q, S * P * G * kkb]: each block's
// picks, sorted by (distance, position), +inf / -1 past its candidates; a
// query's row lies in (shard, probe rank, range) order, so
// mesh_topk_merge with kk = P * G * kkb selects them in the reference's
// (distance, shard, position) order and adds the shard offsets.
int mesh_ivf_rerank(const void* q, int Q, int D, int metric, float p, const void* probes, int P,
                    const void* x, int x_bf16, long long cap, const void* list_rows,
                    const void* list_mask, int C, int L, const void* slot_ok, int S, int G,
                    int kkb, void* out_d, void* out_i, void* stream) {
  if (Q <= 0 || D <= 0 || P <= 0 || cap <= 0 || C <= 0 || L <= 0 || S <= 0 || G <= 0 ||
      kkb <= 0 || kkb > KNN_FUSED_MAX_K || kkb > ir_span(L, G) ||
      (long long)Q * S * P * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* pr = (const int*)probes;
  const int* lr = (const int*)list_rows;
  const unsigned char* lm = (const unsigned char*)list_mask;
  const unsigned char* ok = (const unsigned char*)slot_ok;
  if (x_bf16)
    return rerank_dispatch<__nv_bfloat16>(metric, (const float*)q, Q, D, p, pr, P,
                                          (const __nv_bfloat16*)x, cap, lr, lm, C, L, ok, S, G,
                                          kkb, (float*)out_d, (int*)out_i, s);
  return rerank_dispatch<float>(metric, (const float*)q, Q, D, p, pr, P, (const float*)x, cap, lr,
                                lm, C, L, ok, S, G, kkb, (float*)out_d, (int*)out_i, s);
}

// G: the contiguous ranges each of `lists` (Q * S * P) probed lists of L
// positions is split into, so the launch has about four blocks an SM; a kk
// above knn_search_max_k() splits a list into ranges of at most that many
// positions, so a block's list holds all its candidates.
long long mesh_ivf_rerank_groups(long long lists, int L, int kk) {
  if (lists <= 0 || L <= 0) return 1;
  long long g = (4LL * sm_count() + lists - 1) / lists;
  g = max(1LL, min(g, (long long)(L + 31) / 32));
  if (kk > KNN_FUSED_MAX_K) g = max(g, (long long)(L + KNN_FUSED_MAX_K - 1) / KNN_FUSED_MAX_K);
  return g;
}

// kkb: the picks a block keeps, min(kk, the positions a range may hold)
int mesh_ivf_rerank_picks(int L, int G, int kk) {
  return L <= 0 || G <= 0 ? 0 : min(kk, ir_span(L, G));
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
