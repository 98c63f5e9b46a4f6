// Exact kNN kernels for Hopper (sm_90a): pairwise distance (K1) and the
// masked min-k search (K2), behind a plain C interface loaded with ctypes
// by surrealdb_tpu_torch/ops/_cuda.py.
//
// K2 knn_search replaces surrealdb_tpu/ops/distances.py:knn_search
// (distances, the mask as +inf, lax.top_k(-d, k)); K1 knn_pairwise replaces
// its pairwise_distance (the [Q,D] x [N,D] -> [Q,N] program). Formulas
// follow the reference (metric.cuh). What bounds them at the main path's
// shapes (Q in {1, 8, 64} from the dispatch tiles, N = 2^20, D = 768, bf16
// corpus): reading the corpus, 1.6 GB, 0.48 ms at 3.35 TB/s; K1 also writes
// [Q,N] f32. K2 fuses the selection into the distance pass, so the [Q,N]
// distances never reach device memory. Its answer is exactly the plain
// version's: keys are f2key of the f32 distance (a masked row +inf), order
// is (distance, lower index), indices int32.
//
// One distance core, two epilogues: K1 writes the distances; K2 offers each
// (row, query) key to a running top-k. Two tiers:
//
// - Streaming (Q <= 8, every metric, f32 or bf16 rows; knn.cuh, its f32
//   instances in knn_f32.cu and its bf16 ones in knn_bf16_lo.cu /
//   knn_bf16_hi.cu, half the metrics each, so nvcc builds them in
//   parallel): rowstream.cuh.
//   A thread owns 2 rows of a 512-row tile at one query, 4 of a 1,024-row
//   tile at 8; rows arrive by 16-byte cp.async through a ring (64 bytes of
//   each row a step), the queries sit in shared memory and every query
//   value is one float4 broadcast for the warp that serves the thread's rows
//   x 4 columns of FMA chains. The norms euclidean, cosine and pearson need
//   are summed in the same pass; pearson's row means come from a
//   knn_row_mean pre-pass. One persistent block an SM, each on its own
//   contiguous range of rows. At Q > 8 the metrics other than euclidean and
//   cosine, and f32 rows (on the main path only the IVF probe's 1,024
//   centroids), run this tier over tiles of 8 queries, with the tiles of one
//   range on neighbouring blocks so the rows are read from HBM about once.
// - Tensor cores (Q > 8 with bf16 rows, euclidean or cosine: the Q=64
//   dispatch tile): K5's method (ivf.cu) with the queries in the centroids'
//   place. split_queries splits each f32 query once a launch, by
//   truncation, into three bf16 limbs (q = q0 + q1 + q2 exactly) and writes
//   |q|^2; a bf16 row is exact, so each limb product is exact in f32 and
//   mma.sync.m16n8k16 sums them. Limbs 2 and 1 go to one set of sums and
//   limb 0 to another, added once at the end, so no lower-limb product is
//   added to a sum of the full dot's size (one sum over the three limbs
//   lost limb 2's share in K5's lower-limb checks). A block of 16 warps (8 along 256 rows
//   x 2 along 64 queries, each a 32 x 32 tile of both sets of sums), one an
//   SM, walks its range in 256-row tiles; each 32-column step stages the
//   rows and the three limb planes by cp.async into a 3-slot ring; |x|^2 is
//   summed in f32 from the staged rows. At a tile's end the keys go through
//   a swizzled shared-memory buffer, and warp w offers queries w, w + 16,
//   ... to their lists. A (row, query) whose product is not finite is
//   recomputed as the f32 FMA chain (what f32 gives). 128-row tiles at two
//   blocks an SM measured slower on the H100: their 128 registers spilled.
//   The tier and the launch plan are in knn_tq.cuh (mesh.cu's K12 builds
//   its own instances of both tiers, with an accumulator epilogue).
//
// K2's selection (k <= KNN_FUSED_MAX_K): each warp keeps, per query, the k
// best (key << 32 | row) pairs seen so far, sorted, in shared memory while
// the lists fit (else in global scratch, where an insert costs L2 round
// trips); 32 candidates at a time (one a lane) below the list's k-th
// enter by ranks computed with ballots: a candidate's place is the number
// of kept entries and of candidates below it, a kept entry moves up by the
// candidates below it. Nothing else runs, so once the list is good a
// 32-row chunk costs one compare and one ballot a query. The pair order is
// exactly (distance, index). At the end a block merges its warps' lists
// (streaming tier) and writes its k picks a query, sorted; the blocks'
// ranges are in row order, so one knn_select merge launch over the [Q,
// blocks, k] picks (lowest position first among equal keys) finishes with
// lax.top_k's order. k above KNN_FUSED_MAX_K takes K1 then knn_select (a
// shape rule).
//
// knn_select (also K3's and K9's selection) replaces the selection half:
// an exact radix select over the order-preserving u32 image of the f32 bits
// (four 8-bit histogram passes with warp-aggregated shared atomics) finds
// the k-th key, one ordered compaction keeps every key below it plus the
// lowest-position ties, and a bitonic sort of the k (key << 32 | position)
// pairs gives lax.top_k's order. For k <= 256 over a large row the select
// runs twice: on 4096-column chunks, one block each, then one block a row
// over the chunks' picks; otherwise one block a row selects alone, sorting
// in shared memory while the pairs fit and in a global buffer above.

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

namespace {

// ------------------------------------------------------------------ row means
template <typename T>
__global__ void row_mean_kernel(const T* __restrict__ x, long long N, int D,
                                float* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(x[row * D + c]);
  s = wsum(s);
  if (lane == 0) out[row] = s / (float)D;
}

// ------------------------------------------------------------------ knn_select

// pairs sorted in shared memory up to this count (64 KB of u64)
constexpr int SEL_SMEM_PAIRS = 8192;
// two-stage selection: blocks of SEL_CHUNK_THREADS select the k best of
// each SEL_CHUNK columns, then one block a query merges the chunks' picks
constexpr long long SEL_CHUNK = 4096;
constexpr int SEL_CHUNK_THREADS = 256;
constexpr int SEL_MERGE_THREADS = 1024;
constexpr int SEL_CHUNK_MAX_K = 256;

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
  constexpr int SWARPS = THREADS / 32;
  extern __shared__ unsigned long long smem_pairs[];
  __shared__ unsigned hist[256];
  __shared__ unsigned warp_tot[SWARPS];
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
      const unsigned peers = __match_any_sync(FULL, digit);
      if (digit < 256u && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {  // the bin holding the need-th key: lane l scans bins 8l .. 8l + 7
      unsigned c[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[lane * 8 + j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      const unsigned hit = __ballot_sync(FULL, incl >= need);
      if (lane == __ffs((int)hit) - 1) {  // need <= the keys counted: some lane hits
        unsigned cum = incl - sum;
        int bin = lane * 8 + 7;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cum + c[j] >= need) {
            bin = lane * 8 + j;
            break;
          }
          cum += c[j];
        }
        s_prefix = prefix | ((unsigned)bin << shift);
        s_need = need - cum;
      }
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
    const unsigned blt = __ballot_sync(FULL, lt);
    unsigned lt_base = 0u;
    if (lane == 0 && blt) lt_base = atomicAdd(&s_lt, (unsigned)__popc(blt));
    lt_base = __shfl_sync(FULL, lt_base, 0);
    if (lt) buf[lt_base + __popc(blt & lane_lt)] = ((unsigned long long)key << 32) | (unsigned)i;
    const unsigned taken = s_tie;  // uniform: written by tid 0 before a barrier
    if (taken < need) {
      const unsigned bt = __ballot_sync(FULL, tie);
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
        for (int w = 0; w < SWARPS; ++w) tot += warp_tot[w];
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

std::atomic<unsigned> g_merge_seen{0};

// one block a row over [rows, m] picks (ids through idxmap) -> [rows, k]
int launch_merge(const float* pd, const int* pi, int rows, long long m, int k, float* out_d,
                 int* out_i, cudaStream_t s) {
  if (int err = opt_in_smem(select_kernel<SEL_MERGE_THREADS>,
                            SEL_SMEM_PAIRS * (int)sizeof(unsigned long long), g_merge_seen))
    return err;
  int n2 = 1;
  while (n2 < k) n2 <<= 1;
  select_kernel<SEL_MERGE_THREADS><<<rows, SEL_MERGE_THREADS, (size_t)n2 * 8, s>>>(
      pd, m, nullptr, pi, m, m, k, out_d, out_i, nullptr, 0);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int tq_dispatch(int metric, const KnnPlan& pl, const float* q, const unsigned short* x, int Q,
                long long N, int D, const unsigned char* mask, int k, float* out,
                unsigned char* scratch, cudaStream_t s) {
  if (metric == M_EUCLIDEAN)
    return launch_tq<M_EUCLIDEAN, FUSED>(pl, q, x, Q, N, D, KnnView{D, D, nullptr, 1}, mask, k,
                                         out, scratch, s);
  return launch_tq<M_COSINE, FUSED>(pl, q, x, Q, N, D, KnnView{D, D, nullptr, 1}, mask, k, out,
                                    scratch, s);
}

template <bool FUSED>
int run(const void* q, const void* x, int x_bf16, const void* mask, int Q, long long N, int D,
        int metric, float p, int k, const void* qmean, const void* xmean, void* scratch,
        long long scratch_bytes, void* out, cudaStream_t s) {
  if (metric < M_EUCLIDEAN || metric > M_MINKOWSKI) return (int)cudaErrorInvalidValue;
  const KnnPlan pl = make_plan(Q, N, D, k, x_bf16, metric, FUSED);
  if (pl.bytes > 0 && (scratch == nullptr || scratch_bytes < pl.bytes))
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* qm = (const float*)qmean;
  const float* xm = (const float*)xmean;
  const unsigned char* mk = (const unsigned char*)mask;
  unsigned char* sc = (unsigned char*)scratch;
  if (!x_bf16)
    return knn_stream_f32(FUSED, metric, pl, qf, (const float*)x, Q, N, D, p, qm, xm, mk, k,
                          (float*)out, sc, s);
  if (pl.tq)
    return tq_dispatch<FUSED>(metric, pl, qf, (const unsigned short*)x, Q, N, D, mk, k,
                              (float*)out, sc, s);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  if (metric <= KNN_BF16_LO_LAST)
    return knn_stream_bf16_lo(FUSED, metric, pl, qf, xb, Q, N, D, p, qm, xm, mk, k, (float*)out,
                              sc, s);
  return knn_stream_bf16_hi(FUSED, metric, pl, qf, xb, Q, N, D, p, qm, xm, mk, k, (float*)out, sc,
                            s);
}

}  // namespace

extern "C" {

// K1. q [Q,D] f32, x [N,D] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), out
// [Q,N] f32. qmean [Q] / xmean [N] are read only for pearson (from
// knn_row_mean). scratch: knn_pairwise_scratch_bytes(...) bytes (the query
// limbs of the tensor tier), null when that is 0.
int knn_pairwise(const void* q, const void* x, int x_bf16, int Q, long long N, int D, int metric,
                 float p, const void* qmean, const void* xmean, void* scratch,
                 long long scratch_bytes, void* out, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return run<false>(q, x, x_bf16, nullptr, Q, N, D, metric, p, 1, qmean, xmean, scratch,
                    scratch_bytes, out, (cudaStream_t)stream);
}

long long knn_pairwise_scratch_bytes(int Q, long long N, int D, int x_bf16, int metric) {
  if (Q <= 0 || N <= 0 || D <= 0) return 0;
  return make_plan(Q, N, D, 1, x_bf16, metric, false).bytes;
}

// K2 for 1 <= k <= knn_search_max_k(): the k nearest rows of x to each
// query in (distance, index) order -> out_d [Q,k] f32, out_i [Q,k] i32;
// mask [N] u8 (0 = the row reads as +inf) or null. Arguments as
// knn_pairwise; scratch: knn_search_scratch_bytes(...) bytes. Two launches
// (the fused pass, then the merge of the blocks' picks), three on the
// tensor tier (the query split first).
int knn_search(const void* q, const void* x, int x_bf16, const void* mask, int Q, long long N,
               int D, int metric, float p, int k, const void* qmean, const void* xmean,
               void* scratch, long long scratch_bytes, void* out_d, void* out_i, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || k <= 0 || k > KNN_FUSED_MAX_K || (long long)k > N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = run<true>(q, x, x_bf16, mask, Q, N, D, metric, p, k, qmean, xmean, scratch,
                            scratch_bytes, nullptr, s);
  if (err != 0) return err;
  const KnnPlan pl = make_plan(Q, N, D, k, x_bf16, metric, true);
  unsigned char* sc = (unsigned char*)scratch;
  return launch_merge(reinterpret_cast<const float*>(sc + pl.picks_d),
                      reinterpret_cast<const int*>(sc + pl.picks_i), Q, pl.nblk * k, k,
                      (float*)out_d, (int*)out_i, s);
}

long long knn_search_scratch_bytes(int Q, long long N, int D, int k, int x_bf16, int metric) {
  if (Q <= 0 || N <= 0 || D <= 0 || k <= 0) return 0;
  return make_plan(Q, N, D, k, x_bf16, metric, true).bytes;
}

int knn_search_max_k(void) { return KNN_FUSED_MAX_K; }

// out[r] = mean of row r of x [N,D] (f32 or bf16), one warp a row.
int knn_row_mean(const void* x, int x_bf16, long long N, int D, void* out, void* stream) {
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
  if (int err = opt_in_smem(select_kernel<SEL_MERGE_THREADS>,
                            SEL_SMEM_PAIRS * (int)sizeof(unsigned long long), g_merge_seen))
    return err;
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
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_merge((const float*)mid_d, (const int*)mid_i, Q, nchunks * k, k, (float*)out_d,
                      (int*)out_i, s);
}

long long knn_select_mid_elems(int Q, long long N, int k) { return select_mid_elems(Q, N, k); }

int knn_select_smem_pairs(void) { return SEL_SMEM_PAIRS; }

const char* knn_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

}  // extern "C"
