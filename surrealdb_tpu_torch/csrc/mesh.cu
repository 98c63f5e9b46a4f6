// Mesh kernels for Hopper (sm_90a), behind the same plain C interface as
// knn.cu (one library, loaded with ctypes by surrealdb_tpu_torch/ops/_cuda.py).
// They serve surrealdb_tpu_torch/parallel/mesh.py, the port of
// surrealdb_tpu/parallel/mesh.py, whose shard_map programs run here as one
// launch a shard, or (K12, K14) one launch over all the shards a card holds: a
// shard is a view of one tensor when the shards share a card, a copy on its
// own card otherwise.
//
// mesh_topk_merge is the merge of K11 sharded_knn, K12 sharded_knn_2d and
// K13 _ivf_searcher (and of K3's rerank, as one shard): after the
// all-gather of every shard's kk candidates into d_all / i_all [Q, S*kk]
// (shard order), lax.top_k(-d_all, k_out) and
// the take of the ids, with the id arithmetic done here: a candidate at
// position p belongs to shard p / kk, and its global id is its local id +
// shard * shard_rows (K11, K12: always, so a shard's +inf picks keep their
// ids, as the reference returns them; K3, K13: only where the distance is
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
// K13's rerank is K3's ivf_rerank (ivf.cu) over the S shards a card holds,
// one launch; mesh_topk_merge above finishes it.
//
// mesh_frontier_hop is K14 sharded_frontier_hop's gather, one launch over
// the whole frontier of a card (parallel/mesh.py hands it every shard at
// once when the shards are views of one tensor): for each (frontier row f,
// offset o < max_degree), start = indptr[fr], deg = indptr[fr + 1] - start
// (int32, wrapping as the reference's), valid = o < deg && mask[f], and the
// neighbour indices[clip(start + o, 0, E - 1)], with JAX's gather index rule
// for fr and fr + 1 (a negative index wraps once, then clamps into [0, V])
// so padded frontier entries read what the reference reads, and invalid
// entries carry their neighbour too. What bounds it: the bytes (the outputs,
// 5 a slot, and the rows' index windows); at config 1's last hop one short
// wave, so the launch and its dependent loads. Design: a block a window of
// HOP_WINDOW consecutive outputs; the rows the window touches are read once
// (frontier, mask, both pointers) into shared memory, a thread a row; then a
// thread takes 4 consecutive outputs at a time: one 32-bit division a quad,
// none an output, the index reads of neighbouring threads consecutive, the
// neighbours stored as one 16-byte store and the valid flags as one 32-bit
// store where the outputs are aligned (else byte by byte). Windows cut rows
// anywhere, so no lane idles at a max_degree that is not a power of two (as
// a group of lanes a row would) and the flags pack across row ends.
//
// mesh_dedup_frontier is K15 dedup_frontier: marks = zeros(n_nodes + 1),
// marks[where(mask, nodes, n_nodes)] = 1 with JAX's scatter rule (a negative
// index wraps once; one still out of range is dropped), marks[n_nodes] = 0,
// then the ascending ids of the marked nodes, size F, padded with n_nodes,
// and their mask (id < n_nodes). What bounds it: reading the entries and
// writing F ids and flags (bytes). Design: two launches from one call over a
// scratch the caller keeps zero between calls (parallel/mesh.py
// DedupScratch): a bitmap of the nodes, a bit a node, and lookback.cuh's
// state. dedup_mark writes every output's padding (n_nodes, 0) on its pass
// over the entries and sets their bits with atomicOr: a bitmap of at most
// DD_SMEM_WORDS words is marked in each block's shared memory first, so the
// repeated ids of a hop meet shared memory and only a block's new words
// reach L2 (at config 1, ~10^6 entries over 313 words, ors straight into L2
// queue on those words and took over ten times as long, PERF.md §6); a
// larger one is marked in place, an or only where a read finds the bit
// clear. dedup_compact, a block a tile of DD_THREADS words, a thread a word,
// ranks the marked nodes by their words' popcounts, a block scan and
// lookback.cuh's one-pass decoupled look-back, clears each word behind its
// read, and writes the ids ascending over the padding, a warp a word. No
// memset, and nothing the size of n_nodes allocated, a call; the caller
// clears the scratch only after a failed call.

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
#include "lookback.cuh"

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
// output slot. With finite_only and no NaN among them, every non-finite
// candidate comes out as (+inf, -1) after the finite ones, so only the
// finite ones are ranked and the rest of the row is filled: a K3 / K13
// merge whose k_out is above the probed candidates ranks those alone.
__global__ void __launch_bounds__(MG_THREADS)
topk_merge_rank_kernel(const float* __restrict__ d_all, const int* __restrict__ i_all, int M,
                       int kk, long long shard_rows, int k_out, int finite_only,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ unsigned keys_smem[];
  __shared__ int s_finite, s_nan;
  const long long row = blockIdx.x;
  const float* d = d_all + row * M;
  const int* ids = i_all + row * M;
  const bool staged = M <= MG_SMEM_KEYS;
  if (threadIdx.x == 0) s_finite = s_nan = 0;
  __syncthreads();
  int fin = 0, nan = 0;
  for (int j = threadIdx.x; j < M; j += MG_THREADS) {
    const unsigned kj = f2key(d[j]);
    if (staged) keys_smem[j] = kj;
    fin += kj < INF_KEY;
    nan += kj > INF_KEY;
  }
  atomicAdd(&s_finite, fin);
  atomicAdd(&s_nan, nan);
  __syncthreads();
  const bool skip = finite_only && s_nan == 0;  // the non-finite picks all read (+inf, -1)
  for (int p = threadIdx.x; p < M; p += MG_THREADS) {
    const unsigned kp = staged ? keys_smem[p] : f2key(d[p]);
    if (skip && kp >= INF_KEY) continue;
    int rank = 0;
    for (int j = 0; j < M && rank < k_out; ++j) {
      const unsigned kj = staged ? keys_smem[j] : f2key(d[j]);
      rank += (kj < kp) || (kj == kp && j < p);
    }
    if (rank < k_out)
      merge_pick(d, ids, p, kk, shard_rows, finite_only, out_d + row * k_out + rank,
                 out_i + row * k_out + rank);
  }
  if (skip)
    for (int r = s_finite + threadIdx.x; r < k_out; r += MG_THREADS) {
      out_d[row * k_out + r] = __uint_as_float(0x7f800000u);
      out_i[row * k_out + r] = -1;
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

// ------------------------------------------------------------------ K14

constexpr int HOP_THREADS = 256;
constexpr int HOP_QUADS = 2;                                // output quads a thread a window
constexpr int HOP_WINDOW = 4 * HOP_QUADS * HOP_THREADS;    // outputs a block a window
constexpr int HOP_MAX_ROWS = HOP_WINDOW + 1;               // rows a window touches, at most

// JAX's gather rule for one index into n entries: a negative index wraps
// once, then the result clamps into [0, n - 1]
__device__ __forceinline__ long long gather_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// out_nb / out_valid [F * md]: window w covers outputs [w * HOP_WINDOW, +
// HOP_WINDOW); `aligned`: out_nb 16-byte and out_valid 4-byte aligned.
__global__ void __launch_bounds__(HOP_THREADS)
frontier_hop_kernel(const int* __restrict__ indptr, long long V1, const int* __restrict__ indices,
                    long long E, const int* __restrict__ frontier,
                    const unsigned char* __restrict__ fmask, long long F, int max_degree,
                    int aligned, int* __restrict__ out_nb, unsigned char* __restrict__ out_valid) {
  __shared__ int s_start[HOP_MAX_ROWS];
  __shared__ int s_lim[HOP_MAX_ROWS];  // deg where the row is live, else 0: valid = o < lim
  const long long total = F * max_degree;
  const long long windows = (total + HOP_WINDOW - 1) / HOP_WINDOW;
  const unsigned md = (unsigned)max_degree;
  for (long long w = blockIdx.x; w < windows; w += gridDim.x) {
    const long long w0 = w * HOP_WINDOW;
    const long long r0 = w0 / max_degree;  // a division a window
    const unsigned o0 = (unsigned)(w0 - r0 * max_degree);
    const long long r_end = (w0 + HOP_WINDOW - 1) / max_degree + 1;
    const int rows = (int)((r_end < F ? r_end : F) - r0);
    for (int i = threadIdx.x; i < rows; i += HOP_THREADS) {
      const int fr = frontier[r0 + i];
      const int start = indptr[gather_index(fr, V1)];
      // int32 arithmetic wraps as the reference's does
      const int end = indptr[gather_index((int)((unsigned)fr + 1u), V1)];
      s_start[i] = start;
      s_lim[i] = fmask[r0 + i] ? (int)((unsigned)end - (unsigned)start) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < HOP_QUADS; ++q) {
      const unsigned rel = 4u * (unsigned)(q * HOP_THREADS + threadIdx.x);
      const long long t0 = w0 + rel;
      if (t0 >= total) break;
      const unsigned u = o0 + rel;  // < md + HOP_WINDOW <= 2^31 + HOP_WINDOW
      int row = (int)(u / md);
      unsigned o = u - (unsigned)row * md;
      int nb[4];
      unsigned vb = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (t0 + e < total) {
          const int take = (int)((unsigned)s_start[row] + o);
          const long long safe = take < 0 ? 0 : (take > E - 1 ? E - 1 : take);
          nb[e] = indices[safe];
          vb |= ((int)o < s_lim[row] ? 1u : 0u) << (8 * e);
        }
        if (++o == md) {
          o = 0u;
          ++row;
        }
      }
      if (aligned && t0 + 3 < total) {
        *reinterpret_cast<int4*>(out_nb + t0) = int4{nb[0], nb[1], nb[2], nb[3]};
        *reinterpret_cast<unsigned*>(out_valid + t0) = vb;
      } else {
        for (int e = 0; e < 4 && t0 + e < total; ++e) {
          out_nb[t0 + e] = nb[e];
          out_valid[t0 + e] = (unsigned char)((vb >> (8 * e)) & 1u);
        }
      }
    }
    __syncthreads();  // the rows of the next window overwrite these
  }
}

// ------------------------------------------------------------------ K15

constexpr int DD_THREADS = 256;          // a block; a compaction tile: DD_THREADS bitmap words
static_assert(DD_THREADS == GRID_THREADS, "grid_for sizes the unshared marking's grid");
constexpr int DD_SMEM_WORDS = 4096;      // bitmaps marked in shared memory first: 131,072 nodes
constexpr int DD_BATCH = 8;              // entries a thread loads before it marks them (shared)
constexpr int DD_ROUNDS_A_BLOCK = 2;     // rounds a marking block takes, at least (shared path)
constexpr int DD_BLOCKS_AN_SM = 2;       // marking blocks an SM at most (shared path)

// The bitmap's words: a bit a node, in whole compaction tiles.
long long dedup_words(long long n_nodes) {
  const long long used = (n_nodes + 31) / 32;
  return (used + DD_THREADS - 1) / DD_THREADS * DD_THREADS;
}

// out_nodes / out_mask [F] = (n_nodes, 0), and bit v of `bits` set for each
// v = where(mask, nodes, n_nodes) under JAX's scatter rule over n_nodes + 1
// slots, slot n_nodes left clear (the reference clears it). SMEM: a thread
// loads DD_BATCH entries a round (coalesced: the round's entries
// thread-minor) before it marks them, so their loads are in flight
// together, in a shared bitmap of `used` words; then the block's words with
// a bit not yet in `bits` are or-ed in. Else a thread an entry, whose bit is
// or-ed in where a read of its word finds it clear: ids repeat many times a
// hop and ors of one word queue at L2, so the reads are the cheap side, and
// the grid's later waves find most bits set (batched into one wave, every
// read came before any or and the marking took longer, PERF.md §6). The
// ors' old values are not read, so no thread waits on them.
template <bool SMEM>
__global__ void __launch_bounds__(DD_THREADS)
dedup_mark(const int* __restrict__ nodes, const unsigned char* __restrict__ mask, long long F,
           int n_nodes, int used, unsigned* __restrict__ bits, int* __restrict__ out_nodes,
           unsigned char* __restrict__ out_mask) {
  extern __shared__ unsigned dd_bits[];  // SMEM: [used]
  if (SMEM) {
    for (int w = threadIdx.x; w < used; w += DD_THREADS) dd_bits[w] = 0u;
    __syncthreads();
  }
  constexpr int B = SMEM ? DD_BATCH : 1;
  for (long long i0 = (long long)blockIdx.x * DD_THREADS * B; i0 < F;
       i0 += (long long)gridDim.x * DD_THREADS * B) {
    long long v[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const long long i = i0 + k * DD_THREADS + threadIdx.x;
      v[k] = -1;  // past F: wraps to slot n_nodes, which is never marked
      if (i < F) {
        const int nd = nodes[i];
        v[k] = mask[i] ? (long long)nd : (long long)n_nodes;
        out_nodes[i] = n_nodes;
        out_mask[i] = 0;
      }
    }
    unsigned seen[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (v[k] < 0) v[k] += (long long)n_nodes + 1;
      if (!(v[k] >= 0 && v[k] < n_nodes)) v[k] = -1;  // dropped
      if (!SMEM) seen[k] = v[k] >= 0 ? __ldcg(bits + (v[k] >> 5)) : ~0u;
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (v[k] < 0) continue;
      const unsigned bit = 1u << (v[k] & 31);
      if (SMEM)
        atomicOr(&dd_bits[v[k] >> 5], bit);
      else if ((seen[k] & bit) == 0u)
        atomicOr(&bits[v[k] >> 5], bit);
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int w = threadIdx.x; w < used; w += DD_THREADS) {
      const unsigned b = dd_bits[w];
      if (b != 0u && (__ldcg(bits + w) & b) != b) atomicOr(&bits[w], b);
    }
  }
}

// The marked nodes of a tile of the bitmap, in ascending id order, at their
// ranks among all tiles' (truncated at out_size): out_nodes = node, out_mask
// = 1. Every word read is left zero. A thread a word counts its bits; the
// words' counts are scanned over the block and the tile's offset comes from
// the look-back; then a warp a word, a lane a bit, writes the marked nodes at
// their ranks: consecutive nodes, so the stores coalesce however densely a
// tile is marked.
__global__ void __launch_bounds__(DD_THREADS)
dedup_compact(unsigned* __restrict__ bits, int tiles, int out_size, int* __restrict__ out_nodes,
              unsigned char* __restrict__ out_mask, unsigned long long* state) {
  __shared__ unsigned s_word[DD_THREADS], s_base[DD_THREADS];
  const int tile = lb_tile(state);
  const long long w0 = (long long)tile * DD_THREADS;
  const unsigned word = bits[w0 + threadIdx.x];
  if (word != 0u) bits[w0 + threadIdx.x] = 0u;
  s_word[threadIdx.x] = word;
  const unsigned mine = __popc(word);
  unsigned count;
  s_base[threadIdx.x] = block_scan<DD_THREADS>(mine, &count) - mine;
  const long long before = (long long)lb_offset(state, tile, count);  // syncs the block
  const int lane = threadIdx.x & 31;
  for (int wi = threadIdx.x >> 5; wi < DD_THREADS; wi += DD_THREADS / 32) {
    const unsigned tw = s_word[wi];
    if (((tw >> lane) & 1u) == 0u) continue;
    const long long r = before + s_base[wi] + __popc(tw & ((1u << lane) - 1u));
    if (r < out_size) {
      out_nodes[r] = (int)((w0 + wi) * 32 + lane);
      out_mask[r] = 1;
    }
  }
  lb_finish(state, tiles, nullptr);
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

// indptr [V1] i32, indices [E] i32, frontier [F] i32, fmask [F] u8;
// out_nb / out_valid [F * max_degree] i32 / u8. One launch.
int mesh_frontier_hop(const void* indptr, long long V1, const void* indices, long long E,
                      const void* frontier, const void* fmask, long long F, int max_degree,
                      void* out_nb, void* out_valid, void* stream) {
  if (V1 <= 0 || E <= 0 || F < 0 || max_degree <= 0) return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  const long long windows = (F * max_degree + HOP_WINDOW - 1) / HOP_WINDOW;
  const int aligned = ((uintptr_t)out_nb % 16 == 0) && ((uintptr_t)out_valid % 4 == 0);
  frontier_hop_kernel<<<(unsigned)(windows < 65536 ? windows : 65536), HOP_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const int*)indptr, V1, (const int*)indices, E, (const int*)frontier,
      (const unsigned char*)fmask, F, max_degree, aligned, (int*)out_nb,
      (unsigned char*)out_valid);
  return (int)cudaGetLastError();
}

// nodes [F] i32, mask [F] u8; out_nodes [F] i32, out_mask [F] u8. Scratch,
// zero and left zero: bits [mesh_dedup_bitmap_words(n_nodes)] u32, state
// [mesh_dedup_state_entries(n_nodes)] u64; `clear` zeroes them first (the
// caller's scratch after a failed call). Two launches.
int mesh_dedup_frontier(const void* nodes, const void* mask, int F, int n_nodes, void* bits,
                        void* state, int clear, void* out_nodes, void* out_mask, void* stream) {
  if (F <= 0 || n_nodes < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long words = dedup_words(n_nodes);
  const int tiles = (int)(words / DD_THREADS);
  const int used = (int)(((long long)n_nodes + 31) / 32);
  cudaError_t e;
  if (clear &&
      ((e = cudaMemsetAsync(bits, 0, (size_t)words * sizeof(unsigned), s)) != cudaSuccess ||
       (e = cudaMemsetAsync(state, 0, (size_t)(2 + tiles) * sizeof(unsigned long long), s)) !=
           cudaSuccess))
    return (int)e;
  if (used <= DD_SMEM_WORDS) {
    const long long per_block = (long long)DD_ROUNDS_A_BLOCK * DD_THREADS * DD_BATCH;
    long long grid = (F + per_block - 1) / per_block;
    if (grid > DD_BLOCKS_AN_SM * sm_count()) grid = DD_BLOCKS_AN_SM * sm_count();
    dedup_mark<true><<<(unsigned)grid, DD_THREADS, (size_t)used * sizeof(unsigned), s>>>(
        (const int*)nodes, (const unsigned char*)mask, F, n_nodes, used, (unsigned*)bits,
        (int*)out_nodes, (unsigned char*)out_mask);
  } else {
    dedup_mark<false><<<grid_for(F), DD_THREADS, 0, s>>>(
        (const int*)nodes, (const unsigned char*)mask, F, n_nodes, used, (unsigned*)bits,
        (int*)out_nodes, (unsigned char*)out_mask);
  }
  if ((e = cudaGetLastError()) != cudaSuccess || tiles == 0) return (int)e;
  dedup_compact<<<(unsigned)tiles, DD_THREADS, 0, s>>>((unsigned*)bits, tiles, F,
                                                        (int*)out_nodes, (unsigned char*)out_mask,
                                                        (unsigned long long*)state);
  return (int)cudaGetLastError();
}

long long mesh_dedup_bitmap_words(long long n_nodes) { return dedup_words(n_nodes); }

long long mesh_dedup_state_entries(long long n_nodes) {
  return 2 + dedup_words(n_nodes) / DD_THREADS;
}

}  // extern "C"
