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
//   instances in knn_f32.cu so nvcc builds them in parallel): rowstream.cuh.
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

namespace {

// ------------------------------------------------------------------ tensor-core tier
constexpr int TQ_BM = 256;                 // rows a tile
constexpr int TQ_WM = TQ_BM / 32;          // warps along the rows
constexpr int TQ_THREADS = TQ_WM * 2 * 32;  // x 2 warps along the queries: 16 warps
constexpr int TQ_BN = 64;        // queries a query tile
constexpr int TQ_BK = 32;        // columns a step: two k16 steps
constexpr int TQ_STAGES = 3;     // cp.async ring: steps s + 1, s + 2 in flight while s runs
constexpr int TQ_P = TQ_BK + 8;  // bf16 a staged row: 20 words, conflict-free fragments
constexpr int TQ_PW = TQ_P / 2;
constexpr int TQ_X = TQ_BM * TQ_P;            // bf16 of a stage's rows
constexpr int TQ_L = TQ_BN * TQ_P;            // bf16 of a stage's limb plane
constexpr int TQ_STAGE = TQ_X + 3 * TQ_L;     // bf16 of a stage
constexpr int TQ_RING = TQ_STAGES * TQ_STAGE * 2;
constexpr int TQ_TILE = TQ_BN * TQ_BM * 4;    // the tile's keys (distances for K1)
constexpr int TQ_SMEM = TQ_RING + TQ_TILE;    // + the lists where they fit
static_assert(TQ_BM * (TQ_BK / 8) % TQ_THREADS == 0, "the row copy takes whole turns");

int limb_pitch(int D) { return (D + 15) / 16 * 16; }
int pad_queries(int Q) { return (Q + TQ_BN - 1) / TQ_BN * TQ_BN; }

// limbs [3, Qp, Dp] bf16: q = l0 + l1 + l2 (finite q), zero past Q and D;
// qss [Qp] = |q|^2 in f32. A warp a query.
__global__ void __launch_bounds__(256) split_queries(const float* __restrict__ q, int Q, int Qp,
                                                     int D, int Dp,
                                                     unsigned short* __restrict__ limbs,
                                                     float* __restrict__ qss) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (j >= Qp) return;  // whole warps
  float s = 0.f;
  for (int c = lane; c < Dp; c += 32) {
    const float v = (j < Q && c < D) ? q[j * D + c] : 0.f;
    s = fmaf(v, v, s);
    float l0, l1, l2;
    split3(v, l0, l1, l2);
    limbs[j * Dp + c] = (unsigned short)(__float_as_uint(l0) >> 16);
    limbs[((long long)Qp + j) * Dp + c] = (unsigned short)(__float_as_uint(l1) >> 16);
    limbs[(2LL * Qp + j) * Dp + c] = (unsigned short)(__float_as_uint(l2) >> 16);
  }
  s = wsum(s);
  if (lane == 0) qss[j] = s;
}

// x[row] . q[j] as the f32 FMA chain over the columns (a non-finite product);
// out of line, so the epilogue keeps its registers
__device__ __noinline__ float tq_exact_dot(const unsigned short* __restrict__ x, long long row,
                                           const float* __restrict__ q, int j, int D) {
  float s = 0.f;
  for (int c = 0; c < D; ++c)
    s = fmaf(__uint_as_float((unsigned)x[row * D + c] << 16), q[(long long)j * D + c], s);
  return s;
}

// Warp (wm, wn) = (warp % TQ_WM, warp / TQ_WM) owns rows wm*32 .. +31 of a tile and
// queries wn*32 .. +31 of the query tile: fragments mt (16 rows) x nt (8
// queries); lane (g, t) holds rows g, g + 8 and queries 2t, 2t + 1 of
// each. Query tile blockIdx.x % nqt, rows [b * per, (b + 1) * per) with
// b = blockIdx.x / nqt. At a tile's end the distances go to the tile
// buffer [query][row]; K1 stores them, K2 offers them to the running top-k
// of each query, which warp w keeps for the queries w, w + 8, ...
template <int METRIC, bool FUSED>
__global__ void __launch_bounds__(TQ_THREADS, 1)
tq_kernel(const unsigned short* __restrict__ x, long long N, int D, int Dp,
          const unsigned short* __restrict__ limbs, const float* __restrict__ qss, int Qp,
          const float* __restrict__ q, int Q, const unsigned char* __restrict__ mask, int k,
          long long per, int nqt, int vec, int kept_smem, float* __restrict__ out,
          unsigned long long* kept, float* __restrict__ picks_d, int* __restrict__ picks_i) {
  // ring, then the tile buffer, then (kept_smem) the lists
  extern __shared__ __align__(16) unsigned short tq_smem[];
  __shared__ float xn[TQ_BM];
  __shared__ float s_qss[TQ_BN];
  __shared__ unsigned long long s_theta[TQ_BN];
  __shared__ unsigned long long s_slots[TQ_THREADS / 32][32];
  // [TQ_BN][TQ_BM], row r of query c at r ^ (((c >> 1) & 3) << 3): the
  // fragments' writes and the warps' row reads both hit 32 banks
  unsigned* tile = reinterpret_cast<unsigned*>(tq_smem + TQ_RING / 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp % TQ_WM, wn = warp / TQ_WM;
  const long long b = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * TQ_BN;
  const long long rb = b * per, re = min(N, rb + per);
  unsigned long long* kq =  // [TQ_BN][k]: shared memory while it fits, else global scratch
      kept_smem ? reinterpret_cast<unsigned long long*>(tq_smem + (TQ_RING + TQ_TILE) / 2)
                : kept + (long long)blockIdx.x * TQ_BN * k;
  for (int c = tid; c < TQ_BN; c += TQ_THREADS) {
    s_qss[c] = qss[q0 + c];
    s_theta[c] = PAD_PAIR;
  }
  if (FUSED)
    for (int e = tid; e < TQ_BN * k; e += TQ_THREADS) kq[e] = PAD_PAIR;
  __syncthreads();
  const int nk = (D + TQ_BK - 1) / TQ_BK;
  const long long tiles = re > rb ? (re - rb + TQ_BM - 1) / TQ_BM : 0;
  const long long steps = tiles * nk;

  // step s (tile s / nk, columns (s % nk) * 32 ..) into ring slot s % TQ_STAGES
  auto issue = [&](long long s) {
    if (s < steps) {
      unsigned short* st = tq_smem + (int)(s % TQ_STAGES) * TQ_STAGE;
      const long long row0 = rb + (s / nk) * TQ_BM;
      const int k0 = (int)(s % nk) * TQ_BK;
#pragma unroll
      for (int i = 0; i < TQ_BM * (TQ_BK / 8) / TQ_THREADS; ++i) {
        const int pc = tid + i * TQ_THREADS, r = pc >> 2, kk = k0 + (pc & 3) * 8;
        unsigned short* dst = st + r * TQ_P + (pc & 3) * 8;
        const long long row = row0 + r;
        if (vec) {  // D % 8 == 0 and x 16-byte aligned: a piece is all in or all out
          const bool in = row < re && kk < D;
          cp_async16(dst, in ? x + row * D + kk : x, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (row < re && kk + e < D) ? x[row * D + kk + e] : (unsigned short)0;
        }
      }
      for (int pc = tid; pc < 3 * TQ_BN * (TQ_BK / 8); pc += TQ_THREADS) {
        const int l = pc / (TQ_BN * 4), c = (pc >> 2) % TQ_BN;
        const int kk = k0 + (pc & 3) * 8;
        const bool in = kk < Dp;
        cp_async16(st + TQ_X + l * TQ_L + c * TQ_P + (pc & 3) * 8,
                   in ? limbs + ((long long)l * Qp + q0 + c) * Dp + kk : limbs, in ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float hi[2][4][4], lo[2][4][4];  // limb 0's sums, limbs 1 and 2's
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[i][j][e] = lo[i][j][e] = 0.f;
  float sq = 0.f;  // |x|^2 of row tid / 2 over columns (tid % 2) * 16 .. +15 of each step
  unsigned open = 0u;  // bit m: row row0 + 32 m + lane of the tile is not masked

  for (int s = 0; s < TQ_STAGES - 1; ++s) issue(s);
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<TQ_STAGES - 2>();
    __syncthreads();  // step s landed for every thread; step s - 1 is no longer read
    issue(s + TQ_STAGES - 1);
    const unsigned short* st = tq_smem + (int)(s % TQ_STAGES) * TQ_STAGE;
    if (FUSED && s % nk == 0) {  // the tile's mask bits, read now, used at its end
      const long long row0 = rb + (s / nk) * TQ_BM;
      open = 0u;
#pragma unroll
      for (int m = 0; m < TQ_BM / 32; ++m) {
        const long long row = row0 + 32 * m + lane;
        if (row < re && (mask == nullptr || mask[row])) open |= 1u << m;
      }
    }
    {
      const unsigned short* xr = st + (tid >> 1) * TQ_P + (tid & 1) * 16;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float v = __uint_as_float((unsigned)xr[e] << 16);
        sq = fmaf(v, v, sq);
      }
    }
    const unsigned* xw = reinterpret_cast<const unsigned*>(st);
    const unsigned* lw = reinterpret_cast<const unsigned*>(st + TQ_X);
#pragma unroll
    for (int ks = 0; ks < TQ_BK / 16; ++ks) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned* base = xw + (wm * 32 + mt * 16 + g) * TQ_PW + ks * 8 + t;
        a[mt][0] = base[0];
        a[mt][1] = base[8 * TQ_PW];
        a[mt][2] = base[4];
        a[mt][3] = base[8 * TQ_PW + 4];
      }
#pragma unroll
      for (int l = 2; l >= 0; --l) {  // the smaller limbs first
        unsigned bq[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned* base = lw + l * (TQ_L / 2) + (wn * 32 + nt * 8 + g) * TQ_PW + ks * 8 + t;
          bq[nt][0] = base[0];
          bq[nt][1] = base[4];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(l == 0 ? hi[mt][nt] : lo[mt][nt], a[mt], bq[nt]);
      }
    }
    if (s % nk != nk - 1) continue;
    // the tile's last step: its distances
    const long long row0 = rb + (s / nk) * TQ_BM;
    sq += __shfl_xor_sync(FULL, sq, 1);
    if ((tid & 1) == 0) xn[tid >> 1] = sq;
    sq = 0.f;
    __syncthreads();  // xn complete; the tile buffer's last reads are done
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * 32 + mt * 16 + g + 8 * (e >> 1);
          const int c = wn * 32 + nt * 8 + 2 * t + (e & 1);
          float dot = hi[mt][nt][e] + lo[mt][nt][e];
          hi[mt][nt][e] = lo[mt][nt][e] = 0.f;
          const long long row = row0 + r;
          if (row < re && q0 + c < Q && !finite_f(dot)) dot = tq_exact_dot(x, row, q, q0 + c, D);
          const float d = pw_finish<METRIC>(s_qss[c], xn[r], dot, 0.f, 0.f);
          tile[c * TQ_BM + (r ^ (((c >> 1) & 3) << 3))] = FUSED ? f2key(d) : __float_as_uint(d);
        }
    __syncthreads();
    // warp w takes the queries w, w + 16, ... (its lists, no other warp's),
    // a query's candidates of the tile gathered into one insert
    for (int c = warp; c < TQ_BN; c += TQ_THREADS / 32) {
      const int qi = q0 + c;
      if (qi >= Q) break;  // uniform: the queries past Q
      Batch bt{s_slots[warp], 0};
      unsigned long long th = s_theta[c];
#pragma unroll
      for (int m = 0; m < TQ_BM / 32; ++m) {
        const long long row = row0 + 32 * m + lane;
        const unsigned v = tile[c * TQ_BM + ((32 * m + lane) ^ (((c >> 1) & 3) << 3))];
        if (FUSED) {
          unsigned long long cp = PAD_PAIR;
          if (row < re) cp = pair_of((open >> m) & 1u ? v : INF_KEY, row);
          batch_add(kq + c * k, k, th, s_theta[c], bt, cp);
        } else if (row < re) {
          out[(long long)qi * N + row] = __uint_as_float(v);
        }
      }
      if (FUSED) {
        batch_flush(kq + c * k, k, th, bt);
        s_theta[c] = th;
      }
    }
  }
  cp_async_wait<0>();
  if (!FUSED) return;
  const long long nblk = gridDim.x / nqt;
  for (int c = warp; c < TQ_BN && q0 + c < Q; c += TQ_THREADS / 32) {
    const long long o = ((long long)(q0 + c) * nblk + b) * k;
    for (int i = lane; i < k; i += 32) {
      const unsigned long long v = kq[c * k + i];
      picks_d[o + i] = key2f((unsigned)(v >> 32));
      picks_i[o + i] = (int)(unsigned)(v & 0xFFFFFFFFull);
    }
  }
}

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

// ------------------------------------------------------------------ launch plans
bool tensor_tier(int Q, int x_bf16, int metric) {
  return Q > 8 && x_bf16 && (metric == M_EUCLIDEAN || metric == M_COSINE);
}

long long align256(long long v) { return (v + 255) / 256 * 256; }

KnnPlan make_plan(int Q, long long N, int D, int k, int x_bf16, int metric, bool fused) {
  KnnPlan pl{};
  pl.tq = tensor_tier(Q, x_bf16, metric);
  const long long sms = sm_count();
  if (pl.tq) {
    pl.qt = TQ_BN;
    pl.Qp = pad_queries(Q);
    pl.nqt = pl.Qp / TQ_BN;
    pl.Dp = limb_pitch(D);
    pl.nblk = min(sms, (N + TQ_BM - 1) / TQ_BM);
  } else {
    pl.qt = Q == 1 ? 1 : 8;
    pl.nqt = (Q + pl.qt - 1) / pl.qt;
    pl.nblk = min(sms, (N + ST_MIN_ROWS - 1) / ST_MIN_ROWS);
  }
  pl.per = (N + pl.nblk - 1) / pl.nblk;
  const long long blocks = pl.nblk * pl.nqt;
  long long off = 0;
  if (fused) {
    pl.picks_d = off;
    off = align256(off + (long long)Q * pl.nblk * k * 4);
    pl.picks_i = off;
    off = align256(off + (long long)Q * pl.nblk * k * 4);
    pl.kept = off;
    off = align256(off + blocks * (pl.tq ? TQ_BN : WARPS * pl.qt) * (long long)k * 8);
  }
  if (pl.tq) {
    pl.limbs = off;
    off = align256(off + 3LL * pl.Qp * pl.Dp * 2);
    pl.qss = off;
    off = align256(off + (long long)pl.Qp * 4);
  }
  pl.bytes = off;
  return pl;
}

template <int M, bool FUSED>
int launch_tq(const KnnPlan& pl, const float* q, const unsigned short* x, int Q, long long N, int D,
              const unsigned char* mask, int k, float* out, unsigned char* scratch,
              cudaStream_t s) {
  static std::atomic<unsigned> seen{0};
  unsigned short* limbs = reinterpret_cast<unsigned short*>(scratch + pl.limbs);
  float* qss = reinterpret_cast<float*>(scratch + pl.qss);
  split_queries<<<(unsigned)((pl.Qp + 7) / 8), 256, 0, s>>>(q, Q, pl.Qp, D, pl.Dp, limbs, qss);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (int err = opt_in_smem(tq_kernel<M, FUSED>, SMEM_MAX, seen)) return err;
  const int vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int lists = FUSED ? TQ_BN * k * 8 : 0;
  const int kept_smem = FUSED && TQ_SMEM + lists <= SMEM_MAX;
  const int smem = TQ_SMEM + (kept_smem ? lists : 0);
  unsigned long long* kept = FUSED ? reinterpret_cast<unsigned long long*>(scratch + pl.kept) : nullptr;
  float* pd = FUSED ? reinterpret_cast<float*>(scratch + pl.picks_d) : nullptr;
  int* pi = FUSED ? reinterpret_cast<int*>(scratch + pl.picks_i) : nullptr;
  tq_kernel<M, FUSED><<<(unsigned)(pl.nblk * pl.nqt), TQ_THREADS, smem, s>>>(
      x, N, D, pl.Dp, limbs, qss, pl.Qp, q, Q, mask, k, pl.per, pl.nqt, vec, kept_smem, out, kept,
      pd, pi);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int tq_dispatch(int metric, const KnnPlan& pl, const float* q, const unsigned short* x, int Q,
                long long N, int D, const unsigned char* mask, int k, float* out,
                unsigned char* scratch, cudaStream_t s) {
  if (metric == M_EUCLIDEAN)
    return launch_tq<M_EUCLIDEAN, FUSED>(pl, q, x, Q, N, D, mask, k, out, scratch, s);
  return launch_tq<M_COSINE, FUSED>(pl, q, x, Q, N, D, mask, k, out, scratch, s);
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
  return stream_dispatch<__nv_bfloat16>(FUSED, metric, pl, qf, (const __nv_bfloat16*)x, Q, N, D,
                                        p, qm, xm, mk, k, (float*)out, sc, s);
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
