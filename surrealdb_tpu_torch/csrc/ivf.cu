// IVF kernels for Hopper (sm_90a), behind the same plain C interface as
// knn.cu (one library, loaded with ctypes by surrealdb_tpu_torch/ops/_cuda.py).
//
// K5 ivf_assign replaces surrealdb_tpu/idx/ivf.py:_assign_chunk and
// _assign_gather (and the assignment half of K4 _kmeans_step): the nearest
// centroid (k = 1, jnp.argmin) or the two nearest (k = 2, lax.top_k(-d, 2))
// of each row, by the reference's euclidean formula
// sqrt(max(|x|^2 + |c|^2 - 2 x.c, 0)), compared after the sqrt, lower
// centroid index first on a tie. An optional int32 index vector picks the
// rows from the corpus inside the kernel (clipped to [0, cap-1], as the
// reference clips), so the gathered rows never reach device memory. What
// bounds it: 2*n*C*D operations against n*D row bytes (C = 1024: ~1000
// operations a row byte, above the card's ridge), so the operations.
//
// bf16 rows (the corpus as the card holds it; the main path): on the
// tensor cores, f32-accurate. split_centroids splits each f32 centroid once
// a launch, by truncation, into three bf16 limbs, c = c0 + c1 + c2
// exactly, as planes [3, C, Dp] (Dp = D rounded up to 16, zero-padded),
// and writes |c|^2 in f32. A bf16 row is exact, so x.c = x.c0 + x.c1 +
// x.c2: each limb product is exact in f32 and mma.sync.m16n8k16 (bf16 ->
// f32) sums them. The order of the sums matters: a lower limb's product
// added to a sum of the full dot's size loses its low bits, and a single
// sum over all three limbs, step by step, picked the farther centroid
// where limb 2 alone tells two apart (the lower-limb checks, emulated and
// on the H100). So a tile takes two passes over the columns: limbs 2 and
// 1 first, while the sums are about 2^-8 of the dot, then limb 0 on top,
// and the result differs from an FMA chain by about what another order of
// f32 sums gives.
// assign_tc_kernel: a block owns 256 rows and walks the centroids in
// tiles of 128; each step stages 32 columns of the rows and of one pass's
// limb planes (two, or limb 0's one) by 16-byte cp.async into a 3-slot
// ring (rows through the index vector; a D that is not a multiple of 8, or
// an unaligned corpus, is staged by plain loads), with a 20-word row pitch
// so every fragment load is one conflict-free 32-bit read. 16 warps, 4
// along the rows x 4 along the centroids, each a 64 x 32 tile of f32 sums,
// run the pass's limb planes on one row fragment. |x|^2 is summed in f32
// from the staged rows during the first pass. At a tile's
// last step the epilogue turns the sums into distances in registers; a
// lane keeps the best-2 of its 8 centroids, the four lanes of a fragment
// quad merge theirs by shuffles, and one lane merges the result into the
// column warp's running best-2 of the row in shared memory, in (distance,
// index) order; a candidate whose squared distance exceeds the kept
// second's is skipped before its sqrt. At the end the four column warps'
// best-2 merge, so no [n, C] distance matrix reaches device memory. 256
// rows a block halve the L2 reads of the limb planes against 128 (each
// block reads every plane once a tile). Non-finite values: a limb split of
// inf or NaN is not (v, 0, 0), and a zero limb meeting inf gives NaN where
// f32 gives inf, so a row that met a non-finite product is flagged, and
// after the tiles a warp recomputes all its distances as f32 FMA chains
// (fma_dot), which is what the CUDA-core kernel and f32 give; finite rows
// and centroids stay on the tensor cores. The recompute stays out of the
// epilogue: a call there cost the main loop registers.
// What holds it back: mma.sync reaches about half of wgmma's rate; the
// sums take 64 of a thread's 128 registers at 16 warps, and builds with
// parts patched out showed the epilogue's code (more than its running)
// slowing the main loop; the fragments and the limb planes pass through
// shared memory and L2 for every block, and the rows twice a tile (once a
// pass). A wgmma/TMA version, its sums in the warpgroup's registers, is the
// follow-up.
//
// f32 rows (x_bf16 = 0; no caller on the main path, whose corpus is bf16)
// keep the CUDA-core kernel, assign_f32_kernel: a block owns 64 rows and
// walks the centroids in tiles of 64; each step stages 32 columns of the
// rows and of the centroid tile in shared memory (transposed), each of the
// 256 threads keeps a 4x4 tile of FMA chains in registers and a running
// best-2 per row, and 16 lanes merge theirs with shuffles at the end.
//
// K4 ivf_kmeans_update replaces the update half of
// surrealdb_tpu/idx/ivf.py:_kmeans_step (segment_sum of the rows and of
// ones by assignment, the mean, an empty cluster keeping its centroid).
// What bounds it: reading the n rows once (bytes; 0.032 ms for 65,536 x
// 768 bf16 rows at 3.35 TB/s). The rows are grouped by centroid once, then
// each row is read once. Three launches, no float atomics, no host sync,
// scratch from the wrapper (ivf_kmeans_update_scratch_bytes):
// 1. up_count_kernel: a block a tile of the assignment (2,048 entries; more
//    above 65,536 rows, so there are at most 32 tiles) counts its entries a
//    centroid in shared memory (a warp's equal entries added once, found by
//    __match_any_sync) -> hist [tile, C].
// 2. up_scatter_kernel: every block sums all tiles' counts and scans them
//    (the same sums in every block, so no block waits for another): each
//    centroid's first position start [C + 1] and, with one work item per
//    UP_ITEM (128) members or part of it (one for an empty centroid), its
//    first item istart [C + 1]. Then it scatters its own tile's row ids
//    into order [n] stably: the warps take turns in entry order, and a
//    warp's equal entries take consecutive positions in lane order, so
//    order holds the rows grouped by centroid, in row order within one.
//    Each block also writes its share of start, istart, counts and the
//    item -> centroid map, and zeroes its share of the tickets.
// 3. up_sum_kernel: a block a work item (at most UP_ITEM consecutive
//    members of one centroid, so a heavy centroid spreads over many SMs);
//    a thread a 16-byte column vector (8 bf16 or 4 f32 values; one value
//    where D or the rows' alignment rules 16-byte loads out) walks the
//    item's rows with UP_LOADS (8) loads in flight and adds them in member
//    order into f32 registers. A centroid of one item writes its mean
//    (c_old when it is empty). The items of a heavier centroid write f32
//    partial sums; the last of them to finish (an integer ticket a
//    centroid) adds the partials in item order and writes the mean.
// Summation order, the same bits on every run: a centroid's rows in row
// order, cut into consecutive runs of UP_ITEM; each run summed in f32 from
// 0.0f in row order (adds only, nothing to fuse into an FMA); one run: its
// sum / count; more runs: 0.0f + run 0 + run 1 + ... in f32, then / count.
// An assignment entry outside [0, C) belongs to no centroid: it is neither
// counted nor summed. Limits: n < 2^31 and C <= 19,028 (launch 2 holds 3 C
// + 2 ints in shared memory).
// What holds it back (H100, 65,536 x 768 bf16 rows, C = 1,024): launch 3
// is one wave of ~1,300 short blocks, so its ramp, its tail and the three
// dependent index loads before a block's first row weigh on a stream of a
// few tens of microseconds; 16 loads in flight a thread (fewer blocks an
// SM), 64- or 256-member items and rows in row order did not move it
// (scripts/k4_update_variants.py).
// Launch 2's warp turns are serial (64 a tile), and it reads every tile's
// counts from L2 in each block.
//
// K3 ivf_rerank replaces the rerank of surrealdb_tpu/idx/ivf.py:_ivf_search
// (its probe is K2 over the centroids, its top-k the merge after it), and
// with S shards K13's rerank (surrealdb_tpu/parallel/mesh.py _ivf_searcher):
// per (query, shard, probe rank), the probed list's members that are listed
// (list_mask) and slot_ok, ranked by `metric` in (distance, position pr * L
// + j) order, top-kk, slots local to the shard. One launch, no [Q, nprobe *
// L] scratch, the slots mapped in the kernel; mesh_topk_merge (mesh.cu)
// finishes. What bounds it: the bytes are each distinct probed list's rows
// read once (0.21 ms at the HNSW cell's Q = 64), and the products, a
// (query, member) pair each (8.6 GFLOP there, 0.13 ms at the f32 peak), are
// below that at full rate; but each product is a lane-split FMA chain and
// a five-step shuffle sum, in the reference formula's order, so on the
// card the products bound it (about 90 SM cycles a pair in the pair-major
// mode, PERF.md §6). Two modes, the same picks bit for bit (one distance
// arithmetic, one pick layout):
// - pair-major (rerank_pairs_kernel): a block a (query, shard, probe rank,
//   contiguous range of the list's extent), the ranges chosen so the
//   launch has about four blocks an SM; live rows are read from global
//   memory a warp a row, four at once, and each warp keeps a running top-k
//   (knn.cuh's warp lists). A row is read, converted and its norm summed
//   once a (query, probe) pair.
// - list-major (rerank_lists_kernel): the pairs are grouped by list inside
//   the launch (a sort of (list, pair) keys in shared memory, the same in
//   every block); persistent blocks take (group of up to 32 pairs,
//   1,024-position range) items from a ticket, the heaviest groups first;
//   the range's live rows are staged once into shared memory by 16-byte
//   cp.async, two stages in flight, converted and their norms summed once,
//   and scored there against every query of the group, so a list's rows
//   are read once a tile (once a group when more than 32 pairs probe it).
// ivf_rerank_plan chooses: list-major from LM_MIN_Q (16) queries where its
// shared memory fits (D <= 768), else pair-major; measured on the H100 at
// the HNSW cell's shapes, pair-major wins at 8 queries and list-major from
// 16 (PERF.md §6).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "metric.cuh"
#include "mma.cuh"
#include "rowstream.cuh"
#include "knn.cuh"

namespace {

// ------------------------------------------------------------------ K5

constexpr int AS_THREADS = 256;
constexpr int AS_TR = 64;            // rows a block
constexpr int AS_TC = 64;            // centroids a tile
constexpr int AS_DK = 32;            // columns staged a step
constexpr int AS_PAD = AS_TR + 4;    // row stride of the staged tiles (16-byte aligned)
constexpr int INT_BIG = 0x7fffffff;

__device__ __forceinline__ bool lex_lt(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// keep the two smallest (distance, index) pairs
__device__ __forceinline__ void push2(float& d1, int& i1, float& d2, int& i2, float d, int i) {
  if (lex_lt(d, i, d1, i1)) {
    d2 = d1;
    i2 = i1;
    d1 = d;
    i1 = i;
  } else if (lex_lt(d, i, d2, i2)) {
    d2 = d;
    i2 = i;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Thread (tr, tc) = (tid / 16, tid % 16) owns rows tr*4 .. tr*4+3 of the
// block and centroids tc*4 .. tc*4+3 of each tile.
__global__ void __launch_bounds__(AS_THREADS)
assign_f32_kernel(const float* __restrict__ x, const int* __restrict__ idx, long long cap,
              long long n, const float* __restrict__ cents, int C, int D, int k,
              int* __restrict__ out) {
  __shared__ __align__(16) float xs[AS_DK][AS_PAD];
  __shared__ __align__(16) float cs[AS_DK][AS_PAD];
  __shared__ float xn[AS_TR];
  __shared__ float cn[AS_TC];
  __shared__ long long src[AS_TR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid / 16, tc = tid % 16;
  const long long r0 = (long long)blockIdx.x * AS_TR;

  for (int r = tid; r < AS_TR; r += AS_THREADS) {
    const long long g = r0 + r;
    long long s = -1;  // -1: past the end, no row
    if (g < n) {
      s = idx != nullptr ? (long long)idx[g] : g;
      s = s < 0 ? 0 : (s >= cap ? cap - 1 : s);
    }
    src[r] = s;
  }
  __syncthreads();
  // squared norms of the block's rows, one warp a row
  for (int r = warp; r < AS_TR; r += AS_THREADS / 32) {
    float s = 0.f;
    const long long sr = src[r];
    if (sr >= 0)
      for (int c = lane; c < D; c += 32) {
        const float v = x[sr * D + c];
        s = fmaf(v, v, s);
      }
    s = warp_sum(s);
    if (lane == 0) xn[r] = s;
  }

  float d1[4], d2[4];
  int i1[4], i2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d1[i] = d2[i] = __uint_as_float(0x7f800000u);  // +inf
    i1[i] = i2[i] = INT_BIG;
  }

  for (int c0 = 0; c0 < C; c0 += AS_TC) {
    __syncthreads();  // the previous tile is done with cn
    for (int j = warp; j < AS_TC; j += AS_THREADS / 32) {
      float s = 0.f;
      const int cj = c0 + j;
      if (cj < C)
        for (int c = lane; c < D; c += 32) {
          const float v = cents[(long long)cj * D + c];
          s = fmaf(v, v, s);
        }
      s = warp_sum(s);
      if (lane == 0) cn[j] = s;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += AS_DK) {
      __syncthreads();  // the staged tiles are free
      for (int e = tid; e < AS_TR * AS_DK; e += AS_THREADS) {
        const int r = e / AS_DK, c = e % AS_DK, col = d0 + c;
        const long long sr = src[r];
        xs[c][r] = (sr >= 0 && col < D) ? x[sr * D + col] : 0.f;
      }
      for (int e = tid; e < AS_TC * AS_DK; e += AS_THREADS) {
        const int j = e / AS_DK, c = e % AS_DK, col = d0 + c, cj = c0 + j;
        cs[c][j] = (cj < C && col < D) ? cents[(long long)cj * D + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < AS_DK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[c][tr * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[c][tc * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = c0 + tc * 4 + j;
        if (cj < C) {
          const float d = pw_finish<M_EUCLIDEAN>(xn[tr * 4 + i], cn[tc * 4 + j], acc[i][j], 0.f, 0.f);
          push2(d1[i], i1[i], d2[i], i2[i], d, cj);
        }
      }
  }
  // merge the best-2 of the 16 lanes that share a row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int o = 8; o > 0; o >>= 1) {
      const float od1 = __shfl_xor_sync(0xffffffffu, d1[i], o);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1[i], o);
      const float od2 = __shfl_xor_sync(0xffffffffu, d2[i], o);
      const int oi2 = __shfl_xor_sync(0xffffffffu, i2[i], o);
      push2(d1[i], i1[i], d2[i], i2[i], od1, oi1);
      push2(d1[i], i1[i], d2[i], i2[i], od2, oi2);
    }
  }
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long g = r0 + tr * 4 + i;
      if (g >= n) continue;
      out[g * k] = i1[i];
      if (k == 2) out[g * k + 1] = i2[i];
    }
  }
}

// ------------------------------------------------------------------ K5, bf16 rows

constexpr int TC_THREADS = 512;          // 16 warps: 4 along the rows x 4 along the centroids
constexpr int TC_BM = 256;               // rows a block
constexpr int TC_WM = TC_BM / 64;        // warps along the rows (64 rows each)
static_assert(TC_WM * 4 * 32 == TC_THREADS, "4 column warps of 32 centroids a tile");
constexpr int TC_BN = 128;               // centroids a tile
constexpr int TC_BK = 32;                // columns a step: two k16 steps
constexpr int TC_STAGES = 3;             // cp.async ring: steps s + 1, s + 2 in flight while s runs
constexpr int TC_P = TC_BK + 8;          // bf16 a staged row: 20 words, conflict-free fragments
constexpr int TC_PW = TC_P / 2;
constexpr int TC_X = TC_BM * TC_P;       // bf16 of a stage's rows
constexpr int TC_L = TC_BN * TC_P;       // bf16 of a stage's limb plane
constexpr int TC_STAGE = TC_X + 2 * TC_L;  // the rows and two limb-plane slots
constexpr int TC_SMEM = TC_STAGES * TC_STAGE * 2;  // bytes of the ring
static_assert(TC_SMEM + 32 * 1024 <= 232448, "a block's shared memory");
static_assert(TC_BM * (TC_BK / 8) % TC_THREADS == 0 && TC_BN * (TC_BK / 8) == TC_THREADS,
              "the copy loops take whole turns of the block, one a limb plane");

int limb_pitch(int D) { return (D + 15) / 16 * 16; }

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return (unsigned short)(__float_as_uint(v) >> 16);
}

// limbs [3, C, Dp] bf16: c = l0 + l1 + l2 (finite c), zero past D;
// cnorm [C] = |c|^2 in f32. A warp a centroid.
__global__ void __launch_bounds__(256) split_centroids(const float* __restrict__ cents, int C,
                                                       int D, int Dp,
                                                       unsigned short* __restrict__ limbs,
                                                       float* __restrict__ cnorm) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (j >= C) return;  // whole warps
  float s = 0.f;
  for (int c = lane; c < Dp; c += 32) {
    const float v = c < D ? cents[j * D + c] : 0.f;
    s = fmaf(v, v, s);
    float l0, l1, l2;
    split3(v, l0, l1, l2);
    limbs[j * Dp + c] = bf16_bits(l0);
    limbs[((long long)C + j) * Dp + c] = bf16_bits(l1);
    limbs[(2LL * C + j) * Dp + c] = bf16_bits(l2);
  }
  s = warp_sum(s);
  if (lane == 0) cnorm[j] = s;
}

// x[row] . cents[j] as the f32 FMA chain over the columns, in order
__device__ __forceinline__ float fma_dot(const unsigned short* __restrict__ x, long long row,
                                      const float* __restrict__ cents, int j, int D) {
  float s = 0.f;
  for (int c = 0; c < D; ++c)
    s = fmaf(__uint_as_float((unsigned)x[row * D + c] << 16), cents[(long long)j * D + c], s);
  return s;
}

// A candidate: distance, clamped squared distance, centroid index.
struct Cand {
  float d, e;
  int i;
};

// keep the two smallest candidates in (distance, index) order
__device__ __forceinline__ void keep2(Cand& a, Cand& b, const Cand& c) {
  if (lex_lt(c.d, c.i, a.d, a.i)) {
    b = a;
    a = c;
  } else if (lex_lt(c.d, c.i, b.d, b.i)) {
    b = c;
  }
}

__device__ __forceinline__ Cand shfl_xor_cand(const Cand& c, int o) {
  return {__shfl_xor_sync(0xffffffffu, c.d, o), __shfl_xor_sync(0xffffffffu, c.e, o),
          __shfl_xor_sync(0xffffffffu, c.i, o)};
}

// Warp (wm, wn) = (warp % TC_WM, warp / TC_WM) owns rows wm*64 .. +63 of the block
// and centroids wn*32 .. +31 of each tile: fragments mt (16 rows) x nt (8
// centroids); lane (g, t) = (lane / 4, lane % 4) holds rows g, g + 8 and
// centroids 2t, 2t + 1 of each. A tile takes two passes over the columns:
// limbs 2 and 1 (slots 0, 1 of a stage) while the sums are small, then
// limb 0 (slot 1) on top, so no lower-limb product is added to a sum of
// the full dot's size, where its low bits would be rounded away. Each (column warp, row) keeps its best-2
// in shared memory, written by the lane t = 0 of its quad. A candidate whose
// clamped squared distance e exceeds the second kept one's cannot enter
// the best-2 (sqrt is monotonic, and on an equal distance the tiles'
// ascending indices lose to the kept ones), so the epilogue skips its sqrt.
// A row with a non-finite product is flagged and, after the tiles, a warp
// recomputes all its distances as f32 FMA chains.
__global__ void __launch_bounds__(TC_THREADS, 1)
assign_tc_kernel(const unsigned short* __restrict__ x, const int* __restrict__ idx, long long cap,
                 long long n, const unsigned short* __restrict__ limbs,
                 const float* __restrict__ cnorm, const float* __restrict__ cents, int C, int D,
                 int Dp, int k, int vec, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned short tc_smem[];  // [TC_STAGES][rows, 2 slots]
  __shared__ long long src[TC_BM];
  __shared__ float xn[TC_BM];
  __shared__ Cand best[4][TC_BM][2];  // a column warp's best-2 a row
  __shared__ int bad[TC_BM];          // the row met a non-finite product
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp % TC_WM, wn = warp / TC_WM;
  const float inf = __uint_as_float(0x7f800000u);
  const long long r0 = (long long)blockIdx.x * TC_BM;
  for (int r = tid; r < TC_BM; r += TC_THREADS) {
    long long sr = -1;  // past the end: no row
    if (r0 + r < n) {
      sr = idx != nullptr ? (long long)idx[r0 + r] : r0 + r;
      sr = sr < 0 ? 0 : (sr >= cap ? cap - 1 : sr);
    }
    src[r] = sr;
    bad[r] = 0;
  }
  for (int e = tid; e < 8 * TC_BM; e += TC_THREADS)
    best[e / (2 * TC_BM)][e / 2 % TC_BM][e % 2] = {inf, inf, INT_BIG};
  __syncthreads();
  const int nk = (D + TC_BK - 1) / TC_BK;
  const int steps = 2 * nk * ((C + TC_BN - 1) / TC_BN);

  // step s (tile s / 2nk, pass s / nk % 2, columns (s % nk) * 32 ..) into
  // ring slot s % TC_STAGES
  auto issue = [&](int s) {
    if (s < steps) {
      unsigned short* st = tc_smem + (s % TC_STAGES) * TC_STAGE;
      const int k0 = (s % nk) * TC_BK, c0 = (s / (2 * nk)) * TC_BN;
      const bool hi = s / nk % 2 == 1;
#pragma unroll
      for (int i = 0; i < TC_BM * (TC_BK / 8) / TC_THREADS; ++i) {
        const int p = tid + i * TC_THREADS, r = p >> 2, kk = k0 + (p & 3) * 8;
        unsigned short* dst = st + r * TC_P + (p & 3) * 8;
        const long long sr = src[r];
        if (vec) {  // D % 8 == 0 and x 16-byte aligned: a piece is all in or all out
          const bool in = sr >= 0 && kk < D;
          cp_async16(dst, in ? x + sr * D + kk : x, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (sr >= 0 && kk + e < D) ? x[sr * D + kk + e] : (unsigned short)0;
        }
      }
      const int c = tid >> 2, kk = k0 + (tid & 3) * 8;
      const bool in = c0 + c < C && kk < Dp;
      for (int l = int(hi); l < 2; ++l) {  // limb 0's pass: slot 1 only
        const int pl = hi ? 0 : 2 - l;       // the limb plane slot l holds
        cp_async16(st + TC_X + l * TC_L + c * TC_P + (tid & 3) * 8,
                   in ? limbs + ((long long)pl * C + c0 + c) * Dp + kk : limbs, in ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  float sq = 0.f;  // |x|^2 of row tid / 2 over columns (tid % 2) * 16 .. +15 of each step

  for (int s = 0; s < TC_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // step s landed for every thread; step s - 1 is no longer read
    issue(s + TC_STAGES - 1);
    const unsigned short* st = tc_smem + (s % TC_STAGES) * TC_STAGE;
    const bool hi = s / nk % 2 == 1;
    if (s < nk) {  // the first pass: the rows' squared norms
      const unsigned short* xr = st + (tid >> 1) * TC_P + (tid & 1) * 16;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float v = __uint_as_float((unsigned)xr[e] << 16);
        sq = fmaf(v, v, sq);
      }
      if (s == nk - 1) {  // complete; read first at step 2nk - 1, past a barrier
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        if ((tid & 1) == 0) xn[tid >> 1] = sq;
      }
    }
    const unsigned* xw = reinterpret_cast<const unsigned*>(st);
    const unsigned* lw = reinterpret_cast<const unsigned*>(st + TC_X);
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned* base = xw + (wm * 64 + mt * 16 + g) * TC_PW + ks * 8 + t;
        a[mt][0] = base[0];
        a[mt][1] = base[8 * TC_PW];
        a[mt][2] = base[4];
        a[mt][3] = base[8 * TC_PW + 4];
      }
      for (int l = hi ? 1 : 0; l < 2; ++l) {  // the stage's limb-plane slots
        unsigned b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned* base = lw + l * (TC_L / 2) + (wn * 32 + nt * 8 + g) * TC_PW + ks * 8 + t;
          b[nt][0] = base[0];
          b[nt][1] = base[4];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
      }
    }
    if (s % (2 * nk) == 2 * nk - 1) {  // the tile's last step: its distances
      const int c0 = (s / (2 * nk)) * TC_BN + wn * 32 + 2 * t;
      float cn[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = c0 + (q >> 1) * 8 + (q & 1);
        cn[q] = j < C ? cnorm[j] : 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 64 + mt * 16 + g + 8 * h;
          const float xr = xn[r], e2 = best[wn][r][1].e;
          // this lane's best-2 of the row over its 8 centroids of the tile
          Cand c1 = {inf, inf, INT_BIG}, c2 = {inf, inf, INT_BIG};
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = c0 + (q >> 1) * 8 + (q & 1);
            float dot = acc[mt][q >> 1][2 * h + (q & 1)];
            acc[mt][q >> 1][2 * h + (q & 1)] = 0.f;
            if (j >= C) continue;
            if (!finite_f(dot)) bad[r] = 1;
            const float e = fmaxf(xr + cn[q] - 2.f * dot, 0.f);
            if (e > e2 || e > c2.e) continue;  // cannot enter the row's best-2
            keep2(c1, c2, {sqrtf(e), e, j});
          }
          // the quad's four lanes hold the same row: merge, then lane 0 keeps it
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            const Cand o1 = shfl_xor_cand(c1, o), o2 = shfl_xor_cand(c2, o);
            keep2(c1, c2, o1);
            keep2(c1, c2, o2);
          }
          if (t == 0 && c1.i != INT_BIG) {
            Cand b1 = best[wn][r][0], b2 = best[wn][r][1];
            keep2(b1, b2, c1);
            keep2(b1, b2, c2);
            best[wn][r][0] = b1;
            best[wn][r][1] = b2;
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every column warp's best-2 and flag is written
  // rows with a non-finite product (a limb split of inf or NaN is not
  // (v, 0, 0), and a zero limb meeting inf gives NaN where f32 gives inf):
  // every distance again as the f32 FMA chain, as f32 gives it; a warp a row
  for (int r = warp; r < TC_BM; r += TC_THREADS / 32) {
    if (!bad[r] || src[r] < 0) continue;  // uniform in the warp
    Cand c1 = {inf, inf, INT_BIG}, c2 = {inf, inf, INT_BIG};
    for (int j = lane; j < C; j += 32) {
      const float e = fmaxf(xn[r] + cnorm[j] - 2.f * fma_dot(x, src[r], cents, j, D), 0.f);
      keep2(c1, c2, {sqrtf(e), e, j});
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Cand o1 = shfl_xor_cand(c1, o), o2 = shfl_xor_cand(c2, o);
      keep2(c1, c2, o1);
      keep2(c1, c2, o2);
    }
    if (lane < 4) {  // the row's best-2 in column warp 0's place, the others empty
      best[lane][r][0] = lane == 0 ? c1 : Cand{inf, inf, INT_BIG};
      best[lane][r][1] = lane == 0 ? c2 : Cand{inf, inf, INT_BIG};
    }
  }
  __syncthreads();
  if (tid < TC_BM && r0 + tid < n) {
    Cand b1 = best[0][tid][0], b2 = best[0][tid][1];
    for (int w = 1; w < 4; ++w) {
      keep2(b1, b2, best[w][tid][0]);
      keep2(b1, b2, best[w][tid][1]);
    }
    const long long gi = r0 + tid;
    out[gi * k] = b1.i;
    if (k == 2) out[gi * k + 1] = b2.i;
  }
}

// ------------------------------------------------------------------ K4

constexpr int UP_THREADS = 256;                       // the count and scatter blocks
constexpr int UP_WARPS = UP_THREADS / 32;
constexpr int UP_UNROLL = 8;                          // assignment entries a thread holds at once
constexpr int UP_CHUNK = UP_THREADS * UP_UNROLL;      // assignment entries a block holds at once
constexpr int UP_MAX_TILES = 32;                      // count / scatter blocks, at most
constexpr int UP_ITEM = 128;                          // members a work item, at most
constexpr int UP_SUM_THREADS = 256;                   // a sum block's threads, at most
constexpr int UP_LOADS = 8;                           // rows (or partials) a sum thread has in flight
constexpr unsigned UP_NONE = 0xFFFFFFFFu;             // the key of an entry outside [0, C)

__host__ __device__ inline long long align16(long long b) { return (b + 15) / 16 * 16; }

// One update's scratch, byte offsets: per-tile counts hist [NT, C], the
// grouped row ids order [n], start and istart [C + 1] each, each item's
// centroid item_c [items], a ticket a centroid, and the partial sums [items,
// D] f32 of the centroids that span several items. T: entries a tile (a
// multiple of UP_CHUNK); items: the work items' count at most.
struct UpLayout {
  long long T, NT, items, hist, order, start, istart, item_c, ticket, partial, bytes;
};

UpLayout up_layout(long long n, int D, int C) {
  UpLayout L;
  const long long chunks = (n + UP_CHUNK - 1) / UP_CHUNK;
  L.T = UP_CHUNK * ((chunks + UP_MAX_TILES - 1) / UP_MAX_TILES);
  L.NT = (n + L.T - 1) / L.T;
  // sum over centroids of max(1, ceil(count / UP_ITEM)) <= C + n / UP_ITEM
  L.items = C + n / UP_ITEM;
  L.hist = 0;
  L.order = align16(L.NT * C * 4);
  L.start = align16(L.order + n * 4);
  L.istart = align16(L.start + (C + 1) * 4LL);
  L.item_c = align16(L.istart + (C + 1) * 4LL);
  L.ticket = align16(L.item_c + L.items * 4);
  L.partial = align16(L.ticket + C * 4LL);
  L.bytes = L.partial + L.items * D * 4;
  return L;
}

// A chunk's keys: warp w holds entries [w, w + 1) * 32 * UP_UNROLL of the
// chunk from r0, 32 a step, so the warps' order is the entries' order.
__device__ __forceinline__ void up_keys(unsigned* key, const int* __restrict__ assign,
                                        long long n, int C, long long r0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < UP_UNROLL; ++u) {
    const long long r = r0 + (warp * UP_UNROLL + u) * 32 + lane;
    const int a = r < n ? assign[r] : -1;
    key[u] = a >= 0 && a < C ? (unsigned)a : UP_NONE;
  }
}

// launch 1: each tile's count a centroid -> hist [tile, C]
__global__ void __launch_bounds__(UP_THREADS)
up_count_kernel(const int* __restrict__ assign, long long n, int C, int T, int* __restrict__ hist) {
  extern __shared__ int up_sh[];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int c = tid; c < C; c += UP_THREADS) up_sh[c] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * T;
  for (int r0 = 0; r0 < T; r0 += UP_CHUNK) {
    unsigned key[UP_UNROLL];
    up_keys(key, assign, n, C, t0 + r0);
#pragma unroll
    for (int u = 0; u < UP_UNROLL; ++u) {
      const unsigned peers = __match_any_sync(FULL, key[u]);
      if (key[u] != UP_NONE && lane == __ffs(peers) - 1) atomicAdd(&up_sh[key[u]], __popc(peers));
    }
  }
  __syncthreads();
  int* h = hist + (long long)blockIdx.x * C;
  for (int c = tid; c < C; c += UP_THREADS) h[c] = up_sh[c];
}

// Exclusive scan in place of a [0, len) in shared memory by the block's
// UP_THREADS threads (each a run of consecutive entries); a [len] = the
// total. wsum: UP_WARPS ints of shared scratch.
__device__ void up_scan(int* a, int len, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (len + UP_THREADS - 1) / UP_THREADS;
  const int lo = min(len, tid * per), hi = min(len, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int run = inc - s, total = 0;
  for (int w = 0; w < UP_WARPS; ++w) {
    run += w < warp ? wsum[w] : 0;
    total += wsum[w];
  }
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (tid == 0) a[len] = total;
  __syncthreads();
}

// launch 2: the scans, then this tile's stable scatter into order, and
// this block's share of the tables launch 3 reads
__global__ void __launch_bounds__(UP_THREADS)
up_scatter_kernel(const int* __restrict__ assign, long long n, int C, int T, int NT,
                  const int* __restrict__ hist, int* __restrict__ order, int* __restrict__ start,
                  int* __restrict__ istart, int* __restrict__ item_c,
                  unsigned* __restrict__ ticket, int* __restrict__ counts) {
  extern __shared__ int up_sh[];
  int* st = up_sh;        // [C + 1]: counts, then first positions
  int* it = st + C + 1;   // [C + 1]: items, then first items
  int* run = it + C + 1;  // [C]: the next position of this tile's rows a centroid
  __shared__ int wsum[UP_WARPS];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)t * T;
  unsigned key[UP_UNROLL];
  up_keys(key, assign, n, C, t0);  // in flight during the sums
  for (int c = tid; c < C; c += UP_THREADS) {
    int tot = 0, pre = 0;
#pragma unroll 32
    for (int u = 0; u < NT; ++u) {
      const int h = hist[(long long)u * C + c];
      tot += h;
      pre += u < t ? h : 0;
    }
    st[c] = tot;
    it[c] = max(1, (tot + UP_ITEM - 1) / UP_ITEM);
    run[c] = pre;
  }
  __syncthreads();
  up_scan(st, C, wsum);
  up_scan(it, C, wsum);
  for (int c = tid; c < C; c += UP_THREADS) run[c] += st[c];
  __syncthreads();
  for (int r0 = 0; r0 < T; r0 += UP_CHUNK) {
    if (r0 > 0) up_keys(key, assign, n, C, t0 + r0);
    unsigned peers[UP_UNROLL];
#pragma unroll
    for (int u = 0; u < UP_UNROLL; ++u) peers[u] = __match_any_sync(FULL, key[u]);
    // the warps in turn; in a warp's turn its steps in order, each equal
    // entries' group placed from run[] in lane order
    for (int w = 0; w < UP_WARPS; ++w) {
      if (warp == w) {
#pragma unroll
        for (int u = 0; u < UP_UNROLL; ++u) {
          const bool ok = key[u] != UP_NONE;
          const int rank = __popc(peers[u] & ((1u << lane) - 1u));
          const int base = ok ? run[key[u]] : 0;
          __syncwarp();
          if (ok) {
            order[base + rank] = (int)(t0 + r0 + (warp * UP_UNROLL + u) * 32 + lane);
            if (rank == 0) run[key[u]] = base + __popc(peers[u]);
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }
  const int c1 = (int)((long long)C * (t + 1) / NT);
  for (int c = (int)((long long)C * t / NT) + tid; c < c1; c += UP_THREADS) {
    start[c] = st[c];
    istart[c] = it[c];
    counts[c] = st[c + 1] - st[c];
    ticket[c] = 0u;
  }
  if (t == NT - 1 && tid == 0) {
    start[C] = st[C];
    istart[C] = it[C];
  }
  const int items = it[C], j1 = (int)((long long)items * (t + 1) / NT);
  for (int j = (int)((long long)items * t / NT) + tid; j < j1; j += UP_THREADS) {
    int lo = 0, hi = C - 1;  // the last centroid whose first item is <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (it[mid] <= j) lo = mid;
      else hi = mid - 1;
    }
    item_c[j] = lo;
  }
}

// a row's 16 bytes added to the f32 sums
__device__ __forceinline__ void up_add(float* acc, uint4 v, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void up_add(float* acc, uint4 v, float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

// the last item of a centroid: its ni partial rows p [ni, D] added in item
// order, CW floats a load (4 when D % 4 == 0), / cnt -> out [D]
template <int CW>
__device__ void up_combine(const float* p, int ni, int D, int cnt, float* __restrict__ out) {
  const int nv = D / CW;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    float tot[CW] = {};
    for (int k = 0; k < ni; k += UP_LOADS) {
      float b[UP_LOADS][CW] = {};
#pragma unroll
      for (int u = 0; u < UP_LOADS; ++u) {
        if (k + u >= ni) continue;
        const float* q = p + (long long)(k + u) * D + (long long)v * CW;
        if constexpr (CW == 4) {
          const float4 f = __ldcg(reinterpret_cast<const float4*>(q));
          b[u][0] = f.x;
          b[u][1] = f.y;
          b[u][2] = f.z;
          b[u][3] = f.w;
        } else {
          b[u][0] = __ldcg(q);
        }
      }
#pragma unroll
      for (int u = 0; u < UP_LOADS; ++u) {
        if (k + u >= ni) continue;
#pragma unroll
        for (int j = 0; j < CW; ++j) tot[j] += b[u][j];
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) out[(long long)v * CW + j] = tot[j] / (float)cnt;
  }
}

// launch 3: a block a work item; W elements a load (16 bytes, or 1)
template <typename T, int W>
__global__ void __launch_bounds__(UP_SUM_THREADS)
up_sum_kernel(const T* __restrict__ x, int D, int C, const int* __restrict__ order,
              const int* __restrict__ start, const int* __restrict__ istart,
              const int* __restrict__ item_c, const float* __restrict__ c_old,
              float* __restrict__ partial, unsigned* __restrict__ ticket,
              float* __restrict__ c_new) {
  __shared__ int rows[UP_ITEM];
  __shared__ int s_last;
  const int item = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  if (item >= istart[C]) return;  // past the launch's items: the whole block
  const int c = item_c[item];
  const int i0 = istart[c], ni = istart[c + 1] - i0;
  const int s0 = start[c], cnt = start[c + 1] - s0;
  const int m0 = s0 + (item - i0) * UP_ITEM, mn = min(UP_ITEM, s0 + cnt - m0);
  for (int i = tid; i < mn; i += nt) rows[i] = order[m0 + i];
  __syncthreads();
  const int nv = D / W;
  for (int v = tid; v < nv; v += nt) {
    float acc[W] = {};
    for (int m = 0; m < mn; m += UP_LOADS) {
      if constexpr (W == 1) {
        float b[UP_LOADS] = {};
#pragma unroll
        for (int u = 0; u < UP_LOADS; ++u)
          if (m + u < mn) b[u] = to_f(x[(long long)rows[m + u] * D + v]);
#pragma unroll
        for (int u = 0; u < UP_LOADS; ++u)
          if (m + u < mn) acc[0] += b[u];
      } else {
        const uint4* xv = reinterpret_cast<const uint4*>(x) + v;
        uint4 b[UP_LOADS] = {};
#pragma unroll
        for (int u = 0; u < UP_LOADS; ++u)
          if (m + u < mn) b[u] = __ldg(xv + (long long)rows[m + u] * nv);
#pragma unroll
        for (int u = 0; u < UP_LOADS; ++u)
          if (m + u < mn) up_add(acc, b[u], T{});
      }
    }
    const long long o = (long long)v * W;
    if (ni == 1) {
      const long long cd = (long long)c * D + o;
#pragma unroll
      for (int j = 0; j < W; ++j) c_new[cd + j] = cnt > 0 ? acc[j] / (float)cnt : c_old[cd + j];
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) partial[(long long)item * D + o + j] = acc[j];
    }
  }
  if (ni == 1) return;  // the same for the whole block
  __threadfence();      // this item's partials before its ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + c, 1u) == (unsigned)(ni - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* p = partial + (long long)i0 * D;
  if (D % 4 == 0) up_combine<4>(p, ni, D, cnt, c_new + (long long)c * D);
  else up_combine<1>(p, ni, D, cnt, c_new + (long long)c * D);
}

template <typename T>
int up_sum_launch(const T* x, int D, int C, bool vec, long long items, const int* order,
                  const int* start, const int* istart, const int* item_c, const float* c_old,
                  float* partial, unsigned* ticket, float* c_new, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const int nv = vec ? D / W : D;
  const int threads = min(UP_SUM_THREADS, (nv + 31) / 32 * 32);
  if (vec)
    up_sum_kernel<T, W><<<(unsigned)items, threads, 0, s>>>(x, D, C, order, start, istart, item_c,
                                                            c_old, partial, ticket, c_new);
  else
    up_sum_kernel<T, 1><<<(unsigned)items, threads, 0, s>>>(x, D, C, order, start, istart, item_c,
                                                            c_old, partial, ticket, c_new);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K3 (and K13)

constexpr int IR_THREADS = 256;  // the pair-major blocks
constexpr int IR_WARPS = IR_THREADS / 32;
constexpr int IR_ROWS = 4;         // member rows a warp scores at once
constexpr int LM_THREADS = 512;    // the list-major blocks
constexpr int LM_WARPS = LM_THREADS / 32;
constexpr int LM_ROWS = 2;         // staged rows a warp holds in registers
constexpr int LM_CHUNK = LM_WARPS * LM_ROWS;  // list positions a stage (32: one ballot)
constexpr int LM_QREG = 24;        // a row's values a lane holds
constexpr int LM_MAX_D = 32 * LM_QREG;   // so the list-major mode takes D <= 768
constexpr int LM_TPQ = 64;         // threads that stage one query
constexpr int LM_RANGE = 1024;     // list positions a list-major range (256 when kk > 256)
constexpr int LM_MAX_STAGES = 2;
constexpr int LM_MAX_PAIRS = 4096; // (query, shard, probe) pairs a list-major launch groups
constexpr int LM_MIN_Q = 16;       // queries from which the plan takes the list-major mode
static_assert(LM_CHUNK == 32, "a stage's live positions are one ballot");

// positions a block covers at most: n positions split in G contiguous
// ranges, rounded up to whole 32-position chunks
__host__ __device__ inline int ir_span(int n, int G) { return ((n + G - 1) / G + 31) / 32 * 32; }

int ir_smem_bytes(int D, int kkb) { return (D * 4 + 15) / 16 * 16 + IR_WARPS * kkb * 8; }

// A list-major launch's shape: qb pairs a group at most, nstage stages of
// LM_CHUNK staged rows, and the shared-memory layout (byte offsets): the
// group's queries and squared norms, the stages, the pairs' lists, a
// chunk's keys, the sort keys, the group starts and the groups' order.
struct LmPlan {
  int qb, nstage, np2;
  long long qs, qss, stage, lists, ckeys, keys, gstart, order, bytes;
};

LmPlan lm_plan(int D, int tsize, int kkb, int np, int qb, int nstage) {
  LmPlan p{};
  p.qb = qb;
  p.nstage = nstage;
  p.np2 = 2;
  while (p.np2 < np) p.np2 <<= 1;
  long long b = 0;
  p.qs = b;
  b = align16(b + (long long)qb * align16(D * 4LL));
  p.qss = b;
  b = align16(b + qb * 4LL);
  p.stage = b;
  b = align16(b + (long long)nstage * LM_CHUNK * align16((long long)D * tsize));
  p.lists = b;
  b = align16(b + (long long)qb * kkb * 8);
  p.ckeys = b;
  b = align16(b + (long long)qb * LM_CHUNK * 8);
  p.keys = b;
  b = align16(b + p.np2 * 8LL);
  p.gstart = b;
  b = align16(b + (np + 1) * 4LL);
  p.order = b;
  p.bytes = align16(b + p.np2 * 4LL);
  return p;
}

// The largest group (32 pairs at most) and the deeper ring (at 16 pairs
// or more) that fit a block's shared memory; qb = 0 when none does, or D
// is above LM_MAX_D.
LmPlan lm_fit(int D, int tsize, int kkb, int np) {
  static const int shapes[][2] = {{32, 2}, {24, 2}, {16, 2}, {32, 1}, {24, 1}, {16, 1},
                                  {8, 2},  {8, 1},  {4, 2},  {4, 1},  {2, 2},  {2, 1}};
  for (const auto& sh : shapes) {
    const LmPlan p = lm_plan(D, tsize, kkb, np, sh[0], sh[1]);
    if (D <= LM_MAX_D && p.bytes <= SMEM_OPT_IN) return p;
  }
  return LmPlan{};
}

// waits until at most n (0 or 1) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n == 0)
    cp_async_wait<0>();
  else
    cp_async_wait<1>();
}

// The distances of the query (qs [D], centred for pearson; qss its squared
// norm) to up to IR_ROWS member rows xr[r] at once (src[r] < 0: none;
// uniform in the warp), a warp a row: lane l takes columns l*V + 32*V*i
// (16-byte loads, vec) or l + 32*i, then a shuffle reduction, so every lane
// holds every distance. The list-major kernel repeats this arithmetic in
// this order, so the two modes' distances are the same bits.
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
      float qv[V];  // the query's V values as float4 reads: no bank conflicts
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        const float4 f = reinterpret_cast<const float4*>(qs + c0)[h];
        qv[4 * h] = f.x;
        qv[4 * h + 1] = f.y;
        qv[4 * h + 2] = f.z;
        qv[4 * h + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < IR_ROWS; ++r) {
        if (src[r] < 0) continue;
        const T* tv = reinterpret_cast<const T*>(&raw[r]);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float xv = to_f(tv[u]) - xm[r];
          pw_step<METRIC>(qv[u], xv, p, acc[r], acc2[r]);
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
    for (int off = 16; off > 0; off >>= 1) {  // the sums a metric reads, only
      const float oa = __shfl_xor_sync(FULL, acc[r], off);
      acc[r] = METRIC == M_CHEBYSHEV ? fmaxf(acc[r], oa) : acc[r] + oa;
      if (METRIC == M_JACCARD) acc2[r] += __shfl_xor_sync(FULL, acc2[r], off);
      if (DOT) xss[r] += __shfl_xor_sync(FULL, xss[r], off);
    }
    out[r] = pw_finish<METRIC>(qss, xss[r], acc[r], acc2[r], p);
  }
}

// One query's row q [D] into qs (centred for pearson) and its squared norm
// (the dot metrics) into *qss, exactly as 256 threads take them in the
// pair-major blocks: thread v sums columns v, v + 256, ..., a warp adds its
// threads by shuffles, and thread 0 adds the warps in order. TPQ threads
// (t their index, red [8] the warps' partial sums) stand for the 256: each
// plays 256 / TPQ of them (v = t + TPQ k), whose warps are t / 32 + TPQ k
// / 32, lane for lane, so the sums are the same bits. Every thread of the
// block calls it (it holds __syncthreads); `on` is false for a share of
// threads with no query.
template <int METRIC, int TPQ = 256>
__device__ void query_stats(const float* __restrict__ q, int D, float* qs, float* qss, int t,
                            float* red, bool on) {
  constexpr bool DOT = is_dot_metric<METRIC>();
  constexpr int NV = 256 / TPQ, WPQ = TPQ / 32;
  const int lane = t & 31, w = t >> 5;
  float part[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    part[k] = 0.f;
    if (on)
      for (int c = t + TPQ * k; c < D; c += 256) {
        const float v = q[c];
        qs[c] = v;
        part[k] += v;
      }
  }
  if (METRIC == M_PEARSON) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      part[k] = wsum(part[k]);
      if (lane == 0) red[w + WPQ * k] = part[k];
    }
    __syncthreads();
    float mean = 0.f;
    for (int i = 0; i < 8; ++i) mean += red[i];
    mean /= (float)D;
    __syncthreads();  // red is written again below
    if (on) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        for (int c = t + TPQ * k; c < D; c += 256) qs[c] -= mean;
    }
  }
  __syncthreads();
  if (DOT) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float s = 0.f;
      if (on)
        for (int c = t + TPQ * k; c < D; c += 256) s = fmaf(qs[c], qs[c], s);
      s = wsum(s);
      if (lane == 0) red[w + WPQ * k] = s;
    }
    __syncthreads();
    if (t == 0 && on) {
      float u = 0.f;
      for (int i = 0; i < 8; ++i) u += red[i];
      *qss = u;
    }
    __syncthreads();
  }
}

// The pair-major mode. Block b = (((query * S + shard) * P + probe rank) *
// G + g): query qi against the members of list probes[qi, pr] in shard s
// (tables [S, C, L], rows [S * cap, D], slot_ok [S * cap] or null: every
// slot) that lie in the g-th of G contiguous ranges of the list's extent
// (one past its last listed position). Warp w takes the range's
// 32-position chunks w, w + 8, ...: a lane reads its position's mask byte,
// row and slot_ok byte; a chunk with no live member reads no row and
// offers nothing; live rows are read a warp a row, IR_ROWS at once; the
// chunk's keys (f2key(d) << 32 | position) go to the warp's running
// top-kkb (warp_offer). At the end warp 0 merges the warps' lists and
// writes the block's kkb picks, sorted: the distance and the row's slot
// (list_rows, local to the shard), +inf and -1 past the candidates, to out
// [Q, S, P, G, kkb].
template <int METRIC, typename T>
__global__ void __launch_bounds__(IR_THREADS)
rerank_pairs_kernel(const float* __restrict__ q, int D, float p, const int* __restrict__ probes,
                    int P, const T* __restrict__ x, long long cap,
                    const int* __restrict__ list_rows, const unsigned char* __restrict__ list_mask,
                    int C, int L, const unsigned char* __restrict__ slot_ok, int S, int G, int kkb,
                    int vec, float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr bool DOT = is_dot_metric<METRIC>();
  // the query [D] (centred for pearson), then the warps' lists [IR_WARPS][kkb]
  extern __shared__ __align__(16) unsigned char ir_smem[];
  __shared__ float s_red[IR_WARPS];
  __shared__ int s_last[IR_WARPS];
  __shared__ float s_qss;
  // the least last entry of the warps' full lists: no key above it can be
  // among the block's kkb best
  __shared__ unsigned long long s_bound;
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

  query_stats<METRIC>(q + (long long)qi * D, D, qs, &s_qss, tid, s_red, true);
  // the list's extent; the warp's list starts empty
  int last = -1;
  for (int j = tid; j < L; j += IR_THREADS)
    if (lm[j]) last = j;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(FULL, last, o));
  if (lane == 0) s_last[warp] = last;
  unsigned long long* kept = lists + warp * kkb;
  for (int e = lane; e < kkb; e += 32) kept[e] = PAD_PAIR;
  if (tid == 0) s_bound = PAD_PAIR;
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
    const unsigned long long bound = s_bound;
    unsigned long long cand = live ? pair_of(f2key(mine), j) : PAD_PAIR;
    if (cand >= bound) cand = PAD_PAIR;  // above kkb keys another warp holds
    theta = warp_offer(kept, kkb, theta, cand);
    if (lane == 0 && theta < bound) atomicMin(&s_bound, theta);
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

// The list-major mode: each probed (shard, list)'s live members are staged
// once for all the (query, shard, probe rank) pairs that probe it. Every
// block first groups the NP = Q * S * P pairs the same way: keys (shard *
// C + list) << 32 | pair, bitonic-sorted in shared memory, cut into groups
// of at most qb pairs of one list (in pair order; qb from shared memory's
// room, 32 at kk = 10), and orders the groups, most pairs first. Then the
// persistent blocks take the work items (group, range g of span
// positions) one after another from the launch's ticket, the heaviest
// groups' ranges first, so a few heavy lists do not keep a few SMs busy
// alone. An item stages its pairs' queries in shared memory, eight at a
// time, exactly as the pair-major blocks take them (query_stats), then its
// range's live rows LM_CHUNK positions at a time, compacted, by 16-byte
// cp.async into a ring of two stages (plain loads when the rows are not
// 16-byte aligned). Warp w holds staged rows 2 w and 2 w + 1 in registers
// (lane l's columns, as member_distances takes them), with their squared
// norms, and scores them against the group's pairs two at a time (four
// FMA chains a lane) with member_distances' arithmetic in its order, so
// the distances are the pair-major mode's bits; the query values come as
// conflict-free 16-byte reads. The chunk's keys (f2key(d) << 32 |
// position) go to shared memory, and each pair's running top-kkb
// (knn.cuh's warp lists, a warp a pair) takes them in one 32-key offer.
// The picks go where the pair-major blocks put theirs ([Q, S, P, G,
// kkb]), so the merge selects the same bits in the same order. D <=
// LM_MAX_D.
template <int METRIC, typename T>
__global__ void __launch_bounds__(LM_THREADS, 1)
rerank_lists_kernel(const float* __restrict__ q, int D, float p, const int* __restrict__ probes,
                    int P, const T* __restrict__ x, long long cap,
                    const int* __restrict__ list_rows, const unsigned char* __restrict__ list_mask,
                    int C, int L, const unsigned char* __restrict__ slot_ok, int S, int G, int kkb,
                    int vec, int NP, LmPlan pl, unsigned* __restrict__ ticket,
                    float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr bool DOT = is_dot_metric<METRIC>();
  constexpr int V = 16 / (int)sizeof(T);  // row values in 16 bytes
  constexpr int NI = LM_QREG / V;         // a lane's 16-byte steps of a row (vec)
  constexpr int QPR = LM_THREADS / LM_TPQ;  // queries staged a round
  extern __shared__ __align__(16) unsigned char lm_smem[];
  __shared__ float s_red[QPR][8];
  __shared__ int s_pos[LM_MAX_STAGES][LM_CHUNK];
  __shared__ int s_nlive[LM_MAX_STAGES];
  __shared__ int s_ngroups, s_any;
  __shared__ unsigned s_item;

  const int Dq = (int)(align16(D * 4LL) / 4);  // a staged query's pitch (floats)
  const long long Dr = align16((long long)D * sizeof(T)) / sizeof(T);  // a staged row's pitch
  float* qs = reinterpret_cast<float*>(lm_smem + pl.qs);
  float* qss = reinterpret_cast<float*>(lm_smem + pl.qss);
  T* stage = reinterpret_cast<T*>(lm_smem + pl.stage);
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(lm_smem + pl.lists);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(lm_smem + pl.keys);
  int* gstart = reinterpret_cast<int*>(lm_smem + pl.gstart);
  unsigned* order = reinterpret_cast<unsigned*>(lm_smem + pl.order);
  // a chunk's keys (f2key(d) << 32 | position), [pair][staged row]
  unsigned long long(*s_keys)[LM_CHUNK] =
      reinterpret_cast<unsigned long long(*)[LM_CHUNK]>(lm_smem + pl.ckeys);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb = pl.qb, ns = pl.nstage;

  // ---- the grouping, the same in every block
  for (int i = tid; i < pl.np2; i += LM_THREADS) {
    unsigned long long v = PAD_PAIR;
    if (i < NP) {
      const int pr = i % P, s = i / P % S, qi = i / P / S;
      v = ((unsigned long long)((long long)s * C + probes[(long long)qi * P + pr]) << 32) |
          (unsigned)i;
    }
    keys[i] = v;
  }
  __syncthreads();
  for (int size = 2; size <= pl.np2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < pl.np2 / 2; i += LM_THREADS) {
        const int a = 2 * i - (i & (stride - 1)), b = a + stride;
        const unsigned long long ka = keys[a], kb = keys[b];
        if ((ka > kb) == ((a & size) == 0)) {
          keys[a] = kb;
          keys[b] = ka;
        }
      }
      __syncthreads();
    }
  if (warp == 0) {  // a group starts where its list starts, then every qb pairs
    int n = 0;
    for (int i0 = 0; i0 < NP; i0 += 32) {
      const int i = i0 + lane;
      bool start = false;
      if (i < NP) {
        const unsigned long long k = keys[i] >> 32 << 32;
        int lo = 0, len = i;  // the first entry of this list: a binary search
        while (len > 0) {
          const int half = len >> 1;
          if (keys[lo + half] < k) {
            lo += half + 1;
            len -= half + 1;
          } else {
            len = half;
          }
        }
        start = (i - lo) % qb == 0;
      }
      const unsigned m = __ballot_sync(FULL, start);
      if (start) gstart[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
    }
    if (lane == 0) {
      gstart[n] = NP;
      s_ngroups = n;
    }
  }
  __syncthreads();
  const int ngroups = s_ngroups;
  const int span = ir_span(L, G);
  // the groups, most pairs first (then in group order): their ranges are
  // the items with the most work, taken first
  for (int i = tid; i < pl.np2; i += LM_THREADS)
    order[i] = i < ngroups ? (unsigned)(64 - (gstart[i + 1] - gstart[i])) << 16 | (unsigned)i
                           : 0xFFFFFFFFu;
  __syncthreads();
  for (int size = 2; size <= pl.np2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < pl.np2 / 2; i += LM_THREADS) {
        const int a = 2 * i - (i & (stride - 1)), b = a + stride;
        const unsigned ka = order[a], kb = order[b];
        if ((ka > kb) == ((a & size) == 0)) {
          order[a] = kb;
          order[b] = ka;
        }
      }
      __syncthreads();
    }

  // ---- the work items (group, range): each block takes the next from the
  // launch's ticket, the heaviest groups' ranges first
  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned t = s_item;
    if (t >= (unsigned)ngroups * (unsigned)G) break;  // uniform
    const int gi = (int)(order[t / G] & 0xFFFFu), g = (int)(t % G);
    const int a = gstart[gi], np = gstart[gi + 1] - a;
    const long long key = (long long)(keys[a] >> 32);
    const int s = (int)(key / C);
    const long long lb = key * L;
    const int* lr = list_rows + lb;
    const unsigned char* lm = list_mask + lb;
    const T* xs = x + (long long)s * cap * D;
    const unsigned char* ok = slot_ok == nullptr ? nullptr : slot_ok + (long long)s * cap;
    const int lo = g * span, hi = min(L, lo + span);
    if (tid == 0) s_any = 0;
    __syncthreads();
    for (int j = lo + tid; j < hi; j += LM_THREADS)
      if (lm[j]) s_any = 1;
    __syncthreads();
    const bool any = s_any != 0;
    // the group's queries, QPR at a time, LM_TPQ threads each
    for (int r = 0; any && r < np; r += QPR) {
      const int i = r + tid / LM_TPQ;
      const int pair = (int)(keys[a + min(i, np - 1)] & 0xFFFFFFFFull);
      query_stats<METRIC, LM_TPQ>(q + (long long)(pair / P / S) * D, D,
                                  qs + (long long)min(i, qb - 1) * Dq, qss + min(i, qb - 1),
                                  tid % LM_TPQ, s_red[tid / LM_TPQ], i < np);
    }
    if (any)  // pair j's running top-kkb, [qb][kkb]; warp j % LM_WARPS keeps it
      for (int e = tid; e < np * kkb; e += LM_THREADS) lists[e] = PAD_PAIR;
    const int nchunks = any ? (hi - lo + LM_CHUNK - 1) / LM_CHUNK : 0;
    // A chunk's positions: every warp reads their mask bytes and slots (one
    // a lane, a chunk ahead of the slot_ok bytes, which depend on the slots,
    // and two ahead of the copies), so the index loads' latency hides
    // behind a chunk's scoring; warp 0 keeps the compacted positions, and
    // the live rows are staged a warp a row.
    auto load_slots = [&](int ci, bool& listed, long long& row) {
      const int j = lo + ci * LM_CHUNK + lane;
      listed = j < hi && lm[j] != 0;
      row = j < hi ? lr[j] : 0;
    };
    // the slot clamped, and its slot_ok byte loaded (1 where unlisted or no
    // slot_ok): the byte is first read when the chunk is staged
    auto load_ok = [&](bool listed, long long& row) -> unsigned char {
      row = row < 0 ? 0 : (row >= cap ? cap - 1 : row);
      return listed && ok != nullptr ? ok[row] : (unsigned char)1;
    };
    auto stage_chunk = [&](int ci, bool live, long long row) {
      const int st = ci % ns;
      const int j = lo + ci * LM_CHUNK + lane;
      const unsigned m = __ballot_sync(FULL, live);
      if (warp == 0) {
        if (live) s_pos[st][__popc(m & ((1u << lane) - 1u))] = j;
        if (lane == 0) s_nlive[st] = __popc(m);
      }
      T* dst0 = stage + (long long)st * LM_CHUNK * Dr;
      unsigned mm = m;
      for (int k = 0; k < warp && mm != 0u; ++k) mm &= mm - 1u;  // the warp-th live lane
      for (int r = warp; mm != 0u; r += LM_WARPS) {
        const long long src_row = __shfl_sync(FULL, row, __ffs((int)mm) - 1);
        const T* srcp = xs + src_row * D;
        T* dst = dst0 + r * Dr;
        if (vec) {
          for (int c = lane * V; c < D; c += 32 * V) cp_async16(dst + c, srcp + c, 16);
        } else {
          for (int c = lane; c < D; c += 32) dst[c] = srcp[c];
        }
        for (int k = 0; k < LM_WARPS && mm != 0u; ++k) mm &= mm - 1u;
      }
    };
    // chunk `next` (listed_a, row_a, ok_a) is staged next; chunk next + 1
    // (listed_b, row_b) has its slots loaded
    int next = 0;
    bool listed_a = false, listed_b = false;
    long long row_a = 0, row_b = 0;
    unsigned char ok_a = 0;
    auto advance = [&]() {
      ++next;
      listed_a = listed_b;
      row_a = row_b;
      ok_a = load_ok(listed_a, row_a);
      if (next + 1 < nchunks) load_slots(next + 1, listed_b, row_b);
    };
    if (nchunks > 0) {
      load_slots(0, listed_a, row_a);
      ok_a = load_ok(listed_a, row_a);
      if (nchunks > 1) load_slots(1, listed_b, row_b);
    }
    for (int c = 0; c < ns - 1; ++c) {  // the ring's first chunks in flight, a group each
      if (next < nchunks) {
        stage_chunk(next, listed_a && ok_a != 0, row_a);
        advance();
      }
      cp_async_commit();
    }
    for (int ci = 0; ci < nchunks; ++ci) {
      if (next < nchunks && next == ci + ns - 1) {
        stage_chunk(next, listed_a && ok_a != 0, row_a);
        advance();
      }
      cp_async_commit();
      cp_async_wait_n(ns - 1);  // chunk ci's copies have landed
      __syncthreads();          // and every thread's, with its positions
      const int st = ci % ns, nl = s_nlive[st];
      const T* rows = stage + (long long)st * LM_CHUNK * Dr;
      if (LM_ROWS * warp < nl) {  // the warp's rows, in registers
        float xv[LM_ROWS][LM_QREG], xss[LM_ROWS];
#pragma unroll
        for (int r = 0; r < LM_ROWS; ++r) {
          const int k = LM_ROWS * warp + r;
          const T* xr = rows + (long long)(k < nl ? k : 0) * Dr;
          float xm = 0.f;
          if (METRIC == M_PEARSON) {
            float t2 = 0.f;
            for (int c = lane; c < D; c += 32) t2 += to_f(xr[c]);
            xm = wsum(t2) / (float)D;
          }
          if (vec) {
#pragma unroll
            for (int i2 = 0; i2 < NI; ++i2) {
              const int c0 = lane * V + 32 * V * i2;
              uint4 raw = {0u, 0u, 0u, 0u};
              if (c0 < D) raw = *reinterpret_cast<const uint4*>(xr + c0);
              const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
              for (int u = 0; u < V; ++u) xv[r][i2 * V + u] = to_f(tv[u]) - xm;
            }
          } else {
#pragma unroll
            for (int m = 0; m < LM_QREG; ++m)
              xv[r][m] = lane + 32 * m < D ? to_f(xr[lane + 32 * m]) - xm : 0.f;
          }
          // a lane's columns in member_distances' order; those past D skipped
          xss[r] = 0.f;
          if (DOT) {
#pragma unroll
            for (int m = 0; m < LM_QREG; ++m)
              if ((vec ? lane * V + 32 * V * (m / V) : lane + 32 * m) < D)
                xss[r] = fmaf(xv[r][m], xv[r][m], xss[r]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) xss[r] += __shfl_xor_sync(FULL, xss[r], off);
          }
        }
        const int k0 = LM_ROWS * warp;
        for (int j0 = 0; j0 < np; j0 += 2) {  // two pairs at a time: four chains a lane
          const int nj = j0 + 1 < np ? 2 : 1;
          float acc[2][LM_ROWS], acc2[2][LM_ROWS];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < LM_ROWS; ++r) acc[h][r] = acc2[h][r] = 0.f;
          if (vec) {
#pragma unroll
            for (int i2 = 0; i2 < NI; ++i2) {
              const int c0 = lane * V + 32 * V * i2;
              if (c0 >= D) break;
              float qq[2][V];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float* qv = qs + (long long)(j0 + (h < nj ? h : 0)) * Dq + c0;
#pragma unroll
                for (int e = 0; e < V / 4; ++e) {
                  const float4 f = reinterpret_cast<const float4*>(qv)[e];
                  qq[h][4 * e] = f.x;
                  qq[h][4 * e + 1] = f.y;
                  qq[h][4 * e + 2] = f.z;
                  qq[h][4 * e + 3] = f.w;
                }
              }
#pragma unroll
              for (int u = 0; u < V; ++u)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int r = 0; r < LM_ROWS; ++r)
                    pw_step<METRIC>(qq[h][u], xv[r][i2 * V + u], p, acc[h][r], acc2[h][r]);
            }
          } else {
#pragma unroll
            for (int m = 0; m < LM_QREG; ++m) {
              if (lane + 32 * m >= D) break;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float qm = qs[(long long)(j0 + (h < nj ? h : 0)) * Dq + lane + 32 * m];
#pragma unroll
                for (int r = 0; r < LM_ROWS; ++r)
                  pw_step<METRIC>(qm, xv[r][m], p, acc[h][r], acc2[h][r]);
              }
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h >= nj) break;  // uniform
            float d[LM_ROWS];
#pragma unroll
            for (int r = 0; r < LM_ROWS; ++r) {
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) {
                const float oa = __shfl_xor_sync(FULL, acc[h][r], off);
                acc[h][r] = METRIC == M_CHEBYSHEV ? fmaxf(acc[h][r], oa) : acc[h][r] + oa;
                if (METRIC == M_JACCARD) acc2[h][r] += __shfl_xor_sync(FULL, acc2[h][r], off);
              }
              d[r] = pw_finish<METRIC>(DOT ? qss[j0 + h] : 0.f, xss[r], acc[h][r], acc2[h][r], p);
            }
            // lane r keeps row k0 + r's key for the pair's list
            if (lane < LM_ROWS && k0 + lane < nl) {
              float mine = d[0];
#pragma unroll
              for (int r = 1; r < LM_ROWS; ++r) mine = lane == r ? d[r] : mine;
              s_keys[j0 + h][k0 + lane] = pair_of(f2key(mine), s_pos[st][k0 + lane]);
            }
          }
        }
      }
      __syncthreads();  // the chunk's keys are in place
      // each pair's list takes the chunk's keys at once, 32 a warp offer
      for (int j = warp; nl > 0 && j < np; j += LM_WARPS) {
        unsigned long long* kept = lists + (long long)j * kkb;
        warp_offer(kept, kkb, kept[kkb - 1], lane < nl ? s_keys[j][lane] : PAD_PAIR);
      }
      __syncthreads();  // the stage and the keys are refilled a chunk on
    }
    // each pair's picks written
    for (int j = warp; j < np; j += LM_WARPS) {
      const int pair = (int)(keys[a + j] & 0xFFFFFFFFull);
      const long long o = ((long long)pair * G + g) * kkb;
      const unsigned long long* kept = lists + (long long)j * kkb;
      for (int r = lane; r < kkb; r += 32) {
        const unsigned long long v = any ? kept[r] : PAD_PAIR;
        const bool real = v != PAD_PAIR;
        out_d[o + r] = real ? key2f((unsigned)(v >> 32)) : __uint_as_float(0x7f800000u);
        out_i[o + r] = real ? lr[(unsigned)(v & 0xFFFFFFFFull)] : -1;
      }
    }
    __syncthreads();  // the lists and the queries are rewritten by the next item
  }
}

// the (mode, G, kkb) of a rerank: mode -1 chooses
void rerank_shape(int Q, int S, int P, int L, int kk, int D, int tsize, int mode, int* out) {
  const int np = Q * S * P;
  const bool fits = np <= LM_MAX_PAIRS &&
                    lm_fit(D, tsize, min(kk, kk > KNN_FUSED_MAX_K ? 256 : LM_RANGE), np).qb > 0;
  if (mode < 0) mode = Q >= LM_MIN_Q && fits ? 1 : 0;
  if (mode == 1 && !fits) mode = -1;  // refused
  long long G;
  if (mode == 1) {
    G = (L + (kk > KNN_FUSED_MAX_K ? 256 : LM_RANGE) - 1) / (kk > KNN_FUSED_MAX_K ? 256 : LM_RANGE);
  } else {
    // about four blocks an SM; a kk above knn_search_max_k() splits a list
    // into ranges of at most that many positions, so a block's list holds
    // all its candidates
    const long long lists = (long long)np;
    G = (4LL * sm_count() + lists - 1) / lists;
    G = max(1LL, min(G, (long long)(L + 31) / 32));
    if (kk > KNN_FUSED_MAX_K) G = max(G, (long long)(L + KNN_FUSED_MAX_K - 1) / KNN_FUSED_MAX_K);
  }
  out[0] = mode;
  out[1] = (int)G;
  out[2] = min(kk, ir_span(L, (int)G));
}

template <int M, typename T>
int launch_rerank(const float* q, int Q, int D, float p, const int* probes, int P, const T* x,
                  long long cap, const int* list_rows, const unsigned char* list_mask, int C,
                  int L, const unsigned char* slot_ok, int S, int mode, int G, int kkb,
                  unsigned* ticket, float* out_d, int* out_i, cudaStream_t s) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (D % (16 / (int)sizeof(T)) == 0);
  if (mode == 0) {
    static std::atomic<unsigned> seen{0};
    const int smem = ir_smem_bytes(D, kkb);
    if (smem > SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
    if (int err = opt_in_smem(rerank_pairs_kernel<M, T>, smem > 48 * 1024 ? SMEM_OPT_IN : smem,
                              seen))
      return err;
    const long long blocks = (long long)Q * S * P * G;
    rerank_pairs_kernel<M, T><<<(unsigned)blocks, IR_THREADS, smem, s>>>(
        q, D, p, probes, P, x, cap, list_rows, list_mask, C, L, slot_ok, S, G, kkb, vec, out_d,
        out_i);
    return (int)cudaGetLastError();
  }
  const int np = Q * S * P;
  const LmPlan pl = lm_fit(D, (int)sizeof(T), kkb, np);
  if (np > LM_MAX_PAIRS || pl.qb == 0 || ticket == nullptr) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s)) return (int)e;
  static std::atomic<unsigned> seen{0};
  if (int err = opt_in_smem(rerank_lists_kernel<M, T>, SMEM_OPT_IN, seen)) return err;
  const int per_sm = max(1, (int)(SMEM_OPT_IN / pl.bytes));
  const long long items = (long long)np * G;  // the groups are at most the pairs
  const long long grid = min(items, (long long)sm_count() * per_sm);
  if (items > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  rerank_lists_kernel<M, T><<<(unsigned)grid, LM_THREADS, (size_t)pl.bytes, s>>>(
      q, D, p, probes, P, x, cap, list_rows, list_mask, C, L, slot_ok, S, G, kkb, vec, np, pl,
      ticket, out_d, out_i);
  return (int)cudaGetLastError();
}

template <typename T>
int rerank_dispatch(int metric, const float* q, int Q, int D, float p, const int* probes, int P,
                    const T* x, long long cap, const int* list_rows,
                    const unsigned char* list_mask, int C, int L, const unsigned char* slot_ok,
                    int S, int mode, int G, int kkb, unsigned* ticket, float* out_d, int* out_i,
                    cudaStream_t s) {
#define IR_CASE(M)                                                                         \
  case M:                                                                                  \
    return launch_rerank<M, T>(q, Q, D, p, probes, P, x, cap, list_rows, list_mask, C, L, \
                               slot_ok, S, mode, G, kkb, ticket, out_d, out_i, s);
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

}  // namespace

extern "C" {

// x [cap, D] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); idx [n] i32 or null
// (then row r is x[r] and n <= cap); cents [C, D] f32; out [n, k] i32 with
// k in {1, 2} <= C: the nearest centroids of each row, nearest first.
// bf16 x only: limbs [3, C, ivf_assign_limb_pitch(D)] bf16 and cnorm [C]
// f32, scratch the launch writes first.
int ivf_assign(const void* x, int x_bf16, const void* idx, long long n, long long cap,
               const void* cents, int C, int D, int k, void* limbs, void* cnorm, void* out,
               void* stream) {
  if (n <= 0 || cap <= 0 || C <= 0 || D <= 0 || k < 1 || k > 2 || k > C)
    return (int)cudaErrorInvalidValue;
  if (idx == nullptr && n > cap) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16) {
    assign_f32_kernel<<<(unsigned)((n + AS_TR - 1) / AS_TR), AS_THREADS, 0, s>>>(
        (const float*)x, (const int*)idx, cap, n, (const float*)cents, C, D, k, (int*)out);
    return (int)cudaGetLastError();
  }
  if (limbs == nullptr || cnorm == nullptr) return (int)cudaErrorInvalidValue;
  const int Dp = limb_pitch(D);
  split_centroids<<<(unsigned)((C + 7) / 8), 256, 0, s>>>(
      (const float*)cents, C, D, Dp, (unsigned short*)limbs, (float*)cnorm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static std::atomic<unsigned> seen{0};
  if (int err = opt_in_smem(assign_tc_kernel, TC_SMEM, seen)) return err;
  const int vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  assign_tc_kernel<<<(unsigned)((n + TC_BM - 1) / TC_BM), TC_THREADS, TC_SMEM, s>>>(
      (const unsigned short*)x, (const int*)idx, cap, n, (const unsigned short*)limbs,
      (const float*)cnorm, (const float*)cents, C, D, Dp, k, vec, (int*)out);
  return (int)cudaGetLastError();
}

// bf16 of a limb plane's row: D rounded up to 16
int ivf_assign_limb_pitch(int D) { return limb_pitch(D); }

// bytes of scratch ivf_kmeans_update takes for n rows of D columns and C
// centroids; -1 for a shape it does not take
long long ivf_kmeans_update_scratch_bytes(long long n, int D, int C) {
  if (n <= 0 || D <= 0 || C <= 0) return -1;
  return up_layout(n, D, C).bytes;
}

// x [n, D] f32 / bf16; assign [n] i32; c_old [C, D] f32 -> c_new [C, D] f32
// (the mean of each centroid's rows in the order of the K4 note above,
// c_old where it has none) and counts [C] i32; scratch:
// ivf_kmeans_update_scratch_bytes(n, D, C) bytes, 16-byte aligned, that
// the launches write before they read. Three launches.
int ivf_kmeans_update(const void* x, int x_bf16, long long n, int D, const void* assign,
                      const void* c_old, int C, void* scratch, void* c_new, void* counts,
                      void* stream) {
  const long long scan_smem = (3LL * C + 2) * 4;
  if (n <= 0 || n > 0x7fffffffLL || D <= 0 || C <= 0 || scratch == nullptr ||
      scan_smem > SMEM_OPT_IN || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const UpLayout L = up_layout(n, D, C);
  const cudaStream_t s = (cudaStream_t)stream;
  char* b = (char*)scratch;
  int* hist = (int*)(b + L.hist);
  int* order = (int*)(b + L.order);
  int* start = (int*)(b + L.start);
  int* istart = (int*)(b + L.istart);
  int* item_c = (int*)(b + L.item_c);
  unsigned* ticket = (unsigned*)(b + L.ticket);
  float* partial = (float*)(b + L.partial);
  const int* a = (const int*)assign;
  static std::atomic<unsigned> seen_count{0}, seen_scatter{0};
  if (int err = opt_in_smem(up_count_kernel, SMEM_OPT_IN, seen_count)) return err;
  if (int err = opt_in_smem(up_scatter_kernel, SMEM_OPT_IN, seen_scatter)) return err;
  up_count_kernel<<<(unsigned)L.NT, UP_THREADS, (size_t)C * 4, s>>>(a, n, C, (int)L.T, hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  up_scatter_kernel<<<(unsigned)L.NT, UP_THREADS, (size_t)scan_smem, s>>>(
      a, n, C, (int)L.T, (int)L.NT, hist, order, start, istart, item_c, ticket, (int*)counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int elt = x_bf16 ? 2 : 4;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (long long)D * elt % 16 == 0;
  if (x_bf16)
    return up_sum_launch((const __nv_bfloat16*)x, D, C, vec, L.items, order, start, istart,
                         item_c, (const float*)c_old, partial, ticket, (float*)c_new, s);
  return up_sum_launch((const float*)x, D, C, vec, L.items, order, start, istart, item_c,
                       (const float*)c_old, partial, ticket, (float*)c_new, s);
}

// K3's rerank (S = 1) and K13's (S shards of one device), one launch:
// q [Q, D] f32; probes [Q, P] i32 (list ids); x [S * cap, D] f32 / bf16
// (shard s's rows from s * cap); list_rows [S, C, L] i32 (slots local to
// the shard) and list_mask [S, C, L] u8; slot_ok [S * cap] u8 or null
// (every slot); mode 0 pair-major, 1 list-major, with G ranges a list and
// kkb picks a block, all three from ivf_rerank_plan; work: 4 bytes of
// scratch for the list-major blocks' work ticket (reset here), null for
// pair-major. out_d / out_i [Q, S *
// P * G * kkb]: each (query, shard, probe rank, range)'s picks, sorted by
// (distance, position), +inf / -1 past its candidates; a query's row lies
// in (shard, probe rank, range) order, so mesh_topk_merge with kk = P * G *
// kkb selects them in the reference's (distance, shard, position) order
// and adds the shard offsets.
int ivf_rerank(const void* q, int Q, int D, int metric, float p, const void* probes, int P,
               const void* x, int x_bf16, long long cap, const void* list_rows,
               const void* list_mask, int C, int L, const void* slot_ok, int S, int mode, int G,
               int kkb, void* work, void* out_d, void* out_i, void* stream) {
  if (Q <= 0 || D <= 0 || P <= 0 || cap <= 0 || C <= 0 || L <= 0 || S <= 0 || G <= 0 ||
      kkb <= 0 || kkb > KNN_FUSED_MAX_K || kkb > ir_span(L, G) || mode < 0 || mode > 1 ||
      (long long)Q * S * P * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* pr = (const int*)probes;
  const int* lr = (const int*)list_rows;
  const unsigned char* lm = (const unsigned char*)list_mask;
  const unsigned char* ok = (const unsigned char*)slot_ok;
  if (x_bf16)
    return rerank_dispatch<__nv_bfloat16>(metric, (const float*)q, Q, D, p, pr, P,
                                          (const __nv_bfloat16*)x, cap, lr, lm, C, L, ok, S, mode,
                                          G, kkb, (unsigned*)work, (float*)out_d, (int*)out_i, s);
  return rerank_dispatch<float>(metric, (const float*)q, Q, D, p, pr, P, (const float*)x, cap, lr,
                                lm, C, L, ok, S, mode, G, kkb, (unsigned*)work, (float*)out_d,
                                (int*)out_i, s);
}

// out [3]: the mode (mode -1: the plan's choice, list-major from LM_MIN_Q
// queries where its shared memory fits; 0 / 1 asked for), G and kkb of a
// rerank of Q queries x S shards x P probes over lists of L positions,
// top-kk, D-wide rows (bf16 with x_bf16). Sized on the current card.
// Returns cudaErrorInvalidValue when the list-major mode is asked for and
// does not fit.
int ivf_rerank_plan(int Q, int S, int P, int L, int kk, int D, int x_bf16, int mode, int* out) {
  if (Q <= 0 || S <= 0 || P <= 0 || L <= 0 || kk <= 0 || D <= 0 || mode < -1 || mode > 1)
    return (int)cudaErrorInvalidValue;
  rerank_shape(Q, S, P, L, kk, D, x_bf16 ? 2 : 4, mode, out);
  return out[0] < 0 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

}  // extern "C"
