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
// What bounds it: reading the n rows once (bytes). Design, deterministic:
// a block owns 8 centroids and scans the assignment vector in rounds of
// 2048 entries; each round compacts the rows of each of its centroids in
// row order into shared memory (per-thread counts packed 16 bits a group,
// one warp scan and one block prefix) and sums them in that order, one
// thread a column; no float atomics, so two runs on the same data agree
// bit for bit.
//
// K3 ivf_gather_distance + ivf_map_slots replace the rerank of
// surrealdb_tpu/idx/ivf.py:_ivf_search (its probe is K2 over the
// centroids, its top-k is K2's knn_select). ivf_gather_distance writes, for
// each query and each probed list (in probe rank order) and each list
// position, the distance with `metric` to the list's member row, or +inf
// where the list slot is padding or the slot's slot_ok byte is 0 (the row
// is then not read): a [Q, nprobe*L] f32 array in the order of the
// reference's concatenated candidates. What bounds it: reading the
// candidate rows (bytes). Design: the grid covers (query, probe, chunk of
// 64 list positions), so the whole card reads the candidates; a warp
// computes one row at a time with 16-byte loads and a shuffle reduction;
// the query sits in shared memory. ivf_map_slots maps each selected
// position back to its corpus slot, -1 where the distance is +inf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "metric.cuh"
#include "mma.cuh"

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

constexpr int UP_THREADS = 256;
constexpr int UP_GROUP = 8;                       // centroids a block
constexpr int UP_PER_THREAD = 8;                  // consecutive entries a thread
constexpr int UP_CHUNK = UP_THREADS * UP_PER_THREAD;  // entries compacted a round

// dynamic shared memory: sums [UP_GROUP][D] f32, then member lists
// [UP_GROUP][UP_CHUNK] i32
size_t update_smem_bytes(int D) {
  return (size_t)UP_GROUP * D * sizeof(float) + (size_t)UP_GROUP * UP_CHUNK * sizeof(int);
}

// Per-group counts of a round, packed 16 bits a group (a round holds at
// most UP_CHUNK = 2048 entries): groups 0-3 in .x, 4-7 in .y, so one pair
// of 64-bit adds moves all eight counts at once.
struct Packed8 {
  unsigned long long x, y;
};

__device__ __forceinline__ Packed8 p8_add(Packed8 a, Packed8 b) { return {a.x + b.x, a.y + b.y}; }

__device__ __forceinline__ Packed8 p8_one(int g) {
  const unsigned long long bit = 1ull << (16 * (g & 3));
  return g < 4 ? Packed8{bit, 0ull} : Packed8{0ull, bit};
}

__device__ __forceinline__ int p8_get(Packed8 a, int g) {
  return (int)(((g < 4 ? a.x : a.y) >> (16 * (g & 3))) & 0xFFFFull);
}

template <typename T>
__global__ void __launch_bounds__(UP_THREADS)
kmeans_update_kernel(const T* __restrict__ x, long long n, int D,
                     const int* __restrict__ assign, const float* __restrict__ c_old, int C,
                     float* __restrict__ c_new, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char up_smem[];
  float* sums = reinterpret_cast<float*>(up_smem);
  int* lists = reinterpret_cast<int*>(sums + (size_t)UP_GROUP * D);
  __shared__ Packed8 warp_tot[UP_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = blockIdx.x * UP_GROUP;

  for (int i = tid; i < UP_GROUP * D; i += UP_THREADS) sums[i] = 0.f;
  int total[UP_GROUP];
#pragma unroll
  for (int g = 0; g < UP_GROUP; ++g) total[g] = 0;

  for (long long base = 0; base < n; base += UP_CHUNK) {
    // ordered compaction: thread t owns the UP_PER_THREAD consecutive
    // entries from base + t * UP_PER_THREAD; a block-wide exclusive scan of
    // the per-group counts (in thread order) places each thread's rows, so
    // list g holds the rows of centroid g0 + g of this round in row order
    int grp[UP_PER_THREAD];
    Packed8 mine = {0ull, 0ull};
#pragma unroll
    for (int u = 0; u < UP_PER_THREAD; ++u) {
      const long long r = base + tid * UP_PER_THREAD + u;
      const int g = r < n ? assign[r] - g0 : -1;
      grp[u] = (g >= 0 && g < UP_GROUP) ? g : -1;
      if (grp[u] >= 0) mine = p8_add(mine, p8_one(grp[u]));
    }
    Packed8 incl = mine;  // inclusive scan across the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Packed8 up = {__shfl_up_sync(0xffffffffu, incl.x, o),
                          __shfl_up_sync(0xffffffffu, incl.y, o)};
      if (lane >= o) incl = p8_add(incl, up);
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    Packed8 pos = {incl.x - mine.x, incl.y - mine.y};  // exclusive, within the warp
    Packed8 round = {0ull, 0ull};
    for (int w = 0; w < UP_THREADS / 32; ++w) {
      if (w < warp) pos = p8_add(pos, warp_tot[w]);
      round = p8_add(round, warp_tot[w]);
    }
#pragma unroll
    for (int u = 0; u < UP_PER_THREAD; ++u) {
      const int g = grp[u];
      if (g >= 0) {
        lists[g * UP_CHUNK + p8_get(pos, g)] = (int)(base + tid * UP_PER_THREAD + u);
        pos = p8_add(pos, p8_one(g));
      }
    }
    __syncthreads();
    // sum the members in row order, one thread a column
#pragma unroll
    for (int g = 0; g < UP_GROUP; ++g) {
      const int m_end = p8_get(round, g);
      total[g] += m_end;
      const int* lst = lists + g * UP_CHUNK;
      for (int d = tid; d < D; d += UP_THREADS) {
        float acc = sums[g * D + d];
#pragma unroll 4
        for (int m = 0; m < m_end; ++m) acc += to_f(x[(long long)lst[m] * D + d]);
        sums[g * D + d] = acc;
      }
    }
    __syncthreads();  // lists and warp_tot are rewritten next round
  }
  // the mean; an empty cluster keeps its previous centroid
  for (int i = tid; i < UP_GROUP * D; i += UP_THREADS) {
    const int g = i / D, d = i % D, c = g0 + g;
    if (c >= C) continue;
    int cnt = 0;
#pragma unroll
    for (int h = 0; h < UP_GROUP; ++h) cnt = h == g ? total[h] : cnt;
    c_new[(long long)c * D + d] = cnt > 0 ? sums[i] / (float)cnt : c_old[(long long)c * D + d];
  }
  if (tid < UP_GROUP && g0 + tid < C) {
    int cnt = 0;
#pragma unroll
    for (int h = 0; h < UP_GROUP; ++h) cnt = h == tid ? total[h] : cnt;
    counts[g0 + tid] = cnt;
  }
}

// ------------------------------------------------------------------ K3

constexpr int GD_THREADS = 256;
constexpr int GD_SLOTS = 64;  // list positions a block, 8 a warp

// Block b covers query qi, probe rank pr and list positions
// [chunk * GD_SLOTS, + GD_SLOTS) of list probes[qi, pr]; out[qi, pr*L + j].
template <int METRIC, typename T>
__global__ void __launch_bounds__(GD_THREADS)
gather_distance_kernel(const float* __restrict__ q, const T* __restrict__ x, long long cap,
                       int D, float p, const int* __restrict__ probes, int P,
                       const int* __restrict__ list_rows,
                       const unsigned char* __restrict__ list_mask, int L,
                       const unsigned char* __restrict__ slot_ok, float* __restrict__ out,
                       int vec) {
  constexpr bool DOT = is_dot_metric<METRIC>();
  constexpr int V = 16 / (int)sizeof(T);  // row values in 16 bytes
  extern __shared__ __align__(16) float gd_q[];  // [D], centred for pearson
  __shared__ float s_red[GD_THREADS / 32];
  __shared__ float s_qmean, s_qss;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long chunks = (L + GD_SLOTS - 1) / GD_SLOTS;
  const long long qp = blockIdx.x / chunks;  // query * P + probe rank
  const int chunk = (int)(blockIdx.x % chunks);
  const int qi = (int)(qp / P), pr = (int)(qp % P);
  const int list = probes[qp];

  float part = 0.f;
  for (int c = tid; c < D; c += GD_THREADS) {
    const float v = q[(long long)qi * D + c];
    gd_q[c] = v;
    part += v;
  }
  if (METRIC == M_PEARSON) {
    part = warp_sum(part);
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < GD_THREADS / 32; ++w) s += s_red[w];
      s_qmean = s / (float)D;
    }
    __syncthreads();
    for (int c = tid; c < D; c += GD_THREADS) gd_q[c] -= s_qmean;
  }
  __syncthreads();
  if (DOT) {
    float s = 0.f;
    for (int c = tid; c < D; c += GD_THREADS) s = fmaf(gd_q[c], gd_q[c], s);
    s = warp_sum(s);
    if (lane == 0) s_red[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < GD_THREADS / 32; ++w) t += s_red[w];
      s_qss = t;
    }
    __syncthreads();
  }
  const float qss = DOT ? s_qss : 0.f;

  constexpr int PER_WARP = GD_SLOTS / (GD_THREADS / 32);
  for (int t = 0; t < PER_WARP; ++t) {
    const int j = chunk * GD_SLOTS + warp * PER_WARP + t;
    if (j >= L) break;  // uniform in the warp
    float* o = out + (long long)qi * P * L + (long long)pr * L + j;
    long long row = list_rows[(long long)list * L + j];
    row = row < 0 ? 0 : (row >= cap ? cap - 1 : row);
    if (!list_mask[(long long)list * L + j] || !slot_ok[row]) {
      if (lane == 0) *o = __uint_as_float(0x7f800000u);  // +inf, the row unread
      continue;
    }
    const T* xr = x + row * D;
    float xm = 0.f;
    if (METRIC == M_PEARSON) {
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
      xm = warp_sum(s) / (float)D;
    }
    float acc = 0.f, acc2 = 0.f, xss = 0.f;
    if (vec) {
      for (int c0 = lane * V; c0 < D; c0 += 32 * V) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + c0));
        const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float xv = to_f(tv[u]) - xm;
          pw_step<METRIC>(gd_q[c0 + u], xv, p, acc, acc2);
          if (DOT) xss = fmaf(xv, xv, xss);
        }
      }
    } else {
      for (int c = lane; c < D; c += 32) {
        const float xv = to_f(xr[c]) - xm;
        pw_step<METRIC>(gd_q[c], xv, p, acc, acc2);
        if (DOT) xss = fmaf(xv, xv, xss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oa = __shfl_xor_sync(0xffffffffu, acc, off);
      acc = METRIC == M_CHEBYSHEV ? fmaxf(acc, oa) : acc + oa;
      acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
      xss += __shfl_xor_sync(0xffffffffu, xss, off);
    }
    if (lane == 0) *o = pw_finish<METRIC>(qss, xss, acc, acc2, p);
  }
}

template <int M, typename T>
int launch_gather(const float* q, const T* x, long long cap, int D, float p, const int* probes,
                  int Q, int P, const int* list_rows, const unsigned char* list_mask, int L,
                  const unsigned char* slot_ok, float* out, cudaStream_t s) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (D % (16 / (int)sizeof(T)) == 0);
  const unsigned blocks = (unsigned)((long long)Q * P * ((L + GD_SLOTS - 1) / GD_SLOTS));
  const size_t smem = (size_t)D * sizeof(float);
  static std::atomic<unsigned> seen{0};
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  if (int err = opt_in_smem(gather_distance_kernel<M, T>, SMEM_OPT_IN, seen)) return err;
  gather_distance_kernel<M, T><<<blocks, GD_THREADS, smem, s>>>(
      q, x, cap, D, p, probes, P, list_rows, list_mask, L, slot_ok, out, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int gather_dispatch(int metric, const float* q, const T* x, long long cap, int D, float p,
                    const int* probes, int Q, int P, const int* list_rows,
                    const unsigned char* list_mask, int L, const unsigned char* slot_ok,
                    float* out, cudaStream_t s) {
  switch (metric) {
    case M_EUCLIDEAN: return launch_gather<M_EUCLIDEAN, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    case M_COSINE: return launch_gather<M_COSINE, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    case M_MANHATTAN: return launch_gather<M_MANHATTAN, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    case M_CHEBYSHEV: return launch_gather<M_CHEBYSHEV, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    case M_HAMMING: return launch_gather<M_HAMMING, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    case M_JACCARD: return launch_gather<M_JACCARD, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    case M_PEARSON: return launch_gather<M_PEARSON, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    case M_MINKOWSKI: return launch_gather<M_MINKOWSKI, T>(q, x, cap, D, p, probes, Q, P, list_rows, list_mask, L, slot_ok, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void map_slots_kernel(const int* __restrict__ probes, int P,
                                 const int* __restrict__ list_rows, int L,
                                 const float* __restrict__ sel_d, const int* __restrict__ sel_i,
                                 long long total, int k, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long qi = i / k;
  const int pos = sel_i[i];
  int slot = -1;
  if (sel_d[i] < __uint_as_float(0x7f800000u) && pos >= 0) {
    const int pr = pos / L, j = pos % L;
    slot = list_rows[(long long)probes[qi * P + pr] * L + j];
  }
  out[i] = slot;
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

// x [n, D] f32 / bf16; assign [n] i32; c_old [C, D] f32 -> c_new [C, D] f32
// (the mean of each centroid's rows, c_old where it has none) and
// counts [C] i32.
int ivf_kmeans_update(const void* x, int x_bf16, long long n, int D, const void* assign,
                      const void* c_old, int C, void* c_new, void* counts, void* stream) {
  if (n <= 0 || D <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = update_smem_bytes(D);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((C + UP_GROUP - 1) / UP_GROUP);
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> seen_bf16{0}, seen_f32{0};
  if (x_bf16) {
    if (int err = opt_in_smem(kmeans_update_kernel<__nv_bfloat16>, SMEM_OPT_IN, seen_bf16))
      return err;
    kmeans_update_kernel<__nv_bfloat16><<<blocks, UP_THREADS, smem, s>>>(
        (const __nv_bfloat16*)x, n, D, (const int*)assign, (const float*)c_old, C,
        (float*)c_new, (int*)counts);
  } else {
    if (int err = opt_in_smem(kmeans_update_kernel<float>, SMEM_OPT_IN, seen_f32)) return err;
    kmeans_update_kernel<float><<<blocks, UP_THREADS, smem, s>>>(
        (const float*)x, n, D, (const int*)assign, (const float*)c_old, C, (float*)c_new,
        (int*)counts);
  }
  return (int)cudaGetLastError();
}

// q [Q, D] f32; x [cap, D] f32 / bf16; probes [Q, P] i32 (list ids);
// list_rows [C, L] i32, list_mask [C, L] u8; slot_ok [cap] u8;
// out [Q, P*L] f32: distance with `metric` (codes of knn.cu), +inf where
// the list slot is padding or its slot is not ok.
int ivf_gather_distance(const void* q, const void* x, int x_bf16, long long cap, int D,
                        int metric, float p, const void* probes, int Q, int P,
                        const void* list_rows, const void* list_mask, int L,
                        const void* slot_ok, void* out, void* stream) {
  if (Q <= 0 || P <= 0 || L <= 0 || D <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* pr = (const int*)probes;
  const int* lr = (const int*)list_rows;
  const unsigned char* lm = (const unsigned char*)list_mask;
  const unsigned char* ok = (const unsigned char*)slot_ok;
  if (x_bf16)
    return gather_dispatch<__nv_bfloat16>(metric, (const float*)q, (const __nv_bfloat16*)x, cap, D,
                                          p, pr, Q, P, lr, lm, L, ok, (float*)out, s);
  return gather_dispatch<float>(metric, (const float*)q, (const float*)x, cap, D, p, pr, Q, P,
                                lr, lm, L, ok, (float*)out, s);
}

// sel_d / sel_i [Q, k]: knn_select's picks over ivf_gather_distance's
// [Q, P*L] output; out [Q, k] i32: the corpus slot of each pick, -1 where
// its distance is +inf.
int ivf_map_slots(const void* probes, int Q, int P, const void* list_rows, int L,
                  const void* sel_d, const void* sel_i, int k, void* out, void* stream) {
  if (Q <= 0 || P <= 0 || L <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)Q * k;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  map_slots_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)probes, P, (const int*)list_rows, L, (const float*)sel_d, (const int*)sel_i,
      total, k, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
