// Graph-traversal kernels for Hopper (sm_90a), behind the same plain C
// interface as knn.cu and ivf.cu (one library, loaded with ctypes by
// surrealdb_tpu_torch/ops/_cuda.py). All three count paths of
// surrealdb_tpu/idx/graph_csr.py GraphMirrors._chain_frontier; every count is
// an exact integer, so no kernel here rounds.
//
// K8 graph_dense_count replaces surrealdb_tpu/idx/graph_csr.py
// dense_count_batch: out[b] = ((x_b A_0 ... A_{m-1}) * outdeg).sum(), x_b
// the seeds of lane b densified over the first space (w > 0 only, index
// clip(fr, 0, n0), column n0 dropped), each A_i a composed node-to-node
// operator (bf16, read exactly into f32). Regrouped, the same count is
// out[b] = sum_j [w > 0] w * u_0[clip(fr, 0, n0)] (an index n0 adding
// nothing) with u_m = outdeg and u_i = A_i u_{i+1}: m matrix-vector
// passes over the operators, whatever B, then a gather-dot over the seeds.
// The regrouping is exact: every quantity is a nonnegative integer and the
// caller's guard (graph_csr.py _dense_chain_count: sum of the seed weights
// x the product of the operators' infinity norms below 2^24) bounds every
// entry of every u_i and every partial sum, where f32 sums are exact in
// any order. What bounds it: reading each A_i's bf16 bytes once (61 us of
// HBM at n0 = n1 = 10,112); n0 n1 FMAs a pass are far below that. Design
// (dense_matvec): a persistent grid of a few blocks an SM; each block
// stages u_{i+1} (at most 64 KB at the dense path's 16,384 columns) in
// shared memory, split into two planes so a warp's 16-byte reads hit
// every bank once, then its warps walk work items of (row, 2,048-column
// segment) of A_i: each lane issues its eight 16-byte loads of the segment
// at once, the warp adds its products with shuffles and one lane adds the
// segment's sum into u_i[row] (float atomicAdd, exact by the guard). Items
// of a fifth of a row keep the warps' shares even. seed_dot then gives
// each lane of B one block. No [B, n] array is made.
//
// K7 graph_csc_count replaces dense_count_batch's sibling chain_count_batch:
// B count chains over destination-sorted (cptr, csrc) adjacency. The
// reference's cumsum-and-difference form exists because scatter is slow on
// a TPU; this computes what it computes, y[v, b] = sum over the edges e of v
// of x[csrc[e], b] (summed over the hop's mirrors), then sum_v x[v, b] *
// deg(v) over the last hop. int32 sums wrap exactly as the reference's
// cumsum difference does (unsigned arithmetic here), so any order gives the
// same bits, and a row whose lanes all sum to 0 counts as a row never
// written. What bounds it: reading the CSC arrays once (bytes). Design:
// - live rows only: x is lane-minor ([rows, B]) with a live bitmap a hop
//   (2^20 rows: 128 KB, in L2); a source whose bit is clear is not read, a
//   destination with no live source is not written and stays clear, and
//   nothing the size of x is memset (the seeds' rows are zeroed, then
//   summed); the degree dot walks the live rows (live_dot);
// - fused edge hops: where a hop's CSC gives every node at most one
//   source (an edge table's `->edge` hop: each record has one `in`; the
//   host checks it once a mirror generation, graph_csr.py csc_facts), it
//   and the hop after run as one: y[v] = sum over e of v of x[src1(csrc2[e])],
//   so the edge-wide intermediate is never written; the reference's index
//   rules apply at both levels (a negative index wraps once, then clamps
//   into the width, so a gather past it reads the last column; column
//   n_cap and the sentinel read zero; a reversed segment negates);
// - hop_edges (pointers that rise; the host gives each edge's destination):
//   a warp a range of 256 edges moved to whole destinations, so it owns
//   what it writes (no atomics on x), lanes over edges (coalesced), each
//   live source's B lanes read as one line, four rows in flight;
//   hop_dests (any pointers, or B above 128): a warp a destination.
// The reference's shapes are kept: x starts n_cap + 1 wide, each hop's
// output is its mirrors' cap (+ a zero sentinel) wide.
//
// K6 graph_chain replaces chain_kernel (chain_impl, gather_hop, accum_cap):
// one frontier's multi-hop chain. Each hop is a weighted CSR gather with the
// reference's clips and validity (offs < deg, weight > 0, frontier < n), an
// int32 scatter-add (integer atomicAdd: any order gives the same sums) with
// the sentinel dropped, and the nodes with a signed count > 0 in ascending
// id order, truncated at the hop's out_size and filled with (n_cap, 0), as
// nonzero(size=..., fill_value=n_cap). The order is part of the result
// (chain() emits records in it). A count-only chain ends with the weighted
// degree reduction. Design: touched nodes only. The caller keeps a count
// array [n_cap + 1] and a bitmap of the touched nodes ((n_cap + 32) / 32
// words, 128 KB at 2^20: it sits in L2) zero between calls; a hop is two
// launches: chain_gather (adds each weight with atomicAdd, sets the node's
// bit with atomicOr, writes the hop's (n_cap, 0) fill) and bit_compact
// (a block a tile of 256 bitmap words: a touched node whose count is > 0
// is kept, every count and word read is cleared; a thread reads its word's
// counts as 16-byte groups all at once, so a word with many touched nodes
// costs one round trip; the kept nodes take their ranks by a block scan and
// lookback.cuh's decoupled look-back, and go out a warp a word, so a
// densely touched tile still writes coalesced). Nothing
// the size of the count array is memset or scanned. What bounds it: the
// gathered adjacency and the outputs (bytes); the bitmap's 128 KB the
// design's floor beside them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
static_assert(THREADS == GRID_THREADS, "grid_for sizes the grids of THREADS-thread blocks");

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ------------------------------------------------------------------ K8

constexpr int MV_THREADS = 256;
constexpr int MV_WARPS = MV_THREADS / 32;
constexpr int MV_SEG = 2048;                   // columns of a row a work item (4 KB of bf16)
constexpr int MV_VPL = MV_SEG / 8 / 32;        // 16-byte loads a lane an item
constexpr int MV_BLOCKS_PER_SM = 4;
constexpr int MV_MAX_COLS = 48 * 1024;         // u in shared memory: 192 KB at most
constexpr int MV_SMEM_SM = 227 * 1024;         // shared memory an SM gives its blocks

// y[r] += sum_c A[r, c] u[c] for r < R; A [R, N] bf16 row-major, 16-byte
// aligned rows (N % 8 == 0), u [N] f32, y [R] f32 zeroed. Work item t is
// row t / nseg, segment t % nseg; warp w of the grid takes w, w + warps, ...
// u sits in shared memory as two planes: column 8 v + 4 h + q at h N / 2 +
// 4 v + q, so the float4s that meet a lane's 16 bytes of A (vector v) are
// consecutive across the warp.
__global__ void __launch_bounds__(MV_THREADS, MV_BLOCKS_PER_SM) dense_matvec(const uint16_t* __restrict__ A,
                                                           long long R, int N,
                                                           const float* __restrict__ u,
                                                           float* __restrict__ y) {
  extern __shared__ __align__(16) float mv_u[];
  const int half = N / 2;
  for (int c = threadIdx.x; c < N; c += MV_THREADS)
    mv_u[((c >> 2) & 1) * half + (c >> 3) * 4 + (c & 3)] = u[c];
  __syncthreads();
  const float4* ulo = reinterpret_cast<const float4*>(mv_u);
  const float4* uhi = reinterpret_cast<const float4*>(mv_u + half);
  const int lane = threadIdx.x & 31;
  const int nvec = N / 8, nseg = (N + MV_SEG - 1) / MV_SEG;
  const long long items = R * nseg, warps = (long long)gridDim.x * MV_WARPS;
  for (long long t = (long long)blockIdx.x * MV_WARPS + (threadIdx.x >> 5); t < items;
       t += warps) {  // whole warps
    const long long r = t / nseg;
    const int v0 = (int)(t % nseg) * (MV_SEG / 8) + lane;
    const uint4* row = reinterpret_cast<const uint4*>(A + r * N);
    uint4 a[MV_VPL];
#pragma unroll
    for (int j = 0; j < MV_VPL; ++j) {  // all loads in flight before the first use
      a[j] = {0u, 0u, 0u, 0u};
      if (v0 + 32 * j < nvec) a[j] = __ldg(row + v0 + 32 * j);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MV_VPL; ++j) {
      const int v = v0 + 32 * j;
      if (v >= nvec) break;
      // bf16 -> f32 is exact: the bf16 bits are the f32's high half
      const float4 lo = ulo[v], hi = uhi[v];
      s = fmaf(__uint_as_float(a[j].x << 16), lo.x, s);
      s = fmaf(__uint_as_float(a[j].x & 0xffff0000u), lo.y, s);
      s = fmaf(__uint_as_float(a[j].y << 16), lo.z, s);
      s = fmaf(__uint_as_float(a[j].y & 0xffff0000u), lo.w, s);
      s = fmaf(__uint_as_float(a[j].z << 16), hi.x, s);
      s = fmaf(__uint_as_float(a[j].z & 0xffff0000u), hi.y, s);
      s = fmaf(__uint_as_float(a[j].w << 16), hi.z, s);
      s = fmaf(__uint_as_float(a[j].w & 0xffff0000u), hi.w, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && s != 0.f) atomicAdd(&y[r], s);
  }
}

// out[b] = sum_j [w > 0] w * u[clip(fr, 0, n)] over lane b's seeds, an
// index n adding nothing; a block a lane.
__global__ void __launch_bounds__(THREADS) seed_dot(const int* fr, const int* w, int fsz,
                                                    const float* u, int n, float* out) {
  __shared__ float part[THREADS / 32];
  const long long base = (long long)blockIdx.x * fsz;
  float s = 0.f;
  for (int j = threadIdx.x; j < fsz; j += THREADS) {
    const int wv = w[base + j];
    const long long c = clampll(fr[base + j], 0, n);
    if (wv > 0 && c < n) s = fmaf((float)wv, u[c], s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) t += part[i];
    out[blockIdx.x] = t;
  }
}

cudaError_t launch_matvec(const uint16_t* A, int R, int N, const float* u, float* y,
                          cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(y, 0, (size_t)R * sizeof(float), s);
  if (e != cudaSuccess) return e;
  // the limit is raised to the widest u once a device, not per launch
  static std::atomic<unsigned> seen{0};
  if ((e = (cudaError_t)opt_in_smem(dense_matvec, MV_MAX_COLS * (int)sizeof(float), seen)) !=
      cudaSuccess)
    return e;
  const int smem = N * (int)sizeof(float), sms = sm_count();
  int per_sm = MV_SMEM_SM / (smem + 1024);  // each block also holds 1 KB of the system's
  per_sm = per_sm < 1 ? 1 : (per_sm > MV_BLOCKS_PER_SM ? MV_BLOCKS_PER_SM : per_sm);
  const long long items = (long long)R * ((N + MV_SEG - 1) / MV_SEG);
  const long long want = (items + MV_WARPS - 1) / MV_WARPS;
  const long long grid = want < (long long)sms * per_sm ? want : (long long)sms * per_sm;
  dense_matvec<<<(unsigned)grid, MV_THREADS, smem, s>>>(A, R, N, u, y);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K7

constexpr int K7_LANES = 128;    // count lanes a warp keeps in registers (4 a thread)
constexpr int K7_EDGES = 256;    // a warp's nominal edge range in hop_edges
constexpr int K7_FUSE_MAX = 4;   // first-hop mirrors a fused pair resolves through

// The reference's gather index into a width-W input: a negative index
// wraps once, then the index clamps into [0, W - 1].
__device__ __forceinline__ long long gather_col(long long raw, long long W) {
  if (raw < 0) raw += W;
  return clampll(raw, 0, W - 1);
}

// A column of a width-W hop input that reads zero whatever was written:
// the last (the sentinel, or a wider width's padding) and, when it lies
// inside, column n_cap, which the reference zeroes before every hop.
__device__ __forceinline__ bool dead_col(long long u, long long W, int n_cap) {
  return u == W - 1 || ((long long)n_cap < W && u == n_cap);
}

__device__ __forceinline__ bool live_bit(const unsigned* bits, long long u) {
  return (__ldg(bits + (u >> 5)) >> (u & 31)) & 1u;
}

// The first hop of a fused (->edge, edge->node) pair: its mirrors' CSC
// (cptr [W1], csrc [E]) over one cap (W1 - 1), each giving every
// intermediate node at most one source (checked on the host), and the
// width W0 of the pair's input.
struct FirstHop {
  const int* c[K7_FUSE_MAX];
  const int* s[K7_FUSE_MAX];
  long long E[K7_FUSE_MAX];
  int n;
  long long W1, W0;
};

// The input rows a hop-input column u stands for: itself, live, unless
// dead or clear (unfused); or, fused, the first hop's source of the
// intermediate node u in mirror m, where it has one and that is live. -1:
// nothing. u is a gathered (never dead) column of the pair's intermediate.
template <bool FUSED>
__device__ __forceinline__ long long resolve(long long u, int m, const FirstHop& f,
                                             const unsigned* xbits, long long W, int n_cap) {
  if (!FUSED) return dead_col(u, W, n_cap) || !live_bit(xbits, u) ? -1 : u;
  const long long E = f.E[m];
  const long long a = clampll(f.c[m][u], 0, E), b = clampll(f.c[m][u + 1], 0, E);
  if (b - a != 1) return -1;  // no source (a single-source hop has 0 or 1)
  const long long s = gather_col(f.s[m][a], f.W0);
  return dead_col(s, f.W0, n_cap) || !live_bit(xbits, s) ? -1 : s;
}

// Adds (or, for a destination no earlier launch of this hop wrote,
// writes) a warp's sums for destination v into y and marks v live; the
// calling warp owns v in this launch. Lane l holds lanes l + 32 i.
__device__ __forceinline__ void flush_row(unsigned* y, unsigned* ybits, long long v, int B,
                                          const unsigned (&acc)[K7_LANES / 32]) {
  const int lane = threadIdx.x & 31;
  unsigned had = 0u;  // set before (an earlier mirror's launch, or this warp), and now set
  if (lane == 0) had = (atomicOr(&ybits[v >> 5], 1u << (v & 31)) >> (v & 31)) & 1u;
  had = __shfl_sync(0xffffffffu, had, 0);
#pragma unroll
  for (int i = 0; i < K7_LANES / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < B) y[v * B + c] = had ? y[v * B + c] + acc[i] : acc[i];
  }
}

// One mirror of a hop (or of a fused pair's second hop) whose pointers rise
// (cdst [E]: each edge's destination, cap where it has none; host-made):
// a warp a range of K7_EDGES edges, moved to whole destinations (it skips
// the edges of a destination begun before it and finishes the one it ends
// in), so it owns every destination it writes. Lanes take 32 edges at a
// time (coalesced cdst and csrc); each edge's live input rows (resolve)
// are read a row a load across the lanes, four rows in flight, and summed
// into the warp's current destination, flushed when it changes. A source
// whose bit is clear is not read; a destination with no live source is not
// written. B <= K7_LANES.
template <bool FUSED>
__global__ void __launch_bounds__(THREADS) hop_edges(const int* __restrict__ csrc,
                                                     const int* __restrict__ cdst, long long E,
                                                     int cap, FirstHop f,
                                                     const unsigned* __restrict__ x,
                                                     const unsigned* __restrict__ xbits,
                                                     long long W, int n_cap, int B, unsigned* y,
                                                     unsigned* ybits) {
  constexpr unsigned FULL_MASK = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long e0 = ((long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * K7_EDGES;
  if (e0 >= E) return;  // whole warps
  const long long e1 = e0 + K7_EDGES < E ? e0 + K7_EDGES : E;
  // the first edge of a destination that begins in the range
  long long start = e0;
  if (e0 > 0) {
    const int prev = cdst[e0 - 1];
    for (;; start += 32) {
      const long long e = start + lane;
      const unsigned m = __ballot_sync(FULL_MASK, e < e1 && cdst[e] != prev);
      if (m != 0u) {
        start += __ffs((int)m) - 1;
        break;
      }
      if (start + 32 >= e1) return;  // no destination begins here: the range is owned
    }
  }
  // one past the last edge of the destination the range ends in
  long long end = e1;
  const int last = cdst[e1 - 1];
  if (last < cap)
    for (;; end += 32) {
      const long long e = end + lane;
      const unsigned m = __ballot_sync(FULL_MASK, e >= E || cdst[e] != last);
      if (m != 0u) {
        end += __ffs((int)m) - 1;
        break;
      }
    }
  unsigned acc[K7_LANES / 32];
#pragma unroll
  for (int i = 0; i < K7_LANES / 32; ++i) acc[i] = 0u;
  long long cur = -1;
  const int nm = FUSED ? f.n : 1;
  for (long long base = start; base < end; base += 32) {
    const long long e = base + lane;
    const int v = e < end ? cdst[e] : cap;
    long long u = 0;
    if (v < cap) u = gather_col(csrc[e], FUSED ? f.W1 : W);
    const bool gathered = v < cap && !(FUSED && dead_col(u, f.W1, n_cap));
#pragma unroll
    for (int m = 0; m < K7_FUSE_MAX; ++m) {
      if (m >= nm) break;  // uniform; unrolled, so f's arrays take constant indices
      const long long src = gathered ? resolve<FUSED>(u, m, f, xbits, W, n_cap) : -1;
      unsigned todo = __ballot_sync(FULL_MASK, src >= 0);
      while (todo != 0u) {  // uniform: up to four live rows in flight
        int who[4];
        unsigned row[4][K7_LANES / 32];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          who[r] = todo != 0u ? __ffs((int)todo) - 1 : -1;
          todo &= todo - 1u;
          const long long sr = __shfl_sync(FULL_MASK, src, who[r] < 0 ? 0 : who[r]);
#pragma unroll
          for (int i = 0; i < K7_LANES / 32; ++i) {
            const int c = lane + 32 * i;
            row[r][i] = who[r] >= 0 && c < B ? x[sr * B + c] : 0u;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (who[r] < 0) break;  // uniform
          const long long vr = __shfl_sync(FULL_MASK, (long long)v, who[r]);
          if (vr != cur) {
            if (cur >= 0) flush_row(y, ybits, cur, B, acc);
            cur = vr;
#pragma unroll
            for (int i = 0; i < K7_LANES / 32; ++i) acc[i] = 0u;
          }
#pragma unroll
          for (int i = 0; i < K7_LANES / 32; ++i) acc[i] += row[r][i];
        }
      }
    }
  }
  if (cur >= 0) flush_row(y, ybits, cur, B, acc);
}

// One mirror of a hop whose pointers may fall (a reversed segment gives
// the negated sum, the reference's s[end] - s[start]), or with B above
// K7_LANES: a warp a destination, lanes over its edges to find the live
// input rows, then over the count lanes to sum them.
template <bool FUSED>
__global__ void __launch_bounds__(THREADS) hop_dests(const int* __restrict__ cptr,
                                                     const int* __restrict__ csrc, long long E,
                                                     int cap, FirstHop f,
                                                     const unsigned* __restrict__ x,
                                                     const unsigned* __restrict__ xbits,
                                                     long long W, int n_cap, int B, unsigned* y,
                                                     unsigned* ybits) {
  constexpr unsigned FULL_MASK = 0xffffffffu;
  const long long v = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= cap) return;  // whole warps
  const long long a = clampll(cptr[v], 0, E), b = clampll(cptr[v + 1], 0, E);
  const long long lo = a < b ? a : b, hi = a < b ? b : a;
  const int nm = FUSED ? f.n : 1;
  bool any = false;
  for (long long e0 = lo; e0 < hi && !any; e0 += 32) {
    const long long e = e0 + lane;
    long long u = 0;
    bool g = e < hi;
    if (g) {
      u = gather_col(csrc[e], FUSED ? f.W1 : W);
      g = !(FUSED && dead_col(u, f.W1, n_cap));
    }
    bool live = false;
#pragma unroll
    for (int m = 0; m < K7_FUSE_MAX; ++m)
      if (m < nm) live |= g && resolve<FUSED>(u, m, f, xbits, W, n_cap) >= 0;
    any = __ballot_sync(FULL_MASK, live) != 0u;
  }
  if (!any) return;  // uniform: nothing written, v stays clear
  unsigned had = 0u;  // written by an earlier mirror's launch; marked live from here
  if (lane == 0) had = (atomicOr(&ybits[v >> 5], 1u << (v & 31)) >> (v & 31)) & 1u;
  had = __shfl_sync(FULL_MASK, had, 0);
  for (int c0 = 0; c0 < B; c0 += 32) {
    const int c = c0 + lane;
    unsigned acc = 0u;
    for (long long e0 = lo; e0 < hi; e0 += 32) {
      const long long e = e0 + lane;
      long long u = 0;
      bool g = e < hi;
      if (g) {
        u = gather_col(csrc[e], FUSED ? f.W1 : W);
        g = !(FUSED && dead_col(u, f.W1, n_cap));
      }
#pragma unroll
      for (int m = 0; m < K7_FUSE_MAX; ++m) {
        if (m >= nm) break;  // uniform
        const long long src = g ? resolve<FUSED>(u, m, f, xbits, W, n_cap) : -1;
        for (unsigned todo = __ballot_sync(FULL_MASK, src >= 0); todo != 0u; todo &= todo - 1u) {
          const long long sj = __shfl_sync(FULL_MASK, src, __ffs((int)todo) - 1);
          if (c < B) acc += x[sj * B + c];
        }
      }
    }
    if (c < B) {
      const unsigned val = b < a ? 0u - acc : acc;
      y[v * B + c] = had ? y[v * B + c] + val : val;
    }
  }
}

// The seeds' rows of x: zeroed and marked live (first launch), then
// x[clip(fr, 0, n), b] += w for w > 0 (second); column n is dropped.
__global__ void __launch_bounds__(THREADS) seed_rows(const int* fr, const int* w, int B, int fsz,
                                                     int n, unsigned* x, unsigned* bits,
                                                     int add) {
  const long long total = (long long)B * fsz;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int wv = w[i];
    if (wv <= 0) continue;
    const long long c = clampll(fr[i], 0, n);
    if (c >= n) continue;
    if (add) {
      atomicAdd(&x[c * B + i / fsz], (unsigned)wv);
    } else {
      for (int b = 0; b < B; ++b) x[c * B + b] = 0u;
      atomicOr(&bits[c >> 5], 1u << (c & 31));
    }
  }
}

// out[b] += sum over the live rows v < V of x[v, b] * (ptr[v + 1] - ptr[v]),
// x lane-minor [*, B]. Warp w takes the live bitmap's words w, w + warps,
// ... (its lane j the j-th), so the marked words, which crowd where the
// live rows do, go to different warps; for a marked word the lanes read
// its rows' degrees at once, then each row's counts as one line, four rows
// in flight.
__global__ void __launch_bounds__(THREADS) live_dot(const unsigned* __restrict__ x,
                                                    const unsigned* __restrict__ bits,
                                                    long long V, int B, const int* ptr,
                                                    unsigned* out) {
  constexpr unsigned FULL_MASK = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long words = (V + 31) / 32;
  const long long nwarps = (long long)gridDim.x * (THREADS / 32);
  const long long w0 = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  for (int g0 = 0; g0 < B; g0 += K7_LANES) {
    unsigned acc[K7_LANES / 32];
#pragma unroll
    for (int i = 0; i < K7_LANES / 32; ++i) acc[i] = 0u;
    for (long long base = w0; base < words; base += nwarps * 32) {
      const long long wl = base + nwarps * lane;
      const unsigned mine = wl < words ? __ldg(bits + wl) : 0u;
      for (unsigned todo = __ballot_sync(FULL_MASK, mine != 0u); todo != 0u; todo &= todo - 1u) {
        const int j = __ffs((int)todo) - 1;
        const long long word = base + nwarps * j;
        const unsigned m = __shfl_sync(FULL_MASK, mine, j);
        const long long vl = word * 32 + lane;  // lane l: the word's row l and its degree
        const unsigned deg = (m >> lane) & 1u && vl < V ? (unsigned)(ptr[vl + 1] - ptr[vl]) : 0u;
        for (unsigned rows = m; rows != 0u;) {  // uniform: four rows in flight
          int who[4];
          unsigned xv[4][K7_LANES / 32];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            who[r] = rows != 0u ? __ffs((int)rows) - 1 : -1;
            rows &= rows - 1u;
            const long long v = word * 32 + (who[r] < 0 ? 0 : who[r]);
#pragma unroll
            for (int i = 0; i < K7_LANES / 32; ++i) {
              const int c = g0 + lane + 32 * i;
              xv[r][i] = who[r] >= 0 && v < V && c < B ? x[v * B + c] : 0u;
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const unsigned dr = __shfl_sync(FULL_MASK, deg, who[r] < 0 ? 0 : who[r]);
#pragma unroll
            for (int i = 0; i < K7_LANES / 32; ++i)
              if (who[r] >= 0) acc[i] += xv[r][i] * dr;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < K7_LANES / 32; ++i) {
      const int c = g0 + lane + 32 * i;
      if (c < B && acc[i] != 0u) atomicAdd(&out[c], acc[i]);
    }
  }
}

// out[b] += sum_j [fr < n and w > 0] * deg(clip(fr, 0, n - 1)) * w over one
// mirror (the degree reduction of a compact frontier; int32 wrap-around).
__global__ void __launch_bounds__(THREADS) frontier_degree(const int* fr, const int* w, int B,
                                                           int fsz, int chunks, const int* ptr,
                                                           int n, unsigned* out) {
  constexpr int CHUNK = THREADS * 8;
  const int b = blockIdx.x / chunks, ch = blockIdx.x % chunks;
  unsigned acc = 0u;
  for (int j = ch * CHUNK + threadIdx.x; j < fsz && j < (ch + 1) * CHUNK; j += THREADS) {
    const int f = fr[(long long)b * fsz + j], wv = w[(long long)b * fsz + j];
    if (f < n && wv > 0) {
      const long long c = clampll(f, 0, n > 0 ? n - 1 : 0);
      acc += (unsigned)(ptr[c + 1] - ptr[c]) * (unsigned)wv;
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0 && acc) atomicAdd(&out[b], acc);
}

cudaError_t launch_frontier_degree(const int* fr, const int* w, int B, int fsz, const int* ptr,
                                   int n, unsigned* out, cudaStream_t s) {
  const int chunks = (fsz + THREADS * 8 - 1) / (THREADS * 8);
  if (B <= 0 || chunks <= 0) return cudaSuccess;
  frontier_degree<<<(unsigned)(B * chunks), THREADS, 0, s>>>(fr, w, B, fsz, chunks, ptr, n, out);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K6

// cnt[clip(idx[s + o], 0, n_cap)] += w, and the node's bit set, for each
// frontier entry j and each o < md with o < deg, w > 0 and fr < n (s, deg
// of clip(fr, 0, n - 1)); the gathered position is clipped into the index
// array, as the reference's; the sentinel n_cap is dropped. The first
// fill_n outputs of the hop are set to (n_cap, 0) on the way.
__global__ void __launch_bounds__(THREADS) chain_gather(const int* ptr, int n, const int* idx,
                                                        long long E, const int* fr, const int* w,
                                                        int fsz, int md, int n_cap,
                                                        unsigned* cnt, unsigned* bits,
                                                        int* pres, int* cnts, int fill_n) {
  const long long slots = (long long)fsz * md;
  const long long total = slots > fill_n ? slots : fill_n;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * THREADS) {
    if (t < fill_n) {
      pres[t] = n_cap;
      cnts[t] = 0;
    }
    if (t >= slots) continue;
    const long long j = t / md;
    const int o = (int)(t % md);
    const int f = fr[j], wv = w[j];
    if (wv <= 0 || f >= n) continue;
    const long long c = clampll(f, 0, n > 0 ? n - 1 : 0);
    const int s = ptr[c];
    if (o >= ptr[c + 1] - s) continue;
    const int node = idx[clampll((long long)s + o, 0, E - 1)];
    const long long safe = clampll(node, 0, n_cap);
    if (safe < n_cap) {
      atomicAdd(&cnt[safe], (unsigned)wv);
      atomicOr(&bits[safe >> 5], 1u << (safe & 31));
    }
  }
}

constexpr int BC_THREADS = 256;  // bitmap words a tile, one a thread (8 warps)

// The touched nodes of a tile of the bitmap whose signed count is > 0, in
// ascending id order, at their ranks among all tiles' (truncated at
// out_size): pres = node, cnts = count. Every count and bitmap word read is
// left zero. Two steps:
// - a thread a word loads the 16-byte groups of its word's 32 counts that
//   hold a touched node, all at once (one round trip, however many of its
//   nodes are touched), and keeps the positive ones in shared memory; the
//   words' kept counts are scanned over the block, and the tile's offset
//   comes from the look-back;
// - a warp a word, a lane a node, writes the kept nodes at their ranks and
//   clears the touched counts: consecutive nodes, so the stores coalesce
//   however densely a tile is touched.
// bits holds tiles * BC_THREADS words, cnt 32 counts a word.
__global__ void __launch_bounds__(BC_THREADS) bit_compact(unsigned* bits, unsigned* cnt,
                                                          int tiles, int out_size, int* pres,
                                                          int* cnts, unsigned long long* state) {
  __shared__ unsigned s_word[BC_THREADS], s_keep[BC_THREADS], s_base[BC_THREADS];
  __shared__ int s_cnt[BC_THREADS * 33];  // word t's counts from 33 t: a warp's stores hit 32 banks
  const int tile = lb_tile(state);
  const long long w0 = (long long)tile * BC_THREADS;
  const unsigned word = bits[w0 + threadIdx.x];
  const uint4* cp = reinterpret_cast<const uint4*>(cnt + (w0 + threadIdx.x) * 32);
  uint4 g[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    g[q] = (word >> (4 * q)) & 0xfu ? cp[q] : make_uint4(0u, 0u, 0u, 0u);
  unsigned keep = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned c4[4] = {g[q].x, g[q].y, g[q].z, g[q].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the reference's signed `dense > 0`
      if ((int)c4[i] > 0 && ((word >> (4 * q + i)) & 1u)) {
        keep |= 1u << (4 * q + i);
        s_cnt[threadIdx.x * 33 + 4 * q + i] = (int)c4[i];
      }
    }
  }
  s_word[threadIdx.x] = word;
  s_keep[threadIdx.x] = keep;
  if (word != 0u) bits[w0 + threadIdx.x] = 0u;
  const unsigned mine = __popc(keep);
  unsigned count;
  s_base[threadIdx.x] = block_scan<BC_THREADS>(mine, &count) - mine;
  const long long before = (long long)lb_offset(state, tile, count);  // syncs the block
  const int lane = threadIdx.x & 31;
  for (int wi = threadIdx.x >> 5; wi < BC_THREADS; wi += BC_THREADS / 32) {
    const unsigned tw = s_word[wi];
    if (tw == 0u) continue;  // the whole warp
    const long long node = (w0 + wi) * 32 + lane;
    const unsigned kw = s_keep[wi];
    if ((kw >> lane) & 1u) {
      const long long r = before + s_base[wi] + __popc(kw & ((1u << lane) - 1u));
      if (r < out_size) {
        pres[r] = (int)node;
        cnts[r] = s_cnt[wi * 33 + lane];
      }
    }
    if ((tw >> lane) & 1u) cnt[node] = 0u;
  }
  lb_finish(state, tiles, nullptr);
}

long long bitmap_words(long long n_cap) {
  const long long words = (n_cap + 32) / 32;
  return (words + BC_THREADS - 1) / BC_THREADS * BC_THREADS;
}

}  // namespace

extern "C" {

// K8. mats[i] is [dims[i], dims[i+1]] bf16 with 16-byte aligned rows
// (dims[i+1] % 8 == 0, at most MV_MAX_COLS), outdeg [dims[n_mats]] f32,
// fr / w [B, fsz] int32 seeds as local ids of the first space; xa / xb
// scratch of max(dims) f32 each (xb unused with one operator, both with
// none); out [B] f32.
int graph_dense_count(const void* const* mats, const int* dims, int n_mats, const void* outdeg,
                      const void* fr, const void* w, int B, int fsz, void* xa, void* xb,
                      void* out, void* stream) {
  if (B <= 0 || fsz < 0 || n_mats < 0 || dims[0] <= 0) return (int)cudaErrorInvalidValue;
  for (int i = 1; i <= n_mats; ++i)
    if (dims[i] <= 0 || dims[i] % 8 != 0 || dims[i] > MV_MAX_COLS)
      return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* bufs[2] = {(float*)xa, (float*)xb};
  const float* u = (const float*)outdeg;
  cudaError_t e;
  for (int i = n_mats - 1; i >= 0; --i) {  // u_i = A_i u_{i+1}, the buffers in turn
    float* y = bufs[i & 1];
    if ((e = launch_matvec((const uint16_t*)mats[i], dims[i], dims[i + 1], u, y, s)) !=
        cudaSuccess)
      return (int)e;
    u = y;
  }
  seed_dot<<<(unsigned)B, THREADS, 0, s>>>((const int*)fr, (const int*)w, fsz, u, dims[0],
                                           (float*)out);
  return (int)cudaGetLastError();
}

// K7. Hop h has per_hop[h] mirrors, flattened in order: cptrs[m] [caps[m] + 1]
// and csrcs[m] [nedges[m]] int32, one cap within a hop; cdsts[m] [nedges[m]]
// int32, each edge's destination (caps[m] where none), where the mirror's
// clamped pointers rise, else null; singles[m] 1 where they rise by at most
// one a node. last_ptrs[m] [last_caps[m] + 1] are the final hop's CSR
// pointers. fr / w [B, fsz] int32; xa / xb scratch of rows * B int32 each
// (rows = max(n_cap, caps) + 1), bits scratch of (n_hops + 1) * words
// uint32 (words = (rows + 31) / 32); out [B] int32. The caller has checked
// the reference's shape rules (graph_csr.py).
int graph_csc_count(const void* const* cptrs, const void* const* csrcs, const void* const* cdsts,
                    const int* singles, const int* caps, const long long* nedges,
                    const int* per_hop, int n_hops, const void* const* last_ptrs,
                    const int* last_caps, int n_last, const void* fr, const void* w, int B,
                    int fsz, int n_cap, void* xa, void* xb, void* bits, long long words,
                    void* out, void* stream) {
  if (B <= 0 || fsz < 0 || n_cap < 0 || n_hops < 0 || n_last < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  if (n_hops == 0) {  // a 1-hop count: the weighted degree of the compact seeds
    for (int m = 0; m < n_last; ++m)
      if ((e = launch_frontier_degree((const int*)fr, (const int*)w, B, fsz,
                                      (const int*)last_ptrs[m], last_caps[m], (unsigned*)out,
                                      s)) != cudaSuccess)
        return (int)e;
    return (int)cudaSuccess;
  }
  if (words < ((long long)n_cap + 32) / 32) return (int)cudaErrorInvalidValue;
  unsigned* bm = (unsigned*)bits;
  if ((e = cudaMemsetAsync(bm, 0, (size_t)(n_hops + 1) * words * sizeof(unsigned), s)) !=
      cudaSuccess)
    return (int)e;
  unsigned* x = (unsigned*)xa;
  unsigned* y = (unsigned*)xb;
  for (int add = 0; add < 2; ++add) {  // the seeds' rows: zeroed and marked, then summed
    seed_rows<<<grid_for((long long)B * fsz), THREADS, 0, s>>>((const int*)fr, (const int*)w, B,
                                                                fsz, n_cap, x, bm, add);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  long long W = (long long)n_cap + 1;
  int level = 0;
  for (int h = 0, m0 = 0; h < n_hops; ++level) {
    const int n0 = per_hop[h];
    for (int i = 1; i < n0; ++i)
      if (caps[m0 + i] != caps[m0]) return (int)cudaErrorInvalidValue;
    bool fuse = h + 1 < n_hops && n0 >= 1 && n0 <= K7_FUSE_MAX;
    for (int i = 0; fuse && i < n0; ++i) fuse = singles[m0 + i] != 0;
    FirstHop f{};
    int m = m0, nm = n0;  // the mirrors whose launches write this level
    if (fuse) {  // (->edge, edge->node): the intermediate is never written
      for (int i = 0; i < n0; ++i) {
        f.c[i] = (const int*)cptrs[m0 + i];
        f.s[i] = (const int*)csrcs[m0 + i];
        f.E[i] = nedges[m0 + i];
      }
      f.n = n0;
      f.W1 = (long long)caps[m0] + 1;
      f.W0 = W;
      m = m0 + n0;
      nm = per_hop[h + 1];
      for (int i = 1; i < nm; ++i)
        if (caps[m + i] != caps[m]) return (int)cudaErrorInvalidValue;
    }
    const int cap = caps[m];
    const unsigned* xbits = bm + (size_t)level * words;
    unsigned* ybits = bm + (size_t)(level + 1) * words;
    for (int i = 0; i < nm; ++i, ++m) {
      const long long E = nedges[m];
      if (cdsts[m] != nullptr && B <= K7_LANES) {
        const long long warps = (E + K7_EDGES - 1) / K7_EDGES;
        const unsigned grid = (unsigned)((warps + THREADS / 32 - 1) / (THREADS / 32));
        if (grid == 0) continue;
        if (fuse)
          hop_edges<true><<<grid, THREADS, 0, s>>>((const int*)csrcs[m], (const int*)cdsts[m], E,
                                                   cap, f, x, xbits, W, n_cap, B, y, ybits);
        else
          hop_edges<false><<<grid, THREADS, 0, s>>>((const int*)csrcs[m], (const int*)cdsts[m],
                                                    E, cap, f, x, xbits, W, n_cap, B, y, ybits);
      } else {
        const unsigned grid = (unsigned)(((long long)cap + THREADS / 32 - 1) / (THREADS / 32));
        if (grid == 0) continue;
        if (fuse)
          hop_dests<true><<<grid, THREADS, 0, s>>>((const int*)cptrs[m], (const int*)csrcs[m], E,
                                                   cap, f, x, xbits, W, n_cap, B, y, ybits);
        else
          hop_dests<false><<<grid, THREADS, 0, s>>>((const int*)cptrs[m], (const int*)csrcs[m],
                                                    E, cap, f, x, xbits, W, n_cap, B, y, ybits);
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    m0 = m;
    h += fuse ? 2 : 1;
    W = (long long)cap + 1;
    unsigned* t = x;
    x = y;
    y = t;
  }
  const unsigned* live = bm + (size_t)level * words;
  const long long chunks = ((long long)n_cap + 32 * 32 - 1) / (32 * 32);  // 32 words a warp
  const unsigned grid = (unsigned)((chunks + THREADS / 32 - 1) / (THREADS / 32));  // one pass
  for (int l = 0; l < n_last && grid > 0; ++l) {
    live_dot<<<grid, THREADS, 0, s>>>(x, live, n_cap, B, (const int*)last_ptrs[l],
                                      (unsigned*)out);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// K6. Hop h has per_hop[h] mirrors, flattened in order: ptrs[m] [caps[m] + 1],
// idxs[m] [nidx[m]] int32, md[m] their pow2 max degree. fr / w [fsz] int32.
// Non-final hops (all hops without count_only) write presents[h] / counts[h]
// [out_sizes[h]] int32; a count-only chain writes total [1]. Scratch, zero
// and left zero: bits [graph_chain_bitmap_words(n_cap)] uint32, cnt 32 uint32
// a bitmap word, state [graph_chain_state_entries(n_cap)] uint64; `clear` zeroes
// them first (the caller's scratch after a failed call). A mirror with no
// max degree or no index array fails the call where it is reached.
int graph_chain(const void* const* ptrs, const int* caps, const void* const* idxs,
                const long long* nidx, const int* mds, const int* per_hop, int n_hops,
                const int* out_sizes, const void* fr, const void* w, int fsz, int n_cap,
                int count_only, void* cnt, void* bits, void* state, int clear,
                void* const* presents, void* const* counts, void* total, void* stream) {
  if (fsz < 0 || n_cap < 0 || n_hops <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long words = bitmap_words(n_cap);
  const int tiles = (int)(words / BC_THREADS);
  cudaError_t e;
  if (clear &&
      ((e = cudaMemsetAsync(cnt, 0, (size_t)words * 32 * sizeof(unsigned), s)) != cudaSuccess ||
       (e = cudaMemsetAsync(bits, 0, (size_t)words * sizeof(unsigned), s)) != cudaSuccess ||
       (e = cudaMemsetAsync(state, 0, (size_t)(2 + tiles) * sizeof(unsigned long long), s)) !=
           cudaSuccess))
    return (int)e;
  const int* cur_fr = (const int*)fr;
  const int* cur_w = (const int*)w;
  int width = fsz;
  int m = 0;
  for (int h = 0; h < n_hops; ++h) {
    if (count_only && h == n_hops - 1) {
      if ((e = cudaMemsetAsync(total, 0, sizeof(unsigned), s)) != cudaSuccess) return (int)e;
      for (int i = 0; i < per_hop[h]; ++i, ++m)
        if ((e = launch_frontier_degree(cur_fr, cur_w, 1, width, (const int*)ptrs[m], caps[m],
                                        (unsigned*)total, s)) != cudaSuccess)
          return (int)e;
      return (int)cudaSuccess;
    }
    const int out_size = out_sizes[h];
    int* pres = (int*)presents[h];
    int* cnts = (int*)counts[h];
    for (int i = 0; i < per_hop[h]; ++i, ++m) {
      if (mds[m] <= 0 || nidx[m] <= 0) return (int)cudaErrorInvalidValue;
      const int fill_n = i == 0 ? out_size : 0;
      const long long work = (long long)width * mds[m];
      chain_gather<<<grid_for(work > fill_n ? work : fill_n), THREADS, 0, s>>>(
          (const int*)ptrs[m], caps[m], (const int*)idxs[m], nidx[m], cur_fr, cur_w, width,
          mds[m], n_cap, (unsigned*)cnt, (unsigned*)bits, pres, cnts, fill_n);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    bit_compact<<<(unsigned)tiles, BC_THREADS, 0, s>>>((unsigned*)bits, (unsigned*)cnt, tiles,
                                                      out_size, pres, cnts,
                                                      (unsigned long long*)state);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cur_fr = pres;
    cur_w = cnts;
    width = out_size;
  }
  return (int)cudaSuccess;
}

long long graph_chain_bitmap_words(long long n_cap) { return bitmap_words(n_cap); }

long long graph_chain_state_entries(long long n_cap) {
  return 2 + bitmap_words(n_cap) / BC_THREADS;
}

}  // extern "C"
