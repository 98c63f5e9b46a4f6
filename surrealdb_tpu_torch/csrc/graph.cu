// Graph-traversal kernels for Hopper (sm_90a), behind the same plain C
// interface as knn.cu and ivf.cu (one library, loaded with ctypes by
// surrealdb_tpu_torch/ops/_cuda.py). All three count paths of
// surrealdb_tpu/idx/graph_csr.py GraphMirrors._chain_frontier; every count is
// an exact integer, so no kernel here rounds.
//
// K8 graph_dense_count replaces surrealdb_tpu/idx/graph_csr.py
// dense_count_batch: B seed frontiers densified into x [B, n0] f32, then
// x = x @ A for each composed node-to-node operator A (bf16, read exactly
// into f32), then (x * outdeg).sum(1). What bounds it: the function's floor
// is A's n0*n1*2 bytes a product (61 us of HBM at n0 = n1 = 10,112), since
// regrouped as x @ (A @ (A @ outdeg)) it needs only n0*n1 FMAs a product.
// This design keeps the reference's x @ A form, 2*B*n0*n1 FMAs a product on
// the CUDA cores in f32 (no TF32: x reaches 2^24), 6.5 GFLOP at B = 32, ~0.1
// ms at 67 TFLOP/s, so its own limit is those operations. Design: x is kept
// lane-minor ([n, B], one row a node), a block owns 128 output columns and
// a slice of the reduction (split K, so 79 column tiles still fill 132 SMs);
// each step stages 32 rows of A (bf16) and of x in shared memory, with the
// next step's tiles already loading into registers, and each thread keeps a
// 4 (or 8) lane x 4 column tile of sums in registers. The splits meet in
// float atomicAdd: every value and partial sum is an integer below 2^24
// (the caller's guard, graph_csr.py _dense_chain_count), where f32 sums are
// exact in any order, so the result does not depend on the order.
//
// K7 graph_csc_count replaces dense_count_batch's sibling chain_count_batch:
// B count chains over destination-sorted (cptr, csrc) adjacency. The
// reference's cumsum-and-difference form exists because scatter is slow on
// a TPU; this computes what it computes, y[v, b] = sum over the edges e of v
// of x[csrc[e], b] (summed over the hop's mirrors), pull-based: a warp owns a
// destination and reads each source's row of B lanes as one contiguous 128
// bytes (B = 32). Then sum_v x[v, b] * deg(v) over the last hop. int32 sums
// wrap exactly as the reference's cumsum difference does (unsigned
// arithmetic here), so any order gives the same bits. What bounds it: the
// [n_cap + 1, B] int32 x (134 MB at n_cap = 2^20, B = 32) read and written
// once a hop (bytes). The reference's shapes are kept: x starts n_cap + 1
// wide, each hop's output is its mirrors' cap (+ a zero sentinel) wide,
// gathers past the width read the last column, and column n_cap is zeroed
// before each hop.
//
// K6 graph_chain replaces chain_kernel (chain_impl, gather_hop, accum_cap):
// one frontier's multi-hop chain. Each hop is a weighted CSR gather with the
// reference's clips and validity (offs < deg, weight > 0, frontier < n), an
// int32 scatter-add into a dense [n_cap + 1] (integer atomicAdd: any order
// gives the same sums), the sentinel zeroed, and an ordered stream
// compaction (compact.cuh) of the nodes with a count > 0 in ascending id order, truncated
// at the hop's out_size and filled with (n_cap, 0), as nonzero(size=...,
// fill_value=n_cap). The order is part of the result (chain() emits records
// in it). A count-only chain ends with the weighted degree reduction. What
// bounds it: the compaction's scan of the dense array (4 MB at 2^20) and the
// gathered adjacency (bytes); at these sizes mostly the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "compact.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// x[clip(fr, 0, n), b] += w for w > 0, x lane-minor ([n + 1, B]); the
// sentinel column n is dropped (every caller zeroes or slices it away).
template <class T>
__global__ void __launch_bounds__(THREADS) densify(const int* fr, const int* w, int B, int fsz,
                                                   int n, T* x) {
  const long long total = (long long)B * fsz;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int wv = w[i];
    if (wv <= 0) continue;
    const long long c = clampll(fr[i], 0, n);
    if (c < n) atomicAdd(&x[c * B + i / fsz], (T)wv);
  }
}

// out[b] += sum_v x[v, b] * weight(v) over v < V, x lane-minor [V, B];
// weight(v) is outdeg[v] (K8) or ptr[v + 1] - ptr[v] (K7). A thread keeps
// its lane's sum in a register when the lane window divides the block,
// else adds each term into shared memory.
template <class T, bool FROM_PTR>
__global__ void __launch_bounds__(THREADS) lane_dot(const T* x, long long V, int B,
                                                    const float* outdeg, const int* ptr, T* out) {
  __shared__ T sacc[THREADS];
  for (int l0 = 0; l0 < B; l0 += THREADS) {
    const int W = B - l0 < THREADS ? B - l0 : THREADS;
    const bool fixed = THREADS % W == 0;
    sacc[threadIdx.x] = (T)0;
    __syncthreads();
    T mine = (T)0;
    const long long total = V * W;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
         i += (long long)gridDim.x * THREADS) {
      const long long v = i / W;
      const int lane = (int)(i % W);
      T wt;
      if constexpr (FROM_PTR)
        wt = (T)(unsigned)(ptr[v + 1] - ptr[v]);
      else
        wt = (T)outdeg[v];
      const T term = x[v * B + l0 + lane] * wt;
      if (fixed)
        mine += term;
      else
        atomicAdd(&sacc[lane], term);
    }
    if (fixed) atomicAdd(&sacc[threadIdx.x % W], mine);
    __syncthreads();
    if (threadIdx.x < (unsigned)W) atomicAdd(&out[l0 + threadIdx.x], sacc[threadIdx.x]);
    __syncthreads();
  }
}

// ------------------------------------------------------------------ K8

constexpr int DN_COLS = 128;  // output columns a block
constexpr int DN_KT = 32;     // reduction rows staged a step

// y[col, b] += sum_{k in this block's slice} x[k, b] * A[k, col]; x [K, B]
// f32, A [K, N] bf16 row-major with N % 128 == 0, y [N, B] f32 (zeroed).
// Thread t: columns tile*128 + (t % 32)*4 .. +3, lanes row0 + (t / 32)*RB ..
template <int RB>
__global__ void __launch_bounds__(THREADS) dense_product(const float* x, int B, int K,
                                                         const uint16_t* A, int N, int col_tiles,
                                                         int row_chunks, int k_per_split, float* y) {
  constexpr int LANES = 8 * RB;                        // lanes a block
  constexpr int A_VECS = DN_KT * DN_COLS / 8;          // 16-byte vectors of an A tile
  constexpr int A_PER = A_VECS / THREADS;              // 2 a thread
  constexpr int X_PER = DN_KT * LANES / THREADS;       // RB a thread
  __shared__ __align__(16) uint16_t As[DN_KT][DN_COLS];
  __shared__ __align__(16) float xs[DN_KT][LANES];
  int bid = blockIdx.x;
  const int tile = bid % col_tiles;
  bid /= col_tiles;
  const int chunk = bid % row_chunks;
  const int split = bid / row_chunks;
  const int row0 = chunk * LANES;
  const int k0 = split * k_per_split;
  const int k1 = k0 + k_per_split < K ? k0 + k_per_split : K;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  float acc[RB][4];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  uint4 ra[A_PER];
  float rx[X_PER];
  auto load = [&](int kb) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int i = threadIdx.x + p * THREADS;
      const int r = i / (DN_COLS / 8), c8 = i % (DN_COLS / 8);
      const int k = kb + r;
      ra[p] = {0u, 0u, 0u, 0u};
      if (k < k1)
        ra[p] = *reinterpret_cast<const uint4*>(A + (size_t)k * N + (size_t)tile * DN_COLS + c8 * 8);
    }
#pragma unroll
    for (int p = 0; p < X_PER; ++p) {
      const int i = threadIdx.x + p * THREADS;
      const int r = i / LANES, lane = i % LANES;
      const int k = kb + r, b = row0 + lane;
      rx[p] = (k < k1 && b < B) ? x[(size_t)k * B + b] : 0.f;
    }
  };
  if (k0 < k1) load(k0);
  for (int kb = k0; kb < k1; kb += DN_KT) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int i = threadIdx.x + p * THREADS;
      *reinterpret_cast<uint4*>(&As[i / (DN_COLS / 8)][(i % (DN_COLS / 8)) * 8]) = ra[p];
    }
#pragma unroll
    for (int p = 0; p < X_PER; ++p) {
      const int i = threadIdx.x + p * THREADS;
      xs[i / LANES][i % LANES] = rx[p];
    }
    __syncthreads();
    if (kb + DN_KT < k1) load(kb + DN_KT);  // in flight while this step computes
#pragma unroll 4
    for (int r = 0; r < DN_KT; ++r) {
      const uint2 a2 = *reinterpret_cast<const uint2*>(&As[r][cg * 4]);
      // bf16 -> f32 is exact: the bf16 bits are the f32's high half
      const float a[4] = {__uint_as_float(a2.x << 16), __uint_as_float(a2.x & 0xffff0000u),
                          __uint_as_float(a2.y << 16), __uint_as_float(a2.y & 0xffff0000u)};
      float xv[RB];
#pragma unroll
      for (int q = 0; q < RB; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&xs[r][rg * RB + q]);
        xv[q] = v.x;
        xv[q + 1] = v.y;
        xv[q + 2] = v.z;
        xv[q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], a[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int b = row0 + rg * RB + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t col = (size_t)tile * DN_COLS + cg * 4 + j;
      if (acc[i][j] != 0.f) atomicAdd(&y[col * B + b], acc[i][j]);
    }
  }
}

cudaError_t launch_product(const float* x, int B, int K, const uint16_t* A, int N, float* y,
                           cudaStream_t s) {
  const int rb = B <= 32 ? 4 : 8;
  const int lanes = 8 * rb;
  const int col_tiles = N / DN_COLS;
  const int row_chunks = (B + lanes - 1) / lanes;
  const int ktiles = (K + DN_KT - 1) / DN_KT;
  // about four resident blocks an SM on 132 SMs
  const int want = (4 * 132 + col_tiles * row_chunks - 1) / (col_tiles * row_chunks);
  const int splits = want < ktiles ? (want > 0 ? want : 1) : (ktiles > 0 ? ktiles : 1);
  const int k_per_split = ((ktiles + splits - 1) / splits) * DN_KT;
  const int nsplit = (K + k_per_split - 1) / k_per_split;
  const unsigned grid = (unsigned)(col_tiles * row_chunks * (nsplit > 0 ? nsplit : 1));
  if (rb == 4)
    dense_product<4><<<grid, THREADS, 0, s>>>(x, B, K, A, N, col_tiles, row_chunks, k_per_split, y);
  else
    dense_product<8><<<grid, THREADS, 0, s>>>(x, B, K, A, N, col_tiles, row_chunks, k_per_split, y);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K7

// y[v, :] (= or +=) sum over edges e in [cptr[v], cptr[v+1]) of
// x[src(e), :], src(e) = csrc[e] clamped to the input width W (a negative
// index counts from the end, as the reference's gather does); a reversed
// segment gives the negated sum (the reference's s[end] - s[start]). A warp
// a destination; 32 sources loaded at once and broadcast by shuffles.
__global__ void __launch_bounds__(THREADS) csc_hop(const int* cptr, const int* csrc, long long E,
                                                   int cap, const unsigned* x, long long W, int B,
                                                   unsigned* y, int accumulate) {
  const long long v = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= cap) return;  // whole warps
  const long long a = clampll(cptr[v], 0, E), b = clampll(cptr[v + 1], 0, E);
  const long long lo = a < b ? a : b, hi = a < b ? b : a;
  for (int c0 = 0; c0 < B; c0 += 32) {
    const int c = c0 + lane;
    unsigned acc = 0u;
    for (long long e0 = lo; e0 < hi; e0 += 32) {
      long long src = 0;
      if (e0 + lane < hi) {
        src = csrc[e0 + lane];
        if (src < 0) src += W;
        src = clampll(src, 0, W - 1);
      }
      const int cnt = hi - e0 < 32 ? (int)(hi - e0) : 32;
      for (int j = 0; j < cnt; ++j) {
        const long long sj = __shfl_sync(0xffffffffu, src, j);
        if (c < B) acc += x[sj * B + c];
      }
    }
    if (c < B) {
      const unsigned val = b < a ? 0u - acc : acc;
      y[v * B + c] = accumulate ? y[v * B + c] + val : val;
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

// dense[clip(idx[s + o], 0, n_cap)] += w for each frontier entry j and each
// o < md with o < deg, w > 0 and fr < n (s, deg of clip(fr, 0, n - 1));
// the gathered position is clipped into the index array, as the reference's.
__global__ void __launch_bounds__(THREADS) chain_gather(const int* ptr, int n, const int* idx,
                                                        long long E, const int* fr, const int* w,
                                                        int fsz, int md, int n_cap,
                                                        unsigned* dense) {
  const long long total = (long long)fsz * md;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * THREADS) {
    const long long j = t / md;
    const int o = (int)(t % md);
    const int f = fr[j], wv = w[j];
    if (wv <= 0 || f >= n) continue;
    const long long c = clampll(f, 0, n > 0 ? n - 1 : 0);
    const int s = ptr[c];
    if (o >= ptr[c + 1] - s) continue;
    const int node = idx[clampll((long long)s + o, 0, E - 1)];
    const long long safe = clampll(node, 0, n_cap);
    if (safe < n_cap) atomicAdd(&dense[safe], (unsigned)wv);  // the sentinel is zeroed anyway
  }
}

}  // namespace

extern "C" {

// K8. mats[i] is [dims[i], dims[i+1]] bf16 (dims[i+1] % 128 == 0), outdeg
// [dims[n_mats]] f32, fr / w [B, fsz] int32 seeds as local ids of the first
// space; xa / xb scratch of max(dims) * B f32 each; out [B] f32.
int graph_dense_count(const void* const* mats, const int* dims, int n_mats, const void* outdeg,
                      const void* fr, const void* w, int B, int fsz, void* xa, void* xb,
                      void* out, void* stream) {
  if (B <= 0 || fsz < 0 || n_mats < 0 || dims[0] <= 0) return (int)cudaErrorInvalidValue;
  for (int i = 1; i <= n_mats; ++i)
    if (dims[i] <= 0 || dims[i] % DN_COLS != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* x = (float*)xa;
  float* y = (float*)xb;
  cudaError_t e = cudaMemsetAsync(x, 0, (size_t)dims[0] * B * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  densify<float><<<grid_for((long long)B * fsz), THREADS, 0, s>>>((const int*)fr, (const int*)w,
                                                                   B, fsz, dims[0], x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int i = 0; i < n_mats; ++i) {
    if ((e = cudaMemsetAsync(y, 0, (size_t)dims[i + 1] * B * sizeof(float), s)) != cudaSuccess)
      return (int)e;
    if ((e = launch_product(x, B, dims[i], (const uint16_t*)mats[i], dims[i + 1], y, s)) !=
        cudaSuccess)
      return (int)e;
    float* t = x;
    x = y;
    y = t;
  }
  if ((e = cudaMemsetAsync(out, 0, (size_t)B * sizeof(float), s)) != cudaSuccess) return (int)e;
  const long long V = dims[n_mats];
  lane_dot<float, false><<<grid_for(V * B / 8), THREADS, 0, s>>>(x, V, B, (const float*)outdeg,
                                                                  nullptr, (float*)out);
  return (int)cudaGetLastError();
}

// K7. Hop h has per_hop[h] mirrors, flattened in order: cptrs[m] [caps[m] + 1]
// and csrcs[m] [nedges[m]] int32, one cap within a hop. last_ptrs[m]
// [last_caps[m] + 1] are the final hop's CSR pointers. fr / w [B, fsz] int32;
// xa / xb scratch of (max(n_cap, caps) + 1) * B int32 each; out [B] int32.
// The caller has checked the reference's shape rules (graph_csr.py).
int graph_csc_count(const void* const* cptrs, const void* const* csrcs, const int* caps,
                    const long long* nedges, const int* per_hop, int n_hops,
                    const void* const* last_ptrs, const int* last_caps, int n_last,
                    const void* fr, const void* w, int B, int fsz, int n_cap, void* xa, void* xb,
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
  unsigned* x = (unsigned*)xa;
  unsigned* y = (unsigned*)xb;
  long long W = (long long)n_cap + 1;
  if ((e = cudaMemsetAsync(x, 0, (size_t)W * B * sizeof(unsigned), s)) != cudaSuccess) return (int)e;
  densify<unsigned><<<grid_for((long long)B * fsz), THREADS, 0, s>>>(
      (const int*)fr, (const int*)w, B, fsz, n_cap, x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int m = 0;
  for (int h = 0; h < n_hops; ++h) {
    if (n_cap < W &&
        (e = cudaMemsetAsync(x + (size_t)n_cap * B, 0, (size_t)B * sizeof(unsigned), s)) !=
            cudaSuccess)
      return (int)e;
    const int cap = caps[m];
    for (int i = 0; i < per_hop[h]; ++i, ++m) {
      if (caps[m] != cap) return (int)cudaErrorInvalidValue;
      const unsigned grid = (unsigned)(((long long)cap + THREADS / 32 - 1) / (THREADS / 32));
      if (grid == 0) continue;
      csc_hop<<<grid, THREADS, 0, s>>>((const int*)cptrs[m], (const int*)csrcs[m], nedges[m], cap,
                                       x, W, B, y, i > 0);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if ((e = cudaMemsetAsync(y + (size_t)cap * B, 0, (size_t)B * sizeof(unsigned), s)) !=
        cudaSuccess)
      return (int)e;
    W = (long long)cap + 1;
    unsigned* t = x;
    x = y;
    y = t;
  }
  for (int l = 0; l < n_last; ++l) {
    lane_dot<unsigned, true><<<grid_for((long long)n_cap * B / 8), THREADS, 0, s>>>(
        x, n_cap, B, nullptr, (const int*)last_ptrs[l], (unsigned*)out);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// K6. Hop h has per_hop[h] mirrors, flattened in order: ptrs[m] [caps[m] + 1],
// idxs[m] [nidx[m]] int32, md[m] their pow2 max degree. fr / w [fsz] int32.
// Non-final hops (all hops without count_only) write presents[h] / counts[h]
// [out_sizes[h]] int32; dense is [n_cap + 1] int32 scratch and blk
// graph_compact_blocks(n_cap) int32; a count-only chain writes total [1].
int graph_chain(const void* const* ptrs, const int* caps, const void* const* idxs,
                const long long* nidx, const int* mds, const int* per_hop, int n_hops,
                const int* out_sizes, const void* fr, const void* w, int fsz, int n_cap,
                int count_only, void* dense, void* blk, void* const* presents,
                void* const* counts, void* total, void* stream) {
  if (fsz < 0 || n_cap < 0 || n_hops <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* cur_fr = (const int*)fr;
  const int* cur_w = (const int*)w;
  int width = fsz;
  cudaError_t e;
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
    if ((e = cudaMemsetAsync(dense, 0, ((size_t)n_cap + 1) * sizeof(unsigned), s)) != cudaSuccess)
      return (int)e;
    for (int i = 0; i < per_hop[h]; ++i, ++m) {
      if (mds[m] <= 0 || nidx[m] <= 0) return (int)cudaErrorInvalidValue;
      chain_gather<<<grid_for((long long)width * mds[m]), THREADS, 0, s>>>(
          (const int*)ptrs[m], caps[m], (const int*)idxs[m], nidx[m], cur_fr, cur_w, width, mds[m],
          n_cap, (unsigned*)dense);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    const int out_size = out_sizes[h];
    int* pres = (int*)presents[h];
    int* cnts = (int*)counts[h];
    compact_fill<int><<<grid_for(out_size), CP_THREADS, 0, s>>>(pres, cnts, out_size, n_cap);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if ((e = compact_run<int>((const unsigned*)dense, n_cap, (int*)blk, out_size, pres, cnts, s)) !=
        cudaSuccess)
      return (int)e;
    cur_fr = pres;
    cur_w = cnts;
    width = out_size;
  }
  return (int)cudaSuccess;
}

long long graph_compact_blocks(long long n) { return compact_blocks(n); }

}  // extern "C"
