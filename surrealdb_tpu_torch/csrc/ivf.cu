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
// bounds it: 2*n*C*D flops against n*D row bytes (C = 1024: ~1000 flops a
// row byte, above the card's ridge), so operations. Design: a block owns 64
// rows and walks the centroids in tiles of 64; each step stages 32 columns
// of the rows and of the centroid tile in shared memory (transposed, f32),
// and each of the 256 threads keeps a 4x4 tile of dot products in
// registers (two 16-byte shared loads per 16 FMAs, on the CUDA cores in
// f32). Each thread keeps a running best-2 per row over the centroids it
// saw, and 16 lanes merge theirs with shuffles at the end, so no [n, C]
// distance matrix reaches device memory.
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

#include "metric.cuh"

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
template <typename T>
__global__ void __launch_bounds__(AS_THREADS)
assign_kernel(const T* __restrict__ x, const int* __restrict__ idx, long long cap,
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
        const float v = to_f(x[sr * D + c]);
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
        xs[c][r] = (sr >= 0 && col < D) ? to_f(x[sr * D + col]) : 0.f;
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
  const cudaError_t e = cudaFuncSetAttribute(
      gather_distance_kernel<M, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
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
int ivf_assign(const void* x, int x_bf16, const void* idx, long long n, long long cap,
               const void* cents, int C, int D, int k, void* out, void* stream) {
  if (n <= 0 || cap <= 0 || C <= 0 || D <= 0 || k < 1 || k > 2 || k > C)
    return (int)cudaErrorInvalidValue;
  if (idx == nullptr && n > cap) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + AS_TR - 1) / AS_TR);
  if (x_bf16)
    assign_kernel<__nv_bfloat16><<<blocks, AS_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const int*)idx, cap, n, (const float*)cents, C, D, k, (int*)out);
  else
    assign_kernel<float><<<blocks, AS_THREADS, 0, s>>>(
        (const float*)x, (const int*)idx, cap, n, (const float*)cents, C, D, k, (int*)out);
  return (int)cudaGetLastError();
}

// x [n, D] f32 / bf16; assign [n] i32; c_old [C, D] f32 -> c_new [C, D] f32
// (the mean of each centroid's rows, c_old where it has none) and
// counts [C] i32.
int ivf_kmeans_update(const void* x, int x_bf16, long long n, int D, const void* assign,
                      const void* c_old, int C, void* c_new, void* counts, void* stream) {
  if (n <= 0 || D <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = update_smem_bytes(D);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((C + UP_GROUP - 1) / UP_GROUP);
  cudaError_t e;
  if (x_bf16) {
    e = cudaFuncSetAttribute(kmeans_update_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kmeans_update_kernel<__nv_bfloat16><<<blocks, UP_THREADS, smem, s>>>(
        (const __nv_bfloat16*)x, n, D, (const int*)assign, (const float*)c_old, C,
        (float*)c_new, (int*)counts);
  } else {
    e = cudaFuncSetAttribute(kmeans_update_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
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
