// The exact kNN's shared device code (knn.cu; knn_f32.cu, which builds the
// f32-row streaming kernels as a source of its own, so nvcc compiles them
// beside knn.cu; mesh.cu, whose K12 instances take the accumulator
// epilogue and whose K13 rerank keeps the same warp lists): the
// order-preserving keys, the warps' running top-k (warp_offer), and the
// streaming tier (DistBody over rowstream.cuh, stream_kernel, its
// launcher). The design is in knn.cu's header. Include after
// <cuda_runtime.h>, <cuda_bf16.h>, launch.cuh, metric.cuh, mma.cuh and
// rowstream.cuh.
#pragma once

#include <atomic>

// Where a launch's pieces go. Streaming: nblk row ranges x nqt query tiles
// of qt queries, kept [blocks][WARPS][qt][k]; tensor tier: query tiles of
// TQ_BN, kept [blocks][TQ_BN][k], then the limb planes and |q|^2. picks_*
// [Q, nblk, k] for K2 only; every offset is 256-byte aligned.
struct KnnPlan {
  bool tq;
  int qt, nqt, Qp, Dp;
  long long nblk, per;
  long long picks_d, picks_i, kept, limbs, qss, bytes;
};

// Where a launch's rows and queries lie, and K12's accumulator: rows ld
// elements apart and queries qld apart (D and D for K1 and K2; a feature
// shard's views of wider rows for K12); acc_in and fin are read by the
// ACC instances only (DistBody).
struct KnnView {
  long long ld;
  int qld;
  const float* acc_in;
  int fin;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = RS_THREADS / 32;
constexpr int KNN_FUSED_MAX_K = 256;
constexpr unsigned INF_KEY = 0xFF800000u;  // key of +inf
constexpr unsigned PAD_KEY = 0xFFFFFFFFu;  // above every float key
constexpr unsigned long long PAD_PAIR = ~0ull;
constexpr int SMEM_MAX = 232448 - 8192;  // a block's dynamic shared memory, less the statics

__device__ __forceinline__ unsigned f2key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0, as a float compare
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned long long pair_of(unsigned key, long long row) {
  return ((unsigned long long)key << 32) | (unsigned)row;
}

__device__ __forceinline__ float wsum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// ------------------------------------------------------------------ running top-k
// warp_offer below, once some lane's candidate is below theta; out of line
// (rare once the list is good), so the streaming loops keep their registers.
// A candidate's place is the number of kept entries and of candidates below
// it; a kept entry moves up by the candidates below it. Up to 4 candidates
// (a good list's usual insert) count those by ballots, a dozen instructions
// a candidate; more (a list filling up, up to 32 a batch) are sorted across
// the warp by a bitonic network and placed by binary searches, some 150
// instructions whatever their number.
__device__ __noinline__ unsigned long long warp_insert(unsigned long long* kept, int k,
                                                       unsigned long long theta,
                                                       unsigned long long cand) {
  constexpr int KS = KNN_FUSED_MAX_K / 32;
  const int lane = threadIdx.x & 31;
  const bool take = cand < theta;
  const unsigned ball = __ballot_sync(FULL, take);
  const int c = __popc(ball);
  const int ks = (k + 31) >> 5;
  unsigned long long kv[KS];
  int shift[KS];
#pragma unroll
  for (int m = 0; m < KS; ++m) {
    const int i = lane + 32 * m;
    kv[m] = (m < ks && i < k) ? kept[i] : PAD_PAIR;
    shift[m] = 0;
  }
  int pos = 0;
  unsigned long long v = take ? cand : PAD_PAIR;  // the lane's candidate to place
  if (c <= 4) {
    for (unsigned bm = ball; bm != 0u; bm &= bm - 1u) {
      const int o = __ffs((int)bm) - 1;
      const unsigned long long co = __shfl_sync(FULL, cand, o);
      int below = __popc(__ballot_sync(FULL, take && cand < co));  // candidates below co
#pragma unroll
      for (int m = 0; m < KS; ++m) {
        if (m < ks) {
          below += __popc(__ballot_sync(FULL, kv[m] < co));  // kept entries below co
          shift[m] += co < kv[m];
        }
      }
      if (lane == o) pos = below;
    }
  } else {
    // ascending across the lanes; the PAD_PAIR fill sorts last
    for (int size = 2; size <= 32; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned long long o = __shfl_xor_sync(FULL, v, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        v = keep_min ? (o < v ? o : v) : (o < v ? v : o);
      }
    int lo = 0;  // kept entries below v (a binary search of the list)
    for (int len = k; len > 0;) {
      const int half = len >> 1;
      if (kept[lo + half] < v) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    pos = lane + lo;
    // candidates below kv[m]: a binary search of lanes 0 .. c - 1 by shuffles
#pragma unroll
    for (int m = 0; m < KS; ++m) {
      if (m < ks) {
        int below = 0;
#pragma unroll
        for (int step = 32; step > 0; step >>= 1) {  // reaches all 32
          const unsigned long long co = __shfl_sync(FULL, v, (below + step - 1) & 31);
          if (below + step <= c && co < kv[m]) below += step;
        }
        shift[m] = below;
      }
    }
  }
  __syncwarp();  // every lane has read the list
#pragma unroll
  for (int m = 0; m < KS; ++m) {
    const int i = lane + 32 * m;
    if (m < ks && i < k && i + shift[m] < k) kept[i + shift[m]] = kv[m];
  }
  if ((c <= 4 ? take : lane < c) && pos < k) kept[pos] = v;  // sorted: lanes 0 .. c - 1
  __syncwarp();
  return kept[k - 1];
}

// The warp offers one candidate pair a lane (PAD_PAIR: none) to the sorted
// list kept[0, k) (k <= KNN_FUSED_MAX_K) whose last entry is theta; returns
// the new last entry. Pairs are distinct, except the PAD_PAIR fill.
__device__ __forceinline__ unsigned long long warp_offer(unsigned long long* kept, int k,
                                                         unsigned long long theta,
                                                         unsigned long long cand) {
  if (__ballot_sync(FULL, cand < theta) == 0u) return theta;  // uniform
  return warp_insert(kept, k, theta, cand);
}

// A warp's candidates for one list, gathered (one a lane a call) into 32
// slots of shared memory and inserted when the slots fill and at flush:
// one insert for a tile's few candidates instead of one a 32-row chunk.
// Staged pairs are filtered by `bound` (<= the list's k-th); warp_insert
// filters them again by the list's k-th at the time.
struct Batch {
  unsigned long long* slots;  // this warp's 32
  int n;                      // staged, the same in every lane
};

__device__ __forceinline__ void batch_flush(unsigned long long* kept, int k,
                                            unsigned long long& theta, Batch& b) {
  if (b.n == 0) return;  // uniform
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const unsigned long long mine = lane < b.n ? b.slots[lane] : PAD_PAIR;
  __syncwarp();  // every lane has read its slot before they are filled again
  theta = warp_insert(kept, k, theta, mine);
  b.n = 0;
}

__device__ __forceinline__ void batch_add(unsigned long long* kept, int k,
                                          unsigned long long& theta, unsigned long long bound,
                                          Batch& b, unsigned long long cand) {
  const bool take = cand < bound;
  const unsigned m = __ballot_sync(FULL, take);
  if (m == 0u) return;  // uniform
  const int n = __popc(m);
  if (b.n + n > 32) batch_flush(kept, k, theta, b);
  if (take) b.slots[b.n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u))] = cand;
  b.n += n;
}

// ------------------------------------------------------------------ streaming tier
// Rows a thread and ring stages by query tile (measured on the H100:
// at one query 2 rows and 3 stages, at 8 queries 4 rows and 2 stages, whose
// query reads serve twice the FMAs); one block an SM.
template <int QT>
struct StCfg {
  static constexpr int R = QT == 1 ? 2 : 4;
  static constexpr int STAGES = QT == 1 ? 3 : 2;
  using Tile = RowTile<R, STAGES>;
  // a block's shared memory: the ring, the staged queries (in column chunks
  // past VEC_BYTES), then the warps' lists where they fit (else in global
  // scratch)
  static constexpr int VEC_BYTES = 24 * 1024;
  static_assert(Tile::RING + VEC_BYTES <= SMEM_MAX, "the ring and the queries fit");
};
constexpr int ST_MIN_ROWS = 32;  // rows a block at least

// The distance arithmetic of QT queries q0 .. q0 + QT - 1 against a thread's
// rows: K1 writes the distances, K2 offers the keys to its warp's lists.
// ACC (K12, euclidean only, mesh.cu): the value is the slice's partial
// qss + xss - 2 q.x plus acc_in's entry (null on the first feature shard),
// and with fin the finished sqrt(max(., 0)), +inf at masked rows; K1's
// epilogue then writes it to out (the accumulator), K2's offers its key.
template <int METRIC, typename T, int QT, bool ACC = false>
struct DistBody {
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int R = StCfg<QT>::R;  // rows a thread
  static constexpr bool DOT = is_dot_metric<METRIC>();
  const float* q;
  int Q, q0, D, qld;  // qld: elements between queries
  float p;
  const float* qmean;
  const float* xmean;
  const unsigned char* mask;
  long long N, re;
  float* vs;  // staged queries [QT][vp]
  int vp;
  const float* qss;  // [QT] squared query norms (centred for pearson)
  float* out;                // K1: [Q, N] (null for K2)
  const float* acc_in;       // ACC: [Q, N], added before finishing (may be out)
  int fin;                   // ACC: finish (sqrt, mask)
  unsigned long long* kept;  // K2: this warp's lists [QT][k]
  int k;
  unsigned long long theta[QT];  // the k-th of this warp's lists
  unsigned long long* btheta;    // [QT] the least k-th of the block's warps
  unsigned long long* slots;     // this warp's 32 staging slots
  float acc[R][QT], acc2[R][QT], xss[R], mean[R];
  bool open[R];  // the row is not masked: read at its first step, used at its end

  __device__ void stage(int c0, int clen) {
    const int w = (clen + E - 1) / E * E;  // zero past D: the pieces' padding
    for (int e = threadIdx.x; e < QT * w; e += RS_THREADS) {
      const int j = e / w, c = e % w, qi = q0 + j;
      float v = 0.f;
      if (qi < Q && c < clen) {
        v = q[(long long)qi * qld + c0 + c];
        if (METRIC == M_PEARSON) v -= qmean[qi];
      }
      vs[j * vp + c] = v;
    }
  }
  __device__ void start(int i, long long row) {
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[i][j] = acc2[i][j] = 0.f;
    xss[i] = 0.f;
    mean[i] = (METRIC == M_PEARSON && row < re) ? xmean[row] : 0.f;
    open[i] = mask == nullptr || (row < re && mask[row]);
  }
  // columns e .. e + C - 1 of the piece (C = 4: one float4 broadcast a
  // query; C = 1: the row's last piece past D, plain-load staging only)
  template <int C>
  __device__ __forceinline__ void columns(const float (&v)[R][E], int e, int lc) {
    float xv[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        xv[i][c] = METRIC == M_PEARSON ? v[i][e + c] - mean[i] : v[i][e + c];
        if (DOT) xss[i] = fmaf(xv[i][c], xv[i][c], xss[i]);
      }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      float qv[C];
      if constexpr (C == 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(vs + j * vp + lc + e);
        qv[0] = q4.x;
        qv[1] = q4.y;
        qv[2] = q4.z;
        qv[3] = q4.w;
      } else {
        qv[0] = vs[j * vp + lc + e];
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < R; ++i) pw_step<METRIC>(qv[c], xv[i][c], p, acc[i][j], acc2[i][j]);
    }
  }
  __device__ __forceinline__ void step(const float (&v)[R][E], int n, int lc) {
    if (n == E) {
#pragma unroll
      for (int e = 0; e < E; e += 4) columns<4>(v, e, lc);
    } else {
      for (int e = 0; e < n; ++e) columns<1>(v, e, lc);
    }
  }
  // ACC's value of (query qi, row i) at a row below re
  __device__ __forceinline__ float acc_value(int qi, long long row, int i, float qs, float xs,
                                             float dot) const {
    float v = qs + xs - 2.f * dot;  // pw_finish's euclidean expression, unfinished
    if (acc_in != nullptr) v = acc_in[(long long)qi * N + row] + v;
    if (fin) v = open[i] ? sqrtf(fmaxf(v, 0.f)) : __uint_as_float(0x7f800000u);
    return v;
  }
  // the tile's distances: K1 stores them; K2 gathers, query by query, the
  // pairs of the thread's R rows below the list's bound and inserts them
  // once. A pair above any warp's k-th has k better pairs in that warp's
  // list, so the least of the warps' k-ths (btheta) bounds every warp's.
  __device__ void finish(long long row0) {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int qi = q0 + j;
      if (qi >= Q) break;  // uniform
      Batch bt{slots, 0};
      const unsigned long long old = theta[j];
      const unsigned long long bound = old < btheta[j] ? old : btheta[j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long row = row0 + i * RS_THREADS + threadIdx.x;
        float d;
        if constexpr (ACC)
          d = row < re ? acc_value(qi, row, i, qss[j], xss[i], acc[i][j]) : 0.f;
        else
          d = pw_finish<METRIC>(qss[j], xss[i], acc[i][j], acc2[i][j], p);
        if (out == nullptr) {  // uniform
          unsigned long long c = PAD_PAIR;
          if (row < re) c = pair_of(open[i] ? f2key(d) : INF_KEY, row);
          batch_add(kept + j * k, k, theta[j], bound, bt, c);
        } else if (row < re) {
          out[(long long)qi * N + row] = d;
        }
      }
      if (out == nullptr) {
        batch_flush(kept + j * k, k, theta[j], bt);
        if (theta[j] < old && (threadIdx.x & 31) == 0) atomicMin(btheta + j, theta[j]);
      }
    }
  }
};

// Queries of tile blockIdx.x % nqt (QT each) against rows [b * per, (b + 1)
// * per) with b = blockIdx.x / nqt. K1 (out given) writes out [Q, N]; K2
// (out null) writes the block's k picks a query to picks [Q, nblk, k],
// sorted by (key, row), through the warps' lists (kept [blocks][WARPS][QT]
// [k] where they do not fit shared memory). One kernel for both keeps the
// build's instances down; ACC (K12) as DistBody's.
template <int METRIC, typename T, int QT, bool ACC = false>
__global__ void __launch_bounds__(RS_THREADS, 1)
stream_kernel(const float* __restrict__ q, const T* __restrict__ x, int Q, long long N, int D,
              KnnView view, float p, const float* __restrict__ qmean,
              const float* __restrict__ xmean, const unsigned char* __restrict__ mask, int k,
              long long per, int nqt, int vec, int vchunk, int kept_smem, float* out,
              unsigned long long* kept, float* __restrict__ picks_d, int* __restrict__ picks_i) {
  // ring, then the queries, then (kept_smem) the warps' lists
  extern __shared__ __align__(16) unsigned char st_smem[];
  __shared__ float s_qss[QT];
  __shared__ unsigned long long s_btheta[QT];
  __shared__ unsigned long long s_slots[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const long long rb = b * per, re = min(N, rb + per);
  const bool fused = out == nullptr;
  using Cfg = StCfg<QT>;
  DistBody<METRIC, T, QT, ACC> body;
  body.q = q;
  body.Q = Q;
  body.q0 = q0;
  body.D = D;
  body.qld = view.qld;
  body.p = p;
  body.qmean = qmean;
  body.xmean = xmean;
  body.mask = mask;
  body.N = N;
  body.re = re;
  body.vs = reinterpret_cast<float*>(st_smem + Cfg::Tile::RING);
  body.vp = (min(vchunk, D) + 15) / 16 * 16;
  body.qss = s_qss;
  body.out = out;
  body.acc_in = view.acc_in;
  body.fin = view.fin;
  body.k = k;
  // this block's lists [WARPS][QT][k]: shared memory while they fit (an
  // insert then costs no L2 round trip), else global scratch
  unsigned long long* lists =
      kept_smem ? reinterpret_cast<unsigned long long*>(st_smem + Cfg::Tile::RING + QT * body.vp * 4)
                : kept + (long long)blockIdx.x * WARPS * QT * k;
  body.kept = lists + warp * QT * k;
  if (fused) {
    for (int e = lane; e < QT * k; e += 32) body.kept[e] = PAD_PAIR;
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < QT; ++j) body.theta[j] = PAD_PAIR;
  body.btheta = s_btheta;  // read after row_stream's first barrier
  body.slots = s_slots[warp];
  if (threadIdx.x < QT) s_btheta[threadIdx.x] = PAD_PAIR;
  // the queries' squared norms, a warp a query (read after row_stream's
  // first barrier)
  for (int j = warp; j < QT; j += WARPS) {
    float s = 0.f;
    if (is_dot_metric<METRIC>() && q0 + j < Q) {
      const float m = METRIC == M_PEARSON ? qmean[q0 + j] : 0.f;
      for (int c = lane; c < D; c += 32) {
        const float v = q[(long long)(q0 + j) * view.qld + c] - m;
        s = fmaf(v, v, s);
      }
    }
    s = wsum(s);
    if (lane == 0) s_qss[j] = s;
  }
  row_stream<T, Cfg::R, Cfg::STAGES>(x, rb, re, D, view.ld, vec, vchunk, st_smem, body);
  if (!fused) return;
  __syncthreads();  // every warp's lists are complete
  const long long nblk = gridDim.x / nqt;
  for (int j = warp; j < QT; j += WARPS) {
    if (q0 + j >= Q) continue;  // uniform in the warp
    unsigned long long* dst = lists + j * k;
    unsigned long long th = dst[k - 1];
    for (int w = 1; w < WARPS; ++w) {
      const unsigned long long* src = lists + (w * QT + j) * k;
      for (int c0 = 0; c0 < k; c0 += 32)
        th = warp_offer(dst, k, th, c0 + lane < k ? src[c0 + lane] : PAD_PAIR);
    }
    const long long o = ((long long)(q0 + j) * nblk + b) * k;
    for (int i = lane; i < k; i += 32) {
      const unsigned long long v = dst[i];
      picks_d[o + i] = key2f((unsigned)(v >> 32));
      picks_i[o + i] = (int)(unsigned)(v & 0xFFFFFFFFull);
    }
  }
}

template <typename T, int QT>
int vchunk_for(int D) {
  constexpr int KC = RS_CHUNK / (int)sizeof(T);
  const int fit = StCfg<QT>::VEC_BYTES / (QT * 4) / KC * KC;
  return (D + 15) / 16 * 16 <= fit ? D : fit;
}

template <int M, typename T, int QT, bool ACC = false>
int launch_stream_qt(bool fused, const KnnPlan& pl, const float* q, const T* x, int Q, long long N, int D,
                     const KnnView& view, float p, const float* qmean, const float* xmean,
                     const unsigned char* mask, int k, float* out, unsigned char* scratch,
                     cudaStream_t s) {
  using Cfg = StCfg<QT>;
  static std::atomic<unsigned> seen{0};
  const int vchunk = vchunk_for<T, QT>(D);
  const int vp = (min(vchunk, D) + 15) / 16 * 16;
  const int lists = fused ? WARPS * QT * k * 8 : 0;
  const int base = Cfg::Tile::RING + QT * vp * 4;
  const int kept_smem = fused && base + lists <= SMEM_MAX;
  const int smem = base + (kept_smem ? lists : 0);
  if (int err = opt_in_smem(stream_kernel<M, T, QT, ACC>, SMEM_MAX, seen)) return err;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && ((long long)D * sizeof(T) % 16 == 0) &&
                  (view.ld * (long long)sizeof(T) % 16 == 0);
  unsigned long long* kept = fused ? reinterpret_cast<unsigned long long*>(scratch + pl.kept) : nullptr;
  float* pd = fused ? reinterpret_cast<float*>(scratch + pl.picks_d) : nullptr;
  int* pi = fused ? reinterpret_cast<int*>(scratch + pl.picks_i) : nullptr;
  stream_kernel<M, T, QT, ACC><<<(unsigned)(pl.nblk * pl.nqt), RS_THREADS, smem, s>>>(
      q, x, Q, N, D, view, p, qmean, xmean, mask, k, pl.per, pl.nqt, vec, vchunk, kept_smem, out,
      kept, pd, pi);
  return (int)cudaGetLastError();
}

// the streaming tier over rows of type T: the metric's kernel at the plan's
// query tile (fused: K2's running top-k, else K1 into out); only the
// metrics LO..HI are instantiated (a source builds a share of them), the
// others are refused
template <typename T, int LO = M_EUCLIDEAN, int HI = M_MINKOWSKI>
int stream_dispatch(bool fused, int metric, const KnnPlan& pl, const float* q, const T* x, int Q,
                    long long N, int D, float p, const float* qmean, const float* xmean,
                    const unsigned char* mask, int k, float* out, unsigned char* scratch,
                    cudaStream_t s) {
  const KnnView view{D, D, nullptr, 1};
#define KNN_CASE(M)                                                                              \
  case M:                                                                                        \
    if constexpr (M >= LO && M <= HI)                                                            \
      return pl.qt == 1 ? launch_stream_qt<M, T, 1>(fused, pl, q, x, Q, N, D, view, p, qmean,    \
                                                    xmean, mask, k, out, scratch, s)             \
                        : launch_stream_qt<M, T, 8>(fused, pl, q, x, Q, N, D, view, p, qmean,    \
                                                    xmean, mask, k, out, scratch, s);            \
    return (int)cudaErrorInvalidValue;
  switch (metric) {
    KNN_CASE(M_EUCLIDEAN)
    KNN_CASE(M_COSINE)
    KNN_CASE(M_MANHATTAN)
    KNN_CASE(M_CHEBYSHEV)
    KNN_CASE(M_HAMMING)
    KNN_CASE(M_JACCARD)
    KNN_CASE(M_PEARSON)
    KNN_CASE(M_MINKOWSKI)
    default: return (int)cudaErrorInvalidValue;
  }
#undef KNN_CASE
}

}  // namespace

// the streaming tier over f32 rows (knn_f32.cu): stream_dispatch<float>
int knn_stream_f32(bool fused, int metric, const KnnPlan& pl, const float* q, const float* x,
                   int Q, long long N, int D, float p, const float* qmean, const float* xmean,
                   const unsigned char* mask, int k, float* out, unsigned char* scratch,
                   cudaStream_t s);

// the streaming tier over bf16 rows, its metrics in two sources so nvcc
// builds the halves in parallel: euclidean to chebyshev (knn_bf16_lo.cu),
// hamming to minkowski (knn_bf16_hi.cu)
#define KNN_BF16_LO_LAST M_CHEBYSHEV
int knn_stream_bf16_lo(bool fused, int metric, const KnnPlan& pl, const float* q,
                       const __nv_bfloat16* x, int Q, long long N, int D, float p,
                       const float* qmean, const float* xmean, const unsigned char* mask, int k,
                       float* out, unsigned char* scratch, cudaStream_t s);
int knn_stream_bf16_hi(bool fused, int metric, const KnnPlan& pl, const float* q,
                       const __nv_bfloat16* x, int Q, long long N, int D, float p,
                       const float* qmean, const float* xmean, const unsigned char* mask, int k,
                       float* out, unsigned char* scratch, cudaStream_t s);
