// The exact kNN's tensor-core tier (K1 and K2 at Q > 8 over bf16 rows,
// euclidean or cosine; the design is in knn.cu's header) and the launch
// plan of both tiers, shared by knn.cu and mesh.cu, whose K12 instances
// take the accumulator epilogue (ACC, as knn.cuh's DistBody). Include after
// knn.cuh.
#pragma once

namespace {

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
// qss [Qp] = |q|^2 in f32. Queries qld elements apart. A warp a query.
__global__ void __launch_bounds__(256) split_queries(const float* __restrict__ q, int qld, int Q,
                                                     int Qp, int D, int Dp,
                                                     unsigned short* __restrict__ limbs,
                                                     float* __restrict__ qss) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (j >= Qp) return;  // whole warps
  float s = 0.f;
  for (int c = lane; c < Dp; c += 32) {
    const float v = (j < Q && c < D) ? q[j * qld + c] : 0.f;
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
__device__ __noinline__ float tq_exact_dot(const unsigned short* __restrict__ x, long long ld,
                                           long long row, const float* __restrict__ q, int qld,
                                           int j, int D) {
  float s = 0.f;
  for (int c = 0; c < D; ++c)
    s = fmaf(__uint_as_float((unsigned)x[row * ld + c] << 16), q[(long long)j * qld + c], s);
  return s;
}

// Warp (wm, wn) = (warp % TQ_WM, warp / TQ_WM) owns rows wm*32 .. +31 of a tile and
// queries wn*32 .. +31 of the query tile: fragments mt (16 rows) x nt (8
// queries); lane (g, t) holds rows g, g + 8 and queries 2t, 2t + 1 of
// each. Query tile blockIdx.x % nqt, rows [b * per, (b + 1) * per) with
// b = blockIdx.x / nqt. At a tile's end the distances go to the tile
// buffer [query][row]; K1 stores them, K2 offers them to the running top-k
// of each query, which warp w keeps for the queries w, w + 16, .... ACC
// (K12): the buffer holds the partial qss + xss - 2 q.x, and the warps
// reading it by query add the accumulator's entries (coalesced there),
// finish and mask as DistBody's ACC does, then store or offer.
template <int METRIC, bool FUSED, bool ACC = false>
__global__ void __launch_bounds__(TQ_THREADS, 1)
tq_kernel(const unsigned short* __restrict__ x, long long N, int D, int Dp,
          const unsigned short* __restrict__ limbs, const float* __restrict__ qss, int Qp,
          const float* __restrict__ q, int Q, KnnView view, const unsigned char* __restrict__ mask,
          int k, long long per, int nqt, int vec, int kept_smem, float* out,
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
  const long long ld = view.ld;
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
          cp_async16(dst, in ? x + row * ld + kk : x, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (row < re && kk + e < D) ? x[row * ld + kk + e] : (unsigned short)0;
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
    if ((FUSED || ACC) && s % nk == 0) {  // the tile's mask bits, read now, used at its end
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
          if (row < re && q0 + c < Q && !finite_f(dot))
            dot = tq_exact_dot(x, ld, row, q, view.qld, q0 + c, D);
          float d;
          if constexpr (ACC)
            d = s_qss[c] + xn[r] - 2.f * dot;  // pw_finish's euclidean expression, unfinished
          else
            d = pw_finish<METRIC>(s_qss[c], xn[r], dot, 0.f, 0.f);
          tile[c * TQ_BM + (r ^ (((c >> 1) & 3) << 3))] =
              (FUSED && !ACC) ? f2key(d) : __float_as_uint(d);
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
        unsigned v = tile[c * TQ_BM + ((32 * m + lane) ^ (((c >> 1) & 3) << 3))];
        if constexpr (ACC) {
          float d = __uint_as_float(v);
          if (row < re) {
            if (view.acc_in != nullptr) d = view.acc_in[(long long)qi * N + row] + d;
            if (view.fin) d = (open >> m) & 1u ? sqrtf(fmaxf(d, 0.f)) : __uint_as_float(0x7f800000u);
            if (!FUSED) out[(long long)qi * N + row] = d;
          }
          v = f2key(d);
        }
        if (FUSED) {
          unsigned long long cp = PAD_PAIR;
          if (row < re) cp = pair_of((open >> m) & 1u ? v : INF_KEY, row);
          batch_add(kq + c * k, k, th, s_theta[c], bt, cp);
        } else if (!ACC && row < re) {
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

template <int M, bool FUSED, bool ACC = false>
int launch_tq(const KnnPlan& pl, const float* q, const unsigned short* x, int Q, long long N, int D,
              const KnnView& view, const unsigned char* mask, int k, float* out,
              unsigned char* scratch, cudaStream_t s) {
  static std::atomic<unsigned> seen{0};
  unsigned short* limbs = reinterpret_cast<unsigned short*>(scratch + pl.limbs);
  float* qss = reinterpret_cast<float*>(scratch + pl.qss);
  split_queries<<<(unsigned)((pl.Qp + 7) / 8), 256, 0, s>>>(q, view.qld, Q, pl.Qp, D, pl.Dp,
                                                            limbs, qss);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (int err = opt_in_smem(tq_kernel<M, FUSED, ACC>, SMEM_MAX, seen)) return err;
  const int vec = D % 8 == 0 && view.ld % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int lists = FUSED ? TQ_BN * k * 8 : 0;
  const int kept_smem = FUSED && TQ_SMEM + lists <= SMEM_MAX;
  const int smem = TQ_SMEM + (kept_smem ? lists : 0);
  unsigned long long* kept = FUSED ? reinterpret_cast<unsigned long long*>(scratch + pl.kept) : nullptr;
  float* pd = FUSED ? reinterpret_cast<float*>(scratch + pl.picks_d) : nullptr;
  int* pi = FUSED ? reinterpret_cast<int*>(scratch + pl.picks_i) : nullptr;
  tq_kernel<M, FUSED, ACC><<<(unsigned)(pl.nblk * pl.nqt), TQ_THREADS, smem, s>>>(
      x, N, D, pl.Dp, limbs, qss, pl.Qp, q, Q, view, mask, k, pl.per, pl.nqt, vec, kept_smem, out,
      kept, pd, pi);
  return (int)cudaGetLastError();
}

}  // namespace
