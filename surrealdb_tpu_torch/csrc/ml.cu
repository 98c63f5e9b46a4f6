// The ML forward (K10) for Hopper (sm_90a), behind the same plain C
// interface as knn.cu, ivf.cu, graph.cu and bm25.cu (one library, loaded
// with ctypes by surrealdb_tpu_torch/ops/_cuda.py).
//
// K10 replaces surrealdb_tpu/ml/model.py CompiledModel._device_fn, the
// jitted model forward: for each layer h = act(h @ W + b), the product in
// f32 (preferred_element_type=f32), then relu / tanh / sigmoid / softmax
// over the last axis / none. Two kernels:
//
// ml_linear: out [M, N] f32 = E(x [M, K] @ W [K, N]); x f32 or bf16 (the
// vector mirror as the card holds it: read as bf16, upcast exactly, so no
// f32 copy of the corpus is made), W f32, E the epilogue program
// (ewise.cuh): at most 8 instructions passed by value, over the
// product and up to two per-column [N] operands. A model layer's is
// act(h + b): the bias add and one activation instruction; an ONNX Gemm's
// or MatMul's (K16, ml/onnx_mini.py) carries its alpha, + beta C and the
// chain of elementwise nodes after it. E runs over a thread's tile of
// products before they are written (epi_tile: one dispatch an
// instruction); the wide path runs a layer's act(h + b) value by value at
// the store instead (its LAYER instance). The result is
// f32-accurate: no TF32, no bf16 rounding of W or of f32 x.
// Three paths, chosen by linear_dispatch:
//
// - skinny (N = 1, bench config 5's 768 -> 1; N = 2 over rows of 1 KB or
//   more; any N <= 16 whose x is not 16-byte aligned or whose W is above
//   NR_W_MAX): the read of x bounds it (2^20 x 768 bf16 = 1.61 GB, 0.48 ms
//   at 3.35 TB/s). The row-streaming core it shares with the exact kNN
//   kernels (rowstream.cuh): persistent blocks, one an SM, each on its own
//   contiguous range of rows (no tail of row tiles), a thread owns 2 rows,
//   x arrives by 16-byte cp.async through a 4-stage ring (plain loads where
//   K or the base is not 16-byte aligned), W's columns sit in shared memory
//   (in column chunks where larger than the ring leaves) and each W value
//   read is a broadcast that serves both rows. The sums are f32 FMA chains
//   over k. On the H100, 2 rows x 3 stages and 1 row x 4 stages at two
//   blocks an SM came within 1% of this setting; 4 rows x 2 stages lost 18%.
// - narrow (2 <= N <= 16, x 16-byte aligned, W [K, NB] within NR_W_MAX):
//   the skinny path's butterfly (5 shuffles a column a row, N padded to a
//   power of two) made it shuffle-bound. Here a thread owns R rows and
//   keeps their NB sums in registers (a sequential f32 FMA chain over k, no
//   cross-lane reduction). A block is persistent (one an SM) and walks (row
//   tile, K chunk) steps: each step, 256 R rows x 64 bytes of x go into a
//   ring of shared-memory stages by 16-byte cp.async (L2 fetching the 256
//   bytes around each, so DRAM sees whole bursts), rows padded to 80 bytes
//   so a quarter warp's 16-byte reads hit 32 banks; W [K][NB] sits in
//   shared memory and every lane reads the same W value. A broadcast read
//   costs a warp as much shared-memory time as a spread one, so W's reads
//   bound the path at large NB: R = 4 (2 stages) where NB >= 8 and rows
//   are 1 KB or more, else R = 2 (3 stages). At a tile's end the outputs
//   are staged (odd pitch) in the stage just read and stored coalesced. NB
//   in {2, 4, 8, 12, 16} (N rounded up).
//   The rule is measured (chip_smoke.py --ml-only, phase ml_paths, each
//   design forced by ML_FORCE_PATH): at K = 768 bf16 the narrow path wins
//   2.5-2.8x at N = 10 and 16 and loses 5% at N = 2; at K = 64 and 128 f32
//   it wins 3.5-5x; R = 4 beats R = 2 at K = 768 and loses at K <= 128.
// - wide (N > 16; the MLP's hidden layers): tensor cores, with limbs. Each
//   f32 is split by truncation into three bf16 limbs, v = v0 + v1 + v2
//   exactly (v0 the top 8 significand bits, v1 the next 8 of the rest, v2
//   what is left, at most 8 bits). A product of two bf16 limbs is exact in
//   f32, and mma.sync.m16n8k16 (bf16 -> f32) sums them in f32. bf16 x is
//   exact, so x W = x W0 + x W1 + x W2 (3 passes) loses only the order of
//   the f32 sums, as an FMA chain does. f32 x keeps the 6 products of order
//   >= 2^-16 (x0w0, x0w1, x1w0, x0w2, x1w1, x2w0); the dropped three are
//   below 3 x 2^-24 of |x w|. Passes run smallest first. 3xTF32
//   (m16n8k8) costs the same tensor time (3 products at half the bf16
//   rate) for 2^-22 of accuracy, so bf16 limbs it is, one mma shape for
//   both. A block is persistent and walks tiles of BM = 64 MT rows x BN =
//   32 NT columns (NT 4, or 2 where 64-column tiles pad N less; x is read
//   once from HBM for N <= 128, the other column tiles' reads meet it in
//   L2); 16 warps, 4 along M and 4 along N. K goes 32 a step: x (16-byte)
//   and W (16-byte where N % 4 == 0, else 4-byte) by cp.async into a
//   4-slot ring; a step's W (and f32 x) is split into limb planes [row][k]
//   of bf16 pairs with a 20-word pitch, so every fragment load is one
//   conflict-free 32-bit read. The planes are double-buffered: one
//   barrier a step, and a warp issues step s's mma.sync and then splits
//   step s + 1 while the tensor cores work. The epilogue program runs on
//   the fragments, which are stored (a lane's two columns as
//   one 8-byte store: whole 32-byte sectors). What holds the path back on
//   the H100: every block splits W again for each of its tiles, f32 x is
//   split on the CUDA cores, and mma.sync reaches about half the tensor
//   rate of wgmma; a wgmma/TMA version with W split once is the next step.
//   Non-finite values: a limb split of inf or NaN is not (v, 0, 0), and
//   even (v, 0, 0) would meet a zero limb of the other operand (inf x 0 =
//   NaN where f32 gives inf). So the epilogue recomputes any output that
//   came out non-finite as the f32 FMA chain over k (exact_dot), which is
//   what f32 gives; a finite x and W stay on the tensor cores.
//
// ml_softmax: a row softmax over [M, N] f32 in the reference's order
// (jax.nn.softmax): the row max, exp(h - max), then the division by the
// row sum; one read and one write of HBM, in place when out == h.
// - N <= 32: a block loads its run of 128 rows (contiguous, 128 N floats)
//   with 16-byte loads into shared memory, thread r reduces row r starting
//   at column r mod N (so a warp's lanes spread over the banks), and the run
//   is stored back the same way.
// - 32 < N <= 1024: a warp a row, the row in registers (up to 32 values a
//   lane, 16-byte loads where N % 4 == 0), max and sum by shuffles.
// - N > 1024: a warp a row over the row three times (L1/L2 after the
//   first read).
//
// Sigmoid is 1 / (1 + exp(-x)), as jax.nn.sigmoid and the host twin: it
// saturates to 0 and 1 at large |x| without a NaN.
//
// The helpers that need the card (cp.async, mma.sync) and the limb split
// are in mma.cuh, shared with ivf.cu and knn.cu. ML_FORCE_PATH (a -D flag;
// 0 by default, the rule) forces N <= 16 onto the skinny path (1), or onto
// the narrow path where it runs with R = 2 (2) or, at NB >= 8, R = 4 (3), to
// time the designs against each other.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "ewise.cuh"
#include "launch.cuh"
#include "mma.cuh"
#include "rowstream.cuh"

#ifndef ML_FORCE_PATH
#define ML_FORCE_PATH 0
#endif

namespace {

__device__ __forceinline__ float ml_f(float v) { return v; }
__device__ __forceinline__ float ml_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr unsigned FULL = 0xffffffffu;

// 16 bytes of x as floats: 4 f32 or 8 bf16 (upcast exactly)
__device__ __forceinline__ void unpack16(const uint4& q, float* v, const float*) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(const uint4& q, float* v, const __nv_bfloat16*) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// the f32 FMA chain of one output over k (the wide path's non-finite
// outputs); out of line: a copy at each of the epilogue's outputs made
// ptxas take minutes over the wide kernels
template <typename T>
__device__ __noinline__ float exact_dot(const T* __restrict__ x, const float* __restrict__ w,
                                        long long row, int col, int K, int N) {
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(ml_f(x[row * K + k]), w[(long long)k * N + col], s);
  return s;
}

// ------------------------------------------------------------------ skinny
constexpr int SK_R = 2;       // rows a thread
constexpr int SK_STAGES = 4;  // ring stages
using SkTile = RowTile<SK_R, SK_STAGES>;
// shared memory for W's staged columns: 96 KB, or what the ring leaves
constexpr int SK_SMEM_CAP = 232448 - 1024;  // one block an SM, less the statics
constexpr int SK_W_BYTES =
    SK_SMEM_CAP - SkTile::RING < 96 * 1024 ? SK_SMEM_CAP - SkTile::RING : 96 * 1024;
static_assert(SK_W_BYTES >= 8 * 1024, "room for W");

// out[row] = E(x[row] . W[:, n]) for the NB (>= N) columns of W staged as
// f32 [NB][wp] (zero past N and K): an f32 FMA chain over k a (row,
// column), the epilogue at the row's end (rowstream.cuh)
template <typename T, int NB>
struct LinearBody {
  static constexpr int E = 16 / (int)sizeof(T);
  const float* w;
  const EpiProg* epi;
  int K, N;
  long long re;
  float* out;
  float* ws;
  int wp;
  float acc[SK_R][NB];

  __device__ void stage(int c0, int clen) {
    const int wd = (clen + E - 1) / E * E;  // zero past K: the pieces' padding
    for (int e = threadIdx.x; e < NB * wd; e += RS_THREADS) {
      const int n = e / wd, c = e % wd;
      ws[n * wp + c] = (n < N && c < clen) ? w[(long long)(c0 + c) * N + n] : 0.f;
    }
  }
  __device__ void start(int i, long long) {
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[i][n] = 0.f;
  }
  // past K both x (staged zero) and W are zero: n needs no guard
  // W read as float4 broadcasts: 4 columns of one output a read
  __device__ __forceinline__ void step(const float (&v)[SK_R][E], int, int lc) {
#pragma unroll
    for (int e = 0; e < E; e += 4)
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float4 w4 = *reinterpret_cast<const float4*>(ws + n * wp + lc + e);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < SK_R; ++i) acc[i][n] = fmaf(v[i][e + c], wv[c], acc[i][n]);
      }
  }
  __device__ void finish(long long row0) {
    epi_tile<SK_R, NB>(*epi, acc, EpiCols{0, 2}, N);
#pragma unroll
    for (int i = 0; i < SK_R; ++i) {
      const long long row = row0 + i * RS_THREADS + threadIdx.x;
      if (row >= re) continue;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        if (n < N) out[row * N + n] = acc[i][n];
    }
  }
};

// rows [blockIdx.x * per, + per) of x [M, K]; W staged kchunk columns at a
// time (>= K: once)
template <typename T, int NB>
__global__ void __launch_bounds__(RS_THREADS, 1)
skinny_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const __grid_constant__ EpiProg epi,
              long long M, int K, int N, long long per, int vec, int kchunk,
              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sk_smem[];  // ring, then W
  const long long rb = (long long)blockIdx.x * per, re = min(M, rb + per);
  LinearBody<T, NB> body;
  body.w = w;
  body.epi = &epi;
  body.K = K;
  body.N = N;
  body.re = re;
  body.out = out;
  body.ws = reinterpret_cast<float*>(sk_smem + SkTile::RING);
  body.wp = (min(kchunk, K) + 15) / 16 * 16;
  row_stream<T, SK_R, SK_STAGES>(x, rb, re, K, K, vec, kchunk, sk_smem, body);
}

// ------------------------------------------------------------------ narrow
constexpr int NR_THREADS = 256;
constexpr int NR_CHUNK = 64;                     // bytes of a row a step
constexpr int NR_PITCH = NR_CHUNK + 16;          // bytes a staged row
constexpr int NR_W_MAX = 64 * 1024;              // bytes of W [K][NB] the path takes

// R rows a thread: 2 with a 3-stage ring, or 4 (a W value read from shared
// memory serves 4 FMAs) with 2 stages of twice the rows
template <int R>
struct NarrowTile {
  static constexpr int ROWS = NR_THREADS * R;  // rows a tile
  static constexpr int STAGES = R == 2 ? 3 : 2;
  static constexpr int STAGE_BYTES = ROWS * NR_PITCH;
  static constexpr int SMEM_MAX = STAGES * STAGE_BYTES + NR_W_MAX;
  static_assert(SMEM_MAX <= 232448, "a block's shared memory");
};

template <typename T, int NB, int R>
__global__ void __launch_bounds__(NR_THREADS, 1)
narrow_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const __grid_constant__ EpiProg epi,
              long long M, int K, int N, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char nr_smem[];
  constexpr int E = 16 / (int)sizeof(T);         // values a 16-byte piece
  constexpr int KC = NR_CHUNK / (int)sizeof(T);  // values of a row a step
  constexpr int PIECES = NR_CHUNK / 16;          // pieces of a row a step
  constexpr int P = NB + 1;                      // pitch of the staged outputs (odd)
  using Tile = NarrowTile<R>;
  constexpr int ROWS = Tile::ROWS, NR_STAGES = Tile::STAGES, NR_STAGE_BYTES = Tile::STAGE_BYTES;
  static_assert(ROWS * P * 4 <= NR_STAGE_BYTES, "outputs must fit a stage");
  unsigned char* xs = nr_smem;  // [NR_STAGES][ROWS][NR_PITCH]
  float* ws = reinterpret_cast<float*>(nr_smem + NR_STAGES * NR_STAGE_BYTES);  // [K][NB]
  const int tid = threadIdx.x;
  for (int e = tid; e < K * NB; e += NR_THREADS) {
    const int k = e / NB, n = e % NB;
    ws[e] = n < N ? w[(long long)k * N + n] : 0.f;
  }
  const long long tiles = (M + ROWS - 1) / ROWS;
  const int nchunks = (K + KC - 1) / KC;
  const long long mine =
      tiles > (long long)blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = mine * nchunks;
  // step s: tile blockIdx.x + (s / nchunks) gridDim.x, K chunk s % nchunks
  auto tile_row0 = [&](long long s) {
    return ((long long)blockIdx.x + (s / nchunks) * gridDim.x) * ROWS;
  };
  auto issue = [&](long long s) {
    if (s < steps) {
      const long long row0 = tile_row0(s);
      const int k0 = (int)(s % nchunks) * KC, klen = min(KC, K - k0);
      unsigned char* st = xs + (int)(s % NR_STAGES) * NR_STAGE_BYTES;
      for (int p = tid; p < ROWS * PIECES; p += NR_THREADS) {
        const int r = p / PIECES, q = p % PIECES;
        const long long row = row0 + r;
        if (row < M && q * E < klen) cp_async16(st + r * NR_PITCH + q * 16, x + row * K + k0 + q * E, 16);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  for (int s = 0; s < NR_STAGES - 1; ++s) issue(s);
  float acc[R][NB];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[i][n] = 0.f;
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<NR_STAGES - 2>();
    __syncthreads();  // step s landed for every thread; step s - 1 is no longer read
    issue(s + NR_STAGES - 1);
    const int chunk = (int)(s % nchunks), k0 = chunk * KC, klen = min(KC, K - k0);
    unsigned char* cur = xs + (int)(s % NR_STAGES) * NR_STAGE_BYTES;
    for (int q = 0; q < klen / E; ++q) {
      float xv[R][E];
#pragma unroll
      for (int i = 0; i < R; ++i)
        unpack16(*reinterpret_cast<const uint4*>(cur + (tid + i * NR_THREADS) * NR_PITCH + q * 16),
                 xv[i], x);
      const float* wk = ws + (k0 + q * E) * NB;
#pragma unroll
      for (int j = 0; j < E; ++j)
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float wv = wk[j * NB + n];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][n] = fmaf(xv[i][j], wv, acc[i][n]);
        }
    }
    if (chunk == nchunks - 1) {  // the tile's last chunk: its outputs
      const long long row0 = tile_row0(s);
      epi_tile<R, NB>(epi, acc, EpiCols{0, 2}, N);
      __syncthreads();  // the stage is read: it holds the outputs now
      float* os = reinterpret_cast<float*>(cur);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          os[(tid + i * NR_THREADS) * P + n] = acc[i][n];
          acc[i][n] = 0.f;
        }
      __syncthreads();
      const int count = (int)min((long long)ROWS, M - row0) * N;
      float* dst = out + row0 * N;
      const int dr = NR_THREADS / N, dn = NR_THREADS % N;
      int r = tid / N, n = tid % N;  // element e = r N + n, carried without a division
      for (int e = tid; e < count; e += NR_THREADS) {
        dst[e] = os[r * P + n];
        r += dr;
        n += dn;
        if (n >= N) {
          n -= N;
          ++r;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ wide
constexpr int WD_THREADS = 512;   // 16 warps: 4 along M x 4 along N
constexpr int WD_BK = 32;         // K a step: two k16 steps
constexpr int WD_STAGES = 4;      // raw ring: steps s + 2, s + 3 in flight while s runs
constexpr int WD_LP = WD_BK + 8;  // bf16 a limb-plane row: 20 words, conflict-free fragments
constexpr int WD_LPW = WD_LP / 2;

// f32 x: the limb products (x limb, W limb) of order >= 2^-16, smallest
// first: (2,0) (1,1) (0,2) (1,0) (0,1) (0,0)
__host__ __device__ constexpr int pass_x_limb(int pp) { return pp == 0 ? 2 : pp == 1 || pp == 3 ? 1 : 0; }
__host__ __device__ constexpr int pass_w_limb(int pp) { return pp == 2 ? 2 : pp == 1 || pp == 4 ? 1 : 0; }

template <typename T, int MT, int NT>
struct WideTile {
  static constexpr int BM = 64 * MT, BN = 32 * NT;
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int XP = WD_BK + 8;    // elements a raw x row (bf16: the plane pitch)
  static constexpr int WP = BN + 4;       // floats a raw W row
  static constexpr int X_RAW = BM * XP * (int)sizeof(T);
  static constexpr int W_RAW = WD_BK * WP * 4;
  static constexpr int RAW = X_RAW + W_RAW;                           // a ring slot
  static constexpr int XL = sizeof(T) == 2 ? 0 : 3 * BM * WD_LP * 2;  // f32 x's limb planes
  static constexpr int WL = 3 * BN * WD_LP * 2;                       // W's limb planes
  static constexpr int PL = XL + WL;                                  // a planes buffer (two)
  static constexpr int SMEM = WD_STAGES * RAW + 2 * PL;
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(BM * (WD_BK / E) % WD_THREADS == 0 && WD_BK * BN / 4 % WD_THREADS == 0 &&
                    WD_BK / 2 * BM % WD_THREADS == 0 && WD_BK / 2 * BN % WD_THREADS == 0,
                "the copy and split loops take whole turns of the block");
};

// a model layer's program, act(h + b): [add r0, r1] with r1 a per-column
// [N] operand, then at most one of relu, tanh, sigmoid over r0 (epi_layer
// reads it off an EpiProg). The bias is required: a test for a missing one
// at each store cost the bf16 instance a fifth of its time (PERF.md)
struct EpiLayer {
  const float* b;  // r1's [N]
  int act;         // EW_COPY for none
};

inline bool epi_layer(const EpiProg& e, EpiLayer& l) {
  l = EpiLayer{nullptr, EW_COPY};
  const EwIns* in = e.ins;
  if (e.n < 1 || in[0].op != EW_ADD || in[0].a + in[0].b != 1 || in[0].a * in[0].b != 0 ||
      e.opnd[0] == nullptr || e.ostride[0] != 1)
    return false;
  l.b = e.opnd[0];
  int i = 1;
  if (i < e.n && in[i].a == 0 &&
      (in[i].op == EW_RELU || in[i].op == EW_TANH || in[i].op == EW_SIGMOID)) {
    l.act = in[i].op;
    ++i;
  }
  return i == e.n;
}

// a layer's activation of one value at its store: epi_tile's, so the bits
// agree
__device__ __forceinline__ float layer_act(float v, int act) {
  if (act == EW_RELU) return ew_relu(v);
  if (act == EW_TANH) return tanhf(v);
  if (act == EW_SIGMOID) return ew_sigmoid(v);
  return v;
}

// LAYER: the program is a layer's (epi_layer: bias lb, activation lact),
// run value by value at the store, which keeps the bf16 instance's
// registers (128 a thread at 512 threads, 64 of them accumulators) at the
// fused bias and activation's; else epi_tile over a copy of the tile (it
// spills there: PERF.md)
template <typename T, int MT, int NT, bool LAYER>
__global__ void __launch_bounds__(WD_THREADS, 1)
wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const __grid_constant__ EpiProg epi, const float* __restrict__ lb, int lact,
            long long M, int K, int N, int vec, int wvec, int ovec, float* __restrict__ out) {
  using Tile = WideTile<T, MT, NT>;
  constexpr int BM = Tile::BM, BN = Tile::BN, E = Tile::E, XP = Tile::XP, WP = Tile::WP;
  constexpr bool XBF = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char wd_smem[];
  unsigned char* planes = wd_smem + WD_STAGES * Tile::RAW;  // [2][x limbs (f32 x), W limbs]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2;
  // persistent: the block walks tiles blockIdx.x, + gridDim.x, ... (columns
  // fastest) and each tile's K steps; the ring runs on across tiles
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + WD_BK - 1) / WD_BK;
  const long long mine =
      tiles > (long long)blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = mine * nk;
  auto tile_of = [&](long long s, long long& row0, int& col0) {
    const long long tile = blockIdx.x + (s / nk) * gridDim.x;
    row0 = tile / tiles_n * BM;
    col0 = (int)(tile % tiles_n) * BN;
  };

  // step s's x rows and W columns into ring slot s % WD_STAGES
  auto issue = [&](long long s) {
    if (s < steps) {
      long long row0;
      int col0;
      tile_of(s, row0, col0);
      unsigned char* st = wd_smem + (int)(s % WD_STAGES) * Tile::RAW;
      T* xr = reinterpret_cast<T*>(st);
      float* wr = reinterpret_cast<float*>(st + Tile::X_RAW);
      const int k0 = (int)(s % nk) * WD_BK;
      if (vec) {  // K % E == 0 and x 16-byte aligned: a piece is all in or all out
        constexpr int PIECES = WD_BK / E;
#pragma unroll
        for (int i = 0; i < BM * PIECES / WD_THREADS; ++i) {
          const int p = tid + i * WD_THREADS, r = p / PIECES, q = p % PIECES, k = k0 + q * E;
          const long long row = row0 + r;
          const bool in = row < M && k < K;
          cp_async16(xr + r * XP + q * E, in ? x + row * K + k : x, in ? 16 : 0);
        }
      } else {
        for (int p = tid; p < BM * WD_BK; p += WD_THREADS) {
          const int r = p / WD_BK, kk = p % WD_BK, k = k0 + kk;
          const long long row = row0 + r;
          xr[r * XP + kk] = (row < M && k < K) ? x[row * K + k] : T{};
        }
      }
      if (wvec) {  // N % 4 == 0 and W 16-byte aligned: 4 columns a copy
#pragma unroll
        for (int i = 0; i < WD_BK * (BN / 4) / WD_THREADS; ++i) {
          const int p = tid + i * WD_THREADS;
          const int kk = p / (BN / 4), c = 4 * (p % (BN / 4)), k = k0 + kk, col = col0 + c;
          const bool in = k < K && col < N;
          cp_async16(wr + kk * WP + c, in ? w + (long long)k * N + col : w, in ? 16 : 0);
        }
      } else {
        for (int p = tid; p < WD_BK * BN; p += WD_THREADS) {
          const int kk = p / BN, c = p % BN, k = k0 + kk, col = col0 + c;
          const bool in = k < K && col < N;
          cp_async4(wr + kk * WP + c, in ? w + (long long)k * N + col : w, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  // step u's raw slot -> planes buffer u & 1: W [k][n] f32 into three planes
  // [n][k] of bf16 pairs along k (and f32 x [r][k] into three planes [r][k]);
  // a warp takes 8 columns (rows) x 4 k pairs: conflict-free reads and writes
  auto convert = [&](long long u) {
    if (u >= steps) return;
    const unsigned char* src = wd_smem + (int)(u % WD_STAGES) * Tile::RAW;
    unsigned* xl = reinterpret_cast<unsigned*>(planes + (int)(u & 1) * Tile::PL);
    unsigned* wl = xl + Tile::XL / 4;
    const float* wr = reinterpret_cast<const float*>(src + Tile::X_RAW);
#pragma unroll
    for (int i = 0; i < (WD_BK / 2) * BN / WD_THREADS; ++i) {
      const int grp = (tid + i * WD_THREADS) >> 5;
      const int c = (grp % (BN / 8)) * 8 + (lane & 7);
      const int kp = (grp / (BN / 8)) * 4 + (lane >> 3);
      float a0, a1, a2, b0, b1, b2;
      split3(wr[(2 * kp) * WP + c], a0, a1, a2);
      split3(wr[(2 * kp + 1) * WP + c], b0, b1, b2);
      wl[0 * BN * WD_LPW + c * WD_LPW + kp] = pack_bf16(a0, b0);
      wl[1 * BN * WD_LPW + c * WD_LPW + kp] = pack_bf16(a1, b1);
      wl[2 * BN * WD_LPW + c * WD_LPW + kp] = pack_bf16(a2, b2);
    }
    if constexpr (!XBF) {
      const float* xr = reinterpret_cast<const float*>(src);
#pragma unroll
      for (int i = 0; i < (WD_BK / 2) * BM / WD_THREADS; ++i) {
        const int grp = (tid + i * WD_THREADS) >> 5;
        const int r = (grp % (BM / 8)) * 8 + (lane & 7);
        const int kp = (grp / (BM / 8)) * 4 + (lane >> 3);
        float a0, a1, a2, b0, b1, b2;
        split3(xr[r * XP + 2 * kp], a0, a1, a2);
        split3(xr[r * XP + 2 * kp + 1], b0, b1, b2);
        xl[0 * BM * WD_LPW + r * WD_LPW + kp] = pack_bf16(a0, b0);
        xl[1 * BM * WD_LPW + r * WD_LPW + kp] = pack_bf16(a1, b1);
        xl[2 * BM * WD_LPW + r * WD_LPW + kp] = pack_bf16(a2, b2);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int s = 0; s < WD_STAGES - 1; ++s) issue(s);
  cp_async_wait<WD_STAGES - 2>();  // step 0 landed for this thread
  __syncthreads();
  convert(0);
  // one barrier a step: step s's planes (converted last step) and step s +
  // 1's raw slot are complete; the mma of step s runs on the tensor cores
  // while the warp goes on to convert step s + 1 into the other planes
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<WD_STAGES - 3>();  // step s + 1 landed for this thread
    __syncthreads();
    issue(s + WD_STAGES - 1);  // into the slot of step s - 1, read by now
    const unsigned* xa =  // bf16 x: the raw slot is limb plane 0 (same pitch)
        XBF ? reinterpret_cast<const unsigned*>(wd_smem + (int)(s % WD_STAGES) * Tile::RAW)
            : reinterpret_cast<const unsigned*>(planes + (int)(s & 1) * Tile::PL);
    const unsigned* wl =
        reinterpret_cast<const unsigned*>(planes + (int)(s & 1) * Tile::PL + Tile::XL);
#pragma unroll
    for (int ks = 0; ks < WD_BK / 16; ++ks) {
      const int kw = ks * 8;
      constexpr int XLIMBS = XBF ? 1 : 3;
      unsigned a[XLIMBS][MT][4], bq[3][NT][2];
#pragma unroll
      for (int l = 0; l < XLIMBS; ++l)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned* base = xa + l * BM * WD_LPW + (wm * 16 * MT + 16 * mt + g) * WD_LPW + kw + t;
          a[l][mt][0] = base[0];
          a[l][mt][1] = base[8 * WD_LPW];
          a[l][mt][2] = base[4];
          a[l][mt][3] = base[8 * WD_LPW + 4];
        }
#pragma unroll
      for (int l = 0; l < 3; ++l)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned* base = wl + l * BN * WD_LPW + (wn * 8 * NT + 8 * nt + g) * WD_LPW + kw + t;
          bq[l][nt][0] = base[0];
          bq[l][nt][1] = base[4];
        }
      constexpr int NPASS = XBF ? 3 : 6;
#pragma unroll
      for (int pp = 0; pp < NPASS; ++pp) {
        const int li = XBF ? 0 : pass_x_limb(pp), lw = XBF ? 2 - pp : pass_w_limb(pp);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a[li][mt], bq[lw][nt]);
      }
    }
    convert(s + 1);
    if (s % nk == nk - 1) {
      // the tile's outputs through the epilogue, stored from the
      // fragments: a lane's two columns as one 8-byte store, so a warp's
      // store fills whole 32-byte sectors of 8 rows
      long long row0;
      int col0;
      tile_of(s, row0, col0);
      if constexpr (LAYER) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long row = row0 + wm * 16 * MT + 16 * mt + g + 8 * h;
              const int col = col0 + wn * 8 * NT + 8 * nt + 2 * t;
              float v[2] = {acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]};
              acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
              if (row >= M) continue;
#pragma unroll
              for (int u = 0; u < 2; ++u)
                if (col + u < N) {
                  if (!finite_f(v[u])) v[u] = exact_dot(x, w, row, col + u, K, N);
                  v[u] = __fadd_rn(v[u], lb[col + u]);
                  v[u] = layer_act(v[u], lact);
                }
              if (ovec && col + 1 < N) {  // N even: the pair is all in or all out
                *reinterpret_cast<float2*>(out + row * N + col) = float2{v[0], v[1]};
              } else {
#pragma unroll
                for (int u = 0; u < 2; ++u)
                  if (col + u < N) out[row * N + col + u] = v[u];
              }
            }
      } else {
        // a lane's outputs as v [2 MT][2 NT]: row 2 mt + h, column 2 nt + u
        float v[2 * MT][2 * NT];
        const EpiCols cols{col0 + wn * 8 * NT + 2 * t, 8};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                float p = acc[mt][nt][2 * h + u];
                if (!finite_f(p)) {  // the row only here: no row held through the epilogue
                  const long long row = row0 + wm * 16 * MT + 16 * mt + g + 8 * h;
                  if (row < M && cols(2 * nt + u) < N)
                    p = exact_dot(x, w, row, cols(2 * nt + u), K, N);
                }
                v[2 * mt + h][2 * nt + u] = p;
              }
        epi_tile<2 * MT, 2 * NT>(epi, v, cols, N);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long row = row0 + wm * 16 * MT + 16 * mt + g + 8 * h;
              const int col = cols(2 * nt);
              if (row >= M) continue;
              if (ovec && col + 1 < N) {  // N even: the pair is all in or all out
                *reinterpret_cast<float2*>(out + row * N + col) =
                    float2{v[2 * mt + h][2 * nt], v[2 * mt + h][2 * nt + 1]};
              } else {
#pragma unroll
                for (int u = 0; u < 2; ++u)
                  if (col + u < N) out[row * N + col + u] = v[2 * mt + h][2 * nt + u];
              }
            }
        // zeroed only now: v takes acc's registers through the epilogue
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ softmax
constexpr int SM_THREADS = 128;
constexpr int SM_SMALL_N = 32;     // N <= this: a block's run of 128 rows in shared memory
constexpr int SM_WARP_N = 32 * 32;  // N <= this: a warp a row, in registers

__global__ void __launch_bounds__(SM_THREADS)
softmax_rows_kernel(const float* h, long long M, int N, int vec, float* out) {
  extern __shared__ __align__(16) float sm_run[];  // [SM_THREADS * N]
  const long long row0 = (long long)blockIdx.x * SM_THREADS;
  const int rows = (int)min((long long)SM_THREADS, M - row0);
  const int count = rows * N;
  const float* src = h + row0 * N;
  float* dst = out + row0 * N;
  const int nv = vec ? count / 4 : 0;  // 128 N floats a block: 16-byte aligned runs
  for (int i = threadIdx.x; i < nv; i += SM_THREADS)
    reinterpret_cast<float4*>(sm_run)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = nv * 4 + threadIdx.x; i < count; i += SM_THREADS) sm_run[i] = src[i];
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    float* row = sm_run + r * N;
    const int c0 = r % N;
    float m = -INFINITY;
    for (int j = 0, c = c0; j < N; ++j, c = c + 1 == N ? 0 : c + 1) m = fmaxf(m, row[c]);
    float s = 0.f;
    for (int j = 0, c = c0; j < N; ++j, c = c + 1 == N ? 0 : c + 1) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    for (int j = 0, c = c0; j < N; ++j, c = c + 1 == N ? 0 : c + 1) row[c] = row[c] / s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nv; i += SM_THREADS)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(sm_run)[i];
  for (int i = nv * 4 + threadIdx.x; i < count; i += SM_THREADS) dst[i] = sm_run[i];
}

// a warp a row; lane l holds columns l + 32 j, or (vec) the float4 at 4 (l + 32 j)
template <int VPL>
__global__ void __launch_bounds__(SM_THREADS)
softmax_warp_kernel(const float* h, long long M, int N, int vec, float* out) {
  constexpr int V4 = VPL / 4;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (SM_THREADS / 32) + (threadIdx.x >> 5);
  const bool live = row < M;  // every lane of every warp reaches the shuffles
  const float* src = h + (live ? row : 0) * N;
  float* dst = out + (live ? row : 0) * N;
  float v[VPL];
  bool in[VPL];
  if (V4 > 0 && vec) {
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      const int c = 4 * (lane + 32 * j);
      const bool ok = live && c < N;  // N % 4 == 0: the float4 is all in or all out
      const float4 q = ok ? *reinterpret_cast<const float4*>(src + c) : float4{0.f, 0.f, 0.f, 0.f};
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) in[4 * j + i] = ok;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      in[j] = live && c < N;
      v[j] = in[j] ? src[c] : 0.f;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    if (in[j]) m = fmaxf(m, v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    v[j] = in[j] ? expf(v[j] - m) : 0.f;
    s += v[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (V4 > 0 && vec) {
#pragma unroll
    for (int j = 0; j < V4; ++j)
      if (in[4 * j])
        *reinterpret_cast<float4*>(dst + 4 * (lane + 32 * j)) =
            float4{v[4 * j] / s, v[4 * j + 1] / s, v[4 * j + 2] / s, v[4 * j + 3] / s};
  } else {
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (in[j]) dst[lane + 32 * j] = v[j] / s;
  }
}

// N > SM_WARP_N: a warp a row, the row read three times
__global__ void __launch_bounds__(SM_THREADS)
softmax_long_kernel(const float* h, long long M, int N, float* out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (SM_THREADS / 32) + (threadIdx.x >> 5);
  const bool live = row < M;  // every lane of every warp reaches the shuffles
  const float* src = h + (live ? row : 0) * N;
  float* dst = out + (live ? row : 0) * N;
  float m = -INFINITY;
  if (live)
    for (int c = lane; c < N; c += 32) m = fmaxf(m, src[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  float s = 0.f;
  if (live)
    for (int c = lane; c < N; c += 32) {
      const float e = expf(src[c] - m);
      dst[c] = e;  // read back below by this lane only
      s += e;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (live)
    for (int c = lane; c < N; c += 32) dst[c] = dst[c] / s;
}

// ------------------------------------------------------------------ launchers
template <typename T, int NB>
int launch_skinny(const T* x, const float* w, const EpiProg& epi, long long M, int K, int N,
                  bool vec, float* out, cudaStream_t s) {
  constexpr int KC = RS_CHUNK / (int)sizeof(T);
  static std::atomic<unsigned> seen{0};
  const int fit = SK_W_BYTES / (NB * 4) / KC * KC;
  const int kchunk = (K + 15) / 16 * 16 <= fit ? K : fit;
  const int wp = (min(kchunk, K) + 15) / 16 * 16;
  if (int err = opt_in_smem(skinny_kernel<T, NB>, SkTile::RING + SK_W_BYTES, seen)) return err;
  const long long grid = min((long long)sm_count(), (M + 31) / 32);
  const long long per = (M + grid - 1) / grid;
  skinny_kernel<T, NB><<<(unsigned)grid, RS_THREADS, SkTile::RING + NB * wp * 4, s>>>(
      x, w, epi, M, K, N, per, (int)vec, kchunk, out);
  return (int)cudaGetLastError();
}

template <typename T, int NB, int R>
int launch_narrow(const T* x, const float* w, const EpiProg& epi, long long M, int K, int N,
                  float* out, cudaStream_t s) {
  using Tile = NarrowTile<R>;
  static std::atomic<unsigned> seen{0};
  if (int err = opt_in_smem(narrow_kernel<T, NB, R>, Tile::SMEM_MAX, seen)) return err;
  const size_t smem = (size_t)Tile::STAGES * Tile::STAGE_BYTES + (size_t)K * NB * sizeof(float);
  const long long tiles = (M + Tile::ROWS - 1) / Tile::ROWS;
  const unsigned grid = (unsigned)min(tiles, (long long)sm_count());
  narrow_kernel<T, NB, R><<<grid, NR_THREADS, smem, s>>>(x, w, epi, M, K, N, out);
  return (int)cudaGetLastError();
}

// R = 4 where W's reads from shared memory bound the path (NB >= 8 and a
// long row: K of 1 KB or more), else R = 2 (ML_FORCE_PATH 2 and 3 force 2
// and 4 at NB >= 8)
template <typename T, int NB>
int launch_narrow(const T* x, const float* w, const EpiProg& epi, long long M, int K, int N,
                  float* out, cudaStream_t s) {
  const bool long_rows = (long long)K * sizeof(T) >= 1024;
  if (NB >= 8 && (ML_FORCE_PATH == 0 ? long_rows : ML_FORCE_PATH == 3))
    return launch_narrow<T, NB, NB >= 8 ? 4 : 2>(x, w, epi, M, K, N, out, s);
  return launch_narrow<T, NB, 2>(x, w, epi, M, K, N, out, s);
}

template <typename T, int MT, int NT, bool LAYER>
int launch_wide(const T* x, const float* w, const EpiProg& epi, const EpiLayer& layer,
                long long M, int K, int N, bool vec, float* out, cudaStream_t s) {
  using Tile = WideTile<T, MT, NT>;
  static std::atomic<unsigned> seen{0};
  if (int err = opt_in_smem(wide_kernel<T, MT, NT, LAYER>, Tile::SMEM, seen)) return err;
  const long long tiles = (M + Tile::BM - 1) / Tile::BM * ((N + Tile::BN - 1) / Tile::BN);
  const unsigned grid = (unsigned)min(tiles, (long long)sm_count());
  const int wvec = N % 4 == 0 && ((uintptr_t)w % 16) == 0;
  const int ovec = N % 2 == 0 && ((uintptr_t)out % 8) == 0;
  wide_kernel<T, MT, NT, LAYER><<<grid, WD_THREADS, Tile::SMEM, s>>>(
      x, w, epi, layer.b, layer.act, M, K, N, (int)vec, wvec, ovec, out);
  return (int)cudaGetLastError();
}

template <typename T, int MT, int NT>
int launch_wide(const T* x, const float* w, const EpiProg& epi, long long M, int K, int N,
                bool vec, float* out, cudaStream_t s) {
  EpiLayer layer;
  if (epi_layer(epi, layer))
    return launch_wide<T, MT, NT, true>(x, w, epi, layer, M, K, N, vec, out, s);
  return launch_wide<T, MT, NT, false>(x, w, epi, layer, M, K, N, vec, out, s);
}

// W's row width in the narrow path: N rounded up to 2, 4, 8, 12 or 16
constexpr int narrow_nb(int n) { return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : 16; }

template <typename T>
int linear_dispatch(const T* x, const float* w, const EpiProg& e, long long M, int K, int N,
                    float* out, cudaStream_t s) {
  constexpr int E = 16 / (int)sizeof(T);
  const bool vec = K % E == 0 && ((uintptr_t)x % 16) == 0;
  if (N > 16) {  // column tiles of 128, or of 64 where that pads N less
    if ((N + 63) / 64 * 64 < (N + 127) / 128 * 128)
      return launch_wide<T, sizeof(T) == 2 ? 4 : 2, 2>(x, w, e, M, K, N, vec, out, s);
    return launch_wide<T, sizeof(T) == 2 ? 4 : 1, 4>(x, w, e, M, K, N, vec, out, s);
  }
  // narrow where it runs, but N = 2 over rows of 1 KB or more on the skinny
  // path (the rule in the header), unless ML_FORCE_PATH says otherwise
  const bool narrow_runs = N >= 2 && vec && (long long)K * narrow_nb(N) * 4 <= NR_W_MAX;
  const bool narrow = ML_FORCE_PATH == 0
                          ? narrow_runs && !(N <= 2 && (long long)K * sizeof(T) >= 1024)
                          : ML_FORCE_PATH >= 2 && narrow_runs;
  if (narrow) {
    switch (narrow_nb(N)) {
      case 2: return launch_narrow<T, 2>(x, w, e, M, K, N, out, s);
      case 4: return launch_narrow<T, 4>(x, w, e, M, K, N, out, s);
      case 8: return launch_narrow<T, 8>(x, w, e, M, K, N, out, s);
      case 12: return launch_narrow<T, 12>(x, w, e, M, K, N, out, s);
      default: return launch_narrow<T, 16>(x, w, e, M, K, N, out, s);
    }
  }
  if (N <= 1) return launch_skinny<T, 1>(x, w, e, M, K, N, vec, out, s);
  if (N <= 2) return launch_skinny<T, 2>(x, w, e, M, K, N, vec, out, s);
  if (N <= 4) return launch_skinny<T, 4>(x, w, e, M, K, N, vec, out, s);
  if (N <= 8) return launch_skinny<T, 8>(x, w, e, M, K, N, vec, out, s);
  return launch_skinny<T, 16>(x, w, e, M, K, N, vec, out, s);
}

}  // namespace

extern "C" {

// K10 linear layer (and K16's products). x [M, K] row-major, f32 (x_bf16 =
// 0) or bf16 (x_bf16 = 1); w [K, N] row-major f32; epi host memory laid out
// as EpiProg (ewise.cuh; at most 8 instructions, each operand [N] f32 or
// one value); out [M, N] f32 (never aliasing x). M = 0 launches nothing.
int ml_linear(const void* x, int x_bf16, const void* w, long long M, int K, int N,
              const void* epi, void* out, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || epi == nullptr) return (int)cudaErrorInvalidValue;
  const EpiProg e = *static_cast<const EpiProg*>(epi);
  if (!epi_valid(e)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return linear_dispatch<__nv_bfloat16>((const __nv_bfloat16*)x, (const float*)w, e, M, K, N,
                                          (float*)out, s);
  return linear_dispatch<float>((const float*)x, (const float*)w, e, M, K, N, (float*)out, s);
}

// K10 softmax over the last axis: h [M, N] f32 -> out [M, N] f32; out may
// be h (in place). M = 0 launches nothing.
int ml_softmax(const void* h, long long M, int N, void* out, void* stream) {
  if (M < 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* hf = (const float*)h;
  float* of = (float*)out;
  const bool aligned = ((uintptr_t)h % 16) == 0 && ((uintptr_t)out % 16) == 0;
  if (N <= SM_SMALL_N) {
    const unsigned grid = (unsigned)((M + SM_THREADS - 1) / SM_THREADS);
    softmax_rows_kernel<<<grid, SM_THREADS, (size_t)SM_THREADS * N * sizeof(float), s>>>(
        hf, M, N, (int)aligned, of);
    return (int)cudaGetLastError();
  }
  const unsigned grid = (unsigned)((M + SM_THREADS / 32 - 1) / (SM_THREADS / 32));
  const int vec = (int)(aligned && N % 4 == 0);
  if (N <= 64) softmax_warp_kernel<2><<<grid, SM_THREADS, 0, s>>>(hf, M, N, vec, of);
  else if (N <= 128) softmax_warp_kernel<4><<<grid, SM_THREADS, 0, s>>>(hf, M, N, vec, of);
  else if (N <= 256) softmax_warp_kernel<8><<<grid, SM_THREADS, 0, s>>>(hf, M, N, vec, of);
  else if (N <= 512) softmax_warp_kernel<16><<<grid, SM_THREADS, 0, s>>>(hf, M, N, vec, of);
  else if (N <= SM_WARP_N) softmax_warp_kernel<32><<<grid, SM_THREADS, 0, s>>>(hf, M, N, vec, of);
  else softmax_long_kernel<<<grid, SM_THREADS, 0, s>>>(hf, M, N, of);
  return (int)cudaGetLastError();
}

}  // extern "C"
