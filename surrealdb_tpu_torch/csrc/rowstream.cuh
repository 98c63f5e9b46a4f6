// The row-streaming core shared by the exact kNN kernels' CUDA-core tier
// (knn.cu: K1's and K2's distances at Q <= 8, and at Q > 8 where the tensor
// cores do not serve) and K10's skinny linear path (ml.cu): a row of x
// meets a few vectors held in shared memory (the queries, or W's columns),
// one f32 FMA chain a (row, vector), and the read of x bounds it.
//
// Design: a thread owns R rows of a tile of RS_THREADS * R consecutive rows
// (thread t: rows t, t + RS_THREADS, ...; a warp's lanes hold 32
// consecutive rows), so every vector value a step reads is one
// shared-memory broadcast for the warp. Each step stages RS_CHUNK bytes of
// every row of the tile by 16-byte cp.async (the L2::256B hint makes DRAM
// see whole bursts of a row) into a ring of STAGES stages, rows RS_PITCH
// bytes apart so a quarter warp's 16-byte reads hit 32 banks; STAGES - 1
// steps stay in flight while a step is computed, across tile ends too. One
// barrier a step. A block walks its own contiguous range of rows [rb, re),
// so a launch of SMs x BPS blocks gives every block the same rows (no tail
// of tiles). Rows that are not 16-byte aligned (a D * sizeof(T) that is not
// a multiple of 16, or an offset base) are staged with plain loads into the
// same layout. The vectors sit in shared memory as f32 [n][pitch]; where
// they do not fit they are staged again in column chunks as the steps
// reach them.
//
// The caller's Body does the arithmetic:
//   stage(c0, clen)    all threads: vector columns [c0, c0 + clen) into
//                      shared memory, local column 0 = c0;
//   start(i, row)      before row i's first step;
//   step(v, n, lc)     n (<= E) values v[i] of each row i at local column lc;
//   finish(row0)       all threads, after the tile's last step: the
//                      thread's rows are row0 + i RS_THREADS + tid (i < R;
//                      a row may be >= re).
// Include after <cuda_runtime.h>, <cuda_bf16.h> and mma.cuh.
#pragma once

namespace {

constexpr int RS_THREADS = 256;
constexpr int RS_CHUNK = 64;             // bytes of a row a step
constexpr int RS_PITCH = RS_CHUNK + 16;  // bytes of a staged row

template <int R, int STAGES>
struct RowTile {
  static constexpr int ROWS = RS_THREADS * R;  // rows a tile
  static constexpr int STAGE_BYTES = ROWS * RS_PITCH;
  static constexpr int RING = STAGES * STAGE_BYTES;
};

// 16 bytes as floats: 4 f32 or 8 bf16 (upcast exactly)
__device__ __forceinline__ void rs_unpack(const unsigned char* p, float* v, float) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void rs_unpack(const unsigned char* p, float* v, __nv_bfloat16) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// x [N, D] with rows ld elements apart (ld = D, or a feature shard's
// view of wider rows); the block's rows [rb, re); vchunk: the vector
// columns staged at a time (a multiple of RS_CHUNK / sizeof(T), or >= D:
// staged once); vec: 16-byte cp.async (x, D * sizeof(T) and ld *
// sizeof(T) 16-byte aligned)
template <typename T, int R, int STAGES, class Body>
__device__ __forceinline__ void row_stream(const T* __restrict__ x, long long rb, long long re,
                                           int D, long long ld, int vec, int vchunk,
                                           unsigned char* xs, Body& body) {
  constexpr int E = 16 / (int)sizeof(T);          // values a 16-byte piece
  constexpr int KC = RS_CHUNK / (int)sizeof(T);   // columns a step
  constexpr int PIECES = RS_CHUNK / 16;
  using Tile = RowTile<R, STAGES>;
  constexpr int ROWS = Tile::ROWS;
  const int tid = threadIdx.x;
  const int nch = (D + KC - 1) / KC;
  const long long tiles = re > rb ? (re - rb + ROWS - 1) / ROWS : 0;
  const long long steps = tiles * nch;
  if (vchunk >= D) {
    body.stage(0, D);
    __syncthreads();
  }
  // step s (tile s / nch, columns (s % nch) * KC ..) into stage s % STAGES
  auto issue = [&](long long s) {
    if (s < steps) {
      const long long row0 = rb + (s / nch) * ROWS;
      const int k0 = (int)(s % nch) * KC;
      unsigned char* st = xs + (int)(s % STAGES) * Tile::STAGE_BYTES;
      if (vec) {  // D * sizeof(T) % 16 == 0: a piece is all in or all out
#pragma unroll
        for (int i = 0; i < ROWS * PIECES / RS_THREADS; ++i) {
          const int p = tid + i * RS_THREADS, r = p / PIECES, q = p % PIECES;
          const long long row = row0 + r;
          const int k = k0 + q * E;
          const bool in = row < re && k < D;
          cp_async16(st + r * RS_PITCH + q * 16, in ? x + row * ld + k : x, in ? 16 : 0);
        }
      } else {
        for (int p = tid; p < ROWS * KC; p += RS_THREADS) {
          const int r = p / KC, kk = p % KC, k = k0 + kk;
          const long long row = row0 + r;
          reinterpret_cast<T*>(st + r * RS_PITCH)[kk] = (row < re && k < D) ? x[row * ld + k] : T{};
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed for every thread; step s - 1 is no longer read
    issue(s + STAGES - 1);
    const int ch = (int)(s % nch), k0 = ch * KC;
    const long long row0 = rb + (s / nch) * ROWS;
    if (vchunk < D && k0 % vchunk == 0) {  // the next chunk of the vectors
      body.stage(k0, min(vchunk, D - k0));
      __syncthreads();
    }
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) body.start(i, row0 + i * RS_THREADS + tid);
    }
    const unsigned char* cur = xs + (int)(s % STAGES) * Tile::STAGE_BYTES;
    const int lc0 = vchunk < D ? k0 % vchunk : k0;
#pragma unroll
    for (int q = 0; q < PIECES; ++q) {
      const int n = min(E, D - (k0 + q * E));
      if (n <= 0) break;  // uniform: the row's end
      float v[R][E];
#pragma unroll
      for (int i = 0; i < R; ++i) rs_unpack(cur + (tid + i * RS_THREADS) * RS_PITCH + q * 16, v[i], T{});
      body.step(v, n, lc0 + q * E);
    }
    if (ch == nch - 1) body.finish(row0);
  }
  cp_async_wait<0>();
}

}  // namespace
