// Ordered compaction across the blocks of one launch, in one pass (decoupled
// look-back, after Merrill and Garland's single-pass prefix scan), shared by
// the BM25 match (K9, bm25.cu), the graph chain's bitmap compaction (K6,
// graph.cu) and the frontier dedup's (K15, mesh.cu). Each block takes a tile
// from a ticket, so tiles start in order and a block waits only on tiles
// that are already running; it publishes its tile's count (an aggregate),
// sums its predecessors' counts back to the first inclusive prefix it meets
// (a warp reads 32 flags at a time), and publishes its own inclusive prefix.
//
// State: unsigned long long [2 + tiles]: [0] the ticket, [1] the blocks
// finished, [2 + t] tile t's flag, (status << 32) | value with status 1 an
// aggregate and 2 an inclusive prefix (values below 2^32). It is zero before
// a launch, and the last block to finish leaves it zero again, so a caller
// keeps one zeroed buffer and clears it only after a failed launch.
// Include after <cuda_runtime.h>.
#pragma once

namespace {

constexpr unsigned long long LB_AGGREGATE = 1ull << 32;
constexpr unsigned long long LB_PREFIX = 2ull << 32;

// a flag as the other blocks last published it (a volatile load, served by
// L2: no read-modify-write, so polling blocks do not queue on one address)
__device__ __forceinline__ unsigned long long lb_peek(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// inclusive prefix of v over a block of NT threads (NT a multiple of 32, at
// most 1024); *total gets the block's sum. Every thread calls it.
template <int NT>
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* total) {
  __shared__ unsigned wtot[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  unsigned before = 0, all = 0;
  for (int i = 0; i < NT / 32; ++i) {
    if (i < warp) before += wtot[i];
    all += wtot[i];
  }
  __syncthreads();  // wtot is free for the next call
  *total = all;
  return v + before;
}

// The tile this block works on: tiles are handed out in the order blocks
// start. Every thread calls it.
__device__ __forceinline__ int lb_tile(unsigned long long* state) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = (int)atomicAdd(&state[0], 1ull);
  __syncthreads();
  return tile;
}

// The number of items in the tiles before `tile`, given this tile's count
// (the same value in every thread). Every thread calls it. The first warp
// looks back 32 tiles at a time: it waits until the 32 flags are
// published, adds the values up to the nearest inclusive prefix, and goes
// on past them only if there is none (tiles before 0 read as a prefix 0).
__device__ __forceinline__ unsigned long long lb_offset(unsigned long long* state, int tile,
                                                       unsigned count) {
  __shared__ unsigned long long before;
  if (threadIdx.x < 32) {
    unsigned long long* flags = state + 2;
    const int lane = threadIdx.x;
    if (lane == 0 && tile > 0) atomicExch(&flags[tile], LB_AGGREGATE | count);
    unsigned long long sum = 0;
    for (int base = tile - 1; base >= 0; base -= 32) {
      const int p = base - lane;  // lane 0 the nearest predecessor
      unsigned long long f = p >= 0 ? lb_peek(&flags[p]) : LB_PREFIX;
      while (__ballot_sync(0xffffffffu, (f >> 32) == 0) != 0u)
        if ((f >> 32) == 0) f = lb_peek(&flags[p]);
      const unsigned pre = __ballot_sync(0xffffffffu, (f >> 32) == 2);
      const int stop = pre != 0u ? __ffs((int)pre) - 1 : 31;
      unsigned long long v = lane <= stop ? (f & 0xffffffffull) : 0ull;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      sum += v;
      if (pre != 0u) break;
    }
    if (lane == 0) {
      atomicExch(&flags[tile], LB_PREFIX | (sum + count));
      before = sum;
    }
  }
  __syncthreads();
  return before;
}

// Called by every thread after its block's last write. The last block of the
// launch to finish writes the grand total to *total (when given) and zeroes
// the state for the next launch.
__device__ __forceinline__ void lb_finish(unsigned long long* state, int tiles,
                                          unsigned* total) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&state[1], 1ull) == (unsigned long long)(tiles - 1);
  __syncthreads();
  if (!last) return;  // the whole block
  if (threadIdx.x == 0 && total != nullptr)
    *total = (unsigned)(lb_peek(&state[2 + tiles - 1]) & 0xffffffffull);
  __syncthreads();
  for (int i = threadIdx.x; i < tiles + 2; i += blockDim.x) state[i] = 0ull;
}

}  // namespace
