// Ordered stream compaction shared by the graph chain (K6, graph.cu) and the
// frontier dedup (K15, mesh.cu): the ids v in [0, n) with (int)dense[v] > 0,
// in ascending order, written to present[0, out_size) with their dense value
// cast to the count type, truncated at out_size; the caller fills the tail
// first (compact_fill). Three launches: compact_count (present ids a chunk
// of CP_CHUNK), compact_scan (exclusive prefix of the chunk counts, one
// block) and compact_write (each thread writes its CP_PER ids at its rank).
// Blocks of CP_THREADS. Include after <cuda_runtime.h>.
#pragma once

namespace {

constexpr int CP_THREADS = 256;
constexpr int CP_PER = 8;                      // dense entries a thread
constexpr int CP_CHUNK = CP_THREADS * CP_PER;  // dense entries a block

// a grid of CP_THREADS-thread blocks covering `work` items, grid-stride above
// 65,536 blocks
unsigned grid_for(long long work) {
  long long g = (work + CP_THREADS - 1) / CP_THREADS;
  if (g < 1) g = 1;
  return (unsigned)(g < 65536 ? g : 65536);
}

long long compact_blocks(long long n) { return (n + CP_CHUNK - 1) / CP_CHUNK; }

__device__ __forceinline__ bool present_at(const unsigned* dense, long long v, long long n) {
  return v < n && (int)dense[v] > 0;  // the reference's signed `dense > 0`
}

// blk[c] = number of present ids in chunk c of [0, n)
__global__ void __launch_bounds__(CP_THREADS) compact_count(const unsigned* dense, long long n,
                                                            int* blk) {
  __shared__ int wsum[CP_THREADS / 32];
  const long long base = (long long)blockIdx.x * CP_CHUNK;
  int cnt = 0;
  for (int i = 0; i < CP_PER; ++i) cnt += present_at(dense, base + i * CP_THREADS + threadIdx.x, n);
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int i = 0; i < CP_THREADS / 32; ++i) t += wsum[i];
    blk[blockIdx.x] = t;
  }
}

// inclusive prefix of v over the block; *total gets the block's sum
__device__ __forceinline__ int block_inclusive_scan(int v, int* total) {
  __shared__ int wtot[CP_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < CP_THREADS / 32; ++i) {
    if (i < warp) before += wtot[i];
    all += wtot[i];
  }
  __syncthreads();  // wtot is reused by the next call
  *total = all;
  return v + before;
}

// exclusive prefix sum of blk[0, nb) in place, one block
__global__ void __launch_bounds__(CP_THREADS) compact_scan(int* blk, int nb) {
  int carry = 0;
  for (int base = 0; base < nb; base += CP_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? blk[i] : 0;
    int total;
    const int incl = block_inclusive_scan(v, &total);
    if (i < nb) blk[i] = carry + incl - v;
    carry += total;
  }
}

// present[0, out_size) = fill, counts[...] = 0: the tail past the last id
template <class C>
__global__ void __launch_bounds__(CP_THREADS) compact_fill(int* present, C* counts, int out_size,
                                                           int fill) {
  for (long long i = (long long)blockIdx.x * CP_THREADS + threadIdx.x; i < out_size;
       i += (long long)gridDim.x * CP_THREADS) {
    present[i] = fill;
    counts[i] = (C)0;
  }
}

// present[off + rank] = v, counts[...] = (C)dense[v] for the present ids of
// this block's chunk, in ascending order, dropped past out_size. A thread
// owns CP_PER consecutive ids; ranks come from a block scan of its count.
template <class C>
__global__ void __launch_bounds__(CP_THREADS) compact_write(const unsigned* dense, long long n,
                                                            const int* blk_off, int out_size,
                                                            int* present, C* counts) {
  const int off0 = blk_off[blockIdx.x];
  if (off0 >= out_size) return;  // the whole block: every id here ranks past out_size
  const long long base = (long long)blockIdx.x * CP_CHUNK + (long long)threadIdx.x * CP_PER;
  int cnt = 0;
  for (int i = 0; i < CP_PER; ++i) cnt += present_at(dense, base + i, n);
  int total;
  int pos = off0 + block_inclusive_scan(cnt, &total) - cnt;
  for (int i = 0; i < CP_PER && pos < out_size; ++i) {
    const long long v = base + i;
    if (present_at(dense, v, n)) {
      present[pos] = (int)v;
      counts[pos] = (C)dense[v];
      ++pos;
    }
  }
}

// the three compaction launches over dense[0, n) on stream s (blk: a
// compact_blocks(n) int32 scratch); the caller has run compact_fill
template <class C>
cudaError_t compact_run(const unsigned* dense, long long n, int* blk, int out_size, int* present,
                        C* counts, cudaStream_t s) {
  const long long nb = compact_blocks(n);
  if (nb <= 0) return cudaSuccess;
  cudaError_t e;
  compact_count<<<(unsigned)nb, CP_THREADS, 0, s>>>(dense, n, blk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  compact_scan<<<1, CP_THREADS, 0, s>>>(blk, (int)nb);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  compact_write<C><<<(unsigned)nb, CP_THREADS, 0, s>>>(dense, n, blk, out_size, present, counts);
  return cudaGetLastError();
}

}  // namespace
