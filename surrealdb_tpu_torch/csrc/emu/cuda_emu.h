// CPU emulation of the CUDA subset that csrc/*.cu use, for rehearsing
// the kernels' logic on a machine without a card or nvcc
// (tests/test_torch_kernel_emulation.py). One OS thread per CUDA thread;
// blocks run one after another, so a kernel's `__shared__` arrays become
// function statics; __syncthreads and every warp intrinsic are barriers
// (the kernels call them with all 32 lanes, as the full masks say). A
// `k<<<grid, block, smem, stream>>>(args)` launch is rewritten to
// emu_launch(grid, block, smem, stream, [&]{ k(args); }). It checks logic
// (indexing, barriers, ties, masks), never speed or the hardware's limits.
//
// Built with -DEMU_CONCURRENT (and the sources' `__shared__` declarations
// rewritten to emu_smem / emu_dyn_smem, a block's own), every block of a
// launch runs at once instead, and the later blocks run ahead (see
// emu_launch there): what one block waits for in another's writes, as
// lookback.cuh's look-back does, is then really waited for.
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <algorithm>
#include <array>
#include <functional>
#include <thread>
#include <vector>
#include <memory>
#include <map>
#include <mutex>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a) : x(a) {} };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef struct CUstream_st* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1, cudaMemcpyDeviceToHost = 2 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// a small card: persistent grids walk several tiles a block
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { std::memset(p, v, n); return 0; }
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n, cudaMemcpyKind, cudaStream_t) { std::memcpy(d, s, n); return 0; }
inline cudaError_t cudaStreamSynchronize(cudaStream_t) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
struct __nv_bfloat16 { unsigned short v; };
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(((unsigned)b.v) << 16); }
// IEEE single-precision steps, rounded each on its own (the host compiler
// contracts nothing under -std=c++20)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int2 { int x, y; };
struct alignas(16) int4 { int x, y, z, w; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_add(v); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
inline unsigned atomicOr(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_or(v); }
// look-back flags and tickets (csrc/lookback.cuh)
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline unsigned long long atomicExch(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).exchange(v);
}
inline unsigned long long atomicMin(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p);
  unsigned long long o = a.load();
  while (v < o && !a.compare_exchange_weak(o, v)) {}
  return o;
}

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block_bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<unsigned long long> xchg;  // [threads]
  std::vector<std::array<unsigned, 6>> frag;  // [threads]: a lane's mma fragments (A 4, B 2)
  std::atomic<int> count[2] = {0, 0};  // __syncthreads_count's two slots, used in turn
#ifdef EMU_CONCURRENT
  std::mutex smem_mu;
  std::map<const void*, std::unique_ptr<unsigned char[]>> smem;  // by declaration
  std::atomic<bool> go{false};        // the block may start
  std::atomic<bool>* next = nullptr;  // the next block's `go`
  unsigned lag_ms = 0;                // each __syncthreads after the first waits this first
#endif
};
#ifdef EMU_CONCURRENT
#ifndef EMU_STEP_MS
#define EMU_STEP_MS 25
#endif
inline thread_local EmuBlock* g_blk = nullptr;
inline thread_local unsigned emu_syncs = 0;
// A block's `__shared__` declaration number ID, of type T.
template <class T, int ID> T& emu_smem() {
  static const char tag = 0;
  std::lock_guard<std::mutex> lock(g_blk->smem_mu);
  auto& p = g_blk->smem[&tag];
  if (!p) p.reset(new unsigned char[sizeof(T)]());
  return *reinterpret_cast<T*>(p.get());
}
// A block's dynamic shared memory (`extern __shared__ T name[]`).
template <class T> T* emu_dyn_smem() {
  static const char tag = 0;
  std::lock_guard<std::mutex> lock(g_blk->smem_mu);
  auto& p = g_blk->smem[&tag];
  if (!p) p.reset(new unsigned char[1 << 21]());
  return reinterpret_cast<T*>(p.get());
}
inline void __syncthreads() {
  if (emu_syncs++ > 0 && threadIdx.x == 0 && g_blk->lag_ms > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(g_blk->lag_ms));
  g_blk->block_bar->arrive_and_wait();
  if (threadIdx.x == 0 && g_blk->next != nullptr) g_blk->next->store(true);
}
#else
inline EmuBlock* g_blk = nullptr;
inline void __syncthreads() { g_blk->block_bar->arrive_and_wait(); }
#endif
// the block's count of threads passing a non-zero p: the two slots in turn,
// thread 0 zeroing a slot after the second barrier, before it can reach the
// slot's next use (two calls later)
inline thread_local unsigned emu_count_turn = 0;
inline int __syncthreads_count(int p) {
  auto& c = g_blk->count[emu_count_turn++ & 1];
  if (p) c.fetch_add(1);
  g_blk->block_bar->arrive_and_wait();
  const int r = c.load();
  g_blk->block_bar->arrive_and_wait();
  if (threadIdx.x == 0) c.store(0);
  return r;
}
inline unsigned lane_id() { return threadIdx.x & 31; }
inline unsigned warp_id() { return threadIdx.x >> 5; }
inline void __syncwarp(unsigned = 0xffffffffu) { g_blk->warp_bar[warp_id()]->arrive_and_wait(); }
template <class F> auto warp_exchange(unsigned long long mine, F f) {
  auto& bar = *g_blk->warp_bar[warp_id()];
  unsigned base = warp_id() * 32;
  g_blk->xchg[base + lane_id()] = mine;
  bar.arrive_and_wait();
  auto r = f(&g_blk->xchg[base]);
  bar.arrive_and_wait();
  return r;
}
inline unsigned __match_any_sync(unsigned, unsigned v) {
  return warp_exchange(v, [&](unsigned long long* w) {
    unsigned m = 0; for (int l = 0; l < 32; ++l) if ((unsigned)w[l] == v) m |= 1u << l; return m; });
}
inline unsigned __ballot_sync(unsigned, int p) {
  return warp_exchange(p ? 1 : 0, [&](unsigned long long* w) {
    unsigned m = 0; for (int l = 0; l < 32; ++l) if (w[l]) m |= 1u << l; return m; });
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  unsigned long long bits = 0; std::memcpy(&bits, &v, sizeof(T));
  return warp_exchange(bits, [&](unsigned long long* w) { T r; std::memcpy(&r, &w[src], sizeof(T)); return r; });
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d) {
  unsigned long long bits = 0; std::memcpy(&bits, &v, sizeof(T));
  return warp_exchange(bits, [&](unsigned long long* w) {
    T r; std::memcpy(&r, &w[lane_id() >= d ? lane_id() - d : lane_id()], sizeof(T)); return r; });
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  unsigned long long bits = 0; std::memcpy(&bits, &v, sizeof(T));
  return warp_exchange(bits, [&](unsigned long long* w) { T r; std::memcpy(&r, &w[lane_id() ^ o], sizeof(T)); return r; });
}
// cp.async: a synchronous copy; `bytes` (0 or the size) are read and the
// rest zero-filled, as the PTX src-size operand does. The kernels order
// their reads of a stage with __syncthreads, which covers this copy too.
inline void cp_async16(void* dst, const void* src, int bytes) {
  std::memcpy(dst, src, bytes);
  std::memset(static_cast<char*>(dst) + bytes, 0, 16 - bytes);
}
inline void cp_async4(void* dst, const void* src, int bytes) {
  std::memcpy(dst, src, bytes);
  std::memset(static_cast<char*>(dst) + bytes, 0, 4 - bytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on the PTX fragment
// layouts (g = lane / 4, t = lane % 4): A reg r holds row g + 8 (r & 1),
// columns 2t + 8 (r >> 1) + {0, 1} (low half first); B reg r holds rows
// 2t + 8 r + {0, 1} of column g; d [i] is row g + 8 (i >> 1), column
// 2t + (i & 1). The lanes swap fragments through one of the block's two
// per-warp buffers, in turn, after one warp barrier (a lane writes a
// buffer again only two calls later, past the next call's barrier, which
// every lane reaches after reading this one); each product of two bf16 is
// exact in f32 and d [i] adds the 16 of them in k order.
inline thread_local unsigned emu_mma_turn = 0;
inline void mma_bf16_16816(float* d, const unsigned* a, const unsigned* b) {
  auto& bar = *g_blk->warp_bar[warp_id()];
  const unsigned lane = lane_id();
  const unsigned base = (emu_mma_turn++ & 1) * blockDim.x + warp_id() * 32;
  g_blk->frag[base + lane] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  bar.arrive_and_wait();
  const auto* f = &g_blk->frag[base];
  auto half = [](unsigned word, int k) { return __uint_as_float(k & 1 ? word & 0xffff0000u : word << 16); };
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 16; ++k) {
      const float av = half(f[(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)], k);
      const float bv = half(f[col * 4 + (k % 8) / 2][4 + (k >= 8)], k);
      s += av * bv;
    }
    d[i] = s;
  }
}
#ifdef EMU_CONCURRENT
// One OS thread per CUDA thread of every block, all at once. Block b starts
// once block b - 1 has passed its first __syncthreads (or ended), so blocks
// take a launch's tickets in index order; after its first, each
// __syncthreads of block b waits (grid - 1 - b) * EMU_STEP_MS ms, so the
// later blocks run ahead of the earlier ones and reach a read of what an
// earlier block publishes before it is published.
inline void emu_launch(unsigned grid, unsigned block, size_t, cudaStream_t, std::function<void()> fn) {
  std::vector<std::unique_ptr<EmuBlock>> blks;
  for (unsigned b = 0; b < grid; ++b) {
    auto blk = std::make_unique<EmuBlock>();
    blk->block_bar = std::make_unique<std::barrier<>>(block);
    for (unsigned w = 0; w < (block + 31) / 32; ++w) blk->warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    blk->xchg.assign(block, 0);
    blk->frag.resize(2 * block);
    blk->lag_ms = (grid - 1 - b) * EMU_STEP_MS;
    blk->go.store(b == 0);
    blks.push_back(std::move(blk));
  }
  for (unsigned b = 0; b + 1 < grid; ++b) blks[b]->next = &blks[b + 1]->go;
  std::vector<std::thread> ts;
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([&, b, t] {
        g_blk = blks[b].get();
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        blockDim = dim3(block);
        gridDim = dim3(grid);
        emu_syncs = 0;
        emu_mma_turn = 0;
        emu_count_turn = 0;
        while (!g_blk->go.load()) std::this_thread::sleep_for(std::chrono::milliseconds(1));
        fn();
        if (t == 0 && g_blk->next != nullptr) g_blk->next->store(true);
      });
  for (auto& t : ts) t.join();
}
#else
// One OS thread per CUDA thread of a block, reused for every block of the
// grid in turn; an end-of-block barrier keeps the blocks apart (every
// thread reaches each __syncthreads of a block equally often, so the block
// barrier needs no thread to leave it).
inline void emu_launch(unsigned grid, unsigned block, size_t, cudaStream_t, std::function<void()> fn) {
  EmuBlock blk;
  blk.block_bar = std::make_unique<std::barrier<>>(block);
  for (unsigned w = 0; w < (block + 31) / 32; ++w) blk.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
  blk.xchg.assign(block, 0);
  blk.frag.resize(2 * block);
  std::barrier<> end_bar(block);
  g_blk = &blk;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < block; ++t)
    ts.emplace_back([&, t] {
      threadIdx = dim3(t);
      emu_mma_turn = 0;
      emu_count_turn = 0;
      blockDim = dim3(block);
      gridDim = dim3(grid);
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx = dim3(b);
        fn();
        end_bar.arrive_and_wait();
      }
    });
  for (auto& t : ts) t.join();
}
#endif
