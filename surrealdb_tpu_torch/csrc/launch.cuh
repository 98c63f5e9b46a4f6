// Host-side launch helpers shared by the kernel files: a kernel's dynamic
// shared-memory limit raised once a device, the device's SM count cached,
// so a launch makes no attribute calls after the first, and the grid of a
// thread-an-item kernel.
// csrc/emu/cuda_emu.h defines the runtime calls for the CPU emulation.
// Include after <cuda_runtime.h>.
#pragma once

#include <atomic>

namespace {

// The dynamic shared memory a launcher whose size varies by call raises its
// kernel to, once (a block's 227 KB, less 4 KB for its static arrays); a
// launch asks for its own size up to it.
constexpr int SMEM_OPT_IN = 232448 - 4096;

// Raises a kernel's dynamic shared memory limit to `bytes` once a device:
// `seen` is the launcher's own mask of devices done.
template <class Kern>
int opt_in_smem(Kern kernel, int bytes, std::atomic<unsigned>& seen) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned bit = 1u << (dev & 31);
  if (seen.load() & bit) return 0;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) seen.fetch_or(bit);
  return err;
}

// The block size grid_for sizes its grids for.
constexpr int GRID_THREADS = 256;

// A grid of GRID_THREADS-thread blocks covering `work` items, one a thread,
// grid-stride above 65,536 blocks.
inline unsigned grid_for(long long work) {
  long long g = (work + GRID_THREADS - 1) / GRID_THREADS;
  if (g < 1) g = 1;
  return (unsigned)(g < 65536 ? g : 65536);
}

inline int sm_count() {
  static std::atomic<int> cache[32];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = cache[dev & 31].load();
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev & 31].store(n);
  }
  return n;
}

}  // namespace
