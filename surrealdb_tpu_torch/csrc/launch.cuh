// Host-side launch helpers shared by the kernel files: a kernel's dynamic
// shared-memory limit raised once a device, and the device's SM count
// cached, so a launch makes no attribute calls after the first.
// csrc/emu/cuda_emu.h defines the runtime calls for the CPU emulation.
// Include after <cuda_runtime.h>.
#pragma once

#include <atomic>

namespace {

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
