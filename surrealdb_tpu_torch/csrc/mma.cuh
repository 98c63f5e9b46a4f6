// Helpers shared by the kernels that run bf16 products on the tensor cores
// (ml.cu's wide path, ivf.cu's assignment): cp.async copies into shared
// memory, mma.sync.m16n8k16 (bf16 -> f32), and the split of an f32 into
// three bf16 limbs. The card-only ones are under __CUDACC__;
// csrc/emu/cuda_emu.h defines the same names for the CPU emulation.
// Include after <cuda_runtime.h> and <cuda_bf16.h>.
#pragma once

namespace {

__device__ __forceinline__ bool finite_f(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// ------------------------------------------------------------------ card-only helpers
#ifdef __CUDACC__
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; `bytes` (16 or 0) are read, the rest
// zero-filled. L2 fetches the 256 bytes around it: a row's next chunks
// are then in L2 when their steps come (whole DRAM bursts, not 64 bytes)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
// 4 bytes global -> shared; `bytes` (4 or 0) are read, the rest zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// d [4] += A (16 x 16 bf16, row) x B (16 x 8 bf16, col), PTX fragment layouts
__device__ __forceinline__ void mma_bf16_16816(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// ------------------------------------------------------------------ limbs
__device__ __forceinline__ float bf16_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffff0000u);
}
// v = l0 + l1 + l2 exactly (finite v), each limb exact in bf16
__device__ __forceinline__ void split3(float v, float& l0, float& l1, float& l2) {
  l0 = bf16_trunc(v);
  const float r = v - l0;
  l1 = bf16_trunc(r);
  l2 = r - l1;
}
// two values exact in bf16 as one bf16x2 word, `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

}  // namespace
