// The ML forward (K10) for Hopper (sm_90a), behind the same plain C
// interface as knn.cu, ivf.cu, graph.cu and bm25.cu (one library, loaded
// with ctypes by surrealdb_tpu_torch/ops/_cuda.py).
//
// K10 replaces surrealdb_tpu/ml/model.py CompiledModel._device_fn, the
// jitted model forward: for each layer h = act(h @ W + b), the product in
// f32 (preferred_element_type=f32), then relu / tanh / sigmoid / softmax
// over the last axis / none. Two kernels:
//
// ml_linear: out [M, N] f32 = act(x [M, K] @ W [K, N] + b [N]); x f32 or
// bf16 (the vector mirror as the card holds it: read as bf16, upcast
// exactly, accumulated in f32, so no f32 copy of the corpus is made), W and
// b f32, the activation (none, relu, tanh, sigmoid) fused into the
// epilogue. Every product and sum is f32 on the CUDA cores: no TF32, no
// bf16 rounding of W. Two paths:
//
// - skinny (N <= 16; bench config 5 is 768 -> 1): what bounds it is the
//   read of x (2^20 x 768 bf16 = 1.61 GB, 0.48 ms at 3.35 TB/s; its 1.6
//   GFLOP are nothing), so nothing may pad N to a wide tile. A warp owns
//   SK_ROWS rows at a time; each lane reads x with 16-byte loads
//   (scalar loads where K or the base is not 16-byte aligned), keeps NB
//   partial sums a row in registers and the warp adds them with a
//   butterfly of shuffles. W sits in shared memory, column-major and, on
//   the vector path, permuted within each group of 32 x V values so that
//   the 32 lanes reading their j-th value hit 32 consecutive banks. A K
//   above what fits (96 KB of W) is walked in chunks.
// - wide (N > 16; the MLP's hidden layers): a shared-memory tiled product,
//   64 rows x 64 columns a block, a 4 x 4 register tile a thread, K staged
//   32 at a time (x transposed and upcast to f32 on the way in), as
//   ivf_assign (ivf.cu) tiles its distance products. Bound by the f32 FMA
//   rate (67 TFLOP/s) at the MLP's widths; a wgmma version is a later step.
//
// ml_softmax: a row softmax over [M, N] f32 in the reference's order
// (jax.nn.softmax): subtract the row max, exp, divide by the row sum; a
// warp a row, in place when out == h. Bound by its bytes (one read, one
// write; the kernel reads the row three times, from L1/L2 after the first).
//
// Sigmoid is 1 / (1 + exp(-x)), as jax.nn.sigmoid and the host twin: it
// saturates to 0 and 1 at large |x| without a NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3 };

__device__ __forceinline__ float ml_f(float v) { return v; }
__device__ __forceinline__ float ml_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float ml_act(float v, int act) {
  if (act == ACT_RELU) return v < 0.f ? 0.f : v;  // keeps a NaN, as jnp.maximum does
  if (act == ACT_TANH) return tanhf(v);
  if (act == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  return v;
}

constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------------ skinny
constexpr int SK_THREADS = 256;
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_ROWS = 4;                     // rows a warp a pass
constexpr int SK_TILE = SK_WARPS * SK_ROWS;    // rows a block a pass
constexpr int SK_SMEM = 96 * 1024;             // bytes of W staged a chunk
constexpr int SK_GRID = 2048;                  // blocks at most (grid-stride over row tiles)

// W [K, N] chunk [c0, c0 + kc) into ws [NB][kc], zero-padded past K and N.
// On the vector path (V > 1) value k of a group of G = 32 V sits at
// (k % V) * 32 + (k / V) % 32, so that lane l's j-th value is at j*32 + l.
template <int NB, int V>
__device__ void stage_w(const float* __restrict__ w, int K, int N, int c0, int kc, float* ws) {
  constexpr int G = 32 * V;
  for (int e = threadIdx.x; e < NB * kc; e += SK_THREADS) {
    const int n = e / kc, kl = e % kc, k = c0 + kl;
    const float v = (n < N && k < K) ? w[(long long)k * N + n] : 0.f;
    ws[n * kc + (kl / G) * G + (kl % V) * 32 + (kl / V) % 32] = v;
  }
}

template <typename T, int NB, int V>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, long long M, int K, int N, int act, int kc,
              float* __restrict__ out) {
  extern __shared__ float ws[];  // [NB][kc]
  constexpr int G = 32 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = (K + kc - 1) / kc;
  if (nchunks == 1) {
    stage_w<NB, V>(w, K, N, 0, kc, ws);
    __syncthreads();
  }
  for (long long t0 = (long long)blockIdx.x * SK_TILE; t0 < M;
       t0 += (long long)gridDim.x * SK_TILE) {
    const long long r0 = t0 + warp * SK_ROWS;
    float acc[SK_ROWS][NB];
#pragma unroll
    for (int i = 0; i < SK_ROWS; ++i)
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[i][n] = 0.f;
    for (int c0 = 0; c0 < K; c0 += kc) {
      if (nchunks > 1) {
        __syncthreads();  // the previous chunk is no longer read
        stage_w<NB, V>(w, K, N, c0, kc, ws);
        __syncthreads();
      }
      const int klen = min(kc, K - c0);
      for (int g0 = 0; g0 < klen; g0 += G) {
        const int k = c0 + g0 + lane * V;  // this lane's first value
#pragma unroll
        for (int i = 0; i < SK_ROWS; ++i) {
          const long long row = r0 + i;
          float xv[V];
          if (row < M && k < K) {  // vector path: K % V == 0, so all V are in range
            const T* src = x + row * K + k;
            if constexpr (V == 1) {
              xv[0] = ml_f(src[0]);
            } else {
              const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
              const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
              for (int j = 0; j < V; ++j) xv[j] = ml_f(t[j]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) xv[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < V; ++j)
#pragma unroll
            for (int n = 0; n < NB; ++n)
              acc[i][n] = fmaf(xv[j], ws[n * kc + g0 + j * 32 + lane], acc[i][n]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SK_ROWS; ++i) {
      float mine = 0.f;  // lane n keeps column n's sum
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float v = acc[i][n];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
        if (n == lane) mine = v;
      }
      const long long row = r0 + i;
      if (row < M && lane < N) out[row * N + lane] = ml_act(mine + b[lane], act);
    }
  }
}

// ------------------------------------------------------------------ wide
constexpr int WD_THREADS = 256;
constexpr int WD_TR = 64;  // rows a block
constexpr int WD_TC = 64;  // columns a block
constexpr int WD_DK = 32;  // K staged a step

template <typename T>
__global__ void __launch_bounds__(WD_THREADS)
wide_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
            long long M, int K, int N, int act, float* __restrict__ out) {
  __shared__ float xs[WD_DK][WD_TR + 1];  // x tile, transposed
  __shared__ float wt[WD_DK][WD_TC];
  const int nct = (N + WD_TC - 1) / WD_TC;
  const long long row0 = (long long)(blockIdx.x / nct) * WD_TR;
  const int col0 = (int)(blockIdx.x % nct) * WD_TC;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // rows ty + 16i, cols tx + 16j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += WD_DK) {
    __syncthreads();  // the previous step's tiles are no longer read
    for (int e = tid; e < WD_TR * WD_DK; e += WD_THREADS) {
      const int r = e / WD_DK, kk = e % WD_DK;
      const long long row = row0 + r;
      const int k = k0 + kk;
      xs[kk][r] = (row < M && k < K) ? ml_f(x[row * K + k]) : 0.f;
    }
    for (int e = tid; e < WD_DK * WD_TC; e += WD_THREADS) {
      const int kk = e / WD_TC, c = e % WD_TC;
      const int k = k0 + kk, col = col0 + c;
      wt[kk][c] = (k < K && col < N) ? w[(long long)k * N + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < WD_DK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = wt[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (row < M && col < N) out[row * N + col] = ml_act(acc[i][j] + b[col], act);
    }
  }
}

// ------------------------------------------------------------------ softmax
constexpr int SM_THREADS = 256;
constexpr int SM_ROWS = SM_THREADS / 32;  // rows a block, a warp each

__global__ void __launch_bounds__(SM_THREADS)
softmax_kernel(const float* h, long long M, int N, float* out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * SM_ROWS + (threadIdx.x >> 5);
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

template <typename T, int NB>
int launch_skinny(const T* x, const float* w, const float* b, long long M, int K, int N,
                  int act, float* out, cudaStream_t s) {
  constexpr int VV = 16 / (int)sizeof(T);
  const bool vec = K % VV == 0 && ((uintptr_t)x % 16) == 0;
  const int g = vec ? 32 * VV : 32;
  const int fit = (SK_SMEM / (int)(sizeof(float) * NB)) / g * g;
  const int kc = min((K + g - 1) / g * g, fit);
  const size_t smem = (size_t)NB * kc * sizeof(float);
  const long long tiles = (M + SK_TILE - 1) / SK_TILE;
  const unsigned grid = (unsigned)(tiles < SK_GRID ? tiles : SK_GRID);
  if (vec) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(skinny_kernel<T, NB, VV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    skinny_kernel<T, NB, VV><<<grid, SK_THREADS, smem, s>>>(x, w, b, M, K, N, act, kc, out);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(skinny_kernel<T, NB, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    skinny_kernel<T, NB, 1><<<grid, SK_THREADS, smem, s>>>(x, w, b, M, K, N, act, kc, out);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int linear_dispatch(const T* x, const float* w, const float* b, long long M, int K, int N,
                    int act, float* out, cudaStream_t s) {
  if (N <= 1) return launch_skinny<T, 1>(x, w, b, M, K, N, act, out, s);
  if (N <= 2) return launch_skinny<T, 2>(x, w, b, M, K, N, act, out, s);
  if (N <= 4) return launch_skinny<T, 4>(x, w, b, M, K, N, act, out, s);
  if (N <= 8) return launch_skinny<T, 8>(x, w, b, M, K, N, act, out, s);
  if (N <= 16) return launch_skinny<T, 16>(x, w, b, M, K, N, act, out, s);
  const long long blocks = (M + WD_TR - 1) / WD_TR * ((N + WD_TC - 1) / WD_TC);
  wide_kernel<T><<<(unsigned)blocks, WD_THREADS, 0, s>>>(x, w, b, M, K, N, act, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K10 linear layer. x [M, K] row-major, f32 (x_bf16 = 0) or bf16 (x_bf16 =
// 1); w [K, N] row-major f32; b [N] f32; act 0 none, 1 relu, 2 tanh, 3
// sigmoid; out [M, N] f32 (never aliasing x). M = 0 launches nothing.
int ml_linear(const void* x, int x_bf16, const void* w, const void* b, long long M, int K,
              int N, int act, void* out, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || act < ACT_NONE || act > ACT_SIGMOID)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return linear_dispatch<__nv_bfloat16>((const __nv_bfloat16*)x, (const float*)w,
                                          (const float*)b, M, K, N, act, (float*)out, s);
  return linear_dispatch<float>((const float*)x, (const float*)w, (const float*)b, M, K, N, act,
                                (float*)out, s);
}

// K10 softmax over the last axis: h [M, N] f32 -> out [M, N] f32; out may
// be h (in place). M = 0 launches nothing.
int ml_softmax(const void* h, long long M, int N, void* out, void* stream) {
  if (M < 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((M + SM_ROWS - 1) / SM_ROWS);
  softmax_kernel<<<grid, SM_THREADS, 0, (cudaStream_t)stream>>>((const float*)h, M, N,
                                                                (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
