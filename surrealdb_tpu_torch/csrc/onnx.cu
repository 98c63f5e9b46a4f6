// K16, the ONNX / .surml model forward for Hopper (sm_90a): the
// elementwise and reduction launches of the plan that
// surrealdb_tpu_torch/ml/onnx_mini.py OnnxGraph.lower builds from a graph
// (its products run on ml.cu's ml_linear with an epilogue program, its
// softmax on ml_softmax). Behind the same plain C interface as the other
// sources (one library, loaded with ctypes by ops/_cuda.py).
//
// K16 replaces surrealdb_tpu/ml/model.py:198, the ONNX branch of
// CompiledModel._device_fn: jax.jit of onnx_mini.py build_forward, one XLA
// program of the whole graph. Two kernels here:
//
// ml_ewise: out = P(in0..in3), P a register program of at most 16
// instructions (ewise.cuh) over up to 4 inputs, each f32 or bf16 (the
// mirror as the card holds it, upcast exactly), up to 4-D, with its own
// element strides (0 on a broadcast axis); out f32 with its own strides, so
// a Transpose is one copy through permuted input strides and a Concat one
// copy an input into a slice of its output. A thread an element,
// grid-stride over the output in row-major order, its coordinates taken
// apart with 32-bit divisions while the output has fewer than 2^32
// elements. Bound by bytes: each input element read and each output
// written once (config 5's z-score over [2^20, 768] bf16: 1.61 GB read +
// 3.22 GB written, 1.44 ms at 3.35 TB/s); the divisions and the
// interpreted program are the cost above that.
//
// ml_reduce: the sum, or the mean (the sum divided by the count, as
// the reference's mean), over one axis of a contiguous x viewed as [outer, L, inner],
// f32 or bf16 in, f32 out [outer, inner]. Adjacent axes merge into one L;
// the wrapper (ml/model.py reduce_axis) launches once a run of adjacent
// axes. Axis innermost (inner = 1): G lanes of a warp an output, G the
// next power of two of L up to 32 (a warp an output from L = 17), lane
// sums strided over L then a butterfly; otherwise a thread an output,
// consecutive threads on consecutive inner indices (coalesced), its sum
// sequential over L. Where fewer than 4,096 outputs would each read 4,096
// or more values, L is cut into chunks of ~1,024 (at most 1,024 chunks),
// summed into the wrapper's scratch [outer, chunks, inner] and summed again
// in a second launch: the whole-tensor reduction is then not one warp's
// walk. Bound by bytes: x read once.
//
// Summation order (f32): a lane's (thread's) values in index order, then
// the butterfly's tree, then (chunked) the chunks' sums in the same way;
// deterministic, and not the order of the plain version (torch.sum), so the
// two agree within an f32 tolerance of the sum of |x|.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ewise.cuh"
#include "launch.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float rd_f(float v) { return v; }
__device__ __forceinline__ float rd_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------------ ml_ewise
constexpr int EW_THREADS = 256;
constexpr int EW_MAX_DIMS = 4;
constexpr int EW_INPUTS = 4;

// the launch's description: host memory filled by ml/model.py (_EwDesc),
// passed to the kernel by value
struct EwDesc {
  int ndim, nin, nins, out_reg;
  // dims collapsed where every operand allows, right-aligned: slot
  // EW_MAX_DIMS - 1 the innermost, the first EW_MAX_DIMS - ndim unused
  long long shape[EW_MAX_DIMS];                // the output's
  long long ostride[EW_MAX_DIMS];              // elements
  long long istride[EW_INPUTS][EW_MAX_DIMS];   // elements; 0 on a broadcast axis
  int ibf16[EW_INPUTS];
  EwIns ins[EW_MAX_INS];
  const void* in[EW_INPUTS];
  void* out;
};

template <typename I>  // unsigned (< 2^32 elements) or unsigned long long
__global__ void __launch_bounds__(EW_THREADS) ewise_kernel(const EwDesc d, I total) {
  const I step = (I)gridDim.x * EW_THREADS;
  for (I e = (I)blockIdx.x * EW_THREADS + threadIdx.x; e < total; e += step) {
    // coordinates, innermost dim first; the outermost takes what is left
    // (dims right-aligned: the first 4 - ndim slots unused; constant slot
    // indices keep the description in the parameter bank)
    const int first = EW_MAX_DIMS - d.ndim;
    long long ioff[EW_INPUTS] = {0, 0, 0, 0};
    long long ooff = 0;
    I rest = e;
#pragma unroll
    for (int k = EW_MAX_DIMS - 1; k >= 0; --k) {
      if (k < first) break;
      I c = rest;
      if (k > first) {
        const I q = rest / (I)d.shape[k];
        c = rest - q * (I)d.shape[k];
        rest = q;
      }
      ooff += (long long)c * d.ostride[k];
#pragma unroll
      for (int j = 0; j < EW_INPUTS; ++j) ioff[j] += (long long)c * d.istride[j][k];
    }
    float r[EW_REGS] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < EW_INPUTS; ++j)
      if (j < d.nin)
        r[j] = d.ibf16[j] ? rd_f(static_cast<const __nv_bfloat16*>(d.in[j])[ioff[j]])
                          : static_cast<const float*>(d.in[j])[ioff[j]];
    ew_run<EW_MAX_INS>(d.ins, d.nins, r);
    static_cast<float*>(d.out)[ooff] = ew_rd(r, d.out_reg);
  }
}

// ------------------------------------------------------------------ ml_reduce
constexpr int RD_THREADS = 256;
constexpr long long RD_FEW_OUTPUTS = 4096;  // below: chunk a long L
constexpr long long RD_LONG_L = 4096;
constexpr long long RD_CHUNK = 1024;
constexpr long long RD_MAX_CHUNKS = 1024;

// x [rows, L] (axis innermost): output q = (row o, chunk c) sums x[o L + c lc
// + l] for l < min(lc, L - c lc), G lanes an output, out[q] = sum / div
template <typename T, int G>
__global__ void __launch_bounds__(RD_THREADS)
reduce_rows_kernel(const T* __restrict__ x, long long rows, long long L, long long chunks,
                   long long lc, float div, float* __restrict__ out) {
  constexpr int PER_WARP = 32 / G;
  const int lane = threadIdx.x & 31, sub = lane / G, gl = lane % G;
  const long long nout = rows * chunks;
  const long long warps = (long long)gridDim.x * (RD_THREADS / 32);
  // every lane of a warp takes each turn (the butterfly's shuffles)
  for (long long w = (long long)blockIdx.x * (RD_THREADS / 32) + threadIdx.x / 32;
       w * PER_WARP < nout; w += warps) {
    const long long q = w * PER_WARP + sub;
    float s = 0.f;
    if (q < nout) {
      const long long o = q / chunks, c = q - o * chunks, l0 = c * lc;
      const long long len = L - l0 < lc ? L - l0 : lc;
      const T* p = x + o * L + l0;
      for (long long l = gl; l < len; l += G) s += rd_f(p[l]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL_MASK, s, off);
    if (gl == 0 && q < nout) out[q] = s / div;
  }
}

// x [outer, L, inner] (inner > 1): output q = ((o chunks + c) inner + i)
// sums x[o, c lc + l, i] for l < min(lc, L - c lc), a thread an output
template <typename T>
__global__ void __launch_bounds__(RD_THREADS)
reduce_cols_kernel(const T* __restrict__ x, long long outer, long long L, long long inner,
                   long long chunks, long long lc, float div, float* __restrict__ out) {
  const long long nout = outer * chunks * inner;
  const long long step = (long long)gridDim.x * RD_THREADS;
  for (long long q = (long long)blockIdx.x * RD_THREADS + threadIdx.x; q < nout; q += step) {
    const long long oc = q / inner, i = q - oc * inner;
    const long long o = oc / chunks, c = oc - o * chunks, l0 = c * lc;
    const long long len = L - l0 < lc ? L - l0 : lc;
    const T* p = x + (o * L + l0) * inner + i;
    float s = 0.f;
    for (long long l = 0; l < len; ++l) s += rd_f(p[l * inner]);
    out[q] = s / div;
  }
}

long long rd_chunks(long long outer, long long L, long long inner) {
  if (outer * inner >= RD_FEW_OUTPUTS || L < RD_LONG_L) return 1;
  long long c = (L + RD_CHUNK - 1) / RD_CHUNK;
  return c < RD_MAX_CHUNKS ? c : RD_MAX_CHUNKS;
}

unsigned rd_grid(long long items) {
  long long g = (items + RD_THREADS - 1) / RD_THREADS;
  const long long cap = (long long)sm_count() * 16;
  if (g > cap) g = cap;
  return (unsigned)(g < 1 ? 1 : g);
}

template <typename T, int G>
int launch_rows(const T* x, long long rows, long long L, long long chunks, long long lc,
                float div, float* out, cudaStream_t s) {
  const long long warps = (rows * chunks + 32 / G - 1) / (32 / G);
  reduce_rows_kernel<T, G><<<rd_grid(warps * 32), RD_THREADS, 0, s>>>(x, rows, L, chunks, lc, div,
                                                                      out);
  return (int)cudaGetLastError();
}

// one pass: G from the length a group sums
template <typename T>
int reduce_pass(const T* x, long long outer, long long L, long long inner, long long chunks,
                float div, float* out, cudaStream_t s) {
  const long long lc = (L + chunks - 1) / chunks;
  if (inner > 1) {
    reduce_cols_kernel<T><<<rd_grid(outer * chunks * inner), RD_THREADS, 0, s>>>(
        x, outer, L, inner, chunks, lc, div, out);
    return (int)cudaGetLastError();
  }
  if (lc <= 1) return launch_rows<T, 1>(x, outer, L, chunks, lc, div, out, s);
  if (lc <= 2) return launch_rows<T, 2>(x, outer, L, chunks, lc, div, out, s);
  if (lc <= 4) return launch_rows<T, 4>(x, outer, L, chunks, lc, div, out, s);
  if (lc <= 8) return launch_rows<T, 8>(x, outer, L, chunks, lc, div, out, s);
  if (lc <= 16) return launch_rows<T, 16>(x, outer, L, chunks, lc, div, out, s);
  return launch_rows<T, 32>(x, outer, L, chunks, lc, div, out, s);
}

template <typename T>
int reduce_dispatch(const T* x, long long outer, long long L, long long inner, float div,
                    float* scratch, long long scratch_floats, float* out, cudaStream_t s) {
  const long long chunks = rd_chunks(outer, L, inner);
  if (chunks == 1) return reduce_pass<T>(x, outer, L, inner, 1, div, out, s);
  if (scratch == nullptr || scratch_floats < outer * chunks * inner)
    return (int)cudaErrorInvalidValue;
  // the chunks' sums [outer, chunks, inner], then their sum over chunks
  if (int err = reduce_pass<T>(x, outer, L, inner, chunks, 1.f, scratch, s)) return err;
  return reduce_pass<float>(scratch, outer, chunks, inner, 1, div, out, s);
}

}  // namespace

extern "C" {

// K16 elementwise launch: desc is host memory laid out as EwDesc (1 <=
// ndim <= 4, 0 <= nin <= 4, a valid program of 1..16 instructions). An
// empty output launches nothing.
int ml_ewise(const void* desc, void* stream) {
  const EwDesc d = *static_cast<const EwDesc*>(desc);
  if (d.ndim < 1 || d.ndim > EW_MAX_DIMS || d.nin < 0 || d.nin > EW_INPUTS || d.nins < 1 ||
      !ew_valid(d.ins, d.nins, EW_MAX_INS, d.out_reg) || d.out == nullptr)
    return (int)cudaErrorInvalidValue;
  unsigned long long total = 1;
  for (int k = EW_MAX_DIMS - d.ndim; k < EW_MAX_DIMS; ++k) {
    if (d.shape[k] < 0) return (int)cudaErrorInvalidValue;
    total *= (unsigned long long)d.shape[k];
  }
  for (int j = 0; j < d.nin; ++j)
    if (d.in[j] == nullptr) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  long long g = (long long)((total + EW_THREADS - 1) / EW_THREADS);
  const long long cap = (long long)sm_count() * 16;
  const unsigned grid = (unsigned)(g < cap ? g : cap);
  const cudaStream_t s = (cudaStream_t)stream;
  if (total < (1ull << 32))
    ewise_kernel<unsigned><<<grid, EW_THREADS, 0, s>>>(d, (unsigned)total);
  else
    ewise_kernel<unsigned long long><<<grid, EW_THREADS, 0, s>>>(d, total);
  return (int)cudaGetLastError();
}

// floats of scratch ml_reduce needs for [outer, L, inner] (0: none)
long long ml_reduce_scratch_floats(long long outer, long long L, long long inner) {
  const long long chunks = rd_chunks(outer, L, inner);
  return chunks == 1 ? 0 : outer * chunks * inner;
}

// K16 reduction: out [outer, inner] f32 = sum over l of x [outer, L, inner]
// (contiguous, f32 or bf16), divided by div (1: a sum; the count of the
// reduced values: a mean); scratch of ml_reduce_scratch_floats floats.
// No output launches nothing; L = 0 gives 0 / div.
int ml_reduce(const void* x, int x_bf16, long long outer, long long L, long long inner, float div,
              void* scratch, long long scratch_floats, void* out, void* stream) {
  if (outer < 0 || L < 0 || inner < 1 || x == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (outer == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return reduce_dispatch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), outer, L, inner,
                                          div, static_cast<float*>(scratch), scratch_floats,
                                          static_cast<float*>(out), s);
  return reduce_dispatch<float>(static_cast<const float*>(x), outer, L, inner, div,
                                static_cast<float*>(scratch), scratch_floats,
                                static_cast<float*>(out), s);
}

}  // extern "C"
