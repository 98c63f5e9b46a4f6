// Elementwise register programs, shared by onnx.cu's ml_ewise and ml.cu's
// ml_linear epilogue (K16: the ONNX branch of surrealdb_tpu/ml/model.py
// CompiledModel._device_fn, whose XLA program fused the graph's
// elementwise nodes; ml/onnx_mini.py lowers them to these programs).
//
// A program is a list of instructions over 8 f32 registers. An
// instruction reads its operands a and b (a register, or EW_IMM for its
// immediate) and writes op(a, b) to register dst. ml_ewise starts with its
// inputs in r0..r3, the other registers at 0, and runs the program an
// element at a time (ew_run). ml_linear's epilogue is a chain over the
// product: r0 starts as the product, r1 and r2 are its two per-column
// operands (0 where absent), every instruction writes r0 and reads r0, r1,
// r2 or the immediate, and r0 is the result (epi_valid). It runs over a
// thread's whole tile of outputs at once (epi_tile): one dispatch an
// instruction, a column's operand loaded once. Layouts are mirrored by ctypes
// structures in ml/model.py (_EwIns, _EwDesc, _EpiDesc), and the ops by
// its plain interpreter `run_program_plain`.
//
// Each op rounds as the reference's jax.numpy expression does (onnx_mini.py
// _apply): one f32 operation a step, no FMA contraction (the _rn
// intrinsics), division and sqrt correctly rounded; max and min propagate a
// NaN and order -0 below +0, as XLA's maximum and clip do, so Relu
// is max(x, 0): -0 gives +0, NaN stays NaN; Elu is alpha (exp(x) - 1) and
// Sigmoid 1 / (1 + exp(-x)), as _apply writes them.
#pragma once

namespace {

enum EwOp : int {
  EW_COPY = 0, EW_ADD, EW_SUB, EW_MUL, EW_DIV, EW_POW, EW_MAX, EW_MIN, EW_NEG, EW_EXP,
  EW_SQRT, EW_TANH, EW_RELU, EW_LEAKY, EW_ELU, EW_SIGMOID, EW_NOPS
};
constexpr int EW_REGS = 8;
constexpr int EW_IMM = 8;      // an operand field naming the instruction's immediate
constexpr int EW_MAX_INS = 16;  // ml_ewise's program
constexpr int EPI_MAX_INS = 8;  // ml_linear's epilogue

struct EwIns {
  unsigned char op, dst, a, b;
  float imm;  // the immediate operand; LeakyRelu's and Elu's alpha
};

// ml_linear's epilogue: r0 = the product, r1 / r2 = opnd[k][col * ostride[k]]
// (a per-column [N] operand; ostride 0: one value), out = the result
// register (0)
struct EpiProg {
  int n, out;
  EwIns ins[EPI_MAX_INS];
  const float* opnd[2];
  int ostride[2];
};

__device__ __forceinline__ float ew_rd(const float (&r)[EW_REGS], int i) {
  float v = r[0];
#pragma unroll
  for (int j = 1; j < EW_REGS; ++j) v = i == j ? r[j] : v;
  return v;
}

__device__ __forceinline__ void ew_wr(float (&r)[EW_REGS], int i, float v) {
#pragma unroll
  for (int j = 0; j < EW_REGS; ++j) r[j] = i == j ? v : r[j];
}

__device__ __forceinline__ bool ew_nan(float v) { return v != v; }

// XLA's max / min: a NaN wins, and +0 > -0
__device__ __forceinline__ float ew_max(float a, float b) {
  if (ew_nan(a) || ew_nan(b)) return a + b;
  if (a != b) return a > b ? a : b;
  return (__float_as_uint(a) >> 31) ? b : a;
}

__device__ __forceinline__ float ew_min(float a, float b) {
  if (ew_nan(a) || ew_nan(b)) return a + b;
  if (a != b) return a < b ? a : b;
  return (__float_as_uint(a) >> 31) ? a : b;
}

// ew_max(a, 0) in two compares: a NaN stays, -0 and negatives give +0
__device__ __forceinline__ float ew_relu(float a) { return a > 0.f || ew_nan(a) ? a : 0.f; }

__device__ __forceinline__ float ew_leaky(float a, float alpha) {
  return a > 0.f ? a : __fmul_rn(alpha, a);
}

__device__ __forceinline__ float ew_elu(float a, float alpha) {
  return a > 0.f ? a : __fmul_rn(alpha, __fsub_rn(expf(a), 1.f));
}

__device__ __forceinline__ float ew_sigmoid(float a) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
}

// powf is long: one copy a kernel, out of line
__device__ __noinline__ float ew_pow(float a, float b) { return powf(a, b); }

// the ops with library calls, out of line: one copy a kernel
__device__ __noinline__ float ew_op_call(int op, float a, float b, float imm) {
  switch (op) {
    case EW_POW: return ew_pow(a, b);
    case EW_EXP: return expf(a);
    case EW_SQRT: return sqrtf(a);
    case EW_TANH: return tanhf(a);
    case EW_LEAKY: return ew_leaky(a, imm);
    case EW_ELU: return ew_elu(a, imm);
    case EW_SIGMOID: return ew_sigmoid(a);
    default: return a;
  }
}

__device__ __forceinline__ float ew_op(int op, float a, float b, float imm) {
  switch (op) {
    case EW_COPY: return a;
    case EW_ADD: return __fadd_rn(a, b);
    case EW_SUB: return __fsub_rn(a, b);
    case EW_MUL: return __fmul_rn(a, b);
    case EW_DIV: return __fdiv_rn(a, b);
    case EW_MAX: return ew_max(a, b);
    case EW_MIN: return ew_min(a, b);
    case EW_NEG: return -a;
    case EW_RELU: return ew_relu(a);
    default: return ew_op_call(op, a, b, imm);
  }
}

// runs the first n (<= NMAX) instructions over r
template <int NMAX>
__device__ __forceinline__ void ew_run(const EwIns (&ins)[NMAX], int n, float (&r)[EW_REGS]) {
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    if (i >= n) break;
    const EwIns in = ins[i];
    const float a = in.a == EW_IMM ? in.imm : ew_rd(r, in.a);
    const float b = in.b == EW_IMM ? in.imm : ew_rd(r, in.b);
    ew_wr(r, in.dst, ew_op(in.op, a, b, in.imm));
  }
}

// an epilogue operand of column col: r1 / r2 (0 where absent or col >= N)
// or the immediate; r0 reads as 0 here (the caller takes the product)
__device__ __forceinline__ float epi_src(const EpiProg& e, int reg, float imm, int col, int N) {
  if (reg == EW_IMM) return imm;
  if (reg == 0 || col >= N) return 0.f;
  const float* p = e.opnd[reg - 1];
  return p == nullptr ? 0.f : p[(long long)col * e.ostride[reg - 1]];
}

// the output column of a tile's column c: base + (c / 2) pair + c % 2 (a
// lane of the wide path holds column pairs 8 apart; pair 2: c itself)
struct EpiCols {
  int base, pair;
  __device__ __forceinline__ int operator()(int c) const { return base + (c >> 1) * pair + (c & 1); }
};

// v[r][c] = f(a, b) over a tile, a and b the product v[r][c] or the
// column's source s[c]
template <int R, int C, typename F>
__device__ __forceinline__ void epi_each(float (&v)[R][C], const float (&s)[C], bool a0, bool b0,
                                         F f) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) v[r][c] = f(a0 ? v[r][c] : s[c], b0 ? v[r][c] : s[c]);
}

// the epilogue over a thread's tile of products v [R][C] (tile column c is
// output column cols(c); >= N: padding, read as 0 operands): one dispatch
// an instruction. The short ops and a layer's activations (relu, tanh,
// sigmoid) run inline over the registers; the other long ones (div, pow,
// exp, sqrt, elu) through ew_op over a copy of the tile in local memory, a
// value a turn of one loop, which keeps the code of every tile shape near
// that of the fused bias and activation. Each op is the function ew_op
// runs, so the bits are ml_ewise's.
template <int R, int C>
__device__ __forceinline__ void epi_tile(const EpiProg& e, float (&v)[R][C], EpiCols cols,
                                         int N) {
#pragma unroll 1
  for (int i = 0; i < e.n; ++i) {
    const EwIns in = e.ins[i];
    const float imm = in.imm;
    float s[C];
    bool a0 = in.a == 0;
    const bool b0 = in.b == 0;
    if (!a0 && !b0) {  // neither side reads r0: r0 takes a first (it is overwritten anyway)
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = epi_src(e, in.a, imm, cols(c), N);
      epi_each(v, s, false, false, [](float a, float) { return a; });
      a0 = true;
    }
    const int sreg = a0 ? in.b : in.a;  // the side that is not r0 (r0 itself: unused)
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = epi_src(e, sreg, imm, cols(c), N);
    switch (in.op) {
      case EW_COPY: epi_each(v, s, a0, b0, [](float a, float) { return a; }); break;
      case EW_ADD: epi_each(v, s, a0, b0, [](float a, float b) { return __fadd_rn(a, b); }); break;
      case EW_SUB: epi_each(v, s, a0, b0, [](float a, float b) { return __fsub_rn(a, b); }); break;
      case EW_MUL: epi_each(v, s, a0, b0, [](float a, float b) { return __fmul_rn(a, b); }); break;
      case EW_MAX: epi_each(v, s, a0, b0, [](float a, float b) { return ew_max(a, b); }); break;
      case EW_MIN: epi_each(v, s, a0, b0, [](float a, float b) { return ew_min(a, b); }); break;
      case EW_NEG: epi_each(v, s, a0, b0, [](float a, float) { return -a; }); break;
      case EW_RELU: epi_each(v, s, a0, b0, [](float a, float) { return ew_relu(a); }); break;
      case EW_TANH: epi_each(v, s, a0, b0, [](float a, float) { return tanhf(a); }); break;
      case EW_SIGMOID: epi_each(v, s, a0, b0, [](float a, float) { return ew_sigmoid(a); }); break;
      case EW_LEAKY:
        epi_each(v, s, a0, b0, [imm](float a, float) { return ew_leaky(a, imm); });
        break;
      default: {
        float t[R * C];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) t[r * C + c] = v[r][c];
#pragma unroll 1
        for (int j = 0; j < R * C; ++j) {
          const float o = epi_src(e, sreg, imm, cols(j % C), N);
          t[j] = ew_op(in.op, a0 ? t[j] : o, b0 ? t[j] : o, imm);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) v[r][c] = t[r * C + c];
      }
    }
  }
}

// a program's instructions name known ops, registers or the immediate
inline bool ew_valid(const EwIns* ins, int n, int nmax, int out) {
  if (n < 0 || n > nmax || out < 0 || out >= EW_REGS) return false;
  for (int i = 0; i < n; ++i)
    if (ins[i].op >= EW_NOPS || ins[i].dst >= EW_REGS || ins[i].a > EW_IMM || ins[i].b > EW_IMM)
      return false;
  return true;
}

// an epilogue: a chain over r0 (every instruction writes r0 and reads r0,
// r1, r2 or the immediate; r0 the result)
inline bool epi_valid(const EpiProg& e) {
  if (!ew_valid(e.ins, e.n, EPI_MAX_INS, e.out) || e.out != 0) return false;
  for (int i = 0; i < e.n; ++i) {
    const EwIns& in = e.ins[i];
    if (in.dst != 0 || (in.a > 2 && in.a != EW_IMM) || (in.b > 2 && in.b != EW_IMM)) return false;
  }
  return true;
}

}  // namespace
