// ctc: the CTC alpha recurrence (the loss) and its backward, ONE launch
// each, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/ctc.py::ctc_alpha_pallas (kernel
// _ctc_alpha_kernel: one program per batch row, alpha resident across all
// T steps, as warp-ctc keeps it in shared memory) and the backward the
// reference takes as jax.vjp of its scan (ops/ctc_ops.py:155).
//
// Forward, per row (e [T, Sp] are the log-probabilities at the
// blank-interleaved labels, -1e30 in the padding):
//   alpha_t[s] = valid[s] ? lae(lae(a[s], a[s-1]), skip[s] ? a[s-2] : NEG)
//                           + e[t][s] : NEG      (a = alpha_{t-1})
// for t = 1 .. x_len-1, and loss = -lae(alpha[2U'], alpha[2U'-1]) at
// t = x_len-1 (U' the row's label length; final0 when x_len is 1). lae is
// jnp.logaddexp written as the reference computes it: max(a, b) +
// log1p(exp(-|a - b|)), a + b where a - b is nan, every operation rounded
// explicitly.
//
// Backward, per row, from logp and the labels alone: the extended labels,
// the masks and alpha_0 are formed in shared memory (the forward takes them
// from torch glue, as the Pallas kernel does), alpha_0..alpha_{x_len-1} are
// recomputed into a [T, Sp] scratch through the forward's code, then the
// scan's adjoint is walked back from the loss: logaddexp's gradient is
// jax's custom jvp, g*exp(x - out) for each operand, so the backward is
// autograd of the scan (not the alpha-beta formula; the two differ in
// rounding, and where a row is too short for its labels every state is
// -1e30, each weight is 1 and the scan's gradient grows threefold a step,
// as the reference's does). At each t the cotangent of the emissions is
// scattered onto the classes (dlogp[t][c] = sum of de[t][s] over z[s] == c,
// in increasing s) and taken through the log-softmax: dlogits = dlogp -
// exp(logp) * sum_c dlogp. Rows t >= x_len get zeros.
//
// Bound on the H100: neither bytes nor operations. The CTC model's batch
// (b 64, T <= 200, Sp 104, C 29) reads ~5 MB and runs ~10^7 exp/log1p;
// each row is a chain of T dependent steps with a block barrier each, so
// the serial chain bounds it. One block per row runs the rows in parallel
// on 64 SMs.
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and scratch and passes its stream.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;

__device__ __forceinline__ float lae(float a, float b) {
  const float d = __fsub_rn(a, b);
  if (isnan(d)) return __fadd_rn(a, b);
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(d))));
}

// one step of the recurrence: n[s] from a = alpha_{t-1}; emit(s) is the
// row's log-probability at label position s, read only where s is valid
template <typename Emit>
__device__ void alpha_step(const float* a, float* n, const float* cs,
                           const float* sv, int sp, Emit emit) {
  for (int s = threadIdx.x; s < sp; s += THREADS) {
    const float a1 = s >= 1 ? a[s - 1] : NEG;
    const float a2 = (s >= 2 && cs[s] > 0.f) ? a[s - 2] : NEG;
    const float m = lae(lae(a[s], a1), a2);
    n[s] = sv[s] > 0.f ? __fadd_rn(m, emit(s)) : NEG;
  }
}

__device__ __forceinline__ float final_of(const float* a, int ylen) {
  const int last = 2 * ylen;
  return lae(a[last], ylen > 0 ? a[last - 1] : NEG);
}

__global__ void __launch_bounds__(THREADS)
ctc_alpha_kernel(const float* __restrict__ e,
                 const float* __restrict__ alpha0,
                 const float* __restrict__ final0,
                 const float* __restrict__ can_skip,
                 const float* __restrict__ s_valid,
                 const int* __restrict__ x_lens,
                 const int* __restrict__ y_lens, float* loss, int T,
                 int sp) {
  extern __shared__ float smem[];
  float* al = smem;                    // [2][sp] alpha, double-buffered
  const int row = blockIdx.x;
  const float* er = e + (size_t)row * T * sp;
  const float* cs = can_skip + (size_t)row * sp;
  const float* sv = s_valid + (size_t)row * sp;
  const int xlen = x_lens[row], ylen = y_lens[row];
  for (int s = threadIdx.x; s < sp; s += THREADS)
    al[s] = alpha0[(size_t)row * sp + s];
  __syncthreads();
  int cur = 0;
  const int tend = min(T, xlen);
  for (int t = 1; t < tend; ++t) {
    alpha_step(al + cur * sp, al + (1 - cur) * sp, cs, sv, sp,
               [&](int s) { return er[(size_t)t * sp + s]; });
    __syncthreads();
    cur = 1 - cur;
  }
  if (threadIdx.x == 0) {
    // the scan sets final at t = x_len - 1 when 1 <= t < T
    const float fin = (xlen >= 2 && xlen <= T) ? final_of(al + cur * sp, ylen)
                                               : final0[row];
    loss[row] = -fin;
  }
}

// dlogits[t][c] = dl[c] - exp(logp[t][c]) * sum_c dl[c], where dl[c] is
// the sum of de[s] over the label positions s with z[s] == c
__device__ void emit_grad(const float* de, const int* zs, float* dl,
                          float* tot, const float* lpt, float* out, int sp,
                          int C) {
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < sp; ++s)
      if (zs[s] == c) acc = __fadd_rn(acc, de[s]);
    dl[c] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum = __fadd_rn(sum, dl[c]);
    *tot = sum;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS)
    out[c] = __fsub_rn(dl[c], __fmul_rn(expf(lpt[c]), *tot));
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
ctc_bwd_kernel(const float* __restrict__ logp,
               const long long* __restrict__ labels,
               const int* __restrict__ x_lens,
               const int* __restrict__ y_lens,
               const float* __restrict__ dloss, float* alpha,
               float* dlogits, int T, int sp, int C, int U, int blank) {
  extern __shared__ float smem[];
  float* g = smem;             // [sp] cotangent of alpha_t
  float* g0 = g + sp;          // [sp] its part through a[s]
  float* g1 = g0 + sp;         // [sp] ... through a[s-1] (from s)
  float* g2 = g1 + sp;         // [sp] ... through a[s-2] (from s)
  float* de = g2 + sp;         // [sp] cotangent of the emissions at t
  float* cs = de + sp;         // [sp] the skip mask
  float* sv = cs + sp;         // [sp] the valid positions
  float* dl = sv + sp;         // [C]  cotangent of logp[t]
  float* tot = dl + C;         // [1]
  int* zs = reinterpret_cast<int*>(tot + 1);   // [sp] extended labels
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* lp = logp + (size_t)row * T * C;
  const long long* lab = labels + (size_t)row * U;
  float* A = alpha + (size_t)row * T * sp;
  float* out = dlogits + (size_t)row * T * C;
  const int xlen = x_lens[row], ylen = y_lens[row], last = 2 * ylen;
  // the step whose alpha gives the loss; -1 when no step does
  const int tf = (xlen >= 1 && xlen <= T) ? xlen - 1 : -1;
  for (size_t i = (size_t)(tf + 1) * C + tid; i < (size_t)T * C;
       i += THREADS)
    out[i] = 0.f;
  if (tf < 0) return;

  // the extended labels (blank, l_1, blank, ..., l_U, blank; blank in the
  // padding up to sp), the positions below 2U'+1 valid (reference
  // ctc_ops.py:48-55)
  for (int s = tid; s < sp; s += THREADS) {
    zs[s] = (s & 1) && s < 2 * U + 1 ? (int)lab[s >> 1] : blank;
    sv[s] = s <= last ? 1.f : 0.f;
    g[s] = 0.f;
  }
  __syncthreads();
  // a label may skip the blank before it when it differs from the label
  // before that; alpha_0 holds logp[0] at the blank and the first label
  // (reference :60-64)
  for (int s = tid; s < sp; s += THREADS) {
    cs[s] = ((s & 1) && s >= 2 && zs[s] != zs[s - 2]) ? 1.f : 0.f;
    A[s] = (s == 0 || (s == 1 && ylen > 0)) ? lp[zs[s]] : NEG;
  }
  __syncthreads();
  for (int t = 1; t <= tf; ++t) {
    const float* lpt = lp + (size_t)t * C;
    alpha_step(A + (size_t)(t - 1) * sp, A + (size_t)t * sp, cs, sv, sp,
               [&](int s) { return lpt[zs[s]]; });
    __syncthreads();
  }

  // d loss / d alpha_tf: loss = -lae(alpha[last], alpha[last - 1])
  if (tid == 0) {
    const float* a = A + (size_t)tf * sp;
    const float fin = final_of(a, ylen);
    const float gf = -dloss[row];
    g[last] = __fmul_rn(gf, expf(__fsub_rn(a[last], fin)));
    if (ylen > 0)
      g[last - 1] = __fmul_rn(gf, expf(__fsub_rn(a[last - 1], fin)));
  }
  __syncthreads();

  for (int t = tf; t >= 1; --t) {
    const float* a = A + (size_t)(t - 1) * sp;
    for (int s = tid; s < sp; s += THREADS) {
      const float gn = sv[s] > 0.f ? g[s] : 0.f;
      const bool has1 = s >= 1, has2 = s >= 2 && cs[s] > 0.f;
      const float a1 = has1 ? a[s - 1] : NEG;
      const float a2 = has2 ? a[s - 2] : NEG;
      const float inner = lae(a[s], a1);
      const float merged = lae(inner, a2);
      const float gi = __fmul_rn(gn, expf(__fsub_rn(inner, merged)));
      de[s] = gn;
      g0[s] = __fmul_rn(gi, expf(__fsub_rn(a[s], inner)));
      g1[s] = has1 ? __fmul_rn(gi, expf(__fsub_rn(a1, inner))) : 0.f;
      g2[s] = has2 ? __fmul_rn(gn, expf(__fsub_rn(a2, merged))) : 0.f;
    }
    __syncthreads();
    for (int s = tid; s < sp; s += THREADS) {
      float v = g0[s];
      if (s + 1 < sp) v = __fadd_rn(v, g1[s + 1]);
      if (s + 2 < sp) v = __fadd_rn(v, g2[s + 2]);
      g[s] = v;
    }
    emit_grad(de, zs, dl, tot, lp + (size_t)t * C, out + (size_t)t * C, sp,
              C);
  }
  // t = 0: alpha0[0] = logp[0][blank], alpha0[1] = logp[0][z[1]] (with a
  // label), both where valid
  for (int s = tid; s < sp; s += THREADS)
    de[s] = (sv[s] > 0.f && (s == 0 || (s == 1 && ylen > 0))) ? g[s] : 0.f;
  emit_grad(de, zs, dl, tot, lp, out, sp, C);
}

}  // namespace

extern "C" {

// e [b, T, sp], alpha0, can_skip, s_valid [b, sp], final0 [b, 1] float32
// and x_lens, y_lens [b] int32 in; loss [b, 1] out.
int ctc_alpha_fwd(const float* e, const float* alpha0, const float* final0,
                  const float* can_skip, const float* s_valid,
                  const int* x_lens, const int* y_lens, float* loss, int b,
                  int T, int sp, void* stream) {
  if (b < 1 || T < 1 || sp < 1) return (int)cudaErrorInvalidValue;
  ctc_alpha_kernel<<<b, THREADS, 2 * sp * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      e, alpha0, final0, can_skip, s_valid, x_lens, y_lens, loss, T, sp);
  return (int)cudaGetLastError();
}

// logp [b, T, C] float32, labels [b, U] int64, x_lens, y_lens [b] int32
// and dloss [b] float32 in; dlogits [b, T, C] out; alpha [b, T, sp]
// scratch (sp >= 2U+1).
int ctc_loss_bwd(const float* logp, const long long* labels,
                 const int* x_lens, const int* y_lens, const float* dloss,
                 float* alpha, float* dlogits, int b, int T, int sp, int C,
                 int U, int blank, void* stream) {
  if (b < 1 || T < 1 || C < 1 || U < 0 || sp < 2 * U + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (8 * (size_t)sp + C + 1) * sizeof(float);
  ctc_bwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      logp, labels, x_lens, y_lens, dloss, alpha, dlogits, T, sp, C, U,
      blank);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
