// optimizer_arena: the momentum and the Adam update of every dense float32
// parameter, ONE launch each, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/optimizer.py::momentum_arena_pallas
// (_arena_call with _momentum_kernel): v' = mu * v + g, then
// p' = p - lr * v', or with nesterov p' = p - (g + mu * v') * lr; and
// adam_arena_pallas (_arena_call with _adam_kernel):
// m1' = b1 * m1 + (1 - b1) * g, m2' = b2 * m2 + (1 - b2) * g * g,
// p' = p - lr_eff * m1' / (sqrt(m2') + eps), where the bias-corrected
// lr_eff = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow) is formed on the
// device from the beta-power tensors (the reference forms it in the op and
// passes it through SMEM).
//
// The Pallas kernel needs one flat operand, so the reference concatenates
// params, grads and velocities into arenas (flatten_arena) and slices the
// results back out (split_arena). Here one launch walks a device table of
// (p, g, state..., numel, first chunk) rows, one per parameter, and updates
// p and its state IN PLACE: the same function with no concatenation or split copies. Each
// block takes one CHUNK of one parameter, found by a binary search over the
// rows' first chunks.
//
// Numerics: explicit round-to-nearest multiplies and adds, so no FMA
// contraction separates the kernel from the per-parameter PyTorch
// expressions (ops/cuda/optimizer.py::momentum_arena_torch and
// adam_arena_torch, which evaluate them one PyTorch op at a time: every
// operation rounded once, sqrt and division IEEE-rounded); the kernel and
// its plain version agree bitwise. lr and the beta powers are read from
// their device tensors, so the step never waits on the host.
//
// Bound on the H100: bytes. Momentum reads p, g, v and writes p, v: 20
// bytes per parameter element; Adam reads p, g, m1, m2 and writes p, m1,
// m2: 28 bytes per element; against 3.35 TB/s.
//
// The C entry returns cudaGetLastError() after the launch; the caller
// uploads the table and passes its stream. The kernel allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 4096;   // elements per block (ops/cuda/optimizer.py)
constexpr int THREADS = 256;
constexpr int MOMENTUM_ROW = 5;   // p, g, v, numel, first chunk (int64)
constexpr int ADAM_ROW = 6;       // p, g, m1, m2, numel, first chunk

// This block's chunk: its table row (found by a binary search over the
// rows' first chunks) and its element range [start, end) in the row's
// parameter.
struct Span {
  const long long* row;
  long long start, end;
};

template <int ROW>
__device__ Span find_span(const long long* table, int rows) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * ROW + ROW - 1] <= chunk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long* row = table + lo * ROW;
  const long long numel = row[ROW - 2];
  const long long start = (chunk - row[ROW - 1]) * CHUNK;
  return {row, start, start + CHUNK < numel ? start + CHUNK : numel};
}

__global__ void __launch_bounds__(THREADS)
momentum_arena_kernel(const long long* __restrict__ table, int rows,
                      const float* __restrict__ lr, float mu, int nesterov) {
  const Span s = find_span<MOMENTUM_ROW>(table, rows);
  float* p = reinterpret_cast<float*>(s.row[0]);
  const float* g = reinterpret_cast<const float*>(s.row[1]);
  float* v = reinterpret_cast<float*>(s.row[2]);
  const long long start = s.start, end = s.end;
  const float lrv = *lr;
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const float gi = g[i];
    const float vn = __fadd_rn(__fmul_rn(mu, v[i]), gi);
    const float step =
        nesterov ? __fmul_rn(__fadd_rn(gi, __fmul_rn(mu, vn)), lrv)
                 : __fmul_rn(lrv, vn);
    v[i] = vn;
    p[i] = __fsub_rn(p[i], step);
  }
}

__global__ void __launch_bounds__(THREADS)
adam_arena_kernel(const long long* __restrict__ table, int rows,
                  const float* __restrict__ lr,
                  const float* __restrict__ beta1_pow,
                  const float* __restrict__ beta2_pow, float b1, float c1,
                  float b2, float c2, float eps) {
  const Span s = find_span<ADAM_ROW>(table, rows);
  float* p = reinterpret_cast<float*>(s.row[0]);
  const float* g = reinterpret_cast<const float*>(s.row[1]);
  float* m1 = reinterpret_cast<float*>(s.row[2]);
  float* m2 = reinterpret_cast<float*>(s.row[3]);
  // lr * sqrt(1 - beta2_pow) / (1 - beta1_pow), as adam_lr evaluates it
  const float lr_eff =
      __fdiv_rn(__fmul_rn(*lr, __fsqrt_rn(__fsub_rn(1.f, *beta2_pow))),
                __fsub_rn(1.f, *beta1_pow));
  for (long long i = s.start + threadIdx.x; i < s.end; i += THREADS) {
    const float gi = g[i];
    const float m1n = __fadd_rn(__fmul_rn(b1, m1[i]), __fmul_rn(c1, gi));
    const float m2n =
        __fadd_rn(__fmul_rn(b2, m2[i]), __fmul_rn(__fmul_rn(c2, gi), gi));
    const float step = __fdiv_rn(__fmul_rn(lr_eff, m1n),
                                 __fadd_rn(__fsqrt_rn(m2n), eps));
    m1[i] = m1n;
    m2[i] = m2n;
    p[i] = __fsub_rn(p[i], step);
  }
}

}  // namespace

extern "C" {

// table: [rows, 5] int64 (p, g, v, numel, first chunk) on the device;
// chunks: the total number of CHUNK blocks over all rows; lr: one float32
// on the device. Returns cudaGetLastError() (0 = success).
int momentum_arena(const long long* table, int rows, int chunks,
                   const float* lr, float mu, int nesterov, void* stream) {
  if (rows < 1 || chunks < 1) return (int)cudaErrorInvalidValue;
  momentum_arena_kernel<<<chunks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      table, rows, lr, mu, nesterov);
  return (int)cudaGetLastError();
}

// table: [rows, 6] int64 (p, g, m1, m2, numel, first chunk) on the device;
// lr, beta1_pow, beta2_pow: one float32 each on the device; c1 = 1 - b1 and
// c2 = 1 - b2 as the caller rounded them. Returns cudaGetLastError().
int adam_arena(const long long* table, int rows, int chunks, const float* lr,
               const float* beta1_pow, const float* beta2_pow, float b1,
               float c1, float b2, float c2, float eps, void* stream) {
  if (rows < 1 || chunks < 1) return (int)cudaErrorInvalidValue;
  adam_arena_kernel<<<chunks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      table, rows, lr, beta1_pow, beta2_pow, b1, c1, b2, c2, eps);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
