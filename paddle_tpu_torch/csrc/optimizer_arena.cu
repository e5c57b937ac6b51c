// optimizer_arena: the momentum update of every dense float32 parameter in
// ONE launch, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/optimizer.py::momentum_arena_pallas
// (_arena_call with _momentum_kernel): v' = mu * v + g, then
// p' = p - lr * v', or with nesterov p' = p - (g + mu * v') * lr.
//
// The Pallas kernel needs one flat operand, so the reference concatenates
// params, grads and velocities into arenas (flatten_arena) and slices the
// results back out (split_arena). Here one launch walks a device table of
// (p, g, v, numel, first chunk) rows, one per parameter, and updates p and
// v IN PLACE: the same function with no concatenation or split copies. Each
// block takes one CHUNK of one parameter, found by a binary search over the
// rows' first chunks.
//
// Numerics: explicit round-to-nearest multiplies and adds, so no FMA
// contraction separates the kernel from the per-parameter PyTorch
// expression (ops/cuda/optimizer.py::momentum_arena_torch); the two agree
// bitwise. lr is read from its device tensor, so the step never waits on the
// host.
//
// Bound on the H100: bytes. Each element reads p, g, v and writes p, v:
// 20 bytes per parameter element against 3.35 TB/s.
//
// The C entry returns cudaGetLastError() after the launch; the caller
// uploads the table and passes its stream. The kernel allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 4096;   // elements per block (ops/cuda/optimizer.py)
constexpr int THREADS = 256;
constexpr int ROW = 5;        // p, g, v, numel, first chunk (int64 each)

__global__ void __launch_bounds__(THREADS)
momentum_arena_kernel(const long long* __restrict__ table, int rows,
                      const float* __restrict__ lr, float mu, int nesterov) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * ROW + 4] <= chunk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long* row = table + lo * ROW;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  float* v = reinterpret_cast<float*>(row[2]);
  const long long numel = row[3];
  const long long start = (chunk - row[4]) * CHUNK;
  const long long end = start + CHUNK < numel ? start + CHUNK : numel;
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

}  // namespace

extern "C" {

// table: [rows, 5] int64 on the device; chunks: the total number of CHUNK
// blocks over all rows; lr: one float32 on the device. Returns
// cudaGetLastError() (0 = success).
int momentum_arena(const long long* table, int rows, int chunks,
                   const float* lr, float mu, int nesterov, void* stream) {
  if (rows < 1 || chunks < 1) return (int)cudaErrorInvalidValue;
  momentum_arena_kernel<<<chunks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      table, rows, lr, mu, nesterov);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
