// optimizer_arena: the SGD, momentum and Adam updates of every dense float32
// parameter, one launch each (more only for a list longer than one launch's
// table holds), for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/optimizer.py::sgd_arena_pallas
// (_arena_call with _sgd_kernel): p' = p - lr * g; momentum_arena_pallas
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
// results back out (split_arena). Here a launch walks a table of
// (p, g, state..., numel, first chunk) rows, one per parameter, and updates
// p and its state IN PLACE: the same function with no concatenation or
// split copies. The table travels in the launch's parameter space (a
// __grid_constant__ struct of TABLE_BYTES, which needs CUDA 12.1 or later:
// sm_90 takes 32 764 bytes of kernel parameters from there), filled by the
// C entry from the caller's host columns, so a call uploads nothing and
// allocates nothing. A CHUNK of a parameter is found by a binary search
// over the rows' first chunks, read from the parameter space.
//
// Bound on the H100: bytes. SGD reads p, g and writes p: 12 bytes per
// parameter element; momentum reads p, g, v and writes p, v: 20 bytes;
// Adam reads p, g, m1, m2 and writes p, m1, m2: 28 bytes; against
// 3.35 TB/s. sgd_arena and momentum_arena are shaped for it, on one chunk
// walker (arena_chunk): a grid of CTAS_PER_SM CTAs an SM strides over the
// chunks, and each thread issues its UNROLL float4 loads of every array (p
// and g; p, v and g) together before it computes and stores (the pointers
// are __restrict__, so no load waits on an earlier store); a chunk whose
// arrays are not equally aligned to 16 bytes, and the scalar head and tail
// of one whose base or end is not, take scalar loads. adam_arena keeps one
// block a chunk and one scalar element a thread at a time.
//
// Numerics: explicit round-to-nearest multiplies and adds, so no FMA
// contraction separates the kernel from the per-parameter PyTorch
// expressions (ops/cuda/optimizer.py::sgd_arena_torch, momentum_arena_torch
// and adam_arena_torch, which evaluate them one PyTorch op at a time: every
// operation rounded once, sqrt and division IEEE-rounded); the kernel and
// its plain version agree bitwise. lr and the beta powers are read from
// their device tensors, so the step never waits on the host.
//
// The C entries return cudaGetLastError() after the launch. The kernels
// allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 4096;   // elements a chunk (ops/cuda/optimizer.py)
constexpr int THREADS = 256;
constexpr int UNROLL = CHUNK / 4 / THREADS;  // float4 pieces a thread
constexpr int CTAS_PER_SM = 4;
constexpr int SGD_ROW = 4;        // p, g, numel, first chunk (int64)
constexpr int MOMENTUM_ROW = 5;   // p, g, v, numel, first chunk
constexpr int ADAM_ROW = 6;       // p, g, m1, m2, numel, first chunk
// kernel parameter space: 32 764 bytes from CUDA 12.1 on sm_70 and later;
// the other arguments take under 64
#if CUDART_VERSION < 12010
#error "optimizer_arena.cu needs CUDA 12.1 or later (32 KB kernel parameters)"
#endif
constexpr int TABLE_BYTES = 32640;

// A launch's table: up to ROWS rows of ROW int64, by value.
template <int ROW>
struct Table {
  static constexpr int ROWS = TABLE_BYTES / (8 * ROW);
  long long v[ROWS * ROW];
};

// A chunk's table row (found by a binary search over the rows' first
// chunks) and its element range [start, end) in the row's parameter.
struct Span {
  const long long* row;
  long long start, end;
};

template <int ROW>
__device__ Span find_span(const long long* table, int rows,
                          long long chunk) {
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

// x[k] = a[k][i] for the N arrays, op(x), and the first NW arrays stored
// back: one element.
template <int N, int NW, class Op>
__device__ __forceinline__ void update_one(float* const (&a)[N], long long i,
                                           Op op) {
  float x[N];
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = a[k][i];
  op(x);
#pragma unroll
  for (int k = 0; k < NW; ++k) a[k][i] = x[k];
}

// op on each of the four lanes of the N float4s r, in place.
template <int N, class Op>
__device__ __forceinline__ void update_four(float4 (&r)[N], Op op) {
  float x[N];
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = r[k].x;
  op(x);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k].x = x[k];
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = r[k].y;
  op(x);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k].y = x[k];
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = r[k].z;
  op(x);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k].z = x[k];
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = r[k].w;
  op(x);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k].w = x[k];
}

// The elements [start, end) of N arrays (the first NW written back, the
// rest read only), each element mapped by op: the float4 body [b0, b1)
// from the first 16-byte boundary, whole float4s, empty when the arrays
// are not all equally aligned; scalar loads for the head and the tail.
// Each thread issues all its UNROLL float4 loads of every array before
// any math or store.
template <int N, int NW, class Op>
__device__ __forceinline__ void arena_chunk(float* const (&a)[N],
                                            long long start, long long end,
                                            Op op) {
  const int t = threadIdx.x;
  long long b0 = start, b1 = start;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a[0] + start);
  uintptr_t skew = 0;
#pragma unroll
  for (int k = 1; k < N; ++k)
    skew |= pa ^ reinterpret_cast<uintptr_t>(a[k] + start);
  if ((skew & 15) == 0) {
    const long long head = static_cast<long long>((16 - (pa & 15)) & 15) / 4;
    b0 = start + head < end ? start + head : end;
    b1 = b0 + ((end - b0) & ~3LL);
  }
  for (long long i = start + t; i < b0; i += THREADS)
    update_one<N, NW>(a, i, op);
  for (long long i = b1 + t; i < end; i += THREADS)
    update_one<N, NW>(a, i, op);
  const int n4 = static_cast<int>((b1 - b0) >> 2);
  float4 r[UNROLL][N];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = t + u * THREADS;
    if (i < n4) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        r[u][k] = reinterpret_cast<const float4*>(a[k] + b0)[i];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = t + u * THREADS;
    if (i < n4) {
      update_four<N>(r[u], op);
#pragma unroll
      for (int k = 0; k < NW; ++k)
        reinterpret_cast<float4*>(a[k] + b0)[i] = r[u][k];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
sgd_arena_kernel(const __grid_constant__ Table<SGD_ROW> table, int rows,
                 int chunks, const float* __restrict__ lr) {
  const float lrv = *lr;
  // x = {p, g}
  const auto op = [lrv](float (&x)[2]) {
    x[0] = __fsub_rn(x[0], __fmul_rn(lrv, x[1]));
  };
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const Span s = find_span<SGD_ROW>(table.v, rows, chunk);
    float* __restrict__ p = reinterpret_cast<float*>(s.row[0]);
    float* __restrict__ g = reinterpret_cast<float*>(s.row[1]);
    float* const a[2] = {p, g};
    arena_chunk<2, 1>(a, s.start, s.end, op);
  }
}

__global__ void __launch_bounds__(THREADS)
momentum_arena_kernel(const __grid_constant__ Table<MOMENTUM_ROW> table,
                      int rows, int chunks, const float* __restrict__ lr,
                      float mu, int nesterov) {
  const float lrv = *lr;
  // x = {p, v, g}
  const auto op = [lrv, mu, nesterov](float (&x)[3]) {
    const float gi = x[2];
    const float vn = __fadd_rn(__fmul_rn(mu, x[1]), gi);
    const float step =
        nesterov ? __fmul_rn(__fadd_rn(gi, __fmul_rn(mu, vn)), lrv)
                 : __fmul_rn(lrv, vn);
    x[1] = vn;
    x[0] = __fsub_rn(x[0], step);
  };
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const Span s = find_span<MOMENTUM_ROW>(table.v, rows, chunk);
    float* __restrict__ p = reinterpret_cast<float*>(s.row[0]);
    float* __restrict__ g = reinterpret_cast<float*>(s.row[1]);
    float* __restrict__ v = reinterpret_cast<float*>(s.row[2]);
    float* const a[3] = {p, v, g};
    arena_chunk<3, 2>(a, s.start, s.end, op);
  }
}

__global__ void __launch_bounds__(THREADS)
adam_arena_kernel(const __grid_constant__ Table<ADAM_ROW> table, int rows,
                  const float* __restrict__ lr,
                  const float* __restrict__ beta1_pow,
                  const float* __restrict__ beta2_pow, float b1, float c1,
                  float b2, float c2, float eps) {
  const Span s = find_span<ADAM_ROW>(table.v, rows, blockIdx.x);
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

// Launch `launch(table)` with the table's n rows of ROW filled from the
// caller's ROW columns of n (cols[k * n + r] is row r's k-th entry).
// Returns cudaGetLastError().
template <int ROW, class F>
int with_table(const long long* cols, int n, F launch) {
  using T = Table<ROW>;
  if (n < 1 || n > T::ROWS) return (int)cudaErrorInvalidValue;
  T t;
  for (int r = 0; r < n; ++r)
    for (int k = 0; k < ROW; ++k) t.v[r * ROW + k] = cols[k * n + r];
  launch(t);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int counts[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

}  // namespace

extern "C" {

// The most rows one launch's table holds, for rows of `width` int64.
int arena_max_rows(int width) {
  return width > 0 ? TABLE_BYTES / (8 * width) : 0;
}

// table: [4, rows] int64 columns (p, g, numel, first chunk) in host memory,
// laid out as rows in the launch; chunks: the number of CHUNK pieces over
// all rows; lr: one float32 on the device. Returns cudaGetLastError()
// (0 = success).
int sgd_arena(const long long* table, int rows, int chunks, const float* lr,
              void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int max_grid = sm_count() * CTAS_PER_SM;
  const int grid = chunks < max_grid ? chunks : max_grid;
  return with_table<SGD_ROW>(table, rows, [&](const Table<SGD_ROW>& t) {
    sgd_arena_kernel<<<grid, THREADS, 0, s>>>(t, rows, chunks, lr);
  });
}

// table: [5, rows] int64 columns (p, g, v, numel, first chunk) in host
// memory; otherwise as sgd_arena. Returns cudaGetLastError().
int momentum_arena(const long long* table, int rows, int chunks,
                   const float* lr, float mu, int nesterov, void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int max_grid = sm_count() * CTAS_PER_SM;
  const int grid = chunks < max_grid ? chunks : max_grid;
  return with_table<MOMENTUM_ROW>(
      table, rows, [&](const Table<MOMENTUM_ROW>& t) {
        momentum_arena_kernel<<<grid, THREADS, 0, s>>>(t, rows, chunks, lr,
                                                       mu, nesterov);
      });
}

// table: [6, rows] int64 columns (p, g, m1, m2, numel, first chunk) in host
// memory; lr, beta1_pow, beta2_pow: one float32 each on the device; c1 = 1 - b1 and
// c2 = 1 - b2 as the caller rounded them. Returns cudaGetLastError().
int adam_arena(const long long* table, int rows, int chunks, const float* lr,
               const float* beta1_pow, const float* beta2_pow, float b1,
               float c1, float b2, float c2, float eps, void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_table<ADAM_ROW>(table, rows, [&](const Table<ADAM_ROW>& t) {
    adam_arena_kernel<<<chunks, THREADS, 0, s>>>(
        t, rows, lr, beta1_pow, beta2_pow, b1, c1, b2, c2, eps);
  });
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
