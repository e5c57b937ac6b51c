// embedding_sgd: the sparse SGD step of an embedding table, in place, with
// the merge of duplicate rows fused in, ONE launch, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/embedding.py::embedding_sgd_pallas (kernel
// _row_sgd_kernel, w[row] -= lr * vals[i] for each MERGED row, one row per
// grid step) together with the merge the reference runs before it in jnp
// (core/sparse.py::merge_rows: stable sort, segment-sum, sentinel padding).
// For each unique row r < nrows among the entries: w[r] = w[r] - lr * s_r,
// where s_r sums the values of r's entries from zero in the entries' order.
// Entries with a row >= nrows (sentinels: padded LoD positions, merge
// padding) or < 0 touch nothing, and no other row of the table changes.
//
// The wrapper (ops/cuda/embedding.py) sorts the rows stably first (the
// reference sorts outside its kernel too) and passes the sorted rows and
// the permutation; the values stay where they are and are read through it.
// One warp per sorted entry: a warp whose entry heads a run of equal rows
// walks the run in order, one entry at a time, and sums it in registers,
// then writes the row once; every other warp exits. Each lane owns VEC
// consecutive columns of a 32 * VEC column stripe (VEC 1 at D 32, float2
// loads from D 64). Runs hold unique rows, so no two warps write one row: no
// atomics, no ordering of sentinels (the Pallas kernel orders them first for
// its sequential grid), and the same bits on every run.
//
// Numerics: the run's sum is formed as merge_rows forms it (from 0, one
// round-to-nearest add per entry, in the stable-sorted order, which is the
// entries' own order within a run), then one rounded multiply by lr and one
// rounded subtract (__fmul_rn / __fsub_rn, no FMA contraction), as the plain
// version (ops/cuda/embedding.py::embedding_sgd_torch) evaluates it one
// PyTorch op at a time: the two agree bitwise. lr is read from its device
// tensor, so the step never waits on the host.
//
// Bound on the H100: bytes. The function reads and writes each unique row
// (8 bytes per element) and reads each entry's values (4 per element) and
// row index (8 bytes); against 3.35 TB/s. The sort and the permutation are
// the wrapper's overhead on top. A long run (a hot id) is walked by one
// warp, a dependent position and value load per entry: at CTR scale that
// warp sets the time, and staging or splitting runs is open work.
//
// The C entry returns cudaGetLastError() after the launch. The kernel
// allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // entries (warps) per block
constexpr int THREADS = 32 * WARPS;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  float v[1];
  __device__ static Vec load(const float* p) { return {{*p}}; }
};
template <>
struct Vec<2> {
  float v[2];
  __device__ static Vec load(const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    return {{x.x, x.y}};
  }
};

template <int VEC>
__global__ void __launch_bounds__(THREADS)
embedding_sgd_kernel(float* __restrict__ w, long long nrows, int dim,
                     const long long* __restrict__ srows,
                     const long long* __restrict__ order,
                     const float* __restrict__ vals, long long n,
                     const float* __restrict__ lr) {
  const long long e =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n) return;
  const long long row = srows[e];
  if (row < 0 || row >= nrows || (e > 0 && srows[e - 1] == row)) return;
  // the run's end: the first later entry of another row, 32 checked at a
  // time across the warp
  long long end = e + 1;
  for (;;) {
    const long long i = end + lane;
    const unsigned same =
        __ballot_sync(0xffffffffu, i < n && srows[i] == row);
    if (same != 0xffffffffu) {
      end += __ffs(~same) - 1;
      break;
    }
    end += 32;
  }
  const float lrv = *lr;
  float* wr = w + row * dim;
  for (int c = lane * VEC; c < dim; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (long long i = e; i < end; ++i) {
      const Vec<VEC> x = Vec<VEC>::load(vals + order[i] * dim + c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], x.v[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      wr[c + k] = __fsub_rn(wr[c + k], __fmul_rn(lrv, acc[k]));
  }
}

}  // namespace

extern "C" {

// w: [nrows, dim] float32, contiguous, updated in place; srows: [n] int64
// rows sorted stably; order: [n] int64, srows[i] = rows[order[i]]; vals:
// [n, dim] float32 in the entries' original order; lr: one float32 on the
// device; vec: 1 or 2 columns per lane (dim and both pointers aligned to
// it). Returns cudaGetLastError() (0 = success).
int embedding_sgd(float* w, long long nrows, int dim, const long long* srows,
                  const long long* order, const float* vals, long long n,
                  const float* lr, int vec, void* stream) {
  if (n < 1 || dim < 1 || dim % vec != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1:
      embedding_sgd_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(
          w, nrows, dim, srows, order, vals, n, lr);
      break;
    case 2:
      embedding_sgd_kernel<2><<<(unsigned)blocks, THREADS, 0, s>>>(
          w, nrows, dim, srows, order, vals, n, lr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
