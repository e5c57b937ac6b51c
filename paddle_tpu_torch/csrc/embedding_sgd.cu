// embedding_sgd: the sparse SGD step of an embedding table, in place, with
// the merge of duplicate rows fused in, for Hopper (sm_90a).
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
// Bound on the H100: bytes. The function reads and writes each unique row
// (8 bytes per element) and reads each entry's values (4 per element) and
// row index (8 bytes), against 3.35 TB/s. What holds a kernel back from it
// is latency, not bandwidth: a run of equal rows is a chain of adds that
// must stay in the entries' order, and walking it one entry at a time costs
// a dependent index load and value load per entry (a hot id's 2 339 entries
// at the CTR shape took 0.74 ms that way): each dependent round trip to
// device memory is hundreds of cycles. The design keeps the order of the
// adds and takes the loads off the chain:
//
// - Runs sorted, one CTA per window of the sorted entries (embedding_sgd_
//   sorted: WINDOW entries, fewer where the rows are wide). The C entry
//   first sorts the rows stably with the CUDA toolkit's library radix sort
//   (cub; the reference sorts outside its kernel too): keys of the rows
//   clamped to [-1, nrows] plus 1, unsigned, 4 bytes where they fit,
//   sorted over only the bits that nrows + 1 takes, with the entry indices
//   as values. So the sort is a few launches from the one host call, into
//   one workspace the wrapper allocates, in place of a torch.sort with its
//   own clamp, cast, index fill and allocations. The values stay where
//   they are and are read through the permutation. The CTA finds the run
//   heads in its window and compacts them, with their rows, in order in
//   shared memory. A run that starts in the window belongs to the CTA even
//   where it runs past the window's end (one warp finds its end by a
//   32-way search over the sorted keys); a run that starts before the
//   window is left to the CTA that holds its head. So no two CTAs write one
//   row: no atomics.
// - The window's value rows are copied into shared memory at once
//   (cp.async, every row in flight together). Each (run, column) of a run
//   that ends in the window is then one thread's item: it adds the run's
//   column down the staged rows in entry order, and a thread takes ITEMS
//   items at a time with their table loads issued together. So a window
//   costs a few round trips, whatever its runs.
// - The run that crosses the window's end is the whole CTA's when it is
//   long: its permutation entries go to shared memory IDX_CAP at a time,
//   then its value rows stream through a ring of NSTAGE stages (cp.async),
//   the next stages loading while the column threads add this one. A short
//   one is one warp's walk (permutation entries 32 at a time, GROUP value
//   loads in flight). Rows wider than CTA_MAX_DIM are not staged: each run
//   is one warp's walk.
// - A call of at most FUSED_MAX entries (word2vec's step has 128) is ONE
//   launch of one CTA (embedding_sgd_fused): it sorts (row, entry) keys in
//   shared memory with a bitonic network, which gives exactly the stable
//   order, then runs the same window code over them. No library sort, no
//   allocation, no second launch.
//
// Shapes: word2vec's step (128 entries, D 32) takes the fused path, rows
// staged 512 a window; phase 10's CTR call (106 496 entries, D 64) the
// sorted path with 4-byte keys of 20 bits, 256-entry windows, its
// 2 339-entry hot run through the ring. Copies are 16 bytes where D is a
// multiple of 4 and the values are 16-byte aligned, else 8 or 4 (VEC). What is left bounds the
// sorted launch: a hot run's rows all pass through one SM, whose copies
// (and the one add chain per column) set the launch's time.
//
// Numerics: the run's sum is formed as merge_rows forms it (from 0, one
// round-to-nearest add per entry, in the stable-sorted order, which is the
// entries' own order within a run), then one rounded multiply by lr and one
// rounded subtract (__fmul_rn / __fsub_rn, no FMA contraction), as the plain
// version (ops/cuda/embedding.py::embedding_sgd_torch) evaluates it one
// PyTorch op at a time: the two agree bitwise. lr is read from its device
// tensor, so the step never waits on the host.
//
// The C entries return the first error (cudaGetLastError() after the
// launches). Nothing allocates: the sorted path's keys, permutation and
// sort storage live in the caller's workspace (embedding_sgd_workspace).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

using Key64 = unsigned long long;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;        // sorted path: threads per CTA
constexpr int WINDOW = 256;         // sorted path: most entries a CTA owns
constexpr int FUSED_THREADS = 512;  // the one-launch path's single CTA
constexpr int FUSED_MAX = 1024;     // its entry limit (ops/cuda/embedding.py)
constexpr int IDX_BITS = 10;        // log2(FUSED_MAX): a key's entry field
constexpr int LONG_RUN = 32;        // a longer crossing run takes the CTA
constexpr int GROUP = 8;            // value loads a warp issues together
constexpr int ITEMS = 8;            // (run, column) items a thread batches
constexpr int STAGE_FLOATS = 4096;  // 16 KB a ring stage
constexpr int STAGE_ROWS = 128;     // most rows a stage holds
constexpr int NSTAGE = 4;
constexpr int RING_FLOATS = NSTAGE * STAGE_FLOATS;
constexpr int IDX_CAP = 1024;       // entry indices staged at a time
constexpr int STAGED_BYTES = RING_FLOATS * 4 + IDX_CAP * 4;
constexpr int CTA_MAX_DIM = 1024;   // widest row the ring stages
constexpr int KEYS_BYTES = FUSED_MAX * 8;
constexpr unsigned long long SENT = (1ull << (64 - IDX_BITS)) - 1;
static_assert(NSTAGE >= 2, "NSTAGE");
// a stage's 16-byte pieces split evenly over either CTA's threads
static_assert(STAGE_FLOATS % (4 * THREADS) == 0 &&
                  STAGE_FLOATS % (4 * FUSED_THREADS) == 0,
              "STAGE_FLOATS");

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
template <>
struct Vec<4> {
  float v[4];
  __device__ static Vec load(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    return {{x.x, x.y, x.z, x.w}};
  }
};

template <int BYTES>
__device__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a + col[0] + col[stride] + ... over n values, one rounded add each in
// order, the loads issued U at a time ahead of their adds (a shared-memory
// load's latency would otherwise sit in every link of the chain).
__device__ float column_sum(float a, const float* col, int stride, int n) {
  constexpr int U = 16;
  int r = 0;
  for (; r + U <= n; r += U) {
    float x[U];
#pragma unroll
    for (int q = 0; q < U; ++q) x[q] = col[(r + q) * stride];
#pragma unroll
    for (int q = 0; q < U; ++q) a = __fadd_rn(a, x[q]);
  }
  for (; r < n; ++r) a = __fadd_rn(a, col[r * stride]);
  return a;
}

// The sorted path's entries: sorted keys (each row clamped to [-1, nrows],
// plus 1, as an unsigned K: make_keys) and the stable permutation.
template <typename K>
struct SortedSrc {
  const K* __restrict__ keys;
  const long long* __restrict__ order;
  __device__ long long row(long long i) const {
    return static_cast<long long>(keys[i]) - 1;
  }
  __device__ long long entry(long long i) const { return order[i]; }
};

// The fused path's entries: (row << IDX_BITS | entry) keys sorted in shared
// memory; a sentinel or negative row is SENT, a row past any table.
struct SharedSrc {
  const unsigned long long* keys;
  __device__ long long row(long long i) const {
    return static_cast<long long>(keys[i] >> IDX_BITS);
  }
  __device__ long long entry(long long i) const {
    return static_cast<long long>(keys[i] & ((1ull << IDX_BITS) - 1));
  }
};

// One warp sums the run [s, e) of row `row` from device memory and writes
// the row: the run's permutation entries 32 at a time in one load, handed
// out by shuffles, GROUP value loads issued before their adds.
template <int VEC, class Src>
__device__ void warp_run(const Src& src, long long s, long long e,
                         long long row, float* __restrict__ w, int dim,
                         const float* __restrict__ vals, float lrv) {
  const int lane = threadIdx.x & 31;
  float* wr = w + row * dim;
  for (int base = 0; base < dim; base += 32 * VEC) {
    const int c = base + lane * VEC;
    const bool on = c < dim;
    float acc[VEC], wv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc[k] = 0.f;
      if (on) wv[k] = wr[c + k];
    }
    for (long long g0 = s; g0 < e; g0 += 32) {
      const int cnt = static_cast<int>(e - g0 < 32 ? e - g0 : 32);
      const long long mine = lane < cnt ? src.entry(g0 + lane) : 0;
      for (int j0 = 0; j0 < cnt; j0 += GROUP) {
        Vec<VEC> x[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const long long id = __shfl_sync(FULL, mine, (j0 + j) & 31);
          if (on && j0 + j < cnt) x[j] = Vec<VEC>::load(vals + id * dim + c);
        }
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (on && j0 + j < cnt)
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[k] = __fadd_rn(acc[k], x[j].v[k]);
      }
    }
    if (on)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        wr[c + k] = __fsub_rn(wv[k], __fmul_rn(lrv, acc[k]));
  }
}

// The whole CTA (NT threads) sums the run [s, e) and writes the row. The
// run's permutation entries go to shared memory IDX_CAP at a time (one
// round of coalesced loads), then its value rows stream through the ring:
// while the column threads add one stage, the copies of the next NSTAGE - 1
// are in flight. Every thread of the CTA calls it.
template <int VEC, int NT, class Src>
__device__ void cta_run(const Src& src, long long s, long long e,
                        long long row, float* __restrict__ w, int dim,
                        const float* __restrict__ vals, float lrv,
                        float* ring, int* sidx) {
  constexpr int MAXC = CTA_MAX_DIM / NT;  // columns a thread adds
  const int tid = threadIdx.x;
  const int gpr = dim / VEC;  // granules a row
  const int rows = STAGE_FLOATS / dim < STAGE_ROWS ? STAGE_FLOATS / dim
                                                   : STAGE_ROWS;
  // the granules (16, 8 or 4 bytes) this thread copies into every stage,
  // as row << 16 | piece, -1 for none
  constexpr int MAXG = STAGE_FLOATS / VEC / NT;
  int pk[MAXG];
#pragma unroll
  for (int m = 0; m < MAXG; ++m) {
    const int g = tid + m * NT;
    pk[m] = g < rows * gpr ? (g / gpr) << 16 | (g % gpr) : -1;
  }
  float* wr = w + row * dim;
  float acc[MAXC], wv[MAXC];
#pragma unroll
  for (int m = 0; m < MAXC; ++m) {
    acc[m] = 0.f;
    if (tid + m * NT < dim) wv[m] = wr[tid + m * NT];
  }
  for (long long s0 = s; s0 < e; s0 += IDX_CAP) {
    const int len = static_cast<int>(e - s0 < IDX_CAP ? e - s0 : IDX_CAP);
    __syncthreads();  // the ring and sidx are free
    for (int i = tid; i < len; i += NT)
      sidx[i] = static_cast<int>(src.entry(s0 + i));
    __syncthreads();
    const int nch = (len + rows - 1) / rows;
    auto issue = [&](int ch) {
      float* st = ring + (ch % NSTAGE) * STAGE_FLOATS;
#pragma unroll
      for (int m = 0; m < MAXG; ++m) {
        const int r = pk[m] >> 16, cg = pk[m] & 0xffff, k = ch * rows + r;
        if (pk[m] >= 0 && k < len)
          cp_async<4 * VEC>(st + (r * gpr + cg) * VEC,
                            vals + static_cast<long long>(sidx[k]) * dim +
                                cg * VEC);
      }
    };
    for (int ch = 0; ch < NSTAGE - 1; ++ch) {
      if (ch < nch) issue(ch);
      cp_async_commit();
    }
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    for (int ch = 0; ch < nch; ++ch) {
      // stage (ch - 1) % NSTAGE was added in the last pass: refill it
      if (ch + NSTAGE - 1 < nch) issue(ch + NSTAGE - 1);
      cp_async_commit();
      const float* st = ring + (ch % NSTAGE) * STAGE_FLOATS;
      const int n = len - ch * rows < rows ? len - ch * rows : rows;
#pragma unroll
      for (int m = 0; m < MAXC; ++m) {
        const int c = tid + m * NT;
        if (c < dim) acc[m] = column_sum(acc[m], st + c, dim, n);
      }
      cp_async_wait<NSTAGE - 2>();  // stage ch + 1 has landed
      __syncthreads();
    }
  }
#pragma unroll
  for (int m = 0; m < MAXC; ++m) {
    const int c = tid + m * NT;
    if (c < dim) wr[c] = __fsub_rn(wv[m], __fmul_rn(lrv, acc[m]));
  }
}

// Update every run whose head lies in the sorted entries [a, b) of n (a
// window). Staged (ring != null): the window's value rows
// are copied into the ring at once, every (run, column) item of a run that
// ends in the window is summed from there by one thread, ITEMS at a time
// with their table loads issued together, and the run that crosses b, if
// any, is the whole CTA's (or one warp's, when short). Not staged (rows
// wider than CTA_MAX_DIM): each run is one warp's walk. Every thread of
// the CTA calls it; the caller syncs before the next window.
template <int VEC, int NT, class Src>
__device__ void update_window(const Src& src, long long a, long long b,
                              long long n, long long nrows,
                              float* __restrict__ w, int dim,
                              const float* __restrict__ vals, float lrv,
                              float* ring, int* sidx, int* heads,
                              long long* hrows) {
  constexpr int NW = NT / 32;
  __shared__ int wcount[NW];
  __shared__ long long last_end;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool staged = ring != nullptr;
  // the run heads in order, with their rows: p heads a run if p == 0 or
  // its row differs from the entry before it; and the window's entries
  int count = 0;
  for (long long base = a; base < b; base += NT) {
    const long long p = base + tid;
    const long long r = p < b ? src.row(p) : 0;
    const bool f = p < b && (p == 0 || r != src.row(p - 1));
    if (staged && p < b) sidx[p - a] = static_cast<int>(src.entry(p));
    const unsigned m = __ballot_sync(FULL, f);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = count, total = 0;
    for (int i = 0; i < NW; ++i) {
      if (i < warp) off += wcount[i];
      total += wcount[i];
    }
    if (f) {
      off += __popc(m & ((1u << lane) - 1));
      heads[off] = static_cast<int>(p - a);
      hrows[off] = r;
    }
    __syncthreads();
    count += total;
  }
  if (count == 0) return;  // the window lies inside a run headed before it
  if (staged) {
    const int gpr = dim / VEC;
    const int total = static_cast<int>(b - a) * gpr;
    for (int g = tid; g < total; g += NT) {
      const int r = g / gpr, cg = g - r * gpr;
      cp_async<4 * VEC>(ring + g * VEC,
                        vals + static_cast<long long>(sidx[r]) * dim +
                            cg * VEC);
    }
    cp_async_commit();
  }
  // the end of the last run, which may cross b: a 32-way search over the
  // sorted keys for the first entry past its row, while the rows load
  if (warp == 0) {
    const long long k = hrows[count - 1];
    long long lo = b - 1, hi = n;
    if (k < 0 || k >= nrows) hi = b;  // a sentinel run: nothing to write
    while (hi - lo > 1) {
      const long long span = hi - lo - 1;
      const long long q = lo + 1 + span * lane / 32;
      const int c = __popc(__ballot_sync(FULL, src.row(q) == k));
      if (c == 0) {
        hi = lo + 1;
      } else {
        if (c < 32) hi = lo + 1 + span * c / 32;
        lo = lo + 1 + span * (c - 1) / 32;
      }
    }
    if (lane == 0) last_end = hi;
  }
  if (staged) cp_async_wait<0>();
  __syncthreads();
  const long long end_last = last_end;
  const bool crosses = end_last > b;
  const int inside = crosses ? count - 1 : count;
  if (staged) {
    const int items = inside * dim;
    const int tail = static_cast<int>(end_last - a);
    for (int i0 = 0; i0 < items; i0 += NT * ITEMS) {
      float wv[ITEMS];
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        const int i = i0 + q * NT + tid;
        if (i < items) {
          const int j = i / dim;
          const long long r = hrows[j];
          if (r >= 0 && r < nrows) wv[q] = w[r * dim + (i - j * dim)];
        }
      }
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        const int i = i0 + q * NT + tid;
        if (i < items) {
          const int j = i / dim, c = i - j * dim;
          const long long r = hrows[j];
          if (r >= 0 && r < nrows) {
            const int k = heads[j], e = j + 1 < count ? heads[j + 1] : tail;
            const float acc = column_sum(0.f, ring + k * dim + c, dim, e - k);
            w[r * dim + c] = __fsub_rn(wv[q], __fmul_rn(lrv, acc));
          }
        }
      }
    }
  } else {
    for (int j = warp; j < inside; j += NW) {
      const long long r = hrows[j];
      if (r >= 0 && r < nrows)
        warp_run<VEC>(src, a + heads[j],
                      j + 1 < count ? a + heads[j + 1] : end_last, r, w, dim,
                      vals, lrv);
    }
  }
  if (!crosses) return;
  const long long s = a + heads[count - 1], r = hrows[count - 1];
  if (r < 0 || r >= nrows) return;
  if (!staged || end_last - s <= LONG_RUN) {
    if (warp == (staged ? 0 : inside % NW))
      warp_run<VEC>(src, s, end_last, r, w, dim, vals, lrv);
  } else {
    cta_run<VEC, NT>(src, s, end_last, r, w, dim, vals, lrv, ring, sidx);
  }
}

template <int VEC, typename K>
__global__ void __launch_bounds__(THREADS)
embedding_sgd_sorted(float* __restrict__ w, long long nrows, int dim,
                     const K* __restrict__ keys,
                     const long long* __restrict__ order,
                     const float* __restrict__ vals, long long n,
                     const float* __restrict__ lr, int window, int staged) {
  extern __shared__ float4 smem[];
  __shared__ int heads[WINDOW];
  __shared__ long long hrows[WINDOW];
  float* ring = staged ? reinterpret_cast<float*>(smem) : nullptr;
  const long long a = static_cast<long long>(blockIdx.x) * window;
  update_window<VEC, THREADS>(
      SortedSrc<K>{keys, order}, a, a + window < n ? a + window : n, n,
      nrows, w, dim, vals, *lr, ring,
      reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + RING_FLOATS),
      heads, hrows);
}

// The sorted path's sort operands: keys[i] = clamp(rows[i], -1, nrows) + 1
// (so every key is unsigned and below 2**end_bit) and idx[i] = i.
template <typename K>
__global__ void make_keys(const long long* __restrict__ rows, long long n,
                          long long nrows, K* __restrict__ keys,
                          long long* __restrict__ idx) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = rows[i];
    keys[i] = static_cast<K>((r < 0 ? -1 : r > nrows ? nrows : r) + 1);
    idx[i] = i;
  }
}

__device__ unsigned long long fused_key(long long r, int i, long long nrows) {
  return (r >= 0 && r < nrows ? static_cast<unsigned long long>(r) : SENT)
             << IDX_BITS |
         static_cast<unsigned>(i);
}

template <int VEC>
__global__ void __launch_bounds__(FUSED_THREADS)
embedding_sgd_fused(float* __restrict__ w, long long nrows, int dim,
                    const long long* __restrict__ rows,
                    const float* __restrict__ vals, int n,
                    const float* __restrict__ lr, int staged) {
  extern __shared__ float4 smem[];
  __shared__ int heads[FUSED_MAX];
  __shared__ long long hrows[FUSED_MAX];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* ring = reinterpret_cast<float*>(keys + FUSED_MAX);
  int* sidx = reinterpret_cast<int*>(ring + RING_FLOATS);
  const int tid = threadIdx.x;
  // the keys in order, by a bitonic network: distinct (the entry index
  // breaks ties), so the order is the stable one
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = tid; i < P; i += FUSED_THREADS)
    keys[i] = i < n ? fused_key(rows[i], i, nrows) : ~0ull;
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int t = tid; t < P / 2; t += FUSED_THREADS) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const unsigned long long x = keys[i], y = keys[i + j];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[i + j] = x;
        }
      }
    }
  __syncthreads();
  const float lrv = *lr;
  const int window = staged ? (RING_FLOATS / dim < FUSED_MAX
                                   ? RING_FLOATS / dim
                                   : FUSED_MAX)
                            : FUSED_MAX;
  for (int a = 0; a < n; a += window) {
    update_window<VEC, FUSED_THREADS>(
        SharedSrc{keys}, a, a + window < n ? a + window : n, n, nrows, w,
        dim, vals, lrv, staged ? ring : nullptr, sidx, heads, hrows);
    __syncthreads();
  }
}

// Opt every kernel in to its dynamic shared memory, once per device.
// Returns the first error (0 = success).
int prepare(int dev) {
  static bool done[64];
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  const int sorted = STAGED_BYTES, fused = KEYS_BYTES + STAGED_BYTES;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const cudaError_t errs[] = {
      cudaFuncSetAttribute(embedding_sgd_sorted<1, unsigned>, a, sorted),
      cudaFuncSetAttribute(embedding_sgd_sorted<2, unsigned>, a, sorted),
      cudaFuncSetAttribute(embedding_sgd_sorted<4, unsigned>, a, sorted),
      cudaFuncSetAttribute(embedding_sgd_sorted<1, Key64>, a, sorted),
      cudaFuncSetAttribute(embedding_sgd_sorted<2, Key64>, a, sorted),
      cudaFuncSetAttribute(embedding_sgd_sorted<4, Key64>, a, sorted),
      cudaFuncSetAttribute(embedding_sgd_fused<1>, a, fused),
      cudaFuncSetAttribute(embedding_sgd_fused<2>, a, fused),
      cudaFuncSetAttribute(embedding_sgd_fused<4>, a, fused)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  done[dev] = true;
  return 0;
}

// The sorted path's workspace, carved from one device buffer: the keys
// and the permutation before and after the sort, then the library sort's
// own temporary storage (its size from a query, which launches nothing).
struct Workspace {
  size_t keys_in, keys_out, idx_in, idx_out, temp, temp_bytes, total;
};

size_t align256(size_t b) { return (b + 255) & ~size_t{255}; }

// The bits of the largest key, nrows + 1.
int key_bits(long long nrows) {
  int bits = 1;
  while (bits < 63 && (1ull << bits) <= static_cast<unsigned long long>(
                                            nrows + 1))
    ++bits;
  return bits;
}

template <typename K>
Workspace workspace(long long n, long long nrows) {
  Workspace ws{};
  cub::DeviceRadixSort::SortPairs(
      static_cast<void*>(nullptr), ws.temp_bytes,
      static_cast<const K*>(nullptr),
      static_cast<K*>(nullptr), static_cast<const long long*>(nullptr),
      static_cast<long long*>(nullptr), static_cast<int>(n), 0,
      key_bits(nrows));
  const size_t kb = align256(n * sizeof(K)), ib = align256(n * 8);
  ws.keys_out = kb;
  ws.idx_in = 2 * kb;
  ws.idx_out = 2 * kb + ib;
  ws.temp = 2 * kb + 2 * ib;
  ws.total = ws.temp + ws.temp_bytes;
  return ws;
}

// Keys, the library's stable radix sort over their key_bits (3 passes of
// its 8 bits at a million rows, where a sort of every bit takes 4), then
// the update. Returns the first error.
template <int VEC, typename K>
int launch_sorted(float* w, long long nrows, int dim, const long long* rows,
                  const float* vals, long long n, const float* lr,
                  char* buf, cudaStream_t s) {
  const Workspace ws = workspace<K>(n, nrows);
  K* keys_in = reinterpret_cast<K*>(buf + ws.keys_in);
  K* keys = reinterpret_cast<K*>(buf + ws.keys_out);
  long long* idx_in = reinterpret_cast<long long*>(buf + ws.idx_in);
  long long* order = reinterpret_cast<long long*>(buf + ws.idx_out);
  const long long blocks = (n + THREADS - 1) / THREADS;
  make_keys<K><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                 THREADS, 0, s>>>(rows, n, nrows, keys_in, idx_in);
  size_t temp_bytes = ws.temp_bytes;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      buf + ws.temp, temp_bytes, keys_in, keys, idx_in, order,
      static_cast<int>(n), 0, key_bits(nrows), s);
  if (err != cudaSuccess) return (int)err;
  const int staged = dim <= CTA_MAX_DIM;
  const int window =
      staged && RING_FLOATS / dim < WINDOW ? RING_FLOATS / dim : WINDOW;
  embedding_sgd_sorted<VEC, K>
      <<<static_cast<unsigned>((n + window - 1) / window), THREADS,
         staged ? STAGED_BYTES : 0, s>>>(w, nrows, dim, keys, order, vals,
                                         n, lr, window, staged);
  return 0;
}

template <int VEC>
void launch_fused(float* w, long long nrows, int dim, const long long* rows,
                  const float* vals, int n, const float* lr, cudaStream_t s) {
  embedding_sgd_fused<VEC><<<1, FUSED_THREADS, KEYS_BYTES + STAGED_BYTES,
                             s>>>(w, nrows, dim, rows, vals, n, lr,
                                  dim <= CTA_MAX_DIM);
}

bool valid(int dim, int vec) {
  return dim >= 1 && (vec == 1 || vec == 2 || vec == 4) && dim % vec == 0;
}

}  // namespace

extern "C" {

// The bytes of embedding_sgd_sorted's workspace for n entries into an
// nrows-row table with key_bytes-byte keys; 0 for operands it does not take.
long long embedding_sgd_workspace(long long n, long long nrows,
                                  int key_bytes) {
  if (n < 1 || n > 0x7fffffffLL || nrows < 0 || nrows >= (1LL << 62) ||
      (key_bytes == 4 && nrows >= 0xffffffffLL) ||
      (key_bytes != 4 && key_bytes != 8))
    return 0;
  return static_cast<long long>(
      key_bytes == 4 ? workspace<unsigned>(n, nrows).total
                     : workspace<Key64>(n, nrows).total);
}

// w: [nrows, dim] float32, contiguous, updated in place; rows: [n] int64 in
// the entries' order; vals: [n, dim] float32 in the same order; lr: one
// float32 on the device; key_bytes: 4 (nrows < 2**32 - 1) or 8; vec: 1, 2
// or 4 columns per lane (dim and the vals pointer aligned to it); buf:
// embedding_sgd_workspace(n, nrows, key_bytes) bytes on the device, which
// the call may overwrite until the stream passes it. Returns the first
// error (0 = success).
int embedding_sgd_sorted(float* w, long long nrows, int dim,
                         const long long* rows, int key_bytes,
                         const float* vals, long long n, const float* lr,
                         int vec, void* buf, long long buf_bytes,
                         void* stream) {
  const long long need = embedding_sgd_workspace(n, nrows, key_bytes);
  if (need == 0 || buf_bytes < need || !valid(dim, vec))
    return (int)cudaErrorInvalidValue;
  int dev = -1;
  cudaGetDevice(&dev);
  if (const int err = prepare(dev)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* b = static_cast<char*>(buf);
  int err = 0;
  switch (vec * 10 + key_bytes) {
    case 14: err = launch_sorted<1, unsigned>(w, nrows, dim, rows, vals, n, lr, b, s); break;
    case 24: err = launch_sorted<2, unsigned>(w, nrows, dim, rows, vals, n, lr, b, s); break;
    case 44: err = launch_sorted<4, unsigned>(w, nrows, dim, rows, vals, n, lr, b, s); break;
    case 18: err = launch_sorted<1, Key64>(w, nrows, dim, rows, vals, n, lr, b, s); break;
    case 28: err = launch_sorted<2, Key64>(w, nrows, dim, rows, vals, n, lr, b, s); break;
    case 48: err = launch_sorted<4, Key64>(w, nrows, dim, rows, vals, n, lr, b, s); break;
  }
  return err ? err : (int)cudaGetLastError();
}

// One launch for n <= FUSED_MAX entries: rows [n] int64 unsorted (nrows <
// 2**53), the rest as embedding_sgd_sorted. Returns cudaGetLastError().
int embedding_sgd_fused(float* w, long long nrows, int dim,
                        const long long* rows, const float* vals, long long n,
                        const float* lr, int vec, void* stream) {
  if (n < 1 || n > FUSED_MAX || !valid(dim, vec) || nrows >= (1LL << 53))
    return (int)cudaErrorInvalidValue;
  int dev = -1;
  cudaGetDevice(&dev);
  if (const int err = prepare(dev)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  switch (vec) {
    case 1: launch_fused<1>(w, nrows, dim, rows, vals, m, lr, s); break;
    case 2: launch_fused<2>(w, nrows, dim, rows, vals, m, lr, s); break;
    case 4: launch_fused<4>(w, nrows, dim, rows, vals, m, lr, s); break;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
