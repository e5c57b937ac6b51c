// gru_seq: the whole-sequence GRU forward and its backward, ONE launch
// each, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/rnn.py::gru_seq_pallas: the forward
// kernel _gru_seq_kernel (grid over time, w resident in VMEM, the h carry
// in scratch) and the custom_vjp backward _gru_seq_bwd (a reverse scan of
// per-step vjps of _gru_step_jnp).
//
// What it computes, per step t (x [L, b, 3H] holds the projected inputs
// plus bias, gate columns [u, r, c]; w is [H, 3H] = [W_u | W_r | W_c]):
//   ur = bf16(h_{t-1}) . bf16(w[:, :2H])        (float32 sums of exact
//                                                bf16 x bf16 products)
//   u = sigmoid(x_u + ur_u), r = sigmoid(x_r + ur_r)
//   c = tanh(x_c + bf16(r * h_{t-1}) . bf16(w[:, 2H:]))
//   h = u*c + (1-u)*h_{t-1};  h_t = a*h + (1-a)*h_{t-1}   (a = alive[t])
// and writes the carries h_t to hs. The backward follows the jaxpr of the
// reference step's vjp operation by operation, including its four bf16
// roundings: the cotangents of bf16(r*h_{t-1}) and of bf16(h_{t-1}) (the
// products dpre_c . W_c^T and [dpre_u | dpre_r] . W_ur^T), and both parts
// of dW_t (bf16(h_{t-1})^T . [dpre_u | dpre_r] and
// bf16(r*h_{t-1})^T . dpre_c) are rounded to bfloat16 before they are
// added in float32.
//
// Design. The cooperative, persistent partition of lstm_seq.cu: block j
// owns hidden units 4j..4j+3 and their 12 gate columns (u, r, c of each),
// keeps that column slice of W (bf16-rounded, as float32: 24 KB at H 512)
// in shared memory for all L steps and does its units' cell math itself.
// Unlike the LSTM, a GRU step needs TWO grid-wide barriers: the candidate's
// product bf16(r*h_{t-1}) . W_c needs r of every unit, so each step
// computes u and r of its own units, publishes bf16(r*h_{t-1}) (a [b, H]
// scratch), crosses a barrier, computes c and h, publishes h (into hs) and
// crosses the second barrier.
//
// The backward has the same two dependencies in reverse. A first pass over
// all steps (no barrier between steps: every h_{t-1} is known) recomputes
// u and r through the forward's code (bitwise the forward's gates) into
// dx, and bf16(r*h_{t-1}) into an [L, b, H] scratch. Then, for t = L-1..0:
//   A: stage bf16(r*h_{t-1}); c of own units; dpre_u, dpre_c of own units
//      (written over u and c in dx_t); add bf16(rh^T . dpre_c) to the
//      block's dW_c columns (float32, in registers: no atomics). Barrier.
//   B: stage every unit's dpre_c; cd = bf16(dpre_c . W_c^T) for own units
//      (own rows of W, a second 24 KB slice), then dpre_r (over r in dx_t);
//      stage bf16(h_{t-1}); add bf16(hb^T . [dpre_u | dpre_r]) to dW_u,r.
//      Barrier.
//   C: stage every unit's [dpre_u | dpre_r]; dh_{t-1} of own units =
//      (((1-a)e + (1-u)ae) + r*cd) + bf16([dpre_u | dpre_r] . W_ur^T).
// Step t-1's phase A writes only dx_{t-1}, which no block reads before the
// next barrier, so two barriers per step suffice.
//
// Bound on the H100 at b 64, L 100, H 512: neither bytes nor operations.
// A layer's forward is 10 GFLOP (the products, 0.15 ms at 67 TFLOP/s on
// the CUDA cores) and moves ~45 MB; but its 100 steps are a dependent
// chain of 200 grid barriers, whose serial floor bounds it from below.
// This first version runs the products on the CUDA cores in float32, in a
// fixed summation order (every run is bitwise the same); tensor-core tiles
// (mma / wgmma on the bf16 operands) are later work.
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and scratch and passes its stream.

#include "seq_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace seq;

constexpr int COLS = 3 * UNITS;   // gate columns per block: u, r, c
constexpr int RSPLIT = 16;        // the row products' split of K
static_assert(PART == 8 * BMAX * 8 && PART == RSPLIT * BMAX * UNITS,
              "the partial sums of both products fill PART");
static_assert(2 * THREADS >= MAX_H, "dW: 2 rows of W per thread");

// gates_s[row][c0 + c] = x_t[row][gcol(c0 + c)] + sum_k a_s[row][k] *
// w_s[k][c0 + c] for the NC local columns from c0. Each thread sums a
// 4-row x 4-column tile over the K quads s, s + KS, s + 2KS, ... in
// increasing order; the KS partial sums are then added in order.
template <int NC>
__device__ void col_product(const float* a_s, int hp, const float* w_s,
                            int c0, float* part, float* gates_s,
                            const float* xt, int b, int H, int j0) {
  constexpr int CQ = NC / 4;           // column quads
  constexpr int TILES = 16 * CQ;       // 4 x 4 tiles of the 64 x NC block
  constexpr int KS = THREADS / TILES;  // the split of K
  const int tid = threadIdx.x;
  const int s = tid / TILES, q = tid % TILES, rg = q / CQ, cq = q % CQ;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* arow = a_s + rg * 4 * hp;
  for (int qd = s; qd < H / 4; qd += KS) {
    const int k = qd * 4;
    float av[4][4], wv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(arow + r * hp + k);
      av[r][0] = v.x; av[r][1] = v.y; av[r][2] = v.z; av[r][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(
          w_s + (k + kk) * COLS + c0 + cq * 4);
      wv[kk][0] = v.x; wv[kk][1] = v.y; wv[kk][2] = v.z; wv[kk][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(av[r][kk], wv[kk][c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[(s * BMAX + rg * 4 + r) * NC + cq * 4 + c] = acc[r][c];
  __syncthreads();
  for (int o = tid; o < BMAX * NC; o += THREADS) {
    const int row = o / NC, c = o % NC;
    if (row < b) {
      float mm = part[o];
      for (int k = 1; k < KS; ++k) mm = __fadd_rn(mm, part[k * BMAX * NC + o]);
      gates_s[row * COLS + c0 + c] =
          __fadd_rn(xt[row * 3 * H + gcol(c0 + c, j0, H)], mm);
    }
  }
  __syncthreads();
}

// acc[r][u] += sum_k a_s[rg*4 + r][k] * wr_s[u][off + k] over the K quads
// ks, ks + RSPLIT, ... (rg = tid % 16, ks = tid / 16): the block's own
// units against rows of every unit
__device__ void row_product(const float* a_s, int hp, const float* wr_s,
                            int ldw, int off, int H, float (&acc)[4][4]) {
  const int tid = threadIdx.x, rg = tid % 16, ks = tid / 16;
  for (int qd = ks; qd < H / 4; qd += RSPLIT) {
    float dv[4][4], wv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          a_s + (rg * 4 + r) * hp + qd * 4);
      dv[r][0] = v.x; dv[r][1] = v.y; dv[r][2] = v.z; dv[r][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(
          wr_s + u * ldw + off + qd * 4);
      wv[u][0] = v.x; wv[u][1] = v.y; wv[u][2] = v.z; wv[u][3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[r][u] = fmaf(dv[r][e], wv[u][e], acc[r][u]);
  }
}

// the sum of every thread's row_product partials for cell (row, jj), the
// RSPLIT parts added in order
__device__ float row_reduce(const float (&acc)[4][4], float* part, int row,
                            int jj, bool mine) {
  const int tid = threadIdx.x, rg = tid % 16, ks = tid / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      part[(ks * BMAX + rg * 4 + r) * UNITS + u] = acc[r][u];
  __syncthreads();
  float mm = 0.f;
  if (mine) {
    mm = part[row * UNITS + jj];
    for (int k = 1; k < RSPLIT; ++k)
      mm = __fadd_rn(mm, part[(k * BMAX + row) * UNITS + jj]);
  }
  __syncthreads();
  return mm;
}

// dwacc[i][C0 + c] += bf16(sum_{r<b} a_s[r][k + i] * dg_s[r][C0 + c]) for
// this thread's rows k = 2*tid, 2*tid + 1 of W: one step's dW columns,
// summed over the batch in order and rounded as the reference rounds them
template <int C0, int NC>
__device__ void dw_accumulate(const float* a_s, int hp, const float* dg_s,
                              int b, int H, float (&dwacc)[2][COLS]) {
  const int k = 2 * threadIdx.x;
  if (k >= H) return;
  float tmp[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) tmp[i][c] = 0.f;
  for (int r = 0; r < b; ++r) {
    const float2 av = *reinterpret_cast<const float2*>(a_s + r * hp + k);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float d = dg_s[r * COLS + C0 + c];
      tmp[0][c] = fmaf(av.x, d, tmp[0][c]);
      tmp[1][c] = fmaf(av.y, d, tmp[1][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dwacc[i][C0 + c] = __fadd_rn(dwacc[i][C0 + c], bf16r(tmp[i][c]));
}

__global__ void __launch_bounds__(THREADS, 1)
gru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
               const float* __restrict__ w, const float* __restrict__ h0,
               float* hs, float* rh, int L, int b, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hp = H + 4, H3 = 3 * H;
  float* a_s = smem;                  // [BMAX][hp]  bf16(h_{t-1}), then
                                      //             bf16(r * h_{t-1})
  float* w_s = a_s + BMAX * hp;       // [H][COLS]   bf16(w) columns
  float* part = w_s + H * COLS;       // [PART]      partial sums
  float* gates_s = part + PART;       // [BMAX][COLS]
  const int tid = threadIdx.x, j0 = blockIdx.x * UNITS;
  const int row = tid / UNITS, jj = tid % UNITS;
  const bool mine = row < b;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < BMAX * hp; i += THREADS) a_s[i] = 0.f;
  stage_w_cols<3>(w_s, w, H, j0);
  float h = mine ? h0[row * H + j0 + jj] : 0.f;
  for (int t = 0; t < L; ++t) {
    const float* xt = x + (size_t)t * b * H3;
    __syncthreads();
    stage_rows(a_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, b, H,
               H, true);
    __syncthreads();
    col_product<2 * UNITS>(a_s, hp, w_s, 0, part, gates_s, xt, b, H, j0);
    float u = 0.f;
    if (mine) {
      const float* gr = gates_s + row * COLS;
      u = sigm(gr[jj]);
      const float r = sigm(gr[UNITS + jj]);
      rh[row * H + j0 + jj] = bf16r(__fmul_rn(r, h));
    }
    grid.sync();   // every unit's bf16(r * h_{t-1}) is written
    stage_rows(a_s, hp, rh, b, H, H, false);
    __syncthreads();
    col_product<UNITS>(a_s, hp, w_s, 2 * UNITS, part, gates_s, xt, b, H,
                       j0);
    if (mine) {
      const float c = tanhf(gates_s[row * COLS + 2 * UNITS + jj]);
      const float a = alive[t * b + row];
      const float hn = __fadd_rn(__fmul_rn(u, c),
                                 __fmul_rn(__fsub_rn(1.f, u), h));
      h = __fadd_rn(__fmul_rn(a, hn), __fmul_rn(__fsub_rn(1.f, a), h));
      hs[((size_t)t * b + row) * H + j0 + jj] = h;
    }
    grid.sync();   // every unit's h_t is written
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
               const float* __restrict__ w, const float* __restrict__ h0,
               const float* __restrict__ hs, const float* __restrict__ dhs,
               float* dx, float* dw, float* dh0, float* rh, int L, int b,
               int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hp = H + 4, H3 = 3 * H;
  float* a_s = smem;                   // [BMAX][hp]  staged rows
  float* w_s = a_s + BMAX * hp;        // [H][COLS]   bf16(w) columns
  float* wr_s = w_s + H * COLS;        // [UNITS][3H] bf16(w) rows
  float* part = wr_s + UNITS * H3;     // [PART]      partial sums
  float* gates_s = part + PART;        // [BMAX][COLS]
  float* dg_s = gates_s + BMAX * COLS; // [BMAX][COLS] dgates_t, own columns
  const int tid = threadIdx.x, j0 = blockIdx.x * UNITS;
  const int row = tid / UNITS, jj = tid % UNITS;
  const bool mine = row < b;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < BMAX * hp; i += THREADS) a_s[i] = 0.f;
  for (int i = tid; i < BMAX * COLS; i += THREADS) dg_s[i] = 0.f;
  stage_w_cols<3>(w_s, w, H, j0);
  for (int i = tid; i < UNITS * H3; i += THREADS)
    wr_s[i] = bf16r(w[(j0 + i / H3) * H3 + i % H3]);

  // ---- every step's u and r (into dx) and bf16(r * h_{t-1}) ----
  for (int t = 0; t < L; ++t) {
    __syncthreads();
    stage_rows(a_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, b, H,
               H, true);
    __syncthreads();
    col_product<2 * UNITS>(a_s, hp, w_s, 0, part, gates_s,
                           x + (size_t)t * b * H3, b, H, j0);
    if (mine) {
      const size_t o = ((size_t)t * b + row) * H + j0 + jj;
      const float hprev =
          t == 0 ? h0[row * H + j0 + jj] : hs[o - (size_t)b * H];
      const float* gr = gates_s + row * COLS;
      const float r = sigm(gr[UNITS + jj]);
      float* dxr = dx + ((size_t)t * b + row) * H3 + j0 + jj;
      dxr[0] = sigm(gr[jj]);
      dxr[H] = r;
      rh[o] = bf16r(__fmul_rn(r, hprev));
    }
  }
  grid.sync();

  float dwacc[2][COLS];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) dwacc[i][c] = 0.f;
  float dh = 0.f;   // cotangent of the carry after step t

  for (int t = L - 1; t >= 0; --t) {
    const size_t o = ((size_t)t * b + row) * H + j0 + jj;
    float* dxt = dx + (size_t)t * b * H3;
    // ---- phase A: c, dpre_u and dpre_c of own units; dW_c ----
    __syncthreads();
    stage_rows(a_s, hp, rh + (size_t)t * b * H, b, H, H, false);
    __syncthreads();
    col_product<UNITS>(a_s, hp, w_s, 2 * UNITS, part, gates_s,
                       x + (size_t)t * b * H3, b, H, j0);
    float r = 0.f, hprev = 0.f, bn = 0.f;
    if (mine) {
      float* dxr = dxt + row * H3 + j0 + jj;
      const float u = dxr[0];
      r = dxr[H];
      hprev = t == 0 ? h0[row * H + j0 + jj] : hs[o - (size_t)b * H];
      const float c = tanhf(gates_s[row * COLS + 2 * UNITS + jj]);
      const float a = alive[t * b + row];
      const float e = __fadd_rn(dh, dhs[o]);
      const float bl = __fmul_rn(a, e);
      bn = __fadd_rn(__fmul_rn(__fsub_rn(1.f, a), e),
                     __fmul_rn(__fsub_rn(1.f, u), bl));
      const float du = __fsub_rn(__fmul_rn(bl, c), __fmul_rn(bl, hprev));
      const float bt = __fmul_rn(__fmul_rn(u, bl), __fsub_rn(1.f, c));
      const float dpc = __fadd_rn(bt, __fmul_rn(bt, c));
      const float dpu = __fmul_rn(du, __fmul_rn(u, __fsub_rn(1.f, u)));
      dxr[0] = dpu;
      dxr[2 * H] = dpc;
      dg_s[row * COLS + jj] = dpu;
      dg_s[row * COLS + 2 * UNITS + jj] = dpc;
    }
    __syncthreads();
    dw_accumulate<2 * UNITS, UNITS>(a_s, hp, dg_s, b, H, dwacc);
    grid.sync();   // every unit's dpre_c (dx_t's c columns) is written

    // ---- phase B: cd = bf16(dpre_c . W_c^T), dpre_r; dW_u, dW_r ----
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    stage_rows(a_s, hp, dxt + 2 * H, b, H, H3, false);
    __syncthreads();
    row_product(a_s, hp, wr_s, H3, 2 * H, H, acc);
    const float cd = bf16r(row_reduce(acc, part, row, jj, mine));
    float cf = 0.f;
    if (mine) {
      cf = __fadd_rn(bn, __fmul_rn(r, cd));
      const float dpr = __fmul_rn(__fmul_rn(cd, hprev),
                                  __fmul_rn(r, __fsub_rn(1.f, r)));
      dxt[row * H3 + H + j0 + jj] = dpr;
      dg_s[row * COLS + UNITS + jj] = dpr;
    }
    stage_rows(a_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, b, H,
               H, true);
    __syncthreads();
    dw_accumulate<0, 2 * UNITS>(a_s, hp, dg_s, b, H, dwacc);
    grid.sync();   // every unit's dpre_u and dpre_r are written

    // ---- phase C: dh_{t-1} = cf + bf16([dpre_u | dpre_r] . W_ur^T) ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    for (int ch = 0; ch < 2; ++ch) {
      __syncthreads();
      stage_rows(a_s, hp, dxt + ch * H, b, H, H3, false);
      __syncthreads();
      row_product(a_s, hp, wr_s, H3, ch * H, H, acc);
    }
    const float ct = row_reduce(acc, part, row, jj, mine);
    if (mine) dh = __fadd_rn(cf, bf16r(ct));
  }
  if (mine) dh0[row * H + j0 + jj] = dh;
  const int k = 2 * tid;
  if (k < H) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int lc = 0; lc < COLS; ++lc)
        dw[(size_t)(k + i) * H3 + gcol(lc, j0, H)] = dwacc[i][lc];
  }
}

}  // namespace

extern "C" {

// x [L, b, 3H], alive [L, b, 1], w [H, 3H], h0 [b, H] in; hs [L, b, H]
// out; rh [b, H] scratch; all float32, contiguous, on the current device.
int gru_seq_fwd(const float* x, const float* alive, const float* w,
                const float* h0, float* hs, float* rh, int L, int b, int H,
                void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &alive, &w, &h0, &hs, &rh, &L, &b, &H};
  return launch(gru_fwd_kernel, H / UNITS, fwd_smem<3>(H), args, stream);
}

// the forward's inputs, its carries hs and their cotangents dhs [L, b, H]
// in; dx [L, b, 3H], dw [H, 3H], dh0 [b, H] out; rh [L, b, H] scratch.
int gru_seq_bwd(const float* x, const float* alive, const float* w,
                const float* h0, const float* hs, const float* dhs,
                float* dx, float* dw, float* dh0, float* rh, int L, int b,
                int H, void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x,  &alive, &w,  &h0, &hs, &dhs, &dx,
                  &dw, &dh0,   &rh, &L,  &b,  &H};
  return launch(gru_bwd_kernel, H / UNITS, bwd_smem<3>(H), args, stream);
}

}  // extern "C"
