// lstm_seq: the whole-sequence LSTM forward and its backward, ONE launch
// each, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/rnn.py::lstm_seq_pallas: the forward
// kernel _lstm_seq_kernel (grid over time, w resident in VMEM, h/c carries
// in scratch) and the custom_vjp backward _lstm_seq_bwd (a reverse scan of
// per-step vjps that recomputes the gates from the saved carries).
//
// What it computes, per step t (x [L, b, 4H] holds the projected inputs
// plus bias, gate columns [i, f, c, o]; w is [H, 4H]):
//   gates = x_t + bf16(h_{t-1}) . bf16(w)      (float32 sums of exact
//                                                bf16 x bf16 products)
//   i, f, o = sigmoid, cand = tanh; c = f*c_prev + i*cand; h = o*tanh(c)
//   h_t = a*h + (1-a)*h_{t-1}, c_t = a*c + (1-a)*c_{t-1}  (a = alive[t])
// and writes the carries h_t, c_t to hs, cs. The backward follows the
// jaxpr of the reference step's vjp operation by operation, including its
// two bf16 roundings: dW_t = h_{t-1}^T . dgates_t and the product part of
// dh_{t-1} = dgates_t . W^T are rounded to bfloat16 before they are added
// in float32.
//
// Design. W in bf16 is 2 MiB at H 512 and cannot sit in one SM, so the
// kernel is a persistent COOPERATIVE grid: block j owns hidden units
// 4j..4j+3 and their 16 gate columns (i, f, c, o of each), keeps its column
// slice of W (bf16-rounded, as float32: 32 KB) in shared memory for all L
// steps, and does the cell math of its units itself, so only h crosses
// blocks. Each step a block stages h_{t-1} (all H, from the hs it and the
// other blocks wrote) into shared memory, computes its 64 x 16 gate tile
// (four thread groups each sum a quarter of H in increasing k, the quarters
// then added in order: a fixed order, so every run is bitwise the same),
// updates its carries and writes them; then a grid-wide barrier
// (cooperative_groups grid sync) publishes h_t.
//
// The backward walks t from L-1 to 0 on the same partition. Phase A:
// recompute the block's gates from h_{t-1} through the same code as the
// forward (bitwise the forward's gates), form dgates for its columns,
// write them (they are dx_t), and add its columns of h_{t-1}^T . dgates_t,
// rounded to bf16, to a float32 dW held in registers (no atomics). Barrier.
// Phase B: dh_{t-1} for its own units needs every block's dgates_t, so the
// block reads all of dx_t [b, 4H] back (from L2) in four chunks and
// multiplies by its rows of W (a second resident slice, 32 KB). The next
// step's phase A writes dx_{t-1}, which no block reads before the next
// barrier, so one barrier per step suffices.
//
// Bound on the H100 at b 64, L 100, H 512: neither bytes nor operations.
// A layer's forward is 13.4 GFLOP (0.2 ms at 67 TFLOP/s on the CUDA cores)
// and moves ~40 MB; but its 100 steps are a dependent chain, one grid
// barrier each, so the serial floor (L barriers) bounds it from below.
// This first version runs the products on the CUDA cores in float32;
// tensor-core tiles (mma / wgmma on the bf16 operands) are later work.
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and passes its stream.

#include "seq_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace seq;

constexpr int COLS = 4 * UNITS;   // gate columns per block
constexpr int KSPLIT = 4;         // the gate product's split of H
constexpr int BSPLIT = 16;        // phase B's split of 4H
static_assert(PART == KSPLIT * BMAX * COLS && PART == BSPLIT * BMAX * UNITS,
              "the partial sums of both products fill PART");
static_assert(8 * THREADS / 4 >= MAX_H, "dW: 8 rows of W per 4 threads");

// gates_s[row][lc] = x_t[row][gcol(lc)] + sum_k hs_s[row][k] * w_s[k][lc]
// for the block's 16 columns. Thread groups s = 0..3 sum k in
// [s*H/4, (s+1)*H/4) in increasing order, each thread a 4-row x 4-column
// tile; the four partial sums are then added in order s = 0, 1, 2, 3.
__device__ void gate_preact(const float* hs_s, int hp, const float* w_s,
                            float* part, float* gates_s, const float* xt,
                            int b, int H, int j0) {
  const int tid = threadIdx.x;
  const int s = tid / 64, q = tid % 64, rg = q / 4, cq = q % 4;
  const int ks = H / KSPLIT;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* hrow = hs_s + rg * 4 * hp;
  for (int k = s * ks; k < (s + 1) * ks; k += 4) {
    float hv[4][4], wv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(hrow + r * hp + k);
      hv[r][0] = v.x; hv[r][1] = v.y; hv[r][2] = v.z; hv[r][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(
          w_s + (k + kk) * COLS + cq * 4);
      wv[kk][0] = v.x; wv[kk][1] = v.y; wv[kk][2] = v.z; wv[kk][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(hv[r][kk], wv[kk][c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[s * BMAX * COLS + (rg * 4 + r) * COLS + cq * 4 + c] = acc[r][c];
  __syncthreads();
  for (int o = tid; o < BMAX * COLS; o += THREADS) {
    const int row = o / COLS, lc = o % COLS;
    float g = 0.f;
    if (row < b) {
      const float mm = __fadd_rn(
          __fadd_rn(__fadd_rn(part[o], part[BMAX * COLS + o]),
                    part[2 * BMAX * COLS + o]),
          part[3 * BMAX * COLS + o]);
      g = __fadd_rn(xt[row * 4 * H + gcol(lc, j0, H)], mm);
    }
    gates_s[o] = g;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
                const float* __restrict__ w, const float* __restrict__ h0,
                const float* __restrict__ c0, float* hs, float* cs, int L,
                int b, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hp = H + 4;
  float* hs_s = smem;                      // [BMAX][hp]  bf16(h_{t-1})
  float* w_s = hs_s + BMAX * hp;           // [H][COLS]   bf16(w) columns
  float* part = w_s + H * COLS;            // [PART]      partial sums
  float* gates_s = part + PART;            // [BMAX][COLS]
  const int tid = threadIdx.x, j0 = blockIdx.x * UNITS;
  const int row = tid / UNITS, jj = tid % UNITS;
  const bool mine = row < b;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < BMAX * hp; i += THREADS) hs_s[i] = 0.f;
  stage_w_cols<4>(w_s, w, H, j0);
  float h = 0.f, c = 0.f;
  if (mine) {
    h = h0[row * H + j0 + jj];
    c = c0[row * H + j0 + jj];
  }
  for (int t = 0; t < L; ++t) {
    __syncthreads();
    stage_rows(hs_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, b, H,
               H, true);
    __syncthreads();
    gate_preact(hs_s, hp, w_s, part, gates_s, x + (size_t)t * b * 4 * H, b,
                H, j0);
    if (mine) {
      const float* gr = gates_s + row * COLS;
      const float a = alive[t * b + row];
      const float ig = sigm(gr[jj]);
      const float fg = sigm(gr[UNITS + jj]);
      const float cand = tanhf(gr[2 * UNITS + jj]);
      const float og = sigm(gr[3 * UNITS + jj]);
      const float cn = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, cand));
      const float hn = __fmul_rn(og, tanhf(cn));
      const float na = __fsub_rn(1.f, a);
      h = __fadd_rn(__fmul_rn(a, hn), __fmul_rn(na, h));
      c = __fadd_rn(__fmul_rn(a, cn), __fmul_rn(na, c));
      const size_t o = ((size_t)t * b + row) * H + j0 + jj;
      hs[o] = h;
      cs[o] = c;
    }
    grid.sync();
  }
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
                const float* __restrict__ w, const float* __restrict__ h0,
                const float* __restrict__ c0, const float* __restrict__ hs,
                const float* __restrict__ cs, const float* __restrict__ dhs,
                const float* __restrict__ dcs, float* dx, float* dw,
                float* dh0, float* dc0, int L, int b, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hp = H + 4, H4 = 4 * H;
  float* hs_s = smem;                  // [BMAX][hp]  bf16(h_{t-1}); then
                                       //             a chunk of dgates_t
  float* w_s = hs_s + BMAX * hp;       // [H][COLS]   bf16(w) columns
  float* wr_s = w_s + H * COLS;        // [UNITS][4H] bf16(w) rows
  float* part = wr_s + UNITS * H4;     // [PART]      partial sums
  float* gates_s = part + PART;        // [BMAX][COLS]
  float* dg_s = gates_s + BMAX * COLS; // [BMAX][COLS] dgates_t, own columns
  const int tid = threadIdx.x, j0 = blockIdx.x * UNITS;
  const int row = tid / UNITS, jj = tid % UNITS;
  const bool mine = row < b;
  // dW: this thread's 8 rows k of W and the 4 units of gate gq
  const int kg = tid / 4, gq = tid % 4;
  const bool dw_mine = kg * 8 < H;
  // phase B: rows rg*4..+3, column quads ksb, ksb+BSPLIT, ...
  const int rg = tid % 16, ksb = tid / 16;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < BMAX * hp; i += THREADS) hs_s[i] = 0.f;
  for (int i = tid; i < BMAX * COLS; i += THREADS) dg_s[i] = 0.f;
  stage_w_cols<4>(w_s, w, H, j0);
  for (int i = tid; i < UNITS * H4; i += THREADS)
    wr_s[i] = bf16r(w[(j0 + i / H4) * H4 + i % H4]);
  float dwacc[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) dwacc[kk][u] = 0.f;
  float dh = 0.f, dc = 0.f;   // cotangents of the carries after step t

  for (int t = L - 1; t >= 0; --t) {
    // ---- phase A: this block's dgates_t and its columns of dW ----
    __syncthreads();
    stage_rows(hs_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, b, H,
               H, true);
    __syncthreads();
    gate_preact(hs_s, hp, w_s, part, gates_s, x + (size_t)t * b * H4, b, H,
                j0);
    float bo = 0.f;
    if (mine) {
      const size_t o = ((size_t)t * b + row) * H + j0 + jj;
      const float* gr = gates_s + row * COLS;
      const float a = alive[t * b + row];
      const float cp = t == 0 ? c0[row * H + j0 + jj] : cs[o - (size_t)b * H];
      const float ig = sigm(gr[jj]);
      const float fg = sigm(gr[UNITS + jj]);
      const float u = tanhf(gr[2 * UNITS + jj]);
      const float og = sigm(gr[3 * UNITS + jj]);
      const float tc =
          tanhf(__fadd_rn(__fmul_rn(fg, cp), __fmul_rn(ig, u)));
      const float dht = __fadd_rn(dh, dhs[o]);
      const float dct = __fadd_rn(dc, dcs[o]);
      const float na = __fsub_rn(1.f, a);
      const float bp = __fmul_rn(a, dht);
      const float bs = __fmul_rn(__fmul_rn(og, bp), __fsub_rn(1.f, tc));
      const float dcn = __fadd_rn(__fadd_rn(__fmul_rn(a, dct), bs),
                                  __fmul_rn(bs, tc));
      const float dcand = __fmul_rn(__fmul_rn(ig, dcn), __fsub_rn(1.f, u));
      float dg[4];
      dg[0] = __fmul_rn(__fmul_rn(dcn, u),
                        __fmul_rn(ig, __fsub_rn(1.f, ig)));
      dg[1] = __fmul_rn(__fmul_rn(dcn, cp),
                        __fmul_rn(fg, __fsub_rn(1.f, fg)));
      dg[2] = __fadd_rn(dcand, __fmul_rn(dcand, u));
      dg[3] = __fmul_rn(__fmul_rn(bp, tc),
                        __fmul_rn(og, __fsub_rn(1.f, og)));
      float* dxr = dx + ((size_t)t * b + row) * H4 + j0 + jj;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dxr[g * H] = dg[g];
        dg_s[row * COLS + g * UNITS + jj] = dg[g];
      }
      bo = __fmul_rn(na, dht);
      dc = __fadd_rn(__fmul_rn(na, dct), __fmul_rn(fg, dcn));
    }
    __syncthreads();
    if (dw_mine) {
      float tmp[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) tmp[kk][u] = 0.f;
      for (int r = 0; r < b; ++r) {
        const float4 ha =
            *reinterpret_cast<const float4*>(hs_s + r * hp + kg * 8);
        const float4 hb =
            *reinterpret_cast<const float4*>(hs_s + r * hp + kg * 8 + 4);
        const float4 dv =
            *reinterpret_cast<const float4*>(dg_s + r * COLS + gq * 4);
        const float hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            tmp[kk][u] = fmaf(hv[kk], d4[u], tmp[kk][u]);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dwacc[kk][u] = __fadd_rn(dwacc[kk][u], bf16r(tmp[kk][u]));
    }
    grid.sync();   // every block's dgates_t (= dx_t) is written

    // ---- phase B: dh_{t-1} of this block's units, all of dgates_t ----
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
    for (int ch = 0; ch < 4; ++ch) {
      __syncthreads();
      stage_rows(hs_s, hp, dx + (size_t)t * b * H4 + ch * H, b, H, H4,
                 false);
      __syncthreads();
      for (int qd = ksb; qd < H / 4; qd += BSPLIT) {
        float dv[4][4], wv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(
              hs_s + (rg * 4 + r) * hp + qd * 4);
          dv[r][0] = v.x; dv[r][1] = v.y; dv[r][2] = v.z; dv[r][3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v = *reinterpret_cast<const float4*>(
              wr_s + u * H4 + ch * H + qd * 4);
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
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        part[ksb * BMAX * UNITS + (rg * 4 + r) * UNITS + u] = acc[r][u];
    __syncthreads();
    if (mine) {
      float mm = part[row * UNITS + jj];
      for (int k = 1; k < BSPLIT; ++k)
        mm = __fadd_rn(mm, part[k * BMAX * UNITS + row * UNITS + jj]);
      dh = __fadd_rn(bo, bf16r(mm));
    }
  }
  if (mine) {
    dh0[row * H + j0 + jj] = dh;
    dc0[row * H + j0 + jj] = dc;
  }
  if (dw_mine) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        dw[(size_t)(kg * 8 + kk) * H4 + gq * H + j0 + u] = dwacc[kk][u];
  }
}

__global__ void barrier_chain_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < steps; ++i) grid.sync();
}

}  // namespace

extern "C" {

// x [L, b, 4H], alive [L, b, 1], w [H, 4H], h0, c0 [b, H] in; hs, cs
// [L, b, H] out; all float32, contiguous, on the current device.
int lstm_seq_fwd(const float* x, const float* alive, const float* w,
                 const float* h0, const float* c0, float* hs, float* cs,
                 int L, int b, int H, void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &alive, &w, &h0, &c0, &hs, &cs, &L, &b, &H};
  return launch(lstm_fwd_kernel, H / UNITS, fwd_smem<4>(H), args, stream);
}

// the forward's inputs and outputs, and the carries' cotangents dhs, dcs
// [L, b, H] in; dx [L, b, 4H], dw [H, 4H], dh0, dc0 [b, H] out.
int lstm_seq_bwd(const float* x, const float* alive, const float* w,
                 const float* h0, const float* c0, const float* hs,
                 const float* cs, const float* dhs, const float* dcs,
                 float* dx, float* dw, float* dh0, float* dc0, int L, int b,
                 int H, void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x,   &alive, &w,  &h0,  &c0,  &hs, &cs, &dhs, &dcs,
                  &dx,  &dw,    &dh0, &dc0, &L,  &b,  &H};
  return launch(lstm_bwd_kernel, H / UNITS, bwd_smem<4>(H), args, stream);
}

// an empty cooperative kernel of `blocks` blocks crossing `steps` grid
// barriers: the serial floor of a `steps`-step recurrence
int grid_barrier_chain(int blocks, int steps, void* stream) {
  void* args[] = {&steps};
  return launch(barrier_chain_kernel, blocks, 0, args, stream);
}

}  // extern "C"
