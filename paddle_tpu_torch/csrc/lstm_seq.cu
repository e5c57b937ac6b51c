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
// forward is a persistent COOPERATIVE grid: block j owns hidden units
// 4j..4j+3 and their 16 gate columns (i, f, c, o of each), keeps its column
// slice of W (bf16-rounded, as float32: 32 KB) in shared memory for all L
// steps, and does the cell math of its units itself, so only h crosses
// blocks. Each step a block stages h_{t-1} (all H, from the hs it and the
// other blocks wrote) into shared memory, computes its 64 x 16 gate tile
// (four thread groups each sum a quarter of H in increasing k, the quarters
// then added in order: a fixed order, so every run is bitwise the same),
// updates its carries and writes them; then a grid-wide barrier
// (cooperative_groups grid sync) publishes h_t. The GRU forward runs on
// batch-row groups with its products on the tensor cores (gru_seq.cu);
// this one keeps the first design because chip_smoke.py holds its carries
// to the plain version's within 1e-5, which its order has met (bitwise,
// in every H100 run so far) and a tensor-core order does not: a float32
// step of difference in h_{t-1} moves bf16(h_{t-1}) by 2^-8 of itself now
// and then, and every gate of its row with it (seq_split.py --parts
// lstmtc builds and measures such a forward).
//
// The backward runs three stages in one cooperative launch of the same
// H/4 blocks, separated by grid barriers, and keeps only what depends on
// the carries' cotangents on the serial chain (csrc/seq_mma.cuh holds the
// tensor-core code):
// - Prologue, no barrier between steps: every step's gates at once, one
//   GEMM over the L*b rows [h0; hs[:-1]] (bf16 x bf16 on mma.sync, exact
//   products), activated and written into dx, which the chain overwrites
//   with dgates. They are not the forward's gates bit for bit (another
//   float32 order); the plain version recomputes them in its own order
//   too.
// - Chain, t = L-1 .. 0, one grid barrier a step. Batch rows are
//   independent, so a chain block owns UB units (32, or 16 where H is not
//   a multiple of 32) of RB = 256/UB batch rows, holds its units' rows of
//   W in shared memory (bf16, 128 KB at H 512) and does its cells' math
//   from the gates in dx. It writes its dgates_t into dx_t; after the
//   barrier it reads its rows' dgates_t of every unit (64 KB at b 64, H
//   512, from the 16 blocks of its row group; the second half of the
//   columns in flight while the first half's products run) and forms its
//   cells' dh product bf16(dgates_t . W^T) on the tensor cores: dgates
//   split into three bf16 parts, each 16-column k-step a fresh
//   accumulator, the k-steps summed per warp in increasing order and the 8
//   warps' sums in warp order. On the H100 this exchange took 1.2 us a
//   step where a broadcast of all dgates (the first version's, 512 KB a
//   block) took 9 and column-split partials 12 (PERF.md §6).
// - Epilogue: dW = sum_t bf16(bf16(h_{t-1})^T . dgates_t), t descending,
//   tiled 64 x 128 over W across the grid, K = b a step.
// The grid barrier of step 0 publishes every dgates the epilogue reads, so
// the chain needs no barrier of its own after it. Every sum has a fixed
// order and no atomics: every run is bitwise the same.
//
// Bound on the H100 at b 64, L 100, H 512: neither bytes nor operations.
// A layer's forward is 13.4 GFLOP (0.2 ms at 67 TFLOP/s on the CUDA cores,
// 0.014 ms at the bf16 tensor-core peak) and moves ~40 MB; but its 100
// steps are a dependent chain, one grid barrier each, so the serial floor
// (L barriers) bounds it from below. The forward still runs its products
// on the CUDA cores in float32.
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and passes its stream.

#include "seq_common.cuh"
#include "seq_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace seq;

constexpr int COLS = 4 * UNITS;   // gate columns per block
constexpr int KSPLIT = 4;         // the gate product's split of H
static_assert(PART == KSPLIT * BMAX * COLS,
              "the gate product's partial sums fill PART");

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

// the activations of the recomputed gates, by column: i, f, o sigmoid,
// the candidate tanh
struct LstmAct {
  int H;
  __device__ float operator()(int col, float v) const {
    return col >= 2 * H && col < 3 * H ? tanhf(v) : sigm(v);
  }
};

// what a chain thread reads for its cell at step t: the gates (from the
// prologue, in dx), c_{t-1}, the carries' cotangents and alive
struct LstmIn {
  float i, f, u, o, cp, dh, dc, a;
};

__device__ __forceinline__ LstmIn lstm_in(const float* dx, const float* c0,
                                          const float* cs, const float* dhs,
                                          const float* dcs,
                                          const float* alive, int t, int b,
                                          int H, int row, int j) {
  const size_t o = ((size_t)t * b + row) * H + j;
  const float* g = dx + ((size_t)t * b + row) * 4 * H + j;
  return {__ldcg(g), __ldcg(g + H), __ldcg(g + 2 * H), __ldcg(g + 3 * H),
          t == 0 ? c0[row * H + j] : cs[o - (size_t)b * H], dhs[o], dcs[o],
          alive[t * b + row]};
}

// UB units x RB = THREADS / UB batch rows a chain block (module comment)
template <int UB>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
                const float* __restrict__ w, const float* __restrict__ h0,
                const float* __restrict__ c0, const float* __restrict__ hs,
                const float* __restrict__ cs, const float* __restrict__ dhs,
                const float* __restrict__ dcs, float* dx, float* dw,
                float* dh0, float* dc0, long long* stamps, int L, int b,
                int H) {
  using namespace seqmma;
  constexpr int RB = THREADS / UB, MT = UB / 16, NT = RB / 8;
  extern __shared__ float4 smem4[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(smem4);
  const int H4 = 4 * H, tid = threadIdx.x;
  cg::grid_group grid = cg::this_grid();
  stamp(stamps, 0);

  // ---- prologue: every step's gates, activated, into dx ----
  gate_gemm(h0, hs, b, L * b, w, x, dx, H4, 0, H4, H, LstmAct{H}, sm);
  grid.sync();
  stamp(stamps, 1);

  // ---- chain: t = L-1 .. 0 on batch-row groups ----
  const int U = H / UB;
  const bool active = blockIdx.x < U * ((b + RB - 1) / RB);
  const int j0 = (blockIdx.x % U) * UB, r0 = (blockIdx.x / U) * RB;
  const int row = r0 + tid / UB, j = j0 + tid % UB;
  const bool mine = active && row < b;
  const int wp = H4 + PAD, xp = xpitch(4, H);
  uint16_t* ws = sm;                                    // [UB][wp]
  float* xs = reinterpret_cast<float*>(ws + UB * wp);   // [RB][xp]
  float* part = xs + RB * xp;                           // [WARPS][UB * RB]
  __syncthreads();
  if (active) stage_w_rows(ws, wp, w + (size_t)j0 * H4, UB, H4);
  __syncthreads();
  float dh = 0.f, dc = 0.f;   // cotangents of the carries after step t
  LstmIn in{};
  if (mine) in = lstm_in(dx, c0, cs, dhs, dcs, alive, L - 1, b, H, row, j);
  for (int t = L - 1; t >= 0; --t) {
    float bo = 0.f;
    if (mine) {
      const float tc = tanhf(
          __fadd_rn(__fmul_rn(in.f, in.cp), __fmul_rn(in.i, in.u)));
      const float dht = __fadd_rn(dh, in.dh);
      const float dct = __fadd_rn(dc, in.dc);
      const float a = in.a, na = __fsub_rn(1.f, a);
      const float bp = __fmul_rn(a, dht);
      const float bs = __fmul_rn(__fmul_rn(in.o, bp), __fsub_rn(1.f, tc));
      const float dcn = __fadd_rn(__fadd_rn(__fmul_rn(a, dct), bs),
                                  __fmul_rn(bs, tc));
      const float dcand =
          __fmul_rn(__fmul_rn(in.i, dcn), __fsub_rn(1.f, in.u));
      float* dxr = dx + ((size_t)t * b + row) * H4 + j;
      __stcg(dxr, __fmul_rn(__fmul_rn(dcn, in.u),
                            __fmul_rn(in.i, __fsub_rn(1.f, in.i))));
      __stcg(dxr + H, __fmul_rn(__fmul_rn(dcn, in.cp),
                                __fmul_rn(in.f, __fsub_rn(1.f, in.f))));
      __stcg(dxr + 2 * H, __fadd_rn(dcand, __fmul_rn(dcand, in.u)));
      __stcg(dxr + 3 * H, __fmul_rn(__fmul_rn(bp, tc),
                                    __fmul_rn(in.o, __fsub_rn(1.f, in.o))));
      bo = __fmul_rn(na, dht);
      dc = __fadd_rn(__fmul_rn(na, dct), __fmul_rn(in.f, dcn));
    }
    grid.sync();   // every block's dgates_t (= dx_t) is written
    // step t-1's inputs, in flight during the product (a load before the
    // barrier would hold its fence)
    if (mine && t > 0)
      in = lstm_in(dx, c0, cs, dhs, dcs, alive, t - 1, b, H, row, j);
    if (active) {
      // the columns in two parts, the first a multiple of 128 (8 k-steps:
      // every warp's k-steps keep the order of one pass over all columns)
      float sum[MT][NT][4] = {};
      chain_staged<MT, NT>(ws, wp, xs, xp, dx + ((size_t)t * b + r0) * H4,
                           H4, b - r0, 0, H4 / 256 * 128, H4, sum);
      const float mm = chain_reduce<MT, NT>(sum, part, tid % UB, tid / UB);
      if (mine) dh = __fadd_rn(bo, bf16r(mm));
    }
  }
  if (mine) {
    dh0[row * H + j] = dh;
    dc0[row * H + j] = dc;
  }
  stamp(stamps, 2);

  // ---- epilogue: dW = sum_t bf16(bf16(h_{t-1})^T . dgates_t) ----
  const int mtiles = (H + TM - 1) / TM, ntiles = (H4 + TN - 1) / TN;
  for (int idx = blockIdx.x; idx < mtiles * ntiles; idx += gridDim.x)
    dw_tile_b(h0, hs, 1, dx, dw, H4, 0, H4, H, L, b, (idx % mtiles) * TM,
              (idx / mtiles) * TN, sm);
  stamp(stamps, 3);
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
// [L, b, H] in; dx [L, b, 4H], dw [H, 4H], dh0, dc0 [b, H] out; stamps [4]
// (int64) out: block 0's clock at the stage boundaries.
int lstm_seq_bwd(const float* x, const float* alive, const float* w,
                 const float* h0, const float* c0, const float* hs,
                 const float* cs, const float* dhs, const float* dcs,
                 float* dx, float* dw, float* dh0, float* dc0,
                 long long* stamps, int L, int b, int H, void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x,  &alive, &w,   &h0,  &c0,     &hs, &cs, &dhs, &dcs,
                  &dx, &dw,    &dh0, &dc0, &stamps, &L,  &b,  &H};
  const int ub = H % 32 == 0 ? 32 : 16;
  const size_t smem = seqmma::bwd_smem(4, H, b, ub);
  return ub == 32
             ? launch(lstm_bwd_kernel<32>, H / UNITS, smem, args, stream)
             : launch(lstm_bwd_kernel<16>, H / UNITS, smem, args, stream);
}

// an empty cooperative kernel of `blocks` blocks crossing `steps` grid
// barriers: the serial floor of a `steps`-step recurrence
int grid_barrier_chain(int blocks, int steps, void* stream) {
  void* args[] = {&steps};
  return launch(barrier_chain_kernel, blocks, 0, args, stream);
}

}  // extern "C"
