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
// forward is a persistent COOPERATIVE grid of H/4 blocks, one grid barrier
// a step. Batch rows are independent, so a block owns UB hidden units (32,
// or 16 where H is not a multiple of 32) of RB = 256/UB batch rows (the
// GRU forward's batch-row groups, gru_seq.cu), keeps its units' 4 UB gate
// columns of W in shared memory as bf16 rows (W^T, 128 KB at H 512) for
// all L steps, and each step stages only its rows of h_{t-1} as bf16 (16
// KB at RB 8), read from the L2, where the blocks of its row group wrote
// them. Each of its 8 warps forms one 16 x 8 tile of the block's [4 UB,
// RB] gate tile (16 gate columns in gate-major order by 8 rows) on the
// tensor cores (csrc/seq_mma.cuh: `mma.sync` m16n8k16 bf16, a fresh
// float32 accumulator each 16-deep k-step, the k-steps added in
// increasing k on the CUDA cores) into shared memory; then a thread a
// cell adds x_t and does the cell math and the alive blend, and writes
// h_t, c_t. Every sum has a fixed order and no atomics: every run is
// bitwise the same. The first version (4 units of all 64 rows a block,
// staging all of h and summing on the CUDA cores) took 13.3 us a step,
// 1.29 ms a launch at b 64, L 100, H 512 (PERF.md §6).
//
// Accuracy. The products are exact (bf16 x bf16 in float32), so the
// kernel differs from the plain version (torch.matmul, whatever order the
// library sums in) only in the float32 order of the sums; but a float32
// step of difference in h_{t-1} moves bf16(h_{t-1}) by 2^-8 of itself now
// and then, and every gate of its row with it, and later steps carry it
// on. So the carries are held as the GRU's are (chip_smoke.py phase 5):
// within 1e-2 of the largest element and 2e-3 in ||d||_2 of the plain
// version's, and no further from the same recipe in float64 than twice
// the plain version's distance. Neither order is nearer the truth: both
// round the same exact products' sums once per add.
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
// - Chain, t = L-1 .. 0, one grid barrier a step, on the forward's
//   batch-row groups: a chain block holds its UB units' rows of W in
//   shared memory (bf16, 128 KB at H 512) and does its cells' math
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
// A layer's forward is 13.4 GFLOP (0.014 ms at the bf16 tensor-core peak)
// and moves ~40 MB; but its 100 steps are a dependent chain, one grid
// barrier each, so the serial floor (L barriers, ~0.11 ms) bounds it from
// below, and the latency of a step (a barrier, a row read, 32 dependent
// k-step sums, the cell math) sets its time.
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and passes its stream.

#include "seq_common.cuh"
#include "seq_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace seq;

// the A tile row of unit u's gate g: gate-major, so that warp m's tile
// holds gate (16 m) / UB of units 16 m % UB .. + 15
template <int UB>
struct LstmTile {
  __device__ int operator()(int u, int g) const { return g * UB + u; }
};

// UB units x RB = THREADS / UB batch rows a block (module comment)
template <int UB>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
                const float* __restrict__ w, const float* __restrict__ h0,
                const float* __restrict__ c0, float* hs, float* cs, int L,
                int b, int H) {
  using namespace seqmma;
  constexpr int RB = THREADS / UB, NT = RB / 8, COLS = 4 * UB;
  extern __shared__ float4 smem4[];
  const int wp = H + PAD, U = H / UB, H4 = 4 * H;
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem4);    // [COLS][wp] W^T
  uint16_t* hb = ws + COLS * wp;                        // [RB][wp] bf16(h)
  float* gs = reinterpret_cast<float*>(hb + RB * wp);   // [RB][COLS] sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp / NT, nt = warp % NT;
  const bool active = blockIdx.x < U * ((b + RB - 1) / RB);
  const int j0 = (blockIdx.x % U) * UB, r0 = (blockIdx.x / U) * RB;
  const int rows = min(RB, b - r0);
  // a thread's cell: unit j, batch row `row`
  const int u = tid % UB, row = r0 + tid / UB, j = j0 + u;
  const bool mine = active && row < b;
  const uint16_t* a = ws + (16 * mt + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                               wp + (lane >> 4) * 8;
  const uint16_t* bq = hb + (8 * nt + (lane & 7)) * wp + (lane >> 3) * 8;
  // where the lane's four sums go: gate columns gc and gc + 8 of batch
  // rows br and br + 1
  const int gc = 16 * mt + (lane >> 2), br = 8 * nt + 2 * (lane & 3);
  cg::grid_group grid = cg::this_grid();

  if (active) {
    for (int i = tid; i < RB * wp; i += THREADS) hb[i] = 0;
    stage_w_tiles(ws, wp, w, 4, H, j0, UB, LstmTile<UB>{});
  }
  __syncthreads();
  float h = 0.f, c = 0.f;
  if (mine) {
    h = h0[row * H + j];
    c = c0[row * H + j];
  }
  for (int t = 0; t < L; ++t) {
    if (active) {
      stage_h_rows(hb, wp, t == 0 ? h0 + r0 * H
                                  : hs + ((size_t)(t - 1) * b + r0) * H,
                   rows, H);
      __syncthreads();
      // the cell's x_t and alive, in flight during the product (issued
      // after the rows' loads, which the product waits for)
      float xv[4] = {}, av = 0.f;
      if (mine) {
        const float* xr = x + ((size_t)t * b + row) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[g] = __ldg(xr + g * H);
        av = __ldg(alive + t * b + row);
      }
      float sum[4] = {};
      fwd_product(a, bq, H / 16, sum);
      gs[br * COLS + gc] = sum[0];
      gs[(br + 1) * COLS + gc] = sum[1];
      gs[br * COLS + gc + 8] = sum[2];
      gs[(br + 1) * COLS + gc + 8] = sum[3];
      __syncthreads();
      if (mine) {
        const float* gr = gs + (tid / UB) * COLS + u;
        const float ig = sigm(__fadd_rn(xv[0], gr[0]));
        const float fg = sigm(__fadd_rn(xv[1], gr[UB]));
        const float cand = tanhf(__fadd_rn(xv[2], gr[2 * UB]));
        const float og = sigm(__fadd_rn(xv[3], gr[3 * UB]));
        const float cn = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, cand));
        const float hn = __fmul_rn(og, tanhf(cn));
        const float na = __fsub_rn(1.f, av);
        h = __fadd_rn(__fmul_rn(av, hn), __fmul_rn(na, h));
        c = __fadd_rn(__fmul_rn(av, cn), __fmul_rn(na, c));
        const size_t o = ((size_t)t * b + row) * H + j;
        hs[o] = h;
        cs[o] = c;
      }
    }
    grid.sync();   // h_t of every unit is written
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
  const int ub = H % 32 == 0 ? 32 : 16;
  // W's columns and the rows of h (bf16), then the gate tile (float32)
  const size_t smem =
      seqmma::tile_fwd_smem(4, H, ub) + sizeof(float) * 4 * THREADS;
  return ub == 32
             ? launch(lstm_fwd_kernel<32>, H / UNITS, smem, args, stream)
             : launch(lstm_fwd_kernel<16>, H / UNITS, smem, args, stream);
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
