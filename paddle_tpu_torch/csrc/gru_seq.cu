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
// Design. The forward runs on the batch-row groups of lstm_seq.cu's
// backward chain: a block owns UB units of RB = 256/UB batch rows in a
// cooperative grid of H/4 blocks and keeps its units' u, r and c columns
// of W resident in shared memory as bf16 (96 KB at H 512). Unlike the
// LSTM, a GRU step needs TWO grid barriers: the candidate's product
// bf16(r*h_{t-1}) . W_c needs r of every unit. So each step a block stages
// its rows of h_{t-1} (16 KB at RB 8) as bf16, forms u and r of its cells
// on the tensor cores (csrc/seq_mma.cuh; four warps, each a 16 x 8 tile: u
// and r of 8 units by 8 rows), publishes bf16(r*h_{t-1}) of its cells into
// the rh scratch (bf16 [b, H]), crosses a barrier, stages its rows' rh of
// every unit (8 KB), forms c (each tile the c columns of the
// same 8 units, twice: a lane keeps its two cells through both halves),
// then h, writes h_t and crosses the second barrier. Each product is 32
// k-steps at H 512, each a fresh accumulator added in increasing k. That
// order is not the plain version's, so its carries differ by bf16(r*h)
// rounding moves (within chip_smoke.py's GRU limits, as the first
// version's did). The first version staged all 64 rows twice a step
// (128 KB each) and formed the products on the CUDA cores in float32: 18.5
// us a step, this one 6.6, against a 2.2-us floor of two barriers
// (PERF.md §6).
//
// The backward has the same two dependencies in reverse. It runs the
// three stages of lstm_seq.cu's backward in one cooperative launch
// (csrc/seq_mma.cuh), keeping on the serial chain only what depends on
// the carry's cotangent:
// - Prologue: u and r of every step, one GEMM over the L*b rows [h0;
//   hs[:-1]] against W_ur, activated into dx; a grid barrier; bf16(r *
//   h_{t-1}) of every step into the [L, b, H] scratch rh; a barrier; a
//   second GEMM rh . W_c gives c, activated into dx's c columns. They are
//   not the forward's gates bit for bit (another float32 order), as the
//   plain version's are not either.
// - Chain, t = L-1 .. 0, on lstm_seq.cu's batch-row groups (UB units of
//   RB rows a block, its units' rows of W in shared memory, 96 KB at H
//   512). A: dpre_u and dpre_c of its cells, written over u and c in dx_t.
//   Barrier. B: cd = bf16(dpre_c . W_c^T) from its rows' dpre_c of every
//   unit; then dpre_r, written over r. Barrier. C: its rows' dpre_u and
//   dpre_r, the dpre_r loads in flight while the dpre_u products run, each
//   warp adding its dpre_u k-steps, then its dpre_r ones, the 8 warps'
//   sums in order, rounded to bf16 once: dh_{t-1} = (((1-a)e + (1-u)ae) +
//   r*cd) + bf16([dpre_u | dpre_r] . W_ur^T). Products on the tensor cores
//   with dpre split into three bf16 parts, as the LSTM's.
// - Epilogue: dW_u,r = sum_t bf16(bf16(h_{t-1})^T . [dpre_u | dpre_r])
//   and dW_c = sum_t bf16(rh_t^T . dpre_c), t descending, tiled over W.
//
// Bound on the H100 at b 64, L 100, H 512: neither bytes nor operations.
// A layer's forward is 10 GFLOP (0.01 ms at the bf16 tensor-core peak) and
// moves ~45 MB; but its 100 steps are a dependent chain of 200 grid
// barriers, whose serial floor (~0.22 ms) bounds it from below, and the
// latency of each half-step (a barrier, a row read, 32 dependent k-step
// sums) sets its time. Every sum has a fixed order and no atomics: every
// run is bitwise the same.
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and scratch and passes its stream.

#include "seq_common.cuh"
#include "seq_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace seq;

// the A tile rows of unit u's gates: u and r in tile u / 8 (rows u % 8 and
// 8 + u % 8), so that lane l of the tile's warp holds u and r of unit
// 8 (u / 8) + l / 4 at batch rows 2 (l % 4) and 2 (l % 4) + 1; c in row
// 2 UB + u
template <int UB>
struct GruTile {
  __device__ int operator()(int u, int g) const {
    return g < 2 ? 16 * (u / 8) + u % 8 + 8 * g : 2 * UB + u;
  }
};

// UB units x RB = THREADS / UB batch rows a block (module comment)
template <int UB>
__global__ void __launch_bounds__(THREADS, 1)
gru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
               const float* __restrict__ w, const float* __restrict__ h0,
               float* hs, uint16_t* rh, int L, int b, int H) {
  using namespace seqmma;
  constexpr int RB = THREADS / UB, NT = RB / 8;
  extern __shared__ float4 smem4[];
  const int wp = H + PAD, U = H / UB, H3 = 3 * H;
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem4);   // [3 UB][wp] W^T
  uint16_t* hb = ws + 3 * UB * wp;   // [RB][wp] bf16(h), then bf16(r * h)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mq = warp / NT, nt = warp % NT;
  const bool active = blockIdx.x < U * ((b + RB - 1) / RB);
  const int j0 = (blockIdx.x % U) * UB, r0 = (blockIdx.x / U) * RB;
  const int rows = min(RB, b - r0);
  // warps 0-3 form the tiles; a lane's two cells: unit j, batch rows
  // row and row + 1
  const bool tiler = active && warp < 4;
  const int j = j0 + 8 * mq + (lane >> 2);
  const int row = r0 + 8 * nt + 2 * (lane & 3);
  const bool mine[2] = {tiler && row < b, tiler && row + 1 < b};
  const uint16_t* a_ur = ws + (16 * mq + ((lane >> 3) & 1) * 8 +
                               (lane & 7)) * wp + (lane >> 4) * 8;
  const uint16_t* a_c = ws + (2 * UB + 8 * mq + (lane & 7)) * wp +
                        (lane >> 4) * 8;
  const uint16_t* bq = hb + (8 * nt + (lane & 7)) * wp + (lane >> 3) * 8;
  cg::grid_group grid = cg::this_grid();

  if (active) {
    for (int i = tid; i < RB * wp; i += THREADS) hb[i] = 0;
    stage_w_tiles(ws, wp, w, 3, H, j0, UB, GruTile<UB>{});
  }
  __syncthreads();
  float h[2] = {};
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (mine[e]) h[e] = h0[(row + e) * H + j];
  for (int t = 0; t < L; ++t) {
    float u[2] = {}, xv[2][3] = {}, av[2] = {};
    if (active) {
      stage_h_rows(hb, wp, t == 0 ? h0 + r0 * H
                                  : hs + ((size_t)(t - 1) * b + r0) * H,
                   rows, H);
      __syncthreads();
      // the cells' x_t of u and r, in flight during the product (issued
      // after the rows' loads, which the product waits for)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (mine[e]) {
          const float* xr = x + ((size_t)t * b + row + e) * H3 + j;
          xv[e][0] = __ldg(xr);
          xv[e][1] = __ldg(xr + H);
        }
      if (tiler) {
        float sum[4] = {};
        fwd_product(a_ur, bq, H / 16, sum);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (mine[e]) {
            u[e] = sigm(__fadd_rn(xv[e][0], sum[e]));
            const float r = sigm(__fadd_rn(xv[e][1], sum[2 + e]));
            rh[(row + e) * H + j] = bf16_bits(__fmul_rn(r, h[e]));
          }
      }
    }
    grid.sync();   // bf16(r * h_{t-1}) of every unit is written
    if (active) {
      stage_bf16_rows(hb, wp, rh + r0 * H, rows, H);
      __syncthreads();
      // and of c, with alive, in flight during the second product
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (mine[e]) {
          xv[e][2] = __ldg(x + ((size_t)t * b + row + e) * H3 + 2 * H + j);
          av[e] = __ldg(alive + t * b + row + e);
        }
      if (tiler) {
        float sum[4] = {};
        fwd_product(a_c, bq, H / 16, sum);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (mine[e]) {
            const float c = tanhf(__fadd_rn(xv[e][2], sum[e]));
            const float hn = __fadd_rn(__fmul_rn(u[e], c),
                                       __fmul_rn(__fsub_rn(1.f, u[e]), h[e]));
            h[e] = __fadd_rn(__fmul_rn(av[e], hn),
                             __fmul_rn(__fsub_rn(1.f, av[e]), h[e]));
            hs[((size_t)t * b + row + e) * H + j] = h[e];
          }
      }
    }
    grid.sync();   // h_t of every unit is written
  }
}

struct Sigm {
  __device__ float operator()(int, float v) const { return sigm(v); }
};

struct Tanh {
  __device__ float operator()(int, float v) const { return tanhf(v); }
};

// what a chain thread reads for its cell at step t: u, r, c (from the
// prologue, in dx), h_{t-1}, the carry's cotangent and alive
struct GruIn {
  float u, r, c, hp, dh, a;
};

__device__ __forceinline__ GruIn gru_in(const float* dx, const float* h0,
                                        const float* hs, const float* dhs,
                                        const float* alive, int t, int b,
                                        int H, int row, int j) {
  const size_t o = ((size_t)t * b + row) * H + j;
  const float* g = dx + ((size_t)t * b + row) * 3 * H + j;
  return {__ldcg(g), __ldcg(g + H), __ldcg(g + 2 * H),
          t == 0 ? h0[row * H + j] : hs[o - (size_t)b * H], dhs[o],
          alive[t * b + row]};
}

// UB units x RB = THREADS / UB batch rows a chain block (module comment)
template <int UB>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_kernel(const float* __restrict__ x, const float* __restrict__ alive,
               const float* __restrict__ w, const float* __restrict__ h0,
               const float* __restrict__ hs, const float* __restrict__ dhs,
               float* dx, float* dw, float* dh0, float* rh,
               long long* stamps, int L, int b, int H) {
  using namespace seqmma;
  constexpr int RB = THREADS / UB, MT = UB / 16, NT = RB / 8;
  extern __shared__ float4 smem4[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(smem4);
  const int H3 = 3 * H, tid = threadIdx.x, M = L * b;
  cg::grid_group grid = cg::this_grid();
  stamp(stamps, 0);

  // ---- prologue: every step's u, r, then bf16(r * h_{t-1}), then c ----
  gate_gemm(h0, hs, b, M, w, x, dx, H3, 0, 2 * H, H, Sigm{}, sm);
  grid.sync();
  {   // four elements a thread at a time, eight in flight
    const int q = H / 4, per_block = (M * q + gridDim.x - 1) / gridDim.x;
    const int first = blockIdx.x * per_block;
    const int last = min(M * q, first + per_block);
    batched<8>(
        last - first,
        [&](int i) {
          const int m = (first + i) / q, k = ((first + i) % q) * 4;
          const float4 r = __ldcg(reinterpret_cast<const float4*>(
              dx + (size_t)m * H3 + H + k));
          const float4 h = __ldg(reinterpret_cast<const float4*>(
              m < b ? h0 + (size_t)m * H + k : hs + (size_t)(m - b) * H + k));
          return make_float4(bf16r(__fmul_rn(r.x, h.x)),
                             bf16r(__fmul_rn(r.y, h.y)),
                             bf16r(__fmul_rn(r.z, h.z)),
                             bf16r(__fmul_rn(r.w, h.w)));
        },
        [&](int i, float4 v) {
          reinterpret_cast<float4*>(rh)[first + i] = v;
        });
  }
  grid.sync();
  gate_gemm(rh, rh, 0, M, w, x, dx, H3, 2 * H, H, H, Tanh{}, sm);
  grid.sync();
  stamp(stamps, 1);

  // ---- chain: t = L-1 .. 0 on batch-row groups, two barriers a step ----
  const int U = H / UB;
  const bool active = blockIdx.x < U * ((b + RB - 1) / RB);
  const int j0 = (blockIdx.x % U) * UB, r0 = (blockIdx.x / U) * RB;
  const int row = r0 + tid / UB, j = j0 + tid % UB;
  const bool mine = active && row < b;
  const int wp = H3 + PAD, xp = xpitch(3, H);
  const int ks = H / 16;   // k-steps of one gate's columns
  uint16_t* ws = sm;                                    // [UB][wp]
  float* xs = reinterpret_cast<float*>(ws + UB * wp);   // [RB][xp]
  float* part = xs + RB * xp;                           // [WARPS][UB * RB]
  __syncthreads();
  if (active) stage_w_rows(ws, wp, w + (size_t)j0 * H3, UB, H3);
  __syncthreads();
  float dh = 0.f;   // cotangent of the carry after step t
  GruIn in{};
  if (mine) in = gru_in(dx, h0, hs, dhs, alive, L - 1, b, H, row, j);
  for (int t = L - 1; t >= 0; --t) {
    float* dxr = dx + ((size_t)t * b + row) * H3 + j;
    const float* dgt = dx + ((size_t)t * b + r0) * H3;
    float r = 0.f, hp = 0.f, bn = 0.f;
    if (mine) {
      const float u = in.u, c = in.c, a = in.a;
      r = in.r;
      hp = in.hp;
      const float e = __fadd_rn(dh, in.dh);
      const float bl = __fmul_rn(a, e);
      bn = __fadd_rn(__fmul_rn(__fsub_rn(1.f, a), e),
                     __fmul_rn(__fsub_rn(1.f, u), bl));
      const float du = __fsub_rn(__fmul_rn(bl, c), __fmul_rn(bl, hp));
      const float bt = __fmul_rn(__fmul_rn(u, bl), __fsub_rn(1.f, c));
      __stcg(dxr, __fmul_rn(du, __fmul_rn(u, __fsub_rn(1.f, u))));
      __stcg(dxr + 2 * H, __fadd_rn(bt, __fmul_rn(bt, c)));
    }
    grid.sync();   // every unit's dpre_u and dpre_c are written
    // step t-1's inputs, in flight during the products (a load before a
    // barrier would hold its fence)
    if (mine && t > 0)
      in = gru_in(dx, h0, hs, dhs, alive, t - 1, b, H, row, j);
    float cf = 0.f;
    if (active) {   // cd = bf16(dpre_c . W_c^T), then dpre_r
      stage_dgates<RB>(xs, xp, dgt, H3, b - r0, 2 * H, 3 * H);
      __syncthreads();
      float sum[MT][NT][4] = {};
      chain_product<MT, NT>(ws, wp, xs, xp, 2 * ks, 3 * ks, sum);
      const float cd =
          bf16r(chain_reduce<MT, NT>(sum, part, tid % UB, tid / UB));
      if (mine) {
        __stcg(dxr + H, __fmul_rn(__fmul_rn(cd, hp),
                                  __fmul_rn(r, __fsub_rn(1.f, r))));
        cf = __fadd_rn(bn, __fmul_rn(r, cd));
      }
    }
    grid.sync();   // every unit's dpre_r is written
    if (active) {   // dh_{t-1}: the dpre_u part, then the dpre_r part
      float sum[MT][NT][4] = {};
      chain_staged<MT, NT>(ws, wp, xs, xp, dgt, H3, b - r0, 0, H, 2 * H,
                           sum);
      const float ct = chain_reduce<MT, NT>(sum, part, tid % UB, tid / UB);
      if (mine) dh = __fadd_rn(cf, bf16r(ct));
    }
  }
  if (mine) dh0[row * H + j] = dh;
  stamp(stamps, 2);

  // ---- epilogue: dW_u,r from bf16(h_{t-1}), dW_c from rh_t ----
  const int mtiles = (H + TM - 1) / TM, nt_ur = (2 * H + TN - 1) / TN;
  const int tiles = mtiles * (nt_ur + (H + TN - 1) / TN);
  for (int idx = blockIdx.x; idx < tiles; idx += gridDim.x) {
    const int m0 = (idx % mtiles) * TM, nt = idx / mtiles;
    if (nt < nt_ur)
      dw_tile_b(h0, hs, 1, dx, dw, H3, 0, 2 * H, H, L, b, m0, nt * TN, sm);
    else
      dw_tile_b(rh, rh, 0, dx, dw, H3, 2 * H, H, H, L, b, m0,
                (nt - nt_ur) * TN, sm);
  }
  stamp(stamps, 3);
}

}  // namespace

extern "C" {

// x [L, b, 3H], alive [L, b, 1], w [H, 3H], h0 [b, H] in; hs [L, b, H]
// out; all float32; rh [b, H] bf16 scratch (bf16(r * h_{t-1})); all
// contiguous, on the current device.
int gru_seq_fwd(const float* x, const float* alive, const float* w,
                const float* h0, float* hs, uint16_t* rh, int L, int b,
                int H, void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &alive, &w, &h0, &hs, &rh, &L, &b, &H};
  const int ub = H % 32 == 0 ? 32 : 16;
  const size_t smem = seqmma::tile_fwd_smem(3, H, ub);
  return ub == 32
             ? launch(gru_fwd_kernel<32>, H / UNITS, smem, args, stream)
             : launch(gru_fwd_kernel<16>, H / UNITS, smem, args, stream);
}

// the forward's inputs, its carries hs and their cotangents dhs [L, b, H]
// in; dx [L, b, 3H], dw [H, 3H], dh0 [b, H] out; rh [L, b, H] scratch;
// stamps [4] (int64) out: block 0's clock at the stage boundaries.
int gru_seq_bwd(const float* x, const float* alive, const float* w,
                const float* h0, const float* hs, const float* dhs,
                float* dx, float* dw, float* dh0, float* rh,
                long long* stamps, int L, int b, int H, void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x,  &alive, &w,  &h0,     &hs, &dhs, &dx,
                  &dw, &dh0,   &rh, &stamps, &L,  &b,   &H};
  const int ub = H % 32 == 0 ? 32 : 16;
  const size_t smem = seqmma::bwd_smem(3, H, b, ub);
  return ub == 32
             ? launch(gru_bwd_kernel<32>, H / UNITS, smem, args, stream)
             : launch(gru_bwd_kernel<16>, H / UNITS, smem, args, stream);
}

}  // extern "C"
