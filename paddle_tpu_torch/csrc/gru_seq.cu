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
// Design. The forward takes the cooperative, persistent partition of
// lstm_seq.cu's forward: block j owns hidden units 4j..4j+3 and their 12
// gate columns (u, r, c of each), keeps that column slice of W
// (bf16-rounded, as float32: 24 KB at H 512) in shared memory for all L
// steps and does its units' cell math itself.
// Unlike the LSTM, a GRU step needs TWO grid-wide barriers: the candidate's
// product bf16(r*h_{t-1}) . W_c needs r of every unit, so each step
// computes u and r of its own units, publishes bf16(r*h_{t-1}) (a [b, H]
// scratch), crosses a barrier, computes c and h, publishes h (into hs) and
// crosses the second barrier.
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
// A layer's forward is 10 GFLOP (the products, 0.15 ms at 67 TFLOP/s on
// the CUDA cores) and moves ~45 MB; but its 100 steps are a dependent
// chain of 200 grid barriers, whose serial floor bounds it from below.
// The forward still runs its products on the CUDA cores in float32, in a
// fixed summation order (every run is bitwise the same).
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and scratch and passes its stream.

#include "seq_common.cuh"
#include "seq_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace seq;

constexpr int COLS = 3 * UNITS;   // gate columns per block: u, r, c
static_assert(PART == 8 * BMAX * 8 && PART == 16 * BMAX * UNITS,
              "the column products' partial sums fill PART");

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
// out; rh [b, H] scratch; all float32, contiguous, on the current device.
int gru_seq_fwd(const float* x, const float* alive, const float* w,
                const float* h0, float* hs, float* rh, int L, int b, int H,
                void* stream) {
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &alive, &w, &h0, &hs, &rh, &L, &b, &H};
  return launch(gru_fwd_kernel, H / UNITS, fwd_smem<3>(H), args, stream);
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
