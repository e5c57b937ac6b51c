"""Where one step of the recurrent kernels goes on the card, what the
exchanges and barriers a design could use cost alone, and another tree's
kernels against this checkout's.

    python3 seq_split.py --tree DIR [--parts split,bwdsplit,exchange,
                                     compare,barrier,lstmtc,steps]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card; a measurement tool beside chip_smoke.py, not part of the port's
package. Prints the card's name and power limit, then, by part (default
``split,compare``):

* ``split``: for ``lstm_fwd_kernel`` and ``gru_fwd_kernel`` of ``--tree``
  (the first versions, or the batch-row GRU forward after commit 2db8ad5;
  the anchors pick which), the cycles of each phase of
  one step (staging, products, reductions, cell math, barriers), averaged
  over blocks and steps at b 64, L 100, H 512: the kernel is copied, a
  ``clock64`` stamp (with a block barrier) is inserted at each phase's end
  at fixed anchors of its source, and the copies build under
  ``build/torch_kernels/seq_split/``. The launch's time with and without
  the stamps shows what they cost.
* ``bwdsplit``: the same for ``lstm_bwd_kernel`` and ``gru_bwd_kernel`` of
  the first version (up to commit 6225d18).
* ``exchange``: what a step's exchange costs alone (no products), over
  100 steps of 128 blocks: every block writing what it owns and reading
  what it needs after a barrier, for (a) the first backward's broadcast
  of every block's dgates (512 KB in), (b) partial products split over the
  gate columns (128 KB out and 128 KB in, two barriers), (d) batch-row
  groups of 8 rows (4 KB out, 64 KB in as the backwards' dgates, 16 KB as
  the forwards' h), one and two grid barriers alone, and a barrier of the
  16 blocks of a row group (a counter each, alone and under (d)); then
  whether the card takes a cooperative launch with a cluster dimension,
  and how many clusters of 8 and 16 blocks of 200 KB can be resident.
* ``compare``: the four recurrent kernels of ``--tree`` (from commit
  7dfac6d on) against this checkout's, launch for launch at b 64, H 512,
  L 100 and 200, timed in turns (tree, this, this, tree), and this
  checkout's backward stage shares (prologue, chain, epilogue) from its
  kernels' clocks.
* ``barrier``: this checkout's GRU forward as it is (grid barriers)
  against a copy whose steps wait only for the blocks of their row group,
  in turns (grid, group, group, grid), the carries compared bitwise.
* ``lstmtc``: this checkout's LSTM forward against a forward on the GRU's
  batch-row groups and tensor-core tiles (``LSTM_TC_SRC``, built into a
  copy of ``lstm_seq.cu``), on chip_smoke.py phase 5's operands at L 100
  and 200: each one's distance to the plain version and to the float64
  recipe, which of chip_smoke.py's criteria the tensor-core one meets, a
  bitwise repeat, and both launches' times in turns.
* ``steps``: chip_smoke.py's phases 6, 8 and 9 (the LSTM and GRU
  classifiers and the CTC model, trained on both routes) run from
  ``--tree`` and from this checkout, ten runs each in alternating pairs,
  each in a process of its own; prints each run's steady ms a step, then
  each phase's kernel-route times by pair and whether this checkout is
  faster in every pair.

Nothing runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

from paddle_tpu_torch.ops.cuda import build

OUT = build.BUILD_DIR / "seq_split"

STAMPS = r"""
__device__ long long split_cycles[128 * 24];
__device__ long long split_prev[128];
#define STAMP_START()                                                     \
  do {                                                                    \
    if (threadIdx.x == 0) split_prev[blockIdx.x] = clock64();             \
  } while (0)
#define STAMP(i)                                                          \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0) {                                               \
      const long long n_ = clock64();                                     \
      split_cycles[blockIdx.x * 24 + (i)] += n_ - split_prev[blockIdx.x]; \
      split_prev[blockIdx.x] = n_;                                        \
    }                                                                     \
  } while (0)
extern "C" int split_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, split_cycles, sizeof(split_cycles));
}
extern "C" int split_reset() {
  static long long zero[128 * 24];
  return (int)cudaMemcpyToSymbol(split_cycles, zero, sizeof(zero));
}
"""

DECL = "  STAMP_START();\n"

# (anchor, replacement) pairs, each anchor found exactly once; STAMP(i)
# adds the cycles since the previous stamp to phase i
LSTM_PATCH = [
    ("  float* dg_s = gates_s + BMAX * COLS; // [BMAX][COLS] dgates_t, "
     "own columns\n",
     "  float* dg_s = gates_s + BMAX * COLS; // [BMAX][COLS] dgates_t, "
     "own columns\n" + DECL),
    ("  float dh = 0.f, dc = 0.f;   // cotangents of the carries after step "
     "t\n",
     "  float dh = 0.f, dc = 0.f;   // cotangents of the carries after step "
     "t\n  STAMP(0);\n"),
    ("               H, true);\n    __syncthreads();\n    gate_preact(hs_s, "
     "hp, w_s, part, gates_s, x + (size_t)t * b * H4, b, H,\n"
     "                j0);\n",
     "               H, true);\n    __syncthreads();\n    STAMP(1);\n"
     "    gate_preact(hs_s, hp, w_s, part, gates_s, x + (size_t)t * b * H4, "
     "b, H,\n                j0);\n    STAMP(2);\n"),
    ("    __syncthreads();\n    if (dw_mine) {\n",
     "    STAMP(3);\n    if (dw_mine) {\n"),
    ("    grid.sync();   // every block's dgates_t (= dx_t) is written\n",
     "    STAMP(4);\n    grid.sync();\n    STAMP(5);\n"),
    ("      stage_rows(hs_s, hp, dx + (size_t)t * b * H4 + ch * H, b, H, H4,\n"
     "                 false);\n      __syncthreads();\n",
     "      stage_rows(hs_s, hp, dx + (size_t)t * b * H4 + ch * H, b, H, H4,\n"
     "                 false);\n      __syncthreads();\n      STAMP(6);\n"),
    ("              acc[r][u] = fmaf(dv[r][e], wv[u][e], acc[r][u]);\n"
     "      }\n    }\n",
     "              acc[r][u] = fmaf(dv[r][e], wv[u][e], acc[r][u]);\n"
     "      }\n      STAMP(7);\n    }\n"),
    ("      dh = __fadd_rn(bo, bf16r(mm));\n    }\n  }\n",
     "      dh = __fadd_rn(bo, bf16r(mm));\n    }\n    STAMP(8);\n  }\n"),
]
LSTM_PHASES = {1: "stage bf16(h_{t-1}), 128 KB", 2: "recompute gates",
               3: "cell math, dgates out", 4: "dW accumulate",
               5: "grid barrier", 6: "stage dgates, 4 x 128 KB",
               7: "dh product", 8: "dh reduction (16-way)"}

GRU_PATCH = [
    ("  float* dg_s = gates_s + BMAX * COLS; // [BMAX][COLS] dgates_t, "
     "own columns\n",
     "  float* dg_s = gates_s + BMAX * COLS; // [BMAX][COLS] dgates_t, "
     "own columns\n" + DECL),
    ("  // ---- every step's u and r (into dx) and bf16(r * h_{t-1}) ----\n",
     "  STAMP(0);\n"),
    ("               H, true);\n    __syncthreads();\n    col_product<2 * "
     "UNITS>(a_s, hp, w_s, 0, part, gates_s,\n                           x + "
     "(size_t)t * b * H3, b, H, j0);\n",
     "               H, true);\n    __syncthreads();\n    STAMP(1);\n"
     "    col_product<2 * UNITS>(a_s, hp, w_s, 0, part, gates_s,\n"
     "                           x + (size_t)t * b * H3, b, H, j0);\n"
     "    STAMP(2);\n"),
    ("      rh[o] = bf16r(__fmul_rn(r, hprev));\n    }\n  }\n  grid.sync();\n",
     "      rh[o] = bf16r(__fmul_rn(r, hprev));\n    }\n    STAMP(3);\n  }\n"
     "  grid.sync();\n  STAMP(4);\n"),
    ("    stage_rows(a_s, hp, rh + (size_t)t * b * H, b, H, H, false);\n"
     "    __syncthreads();\n    col_product<UNITS>(a_s, hp, w_s, 2 * UNITS, "
     "part, gates_s,\n                       x + (size_t)t * b * H3, b, H, "
     "j0);\n",
     "    stage_rows(a_s, hp, rh + (size_t)t * b * H, b, H, H, false);\n"
     "    __syncthreads();\n    STAMP(5);\n    col_product<UNITS>(a_s, hp, "
     "w_s, 2 * UNITS, part, gates_s,\n                       x + (size_t)t "
     "* b * H3, b, H, j0);\n    STAMP(6);\n"),
    ("    __syncthreads();\n    dw_accumulate<2 * UNITS, UNITS>(a_s, hp, "
     "dg_s, b, H, dwacc);\n    grid.sync();   // every unit's dpre_c (dx_t's "
     "c columns) is written\n",
     "    STAMP(7);\n    dw_accumulate<2 * UNITS, UNITS>(a_s, hp, dg_s, b, H, "
     "dwacc);\n    STAMP(8);\n    grid.sync();\n    STAMP(9);\n"),
    ("    stage_rows(a_s, hp, dxt + 2 * H, b, H, H3, false);\n"
     "    __syncthreads();\n    row_product(a_s, hp, wr_s, H3, 2 * H, H, "
     "acc);\n    const float cd = bf16r(row_reduce(acc, part, row, jj, "
     "mine));\n",
     "    stage_rows(a_s, hp, dxt + 2 * H, b, H, H3, false);\n"
     "    __syncthreads();\n    STAMP(10);\n    row_product(a_s, hp, wr_s, "
     "H3, 2 * H, H, acc);\n    STAMP(11);\n    const float cd = "
     "bf16r(row_reduce(acc, part, row, jj, mine));\n    STAMP(12);\n"),
    ("    stage_rows(a_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, b, "
     "H,\n               H, true);\n    __syncthreads();\n    "
     "dw_accumulate<0, 2 * UNITS>(a_s, hp, dg_s, b, H, dwacc);\n"
     "    grid.sync();   // every unit's dpre_u and dpre_r are written\n",
     "    STAMP(13);\n    stage_rows(a_s, hp, t == 0 ? h0 : hs + (size_t)(t "
     "- 1) * b * H, b, H,\n               H, true);\n    __syncthreads();\n"
     "    STAMP(14);\n    dw_accumulate<0, 2 * UNITS>(a_s, hp, dg_s, b, H, "
     "dwacc);\n    STAMP(15);\n    grid.sync();\n    STAMP(16);\n"),
    ("      stage_rows(a_s, hp, dxt + ch * H, b, H, H3, false);\n"
     "      __syncthreads();\n      row_product(a_s, hp, wr_s, H3, ch * H, "
     "H, acc);\n    }\n",
     "      stage_rows(a_s, hp, dxt + ch * H, b, H, H3, false);\n"
     "      __syncthreads();\n      STAMP(17);\n      row_product(a_s, hp, "
     "wr_s, H3, ch * H, H, acc);\n      STAMP(18);\n    }\n"),
    ("    if (mine) dh = __fadd_rn(cf, bf16r(ct));\n  }\n",
     "    if (mine) dh = __fadd_rn(cf, bf16r(ct));\n    STAMP(19);\n  }\n"),
]
GRU_PHASES = {1: "pass 1: stage bf16(h_{t-1}), 128 KB",
              2: "pass 1: u, r product", 3: "pass 1: u, r, rh out",
              5: "stage rh, 128 KB", 6: "recompute c (product)",
              7: "cell math A: dpre_u, dpre_c out", 8: "dW_c accumulate",
              9: "grid barrier 1", 10: "stage dpre_c, 128 KB",
              11: "cd product", 12: "cd reduction (16-way)",
              13: "cell math B: dpre_r out", 14: "stage bf16(h_{t-1}), 128 KB",
              15: "dW_u,r accumulate", 16: "grid barrier 2",
              17: "stage dpre_u, dpre_r, 2 x 128 KB", 18: "dh product",
              19: "dh reduction (16-way)"}

# the first-version forwards (csrc up to commit 2db8ad5): block j owns 4
# units of every batch row and stages all of h_{t-1} each step
FWD_LSTM_PATCH = [
    ("  for (int t = 0; t < L; ++t) {\n    __syncthreads();\n"
     "    stage_rows(hs_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, "
     "b, H,\n               H, true);\n    __syncthreads();\n",
     "  STAMP_START();\n  for (int t = 0; t < L; ++t) {\n"
     "    __syncthreads();\n"
     "    stage_rows(hs_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, "
     "b, H,\n               H, true);\n    STAMP(1);\n"),
    ("          acc[r][c] = fmaf(hv[r][kk], wv[kk][c], acc[r][c]);\n  }\n",
     "          acc[r][c] = fmaf(hv[r][kk], wv[kk][c], acc[r][c]);\n  }\n"
     "  STAMP(2);\n"),
    ("    gates_s[o] = g;\n  }\n  __syncthreads();\n}\n",
     "    gates_s[o] = g;\n  }\n  STAMP(3);\n}\n"),
    ("      hs[o] = h;\n      cs[o] = c;\n    }\n    grid.sync();\n",
     "      hs[o] = h;\n      cs[o] = c;\n    }\n    STAMP(4);\n"
     "    grid.sync();\n    STAMP(5);\n"),
]
FWD_LSTM_PHASES = {1: "stage bf16(h_{t-1}), 64 rows, 128 KB",
                   2: "gate product (CUDA cores)",
                   3: "4 partial sums + x_t", 4: "cell math, hs/cs out",
                   5: "grid barrier"}

FWD_GRU_PATCH = [
    ("  for (int t = 0; t < L; ++t) {\n"
     "    const float* xt = x + (size_t)t * b * H3;\n    __syncthreads();\n"
     "    stage_rows(a_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, "
     "b, H,\n               H, true);\n    __syncthreads();\n",
     "  STAMP_START();\n  for (int t = 0; t < L; ++t) {\n"
     "    const float* xt = x + (size_t)t * b * H3;\n    __syncthreads();\n"
     "    stage_rows(a_s, hp, t == 0 ? h0 : hs + (size_t)(t - 1) * b * H, "
     "b, H,\n               H, true);\n    STAMP(1);\n"),
    ("          acc[r][c] = fmaf(av[r][kk], wv[kk][c], acc[r][c]);\n  }\n",
     "          acc[r][c] = fmaf(av[r][kk], wv[kk][c], acc[r][c]);\n  }\n"
     "  STAMP(NC == 8 ? 2 : 7);\n"),
    ("          __fadd_rn(xt[row * 3 * H + gcol(c0 + c, j0, H)], mm);\n"
     "    }\n  }\n  __syncthreads();\n}\n",
     "          __fadd_rn(xt[row * 3 * H + gcol(c0 + c, j0, H)], mm);\n"
     "    }\n  }\n  STAMP(NC == 8 ? 3 : 8);\n}\n"),
    ("    grid.sync();   // every unit's bf16(r * h_{t-1}) is written\n"
     "    stage_rows(a_s, hp, rh, b, H, H, false);\n    __syncthreads();\n",
     "    STAMP(4);\n    grid.sync();\n    STAMP(5);\n"
     "    stage_rows(a_s, hp, rh, b, H, H, false);\n    STAMP(6);\n"),
    ("    grid.sync();   // every unit's h_t is written\n",
     "    STAMP(9);\n    grid.sync();\n    STAMP(10);\n"),
]
FWD_GRU_PHASES = {1: "stage bf16(h_{t-1}), 64 rows, 128 KB",
                  2: "u, r product (CUDA cores)", 3: "u, r partial sums + x",
                  4: "u, r math, rh out", 5: "grid barrier 1",
                  6: "stage rh, 64 rows, 128 KB",
                  7: "c product (CUDA cores)", 8: "c partial sums + x",
                  9: "c, h math, hs out", 10: "grid barrier 2"}

# a barrier of the blocks of one row group, for the forwards' measurement
# (not in the port): `n` blocks share the counter `c`; each arrives once,
# after its block's writes and a fence, then waits until the count reaches
# `target`, the count the launch found plus n for every barrier so far. The
# counters are never reset: launches on one stream run one after another
ROW_BARRIER = r"""
__device__ unsigned rg_counters[64];
__device__ __forceinline__ unsigned rg_load(const unsigned* c) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(c) : "memory");
  return v;
}
__device__ __forceinline__ void rg_sync(unsigned* c, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(c, 1u);
    while ((int)(rg_load(c) - target) < 0) {
    }
  }
  __syncthreads();
}
"""

# the batch-row GRU forward (after commit 2db8ad5): a block owns UB units
# of RB rows and stages only its rows of h_{t-1}
ROW_GRU_PATCH = [
    ("    if (mine[e]) h[e] = h0[(row + e) * H + j];\n"
     "  for (int t = 0; t < L; ++t) {\n",
     "    if (mine[e]) h[e] = h0[(row + e) * H + j];\n  STAMP_START();\n"
     "  for (int t = 0; t < L; ++t) {\n"),
    ("                   rows, H);\n      __syncthreads();\n",
     "                   rows, H);\n      STAMP(1);\n"),
    ("            rhg[(row + e) * H + j] = bf16_bits(__fmul_rn(r, h[e]));\n"
     "          }\n      }\n    }\n"
     "    grid.sync();   // bf16(r * h_{t-1}) of every unit is written\n",
     "            rhg[(row + e) * H + j] = bf16_bits(__fmul_rn(r, h[e]));\n"
     "          }\n      }\n      STAMP(2);\n    }\n"
     "    grid.sync();   // bf16(r * h_{t-1}) of every unit is written\n"
     "    STAMP(3);\n"),
    ("      stage_bf16_rows(hb, wp, rhg + r0 * H, rows, H);\n"
     "      __syncthreads();\n",
     "      stage_bf16_rows(hb, wp, rhg + r0 * H, rows, H);\n"
     "      STAMP(4);\n"),
    ("            hs[((size_t)t * b + row + e) * H + j] = h[e];\n"
     "          }\n      }\n    }\n"
     "    grid.sync();   // h_t of every unit is written\n",
     "            hs[((size_t)t * b + row + e) * H + j] = h[e];\n"
     "          }\n      }\n      STAMP(5);\n    }\n"
     "    grid.sync();   // h_t of every unit is written\n    STAMP(6);\n"),
]
ROW_GRU_PHASES = {1: "stage bf16(h_{t-1}), 16 KB",
                  2: "x loads, u, r product (4 warps), math, rh out",
                  3: "grid barrier 1", 4: "stage rh (bf16), 8 KB",
                  5: "x loads, c product (4 warps), h math, hs out",
                  6: "grid barrier 2"}

# the split of each forward: the first version's, then the batch-row one's
FWD_LSTM_PATCHES = [(FWD_LSTM_PATCH, FWD_LSTM_PHASES)]
FWD_GRU_PATCHES = [(FWD_GRU_PATCH, FWD_GRU_PHASES),
                   (ROW_GRU_PATCH, ROW_GRU_PHASES)]

# this checkout's GRU forward with each grid barrier of its steps replaced
# by a barrier of the row group's blocks (ROW_BARRIER): the block reads its
# counter's base before a first grid barrier; blocks without rows wait for
# no one
ROWBAR_GRU_PATCH = [
    ("  const uint16_t* bq = hb + (8 * nt + (lane & 7)) * wp + "
     "(lane >> 3) * 8;\n  cg::grid_group grid = cg::this_grid();\n",
     "  const uint16_t* bq = hb + (8 * nt + (lane & 7)) * wp + "
     "(lane >> 3) * 8;\n  cg::grid_group grid = cg::this_grid();\n"
     "  unsigned* rg_c = rg_counters + blockIdx.x / U;\n"
     "  const unsigned rg_base = rg_load(rg_c);\n"
     "  unsigned rg_n = 0;\n  grid.sync();\n"),
] + [(f"    grid.sync();   // {what} of every unit is written\n",
      "    if (active) rg_sync(rg_c, rg_base + (unsigned)U * ++rg_n);\n")
     for what in ("bf16(r * h_{t-1})", "h_t")]

# a forward of the LSTM on the GRU forward's batch-row groups and tensor-core
# tiles (csrc/seq_mma.cuh), for the measurement only: block b owns UB units
# (32, or 16 where H is not a multiple of 32) of RB = 256 / UB batch rows
# and holds its units' four gate columns of W as bf16 rows of ws; each step
# it stages its rows of bf16(h_{t-1}), and each of its 8 warps forms one
# 16 x 8 tile of the [4 UB, RB] gate tile (16 columns in gate-major order
# by 8 rows: a fresh tensor-core sum per 16-deep k-step, added in
# increasing k) into shared memory; then a thread a cell adds x_t and does
# lstm_seq.cu's cell math; one grid barrier a step
LSTM_TC_SRC = r"""
namespace lstmtc {
using namespace seq;
using namespace seqmma;
namespace cg = cooperative_groups;

template <int UB>
struct Tile {
  __device__ int operator()(int u, int g) const { return g * UB + u; }
};

template <int UB>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_tc(const float* __restrict__ x, const float* __restrict__ alive,
            const float* __restrict__ w, const float* __restrict__ h0,
            const float* __restrict__ c0, float* hs, float* cs, int L,
            int b, int H) {
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
    stage_w_tiles(ws, wp, w, 4, H, j0, UB, Tile<UB>{});
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

}  // namespace lstmtc

extern "C" int lstm_seq_fwd_tc(const float* x, const float* alive,
                               const float* w, const float* h0,
                               const float* c0, float* hs, float* cs, int L,
                               int b, int H, void* stream) {
  using namespace lstmtc;
  if (!shape_ok(L, b, H)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &alive, &w, &h0, &c0, &hs, &cs, &L, &b, &H};
  const int ub = H % 32 == 0 ? 32 : 16;
  const size_t smem = tile_fwd_smem(4, H, ub) + sizeof(float) * 4 * THREADS;
  return ub == 32 ? launch(lstm_fwd_tc<32>, H / UNITS, smem, args, stream)
                  : launch(lstm_fwd_tc<16>, H / UNITS, smem, args, stream);
}
"""


BENCH_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
""" + ROW_BARRIER + r"""
// mode 0: two grid barriers; 1: (a) broadcast; 2: (b) partials; 3: (d) row
// groups; 4: one row-group barrier (16 blocks); 5: one grid barrier; 6: (d)
// with the row-group barrier. Modes 3 and 6 read `width` float4 of each
// of their 8 rows. buf holds every block's output, dst what the reads
// summed.
__global__ void __launch_bounds__(256, 1)
exchange(float* buf, float* part, float* dst, int mode, int steps,
         int width) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, blk = blockIdx.x;
  unsigned* cnt = rg_counters + blk / 16;
  const unsigned base = rg_load(cnt);
  const bool rows = mode == 3 || mode == 6, rowbar = mode == 4 || mode == 6;
  grid.sync();   // every block has read the base
  float s = 0.f;
  for (int t = 0; t < steps; ++t) {
    float4 v = make_float4(t, tid, blk, s);
    if (mode == 1) {        // own 64 rows x 16 columns of [64][2048]
      for (int i = tid; i < 64 * 4; i += 256)
        reinterpret_cast<float4*>(buf)[(i / 4) * 512 + blk * 4 + i % 4] = v;
    } else if (mode == 2) { // a [64][512] partial of its own
      float4* p = reinterpret_cast<float4*>(part) + (size_t)blk * 64 * 128;
      for (int i = tid; i < 64 * 128; i += 256) p[i] = v;
    } else if (rows) {      // own 8 rows x 128 columns of [64][2048]
      const int rg = blk / 16, ug = blk % 16;
      for (int i = tid; i < 8 * 32; i += 256)
        reinterpret_cast<float4*>(buf)[(rg * 8 + i / 32) * 512 + ug * 32 +
                                       i % 32] = v;
    }
    if (rowbar)
      rg_sync(cnt, base + 16u * (t + 1));
    else
      grid.sync();
    if (mode == 1) {        // all of [64][2048]
      for (int i = tid; i < 64 * 512; i += 256) {
        const float4 r = __ldcg(reinterpret_cast<const float4*>(buf) + i);
        s += r.x + r.y + r.z + r.w;
      }
    } else if (mode == 2) { // own 4 columns of every block's partial
      for (int i = tid; i < 128 * 64; i += 256) {
        const float4 r = __ldcg(reinterpret_cast<const float4*>(part) +
                                (size_t)(i / 64) * 64 * 128 +
                                (i % 64) * 128 + blk);
        s += r.x + r.y + r.z + r.w;
      }
      grid.sync();
    } else if (rows) {      // own 8 rows, `width` float4 each
      const int rg = blk / 16;
      for (int i = tid; i < 8 * width; i += 256) {
        const float4 r = __ldcg(reinterpret_cast<const float4*>(buf) +
                                (rg * 8 + i / width) * 512 + i % width);
        s += r.x + r.y + r.z + r.w;
      }
    } else if (mode == 0) {
      grid.sync();
    }
  }
  dst[blk * 256 + tid] = s;
}

__global__ void empty_kernel() {}

extern "C" int run_exchange(float* buf, float* part, float* dst, int mode,
                            int steps, int width, void* stream) {
  void* args[] = {&buf, &part, &dst, &mode, &steps, &width};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(exchange), dim3(128), dim3(256), args, 0,
      static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// a cooperative launch of 128 blocks in clusters of `cluster`: the error
extern "C" int try_coop_cluster(int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128);
  cfg.blockDim = dim3(256);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if (cluster > 8)
    cudaFuncSetAttribute(empty_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaGetLastError();
  return (int)e;
}

// clusters of `cluster` blocks of 256 threads and `smem` bytes resident at
// once, or -(error)
extern "C" int max_clusters(int cluster, int smem) {
  cudaFuncSetAttribute(empty_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cluster > 8)
    cudaFuncSetAttribute(empty_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, empty_kernel, &cfg);
  cudaGetLastError();
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
"""


def nvcc_all(jobs):
    """Build every (source, library) pair, one nvcc process each, all
    started together."""
    procs = [(src, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, out in jobs]
    for src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {src}:\n{log}")


def prepared(tree: Path, name: str, tag: str, patch=(), extra=""):
    """csrc/<name>.cu of `tree` with the (anchor, replacement) pairs of
    `patch` applied and `extra` inserted after its includes, written with
    the tree's headers under OUT/tag/name; returns (source, library)."""
    csrc = tree / "paddle_tpu_torch" / "csrc"
    src = (csrc / f"{name}.cu").read_text()
    for anchor, repl in patch:
        if src.count(anchor) != 1:
            sys.exit(f"{tree}/{name}.cu: anchor found {src.count(anchor)} "
                     f"times, not once (another version of the source):"
                     f"\n{anchor}")
        src = src.replace(anchor, repl)
    src = src.replace('#include "seq_mma.cuh"\n',
                      '#include "seq_mma.cuh"\n' + extra)
    if extra and extra not in src:
        src = src.replace('#include "seq_common.cuh"\n',
                          '#include "seq_common.cuh"\n' + extra)
    d = OUT / tag / name
    d.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / f"{name}.cu").write_text(src)
    return d / f"{name}.cu", d / f"lib{name}.so"


def pick(tree: Path, name: str, patches):
    """The first of `patches` whose anchors all lie once in the tree's
    csrc/<name>.cu, with its phases."""
    src = (tree / "paddle_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    for patch, phases in patches:
        if all(src.count(a) == 1 for a, _ in patch):
            return patch, phases
    sys.exit(f"{tree}/{name}.cu: no split's anchors match this source")


def libs(jobs):
    """Build the (tag, source, library) jobs together; {tag: CDLL}."""
    nvcc_all([(src, out) for _, src, out in jobs])
    return {tag: ctypes.CDLL(str(out)) for tag, _, out in jobs}


def bind(lib, stamps=True):
    """argtypes of the seq kernels' C entries that `lib` has (the
    backwards with the stage-clock argument unless `stamps` is False)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    s = 1 if stamps else 0
    for fn, n in (("lstm_seq_fwd", 7), ("lstm_seq_bwd", 13 + s),
                  ("gru_seq_fwd", 6), ("gru_seq_bwd", 10 + s)):
        if getattr(lib, fn, None) is not None:
            getattr(lib, fn).argtypes = [p] * n + [i, i, i, p]
    return lib


def time_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def sm_clock_ghz(torch):
    """The SM clock under load: clock64 cycles of a spinning kernel over
    its CUDA-event time."""
    d = OUT / "clock"
    d.mkdir(parents=True, exist_ok=True)
    (d / "clock.cu").write_text(r"""
__global__ void spin(long long* out, long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
extern "C" int run_spin(long long* out, long long cycles, void* stream) {
  spin<<<132, 32, 0, (cudaStream_t)stream>>>(out, cycles);
  return (int)cudaGetLastError();
}
""")
    nvcc_all([(d / "clock.cu", d / "libclock.so")])
    lib = ctypes.CDLL(str(d / "libclock.so"))
    lib.run_spin.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p]
    out = torch.zeros(132, dtype=torch.int64, device="cuda")
    cycles = 20_000_000
    stream = torch.cuda.current_stream().cuda_stream
    ms = time_ms(torch, lambda: lib.run_spin(out.data_ptr(), cycles, stream),
                 reps=5)
    return cycles / (ms * 1e6)


def split(torch, lib_split, lib_plain, launch, phases, steps, blocks, ghz,
          title):
    lib_split.split_read.argtypes = [ctypes.c_void_p]
    t_plain = time_ms(torch, lambda: launch(lib_plain))
    t_split = time_ms(torch, lambda: launch(lib_split))
    lib_split.split_reset()
    launch(lib_split)
    torch.cuda.synchronize()
    cyc = torch.zeros(128 * 24, dtype=torch.int64)
    err = lib_split.split_read(ctypes.c_void_p(cyc.data_ptr()))
    if err:
        sys.exit(f"split_read failed: {err}")
    per = cyc.view(128, 24)[:blocks].double().mean(0) / steps
    total = sum(per[k].item() for k in phases)
    print(f"\n{title}: launch {t_plain:.4f} ms plain, {t_split:.4f} ms with "
          f"the stamps; per step (mean of {blocks} blocks over {steps} "
          f"steps) {total / ghz / 1e3:.3f} us at {ghz:.3f} GHz")
    for k, name in phases.items():
        c = per[k].item()
        print(f"  {name:<36} {c:10.0f} cycles {c / ghz / 1e3:8.3f} us "
              f"{100 * c / total:6.2f}%")
    return t_plain


class Operands:
    """The seq kernels' inputs and outputs at (L, b, H), from a seed, on
    the card; `.lstm_fwd(lib)` etc. launch a library's C entry on them."""

    def __init__(self, torch, L, b, H, seed):
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.L, self.b, self.H = L, b, H
        self.stream = torch.cuda.current_stream().cuda_stream

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        self.alive = torch.ones(L, b, 1, device=dev)
        self.x4, self.w4 = randn(L, b, 4 * H), randn(H, 4 * H, scale=0.05)
        self.x3, self.w3 = randn(L, b, 3 * H), randn(H, 3 * H, scale=0.05)
        self.h0, self.c0 = randn(b, H), randn(b, H)
        self.dhs, self.dcs = randn(L, b, H), randn(L, b, H)
        self.hs, self.cs = (torch.empty(L, b, H, device=dev)
                            for _ in range(2))
        self.hg = torch.empty(L, b, H, device=dev)
        self.rh = torch.empty(L, b, H, device=dev)
        self.dx4, self.dx3 = torch.empty_like(self.x4), \
            torch.empty_like(self.x3)
        self.dw4, self.dw3 = torch.empty_like(self.w4), \
            torch.empty_like(self.w3)
        self.dh0, self.dc0 = torch.empty_like(self.h0), \
            torch.empty_like(self.c0)
        self.clocks = torch.empty(4, dtype=torch.int64, device=dev)

    def _run(self, name, err):
        if err:
            sys.exit(f"{name} launch failed: {err}")

    def lstm_fwd(self, lib, hs=None, cs=None):
        hs = self.hs if hs is None else hs
        cs = self.cs if cs is None else cs
        self._run("lstm_seq_fwd", lib.lstm_seq_fwd(*(t.data_ptr() for t in (
            self.x4, self.alive, self.w4, self.h0, self.c0, hs, cs)),
            self.L, self.b, self.H, self.stream))

    def lstm_bwd(self, lib, stamps=True):
        ts = [self.x4, self.alive, self.w4, self.h0, self.c0, self.hs,
              self.cs, self.dhs, self.dcs, self.dx4, self.dw4, self.dh0,
              self.dc0] + ([self.clocks] if stamps else [])
        self._run("lstm_seq_bwd", lib.lstm_seq_bwd(
            *(t.data_ptr() for t in ts), self.L, self.b, self.H,
            self.stream))

    def gru_fwd(self, lib, hs=None):
        hs = self.hg if hs is None else hs
        self._run("gru_seq_fwd", lib.gru_seq_fwd(*(t.data_ptr() for t in (
            self.x3, self.alive, self.w3, self.h0, hs, self.rh)),
            self.L, self.b, self.H, self.stream))

    def gru_bwd(self, lib, stamps=True):
        ts = [self.x3, self.alive, self.w3, self.h0, self.hg, self.dhs,
              self.dx3, self.dw3, self.dh0, self.rh] + \
            ([self.clocks] if stamps else [])
        self._run("gru_seq_bwd", lib.gru_seq_bwd(
            *(t.data_ptr() for t in ts), self.L, self.b, self.H,
            self.stream))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, type=Path)
    ap.add_argument("--parts", default="split,compare")
    args = ap.parse_args()
    parts = args.parts.split(",")
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    ghz = sm_clock_ghz(torch)
    L, b, H = 100, 64, 512
    if "steps" in parts:
        steps(args.tree)
    if "split" in parts:
        fwd_split(torch, args.tree, ghz, L, b, H)
    if "bwdsplit" in parts:
        bwd_split(torch, args.tree, ghz, L, b, H)
    if "exchange" in parts:
        exchange(torch, L)
    if "compare" in parts:
        compare(torch, args.tree, b, H)
    if "barrier" in parts:
        barrier(torch, b, H)
    if "lstmtc" in parts:
        lstmtc(torch)


def fwd_split(torch, tree, ghz, L, b, H):
    """The tree's forwards with and without the clock64 stamps; prints
    their split."""
    ops = Operands(torch, L, b, H, 0)
    jobs = []
    picked = {}
    for name, patches in (("lstm_seq", FWD_LSTM_PATCHES),
                          ("gru_seq", FWD_GRU_PATCHES)):
        patch, picked[name] = pick(tree, name, patches)
        jobs += [(f"{name}_split",
                  *prepared(tree, name, "fsplit", patch, STAMPS)),
                 (f"{name}_plain", *prepared(tree, name, "fplain"))]
    lib = {k: bind(v) for k, v in libs(jobs).items()}
    split(torch, lib["lstm_seq_split"], lib["lstm_seq_plain"], ops.lstm_fwd,
          picked["lstm_seq"], L, H // 4, ghz,
          f"lstm_fwd_kernel of {tree}, b {b}, L {L}, H {H}")
    split(torch, lib["gru_seq_split"], lib["gru_seq_plain"], ops.gru_fwd,
          picked["gru_seq"], L, H // 4, ghz,
          f"gru_fwd_kernel of {tree}, b {b}, L {L}, H {H}")


def bwd_split(torch, tree, ghz, L, b, H):
    """The first-version backwards (csrc up to commit 6225d18) with and
    without the stamps; prints their split."""
    ops = Operands(torch, L, b, H, 0)
    jobs = []
    for name, patch in (("lstm_seq", LSTM_PATCH), ("gru_seq", GRU_PATCH)):
        jobs += [(f"{name}_split",
                  *prepared(tree, name, "bsplit", patch, STAMPS)),
                 (f"{name}_plain", *prepared(tree, name, "bplain"))]
    lib = {k: bind(v, stamps=False) for k, v in libs(jobs).items()}
    ops.lstm_fwd(lib["lstm_seq_plain"])
    ops.gru_fwd(lib["gru_seq_plain"])
    split(torch, lib["lstm_seq_split"], lib["lstm_seq_plain"],
          lambda lb: ops.lstm_bwd(lb, stamps=False), LSTM_PHASES, L, H // 4,
          ghz, f"lstm_bwd_kernel (first version), b {b}, L {L}, H {H}")
    split(torch, lib["gru_seq_split"], lib["gru_seq_plain"],
          lambda lb: ops.gru_bwd(lb, stamps=False), GRU_PHASES, L, H // 4,
          ghz, f"gru_bwd_kernel (first version), b {b}, L {L}, H {H}; pass "
          f"1 per step of its {L}")


def exchange(torch, L):
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    d = OUT / "exchange"
    d.mkdir(parents=True, exist_ok=True)
    (d / "exchange.cu").write_text(BENCH_SRC)
    nvcc_all([(d / "exchange.cu", d / "libexchange.so")])
    lib = ctypes.CDLL(str(d / "libexchange.so"))
    lib.run_exchange.argtypes = [p, p, p, i, i, i, p]
    lib.error_string.restype = ctypes.c_char_p
    buf = torch.zeros(64 * 2048, device=dev)
    part = torch.zeros(128 * 64 * 512, device=dev)
    dst = torch.zeros(128 * 256, device=dev)
    print(f"\nexchange alone, {L} steps of 128 blocks (us a step):")
    for mode, width, name in (
            (0, 0, "2 grid barriers"),
            (1, 0, "(a) broadcast, 512 KB in, 1 barrier"),
            (2, 0, "(b) partials, 128 KB out + 128 KB in, 2 barriers"),
            (3, 512, "(d) row groups, 4 KB out, 64 KB in, 1 barrier"),
            (3, 128, "(d) row groups, 4 KB out, 16 KB in, 1 barrier"),
            (5, 0, "1 grid barrier"),
            (4, 0, "1 row-group barrier (16 blocks)"),
            (6, 128, "(d), 16 KB in, 1 row-group barrier")):
        def run():
            err = lib.run_exchange(buf.data_ptr(), part.data_ptr(),
                                   dst.data_ptr(), mode, L, width, stream)
            if err:
                sys.exit(f"exchange {mode}: {lib.error_string(err)}")
        print(f"  {name:<52} {time_ms(torch, run) * 1e3 / L:8.3f}")
    for cluster in (8, 16):
        err = lib.try_coop_cluster(cluster)
        n = lib.max_clusters(cluster, 200 * 1024)
        print(f"cooperative launch with clusters of {cluster}: "
              f"{'accepted' if err == 0 else lib.error_string(err).decode()}"
              f"; resident clusters of {cluster} x 200 KB: "
              f"{n if n >= 0 else lib.error_string(-n).decode()}")


def compare(torch, tree, b, H):
    """The tree's four seq kernels (csrc as the tree has it, from commit
    7dfac6d on: the backwards take the stage clocks) against this
    checkout's, launch for launch at b, H and L 100 and 200, in turns
    (tree, this, this, tree); then this checkout's backward stage
    shares."""
    jobs = [(f"tree_{n}", *prepared(tree, n, "tree"))
            for n in ("lstm_seq", "gru_seq")]
    jobs += [(f"this_{n}", *prepared(Path.cwd(), n, "this"))
             for n in ("lstm_seq", "gru_seq")]
    lib = {k: bind(v) for k, v in libs(jobs).items()}
    for L in (100, 200):
        ops = Operands(torch, L, b, H, 1)
        hs_t, cs_t, hg_t = (torch.empty_like(ops.hs) for _ in range(3))
        ops.lstm_fwd(lib["tree_lstm_seq"], hs_t, cs_t)
        ops.gru_fwd(lib["tree_gru_seq"], hg_t)
        ops.lstm_fwd(lib["this_lstm_seq"])
        ops.gru_fwd(lib["this_gru_seq"])
        torch.cuda.synchronize()
        diff = [((a - r).abs().max() / r.abs().max()).item()
                for a, r in ((ops.hs, hs_t), (ops.cs, cs_t), (ops.hg, hg_t))]
        print(f"\nb {b}, L {L}, H {H}: this checkout's forwards against the "
              f"tree's, ‖Δ‖∞/‖ref‖∞: hs {diff[0]:.3e}, cs {diff[1]:.3e}, "
              f"GRU hs {diff[2]:.3e}")
        for name, fn in (("lstm_seq", ops.lstm_fwd),
                         ("lstm_seq_bwd", ops.lstm_bwd),
                         ("gru_seq", ops.gru_fwd),
                         ("gru_seq_bwd", ops.gru_bwd)):
            key = name.removesuffix("_bwd")
            t = [time_ms(torch, lambda lb=lib[f"{who}_{key}"]: fn(lb))
                 for who in ("tree", "this", "this", "tree")]
            line = (f"{name}: tree {t[0]:.4f} / {t[3]:.4f} ms, this "
                    f"checkout {t[1]:.4f} / {t[2]:.4f} ms a launch")
            if name.endswith("_bwd"):
                fn(lib[f"this_{key}"])
                c = ops.clocks.cpu().double()
                share = (c[1:] - c[:-1]) / (c[3] - c[0])
                line += (f"; stages of this one: prologue "
                         f"{100 * share[0]:.1f}%, chain "
                         f"{100 * share[1]:.1f}%, epilogue "
                         f"{100 * share[2]:.1f}%")
            print(line)


def barrier(torch, b, H):
    """This checkout's GRU forward with grid barriers against row-group
    barriers, in turns (grid, group, group, grid), at L 100 and 200; the
    carries of the two must be bitwise equal."""
    here = Path.cwd()
    jobs = [("grid", *prepared(here, "gru_seq", "grid")),
            ("group", *prepared(here, "gru_seq", "group", ROWBAR_GRU_PATCH,
                                ROW_BARRIER))]
    lib = {k: bind(v) for k, v in libs(jobs).items()}
    for L in (100, 200):
        ops = Operands(torch, L, b, H, 2)
        outs = {}
        for who in ("grid", "group"):
            outs[who] = torch.empty_like(ops.hg)
            ops.gru_fwd(lib[who], outs[who])
        torch.cuda.synchronize()
        same = torch.equal(outs["grid"], outs["group"])
        print(f"\nb {b}, L {L}, H {H}: GRU carries with row-group barriers "
              f"{'bitwise equal to' if same else 'DIFFER from'} the grid "
              f"barriers'")
        if not same:
            sys.exit("the row-group barrier changed the carries")
        t = [time_ms(torch, lambda lb=lib[who]: ops.gru_fwd(lb))
             for who in ("grid", "group", "group", "grid")]
        print(f"gru_seq: grid barriers {t[0]:.4f} / {t[3]:.4f} ms, "
              f"row-group barriers {t[1]:.4f} / {t[2]:.4f} ms a launch")


def lstm_float64(torch, x, alive, w, h0, c0):
    """The LSTM forward's recipe (bf16(h)·bf16(w), then the cell) in
    float64: the yardstick both float32 versions are measured against."""
    def bf16(t):
        return t.float().bfloat16().double()

    H = h0.shape[-1]
    wb = bf16(w)
    x, alive = x.double(), alive.double()
    h, c = h0.double(), c0.double()
    hs, cs = [], []
    for t in range(x.shape[0]):
        g = x[t] + bf16(h) @ wb
        i, f = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H])
        cand, o = torch.tanh(g[:, 2 * H:3 * H]), torch.sigmoid(g[:, 3 * H:])
        cn = f * c + i * cand
        hn = o * torch.tanh(cn)
        h = alive[t] * hn + (1 - alive[t]) * h
        c = alive[t] * cn + (1 - alive[t]) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstmtc(torch):
    """This checkout's lstm_seq forward against LSTM_TC_SRC's tensor-core
    forward on chip_smoke.py phase 5's operands (b 64, H 512, ragged
    lengths) at L 100 and 200: each one's distance to the plain version
    (lstm_seq_torch) and to the float64 recipe, what chip_smoke.py's LSTM
    limit and the GRU's criteria would say of the tensor-core one, whether
    it repeats bitwise, and both launches' times in turns (kernel, tc, tc,
    kernel)."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import rnn

    here = Path.cwd()
    lib = libs([("kernel", *prepared(here, "lstm_seq", "this")),
                ("tc", *prepared(here, "lstm_seq", "lstmtc", (),
                                 LSTM_TC_SRC))])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib["kernel"].lstm_seq_fwd.argtypes = [p] * 7 + [i, i, i, p]
    lib["tc"].lstm_seq_fwd_tc.argtypes = [p] * 7 + [i, i, i, p]
    entry = {"kernel": lib["kernel"].lstm_seq_fwd,
             "tc": lib["tc"].lstm_seq_fwd_tc}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    b, H = cs.SEQ_BATCH, cs.SEQ_HIDDEN
    for L in (cs.SEQ_LEN, cs.CTC_FRAMES[1]):
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)   # phase 5's operands (seed 0)
        lens = torch.randint(1, L + 1, (b,), generator=gen, device=dev)
        lens[: b // 4] = L
        x, alive, w, h0, c0, _, _ = cs.lstm_operands(torch, gen, dev, lens,
                                                     L)
        outs = {}

        def run(who, hs, cs_):
            err = entry[who](*(t.data_ptr() for t in (x, alive, w, h0, c0,
                                                      hs, cs_)),
                             L, b, H, stream)
            if err:
                sys.exit(f"{who} forward launch failed: {err}")

        for who in ("kernel", "tc", "tc"):
            hs, cs_ = (torch.empty(L, b, H, device=dev) for _ in range(2))
            run(who, hs, cs_)
            outs.setdefault(who, []).append((hs, cs_))
        torch.cuda.synchronize()
        plain = rnn.lstm_seq_torch(x, alive, w, h0, c0)
        exact = lstm_float64(torch, x, alive, w, h0, c0)
        print(f"\nlstm_seq forwards, b {b}, L {L}, H {H}, lengths "
              f"{int(lens.min())}..{int(lens.max())}:")
        to64 = {}
        for who, pair in (("plain", plain), ("kernel", outs["kernel"][0]),
                          ("tc", outs["tc"][0])):
            to64[who] = [(g.double() - e).abs().max().item()
                         for g, e in zip(pair, exact)]
            errs = [cs.rel_errs(g, r) for g, r in zip(pair, plain)]
            print(f"  {who:<6} hs, cs against the plain version: ‖Δ‖∞/‖ref‖∞ "
                  f"{errs[0][0]:.3e}, {errs[1][0]:.3e}; ‖Δ‖₂/‖ref‖₂ "
                  f"{errs[0][1]:.3e}, {errs[1][1]:.3e}; ‖Δ‖∞ to float64 "
                  f"{to64[who][0]:.3e}, {to64[who][1]:.3e}")
        tc = [cs.rel_errs(g, r) for g, r in zip(outs["tc"][0], plain)]
        lstm_ok = all(e[0] <= cs.LSTM_FWD_LIMIT for e in tc)
        gru_ok = all(e[0] <= cs.GRU_FWD_LIMIT and e[1] <= cs.GRU_FWD_L2_LIMIT
                     and to64["tc"][k] <= cs.GRU_F64_RATIO * to64["plain"][k]
                     for k, e in enumerate(tc))
        same = all(torch.equal(a, r) for a, r in zip(*outs["tc"]))
        print(f"  tc: within LSTM_FWD_LIMIT {cs.LSTM_FWD_LIMIT:.0e}: "
              f"{'yes' if lstm_ok else 'no'}; within the GRU's criteria "
              f"({cs.GRU_FWD_LIMIT:.0e}, {cs.GRU_FWD_L2_LIMIT:.0e} in ‖Δ‖₂, "
              f"{cs.GRU_F64_RATIO}x the plain's distance to float64): "
              f"{'yes' if gru_ok else 'no'}; a second launch "
              f"{'bitwise equal' if same else 'DIFFERS'}")
        hs, cs_ = outs["kernel"][0]
        t = [time_ms(torch, lambda who=who: run(who, hs, cs_))
             for who in ("kernel", "tc", "tc", "kernel")]
        print(f"  lstm_seq: kernel {t[0]:.4f} / {t[3]:.4f} ms, tensor-core "
              f"forward {t[1]:.4f} / {t[2]:.4f} ms a launch")


STEPS_SCRIPT = r"""
import re, sys, torch
import chip_smoke as cs
import paddle_tpu_torch.fluid as fluid
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
lines = []
cs.log = lambda m: lines.append(m)
card = cs.card_line()
cs.phase_textcls(torch, fluid, 0, card)
cs.phase_textcls(torch, fluid, 0, card, "gru")
cs.phase_ctc(torch, fluid, 0, card)
for m in lines:
    if m.startswith("kernel_tier=") or m.startswith("== phase"):
        print(m.strip())
"""


# runs of each tree in `steps`: a whole-process step time spreads by ~10%
# from run to run on one host, so a claim needs most of ten pairs
PAIRS = 10


def steps(tree):
    """chip_smoke.py's phases 6, 8, 9 from `tree` and from this checkout,
    PAIRS runs each, a process a run, in alternating pairs (tree, this;
    this, tree; ...); prints each run's steady ms a step and peak memory on
    both routes, then for each phase the kernel route's times by pair and
    the verdict: met where this checkout is faster in every pair, not met
    where it is faster in at most half of them, unresolved between."""
    here = Path.cwd()
    order = []
    for k in range(PAIRS):
        order += [("tree", tree), ("this", here)][::1 if k % 2 == 0 else -1]
    runs = {"tree": [], "this": []}
    for label, root in order:
        res = subprocess.run([sys.executable, "-c", STEPS_SCRIPT],
                             cwd=root, capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"phases 6, 8, 9 failed in {root}:\n{res.stdout}"
                     f"{res.stderr[-4000:]}")
        print(f"\nphases 6, 8, 9 from {label} ({root}):")
        kernel_ms = []
        for line in res.stdout.splitlines():
            m = re.search(r"^kernel_tier=(\w+).*steady ([\d.]+) ms/step.*"
                          r"peak memory ([\d.]+) GiB", line)
            if line.startswith("=="):
                print("  " + line)
            elif m:
                print(f"    kernel_tier={m[1]}: {m[2]} ms a step, peak "
                      f"{m[3]} GiB")
                if m[1] == "auto":
                    kernel_ms.append(float(m[2]))
        runs[label].append(kernel_ms)
    print(f"\nkernel route, ms a step, {PAIRS} pairs (tree / this):")
    for k, phase in enumerate(("phase 6 (LSTM)", "phase 8 (GRU)",
                               "phase 9 (CTC)")):
        got = [(a[k], b[k]) for a, b in zip(runs["tree"], runs["this"])]
        wins = sum(b < a for a, b in got)
        verdict = ("met" if wins == len(got) else
                   "not met" if 2 * wins <= len(got) else "unresolved")
        med = [sorted(v)[len(v) // 2] for v in zip(*got)]
        print(f"  {phase}: " + ", ".join(f"{a:.2f} / {b:.2f}"
                                        for a, b in got)
              + f"; medians {med[0]:.2f} / {med[1]:.2f}; this faster in "
              f"{wins} of {len(got)}: {verdict}")


if __name__ == "__main__":
    main()
