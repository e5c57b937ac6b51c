"""Where one step of the recurrent kernels goes on the card, what the
exchanges and barriers a design could use cost alone, and another tree's
recurrent and CTC kernels against this checkout's.

    python3 seq_split.py --tree DIR [--parts split,bwdsplit,exchange,
                                     compare,barrier,latency,steps]
                                    [--phases 6,8,9] [--pairs 10]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card; a measurement tool beside chip_smoke.py, not part of the port's
package. Prints the card's name and power limit, then, by part (default
``split,compare``):

* ``split``: for ``lstm_fwd_kernel`` and ``gru_fwd_kernel`` of ``--tree``
  (the first versions, or the batch-row forwards: the GRU's after commit
  2db8ad5, the LSTM's after 9139a45; the anchors pick which), the cycles
  of each phase of one step (staging, products, reductions, cell math,
  barriers), averaged over blocks and steps at b 64, L 100, H 512: the
  kernel is copied, a ``clock64`` stamp (with a block barrier) is
  inserted at each phase's end at fixed anchors of its source, and the
  copies build under ``build/torch_kernels/seq_split/``. The launch's
  time with and without the stamps shows what they cost.
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
  kernels' clocks; then ``ctc_alpha`` and ``ctc_loss_bwd`` the same way at
  the CTC model's b 64, C 29 and T 100 and 200 (labels of
  ⌈frames/8⌉..⌊frames/4⌋ characters), each tree's forward called through
  its own interface from the same logp (a tree with ``ctc_alpha_fwd``
  takes ``ctc_inputs``, this checkout's torch glue, then its kernel; one
  with ``ctc_loss_fwd`` the labels), timed as a call and as the kernel's
  device time (torch.profiler), the loss and dlogits of the two trees
  compared bitwise, and this checkout's stage shares (the forward's
  prologue, chain and loss, with the chain's cycles a step; the
  backward's recompute, adjoint and epilogue).
* ``barrier``: this checkout's GRU forward as it is (grid barriers)
  against a copy whose steps wait only for the blocks of their row group,
  in turns (grid, group, group, grid), the carries compared bitwise.
* ``latency``: a step of the CTC backward's serial chain alone, in
  cycles (``LATENCY_SRC``): a shared-memory round trip under a 128-thread
  barrier, two logaddexp a step on one thread, on 128 threads a state a
  thread, and on one warp four states a lane.
* ``steps``: chip_smoke.py's phases 6, 8 and 9 (the LSTM and GRU
  classifiers and the CTC model, trained on both routes; ``--phases``
  picks some) run from ``--tree`` and from this checkout, ``--pairs``
  runs each (10) in alternating pairs, each in a process of its own;
  prints each run's steady ms a step, the profiled kernel-route step's
  device-busy ms and its device kernels (launches and copies) a step,
  then each phase's kernel-route times by pair and whether this checkout
  is faster in every pair.

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
    ("            rh[(row + e) * H + j] = bf16_bits(__fmul_rn(r, h[e]));\n"
     "          }\n      }\n    }\n"
     "    grid.sync();   // bf16(r * h_{t-1}) of every unit is written\n",
     "            rh[(row + e) * H + j] = bf16_bits(__fmul_rn(r, h[e]));\n"
     "          }\n      }\n      STAMP(2);\n    }\n"
     "    grid.sync();   // bf16(r * h_{t-1}) of every unit is written\n"
     "    STAMP(3);\n"),
    ("      stage_bf16_rows(hb, wp, rh + r0 * H, rows, H);\n"
     "      __syncthreads();\n",
     "      stage_bf16_rows(hb, wp, rh + r0 * H, rows, H);\n"
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

# the batch-row LSTM forward (after commit 9139a45): a block owns UB units
# of RB rows, forms its gate tile on the tensor cores and stages only its
# rows of h_{t-1}
ROW_LSTM_PATCH = [
    ("    c = c0[row * H + j];\n  }\n  for (int t = 0; t < L; ++t) {\n",
     "    c = c0[row * H + j];\n  }\n  STAMP_START();\n"
     "  for (int t = 0; t < L; ++t) {\n"),
    ("                   rows, H);\n      __syncthreads();\n",
     "                   rows, H);\n      STAMP(1);\n"),
    ("      gs[(br + 1) * COLS + gc + 8] = sum[3];\n      __syncthreads();\n",
     "      gs[(br + 1) * COLS + gc + 8] = sum[3];\n      STAMP(2);\n"),
    ("        cs[o] = c;\n      }\n    }\n"
     "    grid.sync();   // h_t of every unit is written\n",
     "        cs[o] = c;\n      }\n      STAMP(3);\n    }\n"
     "    grid.sync();   // h_t of every unit is written\n    STAMP(4);\n"),
]
ROW_LSTM_PHASES = {1: "stage bf16(h_{t-1}), 16 KB",
                   2: "x loads, gate tile product (8 warps), sums out",
                   3: "cell math, hs/cs out", 4: "grid barrier"}

# the split of each forward: the first version's, then the batch-row one's
FWD_LSTM_PATCHES = [(FWD_LSTM_PATCH, FWD_LSTM_PHASES),
                    (ROW_LSTM_PATCH, ROW_LSTM_PHASES)]
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

# what a step of the CTC backward's serial chain costs alone, in cycles:
# mode 0, 128 threads each reading its row's neighbour after a store and a
# 128-thread named barrier; 1, two logaddexp and an add a step on one
# thread, in registers; 2, the same on 128 threads, a state a thread, the
# neighbours through a shared row and the barrier; 3, on one warp, four
# states a lane, __syncwarp a step
LATENCY_SRC = r"""
#include <cuda_runtime.h>
constexpr float NEG = -1e30f;
__device__ __forceinline__ float lae(float a, float b) {
  const float d = __fsub_rn(a, b);
  if (isnan(d)) return __fadd_rn(a, b);
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(d))));
}
__global__ void latency(float* out, const float* in, int mode, int steps,
                        long long* cycles) {
  __shared__ float a[2][512];
  __shared__ float x[512];
  const int tid = threadIdx.x;
  for (int i = tid; i < 512; i += blockDim.x) {
    a[0][i] = a[1][i] = x[i] = in[i];
  }
  __syncthreads();
  float acc = 0.f;
  const long long t0 = clock64();
  if (mode == 0) {
    for (int t = 0; t < steps; ++t) {
      const float v = __fmul_rn(a[t & 1][tid], 1.0001f);
      a[t & 1][tid] = v;
      asm volatile("bar.sync 1, 128;" ::: "memory");
      a[(t + 1) & 1][tid] =
          __fadd_rn(v, __fmul_rn(a[t & 1][(tid + 1) % 128], 1e-9f));
    }
  } else if (mode == 1) {
    float v = in[tid];
    const float e = in[tid + 1], e1 = in[tid + 2];
    for (int t = 0; t < steps; ++t) v = __fadd_rn(lae(lae(v, e), e1), in[3]);
    acc = v;
  } else {
    const int per = mode == 2 ? 1 : 4, width = mode == 2 ? 128 : 32;
    int cur = 0;
    for (int t = 0; t < steps; ++t) {
      const float* p = a[cur];
      float* n = a[1 - cur];
      for (int k = 0; k < per; ++k) {
        const int s = tid + k * width;
        const float a1 = s >= 1 ? p[s - 1] : NEG;
        const float a2 = s >= 2 ? p[s - 2] : NEG;
        n[s] = __fadd_rn(lae(lae(p[s], a1), a2), x[s]);
      }
      if (mode == 2)
        asm volatile("bar.sync 1, 128;" ::: "memory");
      else
        __syncwarp();
      cur ^= 1;
    }
  }
  const long long t1 = clock64();
  if (tid == 0) cycles[mode] = t1 - t0;
  out[tid] = acc + a[0][tid];
}
extern "C" int run_latency(float* out, const float* in, int mode, int steps,
                           long long* cycles) {
  latency<<<1, mode == 1 ? 1 : (mode == 3 ? 32 : 128)>>>(out, in, mode,
                                                         steps, cycles);
  return (int)cudaDeviceSynchronize();
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
    ap.add_argument("--phases", default="6,8,9")
    ap.add_argument("--pairs", type=int, default=PAIRS)
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
        steps(args.tree, [int(v) for v in args.phases.split(",")],
              args.pairs)
    if "split" in parts:
        fwd_split(torch, args.tree, ghz, L, b, H)
    if "bwdsplit" in parts:
        bwd_split(torch, args.tree, ghz, L, b, H)
    if "exchange" in parts:
        exchange(torch, L)
    if "compare" in parts:
        compare(torch, args.tree, b, H)
        compare_ctc(torch, args.tree, b, ghz)
    if "barrier" in parts:
        barrier(torch, b, H)
    if "latency" in parts:
        latency(torch)


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


def ctc_operands(torch, T, seed, b=64, classes=29):
    """The CTC backward's inputs at the CTC model's shape: frames
    T/2..T (one row at T), labels of ⌈frames/8⌉..⌊frames/4⌋ characters in
    1..classes-1 (0 the blank), logp the log-softmax of normal logits, a
    normal loss cotangent."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xl = torch.randint(T // 2, T + 1, (b,), generator=gen, device=dev,
                       dtype=torch.int32)
    xl[0] = T
    lo, hi = (xl + 7) // 8, xl // 4
    yl = (lo + (torch.rand(b, generator=gen, device=dev)
                * (hi - lo + 1).float()).long().clamp_max(
                    (hi - lo).long())).int()
    labels = torch.randint(1, classes, (b, int(yl.max())), generator=gen,
                           device=dev)
    logp = torch.log_softmax(torch.randn(b, T, classes, generator=gen,
                                         device=dev), -1)
    return logp, labels, xl, yl, torch.randn(b, generator=gen, device=dev)


def device_ms(torch, fn, names, reps=20):
    """The device time a call of ``fn`` spends in kernels whose names
    contain one of ``names``, from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages()
             if any(n in ev.key for n in names))
    return us / 1e3 / reps


def compare_ctc(torch, tree, b, ghz):
    """The tree's ctc_alpha and ctc_loss_bwd against this checkout's, call
    for call at b, C 29 and T 100 and 200, in turns (tree, this, this,
    tree): each forward through its own C interface from the same logp
    (``ctc_alpha_fwd`` after ``ctc_inputs``, or ``ctc_loss_fwd``), timed
    as a call and as its kernel's device time; the loss and dlogits
    compared bitwise; then this checkout's stage shares. A tree whose
    backward takes no stage clocks (before its redesign) is called without
    them."""
    from paddle_tpu_torch.ops.cuda import ctc

    p, i = ctypes.c_void_p, ctypes.c_int
    here = Path.cwd()
    lib, clocked, from_logp = {}, {}, {}
    for who, root in (("tree", tree), ("this", here)):
        src = (root / "paddle_tpu_torch" / "csrc" / "ctc.cu").read_text()
        clocked[who] = "long long* stamps" in src
        from_logp[who] = "int ctc_loss_fwd(" in src
    built = libs([(who, *prepared(root, "ctc", f"ctc_{who}"))
                  for who, root in (("tree", tree), ("this", here))])
    for who, lb in built.items():
        if from_logp[who]:
            lb.ctc_loss_fwd.argtypes = [p] * 6 + [i] * 6 + [p]
        else:
            lb.ctc_alpha_fwd.argtypes = [p] * 8 + [i, i, i, p]
        if clocked[who]:
            lb.ctc_bwd_scratch.argtypes = [i, i]
            lb.ctc_bwd_scratch.restype = ctypes.c_longlong
        lb.ctc_loss_bwd.argtypes = [p] * (8 if clocked[who] else 7) \
            + [i] * 6 + [p]
        lib[who] = lb
    stream = torch.cuda.current_stream().cuda_stream
    for T in (100, 200):
        logp, labels, xl, yl, dloss = ctc_operands(torch, T, 3, b)
        C, U = logp.shape[-1], labels.shape[1]
        sp = ctc.label_positions(U)
        scratch = {who: torch.empty(
            b, lib[who].ctc_bwd_scratch(T, sp) if clocked[who] else T * sp,
            device=logp.device) for who in lib}
        clocks = {k: torch.empty(4, dtype=torch.int64, device=logp.device)
                  for k in ("fwd", "bwd")}
        outs = {}

        def fwd(who, loss):
            if from_logp[who]:
                err = lib[who].ctc_loss_fwd(
                    *(t.data_ptr() for t in (logp, labels, xl, yl, loss,
                                             clocks["fwd"])),
                    b, T, sp, C, U, 0, stream)
            else:
                inputs = ctc.ctc_inputs(logp, labels, yl, xl, 0)
                err = lib[who].ctc_alpha_fwd(
                    *(t.data_ptr() for t in inputs + (xl, yl, loss)), b, T,
                    sp, stream)
            if err:
                sys.exit(f"{who}'s CTC forward failed: {err}")

        def bwd(who, dlogits):
            ptrs = [t.data_ptr() for t in (logp, labels, xl, yl, dloss,
                                           scratch[who], dlogits)]
            if clocked[who]:
                ptrs.append(clocks["bwd"].data_ptr())
            err = lib[who].ctc_loss_bwd(*ptrs, b, T, sp, C, U, 0, stream)
            if err:
                sys.exit(f"{who} ctc_loss_bwd failed: {err}")

        for who in ("tree", "this"):
            outs[who] = (torch.empty(b, 1, device=logp.device),
                         torch.empty_like(logp))
            fwd(who, outs[who][0])
            bwd(who, outs[who][1])
        torch.cuda.synchronize()
        same = [torch.equal(outs["tree"][k], outs["this"][k])
                for k in range(2)]
        d = (outs["this"][1] - outs["tree"][1]).abs().max().item()
        print(f"\nCTC, b {b}, T {T}, C {C}, Sp {sp}, frames "
              f"{int(xl.min())}..{T}, labels {int(yl.min())}..{U}: this "
              f"checkout against the tree: loss "
              f"{'bitwise equal' if same[0] else 'DIFFERS'}, dlogits "
              f"{'bitwise equal' if same[1] else f'DIFFER (max |Δ| {d:.3e})'}")
        for name, fn, k in (("ctc_alpha", fwd, 0), ("ctc_loss_bwd", bwd, 1)):
            order = ("tree", "this", "this", "tree")
            t = [time_ms(torch, lambda who=who: fn(who, outs[who][k]))
                 for who in order]
            dev = [device_ms(torch, lambda who=who: fn(who, outs[who][k]),
                             ("ctc_",)) for who in order]
            line = (f"{name}: tree {t[0]:.4f} / {t[3]:.4f} ms, this "
                    f"checkout {t[1]:.4f} / {t[2]:.4f} ms a call; kernel "
                    f"device time tree {dev[0]:.4f} / {dev[3]:.4f}, this "
                    f"{dev[1]:.4f} / {dev[2]:.4f} ms")
            fn("this", outs["this"][k])
            c = clocks["bwd" if k else "fwd"].cpu().double()
            share = (c[1:] - c[:-1]) / (c[3] - c[0])
            if k == 1:
                line += (f"; stages of this one: recompute "
                         f"{100 * share[0]:.1f}%, adjoint "
                         f"{100 * share[1]:.1f}%, epilogue "
                         f"{100 * share[2]:.1f}%")
            elif from_logp["this"]:
                step = (c[2] - c[1]).item() / (int(xl[0]) - 1)
                line += (f"; stages of this one: prologue "
                         f"{100 * share[0]:.1f}%, chain "
                         f"{100 * share[1]:.1f}% ({step:.1f} cycles, "
                         f"{step / ghz / 1e3:.3f} us a step at {ghz:.3f} "
                         f"GHz), loss {100 * share[2]:.1f}%")
            print(line)
        if not all(same):
            sys.exit("the CTC kernels of the two trees differ")


def latency(torch):
    """LATENCY_SRC's four modes, 1000 steps each (after a run to warm up):
    the cycles of one step of each."""
    p, i = ctypes.c_void_p, ctypes.c_int
    d = OUT / "latency"
    d.mkdir(parents=True, exist_ok=True)
    (d / "latency.cu").write_text(LATENCY_SRC)
    nvcc_all([(d / "latency.cu", d / "liblatency.so")])
    lib = ctypes.CDLL(str(d / "liblatency.so"))
    lib.run_latency.argtypes = [p, p, i, i, p]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    inp = torch.randn(1024, generator=gen, device="cuda") * 3 - 5
    out = torch.empty(1024, device="cuda")
    cycles = torch.zeros(4, dtype=torch.int64, device="cuda")
    print("\na step of the CTC backward's chain alone (cycles, 1000 steps):")
    for mode, name in enumerate((
            "128 threads: shared round trip + a 128-thread barrier",
            "1 thread: two logaddexp and an add, in registers",
            "128 threads: the same a state a thread, barrier",
            "1 warp: the same four states a lane, __syncwarp")):
        for _ in range(2):
            err = lib.run_latency(out.data_ptr(), inp.data_ptr(), mode, 1000,
                                  cycles.data_ptr())
            if err:
                sys.exit(f"latency mode {mode} failed: {err}")
        print(f"  {name:<56} {cycles[mode].item() / 1000:8.1f}")


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


STEPS_SCRIPT = r"""
import sys, time, torch
import chip_smoke as cs
import paddle_tpu_torch.fluid as fluid
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
lines = []
cs.log = lambda m: lines.append(m)


def profile(torch, fn, title, card, reps=3, groups=None):
    # the tree's own profile() may print less: this one gives the
    # device-busy ms and the device kernels (launches and copies) a call
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy = kernels = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and "CUDA" in str(getattr(ev, "device_type", "")):
            busy += us / 1e3 / reps
            kernels += ev.count / reps
    lines.append(f"wall {wall:.2f} ms per call, device busy {busy:.2f} ms, "
                 f"{kernels:.0f} device kernels")


cs.profile = profile
card = cs.card_line()
phases = {6: lambda: cs.phase_textcls(torch, fluid, 0, card),
          8: lambda: cs.phase_textcls(torch, fluid, 0, card, "gru"),
          9: lambda: cs.phase_ctc(torch, fluid, 0, card)}
for k in map(int, sys.argv[1].split(",")):
    phases[k]()
for m in lines:
    if m.startswith(("kernel_tier=", "== phase", "wall ")):
        print(m.strip())
"""


# runs of each tree in `steps`: a whole-process step time spreads by ~10%
# from run to run on one host, so a claim needs most of ten pairs
PAIRS = 10
NAMES = {6: "phase 6 (LSTM)", 8: "phase 8 (GRU)", 9: "phase 9 (CTC)"}


def steps(tree, phases, pairs):
    """chip_smoke.py's ``phases`` (of 6, 8, 9) from `tree` and from this
    checkout, ``pairs`` runs each, a process a run, in alternating pairs
    (tree, this; this, tree; ...); prints each run's steady ms a step and
    peak memory on both routes and the profiled kernel-route step's
    device-busy ms and device kernels, then for each phase the kernel
    route's times by pair and the verdict: met where this checkout is
    faster in every pair, not met where it is faster in at most half of
    them, unresolved between; and the same for the device-busy ms (the
    host sets the step time; the device time is what the kernels move)."""
    here = Path.cwd()
    order = []
    for k in range(pairs):
        order += [("tree", tree), ("this", here)][::1 if k % 2 == 0 else -1]
    runs = {"tree": [], "this": []}
    arg = ",".join(map(str, phases))
    for label, root in order:
        res = subprocess.run([sys.executable, "-c", STEPS_SCRIPT, arg],
                             cwd=root, capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"phases {arg} failed in {root}:\n{res.stdout}"
                     f"{res.stderr[-4000:]}")
        print(f"\nphases {arg} from {label} ({root}):")
        kernel_ms, busy_ms = [], []
        for line in res.stdout.splitlines():
            m = re.search(r"^kernel_tier=(\w+).*steady ([\d.]+) ms/step.*"
                          r"peak memory ([\d.]+) GiB", line)
            b = re.search(r"^wall ([\d.]+) ms per call, device busy "
                          r"([\d.]+) ms, (\d+) device kernels", line)
            if line.startswith("=="):
                print("  " + line)
            elif m:
                print(f"    kernel_tier={m[1]}: {m[2]} ms a step, peak "
                      f"{m[3]} GiB")
                if m[1] == "auto":
                    kernel_ms.append(float(m[2]))
            elif b:
                print(f"    profiled kernel-route step: wall {b[1]} ms, "
                      f"device busy {b[2]} ms, {b[3]} device kernels")
                busy_ms.append(float(b[2]))
        runs[label].append((kernel_ms, busy_ms))
    for what, i in (("ms a step", 0), ("device-busy ms a step", 1)):
        print(f"\nkernel route, {what}, {pairs} pairs (tree / this):")
        for k, phase in enumerate(phases):
            got = [(a[i][k], b[i][k])
                   for a, b in zip(runs["tree"], runs["this"])]
            wins = sum(b < a for a, b in got)
            verdict = ("met" if wins == len(got) else
                       "not met" if 2 * wins <= len(got) else "unresolved")
            med = [sorted(v)[len(v) // 2] for v in zip(*got)]
            print(f"  {NAMES[phase]}: " + ", ".join(f"{a:.2f} / {b:.2f}"
                                                   for a, b in got)
                  + f"; medians {med[0]:.2f} / {med[1]:.2f}; this faster "
                  f"in {wins} of {len(got)}: {verdict}")


if __name__ == "__main__":
    main()
