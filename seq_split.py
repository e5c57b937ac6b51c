"""Where one step of the first-version recurrent backwards goes on the card,
and what the candidate exchanges of a redesign cost.

    python3 seq_split.py --tree DIR [--parts split,exchange,compare,steps]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card; a measurement tool beside chip_smoke.py, not part of the port's
package. Prints the card's name and power limit, then:

* for ``lstm_bwd_kernel`` and ``gru_bwd_kernel`` of the first version
  (``csrc/lstm_seq.cu`` and ``csrc/gru_seq.cu`` up to commit 6225d18; give
  such a tree with ``--tree``), the cycles of each phase of one step
  (staging, products, cell math, reductions, dW, barriers), averaged over
  blocks and steps at b 64, L 100, H 512: the kernels are copied, a
  ``clock64`` stamp (with a block barrier) is inserted at each phase's end
  at fixed anchors of their source, and the copies build under
  ``build/torch_kernels/seq_split/``. The launch's time with and without
  the stamps shows what they cost.
* the exchange a redesign could use, alone (no products), over 100 steps of
  128 blocks: every block writing what it owns and reading what it needs
  after a grid barrier, for (a) the first version's broadcast of every
  block's dgates (512 KB in), (b) partial products split over the gate
  columns (128 KB out and 128 KB in, two barriers), and (d) batch-row
  groups of 8 rows whose 16 blocks each hold 32 units' rows of W (4 KB out,
  64 KB in); and two barriers alone.
* whether the card takes a cooperative launch with a cluster dimension,
  and how many clusters of 8 and 16 blocks with 200 KB of shared memory
  each can be resident.
* ``compare``: the first version's backwards (built from ``--tree``)
  against this checkout's, launch for launch at b 64, H 512, L 100 and
  200, timed in turns (first, this, this, first), and this checkout's
  stage shares (prologue, chain, epilogue) from its kernels' clocks.
* ``steps`` (not in the default parts): chip_smoke.py's phases 6, 8 and
  9 (the LSTM and GRU classifiers and the CTC model, trained on both
  routes) run from ``--tree`` and from this checkout in turns, each in a
  process of its own; prints each run's steady ms a step.

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
#define STAMP(i)                                                          \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0) {                                               \
      const long long n_ = clock64();                                     \
      split_cycles[blockIdx.x * 24 + (i)] += n_ - split_last;             \
      split_last = n_;                                                    \
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

DECL = "  long long split_last = clock64();\n"

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

BENCH_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

// mode 0: barriers only; 1: (a) broadcast; 2: (b) partials; 3: (d) row
// groups. buf holds every block's output, dst what the reads summed.
__global__ void __launch_bounds__(256, 1)
exchange(float* buf, float* part, float* dst, int mode, int steps) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, blk = blockIdx.x;
  float s = 0.f;
  for (int t = 0; t < steps; ++t) {
    float4 v = make_float4(t, tid, blk, s);
    if (mode == 1) {        // own 64 rows x 16 columns of [64][2048]
      for (int i = tid; i < 64 * 4; i += 256)
        reinterpret_cast<float4*>(buf)[(i / 4) * 512 + blk * 4 + i % 4] = v;
    } else if (mode == 2) { // a [64][512] partial of its own
      float4* p = reinterpret_cast<float4*>(part) + (size_t)blk * 64 * 128;
      for (int i = tid; i < 64 * 128; i += 256) p[i] = v;
    } else if (mode == 3) { // own 8 rows x 128 columns of [64][2048]
      const int rg = blk / 16, ug = blk % 16;
      for (int i = tid; i < 8 * 32; i += 256)
        reinterpret_cast<float4*>(buf)[(rg * 8 + i / 32) * 512 + ug * 32 +
                                       i % 32] = v;
    }
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
    } else if (mode == 3) { // own 8 rows, every column
      const int rg = blk / 16;
      for (int i = tid; i < 8 * 512; i += 256) {
        const float4 r = __ldcg(reinterpret_cast<const float4*>(buf) +
                                rg * 8 * 512 + i);
        s += r.x + r.y + r.z + r.w;
      }
    } else {
      grid.sync();
    }
  }
  dst[blk * 256 + tid] = s;
}

__global__ void empty_kernel() {}

extern "C" int run_exchange(float* buf, float* part, float* dst, int mode,
                            int steps, void* stream) {
  void* args[] = {&buf, &part, &dst, &mode, &steps};
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


def nvcc(src: Path, out: Path):
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")


def patched(tree: Path, name: str, patch) -> Path:
    """csrc/<name>.cu of `tree` with the stamps inserted, built."""
    csrc = tree / "paddle_tpu_torch" / "csrc"
    src = (csrc / f"{name}.cu").read_text()
    for anchor, repl in patch:
        if src.count(anchor) != 1:
            sys.exit(f"{name}.cu: anchor found {src.count(anchor)} times, "
                     f"not once (a first-version tree is needed):\n{anchor}")
        src = src.replace(anchor, repl)
    src = src.replace('#include "seq_common.cuh"\n',
                      '#include "seq_common.cuh"\n' + STAMPS)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "seq_common.cuh").write_text((csrc / "seq_common.cuh").read_text())
    (d / f"{name}.cu").write_text(src)
    plain = d / f"{name}_plain.cu"
    plain.write_text((csrc / f"{name}.cu").read_text())
    nvcc(d / f"{name}.cu", d / f"lib{name}_split.so")
    nvcc(plain, d / f"lib{name}_plain.so")
    return d


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
    nvcc(d / "clock.cu", d / "libclock.so")
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib_split.split_read.argtypes = [p]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, type=Path)
    ap.add_argument("--parts", default="split,exchange,compare")
    args = ap.parse_args()
    parts = args.parts.split(",")
    import torch
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
    if "split" in parts or "compare" in parts:
        lstm_lib, gru_lib = first_version(torch, args.tree, ghz, L, b, H,
                                          "split" in parts)
    if "exchange" in parts:
        exchange(torch, L)
    if "compare" in parts:
        for steps_ in (100, 200):
            compare(torch, lstm_lib, gru_lib, steps_, b, H)


def first_version(torch, tree, ghz, L, b, H, show):
    """Builds the tree's backwards with and without the stamps, prints
    their split when `show`; returns the two libraries without stamps."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    blocks = H // 4
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    alive = torch.ones(L, b, 1, device=dev)
    d = patched(tree, "lstm_seq", LSTM_PATCH)
    libs = [ctypes.CDLL(str(d / f"liblstm_seq_{k}.so"))
            for k in ("split", "plain")]
    x, w, h0, c0 = randn(L, b, 4 * H), randn(H, 4 * H, scale=0.05), \
        randn(b, H), randn(b, H)
    hs, cs = torch.empty(L, b, H, device=dev), torch.empty(L, b, H,
                                                            device=dev)
    for lib in libs:
        lib.lstm_seq_fwd.argtypes = [p] * 7 + [i, i, i, p]
        lib.lstm_seq_bwd.argtypes = [p] * 13 + [i, i, i, p]
    libs[1].lstm_seq_fwd(x.data_ptr(), alive.data_ptr(), w.data_ptr(),
                         h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
                         cs.data_ptr(), L, b, H, stream)
    dhs, dcs = randn(L, b, H), randn(L, b, H)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)

    def lstm(lib):
        err = lib.lstm_seq_bwd(*(t.data_ptr() for t in (
            x, alive, w, h0, c0, hs, cs, dhs, dcs, dx, dw, dh0, dc0)),
            L, b, H, stream)
        if err:
            sys.exit(f"lstm_seq_bwd launch failed: {err}")

    if show:
        split(torch, libs[0], libs[1], lstm, LSTM_PHASES, L, blocks, ghz,
              f"lstm_bwd_kernel (first version), b {b}, L {L}, H {H}")
    lstm_lib = libs[1]

    d = patched(tree, "gru_seq", GRU_PATCH)
    libs = [ctypes.CDLL(str(d / f"libgru_seq_{k}.so"))
            for k in ("split", "plain")]
    x, w = randn(L, b, 3 * H), randn(H, 3 * H, scale=0.05)
    rh = torch.empty(L, b, H, device=dev)
    for lib in libs:
        lib.gru_seq_fwd.argtypes = [p] * 6 + [i, i, i, p]
        lib.gru_seq_bwd.argtypes = [p] * 10 + [i, i, i, p]
    libs[1].gru_seq_fwd(x.data_ptr(), alive.data_ptr(), w.data_ptr(),
                        h0.data_ptr(), hs.data_ptr(), rh.data_ptr(), L, b,
                        H, stream)
    dx, dw = torch.empty_like(x), torch.empty_like(w)

    def gru(lib):
        err = lib.gru_seq_bwd(*(t.data_ptr() for t in (
            x, alive, w, h0, hs, dhs, dx, dw, dh0, rh)), L, b, H, stream)
        if err:
            sys.exit(f"gru_seq_bwd launch failed: {err}")

    if show:
        split(torch, libs[0], libs[1], gru, GRU_PHASES, L, blocks, ghz,
              f"gru_bwd_kernel (first version), b {b}, L {L}, H {H}; pass "
              f"1 per step of its {L}")
    return lstm_lib, libs[1]


def exchange(torch, L):
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    d = OUT / "exchange"
    d.mkdir(parents=True, exist_ok=True)
    (d / "exchange.cu").write_text(BENCH_SRC)
    nvcc(d / "exchange.cu", d / "libexchange.so")
    lib = ctypes.CDLL(str(d / "libexchange.so"))
    lib.run_exchange.argtypes = [p, p, p, i, i, p]
    lib.error_string.restype = ctypes.c_char_p
    buf = torch.zeros(64 * 2048, device=dev)
    part = torch.zeros(128 * 64 * 512, device=dev)
    dst = torch.zeros(128 * 256, device=dev)
    print(f"\nexchange alone, {L} steps of 128 blocks (us a step):")
    for mode, name in ((0, "2 grid barriers"), (1, "(a) broadcast, 512 KB "
                       "in, 1 barrier"), (2, "(b) partials, 128 KB out + "
                       "128 KB in, 2 barriers"), (3, "(d) row groups, 4 KB "
                       "out, 64 KB in, 1 barrier")):
        def run():
            err = lib.run_exchange(buf.data_ptr(), part.data_ptr(),
                                   dst.data_ptr(), mode, L, stream)
            if err:
                sys.exit(f"exchange {mode}: {lib.error_string(err)}")
        print(f"  {name:<46} {time_ms(torch, run) * 1e3 / L:8.3f}")
    for cluster in (8, 16):
        err = lib.try_coop_cluster(cluster)
        n = lib.max_clusters(cluster, 200 * 1024)
        print(f"cooperative launch with clusters of {cluster}: "
              f"{'accepted' if err == 0 else lib.error_string(err).decode()}"
              f"; resident clusters of {cluster} x 200 KB: "
              f"{n if n >= 0 else lib.error_string(-n).decode()}")


def compare(torch, lstm_lib, gru_lib, L, b, H):
    """The first version's backwards against this checkout's, in turns."""
    from paddle_tpu_torch.ops.cuda import rnn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    alive = torch.ones(L, b, 1, device=dev)
    x, w, h0, c0 = randn(L, b, 4 * H), randn(H, 4 * H, scale=0.05), \
        randn(b, H), randn(b, H)
    hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
    dhs, dcs = randn(L, b, H), randn(L, b, H)
    outs = [torch.empty_like(t) for t in (x, w, h0, c0)]
    args = [t.data_ptr() for t in (x, alive, w, h0, c0, hs, cs, dhs, dcs,
                                   *outs)]
    first = {"lstm_seq_bwd": lambda: lstm_lib.lstm_seq_bwd(*args, L, b, H,
                                                           stream)}
    this = {"lstm_seq_bwd": lambda: rnn.lstm_seq_bwd(
        x, alive, w, h0, c0, hs, cs, dhs, dcs)}
    xg, wg = randn(L, b, 3 * H), randn(H, 3 * H, scale=0.05)
    hg = rnn.gru_seq(xg, alive, wg, h0)
    outs_g = [torch.empty_like(t) for t in (xg, wg, h0, hg)]
    args_g = [t.data_ptr() for t in (xg, alive, wg, h0, hg, dhs, *outs_g)]
    first["gru_seq_bwd"] = lambda: gru_lib.gru_seq_bwd(*args_g, L, b, H,
                                                       stream)
    this["gru_seq_bwd"] = lambda: rnn.gru_seq_bwd(xg, alive, wg, h0, hg,
                                                  dhs)
    for name in ("lstm_seq_bwd", "gru_seq_bwd"):
        t = [time_ms(torch, f) for f in (first[name], this[name],
                                         this[name], first[name])]
        this[name]()
        c = rnn.stage_clocks[name].cpu().double()
        share = (c[1:] - c[:-1]) / (c[3] - c[0])
        print(f"{name}, b {b}, L {L}, H {H}: first version {t[0]:.4f} / "
              f"{t[3]:.4f} ms, this checkout {t[1]:.4f} / {t[2]:.4f} ms a "
              f"launch; stages of this one: prologue "
              f"{100 * share[0]:.1f}%, chain {100 * share[1]:.1f}%, "
              f"epilogue {100 * share[2]:.1f}% of block 0's "
              f"{(c[3] - c[0]).item():.0f} cycles")


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


def steps(tree):
    """chip_smoke.py's phases 6, 8, 9 from `tree` and from this checkout,
    in turns, a process each."""
    here = Path.cwd()
    for label, root in (("first", tree), ("this", here), ("this", here),
                        ("first", tree)):
        res = subprocess.run([sys.executable, "-c", STEPS_SCRIPT],
                             cwd=root, capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"phases 6, 8, 9 failed in {root}:\n{res.stdout}"
                     f"{res.stderr[-4000:]}")
        print(f"\nphases 6, 8, 9 from {label} ({root}):")
        for line in res.stdout.splitlines():
            m = re.search(r"^(kernel_tier=\w+).*steady ([\d.]+) ms/step.*"
                          r"peak memory ([\d.]+) GiB", line)
            if line.startswith("=="):
                print("  " + line)
            elif m:
                print(f"    {m[1]}: {m[2]} ms a step, peak {m[3]} GiB")


if __name__ == "__main__":
    main()
