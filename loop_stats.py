"""What bounds the conv mainloop on the card: the ``mma.sync`` peak rates
and the instruction mix of each conv kernel's main loop.

    python3 loop_stats.py

Run from the root of a checkout on a machine with the CUDA toolkit and a
card; a measurement tool beside chip_smoke.py, not part of the port's
package. Prints the card's name and power limit, then:

* the register-only ``mma.sync`` rate, TF32 ``m16n8k8`` and bf16
  ``m16n8k16``, in TFLOP/s (8 warps a block, 16 independent accumulators a
  thread, 528 blocks): the ceiling of any ``mma.sync`` mainloop, 3xTF32
  reaching at most a third of the TF32 figure;
* for each float32 conv kernel of ``csrc/conv_affine.cu``,
  ``csrc/conv_bn_train.cu`` and ``csrc/conv_bn_bwd.cu``, the instructions
  of its main loop (the backward branch whose body holds the HMMAs) by
  opcode, from ``cuobjdump -sass`` of the build, with the count per HMMA.

Builds go to ``build/torch_kernels/loop_stats/``. Nothing runs at import.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

from paddle_tpu_torch.ops.cuda import build

PEAK_SRC = r"""
#include <cstdio>
#include <cstdint>
template <int KIND>
__global__ void __launch_bounds__(256) peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 3 + i;
  float c[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0;
  for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int KIND>
void run(float* out, const char* name, double flop_per_mma) {
  const int blocks = 528, iters = 4096;
  peak<KIND><<<blocks, 256>>>(out, 16);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  peak<KIND><<<blocks, 256>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  const double flop = (double)blocks * 8 * 16 * iters * flop_per_mma;
  printf("mma.sync %s: %.1f TFLOP/s\n", name, flop / ms / 1e9);
}
int main() {
  float* out;
  cudaMalloc(&out, 528 * 256 * sizeof(float));
  run<0>(out, "tf32 m16n8k8", 2048.0);
  run<1>(out, "bf16 m16n8k16", 4096.0);
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
"""

OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
# a float32 conv kernel's mangled name: its name, BM, BN and VEC
KERNEL = re.compile(r"(conv_affine_kernel|"
                    r"conv_stats_kernel|recompute_kernel|dw_gemm_kernel|"
                    r"dx_kernel)IfN7convmma4TileIfLi(\d+)ELi(\d+)ELb\dELb(\d)")


def mma_peak(workdir: Path) -> str:
    """Build and run the register-only mma.sync loop; its output."""
    src, exe = workdir / "mma_peak.cu", workdir / "mma_peak"
    src.write_text(PEAK_SRC)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS[:4], "-o", str(exe),
                    str(src)], check=True, timeout=600)
    return subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True, timeout=600).stdout


def loop_mix(name: str, workdir: Path):
    """{kernel: Counter of opcodes in its HMMA main loop} for the float32
    kernels of ``csrc/<name>.cu``."""
    cubin = workdir / f"{name}.cubin"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS[:4], "-cubin", "-o",
                    str(cubin), str(build.CSRC / f"{name}.cu")], check=True,
                   timeout=900)
    sass = subprocess.run(["cuobjdump", "-sass", str(cubin)], check=True,
                          capture_output=True, text=True, timeout=600).stdout
    return main_loops(sass)


def main_loops(sass: str):
    """{kernel: Counter of opcodes} of the backward branches in a
    ``cuobjdump -sass`` listing whose bodies hold an HMMA (the last such
    loop of each kernel)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        kernel = part.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2), line)
               for line in part.split("\n") for m in [OP.search(line)] if m]
        for addr, op, line in ins:
            target = re.search(r"BRA\s.*?0x([0-9a-f]+)", line)
            if not target or int(target.group(1), 16) >= addr:
                continue
            body = collections.Counter(
                o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr)
            if any(o.startswith("HMMA") for o in body):
                out[kernel] = body
    return out


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    work = build.BUILD_DIR / "loop_stats"
    work.mkdir(parents=True, exist_ok=True)
    print(mma_peak(work), end="")
    for name in ("conv_affine", "conv_bn_train", "conv_bn_bwd"):
        for kernel, mix in loop_mix(name, work).items():
            tile = KERNEL.search(kernel)
            if tile is None:
                continue
            hmma = sum(v for k, v in mix.items() if k.startswith("HMMA"))
            total = sum(mix.values())
            top = ", ".join(f"{k} {v}" for k, v in mix.most_common(8))
            print(f"{tile[1]}<float, {tile[2]}x{tile[3]}"
                  f"{'' if tile[4] == '1' else ', one-element copies'}>: "
                  f"{total} instructions a loop trip, {hmma} HMMA "
                  f"({total / hmma:.2f} per HMMA): {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
