"""Where MobileNet-SSD's training step on the card parts from the same step
on the CPU: every variable of step 1, forward and backward, beside the
CPU's.

    python3 ssd_divergence.py [--dtype float32|float64] [--scale 1.0]
                              [--image 300] [--batch 32] [--seed 0]
                              [--out FILE]

Run from the root of a checkout on a machine with a card; a measurement
tool beside chip_smoke.py, not part of the port's package. Builds the
model with ``paddle_tpu_torch.testing.models.mobilenet_ssd`` (TF32 off),
runs its startup on the CPU, and runs the training program once on the
card and once on the CPU from that state on ``models.ssd_feed(batch,
image, seed + 26)`` (phase 26's feed), fetching every variable an op
writes before the update. Writes one line a variable to ``--out`` (tab
separated: the index of the op that first writes it, the op's type, the
name, the largest difference over the CPU's largest element, the L2
difference over the CPU's L2 norm, the shape, the CPU's largest
element), and prints the card's name and power limit and the first 25
variables whose largest difference is beyond 1e-3 (float32) or 1e-9
(float64). A variable several grad ops add into is fetched as its sum,
so read it at its last writer.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--image", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="ssd_divergence.tsv")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_divergence.py needs a CUDA card")
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.testing import models as M

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    main_prog, startup, _, _ = M.mobilenet_ssd(
        fluid, scale=args.scale, image=args.image, seed=args.seed,
        dtype=args.dtype)
    cpu = fluid.Executor(fluid.CPUPlace())
    init = fluid.Scope()
    cpu.run(startup, scope=init)
    state = {n: init.find_var(n).numpy() for n in init.local_names()
             if torch.is_tensor(init.find_var(n))}
    names, writer = [], {}
    for i, op in enumerate(main_prog.global_block().ops):
        if op.type == "momentum":
            break
        for n in op.output_arg_names():
            if n not in state and n not in writer:
                writer[n] = (i, op.type)
                names.append(n)
    feed = M.ssd_feed(args.batch, args.image, args.seed + 26)
    if args.dtype == "float64":
        feed = dict(feed, img=feed["img"].astype(np.float64),
                    gt_box=[b.astype(np.float64) for b in feed["gt_box"]])
    runs = [exe.run(main_prog, feed=feed, fetch_list=names,
                    scope=fluid.io.scope_from_numpy(state, dev),
                    return_numpy=False)
            for exe, dev in ((fluid.Executor(), "cuda"), (cpu, "cpu"))]
    limit = 1e-3 if args.dtype == "float32" else 1e-9
    listed = 0
    with open(args.out, "w") as out:
        for n, a, b in zip(names, *runs):
            if hasattr(a, "lens"):
                a, b = a.data, b.data
            if not torch.is_tensor(a):
                continue
            a, b = a.detach().cpu().double(), b.detach().cpu().double()
            top = max(float(b.abs().max()) if b.numel() else 0.0, 1e-300)
            big = float((a - b).abs().max()) / top if b.numel() else 0.0
            l2 = float((a - b).norm()) / max(float(b.norm()), 1e-300)
            i, kind = writer[n]
            out.write(f"{i}\t{kind}\t{n}\t{big:.3e}\t{l2:.3e}\t"
                      f"{tuple(a.shape)}\t{top:.3e}\n")
            if big > limit and listed < 25:
                print(f"{n} (op {i}, {kind}): {big:.3e} of the largest, "
                      f"{l2:.3e} L2, {tuple(a.shape)}")
                listed += 1
    print(f"{len(names)} variables, {args.dtype}, batch {args.batch}; "
          f"written to {args.out}")


if __name__ == "__main__":
    main()
