"""paged_attention and the optimizer arenas of another tree against this
checkout's on the card, and paged_attention's partition size.

    python3 decode_arena.py --tree DIR [--parts compare,part] [--pairs 2]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card; a measurement tool beside chip_smoke.py, not part of the port's
package. Prints the card's name and power limit, then, by part (default
``compare,part``):

* ``compare``: ``--pairs`` pairs of processes in turns (DIR, this, this,
  DIR, ...), each importing its own tree's ``paddle_tpu_torch`` and
  building its kernels: paged_attention at chip_smoke.py's Llama-2-7B
  decode shapes (32 slots, 32 heads of 128, blocks of 16; contexts drawn
  1..4096, and every slot at 4096) and at the serving lane's, and
  momentum_arena, sgd_arena and adam_arena over ResNet-50's 161 trainable
  tensors. Per process and shape: the call's time (CUDA events), the
  profiler's device time by kernel, and the host's enqueue; per arena also
  the wrapper's host pass alone and ``SGD(fused=True)`` /
  ``SGD(momentum=0.9, fused=True)`` / ``Adam(fused=True)`` in turns with
  the call (5 samples each). Every result is first held to its plain
  version (paged_attention within atol 1e-5 / rtol 1e-4, the arenas
  bitwise).
* ``part``: this checkout's paged_attention at the two Llama shapes with
  ``PART`` 128, 256 and 512 positions, in turns (128, 256, 512, 512, 256,
  128), with each one's time and share of the bound.

Nothing runs at import.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
PARTS = (128, 256, 512)


def llama_cases(torch, seed):
    """chip_smoke.py phase 12's two Llama-2-7B decode shapes, drawn the
    same way: ((name, operands), ...), built one at a time."""
    import numpy as np
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    rng = np.random.RandomState(seed + 12)
    p = cs.PA_CTX // cs.PA_BLOCK
    lens = rng.randint(1, cs.PA_CTX + 1, cs.PA_SLOTS)
    lens[rng.choice(cs.PA_SLOTS, 2, replace=False)] = 0
    yield "llama", cs.paged_operands(torch, gen, rng, cs.PA_SLOTS,
                                     cs.PA_HEADS, cs.PA_DIM, cs.PA_BLOCK, p,
                                     lens, 64)
    torch.cuda.empty_cache()
    yield "llama_4096", cs.paged_operands(
        torch, gen, rng, cs.PA_SLOTS, cs.PA_HEADS, cs.PA_DIM, cs.PA_BLOCK,
        p, [cs.PA_CTX] * cs.PA_SLOTS, 64)
    torch.cuda.empty_cache()


def lane_case(torch, seed):
    import numpy as np
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    rng = np.random.RandomState(seed + 12)
    p = cs.GEN_MAX_LEN // cs.GEN_BLOCK
    lens = [0, 1, 5, cs.GEN_BLOCK, 23, 31, p * cs.GEN_BLOCK, 0]
    used = sum(-(-n // cs.GEN_BLOCK) for n in lens)
    return cs.paged_operands(torch, gen, rng, cs.GEN_MAX_SEQS, cs.GEN_HEADS,
                             cs.GEN_EMB // cs.GEN_HEADS, cs.GEN_BLOCK, p,
                             lens, cs.GEN_BLOCKS - used)


def paged_numbers(torch, pak, args):
    """{ms, device: {kernel: ms}, enqueue_ms, bound_ms} of one shape, after
    the result is held to the plain version."""
    want = pak.paged_attention_torch(*args)
    got = pak.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    if not bool(((got - want).abs()
                 <= cs.PA_ATOL + cs.PA_RTOL * want.abs()).all()):
        cs.fail("paged_attention differs from its plain version")
    del want, got

    def call():
        pak.paged_attention_cuda(*args)

    ops = 4 * int(args[4].sum().item()) * args[0].shape[1] \
        * args[0].shape[2]
    return {"ms": cs.time_ms(call, torch),
            "device": {cs.kernel_name(k): v
                       for k, v in cs.device_ms(torch, call, 10).items()
                       if "paged_attention" in k},
            "enqueue_ms": cs.host_ms(torch, call),
            "bound_ms": cs.bound_ms(ops, cs.paged_bytes(args))[0]}


def resnet50_params(torch, fluid, seed):
    """ResNet-50's trainable tensors on the card (161, 25 557 032
    elements), with grads and two state lists, from a seed."""
    main, _, _ = cs.build_resnet50_train(fluid, seed)
    shapes = [tuple(p.shape) for p in main.global_block().all_parameters()
              if p.trainable]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return ([randn(s, 0.05) for s in shapes],
            [randn(s, 1e-3) for s in shapes],
            [randn(s, 1e-3) for s in shapes],
            [randn(s, 1e-3).abs() for s in shapes])


def host_pass(opk, name, ps, gs, state, reps=50):
    """The wrapper's host pass alone, ms a call: the kept tables where the
    tree has them (chip_smoke.host_pass_ms), else the parent's
    ``_gather`` + ``pack_table``."""
    if hasattr(opk, "_tables"):
        return cs.host_pass_ms(opk, name, ps, gs, state, reps)["kept"]
    dev = ps[0].device
    lists = [ps, gs] + list(state)
    width = len(lists) + 2
    opk.pack_table(*opk._gather(name, lists, dev), opk._max_rows(width))
    t0 = time.perf_counter()
    for _ in range(reps):
        opk.pack_table(*opk._gather(name, lists, dev), opk._max_rows(width))
    return (time.perf_counter() - t0) * 1e3 / reps


def arena_numbers(torch, opk, ps, gs, v1, v2):
    """Per arena over ResNet-50's set: bitwise against the plain version,
    then {ms, kernel_device_ms, enqueue_ms, host_pass_ms, turns: (call
    samples, library samples), library_device_ms, bound_ms}."""
    lr = torch.full((), 0.0125, device="cuda")
    pows = (torch.full((1,), 0.9, device="cuda"),
            torch.full((1,), 0.999, device="cuda"))
    nelem = sum(p.numel() for p in ps)
    out = {}
    specs = {
        "sgd_arena": (
            lambda q: opk.sgd_arena(q[0], gs, lr),
            lambda q: opk.sgd_arena_torch(q[0], gs, lr),
            1, 12, dict(lr=0.0125)),
        "momentum_arena": (
            lambda q: opk.momentum_arena(q[0], gs, q[1], lr, 0.9, False),
            lambda q: opk.momentum_arena_torch(q[0], gs, q[1], lr, 0.9,
                                               False),
            2, 20, dict(lr=0.0125, momentum=0.9)),
        "adam_arena": (
            lambda q: opk.adam_arena(q[0], gs, q[1], q[2], lr, *pows, 0.9,
                                     0.999, 1e-8),
            lambda q: opk.adam_arena_torch(q[0], gs, q[1], q[2], lr, *pows,
                                           0.9, 0.999, 1e-8),
            3, 28, dict(lr=0.0125)),
    }
    for name, (kernel, plain, n, per, lib_kw) in specs.items():
        q = [ps, v1, v2][:n]
        got = kernel([[t.clone() for t in ts] for ts in q])
        want = plain(q)
        got = [got] if name == "sgd_arena" else got
        want = [want] if name == "sgd_arena" else want
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for gl, wl in zip(got, want)
                   for a, b in zip(gl, wl)):
            cs.fail(f"{name} differs from its plain version")
        del got, want
        q = [[t.clone() for t in ts] for ts in q]
        lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
        for p, g in zip(lib_ps, gs):
            p.grad = g
        lib = (torch.optim.Adam if name == "adam_arena"
               else torch.optim.SGD)(lib_ps, fused=True, **lib_kw)

        def call(q=q, kernel=kernel):
            kernel(q)

        kern, _, _ = cs.split_device(cs.device_ms(torch, call), name)
        ka, la = cs.turns_ms(torch, call, lib.step)
        out[name] = {
            "ms": cs.time_ms(call, torch), "kernel_device_ms": kern,
            "enqueue_ms": cs.host_ms(torch, call),
            "host_pass_ms": host_pass(opk, name, q[0], gs, q[1:]),
            "turns": (ka, la),
            "library_device_ms": sum(cs.device_ms(torch, lib.step)
                                     .values()),
            "bound_ms": cs.bound_ms(0, per * nelem)[0]}
        del lib, lib_ps, q
    return out


def measure(tree, seed):
    """One process's numbers for ``tree`` (its own paddle_tpu_torch),
    printed as one JSON line."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import paddle_tpu_torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    if Path(paddle_tpu_torch.__file__).resolve().parents[1] \
            != Path(tree).resolve():
        cs.fail(f"imported {paddle_tpu_torch.__file__}, not {tree}'s")
    out = {"lane": paged_numbers(torch, pak, lane_case(torch, seed))}
    for name, args in llama_cases(torch, seed):
        out[name] = paged_numbers(torch, pak, args)
        del args
    ps, gs, v1, v2 = resnet50_params(torch, fluid, seed)
    out.update(arena_numbers(torch, opk, ps, gs, v1, v2))
    print("RESULT " + json.dumps(out), flush=True)


def sweep(torch, seed):
    """This checkout's paged_attention at the Llama shapes with each PART,
    in turns."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    order = list(PARTS) + list(reversed(PARTS))
    for name, args in llama_cases(torch, seed):
        times = {p: [] for p in PARTS}
        for part in order:
            pak.PART = part
            t = paged_numbers(torch, pak, args)
            times[part].append(t["ms"])
            cs.log(f"  {name} PART {part} (nsplit "
                   f"{pak.paged_attention_nsplit(args[3].shape[1], args[1].shape[1])}"
                   f"): {t['ms']:.4f} ms = {t['bound_ms'] / t['ms']:.1%} of "
                   f"the bound {t['bound_ms']:.4f}; device "
                   + ", ".join(f"{k} {v:.4f}" for k, v in t["device"].items()))
        cs.log(f"{name}: " + "; ".join(
            f"PART {p}: {min(v):.4f} / {max(v):.4f} ms"
            for p, v in times.items()))
        del args


def compare(tree, pairs, seed):
    """``pairs`` pairs of processes in turns, tree and this checkout."""
    runs = {"tree": [], "this": []}
    order = []
    for i in range(pairs):
        order += [("tree", tree), ("this", HERE)] if i % 2 == 0 \
            else [("this", HERE), ("tree", tree)]
    for who, root in order:
        r = subprocess.run(
            [sys.executable, str(HERE / "decode_arena.py"), "--measure",
             str(root), "--seed", str(seed)], capture_output=True,
            text=True, timeout=900, cwd=str(root))
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if r.returncode != 0 or not line:
            cs.fail(f"{who} run failed (exit {r.returncode}):\n"
                    f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        res = json.loads(line[0][7:])
        runs[who].append(res)
        cs.log(f"-- {who} ({root}):")
        for k in ("lane", "llama", "llama_4096"):
            t = res[k]
            cs.log(f"  paged_attention {k}: {t['ms']:.4f} ms "
                   f"({t['bound_ms'] / t['ms']:.1%} of the bound "
                   f"{t['bound_ms']:.5f}), enqueue {t['enqueue_ms']:.4f} "
                   f"ms, device " + ", ".join(
                       f"{n} {v:.4f}" for n, v in t["device"].items()))
        for k in ("momentum_arena", "sgd_arena", "adam_arena"):
            t = res[k]
            cs.log(f"  {k}: call {t['ms']:.4f} ms, kernel device "
                   f"{t['kernel_device_ms']:.4f} ms "
                   f"({t['bound_ms'] / max(t['kernel_device_ms'], 1e-9):.1%}"
                   f" of the bound {t['bound_ms']:.4f}), enqueue "
                   f"{t['enqueue_ms']:.4f} ms, host pass "
                   f"{t['host_pass_ms']:.4f} ms; in turns with its library "
                   f"call {cs.samples(t['turns'][0])}, library "
                   f"{cs.samples(t['turns'][1])} (device "
                   f"{t['library_device_ms']:.4f} ms)")
    cs.log("== medians, tree / this ==")
    for k, keys in (("lane", ("ms",)), ("llama", ("ms",)),
                    ("llama_4096", ("ms",)),
                    ("momentum_arena", ("ms", "kernel_device_ms",
                                        "host_pass_ms")),
                    ("sgd_arena", ("ms", "kernel_device_ms",
                                   "host_pass_ms")),
                    ("adam_arena", ("ms", "kernel_device_ms",
                                    "host_pass_ms"))):
        for key in keys:
            a = sorted(r[k][key] for r in runs["tree"])
            b = sorted(r[k][key] for r in runs["this"])
            cs.log(f"{k} {key}: {a[len(a) // 2]:.4f} / {b[len(b) // 2]:.4f} "
                   f"(tree {a}, this {b})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None)
    ap.add_argument("--parts", default="compare,part")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure, args.seed)
        return
    sys.path.insert(0, str(HERE))
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is available")
    cs.log(f"card: {cs.card_line()} | torch {torch.__version__}")
    parts = args.parts.split(",")
    if "part" in parts:
        cs.log("== part: paged_attention's partition size ==")
        sweep(torch, args.seed)
    if "compare" in parts:
        if not args.tree or not os.path.isdir(args.tree):
            cs.fail("--parts compare needs --tree DIR (another checkout)")
        cs.log(f"== compare: {args.tree} against this checkout ==")
        compare(Path(args.tree).resolve(), args.pairs, args.seed)


if __name__ == "__main__":
    main()
