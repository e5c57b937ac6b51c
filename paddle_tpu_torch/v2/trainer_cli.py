"""paddle_trainer — the legacy trainer CLI over v2 configs (counterpart of
paddle_tpu/v2/trainer_cli.py).

Reference: paddle/trainer/TrainerMain.cpp:24-61 — one binary
with ``--config=<v2 config.py>`` and ``--job`` one of train / test /
checkgrad / time, plus --config_args k=v overrides. Here the config is
parsed by v2.parse_config (the same DSL the reference compiles to a
ModelConfig) and the jobs run on the port's fluid executor, on the card
unless ``--use_gpu=false`` (the legacy trainer's own flag) asks for the
CPU:

    python -m paddle_tpu_torch.v2.trainer_cli --config=rnn.py \
        --config_args=batch_size=8,hidden_size=16 --job=train --num_passes=2

The ``time`` job prints ms a batch and, on the card, the device's busy
share of one profiled step. ``--job=merge`` (the reference's MergeModel)
writes one self-contained deployable artifact to ``--model_dir``: the
config's last output pruned from its data layers, the startup state baked
in, exported with ``fluid.aot.export_inference_artifact`` on the job's
device (the card, or the CPU under ``--use_gpu=false``), which
``paddle_tpu_torch/capi`` serves from C.

Data comes from ``--reader module:callable`` (a reader creator returning
batches of per-layer tuples) or, absent that, a deterministic synthetic
feed generator derived from the config's data layers — the stand-in for
the reference's PyDataProvider2 protocol.

The checkgrad job ports Trainer::checkGradient (Trainer.cpp:315-377):
perturb each parameter along its (noised) gradient direction with a step
sized so the analytic directional delta is ``eps * cost``, then compare
the central finite difference of the cost against the analytic delta.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import numpy as np
import torch


from .config_helpers import parse_config_args as _parse_config_args


def _synthetic_reader(topo, batch_size, batches, seed=7):
    """Deterministic feeds shaped by the config's data layers: dense floats
    ~N(0,1); int64 label ids uniform in [0, layer_size); id sequences of
    random length 3..12."""
    layers = [d for d in topo.data_layers if not d.is_pending]
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(batches):
            rows = []
            for _ in range(batch_size):
                row = []
                for d in layers:
                    v = d._var
                    if v.lod_level > 0 and v.dtype == "int64":
                        ln = int(rng.randint(3, 13))
                        row.append(rng.randint(0, max(d._data_size, 2),
                                               (ln, 1)).astype("int64"))
                    elif v.lod_level > 0:
                        ln = int(rng.randint(3, 13))
                        row.append(rng.normal(
                            0, 1, (ln, d._data_size)).astype("float32"))
                    elif v.dtype == "int64":
                        row.append([int(rng.randint(
                            0, max(d._data_size, 2)))])
                    else:
                        row.append(rng.normal(
                            0, 1, d._data_size).astype("float32"))
                rows.append(tuple(row))
            yield rows

    return reader


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def job_checkgrad(topo, main, startup, args):
    """Directional gradient check per parameter (Trainer.cpp:315-377)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.framework import grad_var_name

    with fluid.program_guard(main, startup):
        fluid.append_backward(topo.cost)
    exe = fluid.Executor(_place(args))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    params = [p.name for p in main.all_parameters()]
    reader = _make_reader(topo, args, batches=1)
    batch = next(iter(reader()))
    trainer = _FeedOnly(topo, main)
    feed = trainer._feed(batch)

    # snapshot params, fetch cost+grads once, restore: the main program
    # contains the optimizer update ops and must not move the params the
    # finite differences are taken around
    snapshot = {p: scope.find_var(p).clone() for p in params}
    fetch = [topo.cost] + [grad_var_name(p) for p in params]
    vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    cost = float(np.asarray(vals[0]))
    grad_map = {p: np.asarray(g, dtype=np.float64)
                for p, g in zip(params, vals[1:])}
    for p, v in snapshot.items():
        scope.set(p, v)

    # cost evaluations run the FORWARD slice only (no updates)
    from paddle_tpu_torch.fluid.io import _prune_program
    cost_name = topo.cost if isinstance(topo.cost, str) else topo.cost.name
    fwd_prog = _prune_program(main, [d.name for d in topo.data_layers
                                     if not d.is_pending], [cost_name])

    rng = np.random.RandomState(11)
    eps = args.checkgrad_eps
    max_diff, failed = 0.0, []
    for p in params:
        g = grad_map[p].reshape(-1)
        d = g + 0.1 * np.abs(g).mean() * rng.normal(size=g.shape)
        delta = float(g @ d)
        step = (cost / delta * eps) if delta != 0 else eps
        kept = scope.find_var(p)
        old = _host(kept).copy()

        def cost_at(vec):
            scope.set(p, torch.tensor(vec.reshape(old.shape).astype(
                old.dtype), device=kept.device))
            v, = exe.run(fwd_prog, feed=feed, fetch_list=[cost_name],
                         scope=scope)
            return float(np.asarray(v))

        c1 = cost_at(old.reshape(-1) + step * d)
        c2 = cost_at(old.reshape(-1) - step * d)
        scope.set(p, kept)
        true_delta = 0.5 * (c1 - c2)
        diff = (1e-20 + true_delta) / (1e-20 + delta * step) - 1
        flag = " ***" if abs(diff) > 0.01 else ""
        print(f"{p:24s} step={step:<12.4e} cost1={c1:<12.6f} "
              f"cost2={c2:<12.6f} true_delta={true_delta:<12.4e} "
              f"analytic_delta={delta * step:<12.4e} diff={diff:.6f}{flag}")
        max_diff = max(max_diff, abs(diff))
        if abs(diff) > 0.01:
            failed.append(p)
    print(f"checkgrad max diff: {max_diff:.6f}")
    return 1 if failed else 0


def _provider_reader(topo, is_train=True):
    """When the config declared define_py_data_sources2(module=..., obj=...),
    load the @provider-decorated function and bind it as the reader
    (reference PyDataProvider2 path: the C++ trainer pulled batches through
    the provider; here it IS the reader)."""
    src = topo.data_sources or {}
    module, obj = src.get("module"), src.get("obj")
    if not (module and obj):
        return None
    file_list = src.get("train_list" if is_train else "test_list")
    if file_list is None:
        return None
    if isinstance(file_list, str):
        # the reference contract: train_list/test_list name a LIST FILE of
        # data filenames (trainer config_parser); a missing list file is a
        # config error, not a data file
        if not os.path.exists(file_list):
            raise FileNotFoundError(
                f"data source list file not found: {file_list!r}")
        with open(file_list) as f:
            file_list = [ln.strip() for ln in f if ln.strip()]
    provider_cls = getattr(importlib.import_module(module), obj)
    return provider_cls(file_list, input_order=topo.feed_order,
                        is_train=is_train, **(src.get("args") or {}))


def _make_reader(topo, args, batches=None, is_train=True):
    if args.reader:
        mod, _, fn = args.reader.partition(":")
        return getattr(importlib.import_module(mod), fn)()
    from_provider = _provider_reader(topo, is_train=is_train)
    if from_provider is not None:
        # providers yield samples; the CLI reader contract is batch-level
        from ..reader.minibatch import batch
        return batch(from_provider,
                     int(topo.settings.get("batch_size") or 16))
    bs = topo.settings.get("batch_size") or 16
    return _synthetic_reader(topo, int(bs),
                             batches or args.batches_per_pass)


class _FeedOnly:
    """Feed-building shim for jobs that drive the executor directly."""

    def __init__(self, topo, main):
        self._feed_order = topo.feed_order
        self._main = main

    def _feed(self, data_batch):
        import paddle_tpu_torch.v2.trainer as t
        return t.SGD._feed(self, data_batch)


def _flag(v):
    return str(v).strip().lower() not in ("0", "false", "no", "off")


def _place(args):
    """The card unless ``--use_gpu=false``."""
    import paddle_tpu_torch.fluid as fluid
    return None if args.use_gpu else fluid.CPUPlace()


def job_merge(topo, main_prog, startup, args):
    """The MergeModel analog (reference trainer_cli.py:237-266): run
    startup, keep only the data layers the pruned output reads (an
    inference config, ``outputs(net)``, needs no label feed), and export
    the artifact to ``--model_dir``."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.block_walk import free_reads
    from paddle_tpu_torch.fluid import aot
    from paddle_tpu_torch.fluid.io import _prune_program

    exe = fluid.Executor(_place(args))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    out_var = topo.outputs[-1]
    out_name = out_var.var.name if hasattr(out_var, "var") else out_var
    declared = topo.feed_order
    free = free_reads(_prune_program(main_prog, declared, [out_name]), 0)
    feeds = [n for n in declared if n in free]
    if set(declared) - set(feeds):
        print("note: data layers not reachable from the merged output "
              f"were dropped from the feed list: "
              f"{sorted(set(declared) - set(feeds))}")
    model_dir = args.model_dir or "merged_model"
    aot.export_inference_artifact(model_dir, feeds, [out_name], exe,
                                  main_program=main_prog, scope=scope)
    print(f"merged model -> {model_dir} (output {out_name!r}, feeds "
          f"{feeds}, device {exe.device})")
    return 0


def _busy_share(exe, step):
    """One profiled ``step`` on the card: (wall ms, device-busy ms), or None
    when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and "CUDA" in str(getattr(ev, "device_type", "")):
            busy += us / 1e3
    return (wall, busy) if busy > 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser(prog="paddle_trainer")
    ap.add_argument("--config", required=True)
    ap.add_argument("--config_args", default="")
    ap.add_argument("--job", default="train",
                    choices=["train", "test", "checkgrad", "time", "merge"])
    ap.add_argument("--model_dir", default=None,
                    help="merge job: the artifact's directory")
    ap.add_argument("--num_passes", type=int, default=1)
    ap.add_argument("--batches_per_pass", type=int, default=8)
    ap.add_argument("--reader", default=None,
                    help="module:reader_creator for real data")
    ap.add_argument("--checkgrad_eps", type=float, default=1e-4)
    ap.add_argument("--use_gpu", type=_flag, default=True,
                    help="false runs every job on the CPU (default: the "
                         "card)")
    ap.add_argument("--sequence_inputs", default="",
                    help="comma-separated data-layer names fed as "
                         "sequences (the data-provider knowledge the "
                         "reference supplies at runtime)")
    args = ap.parse_args(argv)

    from .config_helpers import parse_config
    topo, main_prog, startup = parse_config(
        args.config, config_args=_parse_config_args(args.config_args),
        sequence_inputs=tuple(n for n in args.sequence_inputs.split(",")
                              if n))

    if args.job == "checkgrad":
        return job_checkgrad(topo, main_prog, startup, args)
    if args.job == "merge":
        return job_merge(topo, main_prog, startup, args)

    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.v2 as v2

    with fluid.program_guard(main_prog, startup):
        trainer = v2.SGD(cost=topo.cost, optimizer=topo.create_optimizer(),
                         feed_order=topo.feed_order,
                         main_program=main_prog, startup_program=startup,
                         place=_place(args))
    reader = _make_reader(topo, args, is_train=args.job != "test")

    if args.job == "train":
        def handler(evt):
            if isinstance(evt, v2.event.EndPass):
                print(f"Pass {evt.pass_id}: cost={evt.metrics['cost']:.6f}")

        trainer.train(reader, num_passes=args.num_passes,
                      event_handler=handler)
        return 0
    if args.job == "test":
        metrics = trainer.test(reader)
        print(f"Test: {metrics}")
        return 0
    if args.job == "time":
        batches = list(reader())
        t0 = time.perf_counter()
        trainer.train(lambda: iter(batches), num_passes=1,
                      event_handler=lambda e: None)
        if trainer._exe.device.type == "cuda":
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / max(len(batches), 1)
        print(f"time: {dt * 1e3:.3f} ms/batch over {len(batches)} batches")
        if trainer._exe.device.type == "cuda" and batches:
            prof = _busy_share(trainer._exe,
                               lambda: trainer._run(trainer._main,
                                                    batches[0]))
            print("time: busy share of a profiled step: "
                  + (f"{100 * prof[1] / prof[0]:.1f}% ({prof[1]:.3f} of "
                     f"{prof[0]:.3f} ms)" if prof else "not measured"))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
