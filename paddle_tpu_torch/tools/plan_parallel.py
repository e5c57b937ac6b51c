"""The placement planner from the command line: render the auto-parallelism
PlacementReport for a saved bundle or a program (counterpart of
tools/plan_parallel.py, with its options and exit codes).

Does what ``ModelRegistry.warm(plan=True)`` does at publish time, but for
an arbitrary bundle dir (a registry version dir or a raw
``save_inference_model`` export): load the bundle into a throwaway scope,
enumerate the legal (dp, pp, tp, sp) meshes for the device count, cost
each candidate (FLOPs measured by ``obs.perf.attribute`` on the device +
the analytic collective model), and print the ranked report — chosen mesh
first, pruned candidates with why-notes. ``--program`` plans a bare
``__model__`` file (or a bundle's program) without its persistables: its
compute term is the static estimate, nothing runs.

With ``--out`` (or, for a bundle carrying a registry ``VERSION.json``,
``--certify``) the searched report is persisted as a ``.jplan`` artifact
(parallel/planner.py's content-addressed envelope) so replicas — or the
next invocation — load instead of searching; ``--certify`` also writes the
manifest's ``plan_files``. A fingerprint-matching existing artifact is a
cache hit and re-renders without a search.

Usage (from the repository root):
  python -m paddle_tpu_torch.tools.plan_parallel --bundle DIR
         [--devices N] [--batch N] [--memory-budget BYTES]
         [--max-candidates N] [--out DIR] [--certify] [--json]
         [--place cuda|cpu]
  python -m paddle_tpu_torch.tools.plan_parallel --program FILE_OR_DIR
         --devices N [--batch N] [--json]

Exit code: 0 with a chosen candidate, 1 when every candidate was pruned
or no mesh is legal, 2 on unreadable input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _certify_manifest(bundle, store):
    """Update the bundle's VERSION.json ``plan_files`` to exactly the
    artifacts this run touched, pruning stale plans — no-op when the
    bundle has no manifest (a raw export: the artifact self-digest is the
    integrity layer)."""
    from ..parallel import planner as pl
    from ..serving.registry import VERSION_MANIFEST, _sha256_file

    mpath = os.path.join(bundle, VERSION_MANIFEST)
    try:
        with open(mpath) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    touched = set(store.touched())
    plan_files = {}
    for name in sorted(os.listdir(store.path)):
        fpath = os.path.join(store.path, name)
        if not os.path.isfile(fpath) or name.endswith(".tmp"):
            continue
        if name in touched:
            plan_files[f"{pl.PLAN_DIRNAME}/{name}"] = _sha256_file(fpath)
        elif name.endswith(pl.ARTIFACT_SUFFIX):
            try:
                os.unlink(fpath)
            except OSError:
                pass
    if m.get("plan_files") != plan_files:
        m["plan_files"] = plan_files
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(m, f, indent=1, sort_keys=True)
        os.replace(tmp, mpath)
    return plan_files


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="enumerate + cost-model parallel placements for a "
                    "bundle or a program and render the ranked report")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle",
                     help="registry version dir or raw "
                          "save_inference_model export")
    src.add_argument("--program",
                     help="a __model__ file (or a bundle dir) planned "
                          "without its persistables: FLOPs estimated "
                          "from the parameter shapes")
    ap.add_argument("--devices", type=int, default=None,
                    help="device count to plan for (default: the visible "
                         "cards, 1 on the CPU)")
    ap.add_argument("--batch", type=int, default=None,
                    help="feed batch rows to synthesize (default: the "
                         "device count, so every dp degree divides)")
    ap.add_argument("--memory-budget", type=int, default=None,
                    help="per-device memory budget in bytes (default: "
                         "the plan_memory_budget_bytes flag; 0 = off)")
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="ranked candidates to keep (default: the "
                         "plan_max_candidates flag)")
    ap.add_argument("--out", default=None,
                    help="persist the report into this plan-artifact "
                         "dir instead of <bundle>/plan/")
    ap.add_argument("--certify", "--publish", dest="certify",
                    action="store_true",
                    help="persist under <bundle>/plan/ and update the "
                         "bundle's VERSION.json plan_files (the "
                         "registry certify semantics)")
    ap.add_argument("--json", action="store_true",
                    help="print the full report document as JSON "
                         "instead of the rendered table")
    ap.add_argument("--place", choices=("cuda", "cpu"), default="cuda",
                    help="device the bundle loads and is measured on "
                         "(default: the card)")
    args = ap.parse_args(argv)

    from .. import fluid
    from ..core.scope import Scope
    from ..obs import perf
    from ..parallel import planner as pl

    path = os.path.abspath(args.bundle or args.program)
    if not os.path.exists(path):
        print(f"plan_parallel: {path!r} does not exist", file=sys.stderr)
        return 2
    place = fluid.CPUPlace() if args.place == "cpu" else fluid.CUDAPlace(0)
    exe = scope = None
    try:
        if args.program:
            from .lint_program import load_program_meta
            program, feed_names, fetch_names = load_program_meta(path)
            fetch_vars = list(fetch_names)
        else:
            if not os.path.isdir(path):
                print(f"plan_parallel: {path!r} is not a directory",
                      file=sys.stderr)
                return 2
            scope = Scope()
            exe = fluid.Executor(place)
            program, feed_names, fetch_vars = \
                fluid.io.load_inference_model(path, exe, scope=scope)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"plan_parallel: cannot load {path!r}: {e}", file=sys.stderr)
        return 2
    n = args.devices or pl._device_count(
        exe.device if exe is not None else pl._device(None))
    try:
        feed = perf.template_feed(program, feed_names,
                                  batch=args.batch or max(n, 1))
    except ValueError as e:
        print(f"plan_parallel: cannot synthesize feeds: {e}",
              file=sys.stderr)
        return 2

    store = None
    if args.out:
        store = pl.PlanStore(args.out)
    elif args.certify and args.bundle:
        store = pl.PlanStore(os.path.join(path, pl.PLAN_DIRNAME))
    elif args.bundle:
        # the bundle's published plan/ dir (manifest-pinned) when it
        # exists: a matching artifact renders without a search
        store = pl.resolve_store(path)

    try:
        report = pl.plan(program, feed_example=feed, n_devices=n,
                         fetch_list=fetch_vars, executor=exe, scope=scope,
                         memory_budget=args.memory_budget,
                         max_candidates=args.max_candidates, store=store,
                         measure=exe is not None)
    except pl.PlanError as e:
        print(f"plan_parallel: {e}", file=sys.stderr)
        return 1

    if args.json:
        print(json.dumps(report.to_doc(), indent=1, sort_keys=True))
    else:
        print(report.render())
    if args.certify and args.bundle and store is not None:
        _certify_manifest(path, store)
    if report.chosen is None:
        print("plan_parallel: every candidate was pruned — raise the "
              "memory budget or shrink the model", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
