"""The port stands alone: no module of paddle_tpu_torch/, nor chip_smoke.py
and the measurement scripts beside it, imports jax or the reference
package, and the kernel tier never catches a build or launch failure.

Checked on the source (AST), not on ``sys.modules``: the test process
imports jax anyway, through the reference package.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) \
    + [REPO / name for name in ("chip_smoke.py", "loop_stats.py",
                                "conv_bn_accuracy.py", "seq_split.py",
                                "decode_arena.py", "ssd_divergence.py")]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_training_front_end_modules_are_checked():
    """The training front end's modules (clip, decay, schedules, feeding,
    the metrics, the CRF, nets and evaluators) are among the files the
    import check reads."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for name in ("fluid/clip.py", "fluid/regularizer.py",
                 "fluid/data_feeder.py", "fluid/average.py",
                 "fluid/layers/learning_rate_scheduler.py",
                 "fluid/layers/ops.py", "fluid/layers/control_flow.py",
                 "ops/metrics.py", "ops/crf_ops.py", "fluid/nets.py",
                 "fluid/evaluator.py", "fluid/layers/metric.py"):
        assert "paddle_tpu_torch/" + name in checked, name


def test_parallel_modules_are_checked():
    """The multi-device package (meshes, the sharded step, ring attention,
    MoE, the pipeline, multi-host start-up, the rank spawner) and its
    lanes are among the files the import check reads: the spawned ranks
    import none of the reference either."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for name in ("__init__.py", "collectives.py", "sharding.py", "step.py",
                 "ring_attention.py", "moe.py", "pipeline.py",
                 "multihost.py", "launch.py"):
        assert "paddle_tpu_torch/parallel/" + name in checked, name
    assert "paddle_tpu_torch/testing/multichip.py" in checked
    assert "paddle_tpu_torch/ops/io_ops.py" in checked


def test_input_pipeline_modules_are_checked():
    """The input pipeline (the recordio codec, the readers and their
    double buffer, the dataset parsers, fluid.recordio_writer and the
    ragged lane) is among the files the import check reads: it keeps its
    own copy of the JAX package's 13 pure-numpy parsers, common.py and
    __init__.py."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for name in ("recordio/__init__.py", "reader/__init__.py",
                 "reader/creator.py", "reader/decorator.py",
                 "reader/minibatch.py", "reader/pool.py",
                 "reader/prefetch.py", "dataset/__init__.py",
                 "dataset/common.py", "dataset/mnist.py",
                 "dataset/flowers.py", "fluid/recordio_writer.py",
                 "fluid/layers/io.py", "testing/ragged_lane.py"):
        assert "paddle_tpu_torch/" + name in checked, name
    assert len([p for p in checked
                if p.startswith("paddle_tpu_torch/dataset/")]) == 15


LEGACY = ("v2", "trainer", "trainer_config_helpers", "utils")


def test_legacy_surface_modules_are_checked():
    """The legacy surfaces (v2/ with master/ and plot/, trainer/,
    trainer_config_helpers/, utils/: the JAX package's 32 module names)
    are among the files the import check reads, and the op modules the
    layer DSL reaches too."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    want = sorted(str(p.relative_to(REPO / "paddle_tpu"))
                  for d in LEGACY
                  for p in (REPO / "paddle_tpu" / d).rglob("*.py"))
    have = sorted(p[len("paddle_tpu_torch/"):] for p in checked
                  if p.startswith("paddle_tpu_torch/")
                  and p.split("/")[1] in LEGACY)
    assert len(want) == 32 and have == want, (want, have)
    for name in ("ops/misc_ops.py", "ops/breadth_ops.py", "ops/norm_ops.py",
                 "fluid/io.py", "fluid/evaluator.py"):
        assert "paddle_tpu_torch/" + name in checked, name


# modules a parameter-server shard, master or elastic worker process
# loads: numpy and the standard library only at import (torch inside
# functions, where a trainer-side helper needs it)
TORCH_FREE = ("distributed/__init__.py", "distributed/param_server.py",
              "distributed/master.py", "distributed/launch.py",
              "distributed/rpc.py", "distributed/fault.py",
              "testing/elastic.py", "core/flags.py", "core/profiler.py",
              "obs/metrics.py", "obs/recorder.py")


def _module_level_imports(path):
    """Imports outside any function body."""
    tree = ast.parse(path.read_text(), str(path))
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    inner = {id(m) for f in funcs for m in ast.walk(f)}
    for node in ast.walk(tree):
        if id(node) in inner:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_distributed_modules_are_checked_and_import_no_torch():
    """The parameter server, master, launcher and transpiler are among the
    files the import check reads, and what a shard process loads imports
    no torch at module level (launch.py starts shards without the
    package's __init__)."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "paddle_tpu_torch/fluid/distribute_transpiler.py" in checked
    for name in TORCH_FREE:
        path = REPO / "paddle_tpu_torch" / name
        assert "paddle_tpu_torch/" + name in checked, name
        bad = [m for m in _module_level_imports(path)
               if m.split(".")[0] == "torch"]
        assert not bad, f"{name} imports {bad} at module level"


def test_kernel_tier_has_no_silent_fallback():
    """No try statement anywhere in ops/cuda/: a failed build or launch
    reaches the caller."""
    for path in sorted((REPO / "paddle_tpu_torch" / "ops" / "cuda")
                       .glob("*.py")):
        tries = [n.lineno for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Try)]
        assert not tries, f"{path.name} has try at lines {tries}"



def test_every_kernel_source_is_bound_built_and_checked():
    """Each csrc/*.cu is named by a wrapper module under ops/cuda/ (which
    loads it through build.load) and is in chip_smoke.py's build list, so
    the card-side run builds and checks every kernel the port has:
    conv_affine, conv_bn_train, conv_bn_bwd, optimizer_arena (SGD,
    momentum and Adam), lstm_seq and gru_seq (forward and backward), ctc
    (the alpha recurrence and its backward), embedding_sgd and
    paged_attention."""
    sources = sorted(p.stem for p in
                     (REPO / "paddle_tpu_torch" / "csrc").glob("*.cu"))
    assert sources == ["conv_affine", "conv_bn_bwd", "conv_bn_train", "ctc",
                       "embedding_sgd", "gru_seq", "lstm_seq",
                       "optimizer_arena", "paged_attention"]
    wrappers = "\n".join(
        p.read_text() for p in
        (REPO / "paddle_tpu_torch" / "ops" / "cuda").glob("*.py"))
    smoke = ast.parse((REPO / "chip_smoke.py").read_text())
    kernels = next(ast.literal_eval(n.value) for n in smoke.body
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "KERNELS")
    for name in sources:
        assert f'"{name}"' in wrappers, name
        assert name in kernels, name


_IMPORT_PROBE = r"""
import sys
before = set(sys.modules)
sys.path.insert(0, sys.argv[1])
import importlib
for name in sys.argv[2:]:
    importlib.import_module(name)
new = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(",".join(new))
"""


@pytest.mark.parametrize("module", ["paddle_tpu_torch.serving",
                                    "paddle_tpu_torch.distributed.rpc",
                                    "paddle_tpu_torch.distributed",
                                    "paddle_tpu_torch.obs",
                                    "paddle_tpu_torch.fluid.nets",
                                    "paddle_tpu_torch.fluid.evaluator",
                                    "paddle_tpu_torch.reader",
                                    "paddle_tpu_torch.recordio",
                                    "paddle_tpu_torch.dataset",
                                    "paddle_tpu_torch.fluid.recordio_writer",
                                    "paddle_tpu_torch.v2",
                                    "paddle_tpu_torch.v2.trainer_cli",
                                    "paddle_tpu_torch.trainer",
                                    "paddle_tpu_torch.trainer_config_helpers",
                                    "paddle_tpu_torch.utils"])
def test_import_loads_neither_jax_nor_the_reference(module):
    """Imported in a fresh interpreter, the serving front door, the
    distributed services (RPC, parameter server, master, launcher), the
    observability plane, the composite nets, the
    evaluators, the input pipeline (readers, recordio, the datasets,
    fluid.recordio_writer) and the legacy surfaces (v2, paddle_trainer,
    the provider protocol, the config helpers, utils) load no module of
    jax or of the reference package."""
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c", _IMPORT_PROBE, str(REPO),
                        module], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "", f"{module} loaded {r.stdout.strip()}"


_CONFIG_PROBE = r"""
import sys
before = set(sys.modules)
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch.v2.config_helpers import parse_config
topo, main, startup = parse_config(sys.argv[2])
assert topo.feed_order == ["data", "label"], topo.feed_order
new = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(",".join(new))
"""


@pytest.mark.parametrize("spelling", ["paddle", "paddle_tpu"])
def test_parsed_config_loads_neither_jax_nor_the_reference(spelling):
    """A config that imports ``paddle.trainer_config_helpers`` or the JAX
    package's ``paddle_tpu.trainer_config_helpers`` (the AST check cannot
    see into the string parse_config executes) parses in a fresh
    interpreter through the port alone: neither jax nor paddle_tpu enters
    sys.modules."""
    import subprocess
    import sys
    config = (f"from {spelling}.trainer_config_helpers import *\n"
              f"import {spelling}.trainer_config_helpers as tch\n"
              "settings(batch_size=8, learning_rate=0.05,\n"
              "         learning_method=tch.MomentumOptimizer(0.9))\n"
              "net = data_layer('data', size=12)\n"
              "net = fc_layer(input=net, size=4, act=SoftmaxActivation())\n"
              "outputs(classification_cost(input=net,\n"
              "                            label=data_layer('label', 4)))\n")
    r = subprocess.run([sys.executable, "-c", _CONFIG_PROBE, str(REPO),
                        config], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "", f"the config loaded {r.stdout.strip()}"


def test_fleet_and_perf_plane_modules_are_checked():
    """The serving fleet (registry, router, fleet, autoscaler, the warm-
    executable cache, the KV spill tier), the kernel autotuner and the
    perf plane are among the files the import check reads."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for name in ("serving/registry.py", "serving/router.py",
                 "serving/fleet.py", "serving/autoscale.py",
                 "serving/execcache.py", "serving/generate/kvstore.py",
                 "ops/autotune.py", "obs/perf.py"):
        assert "paddle_tpu_torch/" + name in checked, name
