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
                                "decode_arena.py")]


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
                                    "paddle_tpu_torch.obs"])
def test_import_loads_neither_jax_nor_the_reference(module):
    """Imported in a fresh interpreter, the serving front door, the RPC
    transport and the observability plane load no module of jax or of the
    reference package."""
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c", _IMPORT_PROBE, str(REPO),
                        module], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "", f"{module} loaded {r.stdout.strip()}"
