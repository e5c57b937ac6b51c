"""The port's C inference API (paddle_tpu_torch/capi) against the
reference's (paddle_tpu/capi), on the CPU: each package's three C examples
(dense, sequence, multi_thread) built with gcc against an embedded CPython
(``python3-config --embed``), run on each package's artifact of the same
weights; the printed outputs agree within 1e-5 (the examples print six
decimals)."""

import os
import shutil
import subprocess

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import aot as jaot
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import aot as taot

from torch_cross import build_both, port_scope, ref_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI = {"ref": os.path.join(REPO, "paddle_tpu", "capi"),
        "port": os.path.join(REPO, "paddle_tpu_torch", "capi")}
EXAMPLES = {"dense": "dense_infer", "sequence": "seq_infer",
            "multi_thread": "multi_thread_infer"}
C_TOL = 1e-5


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """{(package, example): binary}, each built with gcc as the Makefiles
    build them."""
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    out = tmp_path_factory.mktemp("capi")
    cflags = subprocess.check_output(["python3-config", "--includes"],
                                     text=True).split()
    ldflags = subprocess.check_output(["python3-config", "--embed",
                                       "--ldflags"], text=True).split()
    bins = {}
    for pkg, capi in CAPI.items():
        for ex, name in EXAMPLES.items():
            path = str(out / f"{pkg}_{name}")
            r = subprocess.run(
                ["gcc", "-O1", "-o", path,
                 os.path.join(capi, "examples", "model_inference", ex,
                              "main.c"),
                 os.path.join(capi, "paddle_tpu_capi.c")]
                + cflags + ldflags + ["-lpthread"],
                capture_output=True, text=True)
            assert r.returncode == 0, r.stderr
            bins[pkg, ex] = path
    return bins


def _export_both(tmp_path, build, feed):
    """The model in both packages from the reference's startup state, one
    artifact each: {package: directory}."""
    progs = build_both(build)
    jmain, jstartup, jprobs = progs["ref"]
    jexe, jscope, state = ref_state(jmain, jstartup, mode="eager")
    tmain, _, tprobs = progs["port"]
    dirs = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    jaot.export_inference_artifact(dirs["ref"], [feed], [jprobs], jexe,
                                   main_program=jmain, scope=jscope)
    taot.export_inference_artifact(dirs["port"], [feed], [tprobs],
                                   tfluid.Executor(tfluid.CPUPlace()),
                                   main_program=tmain,
                                   scope=port_scope(state))
    return dirs


def _run_both(binaries, example, dirs, *argv):
    """Both packages' binaries at once on their artifacts: {package:
    stdout}."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = {pkg: subprocess.Popen([binaries[pkg, example], dirs[pkg],
                                    *argv], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for pkg in CAPI}
    out = {}
    for pkg, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, (pkg, stdout, stderr[-3000:])
        out[pkg] = stdout
    return out


def _floats(line):
    return [float(v) for v in line.split(":")[1].split("(")[0].split()]


def _mlp(fluid):
    """tests/test_capi_aot.py's small model, inference only: 8 -> 16 relu
    -> 4 softmax."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        probs = fluid.layers.fc(fluid.layers.fc(x, 16, act="relu"), 4,
                                act="softmax")
    return main, startup, probs


def _seq_pool(fluid):
    """tests/test_capi_aot.py's sequence model: embedding(20, 8) ->
    average pool -> 3-way softmax."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(words, size=(20, 8))
        pooled = fluid.layers.sequence_pool(emb, pool_type="average")
        probs = fluid.layers.fc(pooled, 3, act="softmax")
    return main, startup, probs


def test_dense_example_matches_the_reference(binaries, tmp_path):
    dirs = _export_both(tmp_path, _mlp, "x")
    out = _run_both(binaries, "dense", dirs, "8")
    rows = {}
    for pkg, text in out.items():
        assert "DENSE_INFER_OK" in text, text
        lines = text.splitlines()
        i = next(k for k, ln in enumerate(lines) if ln.startswith("prob:"))
        rows[pkg] = np.array([float(v) for v in lines[i + 1].split()])
        total = [ln for ln in lines if ln.startswith("sum:")][0]
        assert abs(float(total.split()[1]) - 1.0) < 1e-4, text
    assert rows["port"].shape == (4,)
    np.testing.assert_allclose(rows["port"], rows["ref"], atol=C_TOL)


def test_sequence_example_matches_the_reference(binaries, tmp_path):
    dirs = _export_both(tmp_path, _seq_pool, "words")
    out = _run_both(binaries, "sequence", dirs)
    rows = {}
    for pkg, text in out.items():
        assert "SEQ_INFER_OK" in text, text
        rows[pkg] = np.array([_floats(ln) for ln in text.splitlines()
                              if ln.startswith("seq ")])
    assert rows["port"].shape == (3, 3)
    np.testing.assert_allclose(rows["port"], rows["ref"], atol=C_TOL)
    # and the in-process run of the port's artifact on the same sequences
    seqs = [np.array(s, "int64").reshape(-1, 1)
            for s in ([1, 2, 3, 4], [5, 6], [7, 8, 9])]
    want = taot.load_inference_artifact(dirs["port"]).run({"words": seqs})[0]
    np.testing.assert_allclose(rows["port"], want, atol=C_TOL)


def test_multi_thread_example_matches_the_reference(binaries, tmp_path):
    """4 threads on one loaded model, 3 runs each: every thread ok, and
    each thread's first probability the reference's."""
    dirs = _export_both(tmp_path, _mlp, "x")
    out = _run_both(binaries, "multi_thread", dirs, "8")
    first = {}
    for pkg, text in out.items():
        assert "MULTI_THREAD_INFER_OK" in text, text
        oks = [ln for ln in text.splitlines() if "ok=1" in ln]
        assert len(oks) == 4, text
        first[pkg] = np.array([float(ln.split("probs[0]=")[1])
                               for ln in sorted(oks)])
    np.testing.assert_allclose(first["port"], first["ref"], atol=C_TOL)


def test_the_port_capi_loads_the_port_only():
    """The port's C layer imports paddle_tpu_torch.fluid.aot, forces no
    platform, and names neither jax nor the reference package."""
    src = open(os.path.join(CAPI["port"], "paddle_tpu_capi.c")).read()
    assert 'PyImport_ImportModule("paddle_tpu_torch.fluid.aot")' in src
    imports = [ln for ln in src.splitlines() if "PyImport_ImportModule" in ln
               or "PyRun_SimpleString" in ln]
    assert not any("jax" in ln or '"paddle_tpu.' in ln for ln in imports)
    assert "JAX_PLATFORMS" not in src
    header = open(os.path.join(CAPI["port"], "paddle_tpu_capi.h")).read()
    ref_header = open(os.path.join(CAPI["ref"], "paddle_tpu_capi.h")).read()

    def decls(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("pd_tpu_error", "typedef", "  PD_TPU_",
                                  "                              ",
                                  "                                  "))]
    assert decls(header) == decls(ref_header)
