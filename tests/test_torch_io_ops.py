"""The port's persistence and runtime io ops (paddle_tpu_torch/ops/io_ops.py:
fill, delete_var, save, load, save_combine, load_combine,
lod_array_length) against the reference's (paddle_tpu/ops/io_ops.py),
each as a one-op program of both packages on the CPU
(``tests/torch_cross.py``); and a file that either package saves, loaded
by the other: a dense tensor, a LoD tensor, and a combined file of several
tensors (two of one shape) in order."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

from torch_cross import build_both, host, op_both, run_op

PACKAGES = {"ref": jfluid, "port": tfluid}


def test_fill():
    data = np.arange(6, dtype="float32") * 0.5 - 1
    op_both("fill", {}, {"Out": ["out"]},
            {"dtype": "float32", "shape": [2, 3], "data": data.tolist()}, {})
    got, = op_both("fill", {}, {"Out": ["out"]},
                   {"dtype": "int64", "shape": [3], "data": [4, -1, 7]}, {})
    np.testing.assert_array_equal(got, [4, -1, 7])


def test_delete_var_drops_the_variable():
    """A fetch of a deleted variable fails in both packages; the rest of
    the run is untouched."""
    x = np.random.RandomState(0).normal(0, 1, (3, 4)).astype("float32")
    for fluid in PACKAGES.values():
        prog = fluid.Program()
        block = prog.global_block()
        block.create_var(name="x", shape=(3, 4), dtype="float32")
        for n in ("y", "z"):
            block.create_var(name=n, shape=(3, 4), dtype="float32")
        block.append_op("relu", {"X": ["x"]}, {"Out": ["y"]})
        block.append_op("scale", {"X": ["y"]}, {"Out": ["z"]},
                        {"scale": 2.0})
        block.append_op("delete_var", {"X": ["y"]}, {})
        exe = jfluid.Executor(jfluid.CPUPlace(), mode="eager") \
            if fluid is jfluid else fluid.Executor(fluid.CPUPlace())
        z, = exe.run(prog, feed={"x": x}, fetch_list=["z"],
                     scope=fluid.Scope())
        np.testing.assert_array_equal(np.asarray(z),
                                      2 * np.maximum(x, 0))
        with pytest.raises(Exception):
            exe.run(prog, feed={"x": x}, fetch_list=["y"],
                    scope=fluid.Scope())


def _save(pkg, path, name, value, lod=False, op="save"):
    run_op(PACKAGES[pkg], op, {"X": [name]}, {},
           {"file_path": str(path)}, {name: value},
           lod=(name,) if lod else ())


def _load(pkg, path, names, op="load", dtype="float32"):
    """``op`` into ``names`` in ``pkg``; the outputs as ``host`` gives
    them."""
    prog = PACKAGES[pkg].Program()
    block = prog.global_block()
    for n in names:
        block.create_var(name=n, dtype=dtype)
    block.append_op(op, {}, {"Out": list(names)}, {"file_path": str(path)})
    fluid = PACKAGES[pkg]
    exe = jfluid.Executor(jfluid.CPUPlace(), mode="eager") \
        if fluid is jfluid else fluid.Executor(fluid.CPUPlace())
    return [host(v) for v in exe.run(prog, fetch_list=list(names),
                                     scope=fluid.Scope())]


@pytest.mark.parametrize("writer, reader", [("port", "ref"), ("ref", "port"),
                                            ("port", "port")])
def test_save_load_dense_across_packages(tmp_path, writer, reader):
    x = np.random.RandomState(1).normal(0, 1, (4, 5)).astype("float32")
    path = tmp_path / "x.npy"
    _save(writer, path, "x", x)
    got, = _load(reader, path, ["x"])
    np.testing.assert_array_equal(got, x)
    # the file is one np.save of the host array (the reference's format)
    np.testing.assert_array_equal(np.load(path, allow_pickle=True), x)


@pytest.mark.parametrize("writer, reader", [("port", "ref"), ("ref", "port")])
def test_save_load_lod_across_packages(tmp_path, writer, reader):
    """A LoD value travels as its {data, lens, outer} dict."""
    rng = np.random.RandomState(2)
    seqs = [rng.normal(0, 1, (n, 3)).astype("float32") for n in (2, 5, 1)]
    path = tmp_path / "s.npy"
    _save(writer, path, "s", seqs, lod=True)
    raw = np.load(path, allow_pickle=True).item()
    assert sorted(raw) == ["data", "lens", "outer"]
    np.testing.assert_array_equal(raw["lens"], [2, 5, 1])
    (flat, lod), = _load(reader, path, ["s"])
    np.testing.assert_array_equal(flat, np.concatenate(seqs))
    assert [list(level) for level in lod] == [[0, 2, 7, 8]]


def test_save_overwrite_false_refuses(tmp_path):
    x = np.ones((2, 2), "float32")
    path = tmp_path / "x.npy"
    for pkg in PACKAGES:
        _save(pkg, path, "x", x)
        with pytest.raises(Exception, match="overwrite"):
            run_op(PACKAGES[pkg], "save", {"X": ["x"]}, {},
                   {"file_path": str(path), "overwrite": False}, {"x": x})


@pytest.mark.parametrize("writer, reader", [("port", "ref"), ("ref", "port")])
def test_save_combine_keeps_order_across_packages(tmp_path, writer, reader):
    """Three tensors, the first two of one shape (they stay separate
    entries), in the order saved."""
    rng = np.random.RandomState(3)
    vals = {"a": rng.normal(0, 1, (2, 3)).astype("float32"),
            "b": rng.normal(0, 1, (2, 3)).astype("float32"),
            "c": rng.normal(0, 1, (4,)).astype("float32")}
    path = tmp_path / "combined"
    run_op(PACKAGES[writer], "save_combine", {"X": list(vals)}, {},
           {"file_path": str(path)}, vals)
    raw = np.load(path, allow_pickle=True)
    assert raw.dtype == object and raw.shape == (3,)
    got = _load(reader, path, ["a2", "b2", "c2"], op="load_combine")
    for g, want in zip(got, vals.values()):
        np.testing.assert_array_equal(g, want)


def test_lod_array_length():
    """A tensor array written at index 2 has length 3 (int64 [1])."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[4])
            i = fluid.layers.fill_constant(shape=[1], dtype="int64",
                                           value=2)
            arr = fluid.layers.array_write(x, i)
            block = main.global_block()
            out = block.create_var(name="n", dtype="int64")
            block.append_op("lod_array_length", {"X": [arr.name]},
                            {"Out": [out.name]})
        return main, startup
    progs = build_both(build)
    x = np.ones((2, 4), "float32")
    got = {}
    for pkg, fluid in PACKAGES.items():
        main, startup = progs[pkg]
        exe = jfluid.Executor(jfluid.CPUPlace(), mode="eager") \
            if fluid is jfluid else fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        got[pkg] = np.asarray(exe.run(main, feed={"x": x}, fetch_list=["n"],
                                      scope=scope)[0])
    assert got["port"].dtype == np.int64 and got["port"].shape == (1,)
    np.testing.assert_array_equal(got["port"], got["ref"])
    np.testing.assert_array_equal(got["port"], [3])
