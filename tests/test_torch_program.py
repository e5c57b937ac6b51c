"""The port's front end, IR and bundle format against the reference's.

A narrow ResNet (stage depths 1,1,1,1, base width 8, 32x32 images) built by
each package's front end must give the same program after fuse_conv_bn and
inference pruning. A bundle saved by either package must load in the other
with the same program and parameters and give the same answers, and
``scope_from_numpy`` must carry the reference scope's parameters across.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import io as jio
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.testing.models import resnet

# float32 end to end through 17 convs; the packages order conv sums
# differently (XLA vs oneDNN), which moves outputs by float32 roundings
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_port():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tframework.reset_unique_name()
    tfluid.set_flags({"kernel_tier": "auto"})
    yield


def _build(fluid):
    """Narrow ResNet with a softmax fetch, fused, in ``fluid``'s package."""
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[32, 32, 3])
        prob = fluid.layers.softmax(resnet(img, 10, counts=(1, 1, 1, 1),
                                           base=8, layers=fluid.layers))
    assert fluid.fuse_conv_bn(main) == 17
    return main, startup, prob


def _feed(n=3, seed=0):
    return {"img": np.random.RandomState(seed).normal(
        0, 1, (n, 32, 32, 3)).astype("float32")}


def test_front_ends_build_the_same_program():
    jmain, jstart, jprob = _build(jfluid)
    tmain, tstart, tprob = _build(tfluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert tstart.to_dict() == jstart.to_dict()
    jpruned = jio._prune_program(jmain, ["img"], [jprob.name])
    tpruned = tio._prune_program(tmain, ["img"], [tprob.name])
    assert tpruned.to_dict() == jpruned.to_dict()
    assert {n: v.shape for n, v in tpruned.global_block().vars.items()} == \
        {n: v.shape for n, v in jpruned.global_block().vars.items()}
    assert all(op.attrs.get("is_test", True)
               for op in tpruned.global_block().ops)


def _jax_bundle(tmp_path):
    main, startup, prob = _build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "jax_bundle")
    jio.save_inference_model(d, ["img"], [prob], exe, main_program=main,
                             scope=scope)
    return d, main, scope


def _params(program, scope):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in program.global_block().vars.values()
            if v.persistable and not v.is_data}


def test_reference_bundle_loads_in_port(tmp_path):
    d, _, _ = _jax_bundle(tmp_path)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jprog, jfeeds, jfetch = jio.load_inference_model(d, jexe, scope=jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    tprog, tfeeds, tfetch = tio.load_inference_model(d, texe, scope=tscope)
    assert tprog.to_dict() == jprog.to_dict()
    assert tfeeds == jfeeds and [v.name for v in tfetch] == \
        [v.name for v in jfetch]
    jp = _params(jprog, jscope)
    for name, arr in jp.items():
        t = tscope.find_var(name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), arr)
    feed = _feed()
    want, = jexe.run(jprog, feed=feed, fetch_list=jfetch, scope=jscope)
    got, = texe.run(tprog, feed=feed, fetch_list=tfetch, scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_port_bundle_loads_in_reference(tmp_path):
    main, startup, prob = _build(tfluid)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(startup, scope=tscope)
    d = str(tmp_path / "port_bundle")
    tio.save_inference_model(d, ["img"], [prob], texe, main_program=main,
                             scope=tscope)
    # the reference loads it, including its program verifier
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jprog, _, jfetch = jio.load_inference_model(d, jexe, scope=jscope)
    tprog, _, tfetch = tio.load_inference_model(d, texe,
                                                scope=tfluid.Scope())
    assert jprog.to_dict() == tprog.to_dict()
    for name, arr in _params(jprog, jscope).items():
        np.testing.assert_array_equal(arr, tscope.find_var(name).numpy())
    feed = _feed(seed=1)
    want, = jexe.run(jprog, feed=feed, fetch_list=jfetch, scope=jscope)
    got, = texe.run(tprog, feed=feed, fetch_list=tfetch, scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_scope_from_numpy_carries_parameters(tmp_path):
    """The reference scope's persistables, as numpy, run the port's own
    build of the same network to the reference's answers."""
    _, jmain, jscope = _jax_bundle(tmp_path)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n, v in jmain.global_block().vars.items()
              if v.persistable and not v.is_data}
    tmain, _, tprob = _build(tfluid)
    tscope = tio.scope_from_numpy(arrays, "cpu")
    assert sorted(tscope.local_names()) == sorted(arrays)
    tprog = tio._prune_program(tmain, ["img"], [tprob.name])
    feed = _feed(n=2, seed=2)
    jprog = jio._prune_program(jmain, ["img"], [tprob.name])
    want, = jfluid.Executor(jfluid.CPUPlace()).run(
        jprog, feed=feed, fetch_list=[tprob.name], scope=jscope)
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tprog, feed=feed, fetch_list=[tprob.name], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_load_rejects_missing_and_corrupt_bundles(tmp_path):
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(ValueError, match="not a saved inference model"):
        tio.load_inference_model(str(tmp_path / "nope"), exe)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "__model__").write_text("{not json")
    with pytest.raises(ValueError, match="corrupt"):
        tio.load_inference_model(str(bad), exe)


def test_torn_bundle_raises(tmp_path):
    d, _, _ = _jax_bundle(tmp_path)
    victim = next(p for p in (tmp_path / "jax_bundle").iterdir()
                  if p.suffix == ".npy")
    victim.unlink()
    with pytest.raises(RuntimeError, match="torn"):
        tio.load_inference_model(d, tfluid.Executor(tfluid.CPUPlace()),
                                 scope=tfluid.Scope())
