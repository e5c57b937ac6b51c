"""The port's ``fluid.DistributeTranspiler``: the counterparts of
tests/test_distribute_transpiler.py, case by case. Each structural case
transpiles the same program with both packages and holds the port's
trainer program, placement, lifted rule and sparse marks to the
reference's; the end-to-end case trains through two pserver shards with
the port's Executor and holds its first losses to the reference's
transpiled run from the same startup state. Beyond the reference, a
program built with ``fused=True`` transpiles to the same trainer and
pserver programs as its per-parameter form.
"""

import socket

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.distributed import install_params

from torch_cross import build_both, ref_state, port_scope

# the port's losses against the reference's through the same transpiled
# pservers, from the same startup state
CROSS_RTOL = 1e-5


def _free_endpoints(n):
    eps, socks = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        eps.append(f"127.0.0.1:{s.getsockname()[1]}")
    for s in socks:
        s.close()
    return eps


def _build(fluid, opt, fused=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6])
        y = fluid.layers.data("y", shape=[1])
        h = fluid.layers.fc(input=x, size=8, act="relu",
                            param_attr=fluid.ParamAttr(name="w0"),
                            bias_attr=fluid.ParamAttr(name="b0"))
        pred = fluid.layers.fc(input=h, size=1, act=None,
                               param_attr=fluid.ParamAttr(name="w1"),
                               bias_attr=fluid.ParamAttr(name="b1"))
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        kw = {"fused": True} if fused else {}
        {"momentum": lambda: fluid.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9, **kw),
         "adam": lambda: fluid.optimizer.Adam(learning_rate=0.01, **kw),
         "sgd": lambda: fluid.optimizer.SGD(learning_rate=0.1, **kw),
         }[opt]().minimize(loss, startup)
    return main, startup, loss


def _transpile(fluid, main, startup, eps, trainers=1):
    t = fluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers=",".join(eps), trainers=trainers,
                startup_program=startup)
    return t


def _op_types(program):
    return [op.type for op in program.global_block().ops]


def test_transpile_strips_optimize_ops_and_places_params():
    both = build_both(lambda f: _build(f, "momentum"))
    eps = ["127.0.0.1:6174", "127.0.0.1:6175"]
    ts = {k: _transpile(f, *both[k][:2], eps, trainers=2)
          for k, f in (("ref", jfluid), ("port", tfluid))}
    t, main = ts["port"], both["port"][0]
    trainer = t.get_trainer_program()
    ttypes = _op_types(trainer)
    assert "momentum" not in ttypes
    assert any("@GRAD" in n for op in trainer.global_block().ops
               for n in op.output_arg_names())
    assert "momentum" in _op_types(main)        # the original is untouched
    assert ttypes == _op_types(ts["ref"].get_trainer_program())
    p0, p1 = (t.get_pserver_program(e) for e in eps)
    assert sorted(p0.param_names + p1.param_names) == ["b0", "b1", "w0",
                                                       "w1"]
    assert not set(p0.param_names) & set(p1.param_names)
    assert p0.optimizer == "momentum"
    assert p0.opt_kwargs["mu"] == 0.9
    assert abs(p0.opt_kwargs["lr"] - 0.05) < 1e-9
    assert p0.mode == "sync" and p0.fan_in == 2
    for e in eps:
        r, p = ts["ref"].get_pserver_program(e), t.get_pserver_program(e)
        assert (p.param_names, p.optimizer, p.opt_kwargs, p.mode,
                p.fan_in) == (r.param_names, r.optimizer, r.opt_kwargs,
                              r.mode, r.fan_in)


def test_adam_accumulator_updates_are_stripped():
    both = build_both(lambda f: _build(f, "adam"))
    ts = {k: _transpile(f, *both[k][:2], ["127.0.0.1:6200"])
          for k, f in (("ref", jfluid), ("port", tfluid))}
    trainer = ts["port"].get_trainer_program()
    assert "adam" not in _op_types(trainer)
    for op in trainer.global_block().ops:
        for n in op.output_arg_names():
            assert "beta1_pow" not in n and "beta2_pow" not in n, op
    assert _op_types(trainer) == _op_types(ts["ref"].get_trainer_program())
    assert ts["port"].opt_kwargs == ts["ref"].opt_kwargs


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_fused_program_transpiles_like_its_per_parameter_form(opt):
    """A fused_* optimize op lifts the same rule over the same parameters,
    and its trainer program is the per-parameter form's."""
    eps = ["127.0.0.1:6250", "127.0.0.1:6251"]
    out = {}
    for fused in (False, True):
        tfluid.framework.reset_unique_name()
        main, startup, _ = _build(tfluid, opt, fused=fused)
        t = _transpile(tfluid, main, startup, eps)
        out[fused] = (t, _op_types(t.get_trainer_program()))
    (t0, ops0), (t1, ops1) = out[False], out[True]
    assert not any(o.startswith("fused_") for o in ops1)
    assert ops0 == ops1
    assert sorted(t0.params_grads) == sorted(t1.params_grads)
    assert (t0.optimizer, t0.opt_kwargs) == (t1.optimizer, t1.opt_kwargs)
    for e in eps:
        assert t0.get_pserver_program(e).param_names == \
            t1.get_pserver_program(e).param_names


def test_pserver_startup_program_covers_only_its_shard():
    main, startup, _ = _build(tfluid, "sgd")
    eps = ["127.0.0.1:6300", "127.0.0.1:6301"]
    t = _transpile(tfluid, main, startup, eps)
    for ep in eps:
        spec = t.get_pserver_program(ep)
        sprog = t.get_startup_program(ep, spec)
        produced = {n for op in sprog.global_block().ops
                    for n in op.output_arg_names()}
        assert set(spec.param_names) <= produced
        other = {p for e2 in eps if e2 != ep
                 for p in t.get_pserver_program(e2).param_names}
        assert not (other & produced)


def _train_transpiled(t, loss, scope, exe, steps, put):
    """``steps`` steps through ``t``'s pservers (served in threads) from
    ``scope``; ``put(scope, pulled)`` installs a pull. Returns the
    losses."""
    servers = [t.get_pserver_program(ep) for ep in t.endpoints]
    for s in servers:
        s.serve_in_thread()
    try:
        client = t.trainer_client()
        client.init_params({p: np.asarray(_host(scope.find_var(p)))
                            for p, _ in t.params_grads})
        trainer_prog = t.get_trainer_program()
        rng = np.random.RandomState(2)
        w_true = rng.normal(0, 1, (6, 1)).astype("float32")
        losses = []
        for _ in range(steps):
            put(scope, client.pull())
            X = rng.normal(0, 1, (32, 6)).astype("float32")
            out = exe.run(trainer_prog, feed={"x": X, "y": X @ w_true},
                          fetch_list=[loss] + [g for _, g in t.params_grads],
                          scope=scope)
            client.push({p: v for (p, _), v in zip(t.params_grads,
                                                   out[1:])})
            losses.append(float(np.asarray(out[0])))
        client.close()
        return losses
    finally:
        for s in servers:
            s.shutdown()


def _host(v):
    return v.numpy() if hasattr(v, "numpy") and not isinstance(
        v, np.ndarray) else np.asarray(v)


def test_end_to_end_training_through_transpiled_pservers():
    """Two pserver shards serve momentum updates; the stripped trainer
    program + trainer_client() converge on a linear fit, every pull lands
    in the scope's tensors, and the first losses are the reference's
    through its own transpiled pservers from the same startup state."""
    import torch

    both = build_both(lambda f: _build(f, "momentum"))
    jmain, jstart, jloss = both["ref"]
    jexe, jscope, state = ref_state(jmain, jstart)
    tj = _transpile(jfluid, jmain, jstart, _free_endpoints(2))
    ref = _train_transpiled(
        tj, jloss, jscope, jexe, 5,
        lambda scope, pulled: [scope.set(n, v) for n, v in pulled.items()])

    main, startup, loss = both["port"]
    t = _transpile(tfluid, main, startup, _free_endpoints(2))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = port_scope(state)

    def put(scope, pulled):
        install_params(scope, pulled, device=exe.device)
        assert all(isinstance(scope.find_var(n), torch.Tensor)
                   for n in pulled)

    losses = _train_transpiled(t, loss, scope, exe, 80, put)
    np.testing.assert_allclose(losses[:5], ref, rtol=CROSS_RTOL)
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])


def test_transpile_requires_optimize_ops():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[3])
        tfluid.layers.fc(input=x, size=2, act=None)
    t = tfluid.DistributeTranspiler()
    with pytest.raises(ValueError, match="optimize ops"):
        t.transpile(0, program=main, pservers="127.0.0.1:1", trainers=1,
                    startup_program=startup)


def _sparse_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        y = fluid.layers.data("y", shape=[4])
        e = fluid.layers.embedding(ids, size=[12, 6], is_sparse=True)
        e2 = fluid.layers.embedding(ids, size=[12, 6], is_sparse=False)
        h = fluid.layers.elementwise_add(
            fluid.layers.reshape(e, [-1, 6]),
            fluid.layers.reshape(e2, [-1, 6]))
        pred = fluid.layers.fc(h, size=4, act=None)
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, y)))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    return main, startup


def test_transpiler_marks_sparse_embedding_params():
    """Params fed by an is_sparse lookup_table backward are marked sparse,
    and the mark lives with the shard that owns the param — as the
    reference marks them."""
    both = build_both(_sparse_program)
    main, startup = both["port"]
    lookup_sparse = [op for op in main.global_block().ops
                     if op.type == "lookup_table" and op.attr("is_sparse")]
    assert len(lookup_sparse) == 1
    sparse_w = lookup_sparse[0].input("W")[0]
    eps = ["127.0.0.1:6474", "127.0.0.1:6475"]
    t = _transpile(tfluid, main, startup, eps)
    assert t.sparse_param_names == [sparse_w]
    specs = [t.get_pserver_program(ep) for ep in eps]
    assert [n for s in specs for n in s.sparse_param_names] == [sparse_w]
    owner = [s for s in specs if sparse_w in s.param_names]
    assert len(owner) == 1 and owner[0].sparse_param_names == [sparse_w]
    tj = _transpile(jfluid, *both["ref"], eps)
    assert tj.sparse_param_names == t.sparse_param_names
    assert [tj.get_pserver_program(e).param_names for e in eps] == \
        [s.param_names for s in specs]
