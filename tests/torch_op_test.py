"""OpTest on the port: tests/op_test.py's per-op harness over
``paddle_tpu_torch.fluid`` (the reference's contract, op_test.py:212 of
the 2018 unittests). A test defines ``op_type``, ``inputs``, ``attrs`` and
numpy-computed ``outputs``; ``check_output`` builds a one-op program and
holds the executor's fetches against the numpy outputs; ``check_grad``
holds the gradients ``append_backward`` gives against central
differences, by the reference's relative-error rule (op_test.py:97
get_numeric_gradient, :378 check_grad).

The port's executor has one mode, the eager op loop, so each check runs
once where tests/op_test.py runs its eager and jit modes. ``place`` picks
the device: ``CPUPlace()`` by default, ``CUDAPlace(0)`` to run the same
class on the card (its kernels where the op reaches one). This module
imports nothing of JAX, so the card can load it beside the reference's
test classes that import only ``op_test``.

LoD inputs are ``(np_array, lod)`` tuples, as in the reference.
"""

from __future__ import annotations

import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.lod import LoDArray, lodarray_to_flat


def _as_np(v):
    if isinstance(v, tuple):
        return np.asarray(v[0])
    return np.asarray(v)


def host_flat(v):
    """A fetched value as numpy: a LoD value's flat data, else the array."""
    if isinstance(v, LoDArray):
        v = lodarray_to_flat(v)[0]
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        if str(v.dtype) == "torch.bfloat16":
            v = v.float()
        v = v.numpy()
    return np.asarray(v)


class OpTest:
    """Subclass-style harness; pytest test classes inherit and call
    check_output/check_grad from their test methods."""

    op_type: str = None
    inputs: dict = {}
    outputs: dict = {}
    attrs: dict = {}
    place = None          # CPUPlace() when None

    def _place(self):
        return self.place if self.place is not None else fluid.CPUPlace()

    # -- program construction ----------------------------------------------
    def _build(self, extra_loss=False):
        main = fluid.Program()
        startup = fluid.Program()
        with fluid.program_guard(main, startup):
            block = main.global_block()
            in_slots, feed = {}, {}
            for slot, value in self.inputs.items():
                entries = value if isinstance(value, list) else [(slot, value)]
                names = []
                for sub_name, sub_val in entries:
                    lod_level = 1 if isinstance(sub_val, tuple) else 0
                    arr = _as_np(sub_val)
                    block.create_var(name=sub_name, shape=arr.shape,
                                     dtype=str(arr.dtype), lod_level=lod_level,
                                     stop_gradient=False, is_data=True)
                    # a copy: a CPU feed shares the array's memory, and an op
                    # that writes its input in place must not touch the
                    # test's data
                    feed[sub_name] = ((arr.copy(), sub_val[1]) if lod_level
                                      else arr.copy())
                    names.append(sub_name)
                in_slots[slot] = names
            out_slots = {}
            for slot, value in self.outputs.items():
                entries = value if isinstance(value, list) else [(slot, value)]
                names = []
                for sub_name, sub_val in entries:
                    lod_level = 1 if isinstance(sub_val, tuple) else 0
                    block.create_var(name=sub_name, lod_level=lod_level)
                    names.append(sub_name)
                out_slots[slot] = names
            block.append_op(self.op_type, in_slots, out_slots,
                            dict(self.attrs))
        # every OpTest program goes through the structural verifier, as the
        # reference harness's do
        fluid.verify_program(main, feed_names=list(feed))
        return main, startup, feed

    def _out_entries(self):
        for slot, value in self.outputs.items():
            entries = value if isinstance(value, list) else [(slot, value)]
            for sub_name, sub_val in entries:
                yield slot, sub_name, sub_val

    def _run_outputs(self):
        """(fetch names, the port's fetches) of the one-op program."""
        main, _, feed = self._build()
        exe = fluid.Executor(self._place())
        names = [n for _, n, _ in self._out_entries()]
        return names, exe.run(main, feed=feed, fetch_list=names,
                              scope=fluid.Scope())

    # -- forward check -------------------------------------------------------
    def check_output(self, atol=1e-5, rtol=1e-4, no_check_set=None):
        names, results = self._run_outputs()
        for (slot, name, expect), got in zip(self._out_entries(), results):
            if no_check_set and name in no_check_set:
                continue
            if isinstance(got, LoDArray):
                got_flat, got_lod = lodarray_to_flat(got)
                got_flat = host_flat(got_flat)
                if isinstance(expect, tuple):
                    np.testing.assert_allclose(
                        got_flat, np.asarray(expect[0]), atol=atol,
                        rtol=rtol, err_msg=f"output {name} (lod)")
                    assert got_lod[0] == list(np.asarray(expect[1][0])), \
                        f"lod mismatch for {name}"
                    continue
                got = got_flat
            got = host_flat(got)
            np.testing.assert_allclose(
                np.asarray(got, dtype=np.float64),
                np.asarray(_as_np(expect), dtype=np.float64).reshape(
                    got.shape),
                atol=atol, rtol=rtol, err_msg=f"output {name}")
        return names, results

    # -- gradient check ------------------------------------------------------
    def _loss_value(self, outs, output_names):
        return sum(float(np.mean(np.asarray(o, dtype=np.float64)))
                   for n, o in outs.items() if n in output_names)

    def _forward_loss(self, exe, main, feed, output_names):
        results = exe.run(main, feed=feed, fetch_list=list(output_names),
                          scope=fluid.Scope())
        vals = {n: host_flat(r) for n, r in zip(output_names, results)}
        return self._loss_value(vals, output_names)

    def _analytic_grads(self, inputs_to_check, output_names):
        main, startup, feed = self._build()
        with fluid.program_guard(main, startup):
            block = main.global_block()
            means = [fluid.layers.mean(block.var(n)) for n in output_names]
            loss = means[0]
            for m in means[1:]:
                loss = loss + m
            fluid.append_backward(loss)
        exe = fluid.Executor(self._place())
        grad_names = [fluid.grad_var_name(n) for n in inputs_to_check]
        return [host_flat(a) for a in exe.run(main, feed=feed,
                                               fetch_list=grad_names,
                                               scope=fluid.Scope())]

    def _numeric_grads(self, inputs_to_check, output_names, delta):
        main_f, _, feed_f = self._build()
        exe_f = fluid.Executor(self._place())
        numeric = []
        for name in inputs_to_check:
            base = feed_f[name]
            if isinstance(base, tuple):
                arr = np.asarray(base[0]).copy()
                lod = base[1]

                def rebuild(a, lod=lod):
                    return (a.copy(), lod)
            else:
                arr = np.asarray(base).copy()

                def rebuild(a):
                    return a.copy()
            grad = np.zeros_like(arr, dtype=np.float64)
            flat = arr.reshape(-1)
            for i in range(flat.size):
                orig = flat[i]
                flat[i] = orig + delta
                feed_f[name] = rebuild(arr)
                lp = self._forward_loss(exe_f, main_f, feed_f, output_names)
                flat[i] = orig - delta
                feed_f[name] = rebuild(arr)
                lm = self._forward_loss(exe_f, main_f, feed_f, output_names)
                flat[i] = orig
                grad.reshape(-1)[i] = (lp - lm) / (2 * delta)
            feed_f[name] = rebuild(arr)
            numeric.append(grad)
        return numeric

    def check_grad(self, inputs_to_check, output_names,
                   max_relative_error=0.005, no_grad_set=None,
                   numeric_grad_delta=0.005, user_defined_grads=None):
        if isinstance(output_names, str):
            output_names = [output_names]
        analytic = self._analytic_grads(inputs_to_check, output_names)
        if user_defined_grads is not None:
            numeric = [np.asarray(g) for g in user_defined_grads]
        else:
            numeric = self._numeric_grads(inputs_to_check, output_names,
                                          numeric_grad_delta)
        # the reference's __assert_is_close: |a - n| / max(|a|, 1e-3)
        for name, a, n in zip(inputs_to_check, analytic, numeric):
            a = np.asarray(a, dtype=np.float64).reshape(n.shape)
            abs_a = np.maximum(np.abs(a), 1e-3)
            diff = np.abs(a - n) / abs_a
            max_diff = diff.max() if diff.size else 0.0
            assert max_diff <= max_relative_error, (
                f"gradient mismatch for input {name}: max relative error "
                f"{max_diff:.6f} > {max_relative_error} "
                f"(analytic={a.reshape(-1)[:5]}, numeric={n.reshape(-1)[:5]})")
        return analytic
