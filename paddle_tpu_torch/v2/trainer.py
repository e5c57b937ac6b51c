"""The v2 SGD trainer event loop over a fluid Program (counterpart of
paddle_tpu/v2/trainer.py).

Reference: python/paddle/v2/trainer.py:137-215. Per pass: BeginPass; per
batch: BeginIteration, feed, forward-backward and update, EndIteration
(with the cost and the batch's metrics); EndPass (with the pass's
averages); and ``test(reader)`` gives a TestResult. The gradient machine
and the parameter updater are one ``Executor.run`` of the program;
metrics are (name, Variable) pairs fetched each batch, averaged each pass.

The trainer runs on ``place``: the card (``CUDAPlace(0)``) unless the
caller passes ``fluid.CPUPlace()`` or called ``paddle.init(use_gpu=False)``
first.
"""

from __future__ import annotations

import numpy as np

from . import event as v2_event


def default_event_handler(evt):
    pass


class SGD:
    """v2-compatible trainer (reference v2/trainer.py SGD):

        trainer = paddle_tpu_torch.v2.SGD(cost=avg_cost,
                                          optimizer=fluid.optimizer.Adam(1e-3),
                                          feed_order=["img", "label"],
                                          metrics={"acc": acc_var})
        trainer.train(reader=paddle_batch_reader, num_passes=2,
                      event_handler=handler)

    ``cost`` lives in the current default main/startup programs (built with
    fluid.layers under program_guard, the fluid topology replacing the v2
    layer DSL); ``feed_order`` maps reader tuple positions to data-var
    names (the reference's ``feeding``).
    """

    def __init__(self, cost, optimizer=None, feed_order=None, metrics=None,
                 place=None, main_program=None, startup_program=None,
                 parameters=None, update_equation=None):
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.fluid.framework import (default_main_program,
                                                default_startup_program)
        from .config_helpers import LayerOutput, _DATA_LAYERS
        from .inference import default_place

        # v2 calling form: SGD(cost=layer_out, parameters=...,
        # update_equation=paddle.v2.optimizer.Momentum(...)) — reference
        # v2/trainer.py:48. `parameters` (paddle.parameters.create) is
        # accepted for API parity; fluid startup initialization owns the
        # actual parameter creation.
        if isinstance(cost, LayerOutput):
            cost = cost.var
        if update_equation is not None and optimizer is None:
            optimizer = update_equation.to_fluid() \
                if hasattr(update_equation, "to_fluid") else update_equation
        if optimizer is None:
            raise ValueError("SGD needs optimizer= or update_equation=")

        self._cost = cost
        self._main = main_program or default_main_program()
        self._startup = startup_program or default_startup_program()
        if feed_order is None:
            # default to the v2 data layers declared IN THIS PROGRAM, in
            # declaration order (the reference derives feeding from the
            # topology's data layers, v2/trainer.py data_feeder setup)
            block = self._main.global_block()
            feed_order = list(dict.fromkeys(
                d.name for d in _DATA_LAYERS
                if not d.is_pending and block.has_var(d.name)))
            if not feed_order:
                raise ValueError(
                    "feed_order not given and no v2 data layers declared")
        self._feed_order = list(feed_order)
        self._metrics = dict(metrics or {})
        self._exe = fluid.Executor(default_place(place))
        self._scope = fluid.Scope()
        # test program: forward-only clone, taken BEFORE minimize appends
        # backward + optimizer ops — the reference's forwardTest never
        # updates parameters (cloning after would make test() train!)
        self._test_program = self._main.clone(for_test=True)
        optimizer.minimize(cost, self._startup)
        self._exe.run(self._startup, scope=self._scope)
        if parameters is not None:
            # pre-trained values (Parameters.from_tar in a fresh process)
            # seed the trainer's freshly-initialized scope first
            if parameters._scope is not None \
                    and parameters._scope is not self._scope:
                for name in list(parameters._scope._vars):
                    if self._scope.has_var(name):
                        self._scope.set(name, parameters._scope.find_var(
                            name).to(self._exe.device, copy=True))
            # bind the v2 Parameters view (paddle.parameters.create) to this
            # trainer's scope so paddle.infer(parameters=...) and
            # parameters.to_tar see the trained values — the reference's
            # Parameters wraps the same GradientMachine the trainer updates
            parameters._bind(self._scope)
            if parameters._program is None:
                parameters._program = self._main

    @property
    def scope(self):
        return self._scope

    def _feed(self, data_batch):
        from .inference import build_feed
        return build_feed(self._main.global_block(), self._feed_order,
                          data_batch)

    def _run(self, program, data_batch):
        fetch = [self._cost] + list(self._metrics.values())
        vals = self._exe.run(program, feed=self._feed(data_batch),
                             fetch_list=fetch, scope=self._scope)
        cost = float(np.asarray(vals[0]))
        metrics = {n: np.asarray(v)
                   for n, v in zip(self._metrics, vals[1:])}
        return cost, metrics

    def train(self, reader, num_passes=1, event_handler=None):
        event_handler = event_handler or default_event_handler
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            pass_costs, pass_metrics = [], []
            for batch_id, data_batch in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                cost, metrics = self._run(self._main, data_batch)
                pass_costs.append(cost)
                pass_metrics.append(metrics)
                event_handler(v2_event.EndIteration(pass_id, batch_id, cost,
                                                    metrics))
            avg_metrics = {
                n: np.mean([m[n] for m in pass_metrics], axis=0)
                for n in self._metrics
            } if pass_metrics else {}
            avg_metrics["cost"] = float(np.mean(pass_costs)) \
                if pass_costs else float("nan")
            event_handler(v2_event.EndPass(pass_id, avg_metrics))

    def test(self, reader):
        """Forward-only evaluation over a reader (reference SGD.test)."""
        costs, metrics_list, sizes = [], [], []
        for data_batch in reader():
            cost, metrics = self._run(self._test_program, data_batch)
            costs.append(cost)
            metrics_list.append(metrics)
            sizes.append(len(data_batch))
        total = max(sum(sizes), 1)
        cost = float(np.sum([c * s for c, s in zip(costs, sizes)]) / total)
        avg_metrics = {
            n: np.sum([m[n] * s for m, s in zip(metrics_list, sizes)],
                      axis=0) / total
            for n in self._metrics
        } if metrics_list else {}
        return v2_event.TestResult(cost, avg_metrics)

    def save_parameter_to_tar(self, f):
        """v2 parameters.to_tar capability: the trained parameters through
        ``fluid.io.save_params``, one tar member a file (``.npy`` files and
        MANIFEST.json, the JAX package's layout)."""
        import paddle_tpu_torch.fluid as fluid
        import tarfile
        import tempfile
        import os
        import shutil

        d = tempfile.mkdtemp()
        try:
            fluid.io.save_params(self._exe, d, self._main, scope=self._scope)
            with tarfile.open(fileobj=f, mode="w") as tf:
                for name in sorted(os.listdir(d)):
                    tf.add(os.path.join(d, name), arcname=name)
        finally:
            shutil.rmtree(d, ignore_errors=True)
