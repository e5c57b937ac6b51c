"""Optimizers as op inserters (counterpart of paddle_tpu/fluid/optimizer.py
:24-169): ``minimize`` = ``append_backward`` + update ops appended to the
same program, with persistable accumulators initialized in the startup
program. Learning-rate and accumulator variables take the reference's
names, so state copied between the packages by name lines up.

Ported: the ``Optimizer`` base, ``SGD``, ``Momentum`` and ``Adam``
(reference :119, :139, :172), each either one update op per parameter or,
with ``fused=True``, ONE ``fused_*`` op whose dense float32 set runs as a
single arena kernel launch on the card (a sparse gradient keeps its own
update inside that op). Gradient clipping and
regularization are not ported yet and raise when configured.
"""

from __future__ import annotations

from .framework import default_startup_program, unique_name
from .backward import append_backward


class Optimizer:
    """Base class (reference optimizer.py:24). ``fused=True`` emits ONE
    variadic ``fused_*`` op over every parameter instead of one op per
    parameter; under ``kernel_tier=torch`` it applies the per-parameter
    expressions, so the two programs agree bitwise."""

    def __init__(self, learning_rate, regularization=None, fused=False):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._fused = bool(fused)
        self._accumulators = {}  # (name, param name) -> Variable
        self._lr_var = None

    def _create_lr_var(self, program, startup):
        if self._lr_var is not None:
            return self._lr_var
        if hasattr(self._learning_rate, "name"):  # already a Variable
            self._lr_var = self._learning_rate
            return self._lr_var
        name = unique_name("learning_rate")
        self._lr_var = program.global_block().create_var(
            name=name, shape=(1,), dtype="float32", persistable=True)
        sb = startup.global_block()
        sb.create_var(name=name, shape=(1,), dtype="float32",
                      persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [name]},
                     attrs={"shape": [1],
                            "value": float(self._learning_rate),
                            "dtype": "float32"})
        return self._lr_var

    def _add_accumulator(self, name, param, startup, fill_value=0.0,
                         shape=None, dtype=None):
        """A persistable per-parameter state variable (reference
        optimizer.py:96), zero-filled by the startup program."""
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        vname = unique_name(f"{param.name}_{name}")
        shape = tuple(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        v = param.block.program.global_block().create_var(
            name=vname, shape=shape, dtype=dtype, persistable=True)
        sb = startup.global_block()
        sb.create_var(name=vname, shape=shape, dtype=dtype, persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [vname]},
                     attrs={"shape": list(shape), "value": float(fill_value),
                            "dtype": dtype})
        self._accumulators[key] = v
        return v

    def _append_optimize_op(self, block, param_and_grad, startup):
        raise NotImplementedError

    def _append_fused_op(self, block, params_grads, startup):
        raise NotImplementedError(
            f"{type(self).__name__} has no fused update op; construct it "
            "with fused=False")

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append the backward and the update ops (reference
        optimizer.py:98); returns [(param, grad_var)]."""
        startup = startup_program or default_startup_program()
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        program = loss.block.program
        self._create_lr_var(program, startup)
        if self.regularization is not None or any(
                getattr(p, "regularizer", None) is not None
                for p, _ in params_grads):
            raise NotImplementedError(
                "regularization is not ported yet (reference "
                "fluid/regularizer.py)")
        if any(getattr(p, "gradient_clip", None) is not None
               for p, _ in params_grads):
            raise NotImplementedError(
                "gradient clipping is not ported yet (reference "
                "fluid/clip.py)")
        block = program.global_block()
        if self._fused and params_grads:
            self._append_fused_op(block, params_grads, startup)
        else:
            for pg in params_grads:
                self._append_optimize_op(block, pg, startup)
        return params_grads


class SGD(Optimizer):
    """p -= lr·g (reference optimizer.py:119); an ``is_sparse`` embedding's
    table takes the sparse branch, which updates only the rows the batch
    looked up."""

    def _append_optimize_op(self, block, pg, startup):
        p, g = pg
        block.append_op("sgd",
                        inputs={"Param": [p.name], "Grad": [g.name],
                                "LearningRate": [self._lr_var.name]},
                        outputs={"ParamOut": [p.name]})

    def _append_fused_op(self, block, params_grads, startup):
        ps = [p.name for p, _ in params_grads]
        gs = [g.name for _, g in params_grads]
        block.append_op("fused_sgd",
                        inputs={"Params": ps, "Grads": gs,
                                "LearningRate": [self._lr_var.name]},
                        outputs={"ParamsOut": ps})


SGDOptimizer = SGD


class Momentum(Optimizer):
    """v = mu·v + g; p -= lr·v, or with ``use_nesterov`` p -= (g + mu·v)·lr
    (reference optimizer.py:139)."""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, pg, startup):
        p, g = pg
        v = self._add_accumulator("velocity", p, startup)
        block.append_op("momentum",
                        inputs={"Param": [p.name], "Grad": [g.name],
                                "Velocity": [v.name],
                                "LearningRate": [self._lr_var.name]},
                        outputs={"ParamOut": [p.name],
                                 "VelocityOut": [v.name]},
                        attrs={"mu": self._momentum,
                               "use_nesterov": self._use_nesterov})

    def _append_fused_op(self, block, params_grads, startup):
        ps = [p.name for p, _ in params_grads]
        gs = [g.name for _, g in params_grads]
        vs = [self._add_accumulator("velocity", p, startup).name
              for p, _ in params_grads]
        block.append_op("fused_momentum",
                        inputs={"Params": ps, "Grads": gs, "Velocities": vs,
                                "LearningRate": [self._lr_var.name]},
                        outputs={"ParamsOut": ps, "VelocitiesOut": vs},
                        attrs={"mu": self._momentum,
                               "use_nesterov": self._use_nesterov})


MomentumOptimizer = Momentum


class Adam(Optimizer):
    """Adam (reference optimizer.py:172): per parameter, moment1, moment2
    and a beta1_pow/beta2_pow pair updated by ``scale`` ops after the
    update; fused, one shared beta-power pair (every parameter shares the
    step count, so the numerics are the per-parameter form's)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _beta_pows(self, param, startup, suffix=""):
        return [self._add_accumulator(f"beta{k}_pow{suffix}", param, startup,
                                      fill_value=beta, shape=(1,))
                for k, beta in ((1, self._beta1), (2, self._beta2))]

    def _append_pow_updates(self, block, b1p, b2p):
        """The beta powers' step (reference _finish_update, optimizer.py
        :441-463): each scaled by its beta."""
        for v, beta in ((b1p, self._beta1), (b2p, self._beta2)):
            block.append_op("scale", inputs={"X": [v.name]},
                            outputs={"Out": [v.name]},
                            attrs={"scale": beta})

    def _append_optimize_op(self, block, pg, startup):
        p, g = pg
        m1 = self._add_accumulator("moment1", p, startup)
        m2 = self._add_accumulator("moment2", p, startup)
        b1p, b2p = self._beta_pows(p, startup)
        block.append_op(
            "adam",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name]},
            attrs=self._attrs())
        self._append_pow_updates(block, b1p, b2p)

    def _append_fused_op(self, block, params_grads, startup):
        ps = [p.name for p, _ in params_grads]
        gs = [g.name for _, g in params_grads]
        m1s = [self._add_accumulator("moment1", p, startup).name
               for p, _ in params_grads]
        m2s = [self._add_accumulator("moment2", p, startup).name
               for p, _ in params_grads]
        b1p, b2p = self._beta_pows(params_grads[0][0], startup, "_fused")
        block.append_op(
            "fused_adam",
            inputs={"Params": ps, "Grads": gs, "Moment1s": m1s,
                    "Moment2s": m2s, "Beta1Pow": [b1p.name],
                    "Beta2Pow": [b2p.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamsOut": ps, "Moment1sOut": m1s,
                     "Moment2sOut": m2s},
            attrs=self._attrs())
        self._append_pow_updates(block, b1p, b2p)


AdamOptimizer = Adam

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer"]
