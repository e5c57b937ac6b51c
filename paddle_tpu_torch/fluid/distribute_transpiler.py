"""``fluid.DistributeTranspiler`` — the pserver-training program rewriter
(counterpart of paddle_tpu/fluid/distribute_transpiler.py).

Reference: python/paddle/fluid/distribute_transpiler.py:134 (``transpile``),
:258 (``get_pserver_program``) — rewrites one ProgramDesc into N trainer
programs (optimize ops replaced by send/recv) and M pserver programs
(optimize blocks under listen_and_serv), with params placed across pserver
endpoints.

The trainer program keeps forward+backward only (the optimizer moves
server-side, exactly the reference's pserver-side optimize blocks);
send/recv are not graph ops here but the host-RPC client
(``trainer_client()`` -> distributed.param_server.ParamClient, whose
derived round-robin placement this transpiler mirrors). A "pserver
program" is a ``PServerProgram`` service spec: ``serve_in_thread()`` /
``serve_forever()`` run the shard's ParameterServer with the optimizer
rule lifted out of the original program's optimize ops. Sync mode maps to
the fan-in batch-barrier server; async mode applies pushes immediately,
bounded-staleness when ``transpile(..., max_staleness=k)`` is set.

Beyond the reference, the rule is also lifted from this package's fused
optimizer ops (``fused_sgd`` / ``fused_momentum`` / ``fused_adam``, which
list every parameter in one op): the server applies the same per-parameter
rule either way, so a program built with ``fused=True`` transpiles to the
same trainer and pserver programs as its per-parameter form.
"""

from __future__ import annotations

__all__ = ["DistributeTranspiler", "SimpleDistributeTranspiler",
           "PServerProgram"]

# optimize-op type -> how to lift its rule onto the server
# (distributed/param_server.py OPTIMIZERS carries the same three rules the
# reference's Go pserver runs server-side: sgd, momentum, adam)
_SERVER_RULES = {
    "sgd": lambda op, lr: ("sgd", {"lr": lr}),
    "momentum": lambda op, lr: ("momentum",
                                {"lr": lr, "mu": op.attr("mu", 0.9)}),
    "adam": lambda op, lr: ("adam", {"lr": lr,
                                     "b1": op.attr("beta1", 0.9),
                                     "b2": op.attr("beta2", 0.999),
                                     "eps": op.attr("epsilon", 1e-8)}),
}


# this package's fused optimize ops -> the server rule each applies
_FUSED = {"fused_sgd": "sgd", "fused_momentum": "momentum",
          "fused_adam": "adam"}


def _opt_pairs(op):
    """(param, grad) pairs of a server-liftable optimize op, else []."""
    if op.type in _SERVER_RULES and op.input("Param"):
        return [(op.input("Param")[0], op.input("Grad")[0])]
    if op.type in _FUSED and op.input("Params"):
        return list(zip(op.input("Params"), op.input("Grads")))
    return []


class PServerProgram:
    """What ``get_pserver_program(endpoint)`` yields: this endpoint's
    parameter shard + server-resident optimizer rule, runnable as a
    service (the reference's listen_and_serv program)."""

    def __init__(self, endpoint, param_names, optimizer, opt_kwargs, mode,
                 fan_in, max_staleness=None, barrier_timeout_s=None,
                 checkpoint_path=None, checkpoint_every=1,
                 sparse_param_names=()):
        self.endpoint = endpoint
        self.param_names = list(param_names)
        # params whose gradients arrive as SparseRows/SparseGrad (ids +
        # touched rows — the transpiler marks embedding tables); the server
        # applies them rowwise, O(touched rows)
        self.sparse_param_names = list(sparse_param_names)
        self.optimizer = optimizer
        self.opt_kwargs = dict(opt_kwargs)
        self.mode = mode
        self.fan_in = fan_in
        self.max_staleness = max_staleness
        self.barrier_timeout_s = barrier_timeout_s
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self._rpc = None

    def _address(self):
        from ..distributed.param_server import parse_endpoint
        return parse_endpoint(self.endpoint)

    def _start(self):
        from ..distributed.param_server import serve
        ps, rpc = serve(optimizer=self.optimizer,
                        opt_kwargs=self.opt_kwargs, mode=self.mode,
                        fan_in=self.fan_in,
                        max_staleness=self.max_staleness,
                        address=self._address(),
                        barrier_timeout_s=self.barrier_timeout_s,
                        checkpoint_path=self.checkpoint_path,
                        checkpoint_every=self.checkpoint_every)
        self._rpc = rpc
        return ps, rpc

    def serve_in_thread(self):
        ps, rpc = self._start()
        rpc.serve_in_thread()
        return ps, rpc

    def serve_forever(self):
        _ps, rpc = self._start()
        rpc.serve_forever()

    def shutdown(self):
        if self._rpc is not None:
            self._rpc.shutdown()


class DistributeTranspiler:
    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  startup_program=None, sync_mode=True, max_staleness=None):
        """Split ``program`` (which must already carry optimize ops via
        ``optimizer.minimize``) into the trainer side (optimize ops and
        accumulator updates stripped) and per-endpoint pserver specs."""
        from .framework import default_main_program, default_startup_program

        program = program or default_main_program()
        self._startup = startup_program or default_startup_program()
        self.trainer_id = int(trainer_id)
        self.trainers = int(trainers)
        self.sync_mode = bool(sync_mode)
        self.max_staleness = max_staleness
        self.endpoints = [e.strip() for e in pservers.split(",")
                          if e.strip()]
        if not self.endpoints:
            raise ValueError("pservers must list at least one endpoint "
                             "('host:port[,host:port...]')")

        block = program.global_block()
        opt_ops = [op for op in block.ops if _opt_pairs(op)]
        if not opt_ops:
            raise ValueError(
                "program has no server-liftable optimize ops (sgd/momentum/"
                "adam); call optimizer.minimize before transpile")
        kinds = {_FUSED.get(op.type, op.type) for op in opt_ops}
        if len(kinds) > 1:
            raise ValueError(f"mixed optimizer op types {sorted(kinds)}; "
                             "one server rule per job")

        self.params_grads = [pg for op in opt_ops for pg in _opt_pairs(op)]
        # params whose backward emits a sparse-row gradient (lookup_table
        # with is_sparse, the reference's SelectedRows W@GRAD): trainers
        # push these as ids + touched rows (ParamClient ships them on the
        # O(touched-rows) sparse wire) and the pserver applies rowwise
        placed = {p for p, _ in self.params_grads}
        self.sparse_param_names = sorted(
            {op.input("W")[0] for op in block.ops
             if op.type == "lookup_table" and op.attr("is_sparse", False)}
            & placed)
        lr = self._resolve_lr(opt_ops[0], program, self._startup)
        self.optimizer, self.opt_kwargs = _SERVER_RULES[next(iter(kinds))](
            opt_ops[0], lr)

        # accumulators (velocity/moments/beta-pows) live server-side too:
        # identified by the optimizer's own registry metadata, then any op
        # writing only accumulators (e.g. adam's beta-pow scale updates)
        # is stripped with the optimize ops
        accum = {v.name for v in block.vars.values()
                 if getattr(v, "optimizer_accumulator_for", None)}
        self._trainer_program = program.clone()
        tblock = self._trainer_program.global_block()
        keep = []
        for op in tblock.ops:
            if _opt_pairs(op):
                continue
            outs = op.output_arg_names()
            if outs and all(n in accum for n in outs):
                continue
            keep.append(op)
        tblock.ops[:] = keep
        self._trainer_program._bump_version()
        # verify_passes: stripping optimize/accumulator ops must leave a
        # structurally valid trainer program (a dropped var or orphaned
        # grad surfaces here, naming this pass, instead of at run time)
        from .analysis import verify_pass_output
        verify_pass_output(self._trainer_program, "DistributeTranspiler",
                           startup_program=self._startup)
        return self

    @staticmethod
    def _resolve_lr(op, program, startup):
        lr_name = (op.input("LearningRate") or [None])[0]
        if lr_name is None:
            return 0.01
        # the lr fill lives in the startup program (optimizer.py
        # _create_lr_var)
        for prog in (startup, program):
            for blk in prog.blocks:
                for o in blk.ops:
                    if o.type == "fill_constant" and \
                            o.output("Out") == [lr_name]:
                        return float(o.attr("value", 0.01))
        # no constant fill found: the lr is an in-graph decay schedule
        # (learning_rate_scheduler.py) — a server-resident rule cannot
        # follow it; silently freezing a wrong constant would corrupt
        # training, so refuse
        raise ValueError(
            f"learning rate {lr_name!r} is not a constant (in-graph decay "
            "schedule?); server-side optimizer rules need a constant lr — "
            "apply the schedule trainer-side or use a constant")

    # ---- reference API surface ----
    def get_trainer_program(self):
        return self._trainer_program

    def _placement(self):
        """Round-robin param->endpoint placement, identical to ParamClient's
        derived layout (param_server.shard_names over the sorted names) so
        client and servers agree without negotiation."""
        from ..distributed.param_server import shard_names
        names = [p for p, _ in self.params_grads]
        return shard_names(names, len(self.endpoints))

    def get_pserver_program(self, endpoint):
        idx = self.endpoints.index(endpoint)
        shard = self._placement()[idx]
        return PServerProgram(endpoint, shard, self.optimizer,
                              self.opt_kwargs,
                              mode="sync" if self.sync_mode else "async",
                              fan_in=self.trainers,
                              max_staleness=self.max_staleness,
                              sparse_param_names=[
                                  n for n in shard
                                  if n in self.sparse_param_names])

    def get_startup_program(self, endpoint, pserver_program=None):
        """The user startup pruned to this endpoint's shard (reference
        get_startup_program builds the pserver-side init program).
        fluid.io's inference prune treats persistables as load-from-disk
        terminals, so the dependency walk lives here — params ARE the
        targets on a pserver."""
        spec = pserver_program or self.get_pserver_program(endpoint)
        pruned = self._startup.clone()
        block = pruned.global_block()
        needed = set(spec.param_names)
        keep = []
        for i in reversed(range(len(block.ops))):
            op = block.ops[i]
            if any(o in needed for o in op.output_arg_names()):
                keep.append(i)
                needed.update(op.input_arg_names())
        keep_set = set(keep)
        block.ops[:] = [op for i, op in enumerate(block.ops)
                        if i in keep_set]
        pruned._bump_version()
        from .analysis import verify_pass_output
        verify_pass_output(pruned, "DistributeTranspiler.get_startup_program")
        return pruned

    def trainer_client(self, retry=None, rpc_timeout=None, endpoints=None):
        """The send/recv half of the reference trainer program: a
        ParamClient over every endpoint with the transpiler's placement.
        ``retry`` (rpc.RetryPolicy) makes the client reconnect-and-resend
        through pserver restarts — what a long-lived streaming trainer
        under a PserverSupervisor wants; ``endpoints`` substitutes the
        ACTUAL serve addresses when the transpile-time ones were
        placeholders (the supervisor allocates ports at spawn) — the
        count must match, placement is derived from names alone."""
        from ..distributed.param_server import ParamClient, parse_endpoint
        if endpoints is None:
            endpoints = self.endpoints
        elif len(endpoints) != len(self.endpoints):
            raise ValueError(
                f"endpoints count {len(endpoints)} != transpiled pserver "
                f"count {len(self.endpoints)}: the round-robin placement "
                "would disagree with the servers'")
        return ParamClient([parse_endpoint(e) for e in endpoints],
                           trainer_id=self.trainer_id,
                           param_names=[p for p, _ in self.params_grads],
                           sparse_param_names=self.sparse_param_names,
                           retry=retry, rpc_timeout=rpc_timeout)


class SimpleDistributeTranspiler(DistributeTranspiler):
    """Reference distribute_transpiler_simple.py: whole-parameter placement
    with no block splitting. This framework's transpiler already places
    whole parameters (round-robin over endpoints; the reference's 1 KiB /
    1 MiB block splitting served gRPC message sizing, which the host-RPC
    backend does not need), so the simple variant IS the base behavior —
    the class exists for the reference API spelling."""
