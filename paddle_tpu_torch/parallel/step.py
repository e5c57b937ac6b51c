"""The sharded program step behind ``shard_program_step``: the executor's
eager op loop over one rank's shard, with the collectives a partitioned
program needs added at the ops that need them (the list is in
``sharding.py``'s docstring). The block is walked once, when the step is
built: each op gets its action (the registered lowering, or a collective
form of it) and the parameter gradients their all-reduce points, and the
executor's own op loop (``core/executor.py::_run_ops``, with its per-op
hooks) runs the block with those. Ops of sub-blocks (control flow) run as
the executor runs them."""

from __future__ import annotations

import functools
import math

import torch

from ..core import registry
from ..core.amp import amp_guard
from ..core.executor import _RNG_KEY, _analyze_program, _run_ops
from ..core.lod import LoDArray
from ..core.sparse import SparseRows
from ..ops.common import data_of, like
from ..ops.norm_ops import _bn_axes, _bn_bshape
from ..ops.reduce import _axes, _lod_mask_count
from . import collectives as C
from .sharding import P, local_shard, place_feed

# optimizer ops: the parameter, gradient and output slots of the
# per-parameter form and of the fused (list) form
_OPT_SLOTS = (("Param", "Grad", "ParamOut"), ("Params", "Grads", "ParamsOut"))
_NOT_STATE = {"Param", "Grad", "Params", "Grads", "LearningRate"}
# ops whose statistics span the batch and that have no collective form here
_BATCH_COUPLED = {"fused_conv2d_bn", "fused_conv2d_bn_grad", "auc",
                  "precision_recall", "chunk_eval"}
# reductions with a global form when their axes take in the rows (dim 0)
_GLOBAL_REDUCE = ("reduce_sum", "reduce_mean")
_REDUCE = _GLOBAL_REDUCE + ("reduce_max", "reduce_min", "reduce_prod")


def _reduces_rows(op, block):
    """Whether a reduce_* op's axes take in dim 0 of its input."""
    if op.attrs.get("reduce_all", False):
        return True
    dim = op.attrs.get("dim", 0)
    dims = dim if isinstance(dim, (list, tuple)) else (dim,)
    if all(d >= 0 for d in dims):
        return 0 in dims
    shape = block.var(op.input("X")[0]).shape
    if shape is None:
        raise NotImplementedError(
            f"{op.type}: a negative dim of an input of unknown rank; the "
            "sharded step cannot tell whether it reduces over the rows")
    return any(d % len(shape) == 0 for d in dims)


def _opt_slots(op):
    for ps, gs, outs in _OPT_SLOTS:
        if op.input(ps) and op.input(gs) and op.output(outs):
            return ps, gs, outs
    return None


class ShardedStep:
    def __init__(self, executor, program, feed_example, fetch_list, plan,
                 scope):
        from ..core.scope import global_scope

        self.exe = executor
        self.program = program
        self.plan = plan
        self.mesh = plan.mesh
        self.scope = scope or global_scope()
        self.feed_example = dict(feed_example)
        self.fetch_names = [f if isinstance(f, str) else f.name
                            for f in fetch_list]
        self.dp = plan.data_axis
        self.tp = plan.model_axis

    # -- building --

    def build(self):
        exe, program, scope, mesh = self.exe, self.program, self.scope, \
            self.mesh
        block = program.global_block()
        full_feeds = exe._prepare_feed(block, self.feed_example)
        exe._seed_scope(program, scope)
        analysis = _analyze_program(program)
        self.specs, state = {}, {}
        for n in analysis.free:
            if n in full_feeds or not scope.has_var(n):
                continue
            v = scope.find_var(n)
            if not isinstance(v, torch.Tensor):
                state[n] = v
                continue
            var = block.var(n) if block.has_var(n) else None
            spec = self.plan.spec_for_param(n, tuple(v.shape), var=var)
            self.specs[n] = spec
            state[n] = local_shard(v, spec, mesh).clone()
        state[_RNG_KEY] = scope.find_var(_RNG_KEY)
        feeds = {n: place_feed(v, self.plan, n)
                 for n, v in full_feeds.items()}
        self._plan_block(block, full_feeds)
        return self.step, state, feeds

    def _spec_kind(self, name):
        spec = self.specs.get(name, P())
        if not any(e is not None for e in spec):
            return None
        if self.tp and tuple(spec) == (None, self.tp):
            return "tp"
        if self.dp and spec[0] == self.dp \
                and not any(e is not None for e in spec[1:]):
            return "dp"
        raise NotImplementedError(
            f"variable {name!r}: the sharded step has no collective form "
            f"for spec {spec!r} (it shards a 2-D parameter's last dim over "
            "the model axis and an accumulator's dim 0 over the data axis)")

    def _plan_block(self, block, full_feeds):
        kinds = {n: self._spec_kind(n) for n in self.specs}
        tp_vars = {n for n, k in kinds.items() if k == "tp"}
        dp_vars = {n for n, k in kinds.items() if k == "dp"}
        rows = {n for n, v in full_feeds.items()
                if self.plan.spec_for_feed(
                    n, tuple(data_of(v).shape))[:1] == (self.dp,)
                and self.dp is not None}
        ops = block.ops
        sparse_tables = {op.input("W")[0] for op in ops
                         if op.type == "lookup_table"
                         and op.attrs.get("is_sparse", False)}
        params, grad_last = set(), {}
        for op in ops:
            slots = _opt_slots(op)
            if slots:
                params.update(op.input(slots[0]))
        for i, op in enumerate(ops):
            for n in op.output_arg_names():
                if n.endswith("@GRAD") and n[:-5] in params:
                    grad_last[n] = i
        sums = {}
        for g, i in grad_last.items():
            sums.setdefault(i, []).append(g)
        self.after = {i: functools.partial(self._sum_grads, names)
                      for i, names in sums.items()}
        self.actions = []
        live = self._dp_live()
        for op in ops:
            ins = op.input_arg_names()
            sharded_in = any(n in rows for n in ins)
            act = None
            t = op.type
            replicated = t == "mean" or bool(_opt_slots(op))
            over_rows = live and t.removesuffix("_grad") in _REDUCE \
                and op.input("X")[0] in rows and _reduces_rows(op, block)
            if t in ("mean", "mean_grad") and op.input("X")[0] in rows:
                act = self._mean if t == "mean" else self._mean_grad
            elif over_rows and t in _GLOBAL_REDUCE:
                act = self._reduce_rows
                replicated = True
            elif over_rows and t == "reduce_mean_grad":
                act = self._reduce_mean_grad
            elif over_rows and t in _REDUCE:
                raise NotImplementedError(
                    f"{t} over the rows sharded over {self.dp!r}: the "
                    "sharded step sums and averages over them "
                    "(reduce_sum, reduce_mean), nothing else")
            elif t in ("batch_norm", "batch_norm_grad") \
                    and op.input("X")[0] in rows \
                    and not op.attrs.get("is_test", False):
                act = self._bn if t == "batch_norm" else self._bn_grad
            elif t == "accuracy" and sharded_in and live:
                act = self._accuracy
                replicated = True
            elif t in _BATCH_COUPLED and sharded_in and live:
                raise NotImplementedError(
                    f"{t}: it reduces over the batch sharded over "
                    f"{self.dp!r} and has no collective form in the "
                    "sharded step" + ("; build the program without "
                                      "fuse_conv_bn"
                                      if t.startswith("fused") else ""))
            elif t in ("mul", "mul_grad") and op.input("Y")[0] in tp_vars:
                act = self._col_mul if t == "mul" else self._col_mul_grad
            elif t in ("lookup_table", "lookup_table_grad") \
                    and op.input("W")[0] in tp_vars:
                act = self._col_lookup if t == "lookup_table" \
                    else self._col_lookup_grad
            elif _opt_slots(op):
                zero = self._zero_indices(op, dp_vars)
                sparse = {op.input(_opt_slots(op)[0])[i] for i in zero} \
                    & sparse_tables
                if sparse:
                    raise NotImplementedError(
                        f"{t}: is_sparse table(s) {sorted(sparse)} with "
                        f"optimizer state sharded over {self.dp!r} (ZeRO-1); "
                        "the sharded step updates a sparse table's rows on "
                        "whole accumulators only (shard_opt_state=False)")
                if zero:
                    act = self._zero_update
            elif any(n in tp_vars for n in ins):
                raise NotImplementedError(
                    f"op {t!r} reads a parameter sharded over "
                    f"{self.tp!r}; the sharded step shards only mul's Y and "
                    "lookup_table's W")
            self.actions.append(act)
            if replicated:
                continue
            outs = op.output_arg_names()
            if t == "batch_norm":
                outs = op.output("Y")
            if sharded_in:
                rows.update(n for n in outs
                            if not (n.endswith("@GRAD") and n[:-5] in params))
        self._dp_vars = dp_vars

    def _dp_live(self):
        return self.dp is not None and self.mesh.group(self.dp) is not None

    # -- running --

    def step(self, state, feeds):
        """One step of this rank: (new_state, fetches)."""
        env = dict(state)
        env.update(feeds)
        self._counts = {}
        with torch.no_grad(), amp_guard(self.exe.amp):
            _run_ops(self.program.global_block(), env, self.exe.device,
                     self.actions, self.after)
        new_state = {n: env.get(n, state[n]) for n in state}
        return new_state, [env[n] for n in self.fetch_names]

    def _sum_grads(self, names, env):
        """The parameter gradients ``names``, summed over dp after the
        backward's last write of them: a dense one all-reduced, an
        ``is_sparse`` table's SparseRows gathered (the SelectedRows sum)."""
        dp = self.mesh.group(self.dp) if self.dp else None
        for g in names:
            v = env[g]
            if isinstance(v, SparseRows):
                env[g] = self._gather_rows(v, dp)
                continue
            if not isinstance(v, torch.Tensor):
                raise NotImplementedError(
                    f"{g}: a {type(v).__name__} gradient has no sum over "
                    f"{self.dp!r}")
            env[g] = C.all_reduce(v, dp)

    def _gather_rows(self, sr, group):
        """The SelectedRows sum over dp: every rank's entries, joined in
        rank order. Ranks whose entry counts differ (a LoD feed) pad to the
        largest with sentinel rows of zero values, which the sparse update
        drops; one all-reduce of the counts settles the largest (a device
        wait). Under tp each rank's values are its columns of the table."""
        if group is None:
            return sr
        n = self.mesh.size(self.dp)
        k = sr.rows.shape[0]
        kmax = int(C.all_max(torch.tensor([k], device=sr.rows.device),
                             group)[0])
        rows, vals = sr.rows, sr.values
        if kmax > k:
            rows = torch.cat([rows, rows.new_full((kmax - k,), sr.nrows)])
            vals = torch.cat([vals, vals.new_zeros((kmax - k,)
                                                   + vals.shape[1:])])
        return SparseRows(C.all_gather(rows, 0, group, n),
                          C.all_gather(vals, 0, group, n), sr.nrows)

    def _forward(self, ctx):
        registry.get_op_info(ctx.op.type).forward(ctx)

    def _group(self, axis):
        return self.mesh.group(axis), self.mesh.size(axis)

    # mean over the whole batch: the global sum over the global count
    def _global_count(self, ctx, x):
        name = ctx.op.input("X")[0]
        if name not in self._counts:
            if isinstance(x, LoDArray):
                m, count = _lod_mask_count(x)
                local = torch.stack([torch.sum(x.data * m).float(),
                                     count.float()])
            else:
                local = torch.stack([
                    torch.sum(x.float()),
                    torch.tensor(float(x.numel()), device=x.device)])
            self._counts[name] = C.all_reduce(local,
                                              self.mesh.group(self.dp))
        return self._counts[name]

    def _mean(self, ctx):
        x = ctx.input("X")
        total, count = self._global_count(ctx, x)
        dtype = data_of(x).dtype
        ctx.set_output("Out", (total / count).reshape(()).to(dtype))

    def _mean_grad(self, ctx):
        x = ctx.input("X")
        _, count = self._global_count(ctx, x)
        d = ctx.input("Out@GRAD").reshape(())
        if isinstance(x, LoDArray):
            m, _ = _lod_mask_count(x)
            ctx.set_output("X@GRAD", x.with_data(
                (m * (d / count)).expand(x.data.shape).contiguous()))
            return
        ctx.set_output("X@GRAD", (d / count).expand(x.shape)
                       .to(x.dtype).contiguous())

    def _accuracy(self, ctx):
        """The whole batch's accuracy: this rank's Correct and Total
        summed over dp, then their quotient (what the reference's step
        computes over the global batch)."""
        self._forward(ctx)
        local = torch.stack([ctx.env[ctx.op.output("Correct")[0]],
                             ctx.env[ctx.op.output("Total")[0]]]).long()
        correct, total = C.all_reduce(local, self.mesh.group(self.dp))
        ctx.set_output("Accuracy", (correct.float() / total).reshape(()))
        ctx.set_output("Correct", correct.to(torch.int32).reshape(()))
        ctx.set_output("Total", total.to(torch.int32).reshape(()))

    # reduce_sum / reduce_mean over the rows: the global sum, over the
    # global count of the reduced elements
    def _reduce_count(self, ctx, x, axes):
        key = (ctx.op.input("X")[0], axes)
        if key not in self._counts:
            local = torch.tensor(float(math.prod(x.shape[a] for a in axes)),
                                 device=x.device)
            self._counts[key] = C.all_reduce(local,
                                             self.mesh.group(self.dp))
        return self._counts[key]

    def _reduce_axes(self, ctx):
        x = ctx.input("X")
        if isinstance(x, LoDArray):
            raise NotImplementedError(
                f"{ctx.op.type} over a LoD batch sharded over {self.dp!r}: "
                "the ranks pad their sequences to different lengths")
        axes = _axes(ctx, x)
        if 0 not in axes:
            raise RuntimeError(f"{ctx.op.type}: axes {axes} of a "
                               f"{x.ndim}-D input, planned as over dim 0")
        return x, axes

    def _reduce_rows(self, ctx):
        x, axes = self._reduce_axes(ctx)
        out = C.all_reduce(torch.sum(x, dim=axes,
                                     keepdim=ctx.attr("keep_dim", False)),
                           self.mesh.group(self.dp))
        if ctx.op.type == "reduce_mean":
            out = out / self._reduce_count(ctx, x, axes)
        ctx.set_output("Out", out.to(x.dtype))

    def _reduce_mean_grad(self, ctx):
        x, axes = self._reduce_axes(ctx)
        d = data_of(ctx.input("Out@GRAD"))
        if not ctx.attr("keep_dim", False):
            d = d.reshape([1 if i in axes else s
                           for i, s in enumerate(x.shape)])
        ctx.set_output("X@GRAD", (d / self._reduce_count(ctx, x, axes))
                       .expand(x.shape).to(x.dtype).contiguous())

    # batch_norm over the global batch
    def _bn(self, ctx):
        x = ctx.input("X")
        scale, bias = ctx.input("Scale"), ctx.input("Bias")
        layout = ctx.attr("data_layout", "NCHW")
        eps, mom = ctx.attr("epsilon", 1e-5), ctx.attr("momentum", 0.9)
        axes, bshape = _bn_axes(x, layout), _bn_bshape(x, layout)
        group = self.mesh.group(self.dp)
        xf = x.float()
        c = scale.shape[0]
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        if x.dtype == torch.bfloat16:
            s = C.all_reduce(torch.cat([torch.sum(xf, dim=axes),
                                        torch.sum(xf * xf, dim=axes),
                                        count]), group)
            n = s[-1]
            mean = s[:c] / n
            var = torch.clamp_min(s[c:2 * c] / n - mean * mean, 0.0)
        else:
            s = C.all_reduce(torch.cat([torch.sum(xf, dim=axes), count]),
                             group)
            n = s[-1]
            mean = s[:c] / n
            d = xf - mean.reshape(bshape)
            var = C.all_reduce(torch.sum(d * d, dim=axes), group) / n
        inv_std = torch.rsqrt(var + eps)
        y = (xf * (scale * inv_std).reshape(bshape)
             + (bias - mean * scale * inv_std).reshape(bshape))
        ctx.set_output("Y", y.to(x.dtype))
        ctx.set_output("MeanOut", mom * ctx.input("Mean") + (1.0 - mom) * mean)
        ctx.set_output("VarianceOut",
                       mom * ctx.input("Variance") + (1.0 - mom) * var)
        ctx.set_output("SavedMean", mean)
        ctx.set_output("SavedVariance", var)

    def _bn_grad(self, ctx):
        x, scale = ctx.input("X"), ctx.input("Scale")
        mean, var = ctx.input("SavedMean"), ctx.input("SavedVariance")
        dy = ctx.input("Y@GRAD")
        layout = ctx.attr("data_layout", "NCHW")
        eps = ctx.attr("epsilon", 1e-5)
        axes, bshape = _bn_axes(x, layout), _bn_bshape(x, layout)
        c = scale.shape[0]
        xf, dyf = x.float(), dy.float()
        inv_std = torch.rsqrt(var + eps).reshape(bshape)
        xhat = (xf - mean.reshape(bshape)) * inv_std
        dbias = torch.sum(dyf, dim=axes)
        dscale = torch.sum(dyf * xhat, dim=axes)
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        s = C.all_reduce(torch.cat([dbias, dscale, count]),
                         self.mesh.group(self.dp))
        m = s[-1]
        dx = (scale.reshape(bshape) * inv_std / m) * (
            m * dyf - s[:c].reshape(bshape)
            - xhat * s[c:2 * c].reshape(bshape))
        ctx.set_output("X@GRAD", dx.to(x.dtype))
        # this rank's share: the parameter-gradient sum over dp adds them
        ctx.set_output("Scale@GRAD", dscale)
        ctx.set_output("Bias@GRAD", dbias)

    # column-parallel mul / lookup_table over tp
    def _gather_cols(self, ctx, slot):
        name = ctx.op.output(slot)[0]
        v = ctx.env[name]
        group, n = self._group(self.tp)
        ctx.env[name] = like(v, C.all_gather(data_of(v), -1, group, n))

    def _with_col_cotangent(self, ctx, slot):
        """Run the grad op with its ``slot`` cotangent cut to this rank's
        columns, then put the whole cotangent back."""
        name = ctx.op.input(slot)[0]
        full = ctx.env[name]
        n = self.mesh.size(self.tp)
        part = data_of(full).chunk(n, dim=-1)[self.mesh.index(self.tp)]
        ctx.env[name] = like(full, part.contiguous())
        try:
            self._forward(ctx)
        finally:
            ctx.env[name] = full

    def _col_mul(self, ctx):
        self._forward(ctx)
        self._gather_cols(ctx, "Out")

    def _col_mul_grad(self, ctx):
        self._with_col_cotangent(ctx, "Out@GRAD")
        names = ctx.op.output("X@GRAD")
        if names and names[0] in ctx.env:
            v = ctx.env[names[0]]
            ctx.env[names[0]] = like(v, C.all_reduce(
                data_of(v), self.mesh.group(self.tp)))

    def _col_lookup(self, ctx):
        self._forward(ctx)
        self._gather_cols(ctx, "Out")

    def _col_lookup_grad(self, ctx):
        self._with_col_cotangent(ctx, "Out@GRAD")

    # ZeRO-1: this rank's rows of the parameter, then all-gathered
    def _zero_indices(self, op, dp_vars):
        ps = op.input(_opt_slots(op)[0])
        state_slots = [s for s in op.inputs if s not in _NOT_STATE
                       and len(op.input(s)) == len(ps)]
        return [i for i in range(len(ps))
                if any(op.input(s)[i] in dp_vars for s in state_slots)]

    def _zero_update(self, ctx):
        op, env = ctx.op, ctx.env
        ps, gs, outs = _opt_slots(op)
        idx = self._zero_indices(op, self._dp_vars)
        group, n = self._group(self.dp)
        me = self.mesh.index(self.dp)
        saved = {}
        for i in idx:
            for name in (op.input(ps)[i], op.input(gs)[i]):
                saved[name] = env[name]
                env[name] = env[name].chunk(n, dim=0)[me].clone()
        try:
            self._forward(ctx)
        finally:
            for i in idx:
                g = op.input(gs)[i]
                env[g] = saved[g]
        for i in idx:
            out = op.output(outs)[i]
            env[out] = C.all_gather(env[out], 0, group, n)
