"""Executor: runs a Program block op by op on torch tensors (counterpart of
paddle_tpu/core/executor.py, eager path only).

The reference's jit path traces the whole block into one XLA computation;
PyTorch runs eagerly, so this executor is the reference's eager interpreter
(``ExecContext`` :134, ``_run_ops`` :227, the eager branch of
``Executor.run`` :568/:607-614) and nothing else. ``run_steps`` /
``prepare_steps`` / ``run_prepared`` (reference :665-764) are an eager
loop of K such steps over feeds staged on the device once.

State contract: persistable variables live in a Scope between runs as torch
tensors on the executor's device. Temporaries live in a per-run dict; one
may also be a LoDArray or a SparseRows (an ``is_sparse`` embedding's
gradient), and the scope holds either as it is. Every op output whose name
the scope holds, or that the program declares persistable, is written back
after the run: an optimizer op's ParamOut names its Param, so the updated
parameter replaces it in the scope.

The op loop runs under ``torch.no_grad()``: gradients are ops of the
program (``fluid.backward``), not autograd tape. A grad lowering that asks
autograd for a vector-Jacobian product enables it locally
(``ops/common.py::vjp``). With ``amp=True`` it also runs under
``amp_guard`` (reference :610), so the GEMM ops compute in bfloat16
(``core/amp.py``).

Per-program work (the free-read and written-name walks, the op
inventory, the ``executor_verify`` memo) is cached per program version in
``_ProgramAnalysis`` (reference :299-356), so a steady ``run()`` walks no
block. The op loop reads the debug flags (``check_nan_inf``,
``benchmark``, ``obs_op_metrics``) once per block, never per op.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from . import flags as _flags
from . import registry
from .amp import amp_guard
from .block_walk import free_reads, written_names
from .lod import LoDArray, flat_to_lodarray, pack_sequences
from .profiler import profiler_enabled, record_event
from .scope import global_scope
from .sparse import SparseRows
from .types import torch_dtype
from ..obs.metrics import REGISTRY as _METRICS

# scope slot of the startup initializers' torch.Generator
_RNG_KEY = "__rng__"

# ---------------------------------------------------------------------------
# obs_op_metrics: the reference's four executor families (:40-66). The port
# compiles nothing, so "retraces" counts rebuilds of the per-version
# _ProgramAnalysis; like the reference's it is counted whatever the flag
# and stays flat in steady state.
# ---------------------------------------------------------------------------

_M_OP_DISPATCHES = _METRICS.counter(
    "paddle_tpu_executor_op_dispatches",
    "op dispatches by op type (obs_op_metrics flag)",
    labels=("op_type",))
_M_OP_SECONDS = _METRICS.counter(
    "paddle_tpu_executor_op_seconds",
    "cumulative per-op-type eager DISPATCH wall time in seconds: timed "
    "around the op forward only, independent of co-enabled debug flags; "
    "the device's async tail is not awaited (obs_op_metrics flag)",
    labels=("op_type",))
_M_STEPS = _METRICS.counter(
    "paddle_tpu_executor_steps",
    "Executor steps (run() calls and run_prepared steps), by executor "
    "mode (obs_op_metrics flag)", labels=("mode",))
_M_RETRACES = _METRICS.counter(
    "paddle_tpu_executor_retraces",
    "per-program-version preparations: rebuilds of the executor's "
    "_ProgramAnalysis (the port compiles nothing, so this stands where "
    "the reference counts its jit traces); flat in steady state",
    labels=("kind",))

# op_type -> (dispatch child, seconds child), made on first dispatch
_OP_CHILDREN: dict = {}


def _op_children(op_type):
    mc = _OP_CHILDREN.get(op_type)
    if mc is None:
        mc = _OP_CHILDREN[op_type] = (
            _M_OP_DISPATCHES.labels(op_type=op_type),
            _M_OP_SECONDS.labels(op_type=op_type))
    return mc


class Place:
    pass


class CPUPlace(Place):
    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    """One CUDA card, by index."""

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def resolve_device(place=None) -> torch.device:
    """The torch.device a place names. ``None`` means ``CUDAPlace(0)``; with
    no GPU present that raises: only an explicit ``CPUPlace()`` runs on the
    CPU."""
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if place is None or isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass fluid.CPUPlace() to run "
                "on the CPU")
        return torch.device("cuda", getattr(place, "device_id", 0))
    raise TypeError(f"unsupported place {place!r}")


class ExecContext:
    """Per-op view of the environment handed to op lowerings."""

    __slots__ = ("op", "block", "env", "device")

    def __init__(self, op, block, env, device):
        self.op = op
        self.block = block
        self.env = env
        self.device = device

    def input(self, slot):
        names = self.op.input(slot)
        if not names:
            raise KeyError(f"op {self.op.type}: missing input slot {slot!r}")
        return self._read(names[0])

    def _read(self, name):
        if name not in self.env:
            raise KeyError(
                f"op {self.op.type}: variable {name!r} used before definition")
        return self.env[name]

    def has_input(self, slot):
        """Whether the slot names a variable that holds a value (reference
        :147-149): a named slot whose variable is neither fed, in the
        scope, nor written yet counts as absent, as an optional input
        left unset does."""
        names = self.op.input(slot)
        return bool(names) and names[0] in self.env

    def inputs(self, slot):
        """Every value of a variadic slot (sum, fused_momentum), in order."""
        return [self._read(n) for n in self.op.input(slot)]

    def set_output(self, slot, value):
        names = self.op.output(slot)
        if names:
            self.env[names[0]] = value

    def set_outputs(self, slot, values):
        for n, v in zip(self.op.output(slot), values):
            self.env[n] = v

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def var(self, name):
        """The block's declaration of ``name`` (parent blocks included)."""
        return self.block.var(name)

    def out_dtype(self, slot="Out"):
        """Declared torch dtype of the slot's (first) output var, or None
        where it is not annotated."""
        names = self.op.output(slot)
        if names and self.block.has_var(names[0]):
            d = self.block.var(names[0]).dtype
            if d is not None:
                return torch_dtype(d)
        return None

    def generator(self) -> torch.Generator:
        """The run's generator for random ops (seeded once per scope from
        ``program.random_seed``)."""
        return self.env[_RNG_KEY]

    # ---- control flow: run a sub-block over the current env ----
    def run_sub_block(self, block_idx):
        """Run block ``block_idx`` of this op's program over this op's env
        (reference :199-201): the sub-block reads the parent's names and
        its writes stay visible after it."""
        _run_ops(self.block.program.blocks[block_idx], self.env,
                 self.device)

    def sub_block(self, attr_name="sub_block"):
        return self.block.program.blocks[self.attr(attr_name)]


def _float_leaves(value):
    """The floating tensors an op output holds: a tensor itself, a
    LoDArray's data (its lens are int32), a SparseRows' values (its rows
    are int64)."""
    if isinstance(value, torch.Tensor):
        t = value
    elif isinstance(value, LoDArray):
        t = value.data
    elif isinstance(value, SparseRows):
        t = value.values
    else:
        return ()
    return (t,) if t.is_floating_point() and t.numel() else ()


def _check_op_outputs_finite(op, env):
    """check_nan_inf sweep after one op (reference :207-224, executor.cc
    CheckTensorNANOrInf): one reduction per output and one host sync per
    op; only a failing op pays the second pass that names the output."""
    named = [(n, t) for n in op.output_arg_names()
             for t in _float_leaves(env.get(n))]
    if not named:
        return
    if bool(torch.stack([torch.isfinite(t).all() for _, t in named]).all()):
        return
    for name, t in named:
        if not bool(torch.isfinite(t).all()):
            kind = "NaN" if bool(torch.isnan(t).any()) else "Inf"
            raise FloatingPointError(
                f"{kind} in output {name!r} of op {op.type!r} "
                "(check_nan_inf flag)")


def _run_ops(block, env, device, override=None, after=None):
    """Run every op of a block over ``env`` in order. The flags are read
    here once per block: with ``check_nan_inf``, ``benchmark`` and
    ``obs_op_metrics`` off, the profiler idle and ``PDTPU_OP_COVERAGE``
    unset the loop is the plain one.

    ``override`` (one entry per op) runs ``override[i](ctx)`` in place of
    op i's registered forward where the entry is not None, and
    ``after[i](env)`` runs where ``after`` (a dict by op index) has op i,
    right after its forward: the sharded step's collective forms and
    gradient sums (``parallel/step.py``). The hooks see both as the op."""
    check = _flags.get_flag("check_nan_inf")
    bench = _flags.get_flag("benchmark")
    opm = _flags.get_flag("obs_op_metrics")
    prof = profiler_enabled()
    record = registry.dispatch_coverage_enabled()
    if check or bench or opm or prof or record:
        _run_ops_hooked(block, env, device, check, bench, opm, prof, record,
                        override, after)
        return
    for i, op in enumerate(block.ops):
        fn = override[i] if override else None
        if fn is None:
            fn = registry.get_op_info(op.type).forward
        fn(ExecContext(op, block, env, device))
        if after and i in after:
            after[i](env)


def _run_ops_hooked(block, env, device, check, bench, opm, prof, record,
                    override, after):
    """The op loop with the per-op hooks (reference :237-286): a profiler
    span per op, the coverage record after the forward returns, the
    obs_op_metrics counters (the forward's dispatch time, taken before
    the check and the benchmark sync, so it means the same whatever rides
    along), the NaN/Inf sweep, and the benchmark line, timed after the
    device is synchronised."""
    sync = device.type == "cuda"
    for i, op in enumerate(block.ops):
        t0 = time.perf_counter() if (bench or opm) else 0.0
        ctx = ExecContext(op, block, env, device)
        fn = override[i] if override else None
        if fn is None:
            fn = registry.get_op_info(op.type).forward
        post = after.get(i) if after else None
        if prof:
            with record_event(op.type, kind="op"):
                fn(ctx)
                if post is not None:
                    post(env)
        else:
            fn(ctx)
            if post is not None:
                post(env)
        if record:
            registry.record_dispatch(op.type)
        if opm:
            disp, secs = _op_children(op.type)
            disp.inc()
            secs.inc(time.perf_counter() - t0)
        if check:
            _check_op_outputs_finite(op, env)
        if bench:
            if sync:
                torch.cuda.synchronize(device)
            print(f"[benchmark] {op.type}: "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)


class _ProgramAnalysis:
    """Per-(program, version) results for block 0 (reference :299-339):
    the free reads and written names, the persistable subset of the
    writes, and the executor_verify memo (the (feed names, fetch names)
    surfaces this version has verified under)."""

    __slots__ = ("version", "free", "written", "persistable_written",
                 "verified")

    def __init__(self, version, free, written, persistable_written):
        self.version = version
        self.free = free
        self.written = written
        self.persistable_written = persistable_written
        self.verified = set()


# program -> its _ProgramAnalysis, keyed by the program object (weakly, so
# a dropped program takes its entry along) and revalidated by its version
_ANALYSIS_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _analyze_program(program):
    cached = _ANALYSIS_CACHE.get(program)
    if cached is not None and cached.version == program._version:
        return cached
    _M_RETRACES.labels(kind="analysis").inc()
    free = free_reads(program, 0)
    written = written_names(program, 0)
    block = program.global_block()
    persistable = frozenset(
        n for n in written if block.has_var(n) and block.var(n).persistable)
    cached = _ProgramAnalysis(program._version, free, written, persistable)
    _ANALYSIS_CACHE[program] = cached
    return cached


def _maybe_verify(program, analysis, feed_names, fetch_names=(), scope=None):
    """executor_verify (reference :368-396): verify once per (program
    version, feed/fetch surface). Names the scope binds are dataflow roots
    like feeds. With the flag off and nothing memoised this costs one
    attribute read and one flag lookup. Raises ProgramVerifyError naming
    the executor."""
    verified = analysis.verified
    if not verified and not _flags.get_flag("executor_verify"):
        return
    key = (frozenset(feed_names), frozenset(fetch_names))
    if key in verified or not _flags.get_flag("executor_verify"):
        return
    roots = set(feed_names)
    if scope is not None:
        roots.update(n for n in analysis.free if scope.has_var(n))
    from ..fluid.analysis import verify_program
    verify_program(program, feed_names=roots, fetch_names=fetch_names,
                   pass_name="executor")
    verified.add(key)


class _PreparedSteps:
    """Handle from :meth:`Executor.prepare_steps` (reference :120): the
    program and its fetches bound to the feeds stacked on the device."""

    __slots__ = ("program", "stacked", "fetch_names", "steps", "n_feeds",
                 "scope")

    def __init__(self, program, stacked, fetch_names, steps, n_feeds, scope):
        self.program = program
        self.stacked = stacked
        self.fetch_names = fetch_names
        self.steps = steps
        self.n_feeds = n_feeds
        self.scope = scope


def _feed_slice(value, i):
    if isinstance(value, LoDArray):
        return LoDArray(value.data[i], value.lens[i],
                        tuple(o[i] for o in value.outer_levels) or None)
    return value[i]


def _stack_fetches(values, return_numpy):
    """One fetch over the steps: tensors (and a LoDArray's leaves) stacked
    on axis 0; any other value (a SparseRows) as the list of its steps."""
    first = values[0]
    if isinstance(first, torch.Tensor):
        stacked = torch.stack(values)
    elif isinstance(first, LoDArray):
        stacked = LoDArray(
            torch.stack([v.data for v in values]),
            torch.stack([v.lens for v in values]),
            tuple(torch.stack(level) for level in
                  zip(*(v.outer_levels for v in values))) or None)
    else:
        return values
    return Executor._fetch_value(stacked, return_numpy)


class Executor:
    """User-facing executor. Runs on ``cuda:0`` unless ``place`` is
    ``CPUPlace()``; ``amp=True`` runs every program under AMP (bfloat16
    compute, float32 master weights; reference :553-561)."""

    def __init__(self, place=None, amp=False):
        self.device = resolve_device(place)
        self.amp = amp

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from ..fluid.framework import default_main_program

        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = _fetch_names(fetch_list)
        feed_vals = self._prepare_feed(program.global_block(),
                                       dict(feed or {}))
        self._seed_scope(program, scope)
        analysis = _analyze_program(program)
        _maybe_verify(program, analysis, tuple(feed_vals), tuple(fetch_names),
                      scope=scope)
        with torch.no_grad(), amp_guard(self.amp):
            fetches = self._step(program, analysis, feed_vals, fetch_names,
                                 scope)
        return [self._fetch_value(v, return_numpy) for v in fetches]

    def _seed_scope(self, program, scope):
        if scope.find_var(_RNG_KEY) is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(int(program.random_seed or 0))
            scope.set(_RNG_KEY, g)

    def _step(self, program, analysis, feed_vals, fetch_names, scope):
        """One eager step: bind the scope's free reads and the feeds, run
        block 0, write the scope's names and the persistables back, and
        return the raw fetch values."""
        if _flags.get_flag("obs_op_metrics"):
            _M_STEPS.labels(mode="eager").inc()
        env = {n: scope.find_var(n) for n in analysis.free
               if n not in feed_vals and scope.has_var(n)}
        env.update(feed_vals)
        env[_RNG_KEY] = scope.find_var(_RNG_KEY)
        _run_ops(program.global_block(), env, self.device)
        persistable = analysis.persistable_written
        for n in analysis.written:
            if n in env and (n in persistable or scope.has_var(n)):
                scope.set(n, env[n])
        return [env[n] for n in fetch_names]

    # ------------------------------------------------------------------
    def prepare_steps(self, program=None, feeds=(), fetch_list=None,
                      scope=None, steps=None):
        """Stage a K-step loop (reference :665): every feed leaf (a LoD
        feed's data and lens too) is stacked over the ``feeds`` list and
        put on the executor's device once, with one host-to-device copy
        per leaf; :meth:`run_prepared` then runs the steps. The feed dicts
        must agree in names and shapes. ``steps`` defaults to
        ``len(feeds)``."""
        from ..fluid.framework import default_main_program

        program = program or default_main_program()
        feeds = [dict(f) for f in feeds]
        if not feeds:
            raise ValueError("prepare_steps needs at least one feed dict")
        names = list(feeds[0])
        if any(sorted(f) != sorted(names) for f in feeds):
            raise ValueError("prepare_steps: every feed dict must hold the "
                             "same names")
        steps = int(steps or len(feeds))
        scope = scope or global_scope()
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        stacked = {n: self._stack_feed(block, n, [f[n] for f in feeds])
                   for n in names}
        self._seed_scope(program, scope)
        analysis = _analyze_program(program)
        _maybe_verify(program, analysis, tuple(stacked), tuple(fetch_names),
                      scope=scope)
        return _PreparedSteps(program, stacked, fetch_names, steps,
                              len(feeds), scope)

    def run_prepared(self, prepared, return_numpy=True):
        """Run a :meth:`prepare_steps` handle's K steps (reference :728),
        step ``i`` on staged feed ``i % len(feeds)``: each step is the
        eager step of :meth:`run`, so persistables carry from step to step
        and the scope's generator advances as K ``run()`` calls advance it.
        Returns each fetch stacked over the steps on axis 0."""
        program, scope = prepared.program, prepared.scope
        analysis = _analyze_program(program)
        per_step = []
        with torch.no_grad(), amp_guard(self.amp):
            for i in range(prepared.steps):
                j = i % prepared.n_feeds
                feed_vals = {n: _feed_slice(v, j)
                             for n, v in prepared.stacked.items()}
                per_step.append(self._step(program, analysis, feed_vals,
                                           prepared.fetch_names, scope))
        return [_stack_fetches(list(vals), return_numpy)
                for vals in zip(*per_step)]

    def run_steps(self, program=None, feeds=(), fetch_list=None, scope=None,
                  steps=None, return_numpy=True):
        """``steps`` training steps cycling through ``feeds`` (reference
        :748): :meth:`prepare_steps` then :meth:`run_prepared`. The steps
        equal as many :meth:`run` calls on the same feeds bitwise; the
        feeds cross to the device once."""
        prepared = self.prepare_steps(program, feeds, fetch_list, scope,
                                      steps)
        return self.run_prepared(prepared, return_numpy=return_numpy)

    def _stack_feed(self, block, name, values):
        """One feed name over every staged step, on the device. Dense
        tensors already on the device stack there in their own dtype (as
        :meth:`_prepare_feed` passes them through); everything else stacks
        on the host, is cast to the declared dtype and crosses once."""
        var = block.var(name) if block.has_var(name) else None
        values = [self._as_lod(v, var) for v in values]
        if isinstance(values[0], LoDArray):
            return LoDArray(
                self._stack_leaf([v.data for v in values], var),
                self._stack_leaf([v.lens for v in values], None)
                .to(torch.int32),
                tuple(self._stack_leaf(list(level), None).to(torch.int32)
                      for level in zip(*(v.outer_levels for v in values)))
                or None)
        return self._stack_leaf(values, var)

    def _stack_leaf(self, leaves, var):
        if all(isinstance(t, torch.Tensor) and t.device == self.device
               for t in leaves):
            return torch.stack(leaves)
        host = np.stack([t.cpu().numpy() if isinstance(t, torch.Tensor)
                         else np.asarray(t) for t in leaves])
        return self._dense(host, var)

    def _prepare_feed(self, block, feed):
        """Feeds on the executor's device (reference :863-914). A dense
        tensor already there passes through as it is, in its own dtype, as
        the reference passes a ``jax.Array`` (:871-875): a bfloat16 image
        batch staged on the card stays bfloat16. Any other dense feed
        (numpy, a tensor on another device) is cast to the declared var
        dtype and moved (:910-914), and so is a LoD feed's data. Dense: a
        numpy array or tensor. LoD: a ``LoDArray``, the reference's ``(flat,
        lod offsets)`` tuple, or a list of per-sequence arrays fed to a
        ``lod_level > 0`` var."""
        out = {}
        for name, value in feed.items():
            var = block.var(name) if block.has_var(name) else None
            value = self._as_lod(value, var)
            if isinstance(value, LoDArray):
                out[name] = LoDArray(
                    self._dense(value.data, var),
                    self._to_device(value.lens).to(torch.int32),
                    tuple(self._to_device(o).to(torch.int32)
                          for o in value.outer_levels) or None)
            elif isinstance(value, torch.Tensor) \
                    and value.device == self.device:
                out[name] = value
            else:
                out[name] = self._dense(value, var)
        return out

    @staticmethod
    def _as_lod(value, var):
        """A LoD feed in any of its forms as a LoDArray; anything else as
        it is. A nested list fed to a var of ``lod_level`` L >= 2 is peeled
        exactly L - 1 outer levels deep (reference :884-903), so an empty
        outer group packs as a zero-length entry."""
        if isinstance(value, tuple) and len(value) == 2 \
                and not np.isscalar(value[0]):
            return flat_to_lodarray(value[0], value[1])
        if isinstance(value, list) and value and var is not None \
                and var.lod_level > 0 \
                and isinstance(value[0], (np.ndarray, list)):
            levels, cur = [], value
            if var.lod_level >= 2 and isinstance(value[0], list):
                for _ in range(var.lod_level - 1):
                    if not all(isinstance(g, list) for g in cur):
                        break
                    levels.append(torch.tensor([len(g) for g in cur],
                                               dtype=torch.int32))
                    cur = [s for g in cur for s in g]
            arr = pack_sequences([np.asarray(s) for s in cur])
            arr.outer_lens = tuple(levels) or None
            return arr
        return value

    def _to_device(self, value):
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        return t.to(self.device)

    def _dense(self, value, var):
        t = self._to_device(value)
        if var is not None and var.dtype is not None:
            t = t.to(torch_dtype(var.dtype))
        return t

    @staticmethod
    def _fetch_value(v, return_numpy):
        """A tensor, or a LoDArray (reference :924 hands it to the caller,
        who unpacks it with ``lodarray_to_flat``); numpy on the host unless
        ``return_numpy`` is False. A SparseRows comes back as itself, its
        tensors where they lie (reference :923-926; ``to_dense`` densifies
        it)."""
        if not return_numpy or isinstance(v, SparseRows):
            return v
        if isinstance(v, LoDArray):
            return LoDArray(Executor._fetch_value(v.data, True),
                            v.lens.cpu().numpy(),
                            tuple(o.cpu().numpy() for o in v.outer_levels)
                            or None)
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()  # numpy has no bfloat16 without ml_dtypes
        return v.cpu().numpy()


def _fetch_names(fetch_list):
    return [f if isinstance(f, str) else f.name for f in (fetch_list or [])]


__all__ = ["Executor", "CPUPlace", "CUDAPlace", "resolve_device"]
