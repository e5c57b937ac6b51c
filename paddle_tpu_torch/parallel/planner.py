"""Auto-parallelism placement planner: searched meshes over a measured
cost model, persistently cached plans (counterpart of
paddle_tpu/parallel/planner.py).

The sharding layer (sharding.py, step.py) runs one program over the ranks
of a ``torch.distributed`` group under a mesh and a ``ShardingPlan``; WHICH
mesh to build is a hand decision in each lane (``make_mesh(8, axes=("dp",
"tp"))`` and friends). This module makes it a SEARCH, the placement-level
twin of the kernel tuner's "measure once, dispatch forever"
(ops/autotune.py): enumerate the legal (dp, pp, tp, sp) factorizations of
the device count, cost each one with measured compute plus an analytic
collective model, and emit the winner through ``shard_program_step`` —
bitwise the step a hand-built mesh and plan give.

Four planes:

* **search space** — :func:`enumerate_meshes` yields every legal
  factorization for a Program (or hand-built :class:`ProgramFeatures`)
  and a device count, without a process group (a mesh of n ranks plans
  without one). Legality is derived from the program: tensor parallelism
  needs a 2-D parameter whose output dim the candidate tp shards (the
  exact ``ShardingPlan._base_spec`` rule), pipeline a param-bearing layer
  chain at least ``pp`` deep, sequence parallelism attention ops, expert
  parallelism declared MoE experts.
* **cost model** — :func:`cost_candidate` combines the FLOPs measured by
  ``obs.perf.attribute(..., per_op=True)`` (FlopCounterMode over one
  dispatch of the Program's op loop; a static parameter-shape estimate
  where none was measured) with an analytic collective model: ring
  all-reduce bytes for dp gradients and tp activations, ring KV-passing
  bytes for sp, all-to-all bytes for ep, stage-boundary p2p plus a
  pipeline bubble for pp — into a typed :class:`PlanCost`. Candidates over
  the per-device memory budget are PRUNED with a reason, never ranked. The
  machine rates are the executor's device type's: the card's data-sheet
  figures for ``cuda``, round numbers for ``cpu``.
* **plan API + emission** — :func:`plan` returns a
  :class:`PlacementReport` (ranked candidates, chosen mesh, per-candidate
  costs, why-pruned notes); ``report.apply()`` / :func:`apply_candidate`
  build the mesh and ``ShardingPlan`` with exactly the arguments a hand
  lane passes (``make_mesh(n, axes, shape)``, ``ShardingPlan(mesh,
  **kw)``) over ``n_devices`` ranks of the process group, and emit the
  step through ``shard_program_step``. A pp, sp or ep axis is in the mesh
  and no spec uses it, as in the reference: the step runs replicated
  along it. ``python -m paddle_tpu_torch.tools.plan_parallel`` renders
  the report for a program or a published bundle.
* **persistence** — chosen plans serialize under the ops/autotune
  artifact contract: content-addressed envelope (``MAGIC + sha256hex +
  blob``), full identity fingerprint (program content hash x device count
  x the torch and CUDA versions, the device name and capability, the world
  size x planner flags) in the filename, typed bounded rejects
  (:data:`REJECT_REASONS`) each a ``paddle_tpu_plan_rejects`` bump plus a
  flight event followed by a fresh search, and manifest pinning for
  published ``<version>/plan/`` dirs (``registry.publish/warm(plan=True)``
  certifies ``plan_files`` so replicas place without re-searching). A plan
  the reference wrote (its fingerprint names jax) loads here as a typed
  ``fingerprint`` reject.
"""

from __future__ import annotations

import hashlib
import json
import os

from ..core.flags import get_flag
from ..obs.metrics import REGISTRY as _METRICS
from .sharding import ShardingPlan, make_mesh, shard_program_step

PLAN_DIRNAME = "plan"
ARTIFACT_SUFFIX = ".jplan"
_MAGIC = b"PDTPUPLAN1\n"

# typed bounded reject vocabulary (the ops.autotune shape — a plan is
# only ever read, never executed at load time):
#   format       — bad magic / truncated / bit-flipped payload
#   manifest     — raw bytes not certified by the version manifest
#   fingerprint  — embedded identity != this process's planning identity
#   deserialize  — JSON/schema violations inside a well-formed envelope
REJECT_REASONS = ("format", "manifest", "fingerprint", "deserialize")

_M_SEARCHES = _METRICS.counter(
    "paddle_tpu_plan_searches",
    "placement-plan searches executed (mesh enumeration + cost model "
    "ranking); a cache hit skips the search entirely")
_M_CACHE_HITS = _METRICS.counter(
    "paddle_tpu_plan_cache_hits",
    "placement plans loaded from a persisted artifact instead of "
    "searched (bundle plan/ dir or the plan_cache_dir flag)")
_M_REJECTS = _METRICS.counter(
    "paddle_tpu_plan_rejects",
    "placement-plan artifacts refused at load, by typed reason "
    "(parallel.planner.REJECT_REASONS); every reject falls back to a "
    "fresh search, never a failure",
    labels=("reason",))

# cost-model machine constants, per device type: per-device peak FLOP/s
# and per-device interconnect bytes/s. RELATIVE ranking is what matters
# (every full-use candidate divides the same measured FLOPs by the same
# device count). "cuda" is the card's data sheet (NVIDIA H100 80GB HBM3,
# SXM, 700.00 W power limit): 67 TFLOP/s in float32 outside the tensor
# cores (the port's programs run float32 with TF32 off), and NVLink 4's
# 450 GB/s a direction; a card below 700 W computes slower, which moves
# every candidate's compute term alike. "cpu" only needs comm to be
# expensive relative to compute.
PEAK_FLOPS_S = {"cuda": 6.7e13, "cpu": 5.0e10}
COLLECTIVE_BYTES_S = {"cuda": 4.5e11, "cpu": 2.0e7}

# default microbatch count for the pipeline bubble term
# (bubble = (pp-1)/(micro+pp-1), the GPipe fill/drain fraction)
PIPELINE_MICROBATCHES = 8

# the canonical axis order of every emitted mesh — matches how the
# hand-tuned lanes spell composed meshes (("dp","tp"), ("dp","pp","tp"),
# ("dp","sp")); ep composes after dp like the moe lanes' ("ep",)
_AXIS_ORDER = ("dp", "ep", "pp", "tp", "sp")

# ops that constitute one "layer" of a cuttable pipeline chain —
# param-bearing compute stages a pipeline cut can fall between
_LAYER_OPS = frozenset((
    "mul", "conv2d", "depthwise_conv2d", "fused_conv2d_bn",
    "dynamic_gru", "dynamic_lstm", "embedding", "lookup_table",
))

# ops whose presence makes sequence (ring-attention) parallelism
# meaningful: attention over a sequence axis
_ATTENTION_OPS = frozenset((
    "causal_self_attention", "paged_attention", "chunked_prefill_attention",
))


class PlanError(ValueError):
    """Typed planner failure (no legal candidate, malformed plan doc)."""


def _record(kind, **detail):
    from ..obs.recorder import record as _flight_record
    _flight_record(kind, component="parallel.planner", **detail)


# ---------------------------------------------------------------------------
# program features (the legality + cost inputs)
# ---------------------------------------------------------------------------

class ProgramFeatures:
    """Everything the planner knows about one workload: the legality
    inputs (parameter shapes, layer-chain depth, attention presence, MoE
    expert count, batch/seq) and the cost inputs (measured or estimated
    FLOPs, parameter/activation bytes). Built from a Program by
    :func:`extract_features`; the moe/ring lanes — model functions with
    no fluid Program — construct one directly."""

    def __init__(self, signature="", batch=None, param_shapes=None,
                 layer_chain=0, attention=False, seq_len=None,
                 moe_experts=0, moe_param_bytes=None, flops=None,
                 bytes_accessed=None, dtype_bytes=4):
        self.signature = str(signature)
        self.batch = None if batch is None else int(batch)
        # {name: shape tuple} of persistable parameters
        self.param_shapes = dict(param_shapes or {})
        self.layer_chain = int(layer_chain)
        self.attention = bool(attention)
        self.seq_len = None if seq_len is None else int(seq_len)
        self.moe_experts = int(moe_experts)
        self.dtype_bytes = int(dtype_bytes)
        self.param_bytes = sum(
            self._numel(s) * self.dtype_bytes
            for s in self.param_shapes.values())
        # expert-parallel share of the parameters: the moe lanes' expert
        # stacks; defaults to ALL params when experts are declared but
        # no split is given (a pure-MoE features object)
        self.moe_param_bytes = self.param_bytes if (
            moe_param_bytes is None and self.moe_experts) \
            else int(moe_param_bytes or 0)
        self.flops = None if flops is None else float(flops)
        self.bytes_accessed = None if bytes_accessed is None \
            else float(bytes_accessed)

    @staticmethod
    def _numel(shape):
        n = 1
        for d in shape:
            n *= max(int(d), 1)
        return n

    def tp_shardable_bytes(self, tp):
        """Bytes of 2-D parameters a model axis of size ``tp`` really
        shards — the EXACT ``ShardingPlan._base_spec`` predicate
        (``shape[-1] % tp == 0 and shape[-1] >= 2*tp``), so tp legality
        here means the emitted plan shards something."""
        total = 0
        for s in self.param_shapes.values():
            if (len(s) == 2 and int(s[-1]) % tp == 0
                    and int(s[-1]) >= 2 * tp):
                total += self._numel(s) * self.dtype_bytes
        return total

    def activation_bytes(self):
        """Rough per-step activation footprint: batch x the summed
        input dims of every 2-D parameter (each fc reads one [b, k]
        activation), plus the attention sequence block when present —
        the analytic term the tp/sp collective model scales."""
        b = self.batch or 1
        act = sum(int(s[0]) for s in self.param_shapes.values()
                  if len(s) == 2)
        total = b * act * self.dtype_bytes
        if self.attention and self.seq_len:
            # [b, seq, d_model] with d_model ~ the widest 2-D param out
            d_model = max((int(s[-1])
                           for s in self.param_shapes.values()
                           if len(s) == 2), default=64)
            total += b * self.seq_len * d_model * self.dtype_bytes
        return total

    def flops_estimate(self):
        """Measured FLOPs when attribute() provided them, else the
        static fwd+bwd matmul estimate (6 x batch x param elements)."""
        if self.flops:
            return self.flops
        b = self.batch or 1
        elems = sum(self._numel(s) for s in self.param_shapes.values())
        return 6.0 * b * max(elems, 1)

    def to_doc(self):
        return {
            "signature": self.signature,
            "batch": self.batch,
            "param_shapes": {n: list(s)
                             for n, s in sorted(self.param_shapes.items())},
            "layer_chain": self.layer_chain,
            "attention": self.attention,
            "seq_len": self.seq_len,
            "moe_experts": self.moe_experts,
            "moe_param_bytes": self.moe_param_bytes,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "dtype_bytes": self.dtype_bytes,
        }

    @classmethod
    def from_doc(cls, doc):
        if not isinstance(doc, dict):
            raise ValueError("malformed features document")
        shapes = doc.get("param_shapes", {})
        if not isinstance(shapes, dict):
            raise ValueError("malformed features param_shapes")
        return cls(signature=doc.get("signature", ""),
                   batch=doc.get("batch"),
                   param_shapes={str(n): tuple(int(d) for d in s)
                                 for n, s in shapes.items()},
                   layer_chain=doc.get("layer_chain", 0),
                   attention=doc.get("attention", False),
                   seq_len=doc.get("seq_len"),
                   moe_experts=doc.get("moe_experts", 0),
                   moe_param_bytes=doc.get("moe_param_bytes"),
                   flops=doc.get("flops"),
                   bytes_accessed=doc.get("bytes_accessed"),
                   dtype_bytes=doc.get("dtype_bytes", 4))


def program_signature(program):
    """Stable content hash of one Program: the deterministic IR dump
    (vars sorted, ops in order) — what the plan fingerprint keys on, so
    a structurally different program is a silent filename miss."""
    return hashlib.sha256(
        program.to_debug_string(with_vars=True).encode()).hexdigest()


def _scratch_scope(program, scope):
    """A scope holding copies of what ``program`` reads from ``scope`` (the
    global scope by default): the measured dispatch runs the op loop,
    whose optimizer ops update parameters in place and whose random ops
    advance the generator, and a plan must leave the caller's state as it
    was."""
    import torch

    from ..core.executor import _RNG_KEY
    from ..core.scope import Scope, global_scope

    src = scope if scope is not None else global_scope()
    out = Scope()
    names = {n for b in program.blocks for n in b.vars} | {_RNG_KEY}
    for n in names:
        v = src.find_var(n)
        if isinstance(v, torch.Tensor):
            out.set(n, v.clone())
        elif isinstance(v, torch.Generator):
            g = torch.Generator(device=v.device)
            g.set_state(v.get_state())
            out.set(n, g)
        elif v is not None:
            out.set(n, v)
    return out


def extract_features(program, feed_example=None, fetch_list=None,
                     executor=None, scope=None, moe_experts=0,
                     seq_len=None, measure=True):
    """Walk ``program``'s global block into :class:`ProgramFeatures`:
    parameter shapes from the persistable vars, the layer chain from the
    param-bearing op sequence, attention from the op set, the batch from
    ``feed_example``. With ``measure`` and a feed, the measured FLOPs /
    bytes come from ``obs.perf.attribute(..., per_op=True)`` (one
    dispatch of the op loop under FlopCounterMode, on the executor's
    device); a failed measurement falls back to the static estimate — the
    planner never fails for lack of a profiler."""
    from ..fluid.framework import Parameter

    block = program.global_block()
    param_shapes = {}
    for name in sorted(block.vars):
        v = block.vars[name]
        if isinstance(v, Parameter) and v.shape:
            param_shapes[name] = tuple(int(d) for d in v.shape)
    layer_chain = sum(1 for op in block.ops if op.type in _LAYER_OPS)
    attention = any(op.type in _ATTENTION_OPS for op in block.ops)

    batch = None
    if feed_example:
        for v in feed_example.values():
            s = getattr(v, "shape", None)
            if s is not None and len(s) >= 1:
                batch = int(s[0])
                break
            if isinstance(v, (list, tuple)) and v:
                batch = len(v)
                break
    if attention and seq_len is None and feed_example:
        for v in feed_example.values():
            s = getattr(v, "shape", None)
            if s is not None and len(s) >= 2:
                seq_len = int(s[1])
                break

    flops = bytes_accessed = None
    if measure and feed_example is not None and fetch_list is not None:
        from ..obs import perf
        try:
            res = perf.attribute(program, feed=dict(feed_example),
                                 fetch_list=fetch_list, executor=executor,
                                 scope=_scratch_scope(program, scope),
                                 top=0, per_op=True)
            flops = res["cost"].get("flops")
            bytes_accessed = res["cost"].get("bytes_accessed")
        except Exception as e:
            _record("plan_measure_failed",
                    error=f"{type(e).__name__}: {e}")

    return ProgramFeatures(signature=program_signature(program),
                           batch=batch, param_shapes=param_shapes,
                           layer_chain=layer_chain, attention=attention,
                           seq_len=seq_len, moe_experts=moe_experts,
                           flops=flops, bytes_accessed=bytes_accessed)


# ---------------------------------------------------------------------------
# candidates + cost model
# ---------------------------------------------------------------------------

class PlanCost:
    """Typed cost breakdown of one candidate: modeled seconds of
    per-device compute and collective traffic, per-device memory bytes,
    and the pipeline fill/drain bubble fraction."""

    __slots__ = ("compute_s", "comm_s", "memory_bytes", "bubble_frac")

    def __init__(self, compute_s, comm_s, memory_bytes, bubble_frac=0.0):
        self.compute_s = float(compute_s)
        self.comm_s = float(comm_s)
        self.memory_bytes = int(memory_bytes)
        self.bubble_frac = float(bubble_frac)

    def total_s(self):
        """Modeled step seconds: compute + comm, stretched by the
        pipeline bubble (a stage idles bubble_frac of the step)."""
        return (self.compute_s + self.comm_s) / max(
            1.0 - self.bubble_frac, 1e-9)

    def to_doc(self):
        return {"compute_s": self.compute_s, "comm_s": self.comm_s,
                "memory_bytes": self.memory_bytes,
                "bubble_frac": self.bubble_frac,
                "total_s": self.total_s()}

    @classmethod
    def from_doc(cls, doc):
        if not isinstance(doc, dict):
            raise ValueError("malformed plan cost")
        try:
            return cls(doc["compute_s"], doc["comm_s"],
                       doc["memory_bytes"], doc.get("bubble_frac", 0.0))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed plan cost: {e}") from None

    def __repr__(self):
        return (f"PlanCost(compute={self.compute_s:.3e}s "
                f"comm={self.comm_s:.3e}s mem={self.memory_bytes} "
                f"bubble={self.bubble_frac:.2f})")


class Candidate:
    """One searched placement: a concrete mesh (axes + shape, the exact
    ``make_mesh`` arguments a hand-built lane would pass) plus the
    ``ShardingPlan`` kwargs that materialize it, its cost, and — when
    pruned — why it was never ranked."""

    def __init__(self, sizes, plan_kw=None, cost=None, pruned=None,
                 note=""):
        self.sizes = {a: int(sizes.get(a, 1)) for a in _AXIS_ORDER}
        self.plan_kw = dict(plan_kw or {})
        self.cost = cost
        self.pruned = pruned
        self.note = str(note)

    @property
    def axes(self):
        axes = tuple(a for a in _AXIS_ORDER if self.sizes[a] > 1)
        return axes or ("dp",)

    @property
    def shape(self):
        return tuple(self.sizes[a] for a in self.axes)

    @property
    def n_devices(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    def describe(self):
        body = "x".join(f"{a}{self.sizes[a]}" for a in self.axes)
        kw = ",".join(f"{k}={v}" for k, v in sorted(self.plan_kw.items()))
        return body + (f" [{kw}]" if kw else "")

    def build(self, devices=None):
        """-> ``(mesh, ShardingPlan)`` constructed exactly as a hand
        lane constructs them (same make_mesh arguments, same plan
        kwargs) — the bitwise-equality contract of ``apply``. Every rank
        of the process group calls it, in the same order; without a group
        the mesh only plans (its collectives raise)."""
        mesh = make_mesh(self.n_devices, axes=self.axes, shape=self.shape,
                         devices=devices)
        return mesh, ShardingPlan(mesh, **self.plan_kw)

    def to_doc(self):
        return {"sizes": {a: s for a, s in self.sizes.items() if s > 1},
                "plan_kw": dict(self.plan_kw),
                "cost": None if self.cost is None else self.cost.to_doc(),
                "pruned": self.pruned,
                "note": self.note}

    @classmethod
    def from_doc(cls, doc):
        if not isinstance(doc, dict) \
                or not isinstance(doc.get("sizes"), dict):
            raise ValueError("malformed plan candidate")
        sizes = {}
        for a, s in doc["sizes"].items():
            if a not in _AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {a!r} in candidate")
            sizes[a] = int(s)
        pruned = doc.get("pruned")
        if pruned is not None and not isinstance(pruned, str):
            raise ValueError("malformed candidate pruned reason")
        kw = doc.get("plan_kw", {})
        if not isinstance(kw, dict):
            raise ValueError("malformed candidate plan_kw")
        cost = doc.get("cost")
        return cls(sizes, plan_kw=kw,
                   cost=None if cost is None else PlanCost.from_doc(cost),
                   pruned=pruned, note=doc.get("note", ""))


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_meshes(target, n_devices, moe_experts=None):
    """Every legal full-device-count factorization for ``target`` (a
    Program or :class:`ProgramFeatures`): (dp, pp, tp, sp) products plus
    (dp, ep) products when MoE experts are declared, each as a
    :class:`Candidate` whose ``build()`` materializes the concrete mesh
    + ShardingPlan. Legality is per-axis:

    * dp — the feed batch (when known) splits evenly;
    * tp — some 2-D parameter's output dim really shards at this tp
      (the ``ShardingPlan._base_spec`` predicate);
    * pp — the param-bearing layer chain is at least ``pp`` deep;
    * sp — the program has attention ops and the sequence length (when
      known) splits evenly;
    * ep — declared MoE experts split evenly.

    dp>1 candidates additionally spawn a ZeRO-1 variant
    (``shard_opt_state=True``) — same mesh, optimizer state sharded over
    dp, strictly less memory at equal modeled step cost."""
    f = target if isinstance(target, ProgramFeatures) \
        else extract_features(target, measure=False,
                              moe_experts=moe_experts or 0)
    if moe_experts is not None:
        f.moe_experts = int(moe_experts)
    n = int(n_devices)
    if n < 1:
        raise PlanError(f"n_devices must be >= 1, got {n}")

    def dp_ok(dp):
        return dp == 1 or f.batch is None \
            or (f.batch % dp == 0 and f.batch >= dp)

    out, seen = [], set()

    def add(sizes, plan_kw=None):
        key = (tuple(sorted((a, s) for a, s in sizes.items() if s > 1)),
               tuple(sorted((plan_kw or {}).items())))
        if key in seen:
            return
        seen.add(key)
        out.append(Candidate(sizes, plan_kw=plan_kw))

    for dp in _divisors(n):
        if not dp_ok(dp):
            continue
        rem = n // dp
        for pp in _divisors(rem):
            if pp > 1 and f.layer_chain < pp:
                continue
            rem2 = rem // pp
            for tp in _divisors(rem2):
                if tp > 1 and not f.tp_shardable_bytes(tp):
                    continue
                sp = rem2 // tp
                if sp > 1 and not (f.attention and (
                        f.seq_len is None or f.seq_len % sp == 0)):
                    continue
                sizes = {"dp": dp, "pp": pp, "tp": tp, "sp": sp}
                add(sizes)
                if dp > 1:
                    add(sizes, plan_kw={"shard_opt_state": True})
        # expert parallelism: (dp, ep) products over declared experts
        if f.moe_experts:
            ep = n // dp
            if ep > 1 and f.moe_experts % ep == 0:
                add({"dp": dp, "ep": ep})
    if not out:
        raise PlanError(
            f"no legal mesh for {n} devices (batch={f.batch}): even "
            "pure data parallelism cannot split this feed")
    return f, out


def _device(executor=None):
    """The device a plan is for: the executor's, else the card where one
    is present, else the CPU."""
    import torch

    if executor is not None:
        return torch.device(executor.device)
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def _device_count(device):
    """Devices to plan over by default: the process group's world size,
    else the visible cards (a CUDA device), else 1."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if device.type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def _machine_rates(device=None):
    """(peak FLOP/s, collective bytes/s) of ``device``'s type (the card's
    or the CPU's)."""
    import torch

    kind = (_device(None) if device is None else torch.device(device)).type
    return (PEAK_FLOPS_S.get(kind, PEAK_FLOPS_S["cpu"]),
            COLLECTIVE_BYTES_S.get(kind, COLLECTIVE_BYTES_S["cpu"]))


def cost_candidate(features, cand, microbatches=None, comm_scale=1.0,
                   rates=None):
    """Cost one candidate: measured compute split over every shard,
    analytic collective seconds per parallel axis, per-device memory,
    pipeline bubble. ``comm_scale`` multiplies every modeled collective
    byte (the monotonicity probe: scaling it up must never improve a
    candidate's rank); ``rates`` overrides ``(flops_s, bytes_s)``, else
    the default device's (:func:`_machine_rates`)."""
    f, s = features, cand.sizes
    dp, ep, pp, tp, sp = (s[a] for a in _AXIS_ORDER)
    shards = dp * ep * pp * tp * sp
    flops_s, bytes_s = rates or _machine_rates()

    compute_s = f.flops_estimate() / shards / flops_s

    dtype_b = f.dtype_bytes
    shard_b = f.tp_shardable_bytes(tp) if tp > 1 else 0
    dense_b = f.param_bytes - shard_b
    moe_b = min(f.moe_param_bytes, dense_b) if ep > 1 else 0
    # per-device gradient bytes after the model-axis splits: tp shards
    # the shardable 2-D params, pp splits the layer chain across
    # stages, ep shards the expert stacks
    grad_b = ((dense_b - moe_b) + moe_b / ep + shard_b / tp) / pp
    act_b = f.activation_bytes() / max(dp, 1)

    comm = 0.0
    if dp > 1:
        # ring all-reduce of the per-device gradients over dp
        comm += 2.0 * (dp - 1) / dp * grad_b
    if tp > 1:
        # Megatron-style activation all-reduce per tp-sharded layer pair
        comm += 2.0 * (tp - 1) / tp * act_b
    if sp > 1:
        # ring attention: each device passes its KV block around the ring
        comm += 2.0 * (sp - 1) / sp * act_b
    if ep > 1:
        # token all-to-all into and out of the expert shards
        comm += 2.0 * (ep - 1) / ep * act_b
    bubble = 0.0
    if pp > 1:
        # stage-boundary activations, p2p both directions (fwd + bwd)
        comm += 2.0 * (pp - 1) * act_b / max(tp * sp, 1)
        micro = int(microbatches or PIPELINE_MICROBATCHES)
        bubble = (pp - 1) / float(micro + pp - 1)
    comm_s = comm * float(comm_scale) / bytes_s

    # per-device memory: params + grads + optimizer state (~3x params;
    # ZeRO-1 shards the optimizer copy over dp) + activations (sharded
    # by dp and, for attention blocks, sp)
    params_dev = (dense_b - moe_b) / pp + moe_b / ep + shard_b / (tp * pp)
    opt_copies = 2.0 + (1.0 / dp if cand.plan_kw.get("shard_opt_state")
                        else 1.0)
    mem = params_dev * opt_copies + f.activation_bytes() / (dp * sp)
    # keep dtype_b referenced for subclass overrides of activation math
    del dtype_b
    return PlanCost(compute_s, comm_s, mem, bubble)


# ---------------------------------------------------------------------------
# fingerprint + report
# ---------------------------------------------------------------------------

def plan_fingerprint(signature, n_devices, device=None):
    """Identity a plan is valid for: format/schema + toolchain (the torch
    and CUDA versions) + the device's name and capability + the process
    group's world size + DEVICE COUNT + the program's content hash + the
    planner flags that shape the search. Anything else different is a
    filename miss; a doctored (or the reference's) artifact is a typed
    ``fingerprint`` reject."""
    import torch
    import torch.distributed as dist

    dev = _device(None) if device is None else torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev.index or 0)
        cap = list(torch.cuda.get_device_capability(dev.index or 0))
    else:
        name, cap = dev.type, None
    world = dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1
    return {
        "format": 1,
        "kind": "placement_plan",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": name,
        "capability": cap,
        "world_size": int(world),
        "n_devices": int(n_devices),
        "program": str(signature),
        "flags": {
            "plan_memory_budget_bytes":
                int(get_flag("plan_memory_budget_bytes")),
            "plan_max_candidates": int(get_flag("plan_max_candidates")),
        },
    }


def fingerprint_key(fp):
    """Stable digest of a fingerprint dict (the artifact filename key)."""
    return hashlib.sha256(
        json.dumps(fp, sort_keys=True, default=str).encode()).hexdigest()


class PlacementReport:
    """The search result: ranked candidates (cheapest modeled step
    first), the pruned set with why-pruned notes, and the identity
    fingerprint the report was computed under."""

    def __init__(self, fingerprint, candidates, n_devices, dropped=0,
                 from_cache=False):
        self.fingerprint = dict(fingerprint)
        self.candidates = list(candidates)
        self.n_devices = int(n_devices)
        self.dropped = int(dropped)
        self.from_cache = bool(from_cache)

    def ranked(self):
        return [c for c in self.candidates if c.pruned is None]

    def pruned(self):
        return [c for c in self.candidates if c.pruned is not None]

    @property
    def chosen(self):
        r = self.ranked()
        return r[0] if r else None

    def candidate(self, **sizes):
        """The ranked candidate with exactly these axis sizes (axes not
        named must be 1), or None — how a lane finds its naive-all-dp
        baseline row in the report."""
        want = {a: int(sizes.get(a, 1)) for a in _AXIS_ORDER}
        for c in self.ranked():
            if c.sizes == want and not c.plan_kw:
                return c
        return None

    def apply(self, executor, program, feed_example, fetch_list,
              scope=None, donate=False, devices=None):
        """Emit the chosen placement through ``shard_program_step`` —
        bitwise the step a hand-built mesh/ShardingPlan produces."""
        if self.chosen is None:
            raise PlanError(
                "no candidate survived pruning "
                f"({len(self.pruned())} pruned: "
                f"{sorted({c.pruned for c in self.pruned()})}); raise "
                "plan_memory_budget_bytes or shrink the model")
        return apply_candidate(self.chosen, executor, program,
                               feed_example, fetch_list, scope=scope,
                               donate=donate, devices=devices)

    def to_doc(self):
        return {
            "schema": "pdtpu-plan-v1",
            "fingerprint": dict(self.fingerprint),
            "n_devices": self.n_devices,
            "dropped": self.dropped,
            "candidates": [c.to_doc() for c in self.candidates],
        }

    @classmethod
    def from_doc(cls, doc):
        """Strict schema validation — any violation raises ValueError
        (the store's ``deserialize`` reject)."""
        if not isinstance(doc, dict) \
                or doc.get("schema") != "pdtpu-plan-v1":
            raise ValueError("not a pdtpu-plan-v1 document")
        fp = doc.get("fingerprint")
        cands = doc.get("candidates")
        if not isinstance(fp, dict) or not isinstance(cands, list):
            raise ValueError("malformed placement-plan document")
        try:
            n = int(doc["n_devices"])
        except (KeyError, TypeError, ValueError):
            raise ValueError("malformed placement-plan n_devices") \
                from None
        return cls(fp, [Candidate.from_doc(c) for c in cands], n,
                   dropped=int(doc.get("dropped", 0)))

    def digest(self):
        return hashlib.sha256(
            json.dumps(self.to_doc(), sort_keys=True).encode()).hexdigest()

    def render(self):
        """Human-readable ranking table (tools/plan_parallel.py and
        chip_smoke.py's planner phase)."""
        lines = [f"placement plan over {self.n_devices} devices "
                 f"({'cache' if self.from_cache else 'searched'}):"]
        for i, c in enumerate(self.ranked()):
            cost = c.cost
            mark = "->" if i == 0 else "  "
            lines.append(
                f" {mark} {c.describe():28s} total={cost.total_s():.3e}s "
                f"compute={cost.compute_s:.3e}s comm={cost.comm_s:.3e}s "
                f"mem={cost.memory_bytes / 1e6:.1f}MB "
                f"bubble={cost.bubble_frac:.2f}")
        for c in self.pruned():
            mem = "" if c.cost is None \
                else f" mem={c.cost.memory_bytes / 1e6:.1f}MB"
            lines.append(f"  x {c.describe():28s} pruned: {c.pruned}"
                         f"{mem} {c.note}".rstrip())
        if self.dropped:
            lines.append(f"  ({self.dropped} further candidates dropped "
                         "past plan_max_candidates)")
        return "\n".join(lines)


def apply_candidate(cand, executor, program, feed_example, fetch_list,
                    scope=None, donate=False, devices=None):
    """Materialize one candidate and compile the sharded step through
    the existing ``shard_program_step`` path. The mesh and ShardingPlan
    are constructed with exactly the arguments a hand-built lane passes
    (``make_mesh(n, axes, shape)`` + ``ShardingPlan(mesh, **kw)``), so
    the step — and every loss it fetches — is bitwise equal to the
    hand-built plan. The step needs ``cand.n_devices`` ranks: the process
    group's (or ``devices``), one rank without a group."""
    import torch.distributed as dist

    have = len(devices) if devices is not None else (
        dist.get_world_size()
        if dist.is_available() and dist.is_initialized() else 1)
    if have < cand.n_devices:
        raise PlanError(
            f"candidate {cand.describe()} needs {cand.n_devices} ranks; "
            f"this process group has {have} (a plan for more devices "
            "applies only on a group of that many ranks)")
    mesh, sharding_plan = cand.build(devices=devices)
    fn, state, feeds = shard_program_step(
        executor, program, feed_example, fetch_list, sharding_plan,
        scope=scope, donate=donate)
    return fn, state, feeds, sharding_plan


# ---------------------------------------------------------------------------
# persistence (the ops/autotune artifact contract)
# ---------------------------------------------------------------------------

class PlanStore:
    """One directory of placement-plan artifacts under the autotune /
    execcache discipline: content-addressed envelope, identity in the
    filename, typed bounded rejects, optional manifest pinning,
    tmp+replace writes. ``load`` and ``save`` never raise — a broken
    plan must only ever cost the fresh search it failed to replace."""

    def __init__(self, path, readonly=False, expected_digests=None):
        self.path = str(path)
        self.readonly = bool(readonly)
        self._expected = None if expected_digests is None \
            else dict(expected_digests)
        if not self.readonly:
            os.makedirs(self.path, exist_ok=True)
        self._touched = set()

    def artifact_path(self, fp):
        return os.path.join(
            self.path, f"plan-{fingerprint_key(fp)[:40]}{ARTIFACT_SUFFIX}")

    def note_reject(self, reason, error=None):
        if reason not in REJECT_REASONS:
            reason = "deserialize"
        _M_REJECTS.labels(reason=reason).inc()
        _record("plan_reject", dir=self.path, reason=reason,
                error=None if error is None
                else f"{type(error).__name__}: {error}")

    def load(self, fp):
        """The report for this planning identity, or None (miss or
        typed reject — the caller searches fresh). A missing file is a
        silent miss; everything else wrong is a counted reject."""
        path = self.artifact_path(fp)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        stage = "format"
        try:
            if self._expected is not None:
                # manifest pinning: raw bytes must be exactly what the
                # version manifest certifies, BEFORE any parsing
                stage = "manifest"
                want = self._expected.get(os.path.basename(path))
                if want is None:
                    raise ValueError("artifact is not listed in the "
                                     "version manifest's plan_files")
                if hashlib.sha256(raw).hexdigest() != want:
                    raise ValueError("artifact bytes do not match the "
                                     "manifest's plan_files digest")
                stage = "format"
            if not raw.startswith(_MAGIC):
                raise ValueError("bad magic (not a placement-plan "
                                 "artifact)")
            header_end = raw.index(b"\n", len(_MAGIC))
            digest = raw[len(_MAGIC):header_end].decode("ascii")
            blob = raw[header_end + 1:]
            if hashlib.sha256(blob).hexdigest() != digest:
                raise ValueError("payload digest mismatch (truncated or "
                                 "bit-flipped artifact)")
            stage = "deserialize"
            report = PlacementReport.from_doc(
                json.loads(blob.decode("utf-8")))
            stage = "fingerprint"
            if report.fingerprint != fp:
                raise ValueError("plan fingerprint does not match this "
                                 "process's planning identity")
        except Exception as e:
            self.note_reject(stage, error=e)
            return None
        self._touched.add(os.path.basename(path))
        report.from_cache = True
        return report

    def save(self, report):
        """Persist one report (tmp + ``os.replace``); returns the
        artifact path, or None when read-only / unwritable."""
        if self.readonly:
            return None
        try:
            blob = json.dumps(report.to_doc(), sort_keys=True).encode()
            data = (_MAGIC + hashlib.sha256(blob).hexdigest().encode()
                    + b"\n" + blob)
            path = self.artifact_path(report.fingerprint)
            tmp = path + f".{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except Exception as e:
            _record("plan_save_failed", dir=self.path,
                    error=f"{type(e).__name__}: {e}")
            return None
        self._touched.add(os.path.basename(path))
        return path

    def touched(self):
        return sorted(self._touched)


def manifest_plan_digests(model_dir):
    """basename -> sha256 pin set from the version manifest's
    ``plan_files``; manifest without the field pins the empty set; no
    readable manifest returns None (a raw export — the artifact
    self-digest is the only integrity layer)."""
    try:
        with open(os.path.join(model_dir, "VERSION.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return {os.path.basename(rel): digest
            for rel, digest in manifest.get("plan_files", {}).items()}


def resolve_store(model_dir=None):
    """The store a planning site should consult: the bundle's published
    ``plan/`` dir (read-only, manifest-pinned) when it exists, else the
    ``plan_cache_dir`` flag's local READ-WRITE cache (a fresh search
    persists there so the next process loads), else None."""
    if model_dir:
        pdir = os.path.join(str(model_dir), PLAN_DIRNAME)
        if os.path.isdir(pdir):
            return PlanStore(pdir, readonly=True,
                             expected_digests=manifest_plan_digests(
                                 str(model_dir)))
    local = get_flag("plan_cache_dir")
    if local:
        return PlanStore(local)
    return None


# ---------------------------------------------------------------------------
# the planner entry point
# ---------------------------------------------------------------------------

def plan(program, feed_example=None, n_devices=None, fetch_list=None,
         executor=None, scope=None, features=None, moe_experts=0,
         seq_len=None, memory_budget=None, max_candidates=None,
         microbatches=None, store=None, model_dir=None, measure=True,
         rates=None):
    """Search the legal meshes for ``program`` over ``n_devices`` and
    return a ranked :class:`PlacementReport`.

    ``program`` may be a fluid Program (features are extracted, and with
    a ``feed_example`` + ``fetch_list`` the compute term is MEASURED via
    ``obs.perf.attribute``) or a :class:`ProgramFeatures` describing a
    workload without a Program (the moe/ring lanes). ``n_devices``
    defaults to the process group's world size, else the visible cards
    (or 1 on the CPU); ``rates`` overrides the device's ``(flops_s,
    bytes_s)``. ``memory_budget`` /
    ``max_candidates`` default from the ``plan_memory_budget_bytes`` /
    ``plan_max_candidates`` flags; candidates over budget are pruned
    with a note, never ranked. ``store`` (or the store resolved from
    ``model_dir`` / the ``plan_cache_dir`` flag) is consulted first —
    a fingerprint-matching artifact skips the search entirely
    (``paddle_tpu_plan_cache_hits``); any corrupt artifact is a typed
    reject plus a fresh search, never a failure."""
    device = _device(executor)
    n = int(n_devices) if n_devices else _device_count(device)
    if rates is None:
        rates = _machine_rates(device)
    if features is None and isinstance(program, ProgramFeatures):
        features = program
    if features is None:
        features = extract_features(program, feed_example=feed_example,
                                    fetch_list=fetch_list,
                                    executor=executor, scope=scope,
                                    moe_experts=moe_experts,
                                    seq_len=seq_len, measure=measure)
    fp = plan_fingerprint(features.signature, n, device=device)

    if store is None:
        store = resolve_store(model_dir)
    if store is not None:
        cached = store.load(fp)
        if cached is not None:
            _M_CACHE_HITS.labels().inc()
            _record("plan_cache_hit", dir=store.path, n_devices=n,
                    chosen=None if cached.chosen is None
                    else cached.chosen.describe())
            return cached

    _M_SEARCHES.labels().inc()
    budget = int(get_flag("plan_memory_budget_bytes")
                 if memory_budget is None else memory_budget)
    cap = int(get_flag("plan_max_candidates")
              if max_candidates is None else max_candidates)

    features, candidates = enumerate_meshes(features, n,
                                            moe_experts=moe_experts
                                            or None)
    for c in candidates:
        c.cost = cost_candidate(features, c, microbatches=microbatches,
                                rates=rates)
        if budget > 0 and c.cost.memory_bytes > budget:
            c.pruned = "memory_budget"
            c.note = (f"per-device {c.cost.memory_bytes} B > budget "
                      f"{budget} B")
    # rank the survivors: cheapest modeled step, then least memory, then
    # the simplest mesh — deterministic across runs
    ranked = sorted((c for c in candidates if c.pruned is None),
                    key=lambda c: (c.cost.total_s(), c.cost.memory_bytes,
                                   len(c.axes), c.describe()))
    pruned = [c for c in candidates if c.pruned is not None]
    dropped = max(0, len(ranked) - cap) if cap > 0 else 0
    if dropped:
        ranked = ranked[:cap]
    report = PlacementReport(fp, ranked + pruned, n, dropped=dropped)
    _record("plan_search", n_devices=n, candidates=len(candidates),
            pruned=len(pruned), dropped=dropped,
            chosen=None if report.chosen is None
            else report.chosen.describe())
    if store is not None and not store.readonly:
        store.save(report)
    return report


__all__ = [
    "ARTIFACT_SUFFIX", "Candidate", "PLAN_DIRNAME", "PlanCost",
    "PlanError", "PlanStore", "PlacementReport", "ProgramFeatures",
    "REJECT_REASONS", "apply_candidate", "cost_candidate",
    "enumerate_meshes", "extract_features", "fingerprint_key",
    "manifest_plan_digests", "plan", "plan_fingerprint",
    "program_signature", "resolve_store",
]
