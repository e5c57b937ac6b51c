"""Meshes, the sharding plan and the sharded program step (counterpart of
paddle_tpu/parallel/sharding.py).

The reference annotates one jitted step with shardings and lets GSPMD
partition it. PyTorch has no GSPMD: every rank of a ``torch.distributed``
process group runs the same eager op loop on its own shard, and the step
adds the collectives itself, at the points where a partitioned program
needs them, so that with any mesh it computes what the single-device step
computes on the whole batch:

* a feed is split on dim 0 over "dp" (a LoD feed by sequences, its padded
  length kept);
* ``mean`` over batch-sharded values divides the all-reduced sum by the
  all-reduced count, and ``mean_grad`` by that count, so a ragged LoD
  batch gets the global token count, not an average of per-rank means;
* ``reduce_sum`` and ``reduce_mean`` whose axes take in dim 0 of a
  batch-sharded value sum over "dp", ``reduce_mean`` and its grad over
  the global count; ``accuracy`` sums its Correct and Total over "dp";
  the other ops that reduce over the batch (``reduce_max|min|prod``
  there, ``auc``, ``precision_recall``, ``chunk_eval``,
  ``fused_conv2d_bn``) raise;
* ``batch_norm`` in training takes the global batch's statistics (sums
  and counts all-reduced), and ``batch_norm_grad`` the global sums of dY
  and dY·x̂; its Scale/Bias grads stay this rank's share;
* every parameter gradient is summed over "dp" right after the backward
  last writes it, before clipping, decay or the update read it;
* a parameter sharded on its last dim over "tp" (column parallel) is read
  only by ``mul`` (as Y) and ``lookup_table`` (as W): their output is
  all-gathered along its last dim, the grad op takes its shard of dOut,
  ``mul_grad``'s dX is summed over "tp", and dW stays on its shard, as
  does the optimizer's update of it;
* ZeRO-1: an optimizer op whose accumulators are sharded on dim 0 over
  "dp" updates this rank's rows of the parameter (the fused arena kernels
  see only those rows) and the rows are then all-gathered.

Dropout draws its mask from each rank's own generator, so a program with
dropout at a rate above 0 is not the single-device program (the
reference's draws one global mask); the equality tests run rate 0.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from . import collectives as C


class PartitionSpec(tuple):
    """Per-dim mesh axes (``jax.sharding.PartitionSpec``): each entry is
    None, an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """Named axes over the ranks of the default process group. ``devices``
    is the array of global ranks, shaped by the axes; per axis, this rank
    belongs to the group of the ranks that share its other coordinates.
    With no process group initialised the mesh has one rank and its axes
    size 1 (a mesh of more ranks then only plans: its collectives
    raise)."""

    def __init__(self, ranks, axis_names):
        import torch.distributed as dist

        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.devices == self.rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups, self._ranks = {}, {}
        for ax, name in enumerate(self.axis_names):
            moved = np.moveaxis(self.devices, ax, -1)
            for row in moved.reshape(-1, moved.shape[-1]):
                row = [int(r) for r in row]
                # every rank creates every group, in one order
                group = dist.new_group(row) if dist.is_initialized() \
                    else None
                if self.rank in row:
                    self._groups[name], self._ranks[name] = group, row

    def size(self, axis):
        return self.shape.get(axis, 1)

    def group(self, axis):
        """This rank's process group along ``axis`` (None: no such axis,
        or one of size 1 and no process group)."""
        if self.size(axis) > 1 and self._groups.get(axis) is None:
            raise RuntimeError(
                f"mesh axis {axis!r} spans {self.size(axis)} ranks and no "
                "torch.distributed process group is initialised")
        return self._groups.get(axis)

    def ranks(self, axis):
        """The global ranks of this rank's group along ``axis``, in axis
        order."""
        return self._ranks.get(axis, [self.rank])

    # ``with mesh:`` (the reference's jax Mesh is a context that sets the
    # ambient mesh); the port's collectives name their groups, so entering
    # sets nothing
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def index(self, axis):
        """This rank's coordinate along ``axis`` (0 for an absent axis)."""
        if axis not in self.shape:
            return 0
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in this mesh")
        return self.coords[self.axis_names.index(axis)]


def _balanced_shape(n, axes):
    if len(axes) == 1:
        return (n,)
    if len(axes) == 2:
        # balanced dp×tp: the largest tp <= sqrt(n) that divides n
        tp = 1
        for cand in (2, 4, 8, 16):
            if n % cand == 0 and cand * cand <= n:
                tp = cand
        return (n // tp, tp)
    # k axes: prime factors, largest first, each to the smallest axis
    sizes, rem, f, factors = [1] * len(axes), n, 2, []
    while f * f <= rem:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    if rem > 1:
        factors.append(rem)
    for fac in sorted(factors, reverse=True):
        sizes[sizes.index(min(sizes))] *= fac
    return tuple(sizes)


def make_mesh(n_devices=None, axes=("dp",), shape=None, devices=None):
    """A Mesh over the first ``n_devices`` ranks (all of them by default),
    or over the global ranks ``devices``; ``shape`` fixes the per-axis
    sizes, else the reference's balanced split. Every rank of the default
    group must call it, in the same order."""
    import torch.distributed as dist

    if devices is None:
        # with no process group, a mesh of n ranks still plans (specs,
        # shards); its collectives raise (Mesh.group)
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else n_devices or 1)
    ranks = [int(r) for r in devices][:n_devices]
    shape = tuple(shape) if shape is not None \
        else _balanced_shape(len(ranks), axes)
    return Mesh(np.array(ranks).reshape(shape), axes)


# optimizer-accumulator name suffixes (fluid/optimizer.py names them
# "{param}_{acc}"), to make optimizer state follow its param
_ACC_SUFFIX = re.compile(
    r"_(velocity|moment1|moment2|moment|inf_norm|mean_square|momentum_acc"
    r"|avg_squared_grad|avg_squared_update|squared|linear|beta1_pow"
    r"|beta2_pow)(_\d+)?$")


class ShardingPlan:
    """Assigns PartitionSpecs to program variables (reference :70).

    Default policy (overridable per name by ``rules``, (regex, spec)):
      * feed (data) vars: dim 0 sharded over the data axis ("dp");
      * 2-D parameters: the last dim sharded over the model axis ("tp")
        when the mesh has one and the dim divides evenly (tensor
        parallelism); conv filters are never sharded on spatial dims, and
        with ``shard_conv_filters`` their output-channel dim 0 is;
      * optimizer accumulators follow their parameter;
      * with ``shard_opt_state`` (ZeRO-1) accumulators that would be
        replicated shard dim 0 over the data axis;
      * everything else replicated.
    """

    def __init__(self, mesh, data_axis="dp", model_axis="tp", rules=None,
                 shard_params=True, shard_conv_filters=False,
                 shard_opt_state=False):
        self.mesh = mesh
        self.data_axis = data_axis if data_axis in mesh.axis_names else None
        self.model_axis = model_axis if model_axis in mesh.axis_names \
            else None
        self.rules = list(rules or [])
        self.shard_params = shard_params
        self.shard_conv_filters = shard_conv_filters
        self.shard_opt_state = shard_opt_state
        self._tp = mesh.shape.get(model_axis, 1)
        self._dp = mesh.shape.get(data_axis, 1)

    def _base_spec(self, name, shape):
        """The tp spec of a parameter-shaped array (its accumulators of the
        same shape share it)."""
        if not (self.shard_params and self.model_axis and self._tp > 1
                and shape is not None):
            return P()
        if (len(shape) == 2 and shape[-1] % self._tp == 0
                and shape[-1] >= 2 * self._tp):
            return P(None, self.model_axis)
        if (self.shard_conv_filters and len(shape) == 4
                and shape[0] % self._tp == 0 and shape[0] >= 2 * self._tp):
            return P(self.model_axis)
        return P()

    def spec_for_param(self, name, shape, var=None):
        for pat, spec in self.rules:
            if re.search(pat, name):
                return spec
        spec = self._base_spec(name, shape)
        # an accumulator: tagged by the optimizer that made it, or, for a
        # program rebuilt without that tag, named with a known suffix
        is_acc = (getattr(var, "optimizer_accumulator_for", None) is not None
                  or _ACC_SUFFIX.search(name) is not None)
        if (spec == P() and self.shard_opt_state and self.data_axis
                and self._dp > 1 and shape is not None and len(shape) >= 1
                and is_acc
                and shape[0] % self._dp == 0 and shape[0] >= 2 * self._dp):
            return P(*([self.data_axis] + [None] * (len(shape) - 1)))
        return spec

    def spec_for_feed(self, name, shape):
        for pat, spec in self.rules:
            if re.search(pat, name):
                return spec
        if (self.data_axis and shape is not None and len(shape) >= 1
                and shape[0] % self._dp == 0):
            return P(*([self.data_axis] + [None] * (len(shape) - 1)))
        return P()

    # -- serialization --

    @staticmethod
    def _spec_to_list(spec):
        return [list(e) if isinstance(e, (tuple, list)) else e
                for e in spec]

    @staticmethod
    def _spec_from_list(entries):
        if not isinstance(entries, (list, tuple)):
            raise ValueError(f"malformed PartitionSpec entries: {entries!r}")
        out = []
        for e in entries:
            if e is None or isinstance(e, str):
                out.append(e)
            elif isinstance(e, (list, tuple)) \
                    and all(isinstance(a, str) for a in e):
                out.append(tuple(e))
            else:
                raise ValueError(f"malformed PartitionSpec entry: {e!r}")
        return P(*out)

    def to_dict(self):
        """JSON-safe document (reference :162): the mesh as its
        ``make_mesh`` arguments, the axis roles, the rules and the
        switches."""
        return {
            "schema": "pdtpu-sharding-plan-v1",
            "mesh": {"axes": list(self.mesh.axis_names),
                     "shape": list(self.mesh.devices.shape)},
            "data_axis": self.data_axis,
            "model_axis": self.model_axis,
            "rules": [[pat, self._spec_to_list(spec)]
                      for pat, spec in self.rules],
            "shard_params": bool(self.shard_params),
            "shard_conv_filters": bool(self.shard_conv_filters),
            "shard_opt_state": bool(self.shard_opt_state),
        }

    @classmethod
    def from_dict(cls, doc, devices=None):
        """Rebuild a plan from :meth:`to_dict`'s document over this
        process group's ranks (or ``devices``); any violation of the
        schema raises ValueError."""
        if not isinstance(doc, dict) \
                or doc.get("schema") != "pdtpu-sharding-plan-v1":
            raise ValueError("not a pdtpu-sharding-plan-v1 document")
        mesh_doc = doc.get("mesh")
        if not isinstance(mesh_doc, dict) \
                or not isinstance(mesh_doc.get("axes"), (list, tuple)) \
                or not isinstance(mesh_doc.get("shape"), (list, tuple)) \
                or len(mesh_doc["axes"]) != len(mesh_doc["shape"]):
            raise ValueError("malformed sharding-plan mesh (need "
                             "matching axes and shape lists)")
        try:
            shape = tuple(int(d) for d in mesh_doc["shape"])
        except (TypeError, ValueError):
            raise ValueError("malformed sharding-plan mesh shape") from None
        rules_doc = doc.get("rules", [])
        if not isinstance(rules_doc, (list, tuple)):
            raise ValueError("malformed sharding-plan rules")
        rules = []
        for entry in rules_doc:
            if not isinstance(entry, (list, tuple)) or len(entry) != 2 \
                    or not isinstance(entry[0], str):
                raise ValueError(f"malformed sharding-plan rule: {entry!r}")
            rules.append((entry[0], cls._spec_from_list(entry[1])))
        mesh = make_mesh(int(np.prod(shape)),
                         axes=tuple(str(a) for a in mesh_doc["axes"]),
                         shape=shape, devices=devices)
        return cls(mesh,
                   data_axis=doc.get("data_axis") or "dp",
                   model_axis=doc.get("model_axis") or "tp",
                   rules=rules,
                   shard_params=bool(doc.get("shard_params", True)),
                   shard_conv_filters=bool(
                       doc.get("shard_conv_filters", False)),
                   shard_opt_state=bool(doc.get("shard_opt_state", False)))


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_shard(t, spec, mesh):
    """This rank's block of the full tensor ``t`` under ``spec``: each dim
    cut into equal parts over its axes (a multi-axis entry major to
    minor), this rank's part kept."""
    for dim, entry in enumerate(spec):
        for ax in _axes_of(entry):
            n = mesh.size(ax)
            if n > 1:
                t = t.chunk(n, dim=dim)[mesh.index(ax)]
    return t.contiguous()


def unshard(t, spec, mesh):
    """The full tensor from this rank's block under ``spec``: the inverse
    of :func:`local_shard`, gathered over each sharded axis (every rank
    of the mesh must call it)."""
    for dim, entry in reversed(list(enumerate(spec))):
        for ax in reversed(_axes_of(entry)):
            t = C.all_gather(t, dim, mesh.group(ax), mesh.size(ax))
    return t


def place_feed(v, plan, name):
    """This rank's part of one feed value under the plan. A LoDArray (a
    padded ragged feed) is split by sequences: its data [batch, max_len,
    ...], lens [batch] and any outer level take the same rows, and the
    padded length stays the whole batch's."""
    from ..core.lod import LoDArray

    if isinstance(v, LoDArray):
        spec = plan.spec_for_feed(name, tuple(v.data.shape))
        if v.outer_levels and len(spec) and spec[0] is not None:
            raise NotImplementedError(
                f"feed {name!r}: a LoD feed of level 2 or deeper is not "
                "split over the data axis")
        row = P(spec[0]) if len(spec) else P()
        return LoDArray(local_shard(v.data, spec, plan.mesh),
                        local_shard(v.lens, row, plan.mesh))
    return local_shard(v, plan.spec_for_feed(name, tuple(v.shape)),
                       plan.mesh)


def shard_program_step(executor, program, feed_example, fetch_list, plan,
                       scope=None, donate=False):
    """One program block as this rank's step of the sharded program over
    ``plan.mesh`` (reference :263). Returns (fn, state, feeds) where
    ``fn(state, feeds) -> (new_state, fetches)``: state holds this rank's
    shard of every variable the block reads from the scope (and the
    generator), placed by the plan; feeds is this rank's part of
    ``feed_example``. Run it in a loop, carrying state. A replicated fetch
    (the loss) is the whole batch's; a batch-row fetch is this rank's
    rows. ``donate`` is accepted for the reference's signature: the step
    updates the state's tensors in place whatever it says. A set
    ``xla_compiler_options``, which the reference forwards to its
    compiler here, raises when the step is built."""
    from ..core.executor import _check_compiler_options
    from .step import ShardedStep

    _check_compiler_options()

    return ShardedStep(executor, program, feed_example, fetch_list, plan,
                       scope).build()
