"""Pipeline parallelism: a GPipe microbatch pipeline over a "pp" mesh
axis (counterpart of paddle_tpu/parallel/pipeline.py).

S stages, one a rank of the axis: stage s holds its slice of the
stage-stacked parameters (``shard_pipeline_params``). M microbatches
stream through a shift register of activations: each of the M + S - 1
ticks every stage runs ``stage_fn`` on its input and passes the result to
the next rank of the ring (stage 0 takes the next microbatch instead),
and the last stage collects the finished one; the outputs are then summed
over the axis with every other stage's masked to zero, so every rank
holds them. Bubble ticks compute on zeros, as the reference's. The
backward comes from autograd through the exchanges
(``collectives.ppermute_ad``, ``psum_ad``), and every rank builds the same
graph, so every rank makes the same exchanges in the same order.

``stage_fn(stage_params, x) -> y`` keeps x's shape. ``data_spec`` and
``param_specs`` are the reference's composition hooks: under
P(None, "dp") each dp group pipelines its own part of every microbatch
(the caller passes that part), and tensor-sharded stage weights come in
through ``stacked_params`` already cut (the stage_fn sums its partial
products over "tp", ``psum_ad``).
"""

from __future__ import annotations

import torch

from .collectives import ppermute_ad, psum_ad


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_pipeline_params(stacked_params, mesh, axis="pp"):
    """This rank's stage slice [1, ...] of every [S, ...] leaf."""
    s = mesh.index(axis)
    return _tree_map(lambda a: a[s:s + 1].contiguous(), stacked_params)


def pipeline_apply(stage_fn, stacked_params, microbatches, mesh, axis="pp",
                   data_spec=None, param_specs=None):
    """Run ``microbatches`` [M, mb, ...] through the S pipelined stages;
    ``stacked_params`` are this rank's [1, ...] stage slices. Returns the
    [M, mb, ...] outputs on every rank of the axis."""
    n_stages = mesh.size(axis)
    for leaf in _leaves(stacked_params):
        if leaf.shape[0] != 1:
            raise ValueError(
                f"stacked_params leading dim {leaf.shape[0]} must be this "
                f"rank's one stage of the {axis!r} axis's {n_stages} "
                "(shard_pipeline_params cuts it)")
    dspec = tuple(data_spec) if data_spec is not None else ()
    if len(dspec) >= 1 and dspec[0] is not None:
        raise ValueError(
            f"data_spec {dspec} must not partition the leading microbatch "
            "dim; shard the per-microbatch batch dim (e.g. P(None, 'dp'))")
    local = _tree_map(lambda a: a[0], stacked_params)
    stage = mesh.index(axis)
    ranks, group = mesh.ranks(axis), mesh.group(axis)
    m = microbatches.shape[0]
    mb_shape = microbatches.shape[1:]
    zeros = microbatches.new_zeros(mb_shape)
    first = torch.tensor(stage == 0, device=microbatches.device)
    buf, outs = zeros, [None] * m
    for t in range(m + n_stages - 1):
        inject = microbatches[t] if t < m else zeros
        y = stage_fn(local, torch.where(first, inject, buf))
        done = t - (n_stages - 1)
        if done >= 0:
            outs[done] = y
        buf = ppermute_ad(y, ranks, stage, 1, group)
    keep = 1.0 if stage == n_stages - 1 else 0.0
    return psum_ad(torch.stack(outs) * keep, group)


def pipeline_stack_reference(stage_fn, stacked_params, microbatches):
    """Sequential reference: every stage folded over every microbatch."""
    s = _leaves(stacked_params)[0].shape[0]
    outs = []
    for x in microbatches:
        for i in range(s):
            x = stage_fn(_tree_map(lambda a: a[i], stacked_params), x)
        outs.append(x)
    return torch.stack(outs)
