"""The collectives the parallel modules use, over ``torch.distributed``
process groups: the counterparts of the reference's ``lax.psum``,
``lax.ppermute``, ``lax.all_gather`` and GSPMD's all-to-all.

Each takes the mesh axis's group and its ranks (``Mesh.group(axis)``,
``Mesh.ranks(axis)``). Where no process group is initialised the axis
has one member and each collective is the identity, so one process runs
the parallel modules unchanged. Where a group is initialised every call
goes through it, a one-rank group included, so a one-card NCCL run makes
every collective call the many-card run makes.

Autograd. The ``*_ad`` forms are ``torch.autograd.Function``s with the
transposes the reference gets from JAX, under JAX's SPMD convention that
a replicated value is ONE logical value whose cotangent every rank holds
in full:

* ``psum_ad``: forward the sum over the axis; backward the cotangent
  unchanged (each rank's addend gets the replicated sum's cotangent).
* ``pcopy_ad``: forward the identity; backward the sum over the axis
  (Megatron's "f": a value replicated over the axis that feeds
  rank-specific work, as the input of a column-parallel matmul, collects
  its cotangent from every rank);
* ``ppermute_ad``: forward the shift to the next rank of the ring;
  backward the shift back.
* ``all_to_all_ad``: forward chunk j to rank j; backward the same
  exchange of the cotangent's chunks.

A loss that every rank computes from replicated values is then that one
loss, and ``loss.backward()`` on every rank gives each rank the gradient
of its own inputs; a parameter replicated over an axis whose ranks saw
different data sums its gradient over that axis (``all_reduce``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _live(group):
    return group is not None and dist.is_initialized()


def all_reduce(t, group):
    """The sum of ``t`` over the group's ranks (a new tensor)."""
    out = t.contiguous().clone()
    if _live(group):
        dist.all_reduce(out, group=group)
    return out


def all_max(t, group):
    """The elementwise max of ``t`` over the group's ranks (a new tensor)."""
    out = t.contiguous().clone()
    if _live(group):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(t, dim, group, size):
    """The group's ``t`` joined along ``dim`` in rank order."""
    if not _live(group):
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def ppermute(t, ranks, me, shift=1, group=None):
    """Ring shift: this rank (index ``me`` of the group's global ``ranks``)
    sends ``t`` to index ``me + shift`` and returns what index ``me -
    shift`` sent (``lax.ppermute`` with the ring permutation)."""
    n = len(ranks)
    if n == 1 or not dist.is_initialized():
        return t.clone()
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_to_all(t, group, size):
    """Chunk j of ``t``'s dim 0 (of ``size`` equal chunks) goes to rank j
    of the group; returns the received chunks in rank order, joined on
    dim 0."""
    if not _live(group):
        return t.clone()
    chunks = [c.contiguous() for c in t.chunk(size, dim=0)]
    out = [torch.empty_like(c) for c in chunks]
    # one exchange with each other rank, in turn: gloo has no all_to_all
    # in every torch release the port runs on (2.11's raises), and NCCL
    # runs the same pairwise exchange
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    out[me].copy_(chunks[me])
    for step in range(1, size):
        to, frm = (me + step) % size, (me - step) % size
        ops = [dist.P2POp(dist.isend, chunks[to], ranks[to], group),
               dist.P2POp(dist.irecv, out[frm], ranks[frm], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat(out, dim=0)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ranks, me, shift, group):
        ctx.args = (ranks, me, shift, group)
        return ppermute(t, ranks, me, shift, group)

    @staticmethod
    def backward(ctx, g):
        ranks, me, shift, group = ctx.args
        return ppermute(g, ranks, me, -shift, group), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, size):
        ctx.args = (group, size)
        return all_to_all(t, group, size)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, *ctx.args), None, None


def psum_ad(t, group):
    return _PSum.apply(t, group)


def pcopy_ad(t, group):
    return _PCopy.apply(t, group)


def ppermute_ad(t, ranks, me, shift=1, group=None):
    return _PPermute.apply(t, tuple(ranks), me, shift, group)


def all_to_all_ad(t, group, size):
    return _AllToAll.apply(t, group, size)
