"""Ring attention: the sequence axis sharded over a mesh axis ("sp")
(counterpart of paddle_tpu/parallel/ring_attention.py).

Each rank keeps its Q block and passes its K/V block around the ring of
the axis's ranks; every hop folds the held block into an online
(flash-style) softmax whose carry ``(m, l, acc)`` is float32. Under
``causal`` a block that lies wholly in the future of this rank's queries
is skipped. K and V travel as one stacked tensor, so every rank makes the
same sequence of point-to-point exchanges in the forward and, through
autograd (``collectives.ppermute_ad``: the backward shifts the cotangent
back), in the backward.

API: ``ring_attention(q, k, v, mesh, axis="sp", causal=False,
batch_axis=None)`` takes THIS rank's blocks [batch, seq/sp, heads,
head_dim] (``local_block`` cuts them from the whole tensors) and returns
this rank's block of the output. ``batch_axis`` composes it with data
parallelism: the batch rows are split over that axis and the ring runs
within each of its slices. ``full_attention`` is the single-device check.
"""

from __future__ import annotations

import torch

from .collectives import ppermute_ad
from .sharding import P, local_shard


def _block_attention(q, k, v, m_prev, l_prev, acc_prev, mask=None):
    """One K/V block's contribution under online softmax (reference :36).
    q [b, sq, h, d], k/v [b, sk, h, d]; m/l [b, h, sq]; acc [b, sq, h, d]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))
    # a fully masked row keeps -inf maxima: exp(-inf - -inf) would be nan
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    correction = torch.where(torch.isneginf(m_prev), 0.0,
                             torch.exp(m_prev - safe_m))
    l_new = correction * l_prev + p.sum(dim=-1)
    acc_new = (acc_prev * correction.transpose(1, 2)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, v))
    return m_new, l_new, acc_new


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``t`` made one of its inputs (zero
    cotangent): every rank's backward then reaches every exchange of the
    ring, a rank whose causal blocks were all skipped included, so no
    rank waits on a peer that never sends."""

    @staticmethod
    def forward(ctx, out, t):
        ctx.shape, ctx.dtype = t.shape, t.dtype
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.shape, dtype=ctx.dtype)


def local_block(x, mesh, axis="sp", batch_axis=None):
    """This rank's block of a whole [batch, seq, heads, head_dim] tensor:
    seq split over ``axis``, batch over ``batch_axis``."""
    return local_shard(x, P(batch_axis, axis, None, None), mesh)


def ring_attention(q, k, v, mesh, axis="sp", causal=False,
                   batch_axis=None):
    """Multi-head attention with the sequence axis sharded over
    ``mesh[axis]``; q/k/v and the result are this rank's blocks."""
    ranks, me = mesh.ranks(axis), mesh.index(axis)
    group, sp = mesh.group(axis), mesh.size(axis)
    b, sq, h, d = q.shape
    qf = q.float()
    m = torch.full((b, h, sq), -torch.inf, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, sq, h, d), device=q.device)
    kv = torch.stack([k, v])
    for i in range(sp):
        src = (me - i) % sp           # the block held now came from src
        if not (causal and src > me):
            mask = None
            if causal:
                q_pos = me * sq + torch.arange(sq, device=q.device)[:, None]
                k_pos = src * sq + torch.arange(kv.shape[2],
                                                device=q.device)[None]
                mask = (q_pos >= k_pos)[None, None]
            m, l, acc = _block_attention(qf, kv[0].float(), kv[1].float(),
                                         m, l, acc, mask)
        if i < sp - 1:
            kv = ppermute_ad(kv, ranks, me, 1, group)
    out = acc / torch.clamp_min(l, 1e-20).transpose(1, 2)[..., None]
    if torch.is_grad_enabled() and kv.requires_grad:
        out = _Tie.apply(out, kv)
    return out.to(q.dtype)


def full_attention(q, k, v, causal=False):
    """Single-device plain softmax attention (reference :137)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask[None, None], scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
