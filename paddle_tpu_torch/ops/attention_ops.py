"""Attention ops (counterpart of paddle_tpu/ops/attention_ops.py:49-257):
causal self-attention with its grad, and its serving-time split over a
paged KV arena.

``causal_self_attention`` is the model-authoring op: one op per
transformer layer, Q/K/V already projected by ``fc`` layers. Its grad
(reference :83-106) is the vector-Jacobian product of the same plain
attention: a masked score is -1e9, whose softmax weight is exactly 0.0,
so the masked positions get exactly zero gradient, as in the reference. The
generation engine (serving/generate/decode_engine.py) clones the saved
program and rewrites every site into one of three phase ops:

* ``prefill_attention`` — causal attention over the (bucket-padded) prompt
  window, plus a scatter of every position's K/V rows into the arena at
  ``SlotMapping`` (flat ``block * block_size + offset`` slots).
* ``chunked_prefill_attention`` — a prompt chunk whose earlier positions
  already live in the arena (a cached shared prefix, or the prompt's
  previous chunks): the chunk's rows scatter in first, then each chunk
  query attends over the arena context gathered through the sequence's
  block table, masked causally at its absolute position (``ChunkStart`` +
  window index).
* ``paged_attention`` — the fixed-shape ``[max_seqs, 1]`` decode step:
  write the new token's K/V row, then attend its Q through the block
  table, each row masked to its ``ContextLens`` prefix. The attend routes
  through the kernel tier (``ops/cuda/paged_attention.py``): the
  hand-written kernel on the card, the gather-then-attend plain version
  otherwise.

Arena update. The reference's phase ops are functional and output the
updated arena under the input's name, and its engine donates the buffers.
Here the ops write the fed arena tensor IN PLACE and output that same
tensor under the same name (registered ``in_place=True``, as the optimizer
ops): no arena is copied per dispatch. A caller that feeds a numpy array
on the CPU gets it written, since the executor's feed shares its memory.

Drop semantics. A slot outside ``[0, num_blocks * block_size)`` — the
engine's sentinel for padding positions and idle rows — writes nothing:
never a wrapped or clamped write into some other sequence's block. The
live slots' positions come from one ``nonzero`` per phase op, which costs
one device-to-host sync (their count sets the index's length); K and V
share it.

Export. The write is the operator ``torch.ops.paddle_tpu_torch.paged_kv_write``
(``mutates_args`` the two arenas) and the decode attend the operator
``torch.ops.paddle_tpu_torch.paged_attention``: a ``torch.export`` trace of a
phase program keeps both whole, at static shapes (the ``nonzero`` runs
inside the write, never in the graph), and the exported program writes the
fed arena back (``serving/execcache.py``).

All phase ops are row-independent: a row's output depends only on its own
tokens, table and arena rows, which is what makes continuous batching
give the same token streams as one sequence at a time.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .autotune import dispatch_variant, dtype_str, make_key
from .common import data_of, vjp
from .cuda import paged_attention as _pa
from .sequence_ops import _vjp_grad

# the masked-score value of the reference (-1e9): a masked slot
# contributes exp(-1e9 - max) == 0.0 exactly
_MASKED = -1e9


def _split_heads(x, num_heads):
    b, t, e = x.shape
    if e % num_heads:
        raise ValueError(
            f"attention hidden size {e} is not divisible by num_heads "
            f"{num_heads}")
    return x.reshape(b, t, num_heads, e // num_heads)




def _causal_mha(q, k, v, num_heads):
    """Plain causal multi-head attention: [b, T, E] x3 -> [b, T, E]."""
    qh = _split_heads(q, num_heads)
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    d = qh.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", qh, kh) * (d ** -0.5)
    t = q.shape[1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
    p = torch.softmax(torch.where(causal[None, None], scores, _MASKED),
                      dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, vh)
    return out.reshape(q.shape)


@register_op("causal_self_attention",
             grad=_vjp_grad("causal_self_attention",
                            in_slots=("Q", "K", "V")))
def causal_self_attention(ctx):
    """Causal MHA over a [b, T, E] window: the training form, and the
    export form the generation engine rewrites per phase."""
    q = data_of(ctx.input("Q"))
    k = data_of(ctx.input("K"))
    v = data_of(ctx.input("V"))
    ctx.set_output("Out", _causal_mha(q, k, v, int(ctx.attr("num_heads"))))


@register_op("causal_self_attention_grad")
def causal_self_attention_grad(ctx):
    h = int(ctx.attr("num_heads"))
    dq, dk, dv = vjp(lambda a, b, c: _causal_mha(a, b, c, h),
                     [data_of(ctx.input(s)) for s in ("Q", "K", "V")],
                     data_of(ctx.input("Out@GRAD")))
    ctx.set_output("Q@GRAD", dq)
    ctx.set_output("K@GRAD", dk)
    ctx.set_output("V@GRAD", dv)


def _scatter_rows(caches, slots, rows):
    """Write ``rows[i]`` [n, H, D] into each arena ``caches[i]`` [nb, bs,
    H, D] at flat slots [n] (block * block_size + offset), in place.
    Slots outside the arena (the sentinel ``nb * bs``) are dropped."""
    nb, bs = caches[0].shape[0], caches[0].shape[1]
    slots = slots.long()
    live = torch.nonzero((slots >= 0) & (slots < nb * bs)).squeeze(1)
    idx = slots.index_select(0, live)
    for cache, r in zip(caches, rows):
        flat = cache.view((nb * bs,) + cache.shape[2:])
        flat.index_copy_(0, idx, r.index_select(0, live).to(cache.dtype))


@torch.library.custom_op("paddle_tpu_torch::paged_kv_write",
                         mutates_args=("kc", "vc"))
def paged_kv_write(kc: torch.Tensor, vc: torch.Tensor, slots: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor) -> None:
    """``torch.ops.paddle_tpu_torch.paged_kv_write``: :func:`_scatter_rows`
    of the rows k, v [n, H, D] into the arenas kc, vc at the flat slots
    [n], in place, the sentinel rule kept. As an operator, a
    ``torch.export`` trace keeps the write whole (its live-slot count is
    data-dependent) and records the arenas as mutated inputs."""
    _scatter_rows((kc, vc), slots, (k, v))


@paged_kv_write.register_fake
def _paged_kv_write_fake(kc, vc, slots, k, v):
    return None


def _phase_inputs(ctx):
    """Q, K, V, heads, the arenas and the slot mapping of a phase op, with
    the window's K/V rows scattered into the arenas (in place)."""
    q = data_of(ctx.input("Q"))
    k = data_of(ctx.input("K"))
    v = data_of(ctx.input("V"))
    h = int(ctx.attr("num_heads"))
    kc = data_of(ctx.input("KCache"))
    vc = data_of(ctx.input("VCache"))
    slots = data_of(ctx.input("SlotMapping")).reshape(-1)
    kh = _split_heads(k, h).reshape((-1,) + kc.shape[2:])
    vh = _split_heads(v, h).reshape((-1,) + vc.shape[2:])
    paged_kv_write(kc, vc, slots, kh, vh)
    ctx.set_output("KCacheOut", kc)
    ctx.set_output("VCacheOut", vc)
    return q, k, v, h, kc, vc


@register_op("prefill_attention", in_place=True)
def prefill_attention(ctx):
    """Causal attention over the (padded) prompt window plus the K/V
    scatter into the arena. Padding positions map to the sentinel slot and
    write nothing; padding sits after the real prompt and the mask is
    causal, so no real position's output depends on it."""
    q, k, v, h, _, _ = _phase_inputs(ctx)
    ctx.set_output("Out", _causal_mha(q, k, v, h))


def _gather_context(cache, bt):
    """Arena rows of every context position a block-table row may see:
    cache [nb, bs, H, D], bt [b, P] -> [b, P * bs, H, D] ordered by
    position. Unused table entries gather rows the caller's mask
    excludes."""
    nb, bs = cache.shape[0], cache.shape[1]
    pos = torch.arange(bs, dtype=torch.int64, device=bt.device)
    idx = (bt.long()[:, :, None] * bs + pos[None, None, :]) \
        .reshape(bt.shape[0], -1)
    return cache.reshape((nb * bs,) + cache.shape[2:])[idx]


@register_op("chunked_prefill_attention", in_place=True)
def chunked_prefill_attention(ctx):
    """Partial prefill of a prompt chunk whose earlier positions are in
    the arena: the chunk's K/V rows scatter in at ``SlotMapping`` first,
    then every window position i attends over the arena context gathered
    through ``BlockTables``, masked causally at ``ChunkStart + i``. With
    ChunkStart 0 and an empty arena this is the full-window prefill."""
    q, _, _, h, kc, vc = _phase_inputs(ctx)
    bt = data_of(ctx.input("BlockTables"))                       # [b, P]
    start = data_of(ctx.input("ChunkStart")).long().reshape(-1)  # [b]
    # one lowering, but the dispatch still keys the shape (and capture
    # records it), as the reference's does
    dispatch_variant(
        "chunked_prefill_attention",
        make_key(q=tuple(q.shape), kc=tuple(kc.shape),
                 tables=int(bt.shape[1]), heads=h, dtype=dtype_str(q.dtype)),
        {"jnp": True}, device=q.device)
    kctx = _gather_context(kc, bt)                               # [b, C, H, D]
    vctx = _gather_context(vc, bt)
    qh = _split_heads(q, h)                                      # [b, T, H, D]
    d = qh.shape[-1]
    t = q.shape[1]
    scores = torch.einsum("bthd,bchd->bhtc", qh, kctx) * (d ** -0.5)
    qpos = start[:, None] + torch.arange(t, device=q.device)[None]
    cpos = torch.arange(kctx.shape[1], device=q.device)
    visible = cpos[None, None] <= qpos[:, :, None]               # [b, T, C]
    p = torch.softmax(torch.where(visible[:, None], scores, _MASKED),
                      dim=-1)
    out = torch.einsum("bhtc,bchd->bthd", p, vctx)
    ctx.set_output("Out", out.reshape(q.shape))


@register_op("paged_attention", in_place=True)
def paged_attention(ctx):
    """One decode step for every slot of the fixed-shape batch. Q/K/V are
    [max_seqs, 1, E]; the new K/V row is written at ``SlotMapping`` first
    (sentinel = no write), then each row's Q attends over the updated
    arena through its ``BlockTables`` row, masked to its ``ContextLens``
    prefix (which counts the just-written token). Inactive rows
    (ContextLens 0) output zeros. The attend takes the kernel route for
    supported shapes (``ops/cuda/paged_attention.py``); an unsupported
    shape under a tier that wants the kernel routes to the plain version
    with a ``fallback_counts()`` bump."""
    q, _, _, h, kc, vc = _phase_inputs(ctx)
    bt = data_of(ctx.input("BlockTables")).to(torch.int32)       # [b, P]
    ctx_lens = data_of(ctx.input("ContextLens")).to(torch.int32) \
        .reshape(-1)                                             # [b]
    qh = _split_heads(q, h)[:, 0]                                # [b, H, D]
    key = make_key(q=tuple(qh.shape), kc=tuple(kc.shape),
                   tables=int(bt.shape[1]), dtype=dtype_str(qh.dtype))
    choice = dispatch_variant("paged_attention", key, {
        "jnp": True,
        "pallas": _pa.paged_attention_supported(qh, kc, bt),
    }, device=qh.device)
    if choice == "pallas":
        out = _pa.paged_attention_op(qh.contiguous(), kc, vc,
                                     bt.contiguous(), ctx_lens.contiguous())
    else:
        out = _pa.paged_attention_torch(qh, kc, vc, bt, ctx_lens)
    ctx.set_output("Out", out.reshape(bt.shape[0], 1, -1))
