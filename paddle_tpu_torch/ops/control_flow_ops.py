"""Control-flow ops: the dense form of ``beam_search`` (counterpart of
paddle_tpu/ops/control_flow_ops.py:761-800), the one the generation
engine's beam mode runs through a tiny eager program. The LoD form and
``beam_search_decode`` are not ported yet."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op
from .common import data_of


@register_op("beam_search")
def beam_search(ctx):
    """One beam step over dense inputs: pre_ids [b, beam] int, pre_scores
    [b, beam] (accumulated log-probs), ids [b, beam, k] candidate tokens,
    scores [b, beam, k] candidate log-probs. A finished beam (pre_id ==
    end_id) continues only with end_id at its unchanged score. Outputs
    selected_ids / selected_scores [b, beam] and parent_idx [b, beam] (the
    source beam of each). Ties keep the lower flat index first, as
    ``jax.lax.top_k`` does: a stable sort on the negated scores."""
    if isinstance(ctx.input("ids"), LoDArray):
        raise NotImplementedError(
            "beam_search over LoD candidates is not ported yet; the dense "
            "form takes [b, beam, k] candidates")
    pre_ids = data_of(ctx.input("pre_ids")).long()
    pre_scores = data_of(ctx.input("pre_scores"))
    cand_ids = data_of(ctx.input("ids")).long()
    cand_scores = data_of(ctx.input("scores"))
    beam = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))

    b, bm, k = cand_scores.shape
    finished = (pre_ids == end_id)[:, :, None]                # [b, beam, 1]
    total = pre_scores[:, :, None] + cand_scores              # [b, beam, k]
    keep_first = torch.arange(k, device=total.device)[None, None, :] == 0
    total = torch.where(finished,
                        torch.where(keep_first, pre_scores[:, :, None], -1e9),
                        total)
    ids_eff = torch.where(finished, torch.full_like(cand_ids, end_id),
                          cand_ids)
    flat = total.reshape(b, bm * k)
    order = torch.sort(-flat, dim=1, stable=True).indices[:, :beam]
    ctx.set_output("selected_ids",
                   torch.gather(ids_eff.reshape(b, bm * k), 1, order)
                   .to(torch.int32))
    ctx.set_output("selected_scores", torch.gather(flat, 1, order))
    ctx.set_output("parent_idx", (order // k).to(torch.int32))
