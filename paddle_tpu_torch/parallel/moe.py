"""Expert parallelism: a mixture-of-experts FFN with its experts sharded
over an "ep" mesh axis (counterpart of paddle_tpu/parallel/moe.py).

Top-1 routing with a fixed per-expert capacity (the GShard dispatch
formulation: static shapes, one-hot dispatch and combine tensors). The
reference leaves the token shuffle to GSPMD; here it is explicit. With a
mesh, each rank holds its share of the tokens (``x`` [n/ep, d], in rank
order) and its experts' weights (``shard_moe_params``):

1. every rank routes its tokens; a token's place in its expert's buffer
   counts the tokens routed there before it in the GLOBAL token order (the
   lower ranks' counts come from one all-gather), so the buffers match the
   replicated computation's;
2. each rank fills the [E, C, d] buffer at its tokens' places and an
   all-to-all sends expert e's rows to the rank that owns e, which sums
   what the ranks sent (each place is filled by one rank);
3. the owner runs its experts; a second all-to-all hands every rank the
   outputs of every expert, and each rank combines its tokens' rows.

The load-balancing ``aux_loss`` takes the global means (an all-reduce).
Autograd runs through the exchanges (``collectives.all_to_all_ad``,
``psum_ad``). Tokens over capacity pass through with expert output 0.
"""

from __future__ import annotations

import torch

from .collectives import all_gather, all_to_all_ad, psum_ad


def init_moe_params(rng, d_model, d_hidden, n_experts, dtype=torch.float32):
    """gate [d, E], w_in [E, d, h], w_out [E, h, d], normal draws from the
    ``torch.Generator`` ``rng`` (reference :29)."""
    scale = d_model ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=rng, dtype=dtype)

    return {
        "gate": normal(d_model, n_experts) * scale,
        "w_in": normal(n_experts, d_model, d_hidden) * scale,
        "w_out": normal(n_experts, d_hidden, d_model) * d_hidden ** -0.5,
    }


def shard_moe_params(params, mesh, axis="ep"):
    """This rank's experts (dim 0 of w_in and w_out split over ``axis``);
    the gate replicated."""
    n, me = mesh.size(axis), mesh.index(axis)
    return {"gate": params["gate"],
            "w_in": params["w_in"].chunk(n, dim=0)[me].contiguous(),
            "w_out": params["w_out"].chunk(n, dim=0)[me].contiguous()}


def moe_ffn(x, params, mesh=None, axis="ep", capacity_factor=1.25,
            act=torch.relu):
    """Top-1 routed expert FFN over this rank's tokens x [n_local, d] ->
    (out [n_local, d], aux_loss). Without ``mesh`` it is the replicated
    computation over all tokens and all experts."""
    n_local, d = x.shape
    group = mesh.group(axis) if mesh is not None else None
    ep = mesh.size(axis) if mesh is not None else 1
    me = mesh.index(axis) if mesh is not None else 0
    e = params["w_in"].shape[0] * ep
    n = n_local * ep
    cap = max(1, int(capacity_factor * n / e))

    gates = torch.softmax(x @ params["gate"], dim=-1)            # [n_l, E]
    expert_idx = gates.argmax(dim=-1)
    gate_val = gates.gather(1, expert_idx[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert_idx, e).to(x.dtype)
    # tokens routed to each expert by the ranks before this one
    counts = all_gather(onehot.sum(dim=0, keepdim=True), 0, group, ep) \
        if ep > 1 else onehot.sum(dim=0, keepdim=True)
    before = counts[:me].sum(dim=0)
    pos = (torch.cumsum(onehot, dim=0) - 1.0 + before) * onehot  # [n_l, E]
    keep = pos < cap
    pos_idx = torch.where(keep, pos, -1.0).long()
    pos_oh = torch.nn.functional.one_hot(pos_idx.clamp_min(0), cap) \
        .to(x.dtype) * (pos_idx >= 0).to(x.dtype)[..., None]     # [n_l, E, C]
    dispatch = onehot[:, :, None] * pos_oh

    # GShard's load-balancing term over the global token set
    sums = psum_ad(torch.cat([onehot.sum(dim=0), gates.sum(dim=0)]), group)
    aux_loss = e * torch.sum((sums[:e] / n) * (sums[e:] / n))

    expert_in = torch.einsum("nd,nec->ecd", x, dispatch)          # [E, C, d]
    if ep > 1:
        # expert e's rows to its owner, summed over the sending ranks
        expert_in = all_to_all_ad(expert_in, group, ep) \
            .reshape(ep, e // ep, cap, d).sum(dim=0)
    h = act(torch.einsum("ecd,edh->ech", expert_in, params["w_in"]))
    expert_out = torch.einsum("ech,ehd->ecd", h, params["w_out"])
    if ep > 1:
        # every expert's outputs to every rank
        expert_out = all_to_all_ad(expert_out.repeat(ep, 1, 1), group, ep)
    combine = dispatch * gate_val[:, None, None]
    return torch.einsum("ecd,nec->nd", expert_out, combine), aux_loss
