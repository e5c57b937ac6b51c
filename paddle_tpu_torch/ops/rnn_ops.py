"""The dynamic LSTM op and its grad (counterpart of
paddle_tpu/ops/rnn_ops.py: ``lstm`` :187, ``lstm_grad`` :205, with
``_reverse_padded`` :47, ``_lstm_scan`` :60 and ``_lstm_compute`` :128).

The op runs over a padded LoDArray [b, L, 4H] (the projected inputs; gate
columns [i, f, c, o]) with a length mask. Standard activations and no
peepholes take the kernel route (``ops/cuda/rnn.py``: the whole sequence
in one launch, bf16 recurrent product); everything else, and every call
under ``kernel_tier=torch``, the float32 scan, one step at a time. The
grad op differentiates the same function: on the kernel route through
``LstmSeq`` without a second forward launch (the raw carries are rebuilt
from the forward's outputs), on the scan route by autograd through the
recomputed scan, as the reference's ``jax.vjp`` does. dynamic_gru waits
for the Seq2Seq slice.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of, vjp
from .cuda import use_kernel
from .cuda import rnn as rnnk


def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda x: x}[name or "identity"]


def _reverse_padded(data, lens):
    """Reverse each row's valid prefix in place (padding stays at the
    end): the is_reverse attr."""
    L = data.shape[1]
    pos = torch.arange(L, device=data.device)
    idx = lens.long()[:, None] - 1 - pos[None, :]
    idx = torch.where(idx >= 0, idx, pos[None, :])
    idx = idx.reshape(idx.shape + (1,) * (data.ndim - 2)) \
        .expand(idx.shape + data.shape[2:])
    return torch.gather(data, 1, idx)


def _raw_carries(masked, lens, init):
    """The carry sequence [L, b, H] of a forward whose outputs were
    ``masked`` [b, L, H] (carries × alive), in scan order: a row's carry is
    frozen after its last step, and is ``init`` throughout for a row of
    length 0. Exact: an alive output is its carry times 1."""
    b, L, hdim = masked.shape
    pos = torch.arange(L, device=masked.device)
    last = torch.minimum(pos[None, :], lens.long()[:, None] - 1).clamp_min(0)
    raw = torch.gather(masked, 1, last[..., None].expand(b, L, hdim))
    raw = torch.where((lens > 0)[:, None, None], raw,
                      init.detach()[:, None, :])
    return raw.transpose(0, 1).contiguous()


def _lstm_scan(x, lens, w, h0, c0, gate_act, cell_act, cand_act,
               peepholes=None, masked=None):
    """x: [b, L, 4H] (bias added); w: [H, 4H]; ``peepholes``: optional
    (w_ic, w_fc, w_oc), each [H]. Returns hidden, cell [b, L, H], zero past
    each row's length. ``masked``: the (hidden, cell) this forward already
    produced, in scan order, which the kernel route replays instead of
    launching again."""
    b, L, h4 = x.shape
    hdim = h4 // 4
    supported = (peepholes is None
                 and (gate_act, cell_act, cand_act)
                 == ("sigmoid", "tanh", "tanh")
                 and rnnk.supported(b, hdim, x.dtype, x.device))
    if use_kernel("lstm", supported, x.device):
        xt = x.transpose(0, 1).contiguous()                  # [L, b, 4H]
        pos = torch.arange(L, device=x.device)
        alive = (pos[:, None] < lens[None, :]).to(x.dtype)[..., None]
        carries = () if masked is None else (
            _raw_carries(masked[0], lens, h0),
            _raw_carries(masked[1], lens, c0))
        hs, cs = rnnk.LstmSeq.apply(xt, alive, w.contiguous(),
                                    h0.contiguous(), c0.contiguous(),
                                    *carries)
        return (hs * alive).transpose(0, 1), (cs * alive).transpose(0, 1)

    ga, ca, cda = _act(gate_act), _act(cell_act), _act(cand_act)
    h_prev, c_prev = h0, c0
    hs, cs = [], []
    for t in range(L):
        gates = x[:, t] + torch.matmul(h_prev, w)
        alive = (t < lens)[:, None].to(x.dtype)
        gi = gates[:, :hdim]
        gf = gates[:, hdim:2 * hdim]
        go = gates[:, 3 * hdim:]
        if peepholes is not None:
            w_ic, w_fc, w_oc = peepholes
            gi = gi + c_prev * w_ic[None, :]
            gf = gf + c_prev * w_fc[None, :]
        i = ga(gi)
        f = ga(gf)
        cand = cda(gates[:, 2 * hdim:3 * hdim])
        c = f * c_prev + i * cand
        if peepholes is not None:
            go = go + c * w_oc[None, :]
        o = ga(go)
        h = o * ca(c)
        h_prev = alive * h + (1 - alive) * h_prev
        c_prev = alive * c + (1 - alive) * c_prev
        hs.append(h_prev * alive)
        cs.append(c_prev * alive)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def _lstm_compute(x, lens, w, bias, h0, c0, attrs, outputs=None):
    """(hidden, cell) [b, L, H] of the op; ``outputs`` are the op's own
    (hidden, cell) when the grad op re-traces the forward."""
    b, L, h4 = x.shape
    hdim = h4 // 4
    peepholes = None
    if bias is not None:
        x = x + bias[None, None, :h4]
        if bias.shape[-1] == 7 * hdim:
            # [4H gate bias | W_ic | W_fc | W_oc] (reference :133-138)
            peepholes = (bias[4 * hdim:5 * hdim], bias[5 * hdim:6 * hdim],
                         bias[6 * hdim:7 * hdim])
    if h0 is None:
        h0 = torch.zeros((b, hdim), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((b, hdim), dtype=x.dtype, device=x.device)
    rev = attrs.get("is_reverse", False)
    if rev:
        x = _reverse_padded(x, lens)
        if outputs is not None:
            outputs = tuple(_reverse_padded(v, lens) for v in outputs)
    hs, cs = _lstm_scan(x, lens, w, h0, c0,
                        attrs.get("gate_activation", "sigmoid"),
                        attrs.get("cell_activation", "tanh"),
                        attrs.get("candidate_activation", "tanh"),
                        peepholes=peepholes, masked=outputs)
    if rev:
        hs = _reverse_padded(hs, lens)
        cs = _reverse_padded(cs, lens)
    return hs, cs


def _lstm_grad_maker(op):
    """The reference's grad inputs plus the forward's Hidden and Cell, from
    which the kernel route rebuilds its saved carries."""
    inputs = {"Input": op.input("Input"), "Weight": op.input("Weight"),
              "Hidden": op.output("Hidden"), "Cell": op.output("Cell"),
              "Hidden@GRAD": G(op.output("Hidden")),
              "Cell@GRAD": G(op.output("Cell"))}
    outputs = {"Input@GRAD": G(op.input("Input")),
               "Weight@GRAD": G(op.input("Weight"))}
    for slot in ("Bias", "H0", "C0"):
        if op.input(slot):
            inputs[slot] = op.input(slot)
            outputs[slot + "@GRAD"] = G(op.input(slot))
    return [OpSpec("lstm_grad", inputs, outputs, dict(op.attrs))]


def _rnn_infer(out_slots):
    def infer(op, block):
        x = block.var(op.input("Input")[0])
        w = block.var(op.input("Weight")[0])
        if x.shape is None or w.shape is None:
            return
        hdim = w.shape[0]
        for slot in out_slots:
            for name in op.output(slot):
                v = block.var(name)
                v.shape = tuple(x.shape[:-1]) + (hdim,)
                v.dtype = x.dtype
                v.lod_level = x.lod_level
    return infer


def _seq_input(ctx):
    """(padded data, lens) of the Input slot; a dense [b, L, 4H] input is a
    batch of full-length rows."""
    xv = ctx.input("Input")
    x = data_of(xv)
    lens = xv.lens if isinstance(xv, LoDArray) else torch.full(
        (x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return xv, x, lens


def _optional(ctx, slot):
    return ctx.input(slot) if ctx.has_input(slot) else None


@register_op("lstm", infer_shape=_rnn_infer(("Hidden", "Cell")),
             grad=_lstm_grad_maker)
def lstm(ctx):
    _, x, lens = _seq_input(ctx)
    bias = _optional(ctx, "Bias")
    hs, cs = _lstm_compute(x, lens, ctx.input("Weight"),
                           None if bias is None else bias.reshape(-1),
                           _optional(ctx, "H0"), _optional(ctx, "C0"),
                           ctx.op.attrs)
    ctx.set_output("Hidden", LoDArray(hs, lens))
    ctx.set_output("Cell", LoDArray(cs, lens))


@register_op("lstm_grad")
def lstm_grad(ctx):
    """The vector-Jacobian product of ``_lstm_compute`` with respect to
    every forward input the op consumed (reference :205-244)."""
    xv, x, lens = _seq_input(ctx)
    operands = {"Input": x, "Weight": ctx.input("Weight")}
    for slot in ("Bias", "H0", "C0"):
        v = _optional(ctx, slot)
        if v is not None:
            operands[slot] = v.reshape(-1) if slot == "Bias" else v
    names = list(operands)
    outputs = (data_of(ctx.input("Hidden")), data_of(ctx.input("Cell")))
    attrs = dict(ctx.op.attrs)

    def f(*args):
        kw = dict(zip(names, args))
        return _lstm_compute(kw["Input"], lens, kw["Weight"], kw.get("Bias"),
                             kw.get("H0"), kw.get("C0"), attrs, outputs)

    grads = dict(zip(names, vjp(f, list(operands.values()),
                                (data_of(ctx.input("Hidden@GRAD")),
                                 data_of(ctx.input("Cell@GRAD"))))))
    dx = grads["Input"]
    ctx.set_output("Input@GRAD",
                   LoDArray(dx, lens) if isinstance(xv, LoDArray) else dx)
    ctx.set_output("Weight@GRAD", grads["Weight"])
    if "Bias" in grads:
        ctx.set_output("Bias@GRAD", grads["Bias"].reshape(1, -1))
    for slot in ("H0", "C0"):
        if slot in grads:
            ctx.set_output(slot + "@GRAD", grads[slot])
