"""The recurrent ops and their grads (counterpart of
paddle_tpu/ops/rnn_ops.py): the dynamic LSTM and GRU (``lstm`` :187,
``lstm_grad`` :205, ``gru`` :320 and ``gru_grad`` :334, with
``_reverse_padded`` :47, ``_lstm_scan`` :60, ``_lstm_compute`` :128 and
``_gru_compute`` :251), and the single-step ``lstm_unit`` and ``gru_unit``,
the projected ``lstmp`` and the vanilla ``simple_rnn`` (:367-717), which
the reference runs as plain jnp and this port as plain torch.

Each op runs over a padded LoDArray [b, L, gH] (the projected inputs; gate
columns [i, f, c, o] for the LSTM, [u, r, c] for the GRU) with a length
mask. Standard activations (and, for the LSTM, no peepholes) take the
kernel route (``ops/cuda/rnn.py``: the whole sequence in one launch, bf16
recurrent products); everything else, and every call under
``kernel_tier=torch``, the float32 scan, one step at a time. The grad ops
differentiate the same function: on the kernel route through ``LstmSeq``
or ``GruSeq`` without a second forward launch (the raw carries are rebuilt
from the forward's outputs), on the scan route by autograd through the
recomputed scan, as the reference's ``jax.vjp`` does.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of, vjp
from .autotune import dispatch_variant, dtype_str, make_key
from .cuda import resolve_tier
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
    launching again. Outside autograd both routes run as operators
    (``torch.ops.paddle_tpu_torch``), so that ``torch.export`` keeps the
    padded length symbolic."""
    b, L, h4 = x.shape
    hdim = h4 // 4
    supported = (resolve_tier(x.device) == "cuda"
                 and peepholes is None
                 and (gate_act, cell_act, cand_act)
                 == ("sigmoid", "tanh", "tanh")
                 and rnnk.supported(b, hdim, x.dtype, x.device))
    choice = dispatch_variant(
        "rnn", make_key(cell="lstm", x=tuple(x.shape),
                        dtype=dtype_str(x.dtype)),
        {"jnp": True, "pallas": supported}, tier_kernel="lstm",
        device=x.device)
    if choice == "pallas":
        xt = x.transpose(0, 1).contiguous()                  # [L, b, 4H]
        pos = torch.arange(L, device=x.device)
        alive = (pos[:, None] < lens[None, :]).to(x.dtype)[..., None]
        args = (xt, alive, w.contiguous(), h0.contiguous(), c0.contiguous())
        carries = () if masked is None else (
            _raw_carries(masked[0], lens, h0),
            _raw_carries(masked[1], lens, c0))
        if carries or torch.is_grad_enabled():
            hs, cs = rnnk.LstmSeq.apply(*args, *carries)
        else:
            hs, cs = torch.ops.paddle_tpu_torch.lstm_seq(*args)
        return (hs * alive).transpose(0, 1), (cs * alive).transpose(0, 1)
    peep = None if peepholes is None else torch.cat(peepholes)
    if torch.is_grad_enabled():
        return _lstm_scan_plain(x, lens, w, h0, c0, peep, gate_act, cell_act,
                                cand_act)
    return torch.ops.paddle_tpu_torch.lstm_scan(
        x, lens, w, h0, c0, peep, gate_act or "identity",
        cell_act or "identity", cand_act or "identity")


def _lstm_scan_plain(x, lens, w, h0, c0, peep, gate_act, cell_act,
                     cand_act):
    """The float32 scan, one step at a time; ``peep`` is [W_ic | W_fc |
    W_oc] or None."""
    hdim = x.shape[-1] // 4
    ga, ca, cda = _act(gate_act), _act(cell_act), _act(cand_act)
    h_prev, c_prev = h0, c0
    hs, cs = [], []
    for t in range(x.shape[1]):
        gates = x[:, t] + torch.matmul(h_prev, w)
        alive = (t < lens)[:, None].to(x.dtype)
        gi = gates[:, :hdim]
        gf = gates[:, hdim:2 * hdim]
        go = gates[:, 3 * hdim:]
        if peep is not None:
            gi = gi + c_prev * peep[None, :hdim]
            gf = gf + c_prev * peep[None, hdim:2 * hdim]
        i = ga(gi)
        f = ga(gf)
        cand = cda(gates[:, 2 * hdim:3 * hdim])
        c = f * c_prev + i * cand
        if peep is not None:
            go = go + c * peep[None, 2 * hdim:]
        o = ga(go)
        h = o * ca(c)
        h_prev = alive * h + (1 - alive) * h_prev
        c_prev = alive * c + (1 - alive) * c_prev
        hs.append(h_prev * alive)
        cs.append(c_prev * alive)
    return torch.stack(hs, 1), torch.stack(cs, 1)


@torch.library.custom_op("paddle_tpu_torch::lstm_scan", mutates_args=())
def lstm_scan_op(x: torch.Tensor, lens: torch.Tensor, w: torch.Tensor,
                 h0: torch.Tensor, c0: torch.Tensor,
                 peep: torch.Tensor | None, gate_act: str, cell_act: str,
                 cand_act: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain route's scan as one operator (no kernel: the loop over
    the padded length, which ``torch.export`` would otherwise unroll at the
    example's length)."""
    return _lstm_scan_plain(x, lens, w, h0, c0, peep, gate_act, cell_act,
                            cand_act)


@lstm_scan_op.register_fake
def _lstm_scan_fake(x, lens, w, h0, c0, peep, gate_act, cell_act, cand_act):
    shape = (x.shape[0], x.shape[1], w.shape[0])
    return x.new_empty(shape), x.new_empty(shape)


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


def _gru_compute(x, lens, w, bias, h0, attrs, hidden=None):
    """hidden [b, L, H] of the op (reference :251-304); ``hidden`` is the
    op's own output when the grad op re-traces the forward."""
    b, L, h3 = x.shape
    hdim = h3 // 3
    if bias is not None:
        x = x + bias[None, None, :]
    if h0 is None:
        h0 = torch.zeros((b, hdim), dtype=x.dtype, device=x.device)
    gate_act = attrs.get("gate_activation", "sigmoid")
    cand_act = attrs.get("activation", "tanh")
    rev = attrs.get("is_reverse", False)
    if rev:
        x = _reverse_padded(x, lens)
        if hidden is not None:
            hidden = _reverse_padded(hidden, lens)
    supported = (resolve_tier(x.device) == "cuda"
                 and (gate_act, cand_act) == ("sigmoid", "tanh")
                 and rnnk.supported(b, hdim, x.dtype, x.device))
    choice = dispatch_variant(
        "rnn", make_key(cell="gru", x=tuple(x.shape),
                        dtype=dtype_str(x.dtype)),
        {"jnp": True, "pallas": supported}, tier_kernel="gru",
        device=x.device)
    if choice == "pallas":
        xt = x.transpose(0, 1).contiguous()                  # [L, b, 3H]
        pos = torch.arange(L, device=x.device)
        alive = (pos[:, None] < lens[None, :]).to(x.dtype)[..., None]
        args = (xt, alive, w.contiguous(), h0.contiguous())
        carries = () if hidden is None else (
            _raw_carries(hidden, lens, h0),)
        if carries or torch.is_grad_enabled():
            hs = rnnk.GruSeq.apply(*args, *carries)
        else:
            hs = torch.ops.paddle_tpu_torch.gru_seq(*args)
        hs = (hs * alive).transpose(0, 1)
    elif torch.is_grad_enabled():
        hs = _gru_scan_plain(x, lens, w, h0, gate_act, cand_act)
    else:
        hs = torch.ops.paddle_tpu_torch.gru_scan(
            x, lens, w, h0, gate_act or "identity", cand_act or "identity")
    return _reverse_padded(hs, lens) if rev else hs


def _gru_scan_plain(x, lens, w, h0, gate_act, cand_act):
    """The GRU's float32 scan, one step at a time."""
    hdim = h0.shape[-1]
    ga, ca = _act(gate_act), _act(cand_act)
    wu, wr, wc = w[:, :hdim], w[:, hdim:2 * hdim], w[:, 2 * hdim:]
    h_prev = h0
    out = []
    for t in range(x.shape[1]):
        xt = x[:, t]
        alive = (t < lens)[:, None].to(x.dtype)
        r = ga(xt[:, hdim:2 * hdim] + torch.matmul(h_prev, wr))
        rc = torch.matmul(r * h_prev, wc)
        u = ga(xt[:, :hdim] + torch.matmul(h_prev, wu))
        c = ca(xt[:, 2 * hdim:] + rc)
        h = u * c + (1.0 - u) * h_prev
        h_prev = alive * h + (1 - alive) * h_prev
        out.append(h_prev * alive)
    return torch.stack(out, 1)


@torch.library.custom_op("paddle_tpu_torch::gru_scan", mutates_args=())
def gru_scan_op(x: torch.Tensor, lens: torch.Tensor, w: torch.Tensor,
                h0: torch.Tensor, gate_act: str,
                cand_act: str) -> torch.Tensor:
    """The GRU's plain scan as one operator, as :func:`lstm_scan_op`."""
    return _gru_scan_plain(x, lens, w, h0, gate_act, cand_act)


@gru_scan_op.register_fake
def _gru_scan_fake(x, lens, w, h0, gate_act, cand_act):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[0]))


def _gru_grad_maker(op):
    """The reference's grad inputs (:307-316) plus the forward's Hidden,
    from which the kernel route rebuilds its saved carries."""
    inputs = {"Input": op.input("Input"), "Weight": op.input("Weight"),
              "Hidden": op.output("Hidden"),
              "Hidden@GRAD": G(op.output("Hidden"))}
    outputs = {"Input@GRAD": G(op.input("Input")),
               "Weight@GRAD": G(op.input("Weight"))}
    for slot in ("Bias", "H0"):
        if op.input(slot):
            inputs[slot] = op.input(slot)
            outputs[slot + "@GRAD"] = G(op.input(slot))
    return [OpSpec("gru_grad", inputs, outputs, dict(op.attrs))]


@register_op("gru", infer_shape=_rnn_infer(("Hidden",)), grad=_gru_grad_maker)
def gru(ctx):
    _, x, lens = _seq_input(ctx)
    bias = _optional(ctx, "Bias")
    hs = _gru_compute(x, lens, ctx.input("Weight"),
                      None if bias is None else bias.reshape(-1),
                      _optional(ctx, "H0"), ctx.op.attrs)
    ctx.set_output("Hidden", LoDArray(hs, lens))


@register_op("gru_grad")
def gru_grad(ctx):
    """The vector-Jacobian product of ``_gru_compute`` with respect to
    every forward input the op consumed (reference :334-365)."""
    xv, x, lens = _seq_input(ctx)
    operands = {"Input": x, "Weight": ctx.input("Weight")}
    for slot in ("Bias", "H0"):
        v = _optional(ctx, slot)
        if v is not None:
            operands[slot] = v.reshape(-1) if slot == "Bias" else v
    names = list(operands)
    hidden = data_of(ctx.input("Hidden"))
    attrs = dict(ctx.op.attrs)

    def f(*args):
        kw = dict(zip(names, args))
        return _gru_compute(kw["Input"], lens, kw["Weight"], kw.get("Bias"),
                            kw.get("H0"), attrs, hidden)

    grads = dict(zip(names, vjp(f, list(operands.values()),
                                data_of(ctx.input("Hidden@GRAD")))))
    dx = grads["Input"]
    ctx.set_output("Input@GRAD",
                   LoDArray(dx, lens) if isinstance(xv, LoDArray) else dx)
    ctx.set_output("Weight@GRAD", grads["Weight"])
    if "Bias" in grads:
        ctx.set_output("Bias@GRAD", grads["Bias"].reshape(1, -1))
    if "H0" in grads:
        ctx.set_output("H0@GRAD", grads["H0"])


# ---------------------------------------------------------------------------
# single-step units and the other recurrences (reference :367-717). The
# reference runs all four as plain jnp (no pallas_call); so do these, and
# their grads are autograd vjps of the same functions.
# ---------------------------------------------------------------------------

def _lstm_unit_fwd(x, c_prev, fb):
    """One LSTM cell step (reference :372): x [b, 4H] pre-activations in
    gate order [i, f, c, o], forget_bias added into the forget gate."""
    hdim = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :hdim])
    f = torch.sigmoid(x[:, hdim:2 * hdim] + fb)
    cand = torch.tanh(x[:, 2 * hdim:3 * hdim])
    o = torch.sigmoid(x[:, 3 * hdim:])
    c = f * c_prev + i * cand
    return c, o * torch.tanh(c)


@register_op("lstm_unit", grad=lambda op: [OpSpec(
    "lstm_unit_grad",
    {"X": op.input("X"), "C_prev": op.input("C_prev"),
     "C@GRAD": G(op.output("C")), "H@GRAD": G(op.output("H"))},
    {"X@GRAD": G(op.input("X")), "C_prev@GRAD": G(op.input("C_prev"))},
    dict(op.attrs))])
def lstm_unit(ctx):
    c, h = _lstm_unit_fwd(data_of(ctx.input("X")),
                          data_of(ctx.input("C_prev")),
                          ctx.attr("forget_bias", 0.0))
    ctx.set_output("C", c)
    ctx.set_output("H", h)


@register_op("lstm_unit_grad")
def lstm_unit_grad(ctx):
    fb = ctx.attr("forget_bias", 0.0)
    dx, dcp = vjp(lambda a, b: _lstm_unit_fwd(a, b, fb),
                  [data_of(ctx.input("X")), data_of(ctx.input("C_prev"))],
                  (data_of(ctx.input("C@GRAD")),
                   data_of(ctx.input("H@GRAD"))))
    ctx.set_output("X@GRAD", dx)
    ctx.set_output("C_prev@GRAD", dcp)


def _gru_unit_fwd(x, h_prev, w, bias, gate_act, cand_act):
    """One GRU step (reference :455): x [b, 3H] in gate order [u, r, c],
    W [H, 3H]. Returns (u, r, c, h)."""
    hdim = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(1, -1)
    u = gate_act(x[:, :hdim] + torch.matmul(h_prev, w[:, :hdim]))
    r = gate_act(x[:, hdim:2 * hdim]
                 + torch.matmul(h_prev, w[:, hdim:2 * hdim]))
    c = cand_act(x[:, 2 * hdim:] + torch.matmul(r * h_prev, w[:, 2 * hdim:]))
    return u, r, c, u * c + (1.0 - u) * h_prev


def _gru_unit_grad_maker(op):
    inputs = {"Input": op.input("Input"), "HiddenPrev": op.input("HiddenPrev"),
              "Weight": op.input("Weight"),
              "Hidden@GRAD": G(op.output("Hidden"))}
    outputs = {"Input@GRAD": G(op.input("Input")),
               "HiddenPrev@GRAD": G(op.input("HiddenPrev")),
               "Weight@GRAD": G(op.input("Weight"))}
    if op.input("Bias"):
        inputs["Bias"] = op.input("Bias")
        outputs["Bias@GRAD"] = G(op.input("Bias"))
    return [OpSpec("gru_unit_grad", inputs, outputs, dict(op.attrs))]


def _gru_unit_acts(ctx):
    """The gate and candidate activations: the upstream op's enum ints (0
    identity, 1 sigmoid, 2 tanh, 3 relu) or the layer's strings."""
    codes = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}

    def resolve(attr, default):
        v = ctx.attr(attr, default)
        return _act(codes[v] if isinstance(v, int) else v)

    return resolve("gate_activation", "sigmoid"), resolve("activation", "tanh")


@register_op("gru_unit", grad=_gru_unit_grad_maker)
def gru_unit(ctx):
    h_prev = data_of(ctx.input("HiddenPrev"))
    bias = _optional(ctx, "Bias")
    u, r, c, h = _gru_unit_fwd(data_of(ctx.input("Input")), h_prev,
                               data_of(ctx.input("Weight")),
                               None if bias is None else data_of(bias),
                               *_gru_unit_acts(ctx))
    ctx.set_output("Gate", torch.cat([u, r, c], dim=-1))
    ctx.set_output("ResetHiddenPrev", r * h_prev)
    ctx.set_output("Hidden", h)


@register_op("gru_unit_grad")
def gru_unit_grad(ctx):
    ga, ca = _gru_unit_acts(ctx)
    operands = [data_of(ctx.input("Input")),
                data_of(ctx.input("HiddenPrev")),
                data_of(ctx.input("Weight"))]
    has_bias = ctx.has_input("Bias")
    if has_bias:
        operands.append(data_of(ctx.input("Bias")))
    grads = vjp(lambda x, h, w, *b: _gru_unit_fwd(
        x, h, w, b[0] if b else None, ga, ca)[3], operands,
        data_of(ctx.input("Hidden@GRAD")))
    ctx.set_output("Input@GRAD", grads[0])
    ctx.set_output("HiddenPrev@GRAD", grads[1])
    ctx.set_output("Weight@GRAD", grads[2])
    if has_bias:
        ctx.set_output("Bias@GRAD", grads[3])


def _lstmp_compute(x, lens, w, proj_w, bias, h0, c0, attrs):
    """LSTM with a recurrent projection (reference :571): the recurrence
    runs over r_t = proj_act(h_t @ ProjWeight); Weight [P, 4H],
    ProjWeight [H, P]. Returns (projections [b, L, P], cells [b, L, H]),
    zero past each row's length."""
    b, L, h4 = x.shape
    hdim = h4 // 4
    p = proj_w.shape[1]
    if bias is not None:
        x = x + bias[None, None, :h4]
    ga = _act(attrs.get("gate_activation", "sigmoid"))
    ca = _act(attrs.get("cell_activation", "tanh"))
    cda = _act(attrs.get("candidate_activation", "tanh"))
    pa = _act(attrs.get("proj_activation", "tanh"))
    r_prev = torch.zeros((b, p), dtype=x.dtype, device=x.device) \
        if h0 is None else torch.matmul(h0, proj_w)
    c_prev = torch.zeros((b, hdim), dtype=x.dtype, device=x.device) \
        if c0 is None else c0
    rev = attrs.get("is_reverse", False)
    if rev:
        x = _reverse_padded(x, lens)
    rs, cs = [], []
    for t in range(L):
        gates = x[:, t] + torch.matmul(r_prev, w)
        i = ga(gates[:, :hdim])
        f = ga(gates[:, hdim:2 * hdim])
        cand = cda(gates[:, 2 * hdim:3 * hdim])
        o = ga(gates[:, 3 * hdim:])
        c = f * c_prev + i * cand
        r = pa(torch.matmul(o * ca(c), proj_w))
        alive = (t < lens)[:, None].to(x.dtype)
        r_prev = alive * r + (1 - alive) * r_prev
        c_prev = alive * c + (1 - alive) * c_prev
        rs.append(r_prev * alive)
        cs.append(c_prev * alive)
    rs, cs = torch.stack(rs, 1), torch.stack(cs, 1)
    if rev:
        rs, cs = _reverse_padded(rs, lens), _reverse_padded(cs, lens)
    return rs, cs


def _lstmp_grad_maker(op):
    inputs = {"Input": op.input("Input"), "Weight": op.input("Weight"),
              "ProjWeight": op.input("ProjWeight"),
              "Projection@GRAD": G(op.output("Projection")),
              "Cell@GRAD": G(op.output("Cell"))}
    outputs = {"Input@GRAD": G(op.input("Input")),
               "Weight@GRAD": G(op.input("Weight")),
               "ProjWeight@GRAD": G(op.input("ProjWeight"))}
    for slot in ("Bias", "H0", "C0"):
        if op.input(slot):
            inputs[slot] = op.input(slot)
            outputs[slot + "@GRAD"] = G(op.input(slot))
    return [OpSpec("lstmp_grad", inputs, outputs, dict(op.attrs))]


def _lstmp_infer(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Weight")[0])
    pw = block.var(op.input("ProjWeight")[0])
    if x.shape is None or w.shape is None or pw.shape is None:
        return
    hdim, p = pw.shape
    for slot, width in (("Projection", p), ("Cell", hdim)):
        for name in op.output(slot):
            v = block.var(name)
            v.shape = tuple(x.shape[:-1]) + (width,)
            v.dtype = x.dtype
            v.lod_level = x.lod_level


def _operands(ctx, slots):
    """{slot: tensor} of the optional slots that hold a value (a Bias
    flattened)."""
    out = {}
    for slot in slots:
        v = _optional(ctx, slot)
        if v is not None:
            out[slot] = data_of(v).reshape(-1) if slot == "Bias" \
                else data_of(v)
    return out


@register_op("lstmp", infer_shape=_lstmp_infer, grad=_lstmp_grad_maker)
def lstmp(ctx):
    _, x, lens = _seq_input(ctx)
    kw = _operands(ctx, ("Bias", "H0", "C0"))
    rs, cs = _lstmp_compute(x, lens, data_of(ctx.input("Weight")),
                            data_of(ctx.input("ProjWeight")), kw.get("Bias"),
                            kw.get("H0"), kw.get("C0"), ctx.op.attrs)
    ctx.set_output("Projection", LoDArray(rs, lens))
    ctx.set_output("Cell", LoDArray(cs, lens))


@register_op("lstmp_grad")
def lstmp_grad(ctx):
    xv, x, lens = _seq_input(ctx)
    operands = {"Input": x, "Weight": data_of(ctx.input("Weight")),
                "ProjWeight": data_of(ctx.input("ProjWeight")),
                **_operands(ctx, ("Bias", "H0", "C0"))}
    names = list(operands)
    attrs = dict(ctx.op.attrs)

    def f(*args):
        kw = dict(zip(names, args))
        return _lstmp_compute(kw["Input"], lens, kw["Weight"],
                              kw["ProjWeight"], kw.get("Bias"),
                              kw.get("H0"), kw.get("C0"), attrs)

    grads = vjp(f, list(operands.values()),
                (data_of(ctx.input("Projection@GRAD")),
                 data_of(ctx.input("Cell@GRAD"))))
    for n, g in zip(names, grads):
        if n == "Input":
            ctx.set_output("Input@GRAD", LoDArray(g, lens)
                           if isinstance(xv, LoDArray) else g)
        elif n == "Bias":
            ctx.set_output("Bias@GRAD", g.reshape(1, -1))
        else:
            ctx.set_output(n + "@GRAD", g)


def _simple_rnn_compute(x, lens, w, bias, attrs):
    """h_t = act(x_t + h_{t-1} W + b) (reference :678), zero past each
    row's length; is_reverse runs each row's valid prefix backwards."""
    b, L, hdim = x.shape
    act = _act(attrs.get("activation", "tanh"))
    rev = bool(attrs.get("is_reverse", False))
    if bias is not None:
        x = x + bias[None, None, :]
    if rev:
        x = _reverse_padded(x, lens)
    h_prev = torch.zeros((b, hdim), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(L):
        h = act(x[:, t] + torch.matmul(h_prev, w))
        alive = (t < lens)[:, None].to(x.dtype)
        h_prev = alive * h + (1 - alive) * h_prev
        hs.append(h_prev * alive)
    hs = torch.stack(hs, 1)
    return _reverse_padded(hs, lens) if rev else hs


def _simple_rnn_grad_maker(op):
    inputs = {"Input": op.input("Input"), "Weight": op.input("Weight"),
              "Out@GRAD": G(op.output("Out"))}
    outputs = {"Input@GRAD": G(op.input("Input")),
               "Weight@GRAD": G(op.input("Weight"))}
    if op.input("Bias"):
        inputs["Bias"] = op.input("Bias")
        outputs["Bias@GRAD"] = G(op.input("Bias"))
    return [OpSpec("simple_rnn_grad", inputs, outputs, dict(op.attrs))]


@register_op("simple_rnn", infer_shape=_rnn_infer(("Out",)),
             grad=_simple_rnn_grad_maker)
def simple_rnn(ctx):
    _, x, lens = _seq_input(ctx)
    hs = _simple_rnn_compute(x, lens, data_of(ctx.input("Weight")),
                             _operands(ctx, ("Bias",)).get("Bias"),
                             ctx.op.attrs)
    ctx.set_output("Out", LoDArray(hs, lens))


@register_op("simple_rnn_grad")
def simple_rnn_grad(ctx):
    _, x, lens = _seq_input(ctx)
    operands = {"Input": x, "Weight": data_of(ctx.input("Weight")),
                **_operands(ctx, ("Bias",))}
    names = list(operands)
    attrs = dict(ctx.op.attrs)

    def f(*args):
        kw = dict(zip(names, args))
        return _simple_rnn_compute(kw["Input"], lens, kw["Weight"],
                                   kw.get("Bias"), attrs)

    grads = dict(zip(names, vjp(f, list(operands.values()),
                                data_of(ctx.input("Out@GRAD")))))
    ctx.set_output("Input@GRAD", LoDArray(grads["Input"], lens))
    ctx.set_output("Weight@GRAD", grads["Weight"])
    if "Bias" in grads:
        ctx.set_output("Bias@GRAD", grads["Bias"].reshape(1, -1))
