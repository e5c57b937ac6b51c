"""The whole-sequence LSTM and its backward, one launch each (counterpart of
paddle_tpu/ops/pallas/rnn.py::lstm_seq_pallas, forward ``:84`` and the
custom_vjp backward ``:133``).

``lstm_seq(x, alive, w, h0, c0)`` runs the recurrence over x [L, b, 4H]
(the projected inputs plus bias, gate columns [i, f, c, o]) with the
recurrent weight w [H, 4H], the carries h0, c0 [b, H] and the 0/1 mask
alive [L, b, 1], and returns the CARRY sequences hs, cs [L, b, H],
unmasked: a step with alive 0 keeps the previous carries. Each step's gate
product is the reference's bf16 recipe: ``bf16(h_{t-1}) · bf16(w)`` summed
in float32. ``lstm_seq_bwd`` returns (dx, dw, dh0, dc0) from the saved
carries and the carries' cotangents, with the two bf16 roundings of the
reference's vjp (``jax.make_jaxpr`` of ``_lstm_step_jnp``'s vjp): each
step's ``dW_t = h_{t-1}ᵀ·dgates_t`` and the product part of
``dh_{t-1} = dgates_t·Wᵀ`` are rounded to bfloat16 before they are added
in float32.

On CUDA tensors both launch ``csrc/lstm_seq.cu`` (a persistent cooperative
kernel; see the source for the design); on CPU tensors they run
``lstm_seq_torch`` / ``lstm_seq_bwd_torch``, the plain versions, which the
CPU tests hold against the reference. :class:`LstmSeq` is the
``torch.autograd.Function`` that pairs them, saving the reference's
residuals ``(x, alive, w, h0, c0, hs, cs)``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# kernel launches since the last reset; only a launch adds
launches = {"lstm_seq": 0, "lstm_seq_bwd": 0}

# the kernel's limits (csrc/lstm_seq.cu): one block per 4 hidden units and
# every batch row; each block holds up to 217 KB of shared memory, so one
# block fits an SM, and all H/4 blocks must be resident at once (128 of the
# H100's 132 SMs at H 512)
MAX_BATCH, MAX_HIDDEN, HIDDEN_MULTIPLE = 64, 512, 16


def reset_launches():
    for k in launches:
        launches[k] = 0


def supported(batch, hidden, dtype, device=None) -> bool:
    """Shapes the kernels take: float32, 1 ≤ b ≤ 64, H a multiple of 16 up
    to 512, and on a CUDA ``device`` no more blocks (H/4) than the card has
    SMs, so that the cooperative launch can hold them all. The standard
    activations and no peepholes are the call site's part of the
    predicate."""
    ok = (dtype == torch.float32 and 1 <= batch <= MAX_BATCH
          and hidden % HIDDEN_MULTIPLE == 0
          and HIDDEN_MULTIPLE <= hidden <= MAX_HIDDEN)
    if ok and device is not None and device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        ok = hidden // 4 <= sms
    return ok


def _bf16(t):
    """t rounded to bfloat16, kept in float32."""
    return t.bfloat16().float()


def _cell(gates, c_prev, h_prev, alive):
    """The reference's ``_lstm_cell_jnp`` (rnn.py:31): gates [b, 4H] ->
    (h, c) carries, frozen where alive is 0."""
    hdim = gates.shape[-1] // 4
    i = torch.sigmoid(gates[:, :hdim])
    f = torch.sigmoid(gates[:, hdim:2 * hdim])
    cand = torch.tanh(gates[:, 2 * hdim:3 * hdim])
    o = torch.sigmoid(gates[:, 3 * hdim:])
    c = f * c_prev + i * cand
    h = o * torch.tanh(c)
    return (alive * h + (1 - alive) * h_prev,
            alive * c + (1 - alive) * c_prev)


def lstm_seq_torch(x, alive, w, h0, c0):
    """Plain version of the forward: the reference's per-step recipe in a
    loop over time. Returns (hs, cs), each [L, b, H]."""
    wb = _bf16(w)
    h, c = h0, c0
    hs, cs = [], []
    for t in range(x.shape[0]):
        h, c = _cell(x[t] + torch.matmul(_bf16(h), wb), c, h, alive[t])
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_seq_bwd_torch(x, alive, w, h0, c0, hs, cs, dhs, dcs):
    """Plain version of the backward: the reference's reverse scan of
    per-step vjps (rnn.py:133-156), written out in the operation order of
    the vjp's jaxpr, gates recomputed from the saved carries. Returns
    (dx, dw, dh0, dc0)."""
    hdim = h0.shape[-1]
    wb = _bf16(w)
    h_prevs = torch.cat([h0[None], hs[:-1]])
    c_prevs = torch.cat([c0[None], cs[:-1]])
    dh, dc = torch.zeros_like(h0), torch.zeros_like(c0)
    dw = torch.zeros_like(w)
    dx = torch.empty_like(x)
    for t in reversed(range(x.shape[0])):
        a, cp = alive[t], c_prevs[t]
        hb = _bf16(h_prevs[t])
        gates = x[t] + torch.matmul(hb, wb)
        i = torch.sigmoid(gates[:, :hdim])
        f = torch.sigmoid(gates[:, hdim:2 * hdim])
        u = torch.tanh(gates[:, 2 * hdim:3 * hdim])
        o = torch.sigmoid(gates[:, 3 * hdim:])
        tc = torch.tanh(f * cp + i * u)
        dh_t, dc_t = dh + dhs[t], dc + dcs[t]
        na = 1 - a
        bp = a * dh_t                   # d(h) inside the alive blend
        bs = (o * bp) * (1 - tc)        # through tanh(c): (g·(1-y)) + ...
        dcn = (a * dc_t + bs) + bs * tc  # ... (g·(1-y))·y
        d_cand = (i * dcn) * (1 - u)
        dg = torch.cat([(dcn * u) * (i * (1 - i)),
                        (dcn * cp) * (f * (1 - f)),
                        d_cand + d_cand * u,
                        (bp * tc) * (o * (1 - o))], dim=-1)
        dx[t] = dg
        dw = dw + _bf16(torch.matmul(hb.T, dg))
        dh = na * dh_t + _bf16(torch.matmul(dg, wb.T))
        dc = na * dc_t + f * dcn
    return dx, dw, dh, dc


def _check(name, tensors, dev):
    for tname, t, shape in tensors:
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {tname} must be a contiguous float32 tensor of "
                f"shape {shape} on {dev}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")


def _dims(name, x, w):
    L, b, h4 = x.shape
    hdim = h4 // 4
    if h4 != 4 * hdim or tuple(w.shape) != (hdim, h4) \
            or not supported(b, hdim, x.dtype):
        raise ValueError(
            f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} are outside "
            f"the kernel's shapes (float32, batch 1..{MAX_BATCH}, hidden a "
            f"multiple of {HIDDEN_MULTIPLE} up to {MAX_HIDDEN})")
    return L, b, hdim


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")


def lstm_seq(x, alive, w, h0, c0):
    """(hs, cs) [L, b, H]: the kernel on CUDA tensors, one cooperative
    launch; the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return lstm_seq_torch(x, alive, w, h0, c0)
    L, b, hdim = _dims("lstm_seq", x, w)
    _check("lstm_seq", [("x", x, (L, b, 4 * hdim)),
                        ("alive", alive, (L, b, 1)),
                        ("w", w, (hdim, 4 * hdim)), ("h0", h0, (b, hdim)),
                        ("c0", c0, (b, hdim))], x.device)
    hs = torch.empty((L, b, hdim), device=x.device)
    cs = torch.empty_like(hs)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.lstm_seq_fwd(
            x.data_ptr(), alive.data_ptr(), w.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), hs.data_ptr(), cs.data_ptr(), L, b, hdim,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "lstm_seq")
    launches["lstm_seq"] += 1
    return hs, cs


def lstm_seq_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs):
    """(dx, dw, dh0, dc0): the kernel on CUDA tensors, one cooperative
    launch walking time in reverse; the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return lstm_seq_bwd_torch(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    L, b, hdim = _dims("lstm_seq_bwd", x, w)
    seq = (L, b, hdim)
    _check("lstm_seq_bwd", [("x", x, (L, b, 4 * hdim)),
                            ("alive", alive, (L, b, 1)),
                            ("w", w, (hdim, 4 * hdim)),
                            ("h0", h0, (b, hdim)), ("c0", c0, (b, hdim)),
                            ("hs", hs, seq), ("cs", cs, seq),
                            ("dhs", dhs, seq), ("dcs", dcs, seq)], x.device)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.lstm_seq_bwd(
            x.data_ptr(), alive.data_ptr(), w.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
            dcs.data_ptr(), dx.data_ptr(), dw.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), L, b, hdim,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "lstm_seq_bwd")
    launches["lstm_seq_bwd"] += 1
    return dx, dw, dh0, dc0


def barrier_chain(blocks, steps, device):
    """Launch an empty cooperative kernel of ``blocks`` blocks that crosses
    ``steps`` grid-wide barriers: the serial floor of an L-step recurrence
    on this card (measured by chip_smoke.py; not on the path)."""
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.grid_barrier_chain(
            blocks, steps, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "grid_barrier_chain")


class LstmSeq(torch.autograd.Function):
    """``lstm_seq`` with ``lstm_seq_bwd`` as its backward: the reference's
    ``jax.custom_vjp`` pair (rnn.py:123-159). ``forward(x, alive, w, h0,
    c0)`` launches the forward; given the carries ``hs, cs`` of a forward
    that already ran, it returns them instead of running it again (the
    grad op differentiates the forward without a second launch). The
    residuals are the reference's ``(x, alive, w, h0, c0, hs, cs)``."""

    @staticmethod
    def forward(ctx, x, alive, w, h0, c0, hs=None, cs=None):
        if hs is None:
            hs, cs = lstm_seq(x, alive, w, h0, c0)
        ctx.save_for_backward(x, alive, w, h0, c0, hs, cs)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        dx, dw, dh0, dc0 = lstm_seq_bwd(*ctx.saved_tensors,
                                        dhs.contiguous(), dcs.contiguous())
        return dx, None, dw, dh0, dc0, None, None


def _lib():
    lib = _build.load("lstm_seq")
    if lib.lstm_seq_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_seq_fwd.argtypes = [p] * 7 + [i, i, i, p]
        lib.lstm_seq_fwd.restype = i
        lib.lstm_seq_bwd.argtypes = [p] * 13 + [i, i, i, p]
        lib.lstm_seq_bwd.restype = i
        lib.grid_barrier_chain.argtypes = [i, i, p]
        lib.grid_barrier_chain.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
