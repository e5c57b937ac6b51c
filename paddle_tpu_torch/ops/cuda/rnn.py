"""The whole-sequence LSTM and GRU and their backwards, one launch each
(counterpart of paddle_tpu/ops/pallas/rnn.py: ``lstm_seq_pallas``, forward
``:84`` and the custom_vjp backward ``:133``; ``gru_seq_pallas``, forward
``:195`` and the custom_vjp backward ``:242``).

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

On CUDA tensors both launch ``csrc/lstm_seq.cu`` (persistent cooperative
kernels; see the source for the design: the forward forms each step's
gates on batch-row groups with ``mma.sync``, W's columns resident in bf16;
the backward recomputes every step's gates in one tensor-core GEMM, runs
only the cotangents' chain step by step on batch-row groups, and forms dW
in a last tensor-core pass); on CPU tensors they run
``lstm_seq_torch`` / ``lstm_seq_bwd_torch``, the plain versions, which the
CPU tests hold against the reference. :class:`LstmSeq` is the
``torch.autograd.Function`` that pairs them, saving the reference's
residuals ``(x, alive, w, h0, c0, hs, cs)``.

``gru_seq(x, alive, w, h0)`` is the GRU's counterpart over x [L, b, 3H]
(gate columns [u, r, c]) and w [H, 3H]: ``ur = bf16(h_{t-1}) · bf16(w_ur)``,
``c = tanh(x_c + bf16(r ⊙ h_{t-1}) · bf16(w_c))``, ``h = u·c + (1-u)·h_{t-1}``;
it returns the carries hs [L, b, H]. ``gru_seq_bwd`` returns (dx, dw, dh0)
with the four bf16 roundings of the reference's vjp (``jax.make_jaxpr`` of
``_gru_step_jnp``'s vjp): both products of the backward,
``dpre_c · W_cᵀ`` and ``[dpre_u | dpre_r] · W_urᵀ``, and both parts of
each step's dW_t are rounded to bfloat16 before they are added in
float32. Both launch ``csrc/gru_seq.cu`` on CUDA tensors (the forward
forms its gates on batch-row groups with ``mma.sync``, the backward as the
LSTM's) and run
``gru_seq_torch`` / ``gru_seq_bwd_torch`` on CPU tensors; :class:`GruSeq`
pairs them with the residuals ``(x, alive, w, h0, hs)``.

The forwards are also ``torch.library`` operators,
``torch.ops.paddle_tpu_torch.lstm_seq`` and ``::gru_seq``
(:func:`lstm_seq_op`, :func:`gru_seq_op`), which ``LstmSeq``/``GruSeq``
and the recurrent ops outside autograd call, so that ``torch.export``
keeps the launch, with the padded length symbolic (``fluid/aot.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# kernel launches since the last reset; only a launch adds
launches = {"lstm_seq": 0, "lstm_seq_bwd": 0, "gru_seq": 0,
            "gru_seq_bwd": 0}

# the backwards' last launch's stage clocks: int64 [4] on the card, block
# 0's clock64 at the start, after the prologue, after the chain and after
# its epilogue (chip_smoke.py prints the stages' shares)
stage_clocks = {"lstm_seq_bwd": None, "gru_seq_bwd": None}

# the kernels' limits (csrc/lstm_seq.cu, csrc/gru_seq.cu): H/4 blocks, each
# holding up to 204 KB of shared memory, so one block fits an SM, and all
# of them must be resident at once (128 of the H100's 132 SMs at H 512);
# a forward block and a backward chain block own 32 units of 8 batch rows,
# or 16 of 16 where H is not a multiple of 32, so the grid holds 64 rows
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
    """Each (tname, tensor, shape[, dtype]) must be a contiguous tensor of
    that shape and dtype (float32 unless given) on ``dev``."""
    for tname, t, shape, *dtype in tensors:
        dtype = dtype[0] if dtype else torch.float32
        if t.dtype != dtype or t.device != dev \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {tname} must be a contiguous "
                f"{str(dtype).removeprefix('torch.')} tensor of "
                f"shape {shape} on {dev}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")


def _dims(name, x, w, gates=4):
    L, b, hg = x.shape
    hdim = hg // gates
    if hg != gates * hdim or tuple(w.shape) != (hdim, hg) \
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
    clocks = torch.empty(4, dtype=torch.int64, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.lstm_seq_bwd(
            x.data_ptr(), alive.data_ptr(), w.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
            dcs.data_ptr(), dx.data_ptr(), dw.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), clocks.data_ptr(), L, b, hdim,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "lstm_seq_bwd")
    launches["lstm_seq_bwd"] += 1
    stage_clocks["lstm_seq_bwd"] = clocks
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


def gru_seq_torch(x, alive, w, h0):
    """Plain version of the GRU forward: the reference's ``_gru_seq_kernel``
    step (rnn.py:166-192) in a loop over time. Returns hs [L, b, H]."""
    hdim = h0.shape[-1]
    wb = _bf16(w)
    h = h0
    hs = []
    for t in range(x.shape[0]):
        a, xt = alive[t], x[t]
        ur = torch.matmul(_bf16(h), wb[:, :2 * hdim])
        u = torch.sigmoid(xt[:, :hdim] + ur[:, :hdim])
        r = torch.sigmoid(xt[:, hdim:2 * hdim] + ur[:, hdim:])
        c = torch.tanh(xt[:, 2 * hdim:]
                       + torch.matmul(_bf16(r * h), wb[:, 2 * hdim:]))
        hn = u * c + (1.0 - u) * h
        h = a * hn + (1 - a) * h
        hs.append(h)
    return torch.stack(hs)


def gru_seq_bwd_torch(x, alive, w, h0, hs, dhs):
    """Plain version of the GRU backward: the reference's reverse scan of
    per-step vjps (rnn.py:242-257), written out in the operation order of
    the vjp's jaxpr, gates recomputed from the saved carries. Returns
    (dx, dw, dh0)."""
    hdim = h0.shape[-1]
    wb = _bf16(w)
    w_ur, w_c = wb[:, :2 * hdim], wb[:, 2 * hdim:]
    h_prevs = torch.cat([h0[None], hs[:-1]])
    dh = torch.zeros_like(h0)
    dw = torch.zeros_like(w)
    dx = torch.empty_like(x)
    for t in reversed(range(x.shape[0])):
        a, xt, hp = alive[t], x[t], h_prevs[t]
        hb = _bf16(hp)
        ur = torch.matmul(hb, w_ur)
        u = torch.sigmoid(xt[:, :hdim] + ur[:, :hdim])
        r = torch.sigmoid(xt[:, hdim:2 * hdim] + ur[:, hdim:])
        rh = _bf16(r * hp)
        c = torch.tanh(xt[:, 2 * hdim:] + torch.matmul(rh, w_c))
        e = dh + dhs[t]
        bl = a * e
        bn = (1 - a) * e + (1 - u) * bl
        du = bl * c - bl * hp
        bt = (u * bl) * (1 - c)
        dpc = bt + bt * c
        cd = _bf16(torch.matmul(dpc, w_c.T))
        dpr = (cd * hp) * (r * (1 - r))
        dpu = du * (u * (1 - u))
        dur = torch.cat([dpu, dpr], dim=-1)
        dx[t] = torch.cat([dur, dpc], dim=-1)
        dw = dw + torch.cat([_bf16(torch.matmul(hb.T, dur)),
                             _bf16(torch.matmul(rh.T, dpc))], dim=-1)
        dh = (bn + r * cd) + _bf16(torch.matmul(dur, w_ur.T))
    return dx, dw, dh


def gru_seq(x, alive, w, h0):
    """hs [L, b, H]: the kernel on CUDA tensors, one cooperative launch;
    the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return gru_seq_torch(x, alive, w, h0)
    L, b, hdim = _dims("gru_seq", x, w, 3)
    _check("gru_seq", [("x", x, (L, b, 3 * hdim)),
                       ("alive", alive, (L, b, 1)),
                       ("w", w, (hdim, 3 * hdim)), ("h0", h0, (b, hdim))],
           x.device)
    hs = torch.empty((L, b, hdim), device=x.device)
    rh = torch.empty((b, hdim), dtype=torch.bfloat16,
                     device=x.device)                # bf16(r ⊙ h_{t-1})
    lib = _gru_lib()
    with torch.cuda.device(x.device):
        err = lib.gru_seq_fwd(
            x.data_ptr(), alive.data_ptr(), w.data_ptr(), h0.data_ptr(),
            hs.data_ptr(), rh.data_ptr(), L, b, hdim,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "gru_seq")
    launches["gru_seq"] += 1
    return hs


def gru_seq_bwd(x, alive, w, h0, hs, dhs):
    """(dx, dw, dh0): the kernel on CUDA tensors, one cooperative launch
    walking time in reverse; the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return gru_seq_bwd_torch(x, alive, w, h0, hs, dhs)
    L, b, hdim = _dims("gru_seq_bwd", x, w, 3)
    seq = (L, b, hdim)
    _check("gru_seq_bwd", [("x", x, (L, b, 3 * hdim)),
                           ("alive", alive, (L, b, 1)),
                           ("w", w, (hdim, 3 * hdim)),
                           ("h0", h0, (b, hdim)), ("hs", hs, seq),
                           ("dhs", dhs, seq)], x.device)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dh0 = torch.empty_like(h0)
    rh = torch.empty(seq, device=x.device)    # every step's bf16(r ⊙ h)
    clocks = torch.empty(4, dtype=torch.int64, device=x.device)
    lib = _gru_lib()
    with torch.cuda.device(x.device):
        err = lib.gru_seq_bwd(
            x.data_ptr(), alive.data_ptr(), w.data_ptr(), h0.data_ptr(),
            hs.data_ptr(), dhs.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            dh0.data_ptr(), rh.data_ptr(), clocks.data_ptr(), L, b, hdim,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "gru_seq_bwd")
    launches["gru_seq_bwd"] += 1
    stage_clocks["gru_seq_bwd"] = clocks
    return dx, dw, dh0


@torch.library.custom_op("paddle_tpu_torch::lstm_seq", mutates_args=())
def lstm_seq_op(x: torch.Tensor, alive: torch.Tensor, w: torch.Tensor,
                h0: torch.Tensor, c0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.ops.paddle_tpu_torch.lstm_seq``: :func:`lstm_seq` as an
    operator that ``torch.export`` keeps whole, the padded length
    symbolic, so that an exported program launches the kernel. CUDA
    tensors launch it, CPU tensors run the plain version."""
    return lstm_seq(x, alive, w, h0, c0)


@lstm_seq_op.register_fake
def _lstm_seq_fake(x, alive, w, h0, c0):
    shape = (x.shape[0], x.shape[1], w.shape[0])
    return x.new_empty(shape), x.new_empty(shape)


@torch.library.custom_op("paddle_tpu_torch::gru_seq", mutates_args=())
def gru_seq_op(x: torch.Tensor, alive: torch.Tensor, w: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """``torch.ops.paddle_tpu_torch.gru_seq``: :func:`gru_seq` as an
    operator, as :func:`lstm_seq_op`."""
    return gru_seq(x, alive, w, h0)


@gru_seq_op.register_fake
def _gru_seq_fake(x, alive, w, h0):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[0]))


class GruSeq(torch.autograd.Function):
    """``gru_seq`` with ``gru_seq_bwd`` as its backward: the reference's
    ``jax.custom_vjp`` pair (rnn.py:232-260). Given the carries ``hs`` of a
    forward that already ran, ``forward`` returns them instead of
    launching again. The residuals are the reference's
    ``(x, alive, w, h0, hs)``."""

    @staticmethod
    def forward(ctx, x, alive, w, h0, hs=None):
        if hs is None:
            hs = torch.ops.paddle_tpu_torch.gru_seq(x, alive, w, h0)
        ctx.save_for_backward(x, alive, w, h0, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        dx, dw, dh0 = gru_seq_bwd(*ctx.saved_tensors, dhs.contiguous())
        return dx, None, dw, dh0, None


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
            hs, cs = torch.ops.paddle_tpu_torch.lstm_seq(x, alive, w, h0,
                                                         c0)
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
        lib.lstm_seq_bwd.argtypes = [p] * 14 + [i, i, i, p]
        lib.lstm_seq_bwd.restype = i
        lib.grid_barrier_chain.argtypes = [i, i, p]
        lib.grid_barrier_chain.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _gru_lib():
    lib = _build.load("gru_seq")
    if lib.gru_seq_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_seq_fwd.argtypes = [p] * 6 + [i, i, i, p]
        lib.gru_seq_fwd.restype = i
        lib.gru_seq_bwd.argtypes = [p] * 11 + [i, i, i, p]
        lib.gru_seq_bwd.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
