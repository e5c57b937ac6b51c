"""The CTC alpha recurrence and its backward, one launch each (counterpart
of paddle_tpu/ops/pallas/ctc.py::ctc_alpha_pallas, kernel
``_ctc_alpha_kernel`` :23, with the XLA code around it in
``_ctc_loss_pallas``, ops/ctc_ops.py:104, and of the backward the reference
takes as ``jax.vjp`` of its scan, ops/ctc_ops.py:155 ``_ctc_pallas_bwd``).

``ctc_alpha(logp, x_lens, labels, y_lens, blank)`` returns the loss [b, 1]
of logp = log_softmax(logits) [b, T, C], labels [b, U] and the lengths [b]
int32: the kernel forms the blank-interleaved labels (Sp = 2U+1 padded to
a multiple of 8), the masks and alpha0 itself. Its plain version
``ctc_loss_fwd_torch`` is :func:`ctc_inputs`, the glue that forms the
Pallas kernel's inputs as the reference's XLA code does
(ctc_ops.py:111-147), then ``ctc_alpha_torch``, the plain version of the
Pallas kernel's interface (e [b, T, Sp] the log-probabilities at the
labels, padding -1e30; alpha0, can_skip and s_valid [b, Sp]; final0
[b, 1]).

``ctc_loss_bwd(logp, x_lens, labels, y_lens, blank, dloss)`` returns
dlogits [b, T, C] for logp = log_softmax(logits): the vjp of the
reference's scan ``_ctc_loss_scan`` (ctc_ops.py:41) with respect to logp,
taken through the log-softmax as ``dlogp − exp(logp)·Σ_c dlogp``.
:func:`ctc_scan` is the plain float32 port of that scan (after its
log-softmax), with jnp.logaddexp's value and custom-jvp gradient
(:class:`_LogAddExp`), and ``ctc_loss_bwd_torch`` is autograd through it.
The gradient is the scan's, not the alpha-beta formula: where a row is too
short for its labels every state stays at -1e30, logaddexp's weights
exp(x − out) are 1, and the reference's gradient grows threefold per step;
the kernel follows the scan's arithmetic and gives the same.

On CUDA tensors both launch ``csrc/ctc.cu`` (one block per batch row;
both keep only the recurrence, and the backward the cotangents' products,
on the first warps' serial chain, one named barrier a step, the other
warps gathering emissions a chunk of steps ahead; the backward scatters
the emissions' cotangents onto the classes after the chain); on CPU
tensors they run ``ctc_loss_fwd_torch`` / ``ctc_loss_bwd_torch``.
:class:`CtcLoss` is the ``torch.autograd.Function`` that pairs them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build as _build
from .rnn import _check, _raise_on

NEG = -1e30

# kernel launches since the last reset; only a launch adds
launches = {"ctc_alpha": 0, "ctc_loss_bwd": 0}

# each kernel's last launch's stage clocks: int64 [4] on the card, block
# 0's clock64 at the start, after the prologue (the forward) or the
# recompute (the backward), after the chain or the adjoint, and after the
# loss or the emission epilogue (chip_smoke.py prints the stages' shares)
stage_clocks = {"ctc_alpha": None, "ctc_loss_bwd": None}

# the kernels' limits (csrc/ctc.cu): one block per row holds nine [Sp]
# vectors, the class lists and chunks of up to 96 KB in shared memory
# (under 150 KB); the chain keeps up to 8 states a thread
MAX_S, MAX_CLASSES = 1024, 1024


def reset_launches():
    for k in launches:
        launches[k] = 0


def supported(frames, sp, classes, dtype) -> bool:
    """Shapes the kernels take: float32, more than one frame (the
    reference routes T == 1 to its scan), Sp and C (the classes) up to
    1024."""
    return (dtype == torch.float32 and frames > 1 and sp <= MAX_S
            and classes <= MAX_CLASSES)


def label_positions(max_label_len):
    """Sp: the 2U+1 blank-interleaved label positions, padded to a
    multiple of 8 (at least 8), as the Pallas kernel's rows are."""
    return max(8, -(-(2 * max_label_len + 1) // 8) * 8)


def _replace_inf(x):
    return torch.where(x == float("inf"), torch.zeros_like(x), x)


class _LogAddExp(torch.autograd.Function):
    """jnp.logaddexp (jax/_src/lax/other.py): ``max(a, b) +
    log1p(exp(-|a - b|))``, or ``a + b`` where ``a - b`` is nan; its
    gradient is the custom jvp's ``g·exp(a - out)``, ``g·exp(b - out)``,
    not autograd of the max."""

    @staticmethod
    def forward(ctx, a, b):
        d = a - b
        out = torch.where(torch.isnan(d), a + b, torch.maximum(a, b)
                          + torch.log1p(torch.exp(-d.abs())))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        o = _replace_inf(out)
        return (g * torch.exp(_replace_inf(a) - o),
                g * torch.exp(_replace_inf(b) - o))


logaddexp = _LogAddExp.apply


def _extended(labels, y_lens, blank):
    """(z, s_valid, can_skip) [b, S] of the blank-interleaved labels
    (reference ctc_ops.py:48-55)."""
    b, U = labels.shape
    S = 2 * U + 1
    dev = labels.device
    z = torch.full((b, S), blank, dtype=torch.long, device=dev)
    z[:, 1::2] = labels.long()
    pos = torch.arange(S, device=dev)
    s_valid = pos[None, :] < (2 * y_lens.long()[:, None] + 1)
    z_prev2 = F.pad(z, (2, 0), value=-1)[:, :S]
    can_skip = (pos[None, :] % 2 == 1) & (z != z_prev2)
    return z, s_valid, can_skip


def _final_of(alpha, y_lens):
    """log(alpha[2U'] + alpha[2U'-1]) of each row (U' its label length)."""
    last = 2 * y_lens.long()
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_lab = torch.gather(alpha, 1, (last - 1).clamp_min(0)[:, None])[:, 0]
    a_lab = torch.where(y_lens > 0, a_lab, torch.full_like(a_lab, NEG))
    return logaddexp(a_last, a_lab)


def _alpha0(logp, z, s_valid, y_lens, blank):
    """alpha at t = 0 (reference :60-64), [b, S]."""
    b, S = z.shape
    lp0 = logp[:, 0]
    first = torch.gather(lp0, 1, z[:, 1:2]) if S > 1 else lp0[:, :1]
    first = torch.where(y_lens[:, None] > 0, first,
                        torch.full_like(first, NEG))
    alpha0 = torch.cat([lp0[:, blank:blank + 1], first,
                        torch.full((b, max(S - 2, 0)), NEG,
                                   dtype=logp.dtype, device=logp.device)],
                       dim=1)[:, :S]
    return torch.where(s_valid, alpha0, torch.full_like(alpha0, NEG))


def ctc_scan(logp, x_lens, labels, y_lens, blank):
    """The reference's ``_ctc_loss_scan`` (ctc_ops.py:41-97) after its
    log-softmax, in float32: logp [b, T, C], labels [b, U]; returns the
    loss [b, 1]. Differentiable (autograd takes the scan's gradient)."""
    b, T, _ = logp.shape
    z, s_valid, can_skip = _extended(labels, y_lens, blank)
    S = z.shape[1]
    neg = torch.full((b, S), NEG, dtype=logp.dtype, device=logp.device)
    alpha = _alpha0(logp, z, s_valid, y_lens, blank)
    final = torch.where(x_lens == 1, _final_of(alpha, y_lens), neg[:, 0])
    for t in range(1, T):
        a1 = F.pad(alpha, (1, 0), value=NEG)[:, :S]
        a2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=NEG)[:, :S],
                         neg)
        merged = logaddexp(logaddexp(alpha, a1), a2)
        nxt = torch.where(s_valid, merged + torch.gather(logp[:, t], 1, z),
                          neg)
        alpha = torch.where((t < x_lens)[:, None], nxt, alpha)
        final = torch.where(t == x_lens - 1, _final_of(alpha, y_lens),
                            final)
    return (-final)[:, None]


def ctc_inputs(logp, labels, y_lens, x_lens, blank):
    """The Pallas kernel's inputs (reference ctc_ops.py:111-147), padded to
    Sp = max(8, S rounded up to 8): (e [b, T, Sp], alpha0 [b, Sp], final0
    [b, 1], can_skip and s_valid [b, Sp] float 0/1)."""
    b, T, _ = logp.shape
    z, s_valid, can_skip = _extended(labels, y_lens, blank)
    S = z.shape[1]
    alpha0 = _alpha0(logp, z, s_valid, y_lens, blank)
    final0 = torch.where(x_lens == 1, _final_of(alpha0, y_lens),
                         torch.full((b,), NEG, dtype=logp.dtype,
                                    device=logp.device))
    pad = label_positions(labels.shape[1]) - S
    e = torch.gather(logp, 2, z[:, None, :].expand(b, T, S))
    e = F.pad(e, (0, pad), value=NEG)
    f32 = logp.dtype
    return (e.contiguous(), F.pad(alpha0, (0, pad), value=NEG).contiguous(),
            final0[:, None].contiguous(),
            F.pad(can_skip.to(f32), (0, pad)).contiguous(),
            F.pad(s_valid.to(f32), (0, pad)).contiguous())


def ctc_alpha_torch(e, alpha0, final0, can_skip, s_valid, x_lens, y_lens):
    """Plain version of the Pallas kernel's interface:
    ``_ctc_alpha_kernel``'s loop over t = 1..T-1 for every row at once.
    Returns the loss [b, 1]."""
    b, T, sp = e.shape
    pos = torch.arange(sp, device=e.device)
    neg = torch.full_like(alpha0, NEG)
    xl, yl = x_lens.reshape(b), y_lens.reshape(b)
    skip = (pos >= 2)[None, :] & (can_skip > 0)
    alpha, final = alpha0, final0[:, 0]
    for t in range(1, T):
        a1 = torch.where(pos[None, :] >= 1, torch.roll(alpha, 1, 1), neg)
        a2 = torch.where(skip, torch.roll(alpha, 2, 1), neg)
        merged = logaddexp(logaddexp(alpha, a1), a2)
        nxt = torch.where(s_valid > 0, merged + e[:, t], neg)
        alpha = torch.where((t < xl)[:, None], nxt, alpha)
        final = torch.where(t == xl - 1, _final_of(alpha, yl), final)
    return (-final)[:, None]


def ctc_loss_fwd_torch(logp, x_lens, labels, y_lens, blank):
    """Plain version of the forward: :func:`ctc_inputs`, then
    :func:`ctc_alpha_torch`. Returns the loss [b, 1]."""
    return ctc_alpha_torch(*ctc_inputs(logp, labels, y_lens, x_lens, blank),
                           x_lens, y_lens)


def ctc_loss_bwd_torch(logp, x_lens, labels, y_lens, blank, dloss):
    """Plain version of the backward: autograd through :func:`ctc_scan`
    with respect to logp, then through the log-softmax. Returns dlogits
    [b, T, C]."""
    with torch.enable_grad():
        leaf = logp.detach().requires_grad_(True)
        loss = ctc_scan(leaf, x_lens, labels, y_lens, blank)
        dlogp, = torch.autograd.grad(loss, leaf, dloss.reshape(loss.shape))
    return dlogp - torch.exp(logp) * dlogp.sum(-1, keepdim=True)


def ctc_alpha(logp, x_lens, labels, y_lens, blank):
    """The loss [b, 1]: the kernel on CUDA tensors (one block per row: the
    extended labels, masks and alpha0 formed in the kernel, the
    recurrence on the chain, the emissions gathered a chunk of steps
    ahead); the plain version on CPU tensors."""
    if logp.device.type == "cpu":
        return ctc_loss_fwd_torch(logp, x_lens, labels, y_lens, blank)
    b, T, C = logp.shape
    U = labels.shape[1]
    sp = label_positions(U)
    if not supported(T, sp, C, logp.dtype):
        raise ValueError(f"ctc_alpha: logp {tuple(logp.shape)} {logp.dtype} "
                         f"with Sp {sp} is outside the kernel's shapes "
                         f"(float32, T > 1, Sp and C up to {MAX_S})")
    labels = labels.to(torch.int64).contiguous()
    i32 = torch.int32
    _check("ctc_alpha", [("logp", logp, (b, T, C)),
                         ("labels", labels, (b, U), torch.int64),
                         ("x_lens", x_lens, (b,), i32),
                         ("y_lens", y_lens, (b,), i32)], logp.device)
    loss = torch.empty((b, 1), device=logp.device)
    clocks = torch.empty(4, dtype=torch.int64, device=logp.device)
    lib = _lib()
    err = _build.call_on(
        logp.device, lib.ctc_loss_fwd, logp.data_ptr(), labels.data_ptr(),
        x_lens.data_ptr(), y_lens.data_ptr(), loss.data_ptr(),
        clocks.data_ptr(), b, T, sp, C, U, blank)
    _raise_on(lib, err, "ctc_alpha")
    launches["ctc_alpha"] += 1
    stage_clocks["ctc_alpha"] = clocks
    return loss


def ctc_loss_bwd(logp, x_lens, labels, y_lens, blank, dloss):
    """dlogits [b, T, C]: the kernel on CUDA tensors (one block per row:
    the extended labels, masks and alpha0 formed in the kernel, alpha and
    the adjoint's weights recomputed into a scratch, the scan's adjoint
    walked back in time, the emissions' cotangents written over alpha,
    then scattered from the label positions and taken through the
    log-softmax); the plain version on CPU tensors."""
    if logp.device.type == "cpu":
        return ctc_loss_bwd_torch(logp, x_lens, labels, y_lens, blank, dloss)
    b, T, C = logp.shape
    U = labels.shape[1]
    sp = label_positions(U)
    if not supported(T, sp, C, logp.dtype):
        raise ValueError(f"ctc_loss_bwd: logp {tuple(logp.shape)} "
                         f"{logp.dtype} with Sp {sp} is outside the kernel's "
                         f"shapes (float32, T > 1, Sp and C up to {MAX_S})")
    labels = labels.to(torch.int64).contiguous()
    dloss = dloss.reshape(b).to(torch.float32).contiguous()
    f32, i32 = torch.float32, torch.int32
    _check("ctc_loss_bwd", [("logp", logp, (b, T, C), f32),
                            ("labels", labels, (b, U), torch.int64),
                            ("x_lens", x_lens, (b,), i32),
                            ("y_lens", y_lens, (b,), i32)], logp.device)
    dlogits = torch.empty_like(logp)
    lib = _lib()
    # every step's alpha (then its emissions' cotangent) and the adjoint's
    # weights, per row
    scratch = torch.empty((b, lib.ctc_bwd_scratch(T, sp)), device=logp.device)
    clocks = torch.empty(4, dtype=torch.int64, device=logp.device)
    with torch.cuda.device(logp.device):
        err = lib.ctc_loss_bwd(
            logp.data_ptr(), labels.data_ptr(), x_lens.data_ptr(),
            y_lens.data_ptr(), dloss.data_ptr(), scratch.data_ptr(),
            dlogits.data_ptr(), clocks.data_ptr(), b, T, sp, C, U, blank,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "ctc_loss_bwd")
    launches["ctc_loss_bwd"] += 1
    stage_clocks["ctc_loss_bwd"] = clocks
    return dlogits


def chain_floor(frames, device, backward=True):
    """Launch one warp that runs a kernel's serial chain alone: the
    forward's ``frames`` dependent steps (two logaddexp and an add), and
    with ``backward`` the adjoint's as many after them (products, a
    neighbour's value and adds): the floor of one row's forward or
    backward on this card (measured by chip_smoke.py; not on the path)."""
    vals = torch.tensor([-3.0, -1.5, 0.5, 0.75], device=device)
    out = torch.empty(2, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.ctc_chain_floor(vals.data_ptr(), out.data_ptr(), frames,
                                  int(backward),
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "ctc_chain_floor")
    return out


class CtcLoss(torch.autograd.Function):
    """The CTC loss [b, 1] of logits [b, T, C] through ``ctc_alpha``, with
    ``ctc_loss_bwd`` as its backward: the reference's ``jax.custom_vjp``
    pair ``_ctc_loss_pallas`` (ctc_ops.py:103-162). ``forward(logits,
    x_lens, labels, y_lens, blank)``; lengths are int32 [b]."""

    @staticmethod
    def forward(ctx, logits, x_lens, labels, y_lens, blank):
        logp = torch.log_softmax(logits, dim=-1)
        ctx.save_for_backward(logp, x_lens, labels, y_lens)
        ctx.blank = blank
        return ctc_alpha(logp, x_lens, labels, y_lens, blank)

    @staticmethod
    def backward(ctx, dloss):
        logp, x_lens, labels, y_lens = ctx.saved_tensors
        return (ctc_loss_bwd(logp, x_lens, labels, y_lens, ctx.blank, dloss),
                None, None, None, None)


def _lib():
    return _bind(_build.load("ctc"))


def _bind(lib):
    """``lib`` (a build of csrc/ctc.cu) with its C entries' types set."""
    if lib.ctc_loss_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ctc_loss_fwd.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.ctc_loss_fwd.restype = i
        lib.ctc_loss_bwd.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.ctc_loss_bwd.restype = i
        lib.ctc_chain_floor.argtypes = [p, p, i, i, p]
        lib.ctc_chain_floor.restype = i
        lib.ctc_bwd_scratch.argtypes = [i, i]
        lib.ctc_bwd_scratch.restype = ctypes.c_longlong
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
