"""Ragged paged attention, the decode step's attend (counterpart of
paddle_tpu/ops/pallas/paged_attention.py: ``paged_attention_pallas`` :100,
kernel ``_paged_attn_kernel`` :53, predicate :43, twin
``paged_attention_jnp`` :137).

``paged_attention_cuda(qh, kc, vc, bt, ctx_lens)``: one decode step's
attention for every slot, qh [S, H, D] against the arenas kc/vc
[num_blocks, block_size, H, D] through block tables bt [S, P] and context
lengths ctx_lens [S]; returns [S, H, D], zeros where ctx_lens is 0. On CUDA
tensors it launches ``csrc/paged_attention.cu`` once: one CTA per (slot,
head) walks the slot's live positions through its table with an online
softmax, never gathering the context. On CPU tensors it runs the plain
version, ``paged_attention_torch``: the reference twin's gather of the
[S, P * block_size, H, D] context, a softmax masked at -1e9 past each
slot's length, and inactive rows zeroed.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# kernel launches since the last reset; only a launch adds
launches = {"paged_attention": 0}

# one block's K + V, a q row and the accumulator within 4 MiB: the
# reference's resident-set budget (:38), kept so both packages route the
# same shapes to their kernels
_BUDGET_BYTES = 4 * 1024 * 1024
# the kernel keeps ceil(D / 32) <= 8 elements per lane
MAX_HEAD_DIM = 256


def reset_launches():
    for k in launches:
        launches[k] = 0


def paged_attention_supported(qh, kc, bt):
    """The kernel's shapes: the reference predicate (float32 q and arena,
    P >= 1, one block's K + V, a q row and the accumulator within 4 MiB)
    and a head dim of at most 256."""
    if qh.dtype != torch.float32 or kc.dtype != torch.float32:
        return False
    nb, bs, h, d = kc.shape
    per_step = 4 * (2 * bs * h * d + 2 * h * d + h * d)
    return bt.shape[1] >= 1 and per_step <= _BUDGET_BYTES \
        and d <= MAX_HEAD_DIM


def paged_attention_torch(qh, kc, vc, bt, ctx_lens):
    """Plain version: gather every table row's [P * block_size] context,
    scores ``q·k * D^-0.5`` masked to -1e9 at positions >= ctx_len,
    softmax, the weighted sum of V, and zeros for rows with ctx_len == 0
    (whose softmax over garbage is finite, never NaN)."""
    nb, bs = kc.shape[0], kc.shape[1]
    b = bt.shape[0]
    pos = torch.arange(bs, dtype=torch.int64, device=bt.device)
    idx = (bt.long()[:, :, None] * bs + pos[None, None, :]).reshape(b, -1)
    kctx = kc.reshape((nb * bs,) + kc.shape[2:])[idx]       # [b, C, H, D]
    vctx = vc.reshape((nb * bs,) + vc.shape[2:])[idx]
    d = qh.shape[-1]
    scores = torch.einsum("bhd,bchd->bhc", qh, kctx) * (d ** -0.5)
    cl = ctx_lens.long()
    live = torch.arange(idx.shape[1], device=bt.device)[None, :] \
        < cl[:, None]                                        # [b, C]
    scores = torch.where(live[:, None, :], scores, -1e9)
    pw = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhc,bchd->bhd", pw, vctx)
    return torch.where((cl > 0)[:, None, None], out, 0.0)


def paged_attention_cuda(qh, kc, vc, bt, ctx_lens):
    """The decode step's attend (see the module docstring): the kernel on
    CUDA tensors, the plain version on CPU tensors. Raises on what the
    kernel does not take."""
    if qh.device.type == "cpu":
        return paged_attention_torch(qh, kc, vc, bt, ctx_lens)
    dev = qh.device
    s, h, d = qh.shape
    if not paged_attention_supported(qh, kc, bt) or kc.shape != vc.shape \
            or vc.dtype != torch.float32 or kc.shape[2:] != (h, d) \
            or bt.dtype != torch.int32 or bt.ndim != 2 or bt.shape[0] != s \
            or ctx_lens.dtype != torch.int32 or ctx_lens.shape != (s,) \
            or not all(t.is_contiguous() for t in (qh, kc, vc, bt, ctx_lens)) \
            or any(t.device != dev for t in (kc, vc, bt, ctx_lens)):
        raise ValueError(
            "paged_attention: needs contiguous float32 q [S, H, D] and "
            "arenas [num_blocks, block_size, H, D] with D <= "
            f"{MAX_HEAD_DIM} and one block within the 4 MiB budget, int32 "
            f"tables [S, P >= 1] and int32 lengths [S], all on {dev}")
    out = torch.empty_like(qh)
    if s == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.paged_attention(
            qh.data_ptr(), kc.data_ptr(), vc.data_ptr(), bt.data_ptr(),
            ctx_lens.data_ptr(), out.data_ptr(), s, h, d, kc.shape[1],
            bt.shape[1], d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err} ({lib.kernel_error_string(err).decode()})")
    launches["paged_attention"] += 1
    return out


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                        ctypes.c_float, p]
        lib.paged_attention.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
