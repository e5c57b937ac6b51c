"""Ragged paged attention, the decode step's attend (counterpart of
paddle_tpu/ops/pallas/paged_attention.py: ``paged_attention_pallas`` :100,
kernel ``_paged_attn_kernel`` :53, predicate :43, twin
``paged_attention_jnp`` :137).

``paged_attention_cuda(qh, kc, vc, bt, ctx_lens)``: one decode step's
attention for every slot, qh [S, H, D] against the arenas kc/vc
[num_blocks, block_size, H, D] through block tables bt [S, P] and context
lengths ctx_lens [S]; returns [S, H, D], zeros where ctx_lens is 0. On CUDA
tensors it calls ``csrc/paged_attention.cu`` once: each slot's table is cut
into ``paged_attention_nsplit(P, block_size)`` partitions of
``part_blocks(block_size)`` blocks (about ``PART`` positions), one CTA per
(slot, head, partition) walks its live positions with an online softmax,
never gathering the context; with more than one partition a second small
kernel merges the partitions' states in partition order (flash-decoding),
through a float32 workspace this wrapper allocates. On CPU tensors it runs
the plain version, ``paged_attention_torch``: the reference twin's gather
of the [S, P * block_size, H, D] context, a softmax masked at -1e9 past
each slot's length, and inactive rows zeroed.
``paged_attention_split_torch`` models the kernel's decomposition (the
partitions' states, then the merge) on the CPU for the tests.

``paged_attention_op`` (``torch.ops.paddle_tpu_torch.paged_attention``) is
the wrapper as a ``torch.library`` operator, which the decode op calls: a
``torch.export`` trace of the decode program keeps it whole, so an
exported decode program (``serving/execcache.py``) still launches the
kernel.
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
# positions a partition holds, rounded down to whole KV blocks (at least
# one): of 128, 256 and 512, 256 took the least time at the Llama-2-7B
# decode shape with random contexts on the H100 (decode_arena.py --parts
# part; PERF.md); the serving lane's tables (16 blocks of 8) fit one
# partition, so it takes the single-pass path
PART = 256


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


def part_blocks(bs):
    """KV blocks a partition holds: ``PART`` positions rounded down to
    whole blocks, at least one."""
    return max(1, PART // bs)


def paged_attention_nsplit(p, bs):
    """Partitions a slot's table of ``p`` blocks of ``bs`` positions is cut
    into, from the static shapes alone (no sync on the lengths):
    ceil(p / part_blocks(bs)). 1 takes the single-pass path."""
    return -(-p // part_blocks(bs))


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
    # -1e9 in the scores' dtype: -inf in float16, as the reference's
    # jnp.where casts it (a CUDA where refuses the overflowing scalar)
    masked = torch.full((), -1e9, device=scores.device).to(scores.dtype)
    scores = torch.where(live[:, None, :], scores, masked)
    pw = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhc,bchd->bhd", pw, vctx)
    return torch.where((cl > 0)[:, None, None], out, 0.0)


def paged_attention_split_torch(qh, kc, vc, bt, ctx_lens, part):
    """Plain model of the kernel's decomposition, for the tests: the
    context cut into partitions of ``part`` positions; per partition its
    running max m, normalizer l and unnormalized weighted sum acc (m = -inf,
    l = 0 where the partition holds no live position); then the merge in
    partition order, ``sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M) l_i``
    with M the largest m_i; zeros for rows with ctx_len == 0."""
    nb, bs = kc.shape[0], kc.shape[1]
    s, p = bt.shape
    c = p * bs
    nsplit = -(-c // part)
    pos = torch.arange(bs, dtype=torch.int64, device=bt.device)
    idx = (bt.long()[:, :, None] * bs + pos[None, None, :]).reshape(s, -1)
    kctx = kc.reshape((nb * bs,) + kc.shape[2:])[idx]       # [s, C, H, D]
    vctx = vc.reshape((nb * bs,) + vc.shape[2:])[idx]
    d = qh.shape[-1]
    scores = torch.einsum("bhd,bchd->bhc", qh, kctx) * (d ** -0.5)
    cl = ctx_lens.long().clamp(max=c)
    live = torch.arange(c, device=bt.device)[None, :] < cl[:, None]
    scores = torch.where(live[:, None, :], scores, -torch.inf)
    ms, ls, accs = [], [], []
    for i in range(nsplit):
        sc = scores[:, :, i * part:(i + 1) * part]            # [s, H, n]
        m = sc.amax(-1)
        w = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(w.sum(-1))
        accs.append(torch.einsum("bhn,bnhd->bhd", w,
                                 vctx[:, i * part:(i + 1) * part]))
    big = torch.stack(ms).amax(0)
    big = torch.where(torch.isinf(big), 0.0, big)
    num = torch.zeros_like(qh)
    den = torch.zeros_like(big)
    for m, l, acc in zip(ms, ls, accs):
        f = torch.exp(m - big)
        num = num + f[..., None] * acc
        den = den + f * l
    out = num / torch.where(den > 0, den, 1.0)[..., None]
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
    bs, p = kc.shape[1], bt.shape[1]
    nsplit = paged_attention_nsplit(p, bs)
    # the partitions' (m, l) pairs and accumulators; none for one partition
    ws = torch.empty(s * h * nsplit * (d + 2), dtype=torch.float32,
                     device=dev) if nsplit > 1 else None
    lib = _lib()
    err = _build.call_on(
        dev, lib.paged_attention, qh.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), bt.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, s, h, d, bs, p,
        part_blocks(bs), d ** -0.5)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err} ({lib.kernel_error_string(err).decode()})")
    launches["paged_attention"] += 1
    return out


@torch.library.custom_op("paddle_tpu_torch::paged_attention",
                         mutates_args=())
def paged_attention_op(qh: torch.Tensor, kc: torch.Tensor,
                       vc: torch.Tensor, bt: torch.Tensor,
                       ctx_lens: torch.Tensor) -> torch.Tensor:
    """``torch.ops.paddle_tpu_torch.paged_attention``: :func:`paged_attention_cuda`
    as an operator that ``torch.export`` keeps whole in a graph. On CUDA
    tensors it launches the kernel, on CPU tensors it runs the plain
    version (the wrapper's own dispatch); its fake implementation gives
    the output's shape, q's [S, H, D]."""
    return paged_attention_cuda(qh, kc, vc, bt, ctx_lens)


@paged_attention_op.register_fake
def _paged_attention_fake(qh, kc, vc, bt, ctx_lens):
    return torch.empty_like(qh)


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, ctypes.c_float, p]
        lib.paged_attention.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
