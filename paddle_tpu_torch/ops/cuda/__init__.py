"""The CUDA kernel tier (counterpart of paddle_tpu/ops/pallas/__init__.py).

Every Pallas kernel of the reference on a ported path has a kernel written
by hand for Hopper (sources under ``paddle_tpu_torch/csrc/``) and, beside
it in the same module, a plain PyTorch version of the same function.

Tier selection (the ``kernel_tier`` flag):

* ``auto`` (default) — the kernel route for CUDA tensors, the plain op
  chain for CPU tensors.
* ``cuda`` — the kernel route for every supported shape. A kernel wrapper
  given CPU tensors runs its plain version (what the CPU parity tests use,
  as the reference's tests run Pallas in interpret mode).
* ``torch`` — the plain op chain everywhere: the reference the card-side
  checks compare the kernels against.

Kernel families (the names ``use_kernel`` and ``fallback_counts`` use):
``conv_bn`` (``conv_bn.py``: conv_affine, conv_bn_train, conv_bn_bwd),
``optimizer`` (``optimizer.py``: sgd_arena, momentum_arena, adam_arena),
``embedding_sgd`` (``embedding.py``: the sparse SGD step of an embedding
table), ``lstm`` and ``gru`` (``rnn.py``: lstm_seq, gru_seq and their
backwards), ``ctc`` (``ctc.py``: ctc_alpha and ctc_loss_bwd) and
``paged_attention`` (``paged_attention.py``: the generation decode step's
ragged attention through the paged KV arena).

Routing contract: a shape outside a kernel's ``supported()`` set is routed
to the plain op chain by design and counted in :func:`fallback_counts`, on
the obs.metrics family the reference counts its Pallas fallbacks in
(``paddle_tpu_pallas_fallbacks``; the name kept for scrape parity). A
supported shape on a CUDA tensor launches the kernel or raises — there is no
silent fallback after a failed build or launch.
"""

from __future__ import annotations

from ...core.flags import get_flag
from ...obs.metrics import REGISTRY as _METRICS

_TIERS = ("auto", "cuda", "torch")

# per kernel family: supported=False dispatches routed to the plain op chain
# under a tier that wanted the kernel
_M_FALLBACKS = _METRICS.counter(
    "paddle_tpu_pallas_fallbacks",
    "unsupported shapes routed from the kernel tier to the plain op chain, "
    "per kernel family (the reference's family name)",
    labels=("kernel",))


def _tier():
    t = get_flag("kernel_tier")
    if t not in _TIERS:
        raise ValueError(f"kernel_tier must be auto|cuda|torch, got {t!r}")
    return t


def resolve_tier(device):
    """The route the flag resolves to for tensors on ``device``: 'cuda'
    (the kernel route) or 'torch' (the plain op chain)."""
    t = _tier()
    if t == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return t


def use_kernel(kernel, supported, device):
    """Should this dispatch take the kernel route? ``supported`` is the call
    site's shape/config predicate; an unsupported shape under a tier that
    wants the kernel routes to the plain op chain with a counter bump."""
    if resolve_tier(device) != "cuda":
        return False
    if not supported:
        _M_FALLBACKS.labels(kernel=kernel).inc()
        return False
    return True


def fallback_counts():
    """{kernel: unsupported shapes routed to the plain op chain}; kernels
    with zero fallbacks are omitted."""
    out = {}
    for key, child in _M_FALLBACKS.children().items():
        n = int(child.value)
        if n:
            out[key[0]] = n
    return out


def reset_fallback_counts():
    _M_FALLBACKS.reset()


__all__ = ["resolve_tier", "use_kernel", "fallback_counts",
           "reset_fallback_counts"]
