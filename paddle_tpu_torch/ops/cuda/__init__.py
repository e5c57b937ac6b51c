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
``optimizer`` (``optimizer.py``: momentum_arena, adam_arena) and ``lstm``
(``rnn.py``: lstm_seq and its backward).

Routing contract: a shape outside a kernel's ``supported()`` set is routed
to the plain op chain by design and counted in :func:`fallback_counts`. A
supported shape on a CUDA tensor launches the kernel or raises — there is no
silent fallback after a failed build or launch.
"""

from __future__ import annotations

from ...core.flags import get_flag

_TIERS = ("auto", "cuda", "torch")

# kernel family -> number of supported=False dispatches routed to the plain
# op chain under a tier that wanted the kernel
_FALLBACKS: dict[str, int] = {}


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
        _FALLBACKS[kernel] = _FALLBACKS.get(kernel, 0) + 1
        return False
    return True


def fallback_counts():
    """{kernel: unsupported shapes routed to the plain op chain}; kernels
    with zero fallbacks are omitted."""
    return {k: n for k, n in _FALLBACKS.items() if n}


def reset_fallback_counts():
    _FALLBACKS.clear()


__all__ = ["resolve_tier", "use_kernel", "fallback_counts",
           "reset_fallback_counts"]
