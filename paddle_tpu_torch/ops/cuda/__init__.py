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

The deprecated flags ``use_pallas_rnn`` (``lstm``, ``gru``) and
``use_pallas_ctc`` (``ctc``) still force their families' kernel route on
CUDA tensors under any tier, with a one-time DeprecationWarning each.

Routing contract: a shape outside a kernel's ``supported()`` set is routed
to the plain op chain by design and counted in :func:`fallback_counts`, on
the obs.metrics family the reference counts its Pallas fallbacks in
(``paddle_tpu_pallas_fallbacks``; the name kept for scrape parity). A
supported shape on a CUDA tensor launches the kernel or raises — there is no
silent fallback after a failed build or launch.
"""

from __future__ import annotations

import warnings

from ...core.flags import get_flag
from ...obs.metrics import REGISTRY as _METRICS

_TIERS = ("auto", "cuda", "torch")

# kernel family -> the deprecated flag that used to gate it (reference
# pallas/__init__.py:50)
_LEGACY_FLAGS = {
    "lstm": "use_pallas_rnn",
    "gru": "use_pallas_rnn",
    "ctc": "use_pallas_ctc",
}

_warned_legacy: set = set()

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


def _legacy_forced(kernel):
    """Whether the kernel family's deprecated flag is set (reference
    pallas/__init__.py:62); warns once per flag."""
    name = _LEGACY_FLAGS.get(kernel)
    if name is None or not get_flag(name):
        return False
    if name not in _warned_legacy:
        _warned_legacy.add(name)
        warnings.warn(
            f"flag {name!r} is deprecated: use kernel_tier='cuda' (or "
            "'auto', which picks the kernels for CUDA tensors) instead; the "
            "old flag is still honored and forces the kernel route for its "
            "kernels on CUDA tensors", DeprecationWarning, stacklevel=3)
    return True


def wants_kernel(kernel, device):
    """Does the tier, or the family's deprecated flag, want the kernel
    route for tensors on ``device``? A deprecated flag wins over
    ``kernel_tier`` on CUDA tensors only: it never moves work off the
    device it is on, and CPU tensors keep their tier's route."""
    forced = _legacy_forced(kernel) and device.type == "cuda"
    return forced or resolve_tier(device) == "cuda"


def use_kernel(kernel, supported, device):
    """Should this dispatch take the kernel route? ``supported`` is the call
    site's shape/config predicate; an unsupported shape under a tier that
    wants the kernel routes to the plain op chain with a counter bump."""
    if not wants_kernel(kernel, device):
        return False
    if not supported:
        record_fallback(kernel)
        return False
    return True


def record_fallback(kernel):
    """Count one dispatch of ``kernel`` that a tier or a pinned variant
    wanted on the kernel route and that took the plain chain."""
    _M_FALLBACKS.labels(kernel=kernel).inc()


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


def launch_counts():
    """{wrapper: kernel launches since its module's last reset}, over every
    kernel module (each wrapper counts its own launches; a tile variant
    counts under its own name, ``conv_affine_db``)."""
    from . import ctc, embedding, optimizer, paged_attention
    out = {}
    for mod in (conv_bn, optimizer, embedding, rnn, ctc, paged_attention):
        for name in mod.launches:
            out[name] = int(mod.launches[name])
    return out


__all__ = ["resolve_tier", "wants_kernel", "use_kernel", "record_fallback",
           "fallback_counts", "reset_fallback_counts", "launch_counts"]

# the kernels' torch.library operators (torch.ops.paddle_tpu_torch.*),
# which an exported artifact calls (fluid/aot.py)
from . import conv_bn, paged_attention, rnn  # noqa: E402,F401
