"""Global flags registry (counterpart of paddle_tpu/core/flags.py), holding
only the flags this slice reads: ``kernel_tier`` and
``serving_batch_buckets``."""

from __future__ import annotations

_FLAGS: dict[str, dict] = {}


def DEFINE_flag(name, default, help_str=""):
    if name not in _FLAGS:
        _FLAGS[name] = {"value": default, "default": default,
                        "help": help_str, "type": type(default)}
    return _FLAGS[name]["value"]


def get_flag(name):
    return _FLAGS[name]["value"]


def set_flags(flags: dict):
    """fluid.set_flags({'kernel_tier': 'torch'}) — unknown flags raise."""
    for name, value in flags.items():
        if name not in _FLAGS:
            raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
        _FLAGS[name]["value"] = _FLAGS[name]["type"](value)


DEFINE_flag("kernel_tier", "auto",
            "which lowering the hot-op dispatch sites use: 'auto' (the "
            "hand-written kernel for CUDA tensors, the plain PyTorch op "
            "chain for CPU tensors), 'cuda' (the kernel route for every "
            "supported shape; on CPU tensors the kernel wrapper runs its "
            "plain twin), or 'torch' (the plain PyTorch op chain "
            "everywhere). A shape outside a kernel's supported() set routes "
            "to the plain op chain and bumps ops.cuda.fallback_counts()")

DEFINE_flag("serving_batch_buckets", "1,2,4,8,16,32",
            "comma-separated batch buckets the serving InferenceEngine pads "
            "incoming batches up to; batches beyond the largest bucket are "
            "chunked through it (serving/engine.py)")
