"""``paddle.trainer`` — the legacy config front-end package.

Reference: python/paddle/trainer/ (config_parser.py — served here by
``paddle_tpu_torch.v2.config_helpers.parse_config`` — and PyDataProvider2.py,
the @provider data-provider protocol)."""

from . import PyDataProvider2  # noqa: F401

__all__ = ["PyDataProvider2"]
