"""Command-line tools of the port (counterparts of the repo's ``tools/``):
``python -m paddle_tpu_torch.tools.lint_program``."""
