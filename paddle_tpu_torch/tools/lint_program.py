"""Lint/verify a saved program bundle from the command line (counterpart of
tools/lint_program.py, with its output lines and exit codes).

Usage:
    python -m paddle_tpu_torch.tools.lint_program <model_dir>           # verify + lint
    python -m paddle_tpu_torch.tools.lint_program <model_dir> --strict  # warnings fail too
    python -m paddle_tpu_torch.tools.lint_program <model_dir> --json    # machine-readable

``model_dir`` is a ``save_inference_model`` bundle (a directory holding a
``__model__`` file) OR a bare ``__model__``-format JSON file. The program
is parsed without loading persistables or making an executor, so the tool
touches no device and is safe on untrusted bundles.

Prints one line per finding::

    PTL003 error block 0 op#4(conv2d): input 'w' is not declared ...

Exit code: 0 clean (or warnings only), 1 on verifier errors (or any
finding under --strict), 2 on unreadable input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_program_meta(path):
    """Returns (program, feed_names, fetch_names) from a bundle dir or a
    raw __model__ JSON file, without executing anything."""
    model_file = os.path.join(path, "__model__") if os.path.isdir(path) \
        else path
    with open(model_file) as f:
        meta = json.load(f)
    from ..fluid.framework import Program
    program = Program.from_dict(meta)
    return (program, meta.get("feed_var_names", []),
            meta.get("fetch_var_names", []))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="static-analyze a saved inference bundle")
    ap.add_argument("model_dir", help="save_inference_model bundle dir or "
                                      "__model__ JSON file")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings too")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array")
    args = ap.parse_args(argv)

    try:
        program, feeds, fetches = load_program_meta(args.model_dir)
    except (OSError, json.JSONDecodeError, KeyError, ValueError) as e:
        print(f"lint_program: cannot read {args.model_dir!r}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2

    from ..fluid.analysis import ERROR, lint_program, verify_program
    diags = verify_program(program, feed_names=feeds, fetch_names=fetches,
                           raise_on_error=False)
    diags += lint_program(program, fetch_names=fetches)

    if args.as_json:
        print(json.dumps([{
            "code": d.code, "severity": d.severity, "message": d.message,
            "block": d.block_idx, "op": d.op_idx, "op_type": d.op_type,
            "var": d.var} for d in diags], indent=2))
    else:
        for d in diags:
            print(d)
        errors = sum(d.severity == ERROR for d in diags)
        print(f"lint_program: {len(diags)} finding(s), {errors} error(s) "
              f"in {args.model_dir}")

    if any(d.severity == ERROR for d in diags):
        return 1
    if args.strict and diags:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
