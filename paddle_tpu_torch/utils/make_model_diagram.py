"""Render a model config as a graphviz diagram.

Reference: python/paddle/utils/make_model_diagram.py — parses a config and
emits a .dot graph of layers. Here the graph source is the fluid Program's
op/var graph (``Program.to_graphviz``), parsed from a v2 config script or
built programmatically.
"""

from __future__ import annotations

import sys

__all__ = ["make_diagram", "make_diagram_from_program"]


def make_diagram_from_program(program, dot_path):
    dot = program.to_graphviz()
    with open(dot_path, "w") as f:
        f.write(dot)
    return dot


def make_diagram(config_file, dot_path, config_args=""):
    from ..v2.config_helpers import parse_config, parse_config_args

    args = parse_config_args(config_args)
    _topo, main, _startup = parse_config(config_file,
                                         config_args=args or None)
    return make_diagram_from_program(main, dot_path)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        raise SystemExit("usage: make_model_diagram conf.py out.dot "
                         "[config_args]")
    make_diagram(argv[0], argv[1], argv[2] if len(argv) > 2 else "")


if __name__ == "__main__":
    main()
