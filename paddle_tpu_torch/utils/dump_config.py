"""Dump the parsed config of a v2 config script.

Reference: python/paddle/utils/dump_config.py — ``python -m
paddle.utils.dump_config conf.py [config_args] [--whole|--binary]`` parses
the config and prints the TrainerConfig proto (model-only by default,
``--whole`` with trainer settings, ``--binary`` raw bytes). Here the parsed
artifact is the fluid Program: the default prints its debug string,
``--whole`` adds the settings/optimizer dict, ``--binary`` writes the
serialized JSON model bytes to stdout.
"""

from __future__ import annotations

import sys

__all__ = ["dump_config"]


def dump_config(conf_path, config_args="", whole=False, binary=False,
                out=None):
    from ..v2.config_helpers import parse_config, parse_config_args, \
        _SETTINGS

    out = out or sys.stdout
    args = parse_config_args(config_args)
    topo, main, _startup = parse_config(conf_path, config_args=args or None)
    if binary:
        data = main.to_json().encode("utf-8")
        (getattr(out, "buffer", out)).write(data)
        return
    if whole:
        print("# settings:", dict(_SETTINGS), file=out)
    print(main.to_debug_string(), file=out)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: dump_config conf.py [config_args] "
                         "[--whole|--binary]")
    conf = argv[0]
    config_args = ""
    whole = binary = False
    for a in argv[1:]:
        if a == "--whole":
            whole = True
        elif a == "--binary":
            binary = True
        else:
            config_args = a
    dump_config(conf, config_args, whole=whole, binary=binary)


if __name__ == "__main__":
    main()
