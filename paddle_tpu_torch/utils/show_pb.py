"""Print a saved model file.

Reference: python/paddle/utils/show_pb.py — reads a serialized ModelConfig
protobuf and prints it. The model wire format here is the JSON ``__model__``
written by ``fluid.io.save_inference_model`` / ``save_persistables``; this
pretty-prints it (or a Topology inference bundle).
"""

from __future__ import annotations

import json
import os
import sys

__all__ = ["show"]


def show(path, out=None):
    out = out or sys.stdout
    if os.path.isdir(path):
        path = os.path.join(path, "__model__")
    with open(path) as f:
        doc = json.load(f)
    json.dump(doc, out, indent=2)
    out.write("\n")
    return doc


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: show_pb <model-dir-or-__model__-file>")
    show(argv[0])


if __name__ == "__main__":
    main()
