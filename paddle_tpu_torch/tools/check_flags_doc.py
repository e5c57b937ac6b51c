"""Guard against flags-vs-docs drift in the port (counterpart of the repo's
``tools/check_flags_doc.py``): every ``DEFINE_flag`` name in
``paddle_tpu_torch/core/flags.py`` must have a row in the flag table of the
README's "PyTorch/CUDA port" section (a ``| `name` | ... |`` line between
that heading and the next top-level one). The source is parsed, not
imported, so the check needs no torch.

    python -m paddle_tpu_torch.tools.check_flags_doc

Exit 0 when the table covers every flag; exit 1 listing the missing ones.
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGS_PY = os.path.join(REPO, "paddle_tpu_torch", "core", "flags.py")
README = os.path.join(REPO, "README.md")
SECTION = "## PyTorch/CUDA port"


def defined_flags(flags_src):
    """DEFINE_flag("name", ...) occurrences, in definition order."""
    return re.findall(r'DEFINE_flag\(\s*["\']([A-Za-z0-9_]+)["\']',
                      flags_src)


def port_section(readme_src):
    """The README's port section: from its heading to the next ``## ``."""
    start = readme_src.find("\n" + SECTION + "\n")
    if start < 0:
        return ""
    end = readme_src.find("\n## ", start + len(SECTION) + 2)
    return readme_src[start:] if end < 0 else readme_src[start:end]


def documented_flags(readme_src):
    """Flag names with a table row (| `name` | ... |) in the port
    section."""
    return set(re.findall(r'^\|\s*`([A-Za-z0-9_]+)`\s*\|',
                          port_section(readme_src), flags=re.MULTILINE))


def main():
    with open(FLAGS_PY) as f:
        flags = defined_flags(f.read())
    if not flags:
        print(f"check_flags_doc: no DEFINE_flag found in {FLAGS_PY}: the "
              "parser is broken, not the docs", file=sys.stderr)
        return 1
    with open(README) as f:
        documented = documented_flags(f.read())
    missing = [n for n in flags if n not in documented]
    if missing:
        print("check_flags_doc: port flags missing from the README port "
              f"section's flag table ({len(missing)} of {len(flags)}):",
              file=sys.stderr)
        for n in missing:
            print(f"  | `{n}` | <default> | <what it does> |",
                  file=sys.stderr)
        return 1
    print(f"check_flags_doc: OK, {len(flags)} port flags all documented")
    return 0


if __name__ == "__main__":
    sys.exit(main())
