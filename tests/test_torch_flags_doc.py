"""The port's flags-vs-docs guard (counterpart of tests/test_flags_doc.py):
every ``DEFINE_flag`` in paddle_tpu_torch/core/flags.py has a row in the
flag table of the README's port section, checked by the port's tool run
as a subprocess; and the check fails on a missing row."""

import os
import re
import subprocess
import sys

from paddle_tpu_torch.tools import check_flags_doc as mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_port_flag_documented_in_the_port_section():
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.tools.check_flags_doc"],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK, 61 port flags" in r.stdout


def test_checker_detects_a_missing_row():
    flags = mod.defined_flags(open(mod.FLAGS_PY).read())
    assert len(flags) == 61 and "conv_space_to_depth" in flags
    readme = open(mod.README).read()
    assert set(flags) <= mod.documented_flags(readme)
    broken = re.sub(r"^\|\s*`conv_space_to_depth`.*\n", "", readme,
                    flags=re.MULTILINE)
    assert "conv_space_to_depth" not in mod.documented_flags(broken)
    # a row outside the port section does not count
    port = mod.port_section(readme)
    outside = readme.replace(port, re.sub(
        r"^\|\s*`use_pallas_ctc`.*\n", "", port, flags=re.MULTILINE))
    assert "use_pallas_ctc" not in mod.documented_flags(outside)
