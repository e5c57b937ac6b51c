"""The port's paddle_trainer (paddle_tpu_torch/v2/trainer_cli.py): its
train, test, checkgrad and time jobs over the reference's fc CLI config
as subprocesses with ``--use_gpu=false``, the reference RNN benchmark
config in-process through ``--reader``, checkgrad catching a planted
gradient fault, ``--job=merge`` refusing with its reason, and (``-m
cuda``) every job on the card. This file imports no JAX, so that the card
case runs where there is none."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.testing import legacy_lane as lane
from paddle_tpu_torch.v2 import trainer_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG, RNN_CONFIG = lane.CLI_CONFIG, lane.RNN_CONFIG


def _config(tmp_path, text=CONFIG):
    path = tmp_path / "cfg.py"
    path.write_text(text)
    return str(path)


def _run_cli(tmp_path, *args, device="cpu"):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, str(tmp_path)]))
    use = [] if device == "cuda" else ["--use_gpu=false"]
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.v2.trainer_cli",
         f"--config={_config(tmp_path)}", *use, *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)


def _pass_costs(stdout):
    return [float(line.split("cost=")[1]) for line in stdout.splitlines()
            if line.startswith("Pass")]


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_trainer_cli.py on the GPU "
                    "machine)")


@pytest.mark.parametrize("device", DEVICES)
def test_job_train(tmp_path, device):
    _need(device)
    r = _run_cli(tmp_path, "--job=train", "--num_passes=2", device=device)
    assert r.returncode == 0, r.stdout + r.stderr
    costs = _pass_costs(r.stdout)
    assert len(costs) == 2 and costs[1] < costs[0], costs


@pytest.mark.parametrize("device", DEVICES)
def test_job_test(tmp_path, device):
    _need(device)
    r = _run_cli(tmp_path, "--job=test", device=device)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("Test: "), r.stdout


@pytest.mark.parametrize("device", DEVICES)
def test_job_checkgrad(tmp_path, device):
    """Every parameter's directional gradient within 1% of the central
    finite difference (Trainer.cpp:366's '***' gate)."""
    _need(device)
    r = _run_cli(tmp_path, "--job=checkgrad", device=device)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "***" not in r.stdout, r.stdout
    assert r.stdout.count("diff=") == 4 and "checkgrad max diff" in r.stdout


@pytest.mark.parametrize("device", DEVICES)
def test_job_time(tmp_path, device):
    _need(device)
    r = _run_cli(tmp_path, "--job=time", "--batches_per_pass=3",
                 device=device)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ms/batch over 3 batches" in r.stdout
    assert ("busy share of a profiled step" in r.stdout) == \
        (device == "cuda"), r.stdout


def test_job_merge_refuses_with_its_reason(tmp_path):
    r = _run_cli(tmp_path, "--job=merge", f"--model_dir={tmp_path / 'm'}")
    assert r.returncode == 2, r.stdout + r.stderr
    assert "paddle_tpu/fluid/aot.py" in r.stderr and "A12" in r.stderr
    assert not (tmp_path / "m").exists()


def test_rnn_config_trains_in_process_through_a_reader(tmp_path, capsys,
                                                       monkeypatch):
    """rnn.py at narrow widths over legacy_lane's parity reader (8
    sequences of 6 ids a batch, 4 batches): the pass cost falls."""
    for k, v in dict(BATCHES=4, BATCH=8, LENGTH=6, VOCAB=40).items():
        monkeypatch.setattr(lane, k, v)
    cfg = _config(tmp_path, RNN_CONFIG)
    args = [f"--config={cfg}", "--use_gpu=false",
            "--config_args=batch_size=8,hidden_size=16,vocab_size=40,"
            "emb_size=8,lstm_num=2",
            "--reader=paddle_tpu_torch.testing.legacy_lane:reader"]
    assert trainer_cli.main(args + ["--job=train", "--num_passes=6"]) == 0
    costs = _pass_costs(capsys.readouterr().out)
    assert len(costs) == 6 and costs[-1] < costs[0], costs
    assert trainer_cli.main(args + ["--job=time"]) == 0
    assert "ms/batch over 4 batches" in capsys.readouterr().out
    assert trainer_cli.main(args + ["--job=test"]) == 0
    assert capsys.readouterr().out.startswith("Test: ")


def test_parity_batches_label_the_last_token():
    batches = lane.parity_batches(3, 2, 5, 7, 11)
    assert len(batches) == 2 and len(batches[0]) == 5
    for ids, (label,) in batches[1]:
        assert ids.shape == (7, 1) and ids.dtype == np.int64
        assert label == ids[-1, 0] % 2 and ids.max() < 11


def test_checkgrad_catches_a_planted_gradient_fault(tmp_path, capsys,
                                                    monkeypatch):
    """relu_grad doubled: the first fc's weight and bias fail the 1%
    check, the job exits 1."""
    from paddle_tpu_torch.core import registry
    info = registry.get_op_info("relu_grad")
    good = info.forward

    def doubled(ctx):
        good(ctx)
        name = ctx.op.output("X@GRAD")[0]
        ctx.env[name] = ctx.env[name] * 2

    monkeypatch.setattr(info, "forward", doubled)
    rc = trainer_cli.main([f"--config={_config(tmp_path)}",
                           "--use_gpu=false", "--job=checkgrad"])
    out = capsys.readouterr().out
    assert rc == 1 and out.count("***") == 2, out


def test_the_card_is_the_default(tmp_path):
    """Without --use_gpu=false the jobs take the card; without one they
    fail, naming CPUPlace: nothing falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; test_job_* cover it under -m cuda")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        trainer_cli.main([f"--config={_config(tmp_path)}", "--job=train"])


def test_synthetic_reader_is_deterministic(tmp_path):
    from paddle_tpu_torch.v2.config_helpers import parse_config
    topo, _, _ = parse_config(_config(tmp_path))
    a = list(trainer_cli._synthetic_reader(topo, 4, 2)())
    b = list(trainer_cli._synthetic_reader(topo, 4, 2)())
    assert len(a) == 2 and len(a[0]) == 4
    for ra, rb in zip(a, b):
        for sa, sb in zip(ra, rb):
            np.testing.assert_array_equal(sa[0], sb[0])
            assert sa[1] == sb[1]
