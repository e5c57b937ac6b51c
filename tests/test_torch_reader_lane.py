"""bench.py:352's ragged LSTM lane in both packages at a small size: the
bimodal corpus written to recordio, read back through each package's own
reader stack (``creator.recordio`` -> ``bucket_by_length``), padded to its
bucket's bound, each bound's batches staged with ``prepare_steps`` and run
with ``run_prepared`` on each package's executor on the CPU, the port from
the reference's startup state. The epoch's losses agree within 1e-5
relative, and the bucketed and flat epochs see the batches they should."""

import numpy as np
import pytest

import paddle_tpu.reader as jreader
from paddle_tpu.core.lod import pack_sequences as jpack

import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.testing import ragged_lane as lane

from torch_cross import build_both, port_scope, ref_state, tfluid

VOCAB, EMB, HIDDEN, BATCH, N, BOUNDS = 50, 8, 16, 8, 64, (4, 12)
SHORT, LONG = (2, 4), (10, 12)
REL = 1e-5


def _build(fluid):
    return lane.build(fluid, vocab=VOCAB, emb=EMB, hidden=HIDDEN)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The corpus written once by each package's writer."""
    d = tmp_path_factory.mktemp("lane")
    samples = lane.corpus(N, VOCAB, SHORT, LONG)
    paths = {"ref": str(d / "ref.recordio"), "port": str(d / "port.recordio")}
    assert jreader.creator.convert_reader_to_recordio_file(
        paths["ref"], lambda: iter(samples)) == N
    assert treader.creator.convert_reader_to_recordio_file(
        paths["port"], lambda: iter(samples)) == N
    return samples, paths


def test_corpus_files_are_byte_equal(files):
    _, paths = files
    assert open(paths["ref"], "rb").read() == open(paths["port"], "rb").read()


def test_bucketed_batches_equal_across_packages(files):
    samples, paths = files
    ref = lane.bucketed_batches(paths["ref"], BOUNDS, BATCH,
                                reader_pkg=jreader)
    got = lane.bucketed_batches(paths["port"], BOUNDS, BATCH)
    assert [b for _, b in got] == [b for _, b in ref]
    for (gc, _), (rc, _) in zip(got, ref):
        assert len(gc) == len(rc) == BATCH
        for (gs, gl), (rs, rl) in zip(gc, rc):
            assert gl == rl
            np.testing.assert_array_equal(gs, rs)
    # drop_last: every full bucket batch, short ones padded to 4, long to 12
    assert sorted({b for _, b in got}) == list(BOUNDS)
    assert sum(len(c) for c, _ in got) == N - N % BATCH


def _epoch_losses(batches, epochs=2):
    """Per-step losses of ``epochs`` epochs in each package, the port from
    the reference's startup state."""
    progs = build_both(_build)
    jmain, jstartup, jloss = progs["ref"]
    tmain, _, tloss = progs["port"]
    jexe, jscope, state = ref_state(jmain, jstartup)
    jgroups, jn = lane.groups(batches, pack=jpack)
    tgroups, tn = lane.groups(batches)
    assert jn == tn
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = port_scope(state)
    jh = lane.prepare(jexe, jmain, jloss, jscope, jgroups)
    th = lane.prepare(texe, tmain, tloss, tscope, tgroups)
    want = [lane.epoch(jexe, jh) for _ in range(epochs)]
    got = [lane.epoch(texe, th) for _ in range(epochs)]
    return np.concatenate(got), np.concatenate(want)


@pytest.mark.parametrize("path", ["bucketed", "flat"])
def test_lane_epoch_losses_match_the_reference(files, path):
    samples, paths = files
    if path == "bucketed":
        batches = lane.bucketed_batches(paths["port"], BOUNDS, BATCH)
    else:
        batches = lane.flat_batches(samples, BATCH, BOUNDS[-1])
        assert {b for _, b in batches} == {BOUNDS[-1]}
    got, want = _epoch_losses(batches)
    assert got.shape == want.shape == (2 * len(batches),)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
