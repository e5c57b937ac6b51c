"""The port's recordio (paddle_tpu_torch/recordio over native/recordio.cc)
against tests/test_recordio.py's contracts, each backend forced in turn,
and against the JAX package's files: raw and dense records byte-equal on
both backends and both compressors over multi-chunk files, LoD batches
read across the packages both ways, a corrupted chunk refused by both, and
no other ``paddle_tpu`` class decoded."""

import os
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu import recordio as jrec
from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu.core.lod import pack_sequences as jpack

import paddle_tpu_torch.reader as treader
from paddle_tpu_torch import recordio
from paddle_tpu_torch.core.lod import LoDArray, pack_sequences
from paddle_tpu_torch.reader import creator

BACKENDS = ["python", "native"]
COMPRESSORS = ["raw", "deflate"]


def _records(n=137):
    rng = np.random.RandomState(0)
    return [bytes(rng.randint(0, 256, rng.randint(0, 400),
                              dtype=np.uint8)) for _ in range(n)]


def _dense(n=45):
    rng = np.random.RandomState(1)
    return [(rng.rand(3, 4).astype("float32"),
             rng.randint(0, 9, (3, 1)).astype("int64")) for _ in range(n)]


def test_native_backend_builds_into_the_build_tree():
    """The library builds at first use under build/recordio/, keyed by the
    source's hash, never beside the package."""
    assert recordio._native_lib() is not None, recordio.native_error()
    assert recordio.backend() == "native"
    so = recordio.library_path()
    assert so.exists() and so.parent.name == "recordio" \
        and so.parent.parent.name == "build"
    pkg = os.path.dirname(recordio.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


@pytest.mark.parametrize("write_be", BACKENDS)
@pytest.mark.parametrize("read_be", BACKENDS)
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_roundtrip_cross_backend(tmp_path, write_be, read_be, compressor):
    recs = _records()
    path = str(tmp_path / "f.recordio")
    recordio.write_records(path, recs, compressor=compressor,
                           max_records=20, backend=write_be)
    assert recordio.read_records(path, backend=read_be) == recs


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("compressor", COMPRESSORS)
@pytest.mark.parametrize("kind", ["raw", "dense"])
def test_files_byte_equal_across_packages(tmp_path, backend, compressor,
                                          kind):
    """The same records give the same file in both packages (20-record
    chunks, so several chunks a file)."""
    if kind == "raw":
        ref_recs = port_recs = _records()
    else:
        ref_recs = [pickle.dumps(s) for s in _dense()]
        port_recs = [recordio.dumps(s) for s in _dense()]
    a, b = str(tmp_path / "ref.rio"), str(tmp_path / "port.rio")
    jrec.write_records(a, ref_recs, compressor=compressor, max_records=20,
                       backend=backend)
    recordio.write_records(b, port_recs, compressor=compressor,
                           max_records=20, backend=backend)
    data = open(a, "rb").read()
    assert data == open(b, "rb").read()
    assert data.count(b"TPHC") >= 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_each_package_reads_the_others_files(tmp_path, backend):
    recs = _records(50)
    a, b = str(tmp_path / "ref.rio"), str(tmp_path / "port.rio")
    jrec.write_records(a, recs, max_records=7, backend=backend)
    recordio.write_records(b, recs, max_records=7, backend=backend)
    assert recordio.read_records(a, backend=backend) == recs
    assert jrec.read_records(b, backend=backend) == recs


def _lod_batches(n=6):
    rng = np.random.RandomState(2)
    out = []
    for _ in range(n):
        seqs = [rng.randint(0, 30, (int(rng.randint(1, 6)), 1))
                .astype("int64") for _ in range(4)]
        out.append((seqs, rng.randint(0, 2, (4, 1)).astype("int64")))
    return out


def test_lod_batches_cross_both_ways(tmp_path):
    """A LoD batch the port writes is the bytes the reference writes for
    it and decodes into the reference's LoDArray; a reference file decodes
    into the port's LoDArray."""
    batches = _lod_batches()
    ref_path, port_path = str(tmp_path / "r.rio"), str(tmp_path / "p.rio")
    jrec.write_records(ref_path, [
        pickle.dumps({"w": jpack(s), "y": y}) for s, y in batches])
    n = creator.convert_reader_to_recordio_file(
        port_path, lambda: iter({"w": pack_sequences(s), "y": y}
                                for s, y in batches))
    assert n == len(batches)
    assert open(ref_path, "rb").read() == open(port_path, "rb").read()
    for (seqs, y), rec in zip(batches, creator.recordio(ref_path)()):
        w = rec["w"]
        assert type(w) is LoDArray
        np.testing.assert_array_equal(w.lens, [len(s) for s in seqs])
        np.testing.assert_array_equal(np.asarray(w.data),
                                      np.asarray(pack_sequences(seqs).data))
        np.testing.assert_array_equal(rec["y"], y)
    for (seqs, _), raw in zip(batches, jrec.Scanner(port_path)):
        w = pickle.loads(raw)["w"]
        assert type(w) is JLoD
        np.testing.assert_array_equal(np.asarray(w.lens),
                                      [len(s) for s in seqs])


def test_torch_tensors_go_on_disk_as_numpy(tmp_path):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert recordio.dumps((t, 3)) == pickle.dumps((t.numpy(), 3))


def test_scanner_refuses_other_reference_classes():
    from paddle_tpu.core.scope import Scope
    raw = pickle.dumps({"w": Scope()})
    with pytest.raises(pickle.UnpicklingError, match="never imports"):
        recordio.loads(raw)


@pytest.mark.parametrize("read_be", BACKENDS)
def test_corrupt_payload_raises_wrong_checksum_in_both(tmp_path, read_be):
    recs = [b"hello", b"world", b"records"]
    path = str(tmp_path / "c.recordio")
    recordio.write_records(path, recs, compressor="deflate",
                           backend="python")
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(recordio.WrongChecksum):
        recordio.read_records(path, backend=read_be)
    with pytest.raises(jrec.WrongChecksum):
        jrec.read_records(path, backend=read_be)


@pytest.mark.parametrize("backend", BACKENDS)
def test_truncated_file_raises(tmp_path, backend):
    path = str(tmp_path / "t.recordio")
    recordio.write_records(path, [b"abc"], backend="python")
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) - 10])
    with pytest.raises(recordio.CorruptRecordIO):
        recordio.read_records(path, backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_not_a_recordio_file(tmp_path, backend):
    path = str(tmp_path / "x.bin")
    open(path, "wb").write(b"definitely not a recordio file")
    with pytest.raises(OSError):
        recordio.Scanner(path, backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_exhausted_scanner_raises_stopiteration(tmp_path, backend):
    path = str(tmp_path / "e.recordio")
    recordio.write_records(path, [b"a", b"b"], backend="python")
    s = recordio.Scanner(path, backend=backend)
    assert list(s) == [b"a", b"b"]
    with pytest.raises(StopIteration):
        next(s)
    with pytest.raises(StopIteration):
        next(s)  # still safe after close


def test_reader_stack_over_recordio(tmp_path):
    """file reader -> shuffle -> batch over a recordio file written from a
    sample reader (tests/test_recordio.py's input-pipeline bottom half)."""
    rng = np.random.RandomState(1)
    samples = [(rng.rand(4).astype("float32"), int(i % 3))
               for i in range(57)]
    path = str(tmp_path / "samples.recordio")
    n = creator.convert_reader_to_recordio_file(
        path, lambda: iter(samples), max_records=10)
    assert n == 57
    rd = treader.batch(treader.shuffle(creator.recordio(path), buf_size=32),
                       batch_size=8)
    seen = []
    for b in rd():
        assert 1 <= len(b) <= 8
        for feat, lbl in b:
            assert feat.shape == (4,) and feat.dtype == np.float32
            seen.append((tuple(feat.tolist()), lbl))
    assert len(seen) == 57
    assert set(seen) == {(tuple(f.tolist()), l) for f, l in samples}


def test_fluid_recordio_writer_matches_the_reference(tmp_path):
    """fluid.recordio_writer with a DataFeeder: the port's file is the
    reference's for the same batches, dense and LoD columns alike, and
    each package reads the other's records."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid

    rng = np.random.RandomState(3)
    batches = [[(rng.randint(0, 20, int(rng.randint(1, 5))).tolist(),
                 rng.rand(3).astype("float32"), [int(rng.randint(0, 2))])
                for _ in range(4)] for _ in range(5)]
    paths = {}
    for key, fluid in (("ref", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w = fluid.layers.data("w", shape=[1], dtype="int64",
                                  lod_level=1)
            x = fluid.layers.data("x", shape=[3])
            y = fluid.layers.data("y", shape=[1], dtype="int64")
        feeder = fluid.DataFeeder([w, x, y], fluid.CPUPlace())
        paths[key] = str(tmp_path / f"{key}.rio")
        n = fluid.recordio_writer.convert_reader_to_recordio_file(
            paths[key], lambda: iter(batches), feeder, max_num_records=2)
        assert n == 5
    assert open(paths["ref"], "rb").read() == \
        open(paths["port"], "rb").read()
    got = [recordio.loads(r) for r in recordio.Scanner(paths["ref"])]
    assert [list(r) for r in got] == [["w", "x", "y"]] * 5
    assert type(got[0]["w"]) is LoDArray
