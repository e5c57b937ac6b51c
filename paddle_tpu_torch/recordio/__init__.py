"""RecordIO: chunked record files with CRC + optional deflate compression
(counterpart of paddle_tpu/recordio/__init__.py, the same on-disk format).

Native core: paddle_tpu_torch/native/recordio.cc (C ABI), built with
``g++ -shared -lz`` at first use into ``build/recordio/`` at the repository
root (a directory git ignores), the library's file name keyed by a hash of
the source, as ``ops/cuda/build.py`` keys the kernels. A pure-Python
implementation of the IDENTICAL format (struct + zlib) serves where no
compiler or zlib header is at hand; :func:`backend` says which one the
default ``Writer``/``Scanner`` use.

Layout: ``PTRC0001`` file magic, then chunks of u32 magic ``0x43485054``
| u32 records | u32 compressor (0 raw, 1 deflate) | u64 raw length | u64
payload length | u32 crc32(payload) | payload, little-endian. A chunk
whose CRC fails raises ``WrongChecksum`` (Paddle's
go/pserver/service.go:53 contract).

Records of samples and batches are pickles: :func:`dumps` / :func:`loads`
are the record codec. A LoD batch goes on disk under the JAX package's
class name (``paddle_tpu.core.lod.LoDArray``, numpy leaves), so either
package reads the other's files; :func:`loads` maps that one name onto
this package's ``LoDArray`` and refuses any other ``paddle_tpu`` name.

API:
    with Writer(path, compressor="deflate") as w: w.write(b"...")
    for rec in Scanner(path): ...
"""

from __future__ import annotations

import copyreg
import ctypes
import hashlib
import io
import os
import pickle
import struct
import subprocess
import zlib
from pathlib import Path

from ..core.lod import LoDArray

_FILE_MAGIC = b"PTRC0001"
_CHUNK_MAGIC = 0x43485054
_RAW, _DEFLATE = 0, 1
_COMPRESSORS = {"raw": _RAW, "deflate": _DEFLATE}

SOURCE = Path(__file__).resolve().parents[1] / "native" / "recordio.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "recordio"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


class CorruptRecordIO(Exception):
    pass


class WrongChecksum(CorruptRecordIO):
    pass


# ---------------------------------------------------------------------------
# native backend (ctypes over the library, compiled lazily)
# ---------------------------------------------------------------------------

_LIB = None
_LIB_TRIED = False
_LIB_ERROR = None


def library_path() -> Path:
    """Where the native source builds to: keyed by a hash of the source and
    the compiler flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librecordio-{h.hexdigest()[:16]}.so"


def _native_lib():
    """Load (building if needed) the native library; None if unavailable
    (:func:`native_error` says why)."""
    global _LIB, _LIB_TRIED, _LIB_ERROR
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build beside the target and rename: concurrent first uses
            # (test workers) never load a half-written library
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                                str(SOURCE), "-lz"],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise OSError(f"g++ exit {r.returncode}: "
                              f"{r.stderr.strip()[-500:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        _LIB_ERROR = str(e)
        return None
    lib.ptrc_writer_open.restype = ctypes.c_void_p
    lib.ptrc_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_uint64]
    lib.ptrc_writer_write.restype = ctypes.c_int
    lib.ptrc_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64]
    lib.ptrc_writer_close.restype = ctypes.c_int
    lib.ptrc_writer_close.argtypes = [ctypes.c_void_p]
    lib.ptrc_scanner_open.restype = ctypes.c_void_p
    lib.ptrc_scanner_open.argtypes = [ctypes.c_char_p]
    lib.ptrc_scanner_next.restype = ctypes.c_int64
    lib.ptrc_scanner_next.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_char_p)]
    lib.ptrc_scanner_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def backend() -> str:
    """The backend a ``Writer``/``Scanner`` takes by default: "native" (the
    ctypes library) or "python"."""
    return "native" if _native_lib() is not None else "python"


def native_error():
    """Why the native library is unavailable (None where it loaded)."""
    _native_lib()
    return _LIB_ERROR


class Writer:
    """Append records; chunks flush at max_records/max_bytes boundaries
    (Paddle's recordio/writer.h)."""

    def __init__(self, path, compressor="deflate", max_records=1000,
                 max_bytes=1 << 20, backend=None):
        self._comp = _COMPRESSORS[compressor]
        self._closed = False
        lib = _native_lib() if backend in (None, "native") else None
        if lib is not None:
            self._lib = lib
            self._h = lib.ptrc_writer_open(os.fsencode(path), self._comp,
                                           max_records, max_bytes)
            if not self._h:
                raise OSError(f"cannot open {path!r} for writing")
            return
        if backend == "native":
            raise RuntimeError(f"native recordio backend unavailable: "
                               f"{_LIB_ERROR}")
        # pure-python form, identical format
        self._lib = None
        self._f = open(path, "wb")
        self._f.write(_FILE_MAGIC)
        self._buf = bytearray()
        self._n = 0
        self._max_records = max_records
        self._max_bytes = max_bytes

    def write(self, data: bytes):
        assert not self._closed
        if self._lib is not None:
            rc = self._lib.ptrc_writer_write(self._h, data, len(data))
            if rc != 0:
                raise OSError("recordio write failed")
            return
        self._buf += struct.pack("<I", len(data)) + data
        self._n += 1
        if self._n >= self._max_records or len(self._buf) >= self._max_bytes:
            self._flush()

    def _flush(self):
        if self._n == 0:
            return
        raw = bytes(self._buf)
        payload = zlib.compress(raw) if self._comp == _DEFLATE else raw
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(struct.pack("<IIIQQI", _CHUNK_MAGIC, self._n,
                                  self._comp, len(raw), len(payload), crc))
        self._f.write(payload)
        self._buf = bytearray()
        self._n = 0

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._lib is not None:
            rc = self._lib.ptrc_writer_close(self._h)
            if rc != 0:
                raise OSError("recordio close failed")
            return
        self._flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner:
    """Iterate records; verifies each chunk's CRC before use (Paddle's
    recordio/scanner.h + WrongChecksum)."""

    def __init__(self, path, backend=None):
        self._path = path
        lib = _native_lib() if backend in (None, "native") else None
        if lib is not None:
            self._lib = lib
            self._h = lib.ptrc_scanner_open(os.fsencode(path))
            if not self._h:
                raise OSError(f"{path!r}: not a recordio file")
            return
        if backend == "native":
            raise RuntimeError(f"native recordio backend unavailable: "
                               f"{_LIB_ERROR}")
        self._lib = None
        self._f = open(path, "rb")
        if self._f.read(8) != _FILE_MAGIC:
            self._f.close()
            raise OSError(f"{path!r}: not a recordio file")
        self._chunk = b""
        self._pos = 0
        self._remaining = 0
        self._eof = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._lib is not None:
            if self._h is None:       # already exhausted and closed
                raise StopIteration
            out = ctypes.c_char_p()
            n = self._lib.ptrc_scanner_next(self._h, ctypes.byref(out))
            if n == -1:
                self._lib.ptrc_scanner_close(self._h)
                self._h = None
                raise StopIteration
            if n == -3:
                raise WrongChecksum(self._path)
            if n < 0:
                raise CorruptRecordIO(self._path)
            return ctypes.string_at(out, n)
        if self._eof:
            raise StopIteration
        if self._remaining == 0 and not self._load_chunk():
            self._eof = True
            raise StopIteration
        if self._pos + 4 > len(self._chunk):
            raise CorruptRecordIO(self._path)
        (ln,) = struct.unpack_from("<I", self._chunk, self._pos)
        self._pos += 4
        if self._pos + ln > len(self._chunk):
            raise CorruptRecordIO(self._path)
        rec = self._chunk[self._pos:self._pos + ln]
        self._pos += ln
        self._remaining -= 1
        return rec

    def _load_chunk(self):
        head = self._f.read(32)
        if not head:
            self._f.close()
            return False
        if len(head) < 32:
            raise CorruptRecordIO(self._path)
        magic, n, comp, raw_len, pay_len, crc = struct.unpack("<IIIQQI",
                                                              head)
        if magic != _CHUNK_MAGIC:
            raise CorruptRecordIO(self._path)
        payload = self._f.read(pay_len)
        if len(payload) != pay_len:
            raise CorruptRecordIO(self._path)
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise WrongChecksum(self._path)
        self._chunk = zlib.decompress(payload) if comp == _DEFLATE \
            else payload
        if len(self._chunk) != raw_len:
            raise CorruptRecordIO(self._path)
        self._pos = 0
        self._remaining = n
        return True


def write_records(path, records, **kw):
    with Writer(path, **kw) as w:
        for r in records:
            w.write(r)


def read_records(path, **kw):
    return list(Scanner(path, **kw))


# ---------------------------------------------------------------------------
# the record codec: pickles that either package reads
# ---------------------------------------------------------------------------

# the JAX package's name of the LoD batch class, which its files carry
_LOD_WIRE_NAME = ("paddle_tpu.core.lod", "LoDArray")


class _NeedsWireNames(Exception):
    """Raised inside the fast pickler when the object holds a LoDArray or
    a torch tensor: :func:`dumps` then takes the naming pickler."""


def _is_torch(obj):
    return type(obj).__module__.split(".")[0] == "torch"


def _host(t):
    t = t.detach()
    if str(t.dtype) == "torch.bfloat16":
        t = t.float()
    return t.cpu().numpy()


class _FastPickler(pickle.Pickler):
    """``pickle.dumps`` itself, for records of plain data (the bytes the
    JAX package writes for them); gives up on a LoDArray or tensor."""

    def reducer_override(self, obj):
        if isinstance(obj, LoDArray) or _is_torch(obj):
            raise _NeedsWireNames
        return NotImplemented


class _RecordPickler(pickle._Pickler):
    """Writes a LoDArray under the JAX package's class name with numpy
    leaves, and a torch tensor as its numpy array, so the JAX package
    reads the record. The Python pickler, because only its
    ``save_global`` can be told a name."""

    def reducer_override(self, obj):
        if isinstance(obj, LoDArray):
            state = {"data": _leaf(obj.data), "lens": _leaf(obj.lens),
                     "_outer": tuple(_leaf(o) for o in obj.outer_levels)}
            return copyreg.__newobj__, (LoDArray,), (None, state)
        if _is_torch(obj) and hasattr(obj, "detach"):
            return _host(obj).__reduce_ex__(self.proto)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not LoDArray or self.proto < 4:
            return super().save_global(obj, name)
        self.save(_LOD_WIRE_NAME[0])
        self.save(_LOD_WIRE_NAME[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _leaf(v):
    return _host(v) if _is_torch(v) else v


def dumps(obj) -> bytes:
    """One record: ``obj`` pickled. Plain data pickles as ``pickle.dumps``
    does; a LoDArray (a LoD batch) under the JAX package's class name with
    numpy leaves, a torch tensor as a numpy array."""
    buf = io.BytesIO()
    try:
        _FastPickler(buf, pickle.DEFAULT_PROTOCOL).dump(obj)
    except _NeedsWireNames:
        buf = io.BytesIO()
        _RecordPickler(buf, pickle.DEFAULT_PROTOCOL).dump(obj)
    return buf.getvalue()


class _RecordUnpickler(pickle.Unpickler):
    """Decodes a record without importing the JAX package: its LoDArray
    name maps onto this package's LoDArray; any other ``paddle_tpu`` name
    is refused."""

    def find_class(self, module, name):
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            if (module, name) != _LOD_WIRE_NAME:
                raise pickle.UnpicklingError(
                    f"record names {module}.{name}; this package decodes "
                    "only the LoDArray of paddle_tpu.core.lod and never "
                    "imports paddle_tpu")
            return LoDArray
        return super().find_class(module, name)


def loads(data):
    """Decode one record written by :func:`dumps` or by the JAX package
    (a LoD batch comes back as this package's LoDArray, numpy leaves)."""
    return _RecordUnpickler(io.BytesIO(data)).load()
