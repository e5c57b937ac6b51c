"""Builds the hand-written CUDA kernels, loads them with ctypes, and calls
their C entries on PyTorch's current stream.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface under ``build/torch_kernels/`` at the repository root (a
directory git ignores), at first use. The library's file name carries a hash
of the sources and flags, so an edited ``.cu`` rebuilds. Nothing is built
when a module is imported: the CPU test machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_RAW_STREAM = []


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash(name) -> str:
    """sha256 of ``csrc/<name>.cu``, every header in ``csrc/`` and the
    compiler flags: what the library's file name is keyed by, and what the
    warm-executable and tuning-table fingerprints carry (an edited ``.cu``
    misses)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def kernel_libraries():
    """The kernel libraries' names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by :func:`source_hash`."""
    return BUILD_DIR / f"lib{name}-{source_hash(name)[:16]}.so"


def build(names):
    """Compile every named kernel not yet built, one ``nvcc`` process each,
    all started together. Returns {name: (seconds, compiler log)}; raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = {}
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        results[name] = (time.perf_counter() - t0, log)
    if results:
        from ...obs.perf import note_compile
        for name, (seconds, _log) in results.items():
            note_compile("nvcc_build", seconds, identity={"kernel": name})
    return results


def load(name) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def _raw_stream(index):
    """The cudaStream_t of device ``index``'s current stream, as an int."""
    if not _RAW_STREAM:
        import torch
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _RAW_STREAM.append(raw if raw is not None else
                           lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _RAW_STREAM[0](index)


def call_on(dev, fn, *args):
    """``fn(*args, stream)``: a C entry that launches on ``stream``, called
    with ``dev``'s current stream and ``dev`` the current device (made so
    only where it is not already). Returns what ``fn`` returns."""
    import torch
    cur = torch.cuda.current_device()
    if dev.index is None or dev.index == cur:
        return fn(*args, _raw_stream(cur))
    with torch.cuda.device(dev.index):
        return fn(*args, _raw_stream(dev.index))


def device_identity(device=None):
    """What a fingerprint keys a device and its toolchain by: the torch
    and CUDA versions, the device's name and compute capability (the card
    ``device`` names, ``cuda:0`` where a card is in use and ``device`` is
    None, else the CPU), and :func:`source_hash` of every kernel library.
    Reads the sources, initialises no CUDA context that is not there."""
    import torch
    if device is None:
        device = torch.device("cuda", 0) if torch.cuda.is_available() \
            else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index or 0
        name = torch.cuda.get_device_name(idx)
        cap = list(torch.cuda.get_device_capability(idx))
    else:
        name, cap = device.type, None
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": name,
        "capability": cap,
        "kernel_sources": {n: source_hash(n) for n in kernel_libraries()},
    }
