"""Ahead-of-time inference export: a pruned inference program traced once
with ``torch.export`` into a self-contained artifact, and its loader
(counterpart of paddle_tpu/fluid/aot.py, ``export_inference_artifact``
:36, ``InferenceArtifact`` :133, ``load_inference_artifact`` :190).

The reference serializes the program's XLA computation with ``jax.export``
(StableHLO). Here the op loop of the Executor (``core/executor.py``
``_run_ops``) is traced under ``torch.no_grad()`` with
``torch.export.export(strict=False)`` into one ExportedProgram, the scope's
trained persistables baked in as its buffers, and written with
``torch.export.save``. The hand-written kernels stay on the artifact's
path: the op lowerings call them as ``torch.library`` operators
(``torch.ops.paddle_tpu_torch.conv_affine``, ``::lstm_seq``,
``::gru_seq``; ``ops/cuda/``), which the trace keeps whole, so a forward
through the loaded artifact launches the same kernels as the Executor.

Layout on disk:
    <dirname>/__inference__.pt2     torch.export.save of the ExportedProgram
    <dirname>/AOT_MANIFEST.json     the reference's keys (feeds with their
                                    shape, dtype and lod_level, fetches,
                                    batch_symbol, format), plus the device
                                    the artifact was exported on and each
                                    symbolic dim's range

The batch is a ``torch.export.Dim``; a ``lod_level=1`` feed is a padded
(data, lens) pair whose padded length is a second Dim, so one artifact
serves any batch and any padded length, as the reference's does. By
design (ROADMAP §C):

* the artifact is bound to the device it was exported on (the executor's:
  the card unless the caller asked for the CPU); loading it where that
  device is absent raises, and nothing moves it to the CPU;
* an LSTM or GRU exported on the kernel route serves a batch only inside
  the kernel's ``supported()`` range (``ops/cuda/rnn.py`` MAX_BATCH); the
  reference serves any batch. ``run`` refuses a batch outside the range;
* the artifact carries the exporting process's TF32 switches
  (``torch.backends.cuda.matmul.allow_tf32``,
  ``torch.backends.cudnn.allow_tf32``; manifest key ``tf32``), which
  change the traced plain matmuls' and cuDNN convs' bits on the card, and
  ``run`` applies them around each call (restoring the caller's after),
  so an artifact's replies do not depend on the loading process's
  switches. An artifact without the key runs under the caller's.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch
from torch.export import Dim

from ..core.amp import amp_guard
from ..core.block_walk import free_reads
from ..core.executor import _RNG_KEY, Executor, _run_ops
from ..core.lod import LoDArray, pack_sequences
from ..core.scope import global_scope
from ..core.types import torch_dtype
from ..ops.cuda import resolve_tier
from ..ops.cuda import rnn as rnnk

ARTIFACT_FILENAME = "__inference__.pt2"
MANIFEST_FILENAME = "AOT_MANIFEST.json"
FORMAT = "torch.export.pt2.v1"

# the example sizes the trace runs at: above 1, so that no dim of the
# example specializes, and small, so that the trace is cheap
_EXAMPLE_BATCH, _EXAMPLE_LEN = 3, 5


def _recurrent_batch_max(block, device):
    """The largest batch an artifact of ``block`` can serve on ``device``:
    the recurrent kernels' MAX_BATCH where an lstm or gru op of the block
    takes the kernel route there (the route guards the batch), else
    None (unbounded)."""
    if resolve_tier(device) != "cuda":
        return None
    if any(op.type in ("lstm", "gru") for op in block.ops):
        return rnnk.MAX_BATCH
    return None


def export_inference_artifact(dirname, feeded_var_names, target_vars,
                              executor, main_program=None, scope=None,
                              batch_symbol="b"):
    """Prune ``main_program`` to the feed->fetch slice, bake the scope's
    trained persistables in, and serialize the traced forward.

    Mirrors fluid.io.save_inference_model's signature, as the reference
    does. The trace runs on the executor's device, under its AMP setting.
    Returns the manifest."""
    from .framework import default_main_program
    from . import io as fluid_io

    program = main_program or default_main_program()
    scope = scope or global_scope()
    device = executor.device
    feeds = list(feeded_var_names)
    fetch = [t if isinstance(t, str) else t.name for t in target_vars]
    infer = fluid_io._prune_program(program, feeds, fetch)
    block = infer.global_block()

    feed_meta = []
    for name in feeds:
        v = block.var(name)
        shape = list(v.shape if v.shape is not None else (-1,))
        dtype = str(np.dtype(v.dtype or "float32"))
        lod_level = int(v.lod_level or 0)
        if lod_level >= 2:
            # the (data, lens) spec carries the innermost level only (the
            # reference refuses the same, aot.py:93-100)
            raise NotImplementedError(
                f"AOT export: feed {name!r} has lod_level={lod_level}; the "
                "artifact feed spec carries one LoD level (data + lens). "
                "Flatten the outer levels at the feed boundary or export "
                "via save_inference_model + the executor path instead")
        feed_meta.append({"name": name, "shape": shape, "dtype": dtype,
                          "lod_level": lod_level})

    params = {}
    for n in free_reads(infer, 0):
        if n in feeds or not scope.has_var(n):
            continue
        t = scope.find_var(n)
        if isinstance(t, torch.Tensor):
            params[n] = t.detach().to(device)

    bmax = _recurrent_batch_max(block, device)
    batch = Dim(batch_symbol, min=1, max=bmax)
    length = Dim(f"{batch_symbol}_len", min=1)
    args, dynamic = [], []
    for spec in feed_meta:
        feat = [int(s) for s in spec["shape"][1:] if s not in (-1, None)]
        dt = torch_dtype(spec["dtype"])
        if spec["lod_level"]:
            args.append(torch.zeros([_EXAMPLE_BATCH, _EXAMPLE_LEN] + feat,
                                    dtype=dt, device=device))
            args.append(torch.full((_EXAMPLE_BATCH,), _EXAMPLE_LEN,
                                   dtype=torch.int32, device=device))
            dynamic += [{0: batch, 1: length}, {0: batch}]
        else:
            shape = [_EXAMPLE_BATCH if s in (-1, None) else int(s)
                     for s in spec["shape"]]
            args.append(torch.zeros(shape, dtype=dt, device=device))
            dynamic.append({i: batch for i, s in enumerate(spec["shape"])
                            if s in (-1, None)} or None)

    fetch_lod = []      # the trace fills it: which fetches are LoD
    module = _Forward(block, params, feed_meta, fetch, device, fetch_lod)
    with torch.no_grad(), amp_guard(executor.amp):
        exported = torch.export.export(
            module, tuple(args), dynamic_shapes={"args": tuple(dynamic)},
            strict=False)

    os.makedirs(dirname, exist_ok=True)
    tmp = os.path.join(dirname, "__inference__.tmp.pt2")
    torch.export.save(exported, tmp)
    os.replace(tmp, os.path.join(dirname, ARTIFACT_FILENAME))
    manifest = {
        "tf32": _tf32(),
        "feeds": feed_meta,
        "fetches": fetch,
        "batch_symbol": batch_symbol,
        "format": FORMAT,
        "device": str(device),
        "dims": {batch_symbol: [1, bmax],
                 f"{batch_symbol}_len": [1, None]},
        "fetch_lod": fetch_lod,
    }
    mtmp = os.path.join(dirname, MANIFEST_FILENAME + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(mtmp, os.path.join(dirname, MANIFEST_FILENAME))
    return manifest


class _Forward(torch.nn.Module):
    """The pruned block's op loop over its persistables (buffers ``p0``,
    ``p1``, ...) and the flat feeds: a LoD feed is two arguments (data,
    lens), and a LoD fetch two results. Each forward records in
    ``fetch_lod`` which fetches are LoD."""

    def __init__(self, block, params, feed_meta, fetch, device, fetch_lod):
        super().__init__()
        self.block, self.feed_meta, self.fetch = block, feed_meta, fetch
        self.device, self.fetch_lod = device, fetch_lod
        self.names = list(params)
        for i, t in enumerate(params.values()):
            self.register_buffer(f"p{i}", t)

    def forward(self, *args):
        env = {n: getattr(self, f"p{i}") for i, n in enumerate(self.names)}
        k = 0
        for spec in self.feed_meta:
            if spec["lod_level"]:
                env[spec["name"]] = LoDArray(args[k], args[k + 1])
                k += 2
            else:
                env[spec["name"]] = args[k]
                k += 1
        env[_RNG_KEY] = None
        _run_ops(self.block, env, self.device)
        values = [env[n] for n in self.fetch]
        self.fetch_lod[:] = [isinstance(v, LoDArray) for v in values]
        out = []
        for v in values:
            out += [v.data, v.lens] if isinstance(v, LoDArray) else [v]
        return tuple(out)


class InferenceArtifact:
    """A loaded artifact: ``run(feed_dict)`` -> list of fetch arrays. No
    Program, op registry or Scope is involved: the ExportedProgram is the
    whole model (the reference's InferenceArtifact, aot.py:133)."""

    def __init__(self, exported, manifest):
        self._exported = exported
        self._module = exported.module()
        self.manifest = manifest
        self.feed_names = [f["name"] for f in manifest["feeds"]]
        self.fetch_names = manifest["fetches"]
        self.device = manifest["device"]

    def _check_batch(self, n):
        lo, hi = self.manifest["dims"][self.manifest["batch_symbol"]]
        if n < lo or (hi is not None and n > hi):
            raise ValueError(
                f"batch {n} is outside this artifact's batch range "
                f"[{lo}, {hi}]: it was exported on {self.device} with a "
                "recurrent op on its kernel route, whose kernels take "
                f"batches up to {hi} (ops/cuda/rnn.py MAX_BATCH); split the "
                "request")

    def run(self, feed):
        """Feeds in the reference's forms (arrays; for a LoD feed a list of
        per-sequence arrays, or a LoDArray) -> the fetches as numpy arrays
        (a LoD fetch as a LoDArray of numpy arrays)."""
        dev = torch.device(self.device)
        args = []
        for spec in self.manifest["feeds"]:
            v = feed[spec["name"]]
            if spec["lod_level"]:
                if not isinstance(v, LoDArray):
                    v = pack_sequences([np.asarray(s, spec["dtype"])
                                        for s in v])
                data = v.data if isinstance(v.data, torch.Tensor) else \
                    _tensor(v.data, spec["dtype"])
                lens = v.lens if isinstance(v.lens, torch.Tensor) else \
                    _tensor(v.lens, np.int32)
                self._check_batch(int(data.shape[0]))
                args += [data.to(dev, torch_dtype(spec["dtype"])),
                         lens.to(dev, torch.int32)]
            else:
                t = v if isinstance(v, torch.Tensor) else \
                    _tensor(v, spec["dtype"])
                if -1 in spec["shape"] or None in spec["shape"]:
                    self._check_batch(int(t.shape[0]))
                args.append(t.to(dev, torch_dtype(spec["dtype"])))
        with torch.no_grad(), _tf32_as(self.manifest.get("tf32")):
            flat = list(self._module(*args))
        out = []
        for is_lod in self.manifest["fetch_lod"]:
            v = LoDArray(flat.pop(0), flat.pop(0)) if is_lod else flat.pop(0)
            out.append(Executor._fetch_value(v, True))
        return out


def _tf32():
    """The process's TF32 switches, as the manifest records them."""
    return {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}


@contextlib.contextmanager
def _tf32_as(switches):
    """Run under ``switches`` (a manifest's ``tf32``), restoring the
    caller's after; None leaves the caller's in place."""
    if not switches:
        yield
        return
    before = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = bool(switches["matmul"])
    torch.backends.cudnn.allow_tf32 = bool(switches["cudnn"])
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul"]
        torch.backends.cudnn.allow_tf32 = before["cudnn"]


def _tensor(v, dtype):
    """A host array as a CPU tensor, copied only where numpy must (another
    dtype or layout) or where the array is read-only (a C caller's
    buffer)."""
    a = np.ascontiguousarray(v, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def load_inference_artifact(dirname):
    """Load an artifact on the device it was exported on; raises when that
    device is absent (the artifact never moves to the CPU)."""
    from ..ops import cuda  # noqa: F401  (registers the kernels' operators)

    with open(os.path.join(dirname, MANIFEST_FILENAME)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{dirname!r}: artifact format "
                         f"{manifest.get('format')!r}, want {FORMAT!r}")
    dev = torch.device(manifest["device"])
    if dev.type == "cuda" and (not torch.cuda.is_available() or
                               (dev.index or 0) >= torch.cuda.device_count()):
        raise RuntimeError(
            f"{dirname!r} was exported on {dev} and no such CUDA device is "
            "available here; export it again with fluid.CPUPlace() to "
            "serve it on the CPU")
    exported = torch.export.load(os.path.join(dirname, ARTIFACT_FILENAME))
    return InferenceArtifact(exported, manifest)


__all__ = ["export_inference_artifact", "InferenceArtifact",
           "load_inference_artifact", "ARTIFACT_FILENAME",
           "MANIFEST_FILENAME", "FORMAT"]
