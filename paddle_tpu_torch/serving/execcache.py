"""Persistent warm-executable cache: replicas LOAD instead of tracing
(counterpart of paddle_tpu/serving/execcache.py).

The reference AOT-compiles each serving warmup executable (bucket, phase)
and persists it with ``jax.experimental.serialize_executable``, so the next
process deserializes instead of recompiling. The port runs eagerly, so a
cold warmup compiles nothing: its "executable" is the ``torch.export``
program of ONE (bucket, fetch list) of a saved inference program — the
ahead-of-time export's forward (``fluid/aot.py``), traced here at the bucket's static shapes with
the scope's persistables baked in as buffers and the kernels kept whole as
``torch.library`` operators (``torch.ops.paddle_tpu_torch.conv_affine``
...), so a warm dispatch still launches the hand-written kernels. Loading
one skips the engine's op loop, the Program and the bundle's lowering; it
does not skip the kernels' build (``build/torch_kernels/``).

The safety contract is the reference's:

* **Full identity fingerprint.** An artifact is keyed by everything that
  changes its bits or their meaning: the bundle's registry
  ``content_hash``, the executable's feed shapes and dtypes and ordered
  fetch list, the routing flags (``kernel_tier``, ``kernel_autotune``,
  ``kernel_autotune_bf16``, and ``kernel_autotune_digest`` as the digest
  of the tuning table the dispatch routes by), the TF32 switches
  (``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32``: they change the plain ops' bits in
  the traced graph), the torch and CUDA versions, the device name and
  capability, and the source hash of every kernel library
  (``ops/cuda/build.py`` ``device_identity``). Any mismatch is a silent
  miss followed by the engine's eager path.
* **Corruption is a miss, never a failure.** Artifacts carry a sha256 over
  their payload; a truncated or bit-flipped file, an unpickle or
  ``torch.export.load`` raise, or an executable that loads but fails its
  first dispatch (``run_failed``) all fall back to the eager path — on the
  same device and the same kernel route, never the plain route or the CPU
  — with a ``paddle_tpu_exec_cache_rejects`` bump and a flight event.
* **Bitwise parity.** The artifact is the trace of the same op loop the
  Executor runs, on the same device, so warm and cold replies agree
  bitwise (pinned on the CPU by the tests and on the card by
  ``chip_smoke.py``).

Storage: a published registry version holds its artifacts under
``<version>/warm/`` (``ModelRegistry.warm`` / ``publish(warm_cache=
True)``; listed with per-file sha256 in ``VERSION.json``, covered by
``verify()``, deleted by ``gc()``; engines open it read-only); the
``serving_exec_cache_dir`` flag names a per-process read-write local cache
for unpublished bundles. The ``serving_exec_cache`` flag is the kill
switch.

Both engines use it. An ``InferenceEngine`` keys one executable per
bucket (``infer_b<bucket>``); a ``GenerationEngine`` one per (phase,
bucket) (``gen_<phase>_b<bucket>``, the reference's identity), whose
feeds include the per-layer KV arenas. A phase program writes its arenas
through the ``torch.ops.paddle_tpu_torch.paged_kv_write`` operator, which
``torch.export`` records as a mutation of those inputs, so the exported
program's module writes the fed arena back as the op loop does in place;
its decode attend stays the ``torch.ops.paddle_tpu_torch.paged_attention``
operator, which launches the paged-attention kernel on the card.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import time

from ..core.flags import get_flag
from ..obs.metrics import REGISTRY as _METRICS, json_safe, next_instance

WARM_DIRNAME = "warm"
ARTIFACT_SUFFIX = ".jexec"
# another magic than the reference's: a JAX artifact rejects as "format"
_MAGIC = b"PDTPUTORCHEXEC1\n"

#   format      — bad magic / truncated / payload digest mismatch
#   manifest    — artifact unlisted in (or mismatching) the version
#                 manifest's warm_files digests (published warm dirs only;
#                 checked over the raw bytes before unpickling)
#   fingerprint — artifact intact but keyed for a different identity
#   deserialize — unpickle / torch.export.load raised
#   run_failed  — loaded fine but the first dispatch raised
REJECT_REASONS = ("format", "manifest", "fingerprint", "deserialize",
                  "run_failed")

# the flags that change what an exported program routes to
KEY_FLAGS = ("kernel_tier", "kernel_autotune", "kernel_autotune_digest",
             "kernel_autotune_bf16")

_M_HITS = _METRICS.counter(
    "paddle_tpu_exec_cache_hits",
    "persisted executables loaded instead of traced, per cache instance",
    labels=("instance",))
_M_MISSES = _METRICS.counter(
    "paddle_tpu_exec_cache_misses",
    "warm-cache lookups with no artifact on disk (the eager path follows)",
    labels=("instance",))
_M_REJECTS = _METRICS.counter(
    "paddle_tpu_exec_cache_rejects",
    "artifacts refused at load (corrupt bytes, foreign fingerprint, "
    "load/dispatch failure) — eager fallback, never an error",
    labels=("instance", "reason"))
_M_SAVE_SECONDS = _METRICS.histogram(
    "paddle_tpu_exec_cache_save_seconds",
    "wall seconds serializing + persisting one exported executable",
    labels=("instance",), span_name="serving/exec_cache_save",
    span_kind="stage")


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

def bundle_content_hash(model_dir):
    """Content identity of the bundle at ``model_dir``: the registry
    manifest's ``content_hash`` when the dir is a published version, else
    recomputed over the bundle files with the registry's hashing."""
    from .registry import VERSION_MANIFEST, _content_hash, _sha256_file

    mpath = os.path.join(model_dir, VERSION_MANIFEST)
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                ch = json.load(f).get("content_hash")
            if ch:
                return str(ch)
        except (OSError, ValueError):
            pass          # torn/corrupt manifest: fall through to re-hash
    files = {}
    for name in sorted(os.listdir(model_dir)):
        path = os.path.join(model_dir, name)
        if not os.path.isfile(path) or name == VERSION_MANIFEST \
                or name.endswith(".tmp"):
            continue
        files[name] = _sha256_file(path)
    return _content_hash(files)


def tf32_switches():
    """The process's TF32 switches, which change a plain matmul's and a
    cuDNN conv's bits on the card (as ``fluid/aot.py`` records them)."""
    from ..fluid.aot import _tf32
    return _tf32()


def fingerprint(content_hash, tag, feeds, fetch_names, device=None):
    """The full identity of ONE executable, as a JSON-safe dict. ``tag``
    names which executable of the bundle this is (``infer_b8``); ``feeds``
    are the PREPARED feed tensors (what the exported program takes);
    ``fetch_names`` is the ordered fetch list; ``device`` the executor's."""
    from ..ops.autotune import active_table, dtype_str
    from ..ops.cuda.build import device_identity

    flags = {n: get_flag(n) for n in KEY_FLAGS}
    # the table dispatch routes by here: an engine's own, else the one
    # attached process-wide (whose digest the flag already holds)
    table = active_table()
    if table is not None:
        flags["kernel_autotune_digest"] = table.digest()
    fp = {
        "format": 1,
        "content_hash": str(content_hash),
        "tag": str(tag),
        "feeds": {str(k): [dtype_str(v.dtype),
                           [int(d) for d in getattr(v, "shape", ())]]
                  for k, v in feeds.items()},
        "fetch": [str(n) for n in fetch_names],
        "flags": flags,
        "tf32": tf32_switches(),
    }
    fp.update(device_identity(device))
    return fp


def fingerprint_key(fp):
    """Stable digest of a fingerprint dict (the artifact filename key)."""
    return hashlib.sha256(
        json.dumps(fp, sort_keys=True, default=str).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the executable and its dispatch glue
# ---------------------------------------------------------------------------

class WarmExecutable:
    """An exported program of one (bucket, fetch list) and the
    ``Executor.run`` glue around it: :meth:`run` prepares the feed as the
    Executor does (dtype cast, the executor's device) and returns the
    fetches as the Executor returns them. ``source`` is ``"compile"`` (a
    cache fill, just exported) or ``"cache"`` (loaded)."""

    __slots__ = ("module", "feed_names", "fetch_names", "source")

    def __init__(self, module, feed_names, fetch_names, source):
        self.module = module
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.source = source

    def run(self, executor, program, feed, scope=None, return_numpy=True):
        import torch

        from ..core.executor import Executor
        del scope           # an inference program writes no state
        vals = executor._prepare_feed(program.global_block(), dict(feed))
        with torch.no_grad():
            outs = self.module(*[vals[n] for n in self.feed_names])
        return [Executor._fetch_value(v, return_numpy) for v in outs]


def export_executable(program, feed, fetch_names, executor, scope):
    """Trace ONE dispatch of ``program`` at ``feed``'s static shapes (a
    dict of prepared dense tensors) with ``torch.export``, the scope's
    persistables as buffers: the ExportedProgram of the ahead-of-time
    export's forward (``fluid/aot.py``), whose kernels stay
    ``torch.library`` operators."""
    import torch

    from ..core.amp import amp_guard
    from ..core.block_walk import free_reads
    from ..core.lod import LoDArray
    from ..fluid.aot import _Forward

    block = program.global_block()
    names = list(feed)
    if any(isinstance(feed[n], LoDArray) for n in names):
        raise NotImplementedError(
            "warm executables take dense feeds; a LoD feed runs eagerly")
    params = {}
    for n in free_reads(program, 0):
        if n in feed or not scope.has_var(n):
            continue
        t = scope.find_var(n)
        if isinstance(t, torch.Tensor):
            params[n] = t.detach()
    feed_meta = [{"name": n, "lod_level": 0} for n in names]
    fetch_lod = []
    module = _Forward(block, params, feed_meta, list(fetch_names),
                      executor.device, fetch_lod)
    with torch.no_grad(), amp_guard(executor.amp):
        exported = torch.export.export(
            module, tuple(feed[n] for n in names), strict=False)
    if any(fetch_lod):
        raise NotImplementedError(
            "warm executables return dense fetches; a LoD fetch runs "
            "eagerly")
    return exported, names


def compile_and_save(cache, fp, program, feed, fetch_names, executor,
                     scope, site, identity=None):
    """Cache fill: export one dispatch exactly as the Executor runs it,
    persist it under ``fp`` and return it as a :class:`WarmExecutable`.
    The trace lands in the compile-telemetry layer with ``cache_hit:
    False``; a failed save only costs persistence."""
    from ..obs import perf as _perf

    t0 = time.perf_counter()
    exported, names = export_executable(program, feed, fetch_names,
                                        executor, scope)
    seconds = time.perf_counter() - t0
    ident = dict(identity or {})
    ident["tag"] = fp["tag"]
    ident["cache_hit"] = False
    _perf.note_compile(site, seconds, identity=ident)
    cache.save(fp, exported, names, list(fetch_names))
    return WarmExecutable(exported.module(), names, fetch_names, "compile")


# ---------------------------------------------------------------------------
# the on-disk cache
# ---------------------------------------------------------------------------

class ExecCache:
    """Directory of exported executables, fingerprint-keyed.

    Artifact format: ``MAGIC + sha256hex(blob) + "\\n" + blob`` where
    ``blob`` pickles ``{"fingerprint", "payload", "feeds", "fetch"}``
    (``payload`` the ``torch.export.save`` bytes). The digest detects
    truncation and bit rot before unpickling; the embedded fingerprint
    must equal the expected one. Writes are tmp + ``os.replace``.
    ``readonly=True`` is the published ``warm/`` contract;
    ``expected_digests`` (basename -> sha256 of the whole file, from the
    manifest's ``warm_files``) pins what may load, checked over the raw
    bytes before anything is unpickled."""

    def __init__(self, path, readonly=False, expected_digests=None):
        self.path = str(path)
        self.readonly = bool(readonly)
        self._expected = None if expected_digests is None \
            else dict(expected_digests)
        if not self.readonly:
            os.makedirs(self.path, exist_ok=True)
        self.obs_instance = next_instance("execcache")
        self._m_hits = _M_HITS.labels(instance=self.obs_instance)
        self._m_misses = _M_MISSES.labels(instance=self.obs_instance)
        self._m_save = _M_SAVE_SECONDS.labels(instance=self.obs_instance)
        self._m_rejects = {
            r: _M_REJECTS.labels(instance=self.obs_instance, reason=r)
            for r in REJECT_REASONS}
        # artifact basenames this instance loaded or saved: what
        # registry.warm() certifies in the manifest
        self._touched = set()

    def artifact_path(self, fp):
        return os.path.join(
            self.path, f"{fp['tag']}-{fingerprint_key(fp)[:40]}"
                       f"{ARTIFACT_SUFFIX}")

    def note_reject(self, tag, reason, error=None):
        """Count + flight-record one refused artifact (engines call this
        for ``run_failed``; :meth:`load` for the on-disk ones)."""
        from ..obs.recorder import record as _flight_record

        if reason not in self._m_rejects:
            reason = "deserialize"
        self._m_rejects[reason].inc()
        _flight_record("exec_cache_reject", component=self.obs_instance,
                       tag=str(tag), reason=reason,
                       error=None if error is None
                       else f"{type(error).__name__}: {error}")

    def load(self, fp):
        """The warm path: the artifact for ``fp``, loaded and wrapped, or
        None (miss / reject: the caller runs eagerly). Never raises."""
        import torch

        from ..obs import perf as _perf
        path = self.artifact_path(fp)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            self._m_misses.inc()
            return None
        t0 = time.perf_counter()
        stage = "format"
        try:
            if self._expected is not None:
                stage = "manifest"
                want = self._expected.get(os.path.basename(path))
                if want is None:
                    raise ValueError(
                        "artifact is not listed in the version "
                        "manifest's warm_files")
                if hashlib.sha256(raw).hexdigest() != want:
                    raise ValueError(
                        "artifact bytes do not match the manifest's "
                        "warm_files digest")
                stage = "format"
            if not raw.startswith(_MAGIC):
                raise ValueError("bad magic (not an artifact)")
            header_end = raw.index(b"\n", len(_MAGIC))
            digest = raw[len(_MAGIC):header_end].decode("ascii")
            blob = raw[header_end + 1:]
            if hashlib.sha256(blob).hexdigest() != digest:
                raise ValueError("payload digest mismatch (truncated or "
                                 "bit-flipped artifact)")
            stage = "deserialize"
            doc = pickle.loads(blob)
            stage = "fingerprint"
            if doc.get("fingerprint") != fp:
                raise ValueError("artifact fingerprint does not match the "
                                 "requested identity")
            stage = "deserialize"
            from ..ops import cuda  # noqa: F401  (the kernels' operators)
            exported = torch.export.load(io.BytesIO(doc["payload"]))
            entry = WarmExecutable(exported.module(), doc["feeds"],
                                   doc["fetch"], "cache")
        except Exception as e:
            self.note_reject(fp.get("tag", "?"), stage, error=e)
            return None
        _perf.note_compile("exec_cache_load", time.perf_counter() - t0,
                           identity={"tag": fp.get("tag"),
                                     "cache_hit": True})
        self._m_hits.inc()
        self._touched.add(os.path.basename(path))
        return entry

    def save(self, fp, exported, feed_names, fetch_names):
        """Persist one ExportedProgram under ``fp``. Returns the artifact
        path, or None when read-only or the save fails (persistence is
        best-effort)."""
        if self.readonly:
            return None
        import torch

        from ..obs.recorder import record as _flight_record

        t0 = time.perf_counter()
        try:
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            blob = pickle.dumps(
                {"fingerprint": fp, "payload": buf.getvalue(),
                 "feeds": list(feed_names), "fetch": list(fetch_names)},
                protocol=pickle.HIGHEST_PROTOCOL)
            data = (_MAGIC + hashlib.sha256(blob).hexdigest().encode()
                    + b"\n" + blob)
            path = self.artifact_path(fp)
            tmp = path + f".{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except Exception as e:
            _flight_record("exec_cache_save_failed",
                           component=self.obs_instance,
                           tag=fp.get("tag", "?"),
                           error=f"{type(e).__name__}: {e}")
            return None
        self._m_save.observe(time.perf_counter() - t0)
        self._touched.add(os.path.basename(path))
        return path

    def touched(self):
        """Artifact basenames this instance loaded or saved (sorted)."""
        return sorted(self._touched)

    def artifacts(self):
        """Artifact filenames currently on disk (sorted)."""
        try:
            return sorted(n for n in os.listdir(self.path)
                          if n.endswith(ARTIFACT_SUFFIX))
        except OSError:
            return []

    def stats(self):
        save = self._m_save.snapshot()
        return json_safe({
            "dir": self.path,
            "readonly": self.readonly,
            "touched": len(self._touched),
            "hits": int(self._m_hits.value),
            "misses": int(self._m_misses.value),
            "rejects": {r: int(c.value)
                        for r, c in self._m_rejects.items()},
            "saves": int(save.get("count", 0)),
        })


def acquire(cache, content_hash, tag, program, feed, fetch_names,
            executor, scope, identity=None):
    """Load-or-build ONE warm executable: prepare the feed as the Executor
    will, fingerprint, :meth:`ExecCache.load`, and (writable caches)
    export-and-persist on a miss. Returns a :class:`WarmExecutable` or
    None; never raises (any failure is an ``exec_cache_skip`` flight event
    and the caller runs eagerly)."""
    try:
        prepared = executor._prepare_feed(program.global_block(),
                                          dict(feed))
        fp = fingerprint(content_hash, tag, prepared, fetch_names,
                         device=executor.device)
        entry = cache.load(fp)
        if entry is None and not cache.readonly:
            entry = compile_and_save(cache, fp, program, prepared,
                                     fetch_names, executor=executor,
                                     scope=scope, site="exec_cache_save",
                                     identity=identity)
        return entry
    except Exception as e:
        from ..obs.recorder import record as _flight_record
        _flight_record("exec_cache_skip", component=cache.obs_instance,
                       tag=str(tag), error=f"{type(e).__name__}: {e}")
        return None


def manifest_warm_digests(model_dir):
    """basename -> sha256 pin set for the warm dir at ``model_dir``, from
    the version manifest's ``warm_files``; a manifest without the field
    pins the empty set; no readable manifest returns None."""
    from .registry import VERSION_MANIFEST

    try:
        with open(os.path.join(model_dir, VERSION_MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return {os.path.basename(rel): digest
            for rel, digest in manifest.get("warm_files", {}).items()}


def resolve_cache(model_dir, exec_cache=None):
    """The cache an engine uses. An explicit ``exec_cache`` (ExecCache or
    directory path) wins; ``False`` disables it. Otherwise, with the
    ``serving_exec_cache`` flag on: the bundle's published ``warm/`` dir
    read-only when it exists, else the ``serving_exec_cache_dir`` flag's
    local read-write dir, else None (the eager path only)."""
    if exec_cache is False:
        return None
    if isinstance(exec_cache, ExecCache):
        return exec_cache
    if exec_cache is not None:
        return ExecCache(str(exec_cache))
    if model_dir is None or not get_flag("serving_exec_cache"):
        return None
    warm = os.path.join(str(model_dir), WARM_DIRNAME)
    if os.path.isdir(warm):
        return ExecCache(warm, readonly=True,
                         expected_digests=manifest_warm_digests(
                             str(model_dir)))
    local = get_flag("serving_exec_cache_dir")
    if local:
        return ExecCache(local)
    return None


__all__ = ["ExecCache", "WarmExecutable", "WARM_DIRNAME", "ARTIFACT_SUFFIX",
           "REJECT_REASONS", "acquire", "bundle_content_hash",
           "compile_and_save", "export_executable", "fingerprint",
           "fingerprint_key", "manifest_warm_digests", "resolve_cache",
           "tf32_switches"]
