"""Persistent KV-prefix store: replicas ATTACH instead of prefill
(counterpart of paddle_tpu/serving/generate/kvstore.py).

The shared-prefix cache collapses TTFT for the "one system prompt x
a million users" workload, but it lives per-engine and in-arena: every
reload, rollout, and scale-out replica starts cold and re-prefills the
same fleet-famous prefixes independently. This module is the
persistence tier under ``PagedKVCache``: registered refcount-0 prefix
blocks — hash-chain keyed, content-addressed, exactly the chain
granularity the prefix cache pinned — serialize to a host-RAM/disk
directory, LRU eviction DEMOTES to that tier instead of discarding, and
``attach_prefix`` on a spill hit restores blocks into the arena with
zero prefill dispatches, bitwise identical to a hot-cache attach.
"Prefill once, attach forever" — ``execcache.py``'s discipline applied
to KV bytes instead of compiled executables.

The safety contract mirrors ``execcache.py`` exactly:

* **Full identity fingerprint.** An artifact is keyed by everything
  that could change the KV bytes it holds: the bundle's registry
  ``content_hash`` (the exact parameter/program bytes), the arena
  geometry (layers, heads, head_dim, block size, dtype), ``kernel_tier``,
  the torch and CUDA versions, the device name and capability, and the
  kernel libraries' source hashes. ANY mismatch is a silent miss
  followed by a normal prefill — a stale or foreign artifact must never
  attach, because skewed KV bytes silently corrupt every token sampled
  through them.
* **Corruption is a miss, never a failure.** Artifacts carry a sha256
  over their payload; a truncated or bit-flipped file, an unpickle
  raise, a foreign fingerprint, or a payload whose arrays do not match
  the arena geometry all fall back to the prefill path with a
  ``paddle_tpu_kvcache_spill_rejects`` bump and a flight-recorder
  event.
* **Manifest pinning.** A published version's ``kv/`` artifacts are
  listed with per-file sha256 in ``VERSION.json`` (``kv_files``) —
  the RAW bytes must match the manifest BEFORE anything is unpickled,
  ``verify()`` re-hashes them, ``gc()`` deletes them with the version.

Storage layouts: a published registry version holds its artifacts under
``<version>/kv/`` (built by ``ModelRegistry.warm(kv_prompts=...)`` /
``publish(kv_prompts=...)`` — engines open it READ-ONLY); the
``serving_kv_spill_dir`` flag names a per-process read-write spill
directory for unpublished bundles, byte-budgeted by
``serving_kv_spill_bytes`` (oldest artifacts evict first). Empty flag =
no spilling: eviction discards, bitwise the pre-spill behavior.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle

import numpy as np
import torch

from ...core.flags import get_flag
from ...obs.metrics import REGISTRY as _METRICS, json_safe, next_instance

KV_DIRNAME = "kv"
ARTIFACT_SUFFIX = ".jkv"
_MAGIC = b"PDTPUKV1\n"

# reject reasons form a bounded enum (they become a metric label):
#   format      — bad magic / truncated / payload digest mismatch
#   manifest    — artifact unlisted in (or mismatching) the version
#                 manifest's kv_files digests — published kv dirs only;
#                 checked over the RAW bytes before unpickling
#   fingerprint — artifact is intact but keyed for a different identity
#   deserialize — unpickle raised, or the payload arrays do not match
#                 the arena geometry the fingerprint promises
REJECT_REASONS = ("format", "manifest", "fingerprint", "deserialize")

_M_WRITES = _METRICS.counter(
    "paddle_tpu_kvcache_spill_writes",
    "prefix-chain KV blocks serialized to the spill tier (eviction "
    "demotions + publish-time precompute), per store instance",
    labels=("instance",))
_M_RESTORES = _METRICS.counter(
    "paddle_tpu_kvcache_spill_restores",
    "prefix-chain KV blocks restored from the spill tier into the arena "
    "instead of being re-prefilled, per store instance",
    labels=("instance",))
_M_SPILL_REJECTS = _METRICS.counter(
    "paddle_tpu_kvcache_spill_rejects",
    "spill artifacts refused at load (corrupt bytes, foreign "
    "fingerprint, manifest mismatch, bad geometry) — prefill fallback, "
    "never an error", labels=("instance", "reason"))
_M_BYTES = _METRICS.gauge(
    "paddle_tpu_kvcache_spill_bytes",
    "bytes currently held by a writable spill directory (the "
    "serving_kv_spill_bytes budget's measured side), per store instance",
    labels=("instance",))


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

def kv_fingerprint(content_hash, num_layers, num_heads, head_dim,
                   block_size, dtype, device=None):
    """The full identity of ONE arena's KV bytes, as a JSON-safe dict: the
    bundle content hash, the arena geometry, ``kernel_tier`` (another
    attention route may round differently), and the torch/CUDA/device and
    kernel-source fields of ``ops/cuda/build.py``'s ``device_identity``
    (``device`` the arena's). ANY mismatch is a silent miss followed by a
    normal prefill."""
    from ...ops.autotune import dtype_str
    from ...ops.cuda.build import device_identity

    fp = {
        "format": 1,
        "content_hash": str(content_hash),
        "layers": int(num_layers),
        "heads": int(num_heads),
        "head_dim": int(head_dim),
        "block_size": int(block_size),
        "dtype": dtype_str(dtype),
        "flags": {"kernel_tier": get_flag("kernel_tier")},
    }
    fp.update(device_identity(device))
    return fp


def _to_numpy(t):
    """A host tensor's bytes as numpy (bfloat16 through its int16 view)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def fingerprint_key(fp):
    """Stable digest of a fingerprint dict (the artifact filename key):
    a geometry/toolchain flip changes every artifact NAME, so foreign
    configurations miss without even opening a file."""
    return hashlib.sha256(
        json.dumps(fp, sort_keys=True, default=str).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the on-disk store
# ---------------------------------------------------------------------------

class KVStore:
    """Directory of serialized prefix-chain KV blocks, chain-hash keyed.

    One artifact per registered chain hash: because ``h_i`` commits to
    every token in blocks ``0..i``, a per-block artifact IS
    chain-granular — restoring a chain is restoring its blocks in
    order, and a lookup can never attach bytes whose left context
    differs. Artifact format: ``MAGIC + sha256hex(blob) + "\\n" +
    blob`` where ``blob`` pickles ``{"fingerprint", "k", "v"}`` (the
    block's ``[layers, block_size, heads, head_dim]`` K and V stacks as
    numpy, bfloat16 as its int16 view). The digest detects truncation/bit
    rot before unpickling;
    the embedded fingerprint must equal the expected one, so a renamed
    or hash-colliding file is refused too. Writes are content-addressed
    and idempotent (an existing artifact is never rewritten) via tmp +
    ``os.replace``.

    ``readonly=True`` is the published ``kv/`` dir contract: replicas
    attach but never mutate a registry version. ``expected_digests``
    (basename -> sha256 of the whole file, from the version manifest's
    ``kv_files``) pins what this store may load BEFORE anything is
    unpickled. ``budget_bytes > 0`` bounds a writable directory: a
    write that would overflow first evicts the OLDEST artifacts (mtime
    order); an artifact bigger than the whole budget is not written."""

    def __init__(self, path, fingerprint, readonly=False,
                 expected_digests=None, budget_bytes=0):
        self.path = str(path)
        self.fingerprint = dict(fingerprint)
        self.readonly = bool(readonly)
        self.budget_bytes = int(budget_bytes or 0)
        self._expected = None if expected_digests is None \
            else dict(expected_digests)
        self._fpkey = fingerprint_key(self.fingerprint)
        if not self.readonly:
            os.makedirs(self.path, exist_ok=True)
        self.obs_instance = next_instance("kvstore")
        self._m_writes = _M_WRITES.labels(instance=self.obs_instance)
        self._m_restores = _M_RESTORES.labels(instance=self.obs_instance)
        self._m_bytes = _M_BYTES.labels(instance=self.obs_instance)
        self._m_rejects = {
            r: _M_SPILL_REJECTS.labels(instance=self.obs_instance,
                                       reason=r)
            for r in REJECT_REASONS}
        # artifact basenames this instance successfully loaded or saved
        # — registry.warm() lists exactly this set in the manifest (a
        # stale artifact from an older geometry/toolchain is unloadable
        # forever and must not be re-certified)
        self._touched = set()
        # writable stores meter their bytes once at open (budget
        # enforcement needs a running total, not a per-write listdir)
        self._bytes = 0 if self.readonly else self._scan_bytes()
        self._m_bytes.set(self._bytes)

    def _scan_bytes(self):
        total = 0
        try:
            for name in os.listdir(self.path):
                if name.endswith(ARTIFACT_SUFFIX):
                    try:
                        total += os.path.getsize(
                            os.path.join(self.path, name))
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    # ------------------------------------------------------------------
    def artifact_path(self, chain_hash):
        return os.path.join(
            self.path, f"{bytes(chain_hash).hex()}-{self._fpkey[:16]}"
                       f"{ARTIFACT_SUFFIX}")

    def note_reject(self, chain_hash, reason, error=None):
        """Count + flight-record one refused artifact."""
        from ...obs.recorder import record as _flight_record

        if reason not in self._m_rejects:
            reason = "deserialize"
        self._m_rejects[reason].inc()
        _flight_record("kv_spill_reject", component=self.obs_instance,
                       chain=bytes(chain_hash).hex()[:16], reason=reason,
                       error=None if error is None
                       else f"{type(error).__name__}: {error}")

    def load(self, chain_hash):
        """The restore path: ``(k, v)`` host tensors (``[layers,
        block_size, heads, head_dim]`` each) for the chain, or None
        (miss / reject — the caller prefills). Never raises: corruption
        at ANY depth is a reject + prefill fallback, because a broken
        store must only ever cost the prefill it failed to skip."""
        path = self.artifact_path(chain_hash)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        fp = self.fingerprint
        geom = (fp["layers"], fp["block_size"], fp["heads"],
                fp["head_dim"])
        stage = "format"
        try:
            if self._expected is not None:
                # manifest pinning: the raw bytes must be exactly what
                # the version manifest certifies, checked BEFORE any
                # unpickling — unlisted or mismatching bytes never
                # reach pickle.loads
                stage = "manifest"
                want = self._expected.get(os.path.basename(path))
                if want is None:
                    raise ValueError(
                        "artifact is not listed in the version "
                        "manifest's kv_files")
                if hashlib.sha256(raw).hexdigest() != want:
                    raise ValueError(
                        "artifact bytes do not match the manifest's "
                        "kv_files digest")
                stage = "format"
            if not raw.startswith(_MAGIC):
                raise ValueError("bad magic (not a KV artifact)")
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
                raise ValueError("artifact fingerprint does not match "
                                 "the arena identity")
            stage = "deserialize"
            want = "int16" if fp["dtype"] == "bfloat16" else fp["dtype"]
            k = np.asarray(doc["k"])
            v = np.asarray(doc["v"])
            if k.shape != geom or v.shape != geom \
                    or str(k.dtype) != want or str(v.dtype) != want:
                raise ValueError(
                    f"payload arrays {k.shape}/{k.dtype} do not match "
                    f"the arena geometry {geom}/{fp['dtype']}")
            k = _from_numpy(k, fp["dtype"])
            v = _from_numpy(v, fp["dtype"])
        except Exception as e:
            self.note_reject(chain_hash, stage, error=e)
            return None
        self._m_restores.inc()
        self._touched.add(os.path.basename(path))
        return k, v

    def save(self, chain_hash, k, v):
        """Persist one chain block's KV bytes. Content-addressed and
        idempotent: an artifact already on disk is never rewritten (the
        name commits to chain hash + full fingerprint, so same name
        means same bytes). Returns the artifact path (existing or just
        written), or None when the store is read-only, the write fails,
        or the byte budget cannot fit it — persistence is best-effort,
        the arena keeps working either way."""
        if self.readonly:
            return None
        from ...obs.recorder import record as _flight_record

        path = self.artifact_path(chain_hash)
        if os.path.exists(path):
            self._touched.add(os.path.basename(path))
            return path
        try:
            blob = pickle.dumps(
                {"fingerprint": self.fingerprint,
                 "k": _to_numpy(k), "v": _to_numpy(v)},
                protocol=pickle.HIGHEST_PROTOCOL)
            data = (_MAGIC + hashlib.sha256(blob).hexdigest().encode()
                    + b"\n" + blob)
            if self.budget_bytes > 0:
                if len(data) > self.budget_bytes:
                    _flight_record(
                        "kv_spill_skip", component=self.obs_instance,
                        chain=bytes(chain_hash).hex()[:16],
                        error=f"artifact ({len(data)} B) exceeds the "
                              f"whole budget ({self.budget_bytes} B)")
                    return None
                self._evict_for(len(data))
            tmp = path + f".{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except Exception as e:
            _flight_record("kv_spill_save_failed",
                           component=self.obs_instance,
                           chain=bytes(chain_hash).hex()[:16],
                           error=f"{type(e).__name__}: {e}")
            return None
        self._bytes += len(data)
        self._m_bytes.set(self._bytes)
        self._m_writes.inc()
        self._touched.add(os.path.basename(path))
        return path

    def _evict_for(self, need):
        """Budget enforcement: delete OLDEST artifacts (mtime order)
        until ``need`` more bytes fit under ``budget_bytes``."""
        if self._bytes + need <= self.budget_bytes:
            return
        entries = []
        try:
            for name in os.listdir(self.path):
                if not name.endswith(ARTIFACT_SUFFIX):
                    continue
                p = os.path.join(self.path, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, p, st.st_size))
        except OSError:
            return
        for _mtime, p, size in sorted(entries):
            if self._bytes + need <= self.budget_bytes:
                break
            try:
                os.remove(p)
            except OSError:
                continue
            self._bytes -= size
            self._touched.discard(os.path.basename(p))
        self._bytes = max(0, self._bytes)
        self._m_bytes.set(self._bytes)

    # ------------------------------------------------------------------
    def touched(self):
        """Artifact basenames this instance loaded or saved (sorted) —
        what a just-run publish-time prefill actually proved usable."""
        return sorted(self._touched)

    def artifacts(self):
        """Artifact filenames currently on disk (sorted)."""
        try:
            return sorted(n for n in os.listdir(self.path)
                          if n.endswith(ARTIFACT_SUFFIX))
        except OSError:
            return []

    def stats(self):
        # no filesystem I/O here: this rides every engine/server stats()
        # scrape — byte inventory is the running total, not a listdir
        return json_safe({
            "dir": self.path,
            "readonly": self.readonly,
            "budget_bytes": self.budget_bytes,
            "bytes": int(self._bytes),
            "touched": len(self._touched),
            "writes": int(self._m_writes.value),
            "restores": int(self._m_restores.value),
            "rejects": {r: int(c.value)
                        for r, c in self._m_rejects.items()},
        })


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def manifest_kv_digests(model_dir):
    """basename -> sha256 pin set for the kv dir at ``model_dir``, from
    the version manifest's ``kv_files``. A manifest WITHOUT the field
    pins the empty set (a kv dir next to a manifest that never
    certified it restores nothing — replicas prefill); no readable
    manifest at all returns None (not a registry version: the artifact
    self-digest is the only integrity layer)."""
    from ..registry import VERSION_MANIFEST

    try:
        with open(os.path.join(model_dir, VERSION_MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return {os.path.basename(rel): digest
            for rel, digest in manifest.get("kv_files", {}).items()}


def resolve_store(model_dir, kv_store, fingerprint):
    """The spill store an engine's arena should use. An explicit
    ``kv_store`` directory path always wins — that is how
    ``ModelRegistry.warm`` opens a version's ``kv/`` dir writable.
    Otherwise: the bundle's published ``kv/`` dir read-only
    (manifest-pinned) when it exists, else the ``serving_kv_spill_dir``
    flag's local read-write dir (budgeted by ``serving_kv_spill_bytes``),
    else None — no spill tier, bitwise the pre-spill behavior, which is
    also what a ``model_dir``-less engine gets (without bundle bytes
    there is no content identity to key artifacts on).
    ``kv_store=False`` disables the tier for this engine regardless."""
    if kv_store is False:
        return None
    if isinstance(kv_store, KVStore):
        return kv_store
    if kv_store is not None:
        return KVStore(str(kv_store), fingerprint)
    if model_dir is None:
        return None
    kvdir = os.path.join(str(model_dir), KV_DIRNAME)
    if os.path.isdir(kvdir):
        return KVStore(kvdir, fingerprint, readonly=True,
                       expected_digests=manifest_kv_digests(
                           str(model_dir)))
    local = get_flag("serving_kv_spill_dir")
    if local:
        return KVStore(local, fingerprint,
                       budget_bytes=int(get_flag(
                           "serving_kv_spill_bytes")))
    return None


__all__ = ["KVStore", "KV_DIRNAME", "REJECT_REASONS", "kv_fingerprint",
           "fingerprint_key", "manifest_kv_digests", "resolve_store"]
