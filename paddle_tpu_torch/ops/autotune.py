"""Kernel autotuner: measured per-shape variant selection (counterpart of
paddle_tpu/ops/autotune.py).

The ``kernel_tier`` routing layer (``ops/cuda/__init__.py``) decides kernel
against plain chain per kernel family from the flag and the shape's
``supported()``. This module makes that decision data: every tunable
kernel registers its named variants here, a :class:`Tuner` times the
variants that support a concrete shape key — interleaved best-of-N windows,
each timed with CUDA events after a synchronize — and the winners land in a
persistent :class:`TuneTable`. Dispatch sites consult the attached table
through :func:`dispatch_variant` under ``kernel_tier=auto`` before falling
back to static routing, so a tuned table is the new routing and an untuned
process behaves bitwise as before.

Variant names are the reference's, kept one to one so that tables, metric
labels and captured key lists read the same in both packages: ``pallas`` is
the hand-written CUDA kernel (the reference's Pallas kernel), ``jnp`` the
plain PyTorch op chain (the reference's jnp chain), and for ``conv_bn``
``pallas_db`` (the kernels on the 128-row tile where ``pick_tile`` takes 64
rows: ``ops/cuda/conv_bn.py`` ``DB_TILE``, the reference's ``block_n=2``)
and ``pallas_bf16`` (float32 x and w cast to bfloat16 before the kernels,
y cast back; value-changing, so only under the ``kernel_autotune_bf16``
opt-in). Keys use the reference's dtype strings (``"float32"``, not
``"torch.float32"``).

On the card a table routes CUDA tensors only: under ``kernel_tier=auto`` a
CPU tensor takes the plain chain, as static routing sends it. A table
chooses among the hand-written variants wherever the kernel runs: the
tuner times ``jnp`` beside them but never records it as the winner of a key
whose ``pallas`` is supported, and dispatch ignores such an entry from
another table, so a supported shape on a CUDA tensor always launches a
kernel. ``jnp`` wins only where the kernel cannot run, as static routing
sends it there too.

Routing is per engine: an engine's warmup loads its bundle's table
(:func:`load_for_bundle`) and runs its dispatches under :func:`routing`,
so two models in one process route by their own tables, and an engine
whose bundle has none routes by the table attached process-wide by
:func:`attach_table` (none by default: static routing).

Persistence follows the warm-executable cache's artifact contract
(``serving/execcache.py``):

* **content-addressed artifact** — ``MAGIC + sha256hex(blob) + "\\n" +
  blob`` (blob is canonical JSON, no pickle), written tmp + ``os.replace``;
* **full identity fingerprint in the filename** — a table is valid only
  for the toolchain and device that measured it
  (:func:`table_fingerprint`: the torch and CUDA versions, the device name
  and capability, ``kernel_tier``, and the source hash of every kernel
  library ``ops/cuda/build.py`` builds, so an edited ``.cu`` misses);
* **typed bounded rejects** — :data:`REJECT_REASONS`; every refusal is a
  ``paddle_tpu_kernel_autotune_rejects`` bump plus a
  ``kernel_autotune_reject`` flight event followed by static routing;
* **manifest pinning** — a published ``<version>/tune/`` dir loads
  read-only with the raw bytes checked against the manifest's
  ``tune_files`` digests before parsing.

Every warm-executable fingerprint carries the digest of the table in
force (:func:`active_digest`: the engine's own, else the process-wide
one, whose digest is also the ``kernel_autotune_digest`` flag), so an
artifact exported under table X never loads where table Y routes.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import os
import threading
import time
from contextlib import contextmanager

from ..core.flags import get_flag, set_flags
from ..obs.metrics import REGISTRY as _METRICS
from .cuda import record_fallback, use_kernel

TUNE_DIRNAME = "tune"
ARTIFACT_SUFFIX = ".jtune"
_MAGIC = b"PDTPUTUNE1\n"

#   format       — bad magic / truncated / bit-flipped payload
#   manifest     — raw bytes not certified by the version manifest
#   fingerprint  — embedded identity != this process's identity
#   deserialize  — JSON/schema violations inside a well-formed envelope
REJECT_REASONS = ("format", "manifest", "fingerprint", "deserialize")

_M_SELECTIONS = _METRICS.counter(
    "paddle_tpu_kernel_autotune_selections",
    "dispatches routed by a tuned-table entry, per kernel family",
    labels=("kernel",))
_M_TUNES = _METRICS.counter(
    "paddle_tpu_kernel_autotune_tunes",
    "tuner measurements recorded into a tuning table (one per (kernel, "
    "shape key) tuned), per kernel family",
    labels=("kernel",))
_M_REJECTS = _METRICS.counter(
    "paddle_tpu_kernel_autotune_rejects",
    "tuning-table artifacts refused, by typed reason "
    "(ops.autotune.REJECT_REASONS); every reject falls back to static "
    "routing, never an engine failure",
    labels=("reason",))
_M_SELECTED = _METRICS.gauge(
    "paddle_tpu_kernel_variant_selected",
    "entries in the ATTACHED tuning table per (kernel, winning variant) "
    "— zero everywhere when no table is attached",
    labels=("kernel", "variant"))

_LOCK = threading.RLock()
_ACTIVE = None              # the attached TuneTable (process-wide)
# the table of the engine whose dispatch runs in this context (routing())
_ROUTE = contextvars.ContextVar("paddle_tpu_torch_tune_route", default=None)
_FORCED = {}                # kernel -> forced variant (tuner/tests)
_CAPTURE = None             # active capture list, or None


# ---------------------------------------------------------------------------
# shape keys
# ---------------------------------------------------------------------------

def dtype_str(dtype):
    """The reference's dtype string of a torch dtype (``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def make_key(**fields):
    """Canonical shape key for one dispatch: a sorted tuple of (name,
    value) pairs with shapes as int tuples and dtypes as strings. A
    symbolic dim (a ``torch.export`` trace) keys by its name and is never
    made concrete."""
    def canon(v):
        if isinstance(v, (list, tuple)):
            return tuple(canon(x) for x in v)
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        return str(v)
    return tuple(sorted((str(k), canon(v)) for k, v in fields.items()))


def key_str(key):
    """The table's storage key: compact JSON of the key tuple (tuples
    encode as lists, deterministically)."""
    return json.dumps(key, separators=(",", ":"), default=list)


# ---------------------------------------------------------------------------
# the variant registry
# ---------------------------------------------------------------------------

class _VariantSpec:
    __slots__ = ("name", "build", "bf16")

    def __init__(self, name, build, bf16=False):
        self.name = name
        self.build = build          # build(key) -> zero-arg runner | None
        self.bf16 = bool(bf16)


class VariantRegistry:
    """Named variants per tunable kernel family. ``build(key)`` returns a
    zero-arg callable that runs ONE step of the variant on inputs made
    from the shape key on the tuning device (or None when the key cannot be
    made standalone: the tuner then records the routing winner without
    timings)."""

    def __init__(self):
        self._kernels = {}

    def register(self, kernel, name, build, bf16=False):
        self._kernels.setdefault(kernel, {})[name] = \
            _VariantSpec(name, build, bf16=bf16)

    def variants(self, kernel):
        return dict(self._kernels.get(kernel, {}))

    def kernels(self):
        return sorted(self._kernels)


VARIANTS = VariantRegistry()


def variant_allowed(kernel, name, registry=None):
    """May the table route this kernel to this variant here? Unknown
    names (a table from a newer build) and bf16-flagged variants without
    the ``kernel_autotune_bf16`` opt-in are refused."""
    spec = (registry or VARIANTS).variants(kernel).get(name)
    if spec is None:
        return False
    return not spec.bf16 or bool(get_flag("kernel_autotune_bf16"))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@contextmanager
def force_variant(kernel, name):
    """Pin one kernel family to one variant for the duration (tuner
    runners and parity tests)."""
    with _LOCK:
        prev = _FORCED.get(kernel)
        _FORCED[kernel] = name
    try:
        yield
    finally:
        with _LOCK:
            if prev is None:
                _FORCED.pop(kernel, None)
            else:
                _FORCED[kernel] = prev


@contextmanager
def capture():
    """Record every (kernel, key, supported-variants) a region dispatches
    — what ``registry.warm(tune=True)`` runs around the engine's real
    warmup to learn which shapes to tune."""
    global _CAPTURE
    with _LOCK:
        prev, _CAPTURE = _CAPTURE, []
        keys = _CAPTURE
    try:
        yield keys
    finally:
        with _LOCK:
            _CAPTURE = prev


def dispatch_variant(kernel, key, supported, tier_kernel=None, device=None):
    """The ONE routing decision of a tunable dispatch site: which named
    variant runs this call. ``supported`` maps variant name -> this call's
    shape/config predicate; ``device`` is the call's tensors' device.

    Order (the reference's): a :func:`force_variant` pin wins (an
    unsupported pin runs ``jnp`` and counts a fallback); else under
    ``kernel_tier=auto`` with ``kernel_autotune`` on, the routing table's
    entry for ``key`` (the engine's, else the attached one) where its
    variant is supported and allowed, and is not ``jnp`` where ``pallas``
    is supported (CUDA tensors only, see the module docstring); else
    static routing through
    ``use_kernel(tier_kernel or kernel, supported["pallas"], device)``,
    bitwise the pre-autotune behavior; a family without a ``pallas``
    variant runs ``jnp`` and counts no fallback."""
    tier = tier_kernel or kernel
    if _CAPTURE is not None:
        _CAPTURE.append((kernel, key,
                         tuple(sorted(n for n, ok in supported.items()
                                      if ok))))
    forced = _FORCED.get(kernel)
    if forced is not None:
        if supported.get(forced, False):
            return forced
        if forced != "jnp":
            record_fallback(tier)
        return "jnp"
    table = _ROUTE.get() or _ACTIVE
    if (table is not None and get_flag("kernel_tier") == "auto"
            and get_flag("kernel_autotune")
            and (device is None or device.type == "cuda")):
        choice = table.lookup(kernel, key)
        # the plain chain only where the kernel cannot run
        if (choice is not None and supported.get(choice, False)
                and not (choice == "jnp" and supported.get("pallas"))
                and variant_allowed(kernel, choice)):
            _M_SELECTIONS.labels(kernel=kernel).inc()
            return choice
    if "pallas" not in supported:
        # a family with one lowering (chunked prefill): no kernel to want,
        # so no fallback to count
        return "jnp"
    if device is None:
        import torch
        device = torch.device("cpu")
    return "pallas" if use_kernel(tier, supported["pallas"], device) \
        else "jnp"


# ---------------------------------------------------------------------------
# measurement core — the interleaved best-of-N
# ---------------------------------------------------------------------------

def _tuning_device():
    import torch
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def measure(runners, repeats=3, inner=2):
    """Time each runner: ``repeats`` interleaved windows of ``inner``
    calls each, best window kept — the reference's best-of-N, interleaved
    across variants so drift hits every variant equally. One untimed
    warmup call per runner builds its kernels. On a card each window is
    timed with CUDA events after a synchronize (device time of the
    window's launches); on the CPU with the host clock. Returns ``{name:
    best ms/call}``; a runner that raises in its warmup is dropped (a
    variant that cannot run cannot win)."""
    import torch

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    order = []
    for name in sorted(runners):
        try:
            runners[name]()
            if cuda:
                torch.cuda.synchronize()
        except Exception:
            continue
        order.append(name)
    best = {}
    inner = max(1, int(inner))
    for _ in range(max(1, int(repeats))):
        for name in order:
            fn = runners[name]
            if cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _i in range(inner):
                    fn()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / inner
            else:
                t0 = time.perf_counter()
                for _i in range(inner):
                    fn()
                ms = (time.perf_counter() - t0) * 1e3 / inner
            if name not in best or ms < best[name]:
                best[name] = ms
    return best


# ---------------------------------------------------------------------------
# the tuning table + store
# ---------------------------------------------------------------------------

def table_fingerprint(device=None):
    """Identity a table's measurements are valid for: format/schema, the
    torch and CUDA versions, the device name and capability, the
    ``kernel_tier`` flag and every kernel library's source hash. Shapes and
    dtypes live in the per-entry keys."""
    from .cuda.build import device_identity
    fp = {"format": 1, "kind": "kernel_tune_table",
          "kernel_tier": str(get_flag("kernel_tier"))}
    fp.update(device_identity(device))
    return fp


def fingerprint_key(fp):
    """Stable digest of a fingerprint dict (the artifact filename key)."""
    return hashlib.sha256(
        json.dumps(fp, sort_keys=True, default=str).encode()).hexdigest()


class TuneTable:
    """{(kernel, key) -> winning variant (+ the timings that decided it)}
    under one :func:`table_fingerprint` identity."""

    def __init__(self, fingerprint=None, entries=None):
        self.fingerprint = dict(fingerprint) if fingerprint is not None \
            else table_fingerprint()
        # (kernel, key_str) -> {"variant": str, "timings_ms": {...}}
        self.entries = dict(entries or {})

    def set(self, kernel, key, variant, timings_ms=None):
        self.entries[(str(kernel), key_str(key))] = {
            "variant": str(variant),
            "timings_ms": {k: float(v)
                           for k, v in (timings_ms or {}).items()},
        }

    def lookup(self, kernel, key):
        e = self.entries.get((str(kernel), key_str(key)))
        return None if e is None else e["variant"]

    def merge(self, other):
        """Fold another table's entries in (``other`` wins on a key: it is
        the newer measurement)."""
        self.entries.update(other.entries)
        return self

    def to_doc(self):
        return {
            "schema": "pdtpu-tune-table-v1",
            "fingerprint": dict(self.fingerprint),
            "entries": [
                {"kernel": k, "key": json.loads(ks),
                 "variant": e["variant"],
                 "timings_ms": dict(e["timings_ms"])}
                for (k, ks), e in sorted(self.entries.items())],
        }

    @classmethod
    def from_doc(cls, doc):
        """Strict schema validation — any violation raises ValueError
        (the store's ``deserialize`` reject)."""
        if not isinstance(doc, dict) \
                or doc.get("schema") != "pdtpu-tune-table-v1":
            raise ValueError("not a pdtpu-tune-table-v1 document")
        fp = doc.get("fingerprint")
        entries_doc = doc.get("entries")
        if not isinstance(fp, dict) or not isinstance(entries_doc, list):
            raise ValueError("malformed tuning-table document")
        table = cls(fingerprint=fp)
        for e in entries_doc:
            if not isinstance(e, dict) \
                    or not isinstance(e.get("kernel"), str) \
                    or not isinstance(e.get("variant"), str) \
                    or not isinstance(e.get("key"), list):
                raise ValueError("malformed tuning-table entry")
            timings = e.get("timings_ms", {})
            if not isinstance(timings, dict):
                raise ValueError("malformed tuning-table timings")
            table.entries[(e["kernel"],
                           json.dumps(e["key"], separators=(",", ":")))] \
                = {"variant": e["variant"],
                   "timings_ms": {str(k): float(v)
                                  for k, v in timings.items()}}
        return table

    def digest(self):
        """Content identity of the whole table (the
        ``kernel_autotune_digest`` flag value while attached)."""
        return hashlib.sha256(
            json.dumps(self.to_doc(), sort_keys=True).encode()).hexdigest()


class TuneStore:
    """One directory of tuning-table artifacts: content-addressed
    envelope, identity in the filename, typed bounded rejects, optional
    manifest pinning, tmp+replace writes. ``load`` and ``save`` never
    raise — a broken table only ever costs the static routing it failed to
    replace."""

    def __init__(self, path, readonly=False, expected_digests=None):
        self.path = str(path)
        self.readonly = bool(readonly)
        self._expected = None if expected_digests is None \
            else dict(expected_digests)
        if not self.readonly:
            os.makedirs(self.path, exist_ok=True)
        self._touched = set()

    def artifact_path(self, fp=None):
        fp = fp if fp is not None else table_fingerprint()
        return os.path.join(
            self.path, f"table-{fingerprint_key(fp)[:40]}{ARTIFACT_SUFFIX}")

    def note_reject(self, reason, error=None):
        from ..obs.recorder import record as _flight_record

        if reason not in REJECT_REASONS:
            reason = "deserialize"
        _M_REJECTS.labels(reason=reason).inc()
        _flight_record("kernel_autotune_reject", component="ops.autotune",
                       dir=self.path, reason=reason,
                       error=None if error is None
                       else f"{type(error).__name__}: {error}")

    def load(self, fp=None):
        """The table for this process's identity, or None (a missing file
        is a silent miss; everything else wrong is a counted reject)."""
        fp = fp if fp is not None else table_fingerprint()
        path = self.artifact_path(fp)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        stage = "format"
        try:
            if self._expected is not None:
                stage = "manifest"
                want = self._expected.get(os.path.basename(path))
                if want is None:
                    raise ValueError("artifact is not listed in the "
                                     "version manifest's tune_files")
                if hashlib.sha256(raw).hexdigest() != want:
                    raise ValueError("artifact bytes do not match the "
                                     "manifest's tune_files digest")
                stage = "format"
            if not raw.startswith(_MAGIC):
                raise ValueError("bad magic (not a tuning-table artifact)")
            header_end = raw.index(b"\n", len(_MAGIC))
            digest = raw[len(_MAGIC):header_end].decode("ascii")
            blob = raw[header_end + 1:]
            if hashlib.sha256(blob).hexdigest() != digest:
                raise ValueError("payload digest mismatch (truncated or "
                                 "bit-flipped artifact)")
            stage = "deserialize"
            table = TuneTable.from_doc(json.loads(blob.decode("utf-8")))
            stage = "fingerprint"
            if table.fingerprint != fp:
                raise ValueError("table fingerprint does not match this "
                                 "process's identity")
        except Exception as e:
            self.note_reject(stage, error=e)
            return None
        self._touched.add(os.path.basename(path))
        return table

    def save(self, table):
        """Persist one table (tmp + ``os.replace``); returns the artifact
        path, or None when read-only or unwritable."""
        if self.readonly:
            return None
        from ..obs.recorder import record as _flight_record

        try:
            blob = json.dumps(table.to_doc(), sort_keys=True).encode()
            data = (_MAGIC + hashlib.sha256(blob).hexdigest().encode()
                    + b"\n" + blob)
            path = self.artifact_path(table.fingerprint)
            tmp = path + f".{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except Exception as e:
            _flight_record("kernel_autotune_save_failed",
                           component="ops.autotune", dir=self.path,
                           error=f"{type(e).__name__}: {e}")
            return None
        self._touched.add(os.path.basename(path))
        return path

    def touched(self):
        return sorted(self._touched)


# ---------------------------------------------------------------------------
# attach / resolve
# ---------------------------------------------------------------------------

def _refresh_selected_gauge():
    _M_SELECTED.reset()
    if _ACTIVE is None:
        return
    counts = {}
    for (kernel, _ks), e in _ACTIVE.entries.items():
        pair = (kernel, e["variant"])
        counts[pair] = counts.get(pair, 0) + 1
    for (kernel, variant), n in counts.items():
        _M_SELECTED.labels(kernel=kernel, variant=variant).set(n)


def attach_table(table, merge=True):
    """Make ``table`` the process-wide routing table and key every
    warm-executable fingerprint on its digest (the
    ``kernel_autotune_digest`` flag). ``merge=True`` folds it into an
    already-attached table. Returns the active digest."""
    global _ACTIVE
    with _LOCK:
        if merge and _ACTIVE is not None:
            table = TuneTable(fingerprint=table.fingerprint,
                              entries=_ACTIVE.entries).merge(table)
        _ACTIVE = table
        digest = table.digest()
        _refresh_selected_gauge()
    set_flags({"kernel_autotune_digest": digest})
    return digest


def detach_table():
    """Drop the active table: routing reverts to static and the digest
    flag clears."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None
        _refresh_selected_gauge()
    set_flags({"kernel_autotune_digest": ""})


def active_table():
    """The table dispatch routes by here: the engine's (:func:`routing`),
    else the attached one, else None."""
    return _ROUTE.get() or _ACTIVE


def active_digest():
    """Digest of :func:`active_table`, or None."""
    with _LOCK:
        table = active_table()
        return None if table is None else table.digest()


@contextmanager
def routing(table):
    """Route this context's dispatches by ``table`` (an engine's own,
    from :func:`load_for_bundle`); ``None`` leaves the process-wide
    routing in force."""
    if table is None:
        yield
        return
    token = _ROUTE.set(table)
    try:
        yield
    finally:
        _ROUTE.reset(token)


def manifest_tune_digests(model_dir):
    """basename -> sha256 pin set from the version manifest's
    ``tune_files``; a manifest without the field pins the empty set; no
    readable manifest returns None (not a registry version)."""
    try:
        with open(os.path.join(model_dir, "VERSION.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return {os.path.basename(rel): digest
            for rel, digest in manifest.get("tune_files", {}).items()}


def resolve_store(model_dir=None):
    """The store an engine reads its table from: the bundle's published
    ``tune/`` dir (read-only, manifest-pinned) when it exists, else the
    ``kernel_autotune_dir`` flag's local dir, else None."""
    if model_dir:
        tdir = os.path.join(str(model_dir), TUNE_DIRNAME)
        if os.path.isdir(tdir):
            return TuneStore(tdir, readonly=True,
                             expected_digests=manifest_tune_digests(
                                 str(model_dir)))
    local = get_flag("kernel_autotune_dir")
    if local and os.path.isdir(local):
        return TuneStore(local, readonly=True)
    return None


def load_for_bundle(model_dir=None):
    """Engine-warmup hook: resolve + load the bundle's table, which the
    engine then routes by (:func:`routing`). None unless
    ``kernel_tier=auto`` with ``kernel_autotune`` on and a loadable table
    exists; corruption downgrades to static routing through the store's
    typed rejects."""
    if not get_flag("kernel_autotune") or get_flag("kernel_tier") != "auto":
        return None
    store = resolve_store(model_dir)
    return None if store is None else store.load()


def attach_for_bundle(model_dir=None):
    """:func:`load_for_bundle`, attached process-wide (the reference's
    hook, for a process that serves one bundle). Returns the active
    digest, or None where nothing was loaded."""
    table = load_for_bundle(model_dir)
    return None if table is None else attach_table(table)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

class Tuner:
    """Measure captured dispatch keys and record the winners.
    ``repeats``/``inner`` are the interleaved best-of-N window shape
    (:func:`measure`). bf16-flagged variants join the candidate set only
    under the ``kernel_autotune_bf16`` opt-in. Where ``pallas`` is
    supported the winner is the fastest hand-written variant (``jnp`` is
    timed, not chosen)."""

    def __init__(self, repeats=3, inner=2, registry=None):
        self.repeats = int(repeats)
        self.inner = int(inner)
        self.registry = registry or VARIANTS

    def tune(self, captured, table=None):
        """-> :class:`TuneTable` with one entry per distinct (kernel, key)
        in ``captured`` (the :func:`capture` output). Single-candidate
        keys record their only routing without timings; multi-candidate
        keys are measured."""
        table = table if table is not None else TuneTable()
        seen = set()
        for kernel, key, supported_names in captured:
            ks = (kernel, key_str(key))
            if ks in seen:
                continue
            seen.add(ks)
            specs = self.registry.variants(kernel)
            cands = [n for n in supported_names
                     if n in specs
                     and variant_allowed(kernel, n, self.registry)]
            if not cands:
                continue
            winner, timings = cands[0], {}
            if len(cands) > 1:
                runners = {}
                for n in cands:
                    try:
                        r = specs[n].build(key)
                    except Exception:
                        r = None
                    if r is not None:
                        runners[n] = r
                if len(runners) > 1:
                    timings = measure(runners, repeats=self.repeats,
                                      inner=self.inner)
                # where the kernel runs, a hand-written variant wins; the
                # plain chain's time is kept beside theirs
                eligible = {n: ms for n, ms in timings.items()
                            if n != "jnp" or "pallas" not in cands}
                if eligible:
                    winner = min(eligible, key=eligible.get)
                elif "pallas" in cands:
                    winner = "pallas"
                elif "jnp" in cands:
                    winner = "jnp"
            table.set(kernel, key, winner, timings)
            _M_TUNES.labels(kernel=kernel).inc()
        return table


# ---------------------------------------------------------------------------
# variant registrations — runners made from keys on the tuning device
# ---------------------------------------------------------------------------

def _fields(key):
    return dict(key)


def _rng_fill(shape, dtype, seed, device):
    import numpy as np
    import torch

    from ..core.types import torch_dtype
    rng = np.random.RandomState(seed)
    a = rng.standard_normal(size=tuple(int(d) for d in shape))
    return torch.from_numpy(a.astype(np.float32)).to(
        device, torch_dtype(dtype))


def _conv_bn_build(variant):
    def build(key):
        import torch

        from .cuda import conv_bn as cbk
        k = _fields(key)
        dev = _tuning_device()
        x = _rng_fill(k["x"], k["dtype"], 11, dev)
        w = _rng_fill(k["w"], "float32", 13, dev)
        cout = int(k["w"][0])
        f32 = dict(dtype=torch.float32, device=dev)
        scale, bias = torch.ones(cout, **f32), torch.zeros(cout, **f32)
        rm, rv = torch.zeros(cout, **f32), torch.ones(cout, **f32)
        strides, paddings = list(k["strides"]), list(k["paddings"])
        act, is_test = k["act"], bool(k["is_test"])
        eps = 1e-5
        if variant == "jnp":
            from .conv_ops import conv2d_compute
            from .norm_ops import bn_forward_math

            def plain():
                z = conv2d_compute(x, w.to(x.dtype), strides, paddings,
                                   k["dilations"], k["groups"], k["df"])
                y = bn_forward_math(z, scale, bias, rm, rv, eps, 0.9,
                                    k["df"], is_test)[0]
                return torch.clamp_min(y, 0) if act == "relu" else y
            return plain
        tile = {"tile": cbk.DB_TILE} if variant == "pallas_db" else {}
        xv = x.to(torch.bfloat16) if variant == "pallas_bf16" else x
        xv = xv.contiguous()
        if is_test:
            return lambda: cbk.conv_affine(xv, w, scale, bias, strides,
                                           paddings, act, **tile)
        return lambda: cbk.conv_bn_train(xv, w, scale, bias, eps, strides,
                                         paddings, act, **tile)
    return build


def _paged_attention_build(variant):
    def build(key):
        import numpy as np
        import torch

        from .cuda import paged_attention as pa
        k = _fields(key)
        dev = _tuning_device()
        s, h, d = (int(v) for v in k["q"])
        nb, bs = int(k["kc"][0]), int(k["kc"][1])
        p = int(k["tables"])
        qh = _rng_fill((s, h, d), k["dtype"], 17, dev)
        kc = _rng_fill((nb, bs, h, d), k["dtype"], 19, dev)
        vc = _rng_fill((nb, bs, h, d), k["dtype"], 23, dev)
        bt = torch.from_numpy((np.arange(s * p) % nb).reshape(s, p)
                              .astype(np.int32)).to(dev)
        ctx = torch.full((s,), min(p * bs, nb * bs), dtype=torch.int32,
                         device=dev)
        fn = pa.paged_attention_cuda if variant == "pallas" \
            else pa.paged_attention_torch
        return lambda: fn(qh, kc, vc, bt, ctx)
    return build


def _rnn_build(variant):
    def build(key):
        import torch

        from . import rnn_ops
        k = _fields(key)
        dev = _tuning_device()
        cell = k["cell"]
        b, L, hx = (int(v) for v in k["x"])
        H = hx // (4 if cell == "lstm" else 3)
        x = _rng_fill((b, L, hx), k["dtype"], 29, dev) * 0.1
        w = _rng_fill((H, hx), k["dtype"], 31, dev) * 0.1
        lens = torch.full((b,), L, dtype=torch.int32, device=dev)
        h0 = torch.zeros((b, H), dtype=x.dtype, device=dev)
        if cell == "lstm":
            c0 = torch.zeros((b, H), dtype=x.dtype, device=dev)

            def step():
                return rnn_ops._lstm_scan(x, lens, w, h0, c0, "sigmoid",
                                          "tanh", "tanh")
        else:
            def step():
                return rnn_ops._gru_compute(x, lens, w, None, h0, {})

        def run():
            with torch.no_grad(), force_variant("rnn", variant):
                return step()
        return run
    return build


def _embedding_build(variant):
    def build(key):
        import numpy as np
        import torch

        from .cuda import embedding as embk
        k = _fields(key)
        dev = _tuning_device()
        rows, dim, nnz = int(k["rows"]), int(k["dim"]), int(k["nnz"])
        p = _rng_fill((rows, dim), k["dtype"], 37, dev)
        vals = _rng_fill((nnz, dim), k["dtype"], 41, dev)
        # Knuth-hash row ids: spread like real minibatch ids
        idx = torch.from_numpy(((np.arange(nnz) * 2654435761) % rows)
                               .astype(np.int64)).to(dev)
        lr = torch.tensor([0.01], dtype=torch.float32, device=dev)
        fn = embk.embedding_sgd if variant == "pallas" \
            else embk.embedding_sgd_scatter
        return lambda: fn(p, idx, vals, lr)
    return build


def _optimizer_build(variant):
    def build(key):
        import torch

        from .cuda import optimizer as opk
        k = _fields(key)
        dev = _tuning_device()
        kind, tensors, elems = k["kind"], int(k["tensors"]), int(k["elems"])
        per = max(1, elems // max(1, tensors))
        ps = [_rng_fill((per,), "float32", 43 + i, dev)
              for i in range(tensors)]
        gs = [_rng_fill((per,), "float32", 53 + i, dev)
              for i in range(tensors)]
        ss = [_rng_fill((per,), "float32", 67 + i, dev)
              for i in range(tensors)]
        s2 = [_rng_fill((per,), "float32", 79 + i, dev).abs()
              for i in range(tensors)]
        one = dict(dtype=torch.float32, device=dev)
        lr, mu = torch.tensor([0.01], **one), 0.9
        b1p, b2p = torch.tensor([0.9], **one), torch.tensor([0.999], **one)
        if variant == "pallas":
            if kind == "sgd":
                return lambda: opk.sgd_arena(ps, gs, lr)
            if kind == "momentum":
                return lambda: opk.momentum_arena(ps, gs, ss, lr, mu, False)
            return lambda: opk.adam_arena(ps, gs, ss, s2, lr, b1p, b2p, 0.9,
                                          0.999, 1e-8)
        if kind == "sgd":
            return lambda: [opk._sgd_dense(p, g, lr) for p, g in zip(ps, gs)]
        if kind == "momentum":
            return lambda: [opk._momentum_dense(p, g, v, lr, mu, False)
                            for p, g, v in zip(ps, gs, ss)]
        lr_eff = opk.adam_lr(lr, b1p, b2p)
        return lambda: [opk._adam_dense(p, g, m1, m2, lr_eff, 0.9, 0.999,
                                        1e-8)
                        for p, g, m1, m2 in zip(ps, gs, ss, s2)]
    return build


VARIANTS.register("conv_bn", "jnp", _conv_bn_build("jnp"))
VARIANTS.register("conv_bn", "pallas", _conv_bn_build("pallas"))
VARIANTS.register("conv_bn", "pallas_db", _conv_bn_build("pallas_db"))
VARIANTS.register("conv_bn", "pallas_bf16", _conv_bn_build("pallas_bf16"),
                  bf16=True)
VARIANTS.register("paged_attention", "jnp", _paged_attention_build("jnp"))
VARIANTS.register("paged_attention", "pallas",
                  _paged_attention_build("pallas"))
# chunked prefill has one lowering; registering it keeps its warmup shapes
# in tuned tables, as the reference does
VARIANTS.register("chunked_prefill_attention", "jnp", lambda key: None)
VARIANTS.register("rnn", "jnp", _rnn_build("jnp"))
VARIANTS.register("rnn", "pallas", _rnn_build("pallas"))
VARIANTS.register("embedding", "jnp", _embedding_build("jnp"))
VARIANTS.register("embedding", "pallas", _embedding_build("pallas"))
VARIANTS.register("optimizer", "jnp", _optimizer_build("jnp"))
VARIANTS.register("optimizer", "pallas", _optimizer_build("pallas"))


__all__ = [
    "ARTIFACT_SUFFIX", "REJECT_REASONS", "TUNE_DIRNAME", "TuneStore",
    "TuneTable", "Tuner", "VARIANTS", "VariantRegistry", "active_digest",
    "active_table", "attach_for_bundle", "attach_table", "capture",
    "detach_table", "dispatch_variant", "dtype_str", "fingerprint_key",
    "force_variant", "key_str", "load_for_bundle", "make_key",
    "manifest_tune_digests", "measure", "resolve_store", "routing",
    "table_fingerprint", "variant_allowed",
]
