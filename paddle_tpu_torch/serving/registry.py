"""ModelRegistry: a versioned store of ``save_inference_model`` bundles
(counterpart of paddle_tpu/serving/registry.py).

The missing link between "a model was exported somewhere in /tmp" and "a
fleet of replicas serves version N and can roll to N+1": versions live
under ``<root>/<model>/<version>/`` as plain copies of the exported
bundle, and a version becomes VISIBLE only when its ``VERSION.json``
manifest (per-file sha256 digests + a combined content hash) lands via
tmp + ``os.replace`` — the same atomic-last-write discipline the pserver
checkpoints and ``fluid.io.save_vars`` use, so a torn publish is an
invisible version, never a corrupt "latest". Versions are immutable once
published; rollback is just resolving the previous version, which is why
the fleet's ``rolling_reload`` can rescue a failed canary without any
undo machinery.

Corruption is detected at two depths: :meth:`verify` re-hashes the files
against the manifest (bit rot, torn copies), and actually LOADING a
resolved bundle reuses ``load_inference_model``'s typed ValueError
(missing/corrupt ``__model__``) — the serving engine raises it before a
bad version can swap in, which is what a rollout's canary gate catches.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

from ..fluid.io import MODEL_FILENAME

VERSION_MANIFEST = "VERSION.json"


def _default_route():
    """The route the ``kernel_tier`` flag resolves to on the card where
    one is present, else on the CPU: the manifest's default capability."""
    import torch

    from ..ops.cuda import resolve_tier
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    return resolve_tier(dev)


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _content_hash(files):
    """Combined hash over the sorted (name, digest) pairs — one value that
    pins the whole bundle's bytes."""
    h = hashlib.sha256()
    for name in sorted(files):
        h.update(f"{name}:{files[name]}\n".encode())
    return h.hexdigest()


class ModelRegistry:
    """``ModelRegistry(root)`` over a directory of
    ``<model>/<version>/`` bundles.

        reg = ModelRegistry(root)
        v = reg.publish("ranker", export_dir)        # auto-increments
        path, v = reg.resolve("ranker", "latest")    # newest published
        reg.verify("ranker", v)                      # re-hash the bytes
    """

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------------
    def model_dir(self, model):
        if (not model or os.sep in model or (os.altsep or "/") in model
                or model.startswith(".")):
            raise ValueError(
                f"invalid model name {model!r}: one plain path component")
        return os.path.join(self.root, model)

    def version_dir(self, model, version):
        return os.path.join(self.model_dir(model), str(int(version)))

    def models(self):
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def versions(self, model):
        """PUBLISHED versions (ascending) — a version dir without its
        VERSION.json (a torn publish in progress or abandoned) is
        invisible."""
        d = self.model_dir(model)
        if not os.path.isdir(d):
            return []
        out = []
        for name in os.listdir(d):
            if name.isdigit() and os.path.exists(
                    os.path.join(d, name, VERSION_MANIFEST)):
                out.append(int(name))
        return sorted(out)

    # ------------------------------------------------------------------
    def _all_version_dirs(self, model):
        """EVERY numeric version dir, published or torn — what the
        auto-increment must step over: a freezer that crashed mid-copy
        leaves a manifest-less dir, and handing its number out again
        would wedge every subsequent publish on the immutability check."""
        d = self.model_dir(model)
        if not os.path.isdir(d):
            return []
        return sorted(int(n) for n in os.listdir(d) if n.isdigit())

    def publish(self, model, src_dir, version=None, kernel_tier=None,
                model_kind="feedforward", lineage=None, warm_cache=False,
                warm_kwargs=None, kv_prompts=None, tune=False, plan=False,
                place=None):
        """Copy the bundle at ``src_dir`` in as ``version`` (next integer
        when None) and make it visible by writing the manifest LAST,
        atomically. Returns the published version number. Versions are
        immutable: republishing an existing one raises.

        ``kernel_tier`` is a CAPABILITY field recorded in the manifest:
        which route the publisher validated this bundle with, in the
        port's tier names ("cuda" = the hand-written kernels, "torch" =
        the plain chain; default = the route the ``kernel_tier`` flag
        resolves to on the card where one is present, else on the CPU).
        Serving replicas surface their own route through
        ``InferenceEngine.stats()`` so a rollout gate can compare the two.

        ``place`` is the device the warm, KV and tune passes run their
        engines on (the card unless the caller asks for the CPU).

        ``model_kind`` declares which engine class serves the bundle:
        "feedforward" (InferenceEngine, the default — pre-upgrade
        manifests without the field resolve to it, no migration needed)
        or "generative" (GenerationEngine: stateful decode over the
        bundle's causal_self_attention sites). ModelServer reads it from
        the version dir's VERSION.json and picks the engine class;
        :meth:`model_kind` surfaces it alongside :meth:`resolve`.

        ``lineage`` is an optional dict of provenance the publisher wants
        recorded in the manifest (the online freezer stamps
        ``global_step``/``parent_version``/``freeze_round``); every
        manifest additionally records ``published_at`` (wall-clock), the
        timestamp the rollout controller computes publish-to-served lag
        from. Lineage is metadata only — resolution and verification
        never read it.

        ``warm_cache=True`` runs :meth:`warm` on the just-published
        version (``warm_kwargs`` forwarded): the publisher pays each
        executable's compile ONCE and every replica that serves this
        version loads instead of compiling. The manifest lands FIRST —
        a crash mid-warm leaves a fully published version whose
        replicas simply compile.

        ``kv_prompts`` (generative bundles) additionally runs each
        prompt's prefill ONCE at publish time and stores the resulting
        KV-prefix chains under ``<version>/kv/`` (see
        serving/generate/kvstore.py): replicas that serve this version
        attach those prefixes with ZERO prefill steps. Passing it
        implies a warm pass even without ``warm_cache=True``.

        ``tune=True`` (or a dict of Tuner options, e.g.
        ``{"repeats": 3, "inner": 2}``) additionally runs the kernel
        autotuner at publish time against the engine's REAL warmup
        shapes and ships the winning-variant table under
        ``<version>/tune/`` (ops/autotune.py), manifest-pinned like
        ``warm_files`` — replicas that serve this version route tunable
        kernels by measurement with zero in-band tuning work. Implies a
        warm pass.

        ``plan=True`` additionally runs the auto-parallelism placement
        planner (parallel/planner.py) at publish time and ships the
        searched PlacementReport under ``<version>/plan/``,
        manifest-pinned as ``plan_files`` — replicas that serve this
        version resolve the certified plan
        (``parallel.planner.resolve_store``) without re-searching.
        Implies a warm pass."""
        if not os.path.exists(os.path.join(src_dir, MODEL_FILENAME)):
            raise ValueError(
                f"publish: {src_dir!r} is not a save_inference_model "
                f"bundle (no {MODEL_FILENAME!r} file)")
        # validate BEFORE any filesystem mutation: a raise below the
        # makedirs would leave a torn manifest-less version dir that
        # permanently blocks this version number (immutability check)
        if kernel_tier is None:
            kernel_tier = _default_route()
        elif kernel_tier not in ("cuda", "torch"):
            raise ValueError(
                f"kernel_tier capability must be 'cuda' or 'torch', "
                f"got {kernel_tier!r}")
        if model_kind not in ("feedforward", "generative"):
            raise ValueError(
                f"model_kind must be 'feedforward' or 'generative', "
                f"got {model_kind!r}")
        if lineage is not None and not isinstance(lineage, dict):
            raise ValueError(
                f"lineage must be a dict of provenance fields, "
                f"got {type(lineage).__name__}")
        auto = version is None
        if not auto:
            version = int(version)
            if version <= 0:
                raise ValueError(f"version must be a positive int, "
                                 f"got {version}")
        # the makedirs IS the claim on the version number: concurrent
        # publishers (a freezer worker racing an operator publish) both
        # computing the same auto-increment cannot both create the dir,
        # so the loser re-derives the next number instead of failing —
        # only an EXPLICIT version collides into the immutability error
        for _attempt in range(64):
            if auto:
                # next number past EVERY existing dir, torn ones included
                # — a crash mid-publish must not permanently wedge
                # auto-increment on its abandoned manifest-less dir
                all_dirs = self._all_version_dirs(model)
                version = all_dirs[-1] + 1 if all_dirs else 1
            dst = self.version_dir(model, version)
            try:
                os.makedirs(dst)
                break
            except FileExistsError:
                if not auto:
                    raise ValueError(
                        f"version {version} of model {model!r} already "
                        "exists (published versions are immutable; "
                        "publish a new one)") from None
        else:
            raise RuntimeError(
                f"publish: could not claim a version number for "
                f"{model!r} after 64 attempts (pathological publish "
                "contention)")
        files = {}
        for name in sorted(os.listdir(src_dir)):
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src) or name == VERSION_MANIFEST \
                    or name.endswith(".tmp"):
                continue
            shutil.copyfile(src, os.path.join(dst, name))
            # hash the DESTINATION bytes: the manifest certifies what the
            # registry holds, not what the source held mid-copy
            files[name] = _sha256_file(os.path.join(dst, name))
        manifest = {"model": model, "version": version, "files": files,
                    "content_hash": _content_hash(files),
                    "kernel_tier": kernel_tier,
                    "model_kind": model_kind,
                    "published_at": time.time()}
        if lineage:
            manifest["lineage"] = dict(lineage)
        tmp = os.path.join(dst, VERSION_MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(dst, VERSION_MANIFEST))
        if warm_cache or kv_prompts or tune or plan:
            wk = dict(warm_kwargs or {})
            if kv_prompts is not None:
                wk.setdefault("kv_prompts", kv_prompts)
            if tune:
                wk.setdefault("tune", tune)
            if plan:
                wk.setdefault("plan", plan)
            if place is not None:
                wk.setdefault("place", place)
            self.warm(model, version, **wk)
        return version

    # ------------------------------------------------------------------
    def warm(self, model, version="latest", buckets=None, sample_feed=None,
             gen_opts=None, kv_prompts=None, tune=False, plan=False,
             place=None):
        """Build (or complete) the version's persistent compiled-
        executable artifacts under ``<version>/warm/`` so replicas LOAD
        instead of compile (serving/execcache.py): an engine of the
        manifest's ``model_kind`` is constructed on the version dir with
        a WRITABLE cache and warmed — artifacts that already exist and
        fingerprint-match are loaded (so re-warming is idempotent:
        nothing recompiles, nothing is rewritten), the rest are compiled
        once here and persisted. The manifest then lists every artifact
        under ``warm_files`` with a per-file sha256, exactly like the
        bundle files — :meth:`verify` re-hashes them, :meth:`gc` deletes
        them with the version. The bundle files themselves (and
        ``content_hash``, which KEYS the artifacts) stay immutable; the
        warm dir is an additive sidecar.

        ``buckets``/``sample_feed`` configure a feed-forward warmup;
        ``gen_opts`` are GenerationEngine kwargs for generative bundles
        — they must match what serving replicas use (both default from
        the same flags), or the replica's differently-shaped feeds
        simply miss the cache and compile. The warm dir holds exactly
        the LAST warm run's artifact set: artifacts a previous
        toolchain/flag configuration produced fingerprint-miss forever,
        so they are pruned instead of re-certified into the manifest
        (``warm/`` and ``VERSION.json`` must not grow monotonically
        with every toolchain upgrade). Returns the sorted artifact relpaths
        recorded in the manifest.

        ``kv_prompts`` (generative bundles only) runs each prompt's
        prefill once HERE and persists the resulting KV-prefix chains
        under ``<version>/kv/`` (serving/generate/kvstore.py), listed
        in the manifest as ``kv_files`` with per-file sha256 — same
        contract as ``warm_files``: :meth:`verify` re-hashes them,
        :meth:`gc` deletes them with the version, and the serving
        engine pins loads to these digests before deserializing
        anything. Re-warming with the same prompts is idempotent
        (every chain loads from its existing artifact with zero
        prefill steps; nothing is rewritten). When ``kv_prompts`` is
        None an existing ``kv/`` dir is left untouched — warm-cache
        refreshes must not prune KV artifacts they didn't rebuild.

        ``tune=True`` (or a Tuner-option dict: ``repeats``/``inner``)
        runs the kernel autotuner FIRST: a throwaway engine (no exec
        cache) is warmed under ``ops.autotune.capture`` to learn the
        real dispatch keys, the tuner measures each key's registered
        variants, and the winning table lands under ``<version>/tune/``
        with ``tune_files`` certified into the manifest BEFORE the warm
        engine is built — so the warm pass attaches the manifest-pinned
        table and every persisted executable's fingerprint already
        carries the table digest (a replica loading warm/ under the
        same table hits; one without the table recompiles instead of
        loading mismatched routing). When ``tune`` is falsy an existing
        ``tune/`` dir is left untouched, like ``kv/``.

        A generative bundle's ``warm/`` holds one exported program per
        (phase, bucket) of the engine ``gen_opts`` configures.

        ``plan=True`` runs the publish-time placement search
        (parallel/planner.py): the bundle is loaded into a throwaway
        scope, the planner enumerates and cost-models the legal meshes
        for THIS host's device count (the process group's, else the
        visible cards), and the ranked PlacementReport lands under
        ``<version>/plan/`` with ``plan_files`` certified into the
        manifest — replicas resolve the certified plan
        (``parallel.planner.resolve_store``) and place without
        re-searching. Re-warming is idempotent (the fingerprint-matching
        artifact is a cache hit, nothing is rewritten); a plan pass that
        fails (e.g. a bundle whose feeds the planner cannot synthesize)
        records a flight event and certifies nothing — plans are an
        additive sidecar, never a publish failure. When ``plan`` is
        falsy an existing ``plan/`` dir is left untouched. ``place`` is
        the engines' and the planner's device."""
        path, v = self.resolve(model, version)
        m = self.manifest(model, v)
        from .execcache import ARTIFACT_SUFFIX, ExecCache, WARM_DIRNAME
        from .generate import kvstore as _kvs
        if tune:
            tune_files = self._tune(path, m, buckets=buckets,
                                    sample_feed=sample_feed,
                                    gen_opts=gen_opts,
                                    tune_opts=tune if isinstance(tune, dict)
                                    else None, place=place)
            if m.get("tune_files") != tune_files:
                m["tune_files"] = tune_files
                tmp = os.path.join(path, VERSION_MANIFEST + ".tmp")
                with open(tmp, "w") as f:
                    json.dump(m, f, indent=1, sort_keys=True)
                os.replace(tmp, os.path.join(path, VERSION_MANIFEST))
        if plan:
            plan_files = self._plan(path, m, place=place)
            if m.get("plan_files") != plan_files:
                m["plan_files"] = plan_files
                tmp = os.path.join(path, VERSION_MANIFEST + ".tmp")
                with open(tmp, "w") as f:
                    json.dump(m, f, indent=1, sort_keys=True)
                os.replace(tmp, os.path.join(path, VERSION_MANIFEST))
        warm_dir = os.path.join(path, WARM_DIRNAME)
        cache = ExecCache(warm_dir)
        kv_files = None
        if m.get("model_kind", "feedforward") == "generative":
            from .generate import GenerationEngine
            gopts = dict(gen_opts or {})
            if kv_prompts:
                # the prefix cache must be ON so prefilled chains
                # register (prefix_cache_blocks is a retention cap, not
                # an allocation), and the engine's KV store must point
                # at the version's kv/ dir, WRITABLE — resolve_store
                # gives an explicit path write access; replicas that
                # later resolve the same dir implicitly get it
                # read-only and manifest-pinned
                gopts.setdefault("prefix_cache_blocks", 4096)
                gopts.setdefault("kv_store",
                                 os.path.join(path, _kvs.KV_DIRNAME))
            engine = GenerationEngine(path, place=place, exec_cache=cache,
                                      **gopts)
            engine.warmup()
            if kv_prompts:
                kv_files = self._precompute_kv(engine, path, kv_prompts)
        else:
            from .engine import InferenceEngine
            if kv_prompts:
                raise ValueError(
                    "kv_prompts requires a generative bundle; "
                    f"{model!r}/{v} is feedforward")
            engine = InferenceEngine(path, place=place, buckets=buckets,
                                     exec_cache=cache)
            engine.warmup(sample_feed)
        touched = set(cache.touched())
        warm_files = {}
        for name in sorted(os.listdir(warm_dir)):
            fpath = os.path.join(warm_dir, name)
            if not os.path.isfile(fpath) or name.endswith(".tmp"):
                continue
            if name in touched:
                warm_files[f"{WARM_DIRNAME}/{name}"] = _sha256_file(fpath)
            elif name.endswith(ARTIFACT_SUFFIX):
                # stale artifact this warmup neither loaded nor wrote:
                # its fingerprint can never match again — prune it
                # (stray non-artifact files are left alone, unlisted)
                try:
                    os.unlink(fpath)
                except OSError:
                    pass
        changed = m.get("warm_files") != warm_files
        m["warm_files"] = warm_files
        if kv_files is not None:
            changed = changed or m.get("kv_files") != kv_files
            m["kv_files"] = kv_files
        if changed:
            tmp = os.path.join(path, VERSION_MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                json.dump(m, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(path, VERSION_MANIFEST))
        return sorted(warm_files) + sorted(kv_files or {}) \
            + sorted(m.get("tune_files", {}) if tune else {}) \
            + sorted(m.get("plan_files", {}) if plan else {})

    def _tune(self, path, m, buckets=None, sample_feed=None, gen_opts=None,
              tune_opts=None, place=None):
        """Run the publish-time autotune pass: capture the real warmup's
        dispatch keys on a THROWAWAY engine (no exec cache — loading
        warm artifacts would skip the traced dispatches whose keys this
        pass exists to learn), measure each captured key's registered
        variants, and persist the winning table under ``tune/``. Keys an
        existing valid table already covers are NOT re-measured (re-
        warming is idempotent: same table bytes, same digest, nothing
        downstream recompiles). Returns the ``tune_files`` digest map."""
        from ..ops import autotune as _at
        if m.get("model_kind", "feedforward") == "generative":
            from .generate import GenerationEngine
            engine = GenerationEngine(path, place=place, kv_store=False,
                                      exec_cache=False,
                                      **dict(gen_opts or {}))
            with _at.capture() as keys:
                engine.warmup()
        else:
            from .engine import InferenceEngine
            engine = InferenceEngine(path, place=place, buckets=buckets,
                                     exec_cache=False)
            with _at.capture() as keys:
                engine.warmup(sample_feed)
        store = _at.TuneStore(os.path.join(path, _at.TUNE_DIRNAME))
        existing = store.load()
        missing = keys if existing is None else \
            [c for c in keys
             if (c[0], _at.key_str(c[1])) not in existing.entries]
        table = existing
        if missing or existing is None:
            tuner = _at.Tuner(**(tune_opts or {}))
            table = tuner.tune(missing, table=existing)
        store.save(table)
        touched = set(store.touched())
        tune_dir = os.path.join(path, _at.TUNE_DIRNAME)
        tune_files = {}
        for name in sorted(os.listdir(tune_dir)):
            fpath = os.path.join(tune_dir, name)
            if not os.path.isfile(fpath) or name.endswith(".tmp"):
                continue
            if name in touched:
                tune_files[f"{_at.TUNE_DIRNAME}/{name}"] = \
                    _sha256_file(fpath)
            elif name.endswith(_at.ARTIFACT_SUFFIX):
                # a table another toolchain/backend measured: its
                # filename fingerprint can never match here — prune
                try:
                    os.unlink(fpath)
                except OSError:
                    pass
        return tune_files

    def _plan(self, path, m, place=None):
        """Run the publish-time placement search: load the bundle into a
        throwaway scope on ``place`` (the card unless the caller asks for
        the CPU), synthesize a template feed at one row per device (so
        every data-parallel degree divides), and let
        ``parallel.planner.plan`` search + persist into ``<version>/
        plan/``. A fingerprint-matching existing artifact is a cache hit
        (re-warming is idempotent: same bytes, same digest). The search
        failing — a bundle whose free dims ``template_feed`` cannot
        synthesize, a program the lowering rejects — records a flight
        event and certifies nothing: plans are an additive sidecar.
        Returns the ``plan_files`` digest map."""
        from ..core.executor import Executor
        from ..core.scope import Scope
        from ..fluid import io as fluid_io
        from ..obs import perf as _perf
        from ..parallel import planner as _pl
        plan_dir = os.path.join(path, _pl.PLAN_DIRNAME)
        store = _pl.PlanStore(plan_dir)
        try:
            scope = Scope()
            exe = Executor(place)
            program, feed_names, fetch_vars = \
                fluid_io.load_inference_model(path, exe, scope=scope)
            feed = _perf.template_feed(
                program, feed_names,
                batch=_pl._device_count(exe.device))
            _pl.plan(program, feed_example=feed, fetch_list=fetch_vars,
                     executor=exe, scope=scope, store=store)
        except Exception as e:
            from ..obs.recorder import record
            record("plan_publish_failed", component="serving.registry",
                   model=m.get("model"), version=m.get("version"),
                   error=f"{type(e).__name__}: {e}")
        plan_files = {}
        touched = set(store.touched())
        for name in sorted(os.listdir(plan_dir)):
            fpath = os.path.join(plan_dir, name)
            if not os.path.isfile(fpath) or name.endswith(".tmp"):
                continue
            if name in touched:
                plan_files[f"{_pl.PLAN_DIRNAME}/{name}"] = \
                    _sha256_file(fpath)
            elif name.endswith(_pl.ARTIFACT_SUFFIX):
                # a plan another toolchain/device-count searched: its
                # filename fingerprint can never match here — prune
                try:
                    os.unlink(fpath)
                except OSError:
                    pass
        return plan_files

    def _precompute_kv(self, engine, path, kv_prompts):
        """Prefill each prompt on the warm engine (chains that already
        have artifacts restore with zero prefill steps), force-spill
        every registered block, then certify exactly the artifacts this
        run touched — stale ``.jkv`` files (earlier prompt sets, older
        toolchains: their filenames embed the fingerprint key, so a
        geometry/toolchain flip strands them forever) are pruned."""
        from .generate import kvstore as _kvs
        for p in kv_prompts:
            toks = [int(t) for t in p]
            handle, _, finished = engine.start(toks, 1, {"mode": "greedy"})
            # chunked admission parks the prompt on the prefill queue;
            # step until the chain is prefilled + registered
            for _ in range(len(toks) + 16):
                if handle.finished or not handle.prefilling:
                    break
                engine.step()
            if not handle.finished:
                engine.abort(handle)
        engine.cache.spill_registered()
        store = engine.cache.spill_store
        touched = set(store.touched()) if store is not None else set()
        kv_dir = os.path.join(path, _kvs.KV_DIRNAME)
        kv_files = {}
        if os.path.isdir(kv_dir):
            for name in sorted(os.listdir(kv_dir)):
                fpath = os.path.join(kv_dir, name)
                if not os.path.isfile(fpath) or name.endswith(".tmp"):
                    continue
                if name in touched:
                    kv_files[f"{_kvs.KV_DIRNAME}/{name}"] = \
                        _sha256_file(fpath)
                elif name.endswith(_kvs.ARTIFACT_SUFFIX):
                    try:
                        os.unlink(fpath)
                    except OSError:
                        pass
        return kv_files

    # ------------------------------------------------------------------
    def resolve(self, model, version="latest"):
        """-> ``(bundle_path, version_int)``. ``"latest"`` (or None) picks
        the newest published version. Unknown models/versions raise a
        ValueError naming what IS available."""
        published = self.versions(model)
        if not published:
            raise ValueError(
                f"model {model!r} has no published versions in registry "
                f"{self.root!r} (known models: {self.models()})")
        if version in (None, "latest"):
            v = published[-1]
        else:
            v = int(version)
            if v not in published:
                raise ValueError(
                    f"model {model!r} has no published version {v}; "
                    f"published: {published}")
        return self.version_dir(model, v), v

    def model_kind(self, model, version="latest"):
        """The resolved version's engine-class declaration; manifests
        published before the field existed default to "feedforward"."""
        return self.manifest(model, version).get("model_kind",
                                                 "feedforward")

    def previous(self, model, version):
        """The newest published version strictly older than ``version``
        (what a failed canary rolls back to), or None."""
        older = [v for v in self.versions(model) if v < int(version)]
        return older[-1] if older else None

    def manifest(self, model, version):
        path, v = self.resolve(model, version)
        mpath = os.path.join(path, VERSION_MANIFEST)
        try:
            with open(mpath) as f:
                return json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(
                f"registry version {model!r}/{v} holds a corrupt "
                f"{VERSION_MANIFEST!r} ({type(e).__name__}: {e}); "
                "republish the version") from e

    def gc(self, model, keep_latest=2, pinned=(), torn_ttl_s=3600.0):
        """Retention: delete old published version dirs, keeping the
        newest ``keep_latest`` versions and NEVER deleting

        * the latest published version (what ``resolve("latest")`` and a
          crash-restarting replica load),
        * its :meth:`previous` (the rollback target a failed canary
          needs), or
        * any version in ``pinned`` (the caller's currently-served /
          must-keep set — the registry cannot know what a fleet is
          serving, so the rollout controller passes it).

        Deletion is manifest-first: the VERSION.json is unlinked before
        the dir is removed, so a crash mid-gc leaves a TORN (invisible)
        version, never a corrupt resolvable one. Returns the sorted list
        of deleted version numbers. Typed ValueErrors on bad args;
        pinned versions that no longer exist are ignored (gc must be
        idempotent across restarts).

        Torn (manifest-less) dirs — abandoned by a publisher that
        crashed mid-copy — are swept too once older than ``torn_ttl_s``
        seconds (dir mtime): they hold full-size bundle copies no other
        API can reach, and without the sweep repeated publisher crashes
        grow the registry without bound. The TTL protects an IN-FLIGHT
        publish (a fresh manifest-less dir is a publish in progress,
        not garbage); 0 sweeps every torn dir immediately — only safe
        when no publisher can be running concurrently."""
        try:
            keep_latest = int(keep_latest)
        except (TypeError, ValueError):
            raise ValueError(
                f"keep_latest must be a positive int, "
                f"got {keep_latest!r}") from None
        if keep_latest < 1:
            raise ValueError(
                f"keep_latest must be >= 1 (the latest version is never "
                f"deleted), got {keep_latest}")
        try:
            pinned = {int(v) for v in pinned}
        except (TypeError, ValueError):
            raise ValueError(
                f"pinned must be an iterable of version ints, "
                f"got {pinned!r}") from None
        try:
            torn_ttl_s = float(torn_ttl_s)
        except (TypeError, ValueError):
            raise ValueError(
                f"torn_ttl_s must be a non-negative number of seconds, "
                f"got {torn_ttl_s!r}") from None
        if torn_ttl_s < 0:
            raise ValueError(
                f"torn_ttl_s must be >= 0, got {torn_ttl_s}")
        published = self.versions(model)
        deleted = self._sweep_torn(model, set(published), torn_ttl_s)
        if not published:
            return sorted(deleted)
        latest = published[-1]
        protected = set(published[-keep_latest:]) | {latest} | pinned
        prev = self.previous(model, latest)
        if prev is not None:
            protected.add(prev)
        for v in published:
            if v in protected:
                continue
            vdir = self.version_dir(model, v)
            try:
                os.unlink(os.path.join(vdir, VERSION_MANIFEST))
            except FileNotFoundError:
                pass      # already torn: finish removing the remains
            shutil.rmtree(vdir, ignore_errors=True)
            deleted.append(v)
        return sorted(deleted)

    def _sweep_torn(self, model, published, ttl_s):
        """Delete manifest-less version dirs older than ``ttl_s`` —
        abandoned publishes only; a fresh torn dir is an in-flight
        publish and must survive. Returns the swept version numbers."""
        cutoff = time.time() - ttl_s
        swept = []
        for v in self._all_version_dirs(model):
            if v in published:
                continue
            vdir = self.version_dir(model, v)
            try:
                if os.path.getmtime(vdir) > cutoff:
                    continue
            except OSError:
                continue       # raced a concurrent delete
            shutil.rmtree(vdir, ignore_errors=True)
            swept.append(v)
        return swept

    def verify(self, model, version):
        """Re-hash the stored files against the manifest; raises ValueError
        on a torn (file missing) or corrupt (digest mismatch) version.
        Returns the manifest. Note the deeper check — whether the bundle
        actually LOADS — is ``load_inference_model``'s typed ValueError,
        raised by the engine when a resolved version is served."""
        path, v = self.resolve(model, version)
        m = self.manifest(model, v)
        # warm_files are covered by the same re-hash: a tampered
        # compiled-executable artifact fails verify() exactly like a
        # tampered bundle file. The serving engine independently pins
        # loads to these SAME manifest digests (execcache checks the
        # raw bytes against warm_files BEFORE unpickling anything) —
        # verify is the operator's offline check, the engine's
        # manifest-pinned reject is the runtime safety net.
        listed = dict(m.get("files", {}))
        listed.update(m.get("warm_files", {}))
        # kv_files (publish-time KV-prefix artifacts, kv/) re-hash the
        # same way: verify is the offline check, the engine's
        # manifest-pinned load reject is the runtime one
        listed.update(m.get("kv_files", {}))
        # tune_files (publish-time kernel-tuning tables, tune/) too:
        # ops.autotune.TuneStore pins loads to these digests at runtime
        listed.update(m.get("tune_files", {}))
        # plan_files (publish-time placement plans, plan/) the same:
        # parallel.planner.PlanStore pins loads to these digests
        listed.update(m.get("plan_files", {}))
        for name, want in listed.items():
            fpath = os.path.join(path, name)
            if not os.path.exists(fpath):
                raise ValueError(
                    f"registry version {model!r}/{v} is torn: manifest "
                    f"lists {name!r} but {fpath!r} is missing")
            got = _sha256_file(fpath)
            if got != want:
                raise ValueError(
                    f"registry version {model!r}/{v} is corrupt: "
                    f"{name!r} hashes {got[:12]}… but the manifest "
                    f"records {want[:12]}…")
        if _content_hash(m.get("files", {})) != m.get("content_hash"):
            raise ValueError(
                f"registry version {model!r}/{v} is corrupt: content "
                "hash does not match the manifest's file digests")
        return m


__all__ = ["ModelRegistry", "VERSION_MANIFEST"]
