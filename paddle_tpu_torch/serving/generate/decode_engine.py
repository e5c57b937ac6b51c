"""GenerationEngine: stateful autoregressive decode over a saved program
(counterpart of paddle_tpu/serving/generate/decode_engine.py).

A generative saved program is a decoder-only LM over a token window —
feeds ``tokens`` (``[batch, seq, 1]`` int64, plus optional ``positions``),
one logits fetch ``[batch, seq, vocab]`` — whose attention sites are
``causal_self_attention`` ops. The engine splits that one program into
its serving phases, each a clone with every attention site rewritten:

* **prefill** — ``prefill_attention``: causal attention over the
  bucket-padded prompt window that also scatters each position's K/V into
  the paged arena (kvcache.py).
* **chunked prefill** — ``chunked_prefill_attention``: a prompt chunk
  attending over arena context that is already there (a cached shared
  prefix, previous chunks). Built only when the prefix cache
  (``serving_prefix_cache_blocks``) or chunking (``serving_prefill_chunk``)
  is on. A request whose prompt prefix is cached attaches to the cached
  blocks and prefills only its tail; a long cold prompt under chunking
  admits at once and prefills one bounded chunk per :meth:`step`, so
  in-flight decode streams keep producing tokens while it loads.
* **decode** — ``paged_attention``: a fixed-shape ``[max_seqs, 1]`` step
  over the arena, whose attend is the hand-written paged-attention kernel
  on the card (ops/cuda/paged_attention.py), once per layer. Ragged
  in-flight sequences share it through their block tables and context
  lengths; idle slots ride along masked (sentinel slot, length 0).

PyTorch runs the phase programs eagerly, so nothing compiles: the
reference's per-(phase, bucket) compile and trace-cache-hit counters
(``paddle_tpu_genengine_compiles`` / ``_hits`` on obs.metrics) count a
(phase, bucket)'s first dispatch and its later ones here, and
:meth:`warmup` runs each (phase, bucket) once with inert feeds (every
kernel built and launched before the first request). The phase ops
update the arena in place; with ``donate_arena=False`` the engine feeds
clones of the arena instead and keeps the updated clones, which gives the
same token streams.

Sampling is host-side and per sequence — greedy argmax, top-k (own
``numpy.RandomState`` seeded per request), or beam search riding the
dense ``beam_search`` op (ops/control_flow_ops.py) with copy-on-write
block-table forks for hypothesis reordering. Because the phase ops are
row-independent and sampling state is per sequence, a sequence's token
stream is the same whether it decodes alone or joins a running batch.

The KV spill tier (``kvstore.py``): a bundle's published ``kv/`` dir
(read-only, manifest-pinned) or the ``serving_kv_spill_dir`` flag's local
tier is attached to the arena, so evicted prefix blocks demote to it and a
later attach restores them with zero prefill dispatches. Warmup loads
the bundle's tuning table (``ops.autotune.load_for_bundle``) first and
every dispatch routes by it (``ops.autotune.routing``), and
each (phase, bucket)'s first dispatch lands in obs.perf's compile log
(``genengine_warmup`` / ``genengine_<phase>``).

The warm-executable cache (``exec_cache=``, or the ``serving_exec_cache*``
flags, or a registry version's ``warm/`` dir; serving/execcache.py): at
warmup each (phase, bucket) loads its ``torch.export`` program, or (a
writable cache) exports and persists it, keyed ``gen_<phase>_b<bucket>``.
The phase programs export whole: the arena write and the decode attend are
``torch.library`` operators (ops/attention_ops.py), and the exported
program writes the fed arena back, so a warm dispatch updates the arena as
the op loop does and the decode attend still launches the paged-attention
kernel. A loaded (phase, bucket)'s first dispatch counts as a hit, so a
warm engine's :meth:`warmup` reports 0; an executable that loads but fails
to run is a ``run_failed`` reject, counts as a hot recompile and reruns on
the op loop (the same kernels). Telemetry lives on the obs.metrics
registry, as the reference's does: the compile/hit counters, the
hot-recompile alarm and the per-request TTFT/TPOT histograms.
"""

from __future__ import annotations

import bisect
import threading
import time

import numpy as np
import torch

from ...core.executor import Executor
from ...core.scope import Scope
from ...core.flags import get_flag
from ...fluid import io as fluid_io
from ...fluid.framework import Operator, Program
from ...obs import perf as _perf
from ...obs.metrics import REGISTRY as _METRICS, next_instance
from ...ops import autotune as _autotune
from ...ops import cuda as kernel_tier
from ...ops.cuda import paged_attention as _pa
from ..engine import parse_buckets
from .. import execcache as _execcache
from . import kvstore as _kvstore
from .kvcache import CacheExhausted, PagedKVCache

_M_COMPILES = _METRICS.counter(
    "paddle_tpu_genengine_compiles",
    "GenerationEngine first dispatches of a (phase, bucket): where the "
    "reference compiles an executable, per instance/phase/bucket",
    labels=("instance", "phase", "bucket"))
_M_HITS = _METRICS.counter(
    "paddle_tpu_genengine_hits",
    "GenerationEngine later dispatches of a (phase, bucket): the "
    "reference's trace-cache hits, per instance/phase/bucket",
    labels=("instance", "phase", "bucket"))
_M_HOT = _METRICS.counter(
    "paddle_tpu_genengine_hot_recompiles",
    "generation compiles observed AFTER warmup (the no-recompile alarm)",
    labels=("instance",))
# per-request serving quantities: TTFT (submit -> first actual token,
# stamped by the scheduler, which owns the submit clock; a request aborted
# before its first token discards its probe) and TPOT (mean time per
# output token after the first, recorded once at stream end for requests
# that emitted >= 2 tokens)
_M_TTFT = _METRICS.histogram(
    "paddle_tpu_genengine_ttft_seconds",
    "time to first token per generation request (submit -> first actual "
    "token), per engine instance", labels=("instance",),
    span_name="serving/ttft", span_kind="stage")
_M_TPOT = _METRICS.histogram(
    "paddle_tpu_genengine_tpot_seconds",
    "mean time per output token after the first, recorded once per "
    "finished stream that emitted >= 2 tokens, per engine instance",
    labels=("instance",), span_name="serving/tpot", span_kind="stage")

ATTENTION_OP = "causal_self_attention"
_SLOTS = "__kv_slots__"
_TABLES = "__kv_block_tables__"
_CTXLENS = "__kv_context_lens__"
_CHUNKSTART = "__kv_chunk_start__"


class NoFreeSlots(RuntimeError):
    """All ``max_seqs`` decode slots are occupied: the admission-control
    twin of :class:`CacheExhausted` for the slot dimension. The scheduler
    keeps the request queued until a sequence finishes."""


def _kv_name(kind, layer):
    return f"__kv_{kind}_{layer}__"


def normalize_sampling(sampling):
    """Validate/default a sampling spec (a plain dict): ``mode`` greedy |
    topk | beam, with ``top_k``/``temperature``/``seed`` for topk and
    ``beam_size`` for beam; ``eos_id`` (None = run to max_new_tokens)
    applies to all modes."""
    s = dict(sampling or {})
    mode = s.pop("mode", "greedy")
    out = {"mode": mode,
           "eos_id": s.pop("eos_id", None),
           "top_k": int(s.pop("top_k", 8)),
           "temperature": float(s.pop("temperature", 1.0)),
           "seed": int(s.pop("seed", 0)),
           "beam_size": int(s.pop("beam_size", 4))}
    if s:
        raise ValueError(f"unknown sampling fields {sorted(s)}")
    if mode not in ("greedy", "topk", "beam"):
        raise ValueError(f"sampling mode must be greedy|topk|beam, "
                         f"got {mode!r}")
    if mode == "topk" and out["top_k"] <= 0:
        raise ValueError("top_k must be positive")
    if mode == "topk" and out["temperature"] <= 0:
        raise ValueError("temperature must be positive")
    if mode == "beam" and out["beam_size"] < 2:
        raise ValueError("beam_size must be >= 2")
    if out["eos_id"] is not None:
        out["eos_id"] = int(out["eos_id"])
    return out


def _log_softmax(x):
    x = x - x.max()
    return x - np.log(np.exp(x).sum())


class _Sequence:
    """One decode slot's state (a beam hypothesis is one of these too)."""

    __slots__ = ("seq_id", "slot", "next_token", "emitted", "max_new",
                 "params", "rng", "group", "finished", "user_data",
                 "prompt", "pending", "prefilling")

    def __init__(self, seq_id, slot, params, max_new):
        self.seq_id = seq_id
        self.slot = slot
        self.params = params
        self.max_new = max_new
        self.next_token = 0
        self.emitted = 0
        self.rng = np.random.RandomState(params["seed"] & 0x7FFFFFFF)
        self.group = None          # set for beam hypotheses
        self.finished = False
        self.user_data = None      # scheduler's stream handle
        self.prompt = None         # full prompt (prefix registration)
        self.pending = None        # prompt tail still to chunk-prefill
        self.prefilling = False    # occupies a slot but must not decode


class _BeamGroup:
    """A beam request: ``beam_size`` sequences advancing in lockstep."""

    __slots__ = ("seqs", "pre_ids", "pre_scores", "hist_ids",
                 "hist_parents", "steps", "max_new", "end_id", "finished",
                 "user_data", "prompt", "pending", "prefilling")

    def __init__(self, seqs, max_new, end_id):
        self.seqs = seqs
        self.max_new = max_new
        # -1 never matches a real token: "no EOS" runs to max_new
        self.end_id = -1 if end_id is None else int(end_id)
        self.pre_ids = None
        self.pre_scores = None
        self.hist_ids = []
        self.hist_parents = []
        self.steps = 0
        self.finished = False
        self.user_data = None
        self.prompt = None
        self.pending = None        # lead hypothesis's unprefilled tail
        self.prefilling = False


class GenerationEngine:
    """``GenerationEngine(model_dir)`` loads a generative bundle into a
    private scope on the card (``place=CPUPlace()`` for the CPU) and splits
    it; ``max_seqs``/``block_size``/``num_blocks`` default from the
    ``serving_max_seqs`` / ``serving_kv_block_size`` /
    ``serving_kv_num_blocks`` flags; ``max_len`` bounds prompt + generation
    per sequence (it sizes the block-table width); ``prefill_buckets`` are
    the prompt-length pads (default: powers of two from 8 up to
    ``max_len``).

    Thread safety: dispatches serialize on a lock; the ContinuousBatcher
    drives the engine from one worker thread. Every tensor lives on the
    executor's explicit device, never the thread's current one."""

    def __init__(self, model_dir=None, program=None, feed_names=None,
                 fetch_vars=None, executor=None, scope=None, place=None,
                 max_seqs=None, block_size=None, num_blocks=None,
                 max_len=128, prefill_buckets=None, prefix_cache_blocks=None,
                 prefill_chunk=None, donate_arena=True, exec_cache=None,
                 kv_store=None):
        self._scope = scope or Scope()
        self._exe = executor or Executor(place)
        if model_dir is not None:
            program, feed_names, fetch_vars = \
                fluid_io.load_inference_model(model_dir, self._exe,
                                              scope=self._scope)
        if program is None or feed_names is None or fetch_vars is None:
            raise ValueError(
                "GenerationEngine needs model_dir= or all of program=/"
                "feed_names=/fetch_vars=")
        self._feed_names = list(feed_names)
        unknown = [n for n in self._feed_names
                   if n not in ("tokens", "positions")]
        if "tokens" not in self._feed_names or unknown:
            raise ValueError(
                "a generative bundle feeds 'tokens' (and optionally "
                f"'positions'); this one feeds {self._feed_names}")
        fetch_names = [v if isinstance(v, str) else v.name
                       for v in fetch_vars]
        if len(fetch_names) != 1:
            raise ValueError(
                f"a generative bundle fetches exactly its logits, "
                f"got {fetch_names}")
        self._logits_name = fetch_names[0]

        self.max_seqs = int(max_seqs if max_seqs is not None
                            else get_flag("serving_max_seqs"))
        self.max_len = int(max_len)
        if self.max_seqs <= 0 or self.max_len <= 0:
            raise ValueError("max_seqs and max_len must be positive")

        layers, heads, head_dim = self._attention_config(program)
        self.num_layers = layers
        self.cache = PagedKVCache(layers, heads, head_dim,
                                  num_blocks=num_blocks,
                                  block_size=block_size,
                                  prefix_cache_blocks=prefix_cache_blocks,
                                  device=self._exe.device)
        # the persistent KV-prefix spill tier, keyed by the bundle's
        # content hash and the arena geometry: no bundle bytes, no tier
        self._model_dir = str(model_dir) if model_dir is not None else None
        self._tune_table = None        # the bundle's, loaded by warmup
        self._bundle_hash = _execcache.bundle_content_hash(model_dir) \
            if model_dir is not None else None
        # the warm-executable cache: each (phase, bucket) loads its
        # exported program at warmup instead of running its first
        # dispatch through the op loop. The engine's geometry (max_seqs,
        # max_len, the arena, chunking) needs no key of its own: the
        # warmup feeds' shapes, which the fingerprint holds, fix it
        self._exec_cache = _execcache.resolve_cache(model_dir, exec_cache) \
            if self._bundle_hash is not None else None
        self._warm_execs = {}          # (phase, bucket) -> WarmExecutable
        self._warm_loaded = set()      # keys whose executable was LOADED
        self._seen = set()             # (phase, bucket) dispatched so far
        self._kv_store = None
        if model_dir is not None and kv_store is not False:
            kv_fp = _kvstore.kv_fingerprint(
                self._bundle_hash, layers, heads,
                head_dim, self.cache.block_size, self.cache.k[0].dtype,
                self._exe.device)
            self._kv_store = _kvstore.resolve_store(model_dir, kv_store,
                                                    kv_fp)
        self.cache.attach_spill(self._kv_store)
        self.donate_arena = bool(donate_arena)
        self.prefill_chunk = int(prefill_chunk if prefill_chunk is not None
                                 else get_flag("serving_prefill_chunk"))
        self._table_width = self.cache.blocks_for(self.max_len)
        self._prefill_program = self._rewrite(program, "prefill_attention")
        self._decode_program = self._rewrite(program, "paged_attention")
        # the chunked-prefill phase exists only when a partial prefill can
        # happen (cached-prefix tails, chunked admission)
        self._partial_enabled = (self.cache.prefix_cache_blocks > 0
                                 or self.prefill_chunk > 0)
        self._chunk_program = (
            self._rewrite(program, "chunked_prefill_attention")
            if self._partial_enabled else None)
        if prefill_buckets is None:
            b, buckets = 8, []
            while b < self.max_len:
                buckets.append(b)
                b *= 2
            buckets.append(b)
            prefill_buckets = buckets
        self.prefill_buckets = parse_buckets(prefill_buckets)

        self._slots = [None] * self.max_seqs
        self._groups = []
        self._prefill_queue = []   # FIFO of handles mid-chunked-prefill
        self._next_seq_id = 0
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._beam_programs = {}
        self._warmed = False
        # per-(phase, bucket) (compiles, hits) children on obs.metrics
        # under this engine's instance label; stats() derives its phases
        # dict from them
        self.obs_instance = next_instance("genengine")
        self._phase = {"prefill": {}, "chunk": {}, "decode": {}}
        self._m_hot = _M_HOT.labels(instance=self.obs_instance)
        # per-request TTFT/TPOT histograms: the scheduler (which owns the
        # submit clock) records into these; stats() snapshots them
        self.ttft = _M_TTFT.labels(instance=self.obs_instance)
        self.tpot = _M_TPOT.labels(instance=self.obs_instance)

    @property
    def device(self):
        return self._exe.device

    # ------------------------------------------------------------------
    # program split
    # ------------------------------------------------------------------
    def _attention_config(self, program):
        block = program.global_block()
        sites = [op for op in block.ops if op.type == ATTENTION_OP]
        if not sites:
            raise ValueError(
                "program has no causal_self_attention sites: not a "
                "generative bundle (use InferenceEngine for feed-forward "
                "models)")
        configs = set()
        for op in sites:
            heads = int(op.attr("num_heads"))
            hidden = int(block.var(op.input("K")[0]).shape[-1])
            configs.add((heads, hidden // heads))
        if len(configs) != 1:
            raise ValueError(
                f"attention sites disagree on (heads, head_dim): "
                f"{sorted(configs)}")
        heads, head_dim = configs.pop()
        return len(sites), heads, head_dim

    def _rewrite(self, program, phase_op):
        """Clone the program and rewrite every attention site into the
        phase op, wiring the per-layer arena vars in and out under the
        SAME names (the phase ops update them in place). Arena and slot
        vars are declared in the clone (typed, ``is_data``: they are fed
        every dispatch)."""
        p = program.clone(for_test=True)
        block = p.global_block()

        def _declare(name, dtype):
            if not block.has_var(name):
                block.create_var(name=name, dtype=dtype, is_data=True)

        _declare(_SLOTS, "int32")
        if phase_op == "paged_attention":
            _declare(_TABLES, "int32")
            _declare(_CTXLENS, "int32")
        elif phase_op == "chunked_prefill_attention":
            _declare(_TABLES, "int32")
            _declare(_CHUNKSTART, "int32")
        layer = 0
        for i, op in enumerate(block.ops):
            if op.type != ATTENTION_OP:
                continue
            inputs = dict(op.inputs)
            outputs = dict(op.outputs)
            for kind in ("k", "v"):
                _declare(_kv_name(kind, layer), "float32")
            inputs["KCache"] = [_kv_name("k", layer)]
            inputs["VCache"] = [_kv_name("v", layer)]
            inputs["SlotMapping"] = [_SLOTS]
            outputs["KCacheOut"] = [_kv_name("k", layer)]
            outputs["VCacheOut"] = [_kv_name("v", layer)]
            if phase_op == "paged_attention":
                inputs["BlockTables"] = [_TABLES]
                inputs["ContextLens"] = [_CTXLENS]
            elif phase_op == "chunked_prefill_attention":
                inputs["BlockTables"] = [_TABLES]
                inputs["ChunkStart"] = [_CHUNKSTART]
            block.ops[i] = Operator(block, phase_op, inputs, outputs,
                                    dict(op.attrs))
            layer += 1
        # verify_passes: the per-phase rewrite is a transform pass like any
        # other; a mis-wired arena var fails here naming the phase
        from ...fluid.analysis import verify_pass_output
        verify_pass_output(
            p, f"GenerationEngine._rewrite({phase_op})",
            feed_names=list(self._feed_names))
        return p

    # ------------------------------------------------------------------
    # dispatch plumbing
    # ------------------------------------------------------------------
    def _arena_feed(self):
        """The arena tensors as feeds: themselves (updated in place), or
        clones of them when ``donate_arena`` is off."""
        feed = {}
        for l in range(self.num_layers):
            for kind, arena in (("k", self.cache.k), ("v", self.cache.v)):
                t = arena[l]
                feed[_kv_name(kind, l)] = t if self.donate_arena \
                    else t.clone()
        return feed

    def _gen_fetch(self):
        return [self._logits_name] + [_kv_name(k, l)
                                      for l in range(self.num_layers)
                                      for k in ("k", "v")]

    def _warm_phase(self, program, feed, phase, bucket):
        """Register one (phase, bucket)'s warm executable: load the
        artifact whose fingerprint matches this exact dispatch, or
        (writable caches) export and persist it. Every failure is silent:
        the (phase, bucket) runs the op loop."""
        key = (phase, bucket)
        if self._exec_cache is None or key in self._warm_execs:
            return
        with _autotune.routing(self._tune_table):
            entry = _execcache.acquire(
                self._exec_cache, self._bundle_hash, f"gen_{phase}_b{bucket}",
                program, feed, self._gen_fetch(), self._exe, self._scope,
                identity={"instance": self.obs_instance, "phase": phase,
                          "bucket": bucket})
        if entry is not None:
            self._warm_execs[key] = entry
            if entry.source == "cache":
                self._warm_loaded.add(key)

    def _dispatch(self, program, feed, phase, bucket):
        key = (phase, bucket)
        warm = self._warm_execs.get(key)
        # accounting before the dispatch (mark-then-dispatch): a first
        # dispatch through a LOADED executable runs no op loop and counts
        # as a hit, so a warm warmup() reports 0
        first = False
        with self._stats_lock:
            per = self._phase[phase].get(bucket)
            if per is None:
                per = self._phase[phase][bucket] = (
                    _M_COMPILES.labels(instance=self.obs_instance,
                                       phase=phase, bucket=str(bucket)),
                    _M_HITS.labels(instance=self.obs_instance,
                                   phase=phase, bucket=str(bucket)))
            if key in self._seen:
                per[1].inc()
            else:
                self._seen.add(key)
                if warm is not None and key in self._warm_loaded:
                    per[1].inc()
                else:
                    first = True
                    per[0].inc()
                    if self._warmed:
                        # a (phase, bucket) first dispatched after warmup:
                        # where the reference counts a hot recompile
                        self._m_hot.inc()
        outs = None
        if warm is not None:
            # the exported program dispatched directly: the same op loop
            # traced, so its outputs are the op loop's bitwise; one that
            # loaded but will not run rejects and the op loop runs it
            try:
                outs = warm.run(self._exe, program, feed, self._scope,
                                return_numpy=False)
            except Exception as e:
                self._warm_execs.pop(key, None)
                loaded = key in self._warm_loaded
                self._warm_loaded.discard(key)
                self._exec_cache.note_reject(f"gen_{phase}_b{bucket}",
                                             "run_failed", error=e)
                if loaded:
                    with self._stats_lock:
                        # the op loop below is the real first dispatch
                        # that the accounting booked as a hit
                        first = True
                        per[0].inc()
                        if self._warmed:
                            self._m_hot.inc()
        if outs is None:
            t0 = time.perf_counter()
            with _autotune.routing(self._tune_table):
                outs = self._exe.run(program, feed=feed,
                                     fetch_list=self._gen_fetch(),
                                     scope=self._scope, return_numpy=False)
            if first:
                detail = dict(instance=self.obs_instance, phase=phase,
                              bucket=bucket)
                if self._exec_cache is not None:
                    detail["cache_hit"] = False
                _perf.note_compile(
                    f"genengine_{phase}" if self._warmed
                    else "genengine_warmup",
                    time.perf_counter() - t0, identity=detail)
        for l in range(self.num_layers):
            self.cache.k[l] = outs[1 + 2 * l]
            self.cache.v[l] = outs[2 + 2 * l]
        return outs[0].float().cpu().numpy()

    def _prefill_bucket(self, n):
        i = bisect.bisect_left(self.prefill_buckets, n)
        if i == len(self.prefill_buckets):
            raise ValueError(
                f"prompt of {n} tokens exceeds the largest prefill "
                f"bucket {self.prefill_buckets[-1]}")
        return self.prefill_buckets[i]

    def _window_feed(self, seq, window, start):
        """Feed of a (chunked) prefill dispatch: ``window`` tokens whose
        first sits at absolute position ``start``, bucket-padded; padding
        maps to the sentinel slot."""
        bucket = self._prefill_bucket(len(window))
        toks = np.zeros((1, bucket, 1), np.int64)
        toks[0, :len(window), 0] = window
        slots = np.full((1, bucket), self.cache.sentinel_slot, np.int32)
        if seq is not None:
            slots[0, :len(window)] = self.cache.append_slots(
                seq.seq_id, len(window))
        feed = self._arena_feed()
        feed["tokens"] = toks
        feed[_SLOTS] = slots
        if "positions" in self._feed_names:
            feed["positions"] = (start + np.arange(bucket, dtype=np.int64)) \
                .reshape(1, bucket, 1)
        return feed, bucket

    def _run_prefill(self, seq, prompt):
        feed, bucket = self._window_feed(seq, prompt, 0)
        logits = self._dispatch(self._prefill_program, feed, "prefill",
                                bucket)
        return logits[0, len(prompt) - 1]          # [vocab]

    def _chunk_limit(self):
        # tails longer than this defer to the chunked pump; with chunking
        # off nothing defers (a tail never exceeds max_len)
        return self.prefill_chunk if self.prefill_chunk > 0 else self.max_len

    def _run_chunk(self, seq, chunk, start):
        """One partial-prefill dispatch: ``chunk`` prompt tokens whose
        context starts at absolute position ``start`` (everything before
        them is already in the arena). Returns the chunk's last real
        position's logits."""
        feed, bucket = self._window_feed(seq, chunk, start)
        feed[_TABLES] = self.cache.block_table(
            seq.seq_id, self._table_width).reshape(1, -1)
        feed[_CHUNKSTART] = np.asarray([start], np.int32)
        logits = self._dispatch(self._chunk_program, feed, "chunk", bucket)
        return logits[0, len(chunk) - 1]           # [vocab]

    def _run_tail(self, seq, prompt, cached):
        """Single-dispatch prefill of the uncached tail: a cold prompt
        takes the full-window prefill, a cached prefix prefills only the
        tail through the chunked phase."""
        if cached == 0:
            return self._run_prefill(seq, prompt)
        return self._run_chunk(seq, prompt[cached:], cached)

    def _decode_feed(self, active):
        S, P = self.max_seqs, self._table_width
        toks = np.zeros((S, 1, 1), np.int64)
        pos = np.zeros((S, 1, 1), np.int64)
        tables = np.zeros((S, P), np.int32)
        ctx = np.zeros(S, np.int32)
        slots = np.full(S, self.cache.sentinel_slot, np.int32)
        for s in active:
            j = s.slot
            toks[j, 0, 0] = s.next_token
            pos[j, 0, 0] = self.cache.context_len(s.seq_id)
            slots[j] = self.cache.append_slots(s.seq_id, 1)[0]
            tables[j] = self.cache.block_table(s.seq_id, P)
            ctx[j] = self.cache.context_len(s.seq_id)
        feed = self._arena_feed()
        feed["tokens"] = toks
        feed[_SLOTS] = slots
        feed[_TABLES] = tables
        feed[_CTXLENS] = ctx
        if "positions" in self._feed_names:
            feed["positions"] = pos
        return feed

    def _run_decode(self):
        active = [s for s in self._slots
                  if s is not None and not s.finished and not s.prefilling]
        logits = self._dispatch(self._decode_program,
                                self._decode_feed(active), "decode",
                                self.max_seqs)
        return logits[:, 0]                        # [max_seqs, vocab]

    # ------------------------------------------------------------------
    def warmup(self, sample_feed=None):
        """Run the decode phase and every prefill bucket (and its chunked
        twin, when partial prefill is on) once with inert feeds: sentinel
        slots write nothing, so every kernel is built and launched before
        the first request. With a warm-executable cache each (phase,
        bucket) first loads (or exports) its program. Returns the number
        of first dispatches that ran the op loop: one per (phase, bucket)
        on a fresh engine, 0 on one whose cache held every program."""
        del sample_feed                            # the engine derives its own
        with self._lock:
            before = self._compiles()
            # the bundle's published tuning table loads before the first
            # dispatch: every warm executable's fingerprint carries it
            self._tune_table = _autotune.load_for_bundle(self._model_dir)
            feed = self._decode_feed([])
            self._warm_phase(self._decode_program, feed, "decode",
                             self.max_seqs)
            self._dispatch(self._decode_program, feed, "decode",
                           self.max_seqs)
            for b in self.prefill_buckets:
                feed, _ = self._window_feed(None, [0] * b, 0)
                self._warm_phase(self._prefill_program, feed, "prefill", b)
                self._dispatch(self._prefill_program, feed, "prefill", b)
                if self._partial_enabled:
                    feed, _ = self._window_feed(None, [0] * b, 0)
                    feed[_TABLES] = np.zeros((1, self._table_width),
                                             np.int32)
                    feed[_CHUNKSTART] = np.zeros(1, np.int32)
                    self._warm_phase(self._chunk_program, feed, "chunk", b)
                    self._dispatch(self._chunk_program, feed, "chunk", b)
            self._warmed = True
            return self._compiles() - before

    def _compiles(self):
        with self._stats_lock:
            return int(sum(c.value for per in self._phase.values()
                           for c, _h in per.values()))

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _sample(self, seq, logits):
        p = seq.params
        if p["mode"] == "greedy":
            return int(np.argmax(logits))
        k = min(p["top_k"], logits.shape[0])
        # deterministic top-k: stable sort on (-logit, index)
        idx = np.lexsort((np.arange(logits.shape[0]), -logits))[:k]
        logp = _log_softmax(logits[idx].astype(np.float64)
                            / p["temperature"])
        probs = np.exp(logp)
        probs /= probs.sum()
        r = seq.rng.random_sample()
        return int(idx[np.searchsorted(np.cumsum(probs), r,
                                       side="right").clip(0, k - 1)])

    # ------------------------------------------------------------------
    # sequence lifecycle
    # ------------------------------------------------------------------
    @property
    def active_sequences(self):
        return sum(1 for s in self._slots if s is not None)

    def _free_slots(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def _new_seq(self, slot, params, max_new):
        seq = _Sequence(self._next_seq_id, slot, params, max_new)
        self._next_seq_id += 1
        return seq

    def start(self, prompt, max_new_tokens, sampling=None):
        """Admit + prefill one request. Returns ``(handle, first_tokens,
        finished)`` — the first token(s) stream immediately. Raises
        :class:`NoFreeSlots` / :class:`CacheExhausted` typed (and admits
        nothing) when the request cannot join the running batch, and
        ValueError for a request that can never be admitted."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("prompt must have at least one token")
        max_new = int(max_new_tokens)
        if max_new <= 0:
            raise ValueError("max_new_tokens must be positive")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the engine's max_len {self.max_len}")
        params = normalize_sampling(sampling)
        # never-satisfiable requests raise ValueError (a bad request the
        # scheduler fails), not a transient capacity error the strict-FIFO
        # scheduler would wait on forever
        beam = params["beam_size"] if params["mode"] == "beam" else 1
        if beam > self.max_seqs:
            raise ValueError(
                f"beam_size {beam} exceeds the engine's {self.max_seqs} "
                f"decode slots: this request can never be admitted")
        headroom = 1 if params["mode"] == "beam" else 0
        need = beam * (self.cache.blocks_for(len(prompt) + max_new)
                       + headroom)
        if need > self.cache.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks worst-case but the arena "
                f"only has {self.cache.num_blocks}: it can never be "
                f"admitted (raise serving_kv_num_blocks or lower "
                f"max_new_tokens)")
        with self._lock:
            if params["mode"] == "beam":
                return self._start_beam(prompt, max_new, params)
            free = self._free_slots()
            if not free:
                raise NoFreeSlots(
                    f"all {self.max_seqs} decode slots are busy")
            slot = free[0]
            seq = self._new_seq(slot, params, max_new)
            seq.prompt = prompt
            self.cache.admit(seq.seq_id, len(prompt) + max_new)
            cached = self.cache.attach_prefix(seq.seq_id, prompt) \
                if self.cache.prefix_cache_blocks > 0 else 0
            if len(prompt) - cached > self._chunk_limit():
                # long uncached tail under chunking: admit now, prefill one
                # bounded chunk per step boundary
                seq.pending = list(prompt[cached:])
                seq.prefilling = True
                self._slots[slot] = seq
                self._prefill_queue.append(seq)
                return seq, [], False
            try:
                logits = self._run_tail(seq, prompt, cached)
            except Exception:
                self.cache.release(seq.seq_id)
                raise
            self._slots[slot] = seq
            self.cache.register_prefix(seq.seq_id, prompt)
            tok = self._sample(seq, logits)
            toks, finished = self._advance(seq, tok)
            if finished:
                self._retire(seq)
            return seq, toks, finished

    def _advance(self, seq, tok):
        """Apply one sampled token to a greedy/topk sequence; returns
        (tokens_to_emit, finished). EOS is consumed, not emitted."""
        if seq.params["eos_id"] is not None and tok == seq.params["eos_id"]:
            seq.finished = True
            return [], True
        seq.emitted += 1
        seq.next_token = tok
        if seq.emitted >= seq.max_new:
            seq.finished = True
            return [tok], True
        return [tok], False

    def _start_beam(self, prompt, max_new, params):
        B = params["beam_size"]
        free = self._free_slots()
        if len(free) < B:
            raise NoFreeSlots(
                f"beam request needs {B} slots, {len(free)} free of "
                f"{self.max_seqs}")
        seqs = []
        try:
            for slot in free[:B]:
                seq = self._new_seq(slot, params, max_new)
                self.cache.admit(seq.seq_id, len(prompt) + max_new,
                                 cow_headroom=1)
                seqs.append(seq)
        except CacheExhausted:
            for s in seqs:
                self.cache.release(s.seq_id)
            raise
        group = _BeamGroup(seqs, max_new, params["eos_id"])
        group.prompt = prompt
        cached = self.cache.attach_prefix(seqs[0].seq_id, prompt) \
            if self.cache.prefix_cache_blocks > 0 else 0
        if len(prompt) - cached > self._chunk_limit():
            # chunked beam prefill: the lead hypothesis loads the prompt
            # chunk by chunk; siblings fork COW once it completes
            group.pending = list(prompt[cached:])
            group.prefilling = True
            for s in seqs:
                s.group = group
                s.prefilling = True
                self._slots[s.slot] = s
            self._prefill_queue.append(group)
            return group, [], False
        try:
            logits = self._run_tail(seqs[0], prompt, cached)
        except Exception:
            for s in seqs:
                self.cache.release(s.seq_id)
            raise
        return self._finish_beam_prefill(group, logits)

    def _finish_beam_prefill(self, group, logits):
        """Completion of a beam request's (possibly chunked) prefill:
        register the prefix, fork the sibling hypotheses COW off the lead,
        and seed the beam from the prompt logits. A beam stream emits only
        on completion."""
        seqs = group.seqs
        B = len(seqs)
        self.cache.register_prefix(seqs[0].seq_id, group.prompt)
        for s in seqs[1:]:
            self.cache.fork(seqs[0].seq_id, s.seq_id)
        logp = _log_softmax(logits.astype(np.float64)).astype(np.float32)
        order = np.lexsort((np.arange(logp.shape[0]), -logp))[:B]
        group.pre_ids = order.astype(np.int64)
        group.pre_scores = logp[order]
        group.hist_ids.append(group.pre_ids.copy())
        group.hist_parents.append(np.arange(B))
        group.steps = 1
        group.prefilling = False
        for s, t in zip(seqs, group.pre_ids):
            s.group = group
            s.prefilling = False
            s.next_token = int(t)
            self._slots[s.slot] = s
        self._groups.append(group)
        if group.steps >= group.max_new or bool(
                np.all(group.pre_ids == group.end_id)):
            toks = self._finish_beam(group)
            return group, toks, True
        return group, [], False

    # ------------------------------------------------------------------
    def step(self):
        """One continuous-batching step: advance the FIFO-head chunked
        prefill by one bounded chunk (if any is pending), then one
        fixed-shape decode dispatch over every active slot, then
        per-sequence sampling / one dense ``beam_search`` op per beam
        group. Returns a list of ``(handle, new_tokens, finished)``
        events. Finished sequences leave the batch at once."""
        with self._lock:
            events = []
            if self._prefill_queue:
                events.extend(self._pump_prefill_locked())
            if not any(s is not None and not s.finished
                       and not s.prefilling for s in self._slots):
                return events
            logits = self._run_decode()
            for s in list(self._slots):
                if s is None or s.group is not None or s.prefilling:
                    continue
                tok = self._sample(s, logits[s.slot])
                toks, finished = self._advance(s, tok)
                if finished:
                    self._retire(s)
                if toks or finished:
                    events.append((s, toks, finished))
            for g in list(self._groups):
                events.extend(self._beam_step(g, logits))
            return events

    def _pump_prefill_locked(self):
        """Advance the oldest pending chunked prefill by one chunk; on the
        last chunk the request's first sample happens and it joins the
        decode batch."""
        handle = self._prefill_queue[0]
        lead = handle.seqs[0] if isinstance(handle, _BeamGroup) else handle
        chunk = handle.pending[:self.prefill_chunk]
        del handle.pending[:len(chunk)]
        start = self.cache.context_len(lead.seq_id)
        logits = self._run_chunk(lead, chunk, start)
        if handle.pending:
            return []
        self._prefill_queue.pop(0)
        if isinstance(handle, _BeamGroup):
            return [self._finish_beam_prefill(handle, logits)]
        handle.prefilling = False
        self.cache.register_prefix(handle.seq_id, handle.prompt)
        tok = self._sample(handle, logits)
        toks, finished = self._advance(handle, tok)
        if finished:
            self._retire(handle)
        return [(handle, toks, finished)]

    def _beam_step(self, group, logits):
        B = len(group.seqs)
        logp = np.stack([
            _log_softmax(logits[s.slot].astype(np.float64))
            for s in group.seqs]).astype(np.float32)      # [B, vocab]
        k = min(B, logp.shape[1])
        cand_idx = np.argsort(-logp, axis=1, kind="stable")[:, :k]
        cand_scores = np.take_along_axis(logp, cand_idx, axis=1)
        sel_ids, sel_scores, parents = self._beam_search_op(
            group.pre_ids.reshape(1, B),
            group.pre_scores.reshape(1, B),
            cand_idx.reshape(1, B, k).astype(np.int64),
            cand_scores.reshape(1, B, k),
            B, group.end_id)
        group.pre_ids = sel_ids.reshape(B).astype(np.int64)
        group.pre_scores = sel_scores.reshape(B)
        parents = parents.reshape(B)
        group.hist_ids.append(group.pre_ids.copy())
        group.hist_parents.append(parents.copy())
        group.steps += 1
        # fork hypothesis state: slot j continues from its parent's
        # context (copy-on-write block sharing), then feeds its token
        self.cache.reorder({
            s.seq_id: group.seqs[int(parents[j])].seq_id
            for j, s in enumerate(group.seqs)})
        for j, s in enumerate(group.seqs):
            s.next_token = int(group.pre_ids[j])
        if group.steps >= group.max_new or bool(
                np.all(group.pre_ids == group.end_id)):
            toks = self._finish_beam(group)
            return [(group, toks, True)]
        # heartbeat: the group advanced but emits only on completion
        return [(group, [], False)]

    def _beam_search_op(self, pre_ids, pre_scores, ids, scores, beam,
                        end_id):
        """One step of the dense ``beam_search`` op, run through a tiny
        program on the engine's executor."""
        key = (beam, end_id)
        prog = self._beam_programs.get(key)
        if prog is None:
            prog = Program()
            b = prog.global_block()
            for n, dt in (("pre_ids", "int64"), ("pre_scores", "float32"),
                          ("ids", "int64"), ("scores", "float32")):
                b.create_var(name=n, dtype=dt, is_data=True)
            b.append_op(
                "beam_search",
                inputs={"pre_ids": ["pre_ids"], "pre_scores": ["pre_scores"],
                        "ids": ["ids"], "scores": ["scores"]},
                outputs={"selected_ids": ["selected_ids"],
                         "selected_scores": ["selected_scores"],
                         "parent_idx": ["parent_idx"]},
                attrs={"beam_size": beam, "end_id": end_id})
            self._beam_programs[key] = prog
        out = self._exe.run(prog,
                            feed={"pre_ids": pre_ids,
                                  "pre_scores": pre_scores,
                                  "ids": ids, "scores": scores},
                            fetch_list=["selected_ids", "selected_scores",
                                        "parent_idx"],
                            scope=Scope())
        return out[0], out[1], out[2]

    def _finish_beam(self, group):
        """Backtrack the best hypothesis and retire the group. Returns its
        tokens (EOS-trimmed) — a beam stream's single emission."""
        j = int(np.argmax(group.pre_scores))
        toks = []
        for t in range(len(group.hist_ids) - 1, -1, -1):
            toks.append(int(group.hist_ids[t][j]))
            j = int(group.hist_parents[t][j])
        toks.reverse()
        if group.end_id in toks:
            toks = toks[:toks.index(group.end_id)]
        group.finished = True
        for s in group.seqs:
            s.finished = True
            self._retire(s)
        self._groups.remove(group)
        return toks

    def _retire(self, seq):
        if self._slots[seq.slot] is seq:
            self._slots[seq.slot] = None
        self.cache.release(seq.seq_id)

    def abort(self, handle):
        """Cancel an in-flight request: frees its slot(s) and blocks at
        once (a request mid-chunked-prefill leaves the prefill queue
        too)."""
        with self._lock:
            if handle in self._prefill_queue:
                self._prefill_queue.remove(handle)
            if isinstance(handle, _BeamGroup):
                if not handle.finished:
                    handle.finished = True
                    for s in handle.seqs:
                        if not s.finished:
                            s.finished = True
                            self._retire(s)
                    if handle in self._groups:
                        self._groups.remove(handle)
            elif not handle.finished:
                handle.finished = True
                self._retire(handle)

    # ------------------------------------------------------------------
    @property
    def warmed(self):
        return self._warmed

    @property
    def hot_recompiles(self):
        """(phase, bucket) pairs first dispatched after warmup."""
        return int(self._m_hot.value)

    def _memory_section(self):
        """The arena's byte footprint (pre-allocated, live whatever the
        occupancy), the share its in-use blocks address, the scope's
        parameter bytes, and the card's allocated total (None on the
        CPU)."""
        arena_bytes = sum(a.numel() * a.element_size()
                          for arrs in (self.cache.k, self.cache.v)
                          for a in arrs)
        cs = self.cache.stats()
        in_use_frac = cs["blocks_in_use"] / max(cs["num_blocks"], 1)
        param_bytes = 0
        for name in self._scope.local_names():
            v = self._scope.find_var(name)
            if isinstance(v, torch.Tensor):
                param_bytes += v.numel() * v.element_size()
        live = torch.cuda.memory_allocated(self.device) \
            if self.device.type == "cuda" else None
        return {"arena_bytes": arena_bytes,
                "arena_bytes_in_use": int(arena_bytes * in_use_frac),
                "param_bytes": param_bytes,
                "device_bytes_live": live}

    def tune_digest(self):
        """Digest of the tuning table this engine's dispatches route by
        (its bundle's, else the one attached process-wide), or None."""
        with _autotune.routing(self._tune_table):
            return _autotune.active_digest()

    def stats(self):
        """Per-phase dispatch counts ({phase: {bucket: {"dispatches":
        n}}}), slot and arena occupancy, the kernel route, the process-wide
        paged-attention launches and fallbacks, the warm-executable cache's
        counters and loaded executables, TTFT/TPOT summaries and the memory
        section."""
        with self._stats_lock:
            phases = {ph: {b: {"dispatches": int(c.value) + int(h.value)}
                           for b, (c, h) in per.items()}
                      for ph, per in self._phase.items()}
        return {
            "phases": phases,
            "dispatches": sum(s["dispatches"] for per in phases.values()
                              for s in per.values()),
            "warmed": self._warmed,
            "hot_recompiles": self.hot_recompiles,
            "active_sequences": self.active_sequences,
            "prefilling": len(self._prefill_queue),
            "max_seqs": self.max_seqs,
            "blocks_in_use": self.cache.stats()["blocks_in_use"],
            "cache": self.cache.stats(),
            "prefill_chunk": self.prefill_chunk,
            "kernel_tier": kernel_tier.resolve_tier(self.device),
            "kernel_launches": dict(_pa.launches),
            "fallbacks": kernel_tier.fallback_counts(),
            "donate_arena": self.donate_arena,
            "tune_digest": self.tune_digest(),
            "exec_cache": None if self._exec_cache is None
            else self._exec_cache.stats(),
            "warm_loaded": len(self._warm_loaded),
            "kv_store": None if self._kv_store is None
            else self._kv_store.stats(),
            "ttft": self.ttft.snapshot(),
            "tpot": self.tpot.snapshot(),
            "memory": self._memory_section(),
        }


__all__ = ["GenerationEngine", "NoFreeSlots", "normalize_sampling"]
