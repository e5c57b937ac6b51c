"""bench.py:352's ragged LSTM lane (``run_lstm_ragged_lane``) as the port
runs it: the IMDB-width LSTM classifier of bench.py:238 over a bimodal
corpus (half the sequences short, half long), one epoch either padded
flat to the corpus bound or bucketed by length through recordio and
``reader.bucket_by_length``; each padded bound's batches are staged once
with ``Executor.prepare_steps`` and run with ``run_prepared``.

The functions take the reader stack and the LoD packer as arguments with
this package's as defaults, so a test can run the same protocol through
the JAX package's own modules.
"""

from __future__ import annotations

import numpy as np

# bench.py:352's lane: batch 64, bounds [12, 100], 4608 sequences, half of
# length 10-12, half 96-100, vocab 30000, emb 128, hidden 512, Adam 2e-3
BATCH, BOUNDS, N_SEQS = 64, (12, 100), 4608
SHORT, LONG = (10, 12), (96, 100)
VOCAB, EMB, HIDDEN, LR = 30000, 128, 512, 2e-3


def corpus(n_seqs=N_SEQS, vocab=VOCAB, short=SHORT, long=LONG, seed=0):
    """bench.py:380's corpus: sequence i is ``short`` long (inclusive
    range) for even i, ``long`` for odd i, of ids below ``vocab``, with a
    label 0/1, all drawn from ``RandomState(seed)`` in bench.py's order."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_seqs):
        lo, hi = short if i % 2 == 0 else long
        ln = int(rng.randint(lo, hi + 1))
        out.append((rng.randint(0, vocab, (ln, 1)).astype("int64"),
                    int(rng.randint(0, 2))))
    return out


def flat_batches(samples, batch=BATCH, bound=BOUNDS[-1]):
    """Full batches in corpus order, each padded to the corpus bound:
    [(samples, bound)]."""
    return [(samples[i:i + batch], bound)
            for i in range(0, len(samples) - batch + 1, batch)]


def bucketed_batches(path, bounds=BOUNDS, batch=BATCH, reader_pkg=None):
    """The corpus read back from the recordio file at ``path``
    (``reader_pkg.creator.recordio``), grouped by
    ``reader_pkg.bucket_by_length`` (drop last) and padded to
    ``bucket_bound_for``: [(samples, bound)]."""
    if reader_pkg is None:
        from .. import reader as reader_pkg
    rd = reader_pkg.bucket_by_length(reader_pkg.creator.recordio(path),
                                     key=lambda s: len(s[0]),
                                     bucket_bounds=list(bounds),
                                     batch_size=batch, drop_last=True)
    return [(chunk, reader_pkg.bucket_bound_for(
        list(bounds), max(len(s[0]) for s in chunk))) for chunk in rd()]


def feed_of(chunk, bound, pack=None):
    """One batch's feed: words padded to ``bound``, labels [b, 1]."""
    if pack is None:
        from ..core.lod import pack_sequences as pack
    return {"words": pack([s for s, _ in chunk], max_len=bound),
            "label": np.asarray([[lbl] for _, lbl in chunk], "int64")}


def groups(batches, pack=None):
    """{bound: [feed, ...]} in batch order, and the sample count."""
    out, n = {}, 0
    for chunk, bound in batches:
        out.setdefault(bound, []).append(feed_of(chunk, bound, pack))
        n += len(chunk)
    return out, n


def build(fluid, vocab=VOCAB, emb=EMB, hidden=HIDDEN, lr=LR, seed=None):
    """bench.py:238 build_lstm_textcls: the classifier, mean cross entropy
    and (unfused) Adam(lr). Returns (main, startup, loss)."""
    from .models import lstm_textcls

    main, startup = fluid.Program(), fluid.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prob = lstm_textcls(words, vocab=vocab, emb=emb, hidden=hidden,
                            layers=fluid.layers)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss, startup)
    return main, startup, loss


def prepare(exe, main, loss, scope, grouped):
    """One prepared handle per bound, ascending."""
    return [exe.prepare_steps(main, feeds=grouped[b], fetch_list=[loss],
                              scope=scope) for b in sorted(grouped)]


def epoch(exe, handles):
    """Run every handle once: the epoch's per-step losses, as the
    executor returns them (numpy), in order."""
    out = []
    for h in handles:
        out.extend(np.asarray(exe.run_prepared(h)[0]).reshape(-1))
    return np.asarray(out)
