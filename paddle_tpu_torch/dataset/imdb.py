"""IMDB sentiment dataset (reference python/paddle/v2/dataset/imdb.py).

``word_dict()`` returns token→id; ``train(word_dict)`` / ``test(word_dict)``
yield (token_id_sequence, label 0/1) — the reference schema consumed by the
understand_sentiment book models. Falls back to a deterministic synthetic
corpus of sentiment-bearing token patterns (positive/negative marker tokens
mixed with noise words, learnable by conv/LSTM models) when the aclImdb
tarball is absent from DATA_HOME/imdb.
"""

from __future__ import annotations

import os
import re
import string
import tarfile

import numpy as np

from . import common

URL = "https://ai.stanford.edu/~amaas/data/sentiment/aclImdb_v1.tar.gz"

SYNTH_VOCAB = 120
SYNTH_TRAIN, SYNTH_TEST = 1024, 256


def _tokenize(text):
    return re.sub(f"[{string.punctuation}]", " ", text.lower()).split()


def _corpus_from_tar(path, pattern):
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            if re.match(pattern, m.name):
                yield _tokenize(tf.extractfile(m).read().decode()), \
                    0 if "neg" in m.name else 1


def _synth_corpus(n, seed):
    rng = np.random.RandomState(seed)
    pos_markers = list(range(2, 12))
    neg_markers = list(range(12, 22))
    samples = []
    for i in range(n):
        label = int(rng.randint(0, 2))
        markers = pos_markers if label else neg_markers
        ln = int(rng.randint(8, 40))
        seq = rng.randint(22, SYNTH_VOCAB, ln).tolist()
        for _ in range(max(2, ln // 6)):
            seq[int(rng.randint(0, ln))] = int(
                markers[int(rng.randint(0, len(markers)))])
        samples.append(([f"w{t}" for t in seq], label))
    return samples


def word_dict():
    """token -> id, frequency-sorted (reference imdb.word_dict)."""
    freq = {}
    if common.have_file(URL, "imdb"):
        path = os.path.join(common.DATA_HOME, "imdb", URL.split("/")[-1])
        for toks, _ in _corpus_from_tar(
                path, r"aclImdb/(train|test)/(pos|neg)/.*\.txt$"):
            for t in toks:
                freq[t] = freq.get(t, 0) + 1
    else:
        for toks, _ in _synth_corpus(SYNTH_TRAIN, 13):
            for t in toks:
                freq[t] = freq.get(t, 0) + 1
    words = sorted(freq, key=lambda w: (-freq[w], w))
    d = {w: i for i, w in enumerate(words)}
    d["<unk>"] = len(d)
    return d


def _reader(pattern, synth_n, seed, word_idx):
    unk = word_idx.get("<unk>", len(word_idx))

    def reader():
        if common.have_file(URL, "imdb"):
            path = os.path.join(common.DATA_HOME, "imdb",
                                URL.split("/")[-1])
            corpus = _corpus_from_tar(path, pattern)
        else:
            corpus = _synth_corpus(synth_n, seed)
        for toks, label in corpus:
            yield [word_idx.get(t, unk) for t in toks], label

    return reader


def train(word_idx):
    return _reader(r"aclImdb/train/(pos|neg)/.*\.txt$", SYNTH_TRAIN, 13,
                   word_idx)


def test(word_idx):
    return _reader(r"aclImdb/test/(pos|neg)/.*\.txt$", SYNTH_TEST, 17,
                   word_idx)


def convert(path):
    """Converts dataset to sharded recordio format (reference
    imdb.py:142)."""
    w = word_dict()
    common.convert(path, lambda: train(w)(), 1000, "imdb_train")
    common.convert(path, lambda: test(w)(), 1000, "imdb_test")
