"""imikolov (PTB) language-model dataset (reference
python/paddle/v2/dataset/imikolov.py).

``build_dict(min_word_freq)`` builds the frequency-filtered vocabulary with
a trailing ``<unk>``; ``train(word_idx, n)`` / ``test(word_idx, n)`` yield
n-gram id tuples (DataType.NGRAM) or (src_ids, trg_ids) shifted pairs
(DataType.SEQ) over sentences wrapped in <s>/<e>. Parses the canonical
simple-examples.tgz when cached; otherwise a deterministic synthetic corpus
with Zipf-ish unigram statistics and strong bigram structure (so n-gram
models actually learn)."""

from __future__ import annotations

import os
import tarfile

import numpy as np

from . import common

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
TRAIN_MEMBER = "./simple-examples/data/ptb.train.txt"
TEST_MEMBER = "./simple-examples/data/ptb.valid.txt"

SYNTH_VOCAB = 200
SYNTH_TRAIN, SYNTH_TEST = 1200, 240


class DataType:
    NGRAM = 1
    SEQ = 2


def _synth_sentences(n, seed):
    """Markov-chain sentences: each token prefers (token*3+1) mod V next —
    structure an n-gram model can fit."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = int(rng.randint(4, 18))
        tok = int(rng.randint(0, SYNTH_VOCAB))
        sent = []
        for _ in range(ln):
            sent.append(f"w{tok}")
            if rng.rand() < 0.7:
                tok = (tok * 3 + 1) % SYNTH_VOCAB
            else:
                tok = int(rng.randint(0, SYNTH_VOCAB))
        out.append(sent)
    return out


def _sentences(member, synth_n, seed):
    if common.have_file(URL, "imikolov"):
        path = os.path.join(common.DATA_HOME, "imikolov",
                            URL.split("/")[-1])
        with tarfile.open(path) as tf:
            for line in tf.extractfile(member):
                yield line.decode().strip().split()
    else:
        yield from _synth_sentences(synth_n, seed)


def word_count(sentences, word_freq=None):
    word_freq = word_freq if word_freq is not None else {}
    for l in sentences:
        for w in l:
            word_freq[w] = word_freq.get(w, 0) + 1
        word_freq["<s>"] = word_freq.get("<s>", 0) + 1
        word_freq["<e>"] = word_freq.get("<e>", 0) + 1
    return word_freq


def build_dict(min_word_freq=50):
    """Frequency-filtered word -> id, '<unk>' appended last (reference
    imikolov.build_dict)."""
    synth = not common.have_file(URL, "imikolov")
    freq = word_count(_sentences(TRAIN_MEMBER, SYNTH_TRAIN, 5))
    if synth:
        min_word_freq = 1  # the synthetic corpus is small
    freq = {k: v for k, v in freq.items() if v >= min_word_freq
            and k != "<unk>"}
    words, _ = list(zip(*sorted(freq.items(),
                                key=lambda x: (-x[1], x[0]))))
    word_idx = dict(zip(words, range(len(words))))
    word_idx["<unk>"] = len(words)
    return word_idx


def reader_creator(member, word_idx, n, data_type, synth_n, seed):
    def reader():
        unk = word_idx["<unk>"]
        for sent in _sentences(member, synth_n, seed):
            if data_type == DataType.NGRAM:
                assert n > -1, "Invalid gram length"
                l = ["<s>"] + sent + ["<e>"]
                if len(l) >= n:
                    ids = [word_idx.get(w, unk) for w in l]
                    for i in range(n, len(l) + 1):
                        yield tuple(ids[i - n:i])
            elif data_type == DataType.SEQ:
                ids = [word_idx.get(w, unk) for w in sent]
                src = [word_idx["<s>"]] + ids
                trg = ids + [word_idx["<e>"]]
                yield src, trg
            else:
                raise ValueError(f"Unknown data type {data_type}")

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return reader_creator(TRAIN_MEMBER, word_idx, n, data_type,
                          SYNTH_TRAIN, 5)


def test(word_idx, n, data_type=DataType.NGRAM):
    return reader_creator(TEST_MEMBER, word_idx, n, data_type,
                          SYNTH_TEST, 9)


def convert(path):
    """Converts dataset to sharded recordio format (reference
    imikolov.py:151)."""
    n = 5
    word_idx = build_dict()
    common.convert(path, train(word_idx, n), 1000, "imikolov_train")
    common.convert(path, test(word_idx, n), 1000, "imikolov_test")
