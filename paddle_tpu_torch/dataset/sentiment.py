"""NLTK movie-review sentiment dataset (reference
python/paddle/v2/dataset/sentiment.py — 2k polarity-labeled reviews).

``get_word_dict()`` -> frequency-ranked token->id;
``train()/test()`` yield (token_id_list, label 0/1) with the reference's
1600/400 split. Parses the movie_reviews corpus zip (NLTK layout:
movie_reviews/{pos,neg}/*.txt) when cached; otherwise a deterministic
synthetic polarity corpus (marker tokens + noise, same recipe as
dataset/imdb.py)."""

from __future__ import annotations

import os
import re
import zipfile

import numpy as np

from . import common

URL = ("https://raw.githubusercontent.com/nltk/nltk_data/gh-pages/"
       "packages/corpora/movie_reviews.zip")

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000

SYNTH_VOCAB = 100


def _tokenize(text):
    return re.findall(r"[a-z']+", text.lower())


def _synth_corpus():
    rng = np.random.RandomState(21)
    # reference label convention (sentiment.py:98): neg=0, pos=1
    neg_markers = list(range(2, 10))
    pos_markers = list(range(10, 18))
    samples = []
    for i in range(NUM_TOTAL_INSTANCES):
        label = i % 2
        markers = neg_markers if label == 0 else pos_markers
        ln = int(rng.randint(10, 50))
        seq = rng.randint(18, SYNTH_VOCAB, ln).tolist()
        for _ in range(max(2, ln // 8)):
            seq[int(rng.randint(0, ln))] = int(
                markers[int(rng.randint(0, len(markers)))])
        samples.append(([f"w{t}" for t in seq], label))
    order = np.random.RandomState(8).permutation(len(samples))
    return [samples[i] for i in order]


def _real_corpus():
    path = os.path.join(common.DATA_HOME, "sentiment", URL.split("/")[-1])
    samples = []
    with zipfile.ZipFile(path) as z:
        for name in sorted(z.namelist()):
            m = re.match(r"movie_reviews/(pos|neg)/.*\.txt$", name)
            if not m:
                continue
            # reference sentiment.py:98: neg -> 0, pos -> 1
            label = 0 if m.group(1) == "neg" else 1
            samples.append((_tokenize(z.read(name).decode("latin1")),
                            label))
    order = np.random.RandomState(8).permutation(len(samples))
    return [samples[i] for i in order]


_CORPUS = None


def _corpus():
    global _CORPUS
    if _CORPUS is None:
        _CORPUS = _real_corpus() if common.have_file(URL, "sentiment") \
            else _synth_corpus()
    return _CORPUS


_WORD_DICT = None


def get_word_dict():
    """Frequency-ranked word->id over the whole corpus (reference
    sentiment.get_word_dict sorts by descending count). Cached: readers
    call this per epoch."""
    global _WORD_DICT
    if _WORD_DICT is not None:
        return _WORD_DICT
    freq = {}
    for words, _ in _corpus():
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    ranked = sorted(freq.items(), key=lambda x: (-x[1], x[0]))
    _WORD_DICT = {w: i for i, (w, _) in enumerate(ranked)}
    return _WORD_DICT


def reader_creator(data):
    def reader():
        word_dict = get_word_dict()
        for words, label in data:
            yield [word_dict[w] for w in words if w in word_dict], label

    return reader


def train():
    return reader_creator(_corpus()[:NUM_TRAINING_INSTANCES])


def test():
    return reader_creator(_corpus()[NUM_TRAINING_INSTANCES:])


def convert(path):
    """Converts dataset to sharded recordio format (reference
    sentiment.py:136)."""
    common.convert(path, train(), 1000, "sentiment_train")
    common.convert(path, test(), 1000, "sentiment_test")
