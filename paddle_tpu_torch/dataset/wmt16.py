"""WMT16 English<->German translation dataset (reference
python/paddle/v2/dataset/wmt16.py — the multimodal task's text pairs with
on-the-fly vocabulary building).

``train/test/validation(src_dict_size, trg_dict_size, src_lang)`` yield
(src_ids, trg_ids, trg_ids_next); ``get_dict(lang, dict_size)``. Same id
conventions as wmt14 (<s>=0, <e>=1, <unk>=2). Real path parses the
wmt16.tar.gz train/val/test tsvs, building frequency dictionaries exactly
like the reference (__build_dict counts words, keeps dict_size-3 most
frequent); synthetic fallback mirrors wmt14's toy permutation task with a
German-flavored direction flag."""

from __future__ import annotations

import os
import tarfile
from collections import defaultdict

import numpy as np

from . import common

URL = ("http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz")

START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"

SYNTH_VOCAB = 30
SYNTH_TRAIN, SYNTH_TEST = 600, 120
SYNTH_MAXLEN = 8


def _tar_path():
    return os.path.join(common.DATA_HOME, "wmt16", URL.split("/")[-1])


def __build_dict(tar_file, dict_size, lang):
    word_dict = defaultdict(int)
    with tarfile.open(tar_file, mode="r") as f:
        for line in f.extractfile("wmt16/train"):
            line = line.decode().strip().split("\t")
            if len(line) != 2:
                continue
            sen = line[0] if lang == "en" else line[1]
            for w in sen.split():
                word_dict[w] += 1
    words = [w for w, _ in sorted(word_dict.items(),
                                  key=lambda x: (-x[1], x[0]))]
    d = {START_MARK: 0, END_MARK: 1, UNK_MARK: 2}
    for w in words[:dict_size - 3]:
        d[w] = len(d)
    return d


def _synth_dict(dict_size, lang):
    prefix = "e" if lang == "en" else "g"
    d = {START_MARK: 0, END_MARK: 1, UNK_MARK: 2}
    for i in range(3, min(dict_size, SYNTH_VOCAB + 3)):
        d[f"{prefix}{i}"] = i
    return d


def get_dict(lang, dict_size, reverse=False):
    if common.have_file(URL, "wmt16"):
        d = __build_dict(_tar_path(), dict_size, lang)
    else:
        d = _synth_dict(dict_size, lang)
    if reverse:
        d = {v: k for k, v in d.items()}
    return d


def _synth_samples(n, seed, src_dict_size, trg_dict_size):
    rng = np.random.RandomState(seed)
    usable = min(src_dict_size, SYNTH_VOCAB + 3) - 3
    perm = np.random.RandomState(78).permutation(usable)
    for _ in range(n):
        ln = int(rng.randint(2, SYNTH_MAXLEN))
        src_core = rng.randint(0, usable, ln)
        trg_core = perm[src_core[::-1]]
        src_ids = [0] + [int(t) + 3 for t in src_core] + [1]
        trg_ids = [int(t) + 3 for t in trg_core]
        yield src_ids, [0] + trg_ids, trg_ids + [1]


def reader_creator(file_name, src_dict_size, trg_dict_size, src_lang,
                   synth_n, synth_seed):
    def reader():
        if common.have_file(URL, "wmt16"):
            src_dict = get_dict(src_lang, src_dict_size)
            trg_lang = "de" if src_lang == "en" else "en"
            trg_dict = get_dict(trg_lang, trg_dict_size)
            src_col = 0 if src_lang == "en" else 1
            with tarfile.open(_tar_path(), mode="r") as f:
                for line in f.extractfile(f"wmt16/{file_name}"):
                    parts = line.decode().strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[src_col].split()
                    trg_words = parts[1 - src_col].split()
                    src_ids = [src_dict.get(w, 2)
                               for w in [START_MARK] + src_words
                               + [END_MARK]]
                    trg_ids = [trg_dict.get(w, 2) for w in trg_words]
                    yield (src_ids, [0] + trg_ids, trg_ids + [1])
        else:
            yield from _synth_samples(synth_n, synth_seed, src_dict_size,
                                      trg_dict_size)

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return reader_creator("train", src_dict_size, trg_dict_size, src_lang,
                          SYNTH_TRAIN, 5)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return reader_creator("test", src_dict_size, trg_dict_size, src_lang,
                          SYNTH_TEST, 9)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return reader_creator("val", src_dict_size, trg_dict_size, src_lang,
                          SYNTH_TEST, 13)


def convert(path, src_dict_size, trg_dict_size, src_lang):
    """Converts dataset to sharded recordio format (reference
    wmt16.py:322)."""
    common.convert(path,
                   train(src_dict_size=src_dict_size,
                         trg_dict_size=trg_dict_size, src_lang=src_lang),
                   1000, "wmt16_train")
    common.convert(path,
                   test(src_dict_size=src_dict_size,
                        trg_dict_size=trg_dict_size, src_lang=src_lang),
                   1000, "wmt16_test")
