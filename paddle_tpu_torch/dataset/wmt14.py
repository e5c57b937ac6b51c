"""WMT14 English->French translation dataset (reference
python/paddle/v2/dataset/wmt14.py).

``train(dict_size)/test(dict_size)`` yield (src_ids, trg_ids, trg_ids_next)
with the reference's id conventions: <s>=0, <e>=1, <unk>=2, source wrapped
in <s>/<e>, target pair shifted by one (wmt14.py:79-109); sequences longer
than 80 are dropped. ``get_dict(dict_size)`` -> (src_dict, trg_dict).
Parses the canonical wmt14 tarball (train/test tsv + src.dict/trg.dict)
when cached; otherwise a deterministic synthetic translation task — target
= source reversed and offset-mapped — that attention seq2seq models learn
to high accuracy (the machine_translation book gate)."""

from __future__ import annotations

import os
import tarfile

import numpy as np

from . import common

URL_TRAIN = ("http://paddlepaddle.cdn.bcebos.com/demo/wmt_shrinked_data/"
             "wmt14.tgz")
START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

SYNTH_VOCAB = 30          # effective token count of the toy task
SYNTH_TRAIN, SYNTH_TEST = 600, 120
SYNTH_MAXLEN = 8


def _tar_path():
    return os.path.join(common.DATA_HOME, "wmt14", URL_TRAIN.split("/")[-1])


def _load_tar_dicts(tar_file, dict_size):
    """Vocabulary tables from the wmt14 tarball: the archive ships
    ``*src.dict`` / ``*trg.dict`` members, one token per line already in
    frequency order, so token -> line number caps the vocabulary at
    ``dict_size`` (reference wmt14.py __read_to_dict)."""
    def vocab_of(tf, suffix):
        member = next(n for n in tf.getnames() if n.endswith(suffix))
        lines = tf.extractfile(member).read().decode().splitlines()
        return {tok.strip(): i for i, tok in enumerate(lines[:dict_size])}

    with tarfile.open(tar_file, mode="r") as tf:
        return vocab_of(tf, "src.dict"), vocab_of(tf, "trg.dict")


def _synth_dicts(dict_size):
    n = min(dict_size, SYNTH_VOCAB + 3)
    src = {START: 0, END: 1, UNK: 2}
    trg = {START: 0, END: 1, UNK: 2}
    for i in range(3, n):
        src[f"s{i}"] = i
        trg[f"t{i}"] = i
    return src, trg


def _synth_samples(n, seed, dict_size):
    """target = reversed source with a fixed token permutation."""
    rng = np.random.RandomState(seed)
    vocab = min(dict_size, SYNTH_VOCAB + 3)
    usable = vocab - 3
    perm = np.random.RandomState(77).permutation(usable)
    for _ in range(n):
        ln = int(rng.randint(2, SYNTH_MAXLEN))
        src_core = rng.randint(0, usable, ln)
        trg_core = perm[src_core[::-1]]
        src_ids = [0] + [int(t) + 3 for t in src_core] + [1]
        trg_ids = [int(t) + 3 for t in trg_core]
        yield src_ids, [0] + trg_ids, trg_ids + [1]


def reader_creator(file_name, dict_size, synth_n, synth_seed):
    def reader():
        if common.have_file(URL_TRAIN, "wmt14"):
            src_dict, trg_dict = _load_tar_dicts(_tar_path(), dict_size)
            with tarfile.open(_tar_path(), mode="r") as f:
                names = [n for n in f.getnames() if n.endswith(file_name)]
                for name in names:
                    for line in f.extractfile(name):
                        parts = line.decode().strip().split("\t")
                        if len(parts) != 2:
                            continue
                        src_words = parts[0].split()
                        src_ids = [src_dict.get(w, UNK_IDX)
                                   for w in [START] + src_words + [END]]
                        trg_words = parts[1].split()
                        trg_ids = [trg_dict.get(w, UNK_IDX)
                                   for w in trg_words]
                        if len(src_ids) > 80 or len(trg_ids) > 80:
                            continue
                        yield (src_ids, [trg_dict[START]] + trg_ids,
                               trg_ids + [trg_dict[END]])
        else:
            yield from _synth_samples(synth_n, synth_seed, dict_size)

    return reader


def train(dict_size):
    return reader_creator("train/train", dict_size, SYNTH_TRAIN, 5)


def test(dict_size):
    return reader_creator("test/test", dict_size, SYNTH_TEST, 9)


def gen(dict_size):
    return reader_creator("gen/gen", dict_size, SYNTH_TEST, 13)


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); reverse=True returns id->word (the reference's
    default orientation for decoding printouts)."""
    if common.have_file(URL_TRAIN, "wmt14"):
        src_dict, trg_dict = _load_tar_dicts(_tar_path(), dict_size)
    else:
        src_dict, trg_dict = _synth_dicts(dict_size)
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict


def convert(path):
    """Converts dataset to sharded recordio format (reference
    wmt14.py:175)."""
    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")
