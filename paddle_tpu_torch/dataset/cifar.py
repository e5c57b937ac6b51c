"""CIFAR-10/100 dataset (reference python/paddle/v2/dataset/cifar.py).

Readers yield (image float32[3072] in [0, 1], label int). Canonical
pickle-batch tarballs in DATA_HOME/cifar are used when present; otherwise a
deterministic synthetic generator with per-class color/texture structure.
"""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from . import common

URL_PREFIX = "https://www.cs.toronto.edu/~kriz/"
CIFAR10_URL = URL_PREFIX + "cifar-10-python.tar.gz"
CIFAR100_URL = URL_PREFIX + "cifar-100-python.tar.gz"

SYNTH_TRAIN, SYNTH_TEST = 2048, 512


def _tar_reader(path, member_match):
    def reader():
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if member_match not in m.name:
                    continue
                d = pickle.load(tf.extractfile(m), encoding="latin1")
                for img, lbl in zip(d["data"],
                                    d.get("labels", d.get("fine_labels"))):
                    yield (img.astype(np.float32) / 255.0, int(lbl))

    return reader


def _synthetic(n, classes, seed):
    # fixed per-class templates across splits (see mnist._synthetic)
    trng = np.random.RandomState(4321 + classes)
    templates = trng.rand(classes, 3072).astype(np.float32)
    t = templates.reshape(classes, 3, 32, 32)
    for _ in range(2):
        t = (t + np.roll(t, 1, 2) + np.roll(t, 1, 3)) / 3.0
    templates = t.reshape(classes, 3072)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    imgs = np.clip(templates[labels]
                   + 0.2 * rng.rand(n, 3072).astype(np.float32), 0, 1)
    return imgs.astype(np.float32), labels


def _reader(url, member_match, classes, synth_n, seed):
    def reader():
        if common.have_file(url, "cifar"):
            path = os.path.join(common.DATA_HOME, "cifar",
                                url.split("/")[-1])
            yield from _tar_reader(path, member_match)()
            return
        imgs, labels = _synthetic(synth_n, classes, seed)
        for img, lbl in zip(imgs, labels):
            yield img, int(lbl)

    return reader


def train10():
    return _reader(CIFAR10_URL, "data_batch", 10, SYNTH_TRAIN, 3)


def test10():
    return _reader(CIFAR10_URL, "test_batch", 10, SYNTH_TEST, 5)


def train100():
    return _reader(CIFAR100_URL, "train", 100, SYNTH_TRAIN, 7)


def test100():
    return _reader(CIFAR100_URL, "test", 100, SYNTH_TEST, 9)


def convert(path):
    """Converts dataset to sharded recordio format (reference
    cifar.py:132)."""
    common.convert(path, train100(), 1000, "cifar_train100")
    common.convert(path, test100(), 1000, "cifar_test100")
    common.convert(path, train10(), 1000, "cifar_train10")
    common.convert(path, test10(), 1000, "cifar_test10")
