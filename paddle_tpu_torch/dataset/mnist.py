"""MNIST dataset (reference python/paddle/v2/dataset/mnist.py).

Readers yield (image float32[784] scaled to [-1, 1], label int) — the
reference's exact sample schema. With the canonical idx-format files in
DATA_HOME/mnist they are parsed; otherwise a deterministic synthetic
generator produces class-structured digits (each class = a fixed blurred
template + noise, linearly separable, so MLP/conv book models converge on
it just like the real data).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from . import common

URL_PREFIX = "http://yann.lecun.com/exdb/mnist/"
TRAIN_IMAGE = "train-images-idx3-ubyte.gz"
TRAIN_LABEL = "train-labels-idx1-ubyte.gz"
TEST_IMAGE = "t10k-images-idx3-ubyte.gz"
TEST_LABEL = "t10k-labels-idx1-ubyte.gz"

SYNTH_TRAIN, SYNTH_TEST = 2048, 512


def _parse_idx(image_path, label_path):
    with gzip.open(label_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(n), dtype=np.uint8)
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        images = images.reshape(n, rows * cols)
    return images, labels


def _synthetic(n, seed):
    # class templates are FIXED across splits (train/test share one
    # labeling rule; only the samples/noise vary per split) so held-out
    # evaluation measures real generalization
    trng = np.random.RandomState(1234)
    templates = trng.rand(10, 784).astype(np.float32)
    templates = templates.reshape(10, 28, 28)
    for _ in range(2):  # cheap blur for spatial structure (conv models)
        templates = (templates + np.roll(templates, 1, 1)
                     + np.roll(templates, 1, 2)) / 3.0
    templates = templates.reshape(10, 784)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n)
    imgs = templates[labels] + 0.25 * rng.rand(n, 784).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return (imgs * 2.0 - 1.0).astype(np.float32), labels.astype(np.int64)


def _reader(image_file, label_file, synth_n, synth_seed):
    def reader():
        if (common.have_file(URL_PREFIX + image_file, "mnist")
                and common.have_file(URL_PREFIX + label_file, "mnist")):
            imgs, labels = _parse_idx(
                os.path.join(common.DATA_HOME, "mnist", image_file),
                os.path.join(common.DATA_HOME, "mnist", label_file))
            imgs = imgs.astype(np.float32) / 255.0 * 2.0 - 1.0
        else:
            imgs, labels = _synthetic(synth_n, synth_seed)
        for img, lbl in zip(imgs, labels):
            yield img, int(lbl)

    return reader


def train():
    return _reader(TRAIN_IMAGE, TRAIN_LABEL, SYNTH_TRAIN, 7)


def test():
    return _reader(TEST_IMAGE, TEST_LABEL, SYNTH_TEST, 11)


def convert(path):
    """Converts dataset to sharded recordio format (reference
    mnist.py:118)."""
    common.convert(path, train(), 1000, "minist_train")
    common.convert(path, test(), 1000, "minist_test")
