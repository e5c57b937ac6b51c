"""Oxford 102 Flowers dataset (reference python/paddle/v2/dataset/flowers.py).

``train()/test()/valid()`` yield (image float32 CHW [3, 224, 224] scaled to
[0, 1], label 0..101) — the reference pipes JPEGs through
image.simple_transform(resize 256, crop 224); parsing the real 102flowers
tarball needs an image decoder, so the real path requires Pillow (gated
with a clear error). The synthetic fallback renders class-templated
low-frequency images upsampled to 224 (conv classifiers separate them)."""

from __future__ import annotations

import os
import tarfile

import numpy as np

from . import common

DATA_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
            "102flowers.tgz")
LABEL_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
             "imagelabels.mat")
SETID_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
             "setid.mat")

N_CLASSES = 102
SYNTH_PER_CLASS_TRAIN, SYNTH_PER_CLASS_TEST = 4, 1


def _synth_reader(per_class, seed):
    def reader():
        trng = np.random.RandomState(99)
        templates = trng.rand(N_CLASSES, 3, 8, 8).astype(np.float32)
        rng = np.random.RandomState(seed)
        order = rng.permutation(N_CLASSES * per_class)
        for idx in order:
            label = int(idx % N_CLASSES)
            low = templates[label] + 0.15 * rng.rand(3, 8, 8)
            img = np.kron(low, np.ones((28, 28), np.float32))
            img = np.clip(img + 0.05 * rng.rand(3, 224, 224), 0, 1)
            yield img.astype(np.float32), label

    return reader


def _real_reader(split):
    def reader():
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "parsing the real 102flowers JPEGs needs Pillow; install it "
                "or fall back to the synthetic readers") from e
        import scipy.io as sio

        base = os.path.join(common.DATA_HOME, "flowers")
        labels = sio.loadmat(os.path.join(base, "imagelabels.mat"))[
            "labels"].ravel()
        setid = sio.loadmat(os.path.join(base, "setid.mat"))
        # reference flowers.py:50-54 deliberately SWAPS the mat file's
        # naming: TRAIN_FLAG='tstid' (the ~6k-image split, "test data is
        # more than train data") and TEST_FLAG='trnid'
        ids = setid[{"train": "tstid", "test": "trnid",
                     "valid": "valid"}[split]].ravel()
        from ..v2 import image as v2_image

        del Image  # decoding goes through v2.image (same Pillow backend)
        with tarfile.open(os.path.join(base, DATA_URL.split("/")[-1])) as tf:
            members = {m.name: m for m in tf.getmembers()}
            for i in ids:
                name = f"jpg/image_{int(i):05d}.jpg"
                # the reference pipeline: decode -> simple_transform
                # (resize_short 256, center-crop 224, CHW float32) — then
                # scaled to [0,1], this module's pinned schema
                im = v2_image.load_image_bytes(
                    tf.extractfile(members[name]).read())
                arr = v2_image.simple_transform(im, 256, 224,
                                                is_train=False) / 255.0
                yield arr.astype(np.float32), int(labels[int(i) - 1]) - 1

    return reader


def _have_real():
    return (common.have_file(DATA_URL, "flowers")
            and common.have_file(LABEL_URL, "flowers")
            and common.have_file(SETID_URL, "flowers"))


def _with_mapper(reader, mapper):
    """Apply the reference's per-sample mapper contract (flowers.py maps
    every (img, label) through it, via xmap in the original) using the
    reader-decorator layer, like the reference."""
    if mapper is None:
        return reader
    from ..reader.decorator import map_readers
    return map_readers(mapper, reader)


def train(mapper=None, buffered_size=1024, use_xmap=True):
    base = _real_reader("train") if _have_real()         else _synth_reader(SYNTH_PER_CLASS_TRAIN, 3)
    return _with_mapper(base, mapper)


def test(mapper=None, buffered_size=1024, use_xmap=True):
    base = _real_reader("test") if _have_real()         else _synth_reader(SYNTH_PER_CLASS_TEST, 7)
    return _with_mapper(base, mapper)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    base = _real_reader("valid") if _have_real()         else _synth_reader(SYNTH_PER_CLASS_TEST, 13)
    return _with_mapper(base, mapper)
