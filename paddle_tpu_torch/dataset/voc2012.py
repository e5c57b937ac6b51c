"""PASCAL VOC2012 segmentation dataset (reference
python/paddle/v2/dataset/voc2012.py).

``train()/test()/val()`` yield (image uint8 HWC, label uint8 HW segmentation
mask with class ids 0..20 and 255=void) per the reference's
load_image_bytes pairs. Real path reads the VOCtrainval tarball (needs
Pillow for JPEG/PNG decode); synthetic fallback draws axis-aligned class
rectangles on structured backgrounds."""

from __future__ import annotations

import io
import os
import tarfile

import numpy as np

from . import common

URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
       "VOCtrainval_11-May-2012.tar")
VOC_ROOT = "VOCdevkit/VOC2012/"

N_CLASSES = 21
SYNTH_TRAIN, SYNTH_TEST = 48, 12
SYNTH_HW = 96


def _synth_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            img = rng.randint(0, 80, (SYNTH_HW, SYNTH_HW, 3),
                              dtype=np.uint8)
            label = np.zeros((SYNTH_HW, SYNTH_HW), np.uint8)
            for _ in range(int(rng.randint(1, 4))):
                cls = int(rng.randint(1, N_CLASSES))
                x0, y0 = rng.randint(0, SYNTH_HW - 16, 2)
                w, h = rng.randint(12, 32, 2)
                x1, y1 = min(x0 + w, SYNTH_HW), min(y0 + h, SYNTH_HW)
                label[y0:y1, x0:x1] = cls
                # class-correlated appearance so a segmenter can learn
                img[y0:y1, x0:x1] = (40 + cls * 10) % 255
            yield img, label

    return reader


def _real_reader(sub_name):
    def reader():
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("parsing VOC2012 needs Pillow") from e
        path = os.path.join(common.DATA_HOME, "voc2012", URL.split("/")[-1])
        with tarfile.open(path) as tf:
            listing = tf.extractfile(
                VOC_ROOT + f"ImageSets/Segmentation/{sub_name}.txt"
            ).read().decode().split()
            for name in listing:
                img = Image.open(io.BytesIO(tf.extractfile(
                    VOC_ROOT + f"JPEGImages/{name}.jpg").read()))
                lab = Image.open(io.BytesIO(tf.extractfile(
                    VOC_ROOT + f"SegmentationClass/{name}.png").read()))
                yield (np.asarray(img.convert("RGB"), np.uint8),
                       np.asarray(lab, np.uint8))

    return reader


def _pick(sub_name, n, seed):
    if common.have_file(URL, "voc2012"):
        return _real_reader(sub_name)
    return _synth_reader(n, seed)


def train():
    return _pick("trainval", SYNTH_TRAIN, 1)


def test():
    return _pick("train", SYNTH_TEST, 2)


def val():
    return _pick("val", SYNTH_TEST, 3)
