"""v2 image preprocessing utilities.

Reference: python/paddle/v2/image.py — load/resize_short/to_chw/
center_crop/random_crop/left_right_flip/simple_transform/
load_and_transform/batch_images_from_tar, the helpers every reference
image pipeline (flowers, image-classification book chapter) maps samples
through.

Layouts follow the reference's contract: decoded images are HWC (HW for
grayscale); training consumes CHW via ``to_chw``. The reference decodes
with OpenCV (BGR); this implementation decodes with Pillow (RGB, the only
decoder in the image) — as the reference's own docstring notes, either
color order works as long as train and inference agree.
"""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def _pil():
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "paddle_tpu_torch.v2.image decoding needs Pillow") from e
    return Image


def load_image_bytes(bytes_, is_color=True):
    """Decode an image from its encoded bytes -> HWC uint8 ndarray (HW for
    grayscale), reference image.py:111."""
    import io

    img = _pil().open(io.BytesIO(bytes_))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(file, is_color=True):
    """Decode an image file -> HWC uint8 ndarray (reference image.py:135)."""
    img = _pil().open(file).convert("RGB" if is_color else "L")
    return np.asarray(img)


def resize_short(im, size):
    """Resize so the SHORTER edge equals ``size``, keeping aspect ratio
    (reference image.py:163, INTER_CUBIC -> Pillow BICUBIC)."""
    h, w = im.shape[:2]
    if h > w:
        h_new, w_new = size * h // w, size
    else:
        h_new, w_new = size, size * w // h
    Image = _pil()
    mode = "RGB" if im.ndim == 3 else "L"
    pil = Image.fromarray(im.astype(np.uint8), mode=mode)
    pil = pil.resize((w_new, h_new), Image.BICUBIC)
    return np.asarray(pil)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference image.py:189)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the spatial center (reference image.py:213)."""
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    if is_color and im.ndim == 3:
        return im[h_start:h_start + size, w_start:w_start + size, :]
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True, rng=None):
    """Random spatial crop (reference image.py:241; ``rng`` added for
    reproducible pipelines, defaults to numpy's global state like the
    reference)."""
    rng = rng or np.random
    h, w = im.shape[:2]
    h_start = rng.randint(0, h - size + 1)
    w_start = rng.randint(0, w - size + 1)
    if is_color and im.ndim == 3:
        return im[h_start:h_start + size, w_start:w_start + size, :]
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    """Horizontal flip (reference image.py:269)."""
    if im.ndim == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None, rng=None):
    """resize_short -> (random crop + coin-flip LR flip | center crop) ->
    CHW float32 -> optional mean subtraction (reference image.py:291; mean
    may be per-channel or elementwise)."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color, rng=rng)
        if rng.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and is_color and im.ndim == 3:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """load_image + simple_transform (reference image.py:348)."""
    im = load_image(filename, is_color)
    return simple_transform(im, resize_size, crop_size, is_train, is_color,
                            mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-batch raw image bytes from a tar into pickled batch files and a
    meta listing (reference image.py:48; pickle protocol updated, same
    {label, data} record shape)."""
    batch_dir = data_file + "_batch"
    out_path = os.path.join(batch_dir, dataset_name)
    meta_file = os.path.join(batch_dir, dataset_name + ".txt")
    if os.path.exists(out_path):
        return meta_file
    os.makedirs(out_path)

    data, labels, file_id = [], [], 0

    def _flush():
        nonlocal file_id, data, labels
        with open(os.path.join(out_path, f"batch_{file_id}"), "wb") as f:
            pickle.dump({"label": labels, "data": data}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        file_id += 1
        data, labels = [], []

    with tarfile.open(data_file) as tf:
        for mem in tf.getmembers():
            if mem.name in img2label:
                data.append(tf.extractfile(mem).read())
                labels.append(img2label[mem.name])
                if len(data) == num_per_batch:
                    _flush()
    if data:
        _flush()
    with open(meta_file, "a") as meta:
        for fn in sorted(os.listdir(out_path)):
            meta.write(os.path.abspath(os.path.join(out_path, fn)) + "\n")
    return meta_file
