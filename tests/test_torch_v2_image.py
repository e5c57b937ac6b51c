"""v2/image.py in the port against the reference's, and dataset/flowers.py's
real-file path through it: decode, resize_short, the crops, the flip and
simple_transform (its train path under one seeded RandomState) give
bitwise the reference's arrays; batch_images_from_tar writes the same
batches; and the flowers readers over a small stand-in of the 102flowers
files (a JPEG tarball, imagelabels.mat, setid.mat) yield bitwise the
reference's samples."""

import io
import os
import pickle
import tarfile

import numpy as np
import pytest

PIL = pytest.importorskip("PIL.Image")

import paddle_tpu.v2.image as jimage  # noqa: E402
import paddle_tpu_torch.v2.image as timage  # noqa: E402


def _jpeg(rng, h, w):
    buf = io.BytesIO()
    PIL.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("shape", [(40, 30), (24, 52)])
def test_transforms_equal_the_reference(shape):
    rng = np.random.RandomState(sum(shape))
    data = _jpeg(rng, *shape)
    for is_color in (True, False):
        a = timage.load_image_bytes(data, is_color)
        b = jimage.load_image_bytes(data, is_color)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(timage.resize_short(a, 20),
                                      jimage.resize_short(b, 20))
        np.testing.assert_array_equal(timage.center_crop(a, 16, is_color),
                                      jimage.center_crop(b, 16, is_color))
        np.testing.assert_array_equal(timage.left_right_flip(a, is_color),
                                      jimage.left_right_flip(b, is_color))
        for is_train in (False, True):
            got = timage.simple_transform(
                a, 20, 16, is_train, is_color, mean=[1.0, 2.0, 3.0]
                if is_color else None, rng=np.random.RandomState(3))
            want = jimage.simple_transform(
                b, 20, 16, is_train, is_color, mean=[1.0, 2.0, 3.0]
                if is_color else None, rng=np.random.RandomState(3))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timage.to_chw(a[..., None]),
                                  jimage.to_chw(b[..., None]))


def test_batch_images_from_tar_writes_the_reference_batches(tmp_path):
    rng = np.random.RandomState(1)
    labels = {}
    tar = tmp_path / "imgs.tar"
    with tarfile.open(tar, "w") as tf:
        for i in range(5):
            data = _jpeg(rng, 8, 8)
            info = tarfile.TarInfo(f"img_{i}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            labels[info.name] = i % 2
    metas = []
    for mod, name in ((timage, "t"), (jimage, "j")):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "imgs.tar")
        os.link(tar, path)
        meta = mod.batch_images_from_tar(path, "set", labels,
                                         num_per_batch=2)
        metas.append([pickle.load(open(f.strip(), "rb"))
                      for f in open(meta)])
    assert metas[0] == metas[1] and len(metas[0]) == 3


@pytest.fixture
def flowers_home(tmp_path, monkeypatch):
    """A stand-in of the 102flowers files: 6 JPEGs of various sizes, their
    labels, and a split of 2 images each."""
    sio = pytest.importorskip("scipy.io")
    import paddle_tpu.dataset.common as jcommon
    import paddle_tpu_torch.dataset.common as tcommon
    base = tmp_path / "flowers"
    base.mkdir()
    rng = np.random.RandomState(5)
    with tarfile.open(base / "102flowers.tgz", "w:gz") as tf:
        for i in range(1, 7):
            data = _jpeg(rng, int(rng.randint(230, 300)),
                         int(rng.randint(230, 300)))
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    sio.savemat(base / "imagelabels.mat",
                {"labels": np.array([[3, 1, 102, 7, 7, 50]])})
    sio.savemat(base / "setid.mat", {"trnid": np.array([[1, 4]]),
                                     "tstid": np.array([[2, 6]]),
                                     "valid": np.array([[3, 5]])})
    for common in (jcommon, tcommon):
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    return base


@pytest.mark.parametrize("split", ["train", "test", "valid"])
def test_flowers_real_files_equal_the_reference(flowers_home, split):
    import paddle_tpu.dataset.flowers as jflowers
    import paddle_tpu_torch.dataset.flowers as tflowers
    assert tflowers._have_real() and jflowers._have_real()
    got = list(getattr(tflowers, split)()())
    want = list(getattr(jflowers, split)()())
    assert len(got) == len(want) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.shape == (3, 224, 224) and gi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        assert gl == wl
