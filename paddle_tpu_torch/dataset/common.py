"""Dataset plumbing (counterpart of paddle_tpu/dataset/common.py; Paddle's
python/paddle/v2/dataset/common.py):
DATA_HOME cache dir, md5-checked download, and reader→recordio conversion.

``download`` fetches nothing: it only serves files already placed in
DATA_HOME (with md5 verification, Paddle's contract), the same
``PADDLE_TPU_DATA_HOME`` the JAX package reads, so a placed dataset serves
both packages;
each dataset module falls back to a deterministic synthetic generator of the
same sample schema when the canonical files are absent, keeping the v2
dataset API usable offline (the shapes/dtypes/readers are the parity
surface; the bytes are stand-ins).
"""

from __future__ import annotations

import hashlib
import os

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum):
    """Return the cached path for ``url`` if present and md5-valid.
    Raises FileNotFoundError otherwise (nothing is downloaded — drop the file into
    DATA_HOME/<module_name>/ manually to use the real dataset)."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(dirname, url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum is None or md5file(filename) == md5sum:
            return filename
        raise IOError(f"{filename}: md5 mismatch")
    raise FileNotFoundError(
        f"{filename} not cached and nothing is downloaded; "
        f"place the file there or use the synthetic fallback readers")


def have_file(url, module_name, md5sum=None):
    try:
        download(url, module_name, md5sum)
        return True
    except (FileNotFoundError, IOError):
        return False


def convert(output_path, reader, line_count=1000, name_prefix="dataset"):
    """reader → sharded recordio files ``output_path/name_prefix-00000``…
    with ``line_count`` pickled samples per shard (reference
    common.convert's layout; every dataset module's ``convert(path)``
    delegates here)."""
    from ..recordio import Writer, dumps

    os.makedirs(output_path, exist_ok=True)
    shard_paths = []
    writer, n_in_shard = None, 0

    def _shard_path(idx):
        return os.path.join(output_path, f"{name_prefix}-{idx:05d}")

    for sample in reader():
        if writer is None:
            shard_paths.append(_shard_path(len(shard_paths)))
            writer = Writer(shard_paths[-1])
        writer.write(dumps(sample))
        n_in_shard += 1
        if n_in_shard >= line_count:
            writer.close()
            writer, n_in_shard = None, 0
    if writer is not None:
        writer.close()
    return shard_paths
