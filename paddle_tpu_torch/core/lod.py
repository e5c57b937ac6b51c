"""LoD (ragged-sequence) tensors as padded torch tensors (counterpart of
paddle_tpu/core/lod.py).

A LoD tensor is a ``LoDArray``: padded dense data of shape
[batch, max_len, ...] plus an int32 ``lens`` vector of true lengths, both
tensors on one device. Sequence ops mask with
``arange(max_len) < lens[:, None]`` instead of walking offsets. Nested LoD
keeps its outer levels as further int32 length vectors on the same device
(``outer_lens``), outermost first: each level's lengths sum to the number
of entries of the level below it, the innermost outer level's to
``batch``. The host helpers keep the reference's feed forms: a list of
per-sequence arrays (``pack_sequences``) or the flat concatenation plus an
offset table of one or more levels (``flat_to_lodarray`` /
``lodarray_to_flat``).
"""

from __future__ import annotations

import numpy as np
import torch


class LoDArray:
    """Padded device form of a LoD tensor (reference :33).

    data: [batch, max_len, *feature], zero past each row's length
    lens: [batch] int32 true sequence lengths (the innermost level)
    outer_lens: None (level 1), one [n_outer] int32 tensor (level 2), or a
        tuple of them, outermost first (level 3 and deeper)
    """

    __slots__ = ("data", "lens", "_outer")

    def __init__(self, data, lens, outer_lens=None):
        self.data = data
        self.lens = lens
        self.outer_lens = outer_lens

    @property
    def outer_lens(self):
        """None (level 1), the single outer tensor (level 2), or the
        outermost-first tuple (level 3+), as the reference's."""
        if not self._outer:
            return None
        if len(self._outer) == 1:
            return self._outer[0]
        return self._outer

    @outer_lens.setter
    def outer_lens(self, value):
        if value is None:
            self._outer = ()
        elif isinstance(value, (tuple, list)):
            self._outer = tuple(value)
        else:
            self._outer = (value,)

    @property
    def outer_levels(self):
        """Every outer level as a tuple, outermost first (empty at level
        1)."""
        return self._outer

    @property
    def batch(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    @property
    def lod_level(self):
        return 1 + len(self._outer)

    def mask(self, dtype=torch.float32):
        """[batch, max_len] 1/0 validity mask (reference :106): position <
        length."""
        pos = torch.arange(self.data.shape[1], device=self.lens.device)
        return (pos[None, :] < self.lens[:, None]).to(dtype)

    def row_to_outer(self, level=-1):
        """[n_below] int32: for each entry of the level below outer level
        ``level`` (default the innermost, whose entries are the data rows),
        the index of its group there (reference :111)."""
        lens = self._outer[level]
        n_below = self.data.shape[0] \
            if level in (-1, len(self._outer) - 1) \
            else self._outer[level + 1].shape[0]
        starts = torch.cumsum(lens.long(), 0)
        below = torch.arange(n_below, device=lens.device)
        return torch.searchsorted(starts, below, right=True).to(torch.int32)

    def with_data(self, data):
        """This array's levels around new padded ``data``."""
        return LoDArray(data, self.lens, self._outer or None)

    def __repr__(self):
        extra = (f", outer_lens={[o.tolist() for o in self._outer]}"
                 if self._outer else "")
        return (f"LoDArray(data={tuple(self.data.shape)}, "
                f"lens={self.lens.tolist()}{extra})")


def pack_sequences(seqs, dtype=None, max_len=None, pad_multiple=1):
    """List of [len_i, *feature] arrays -> a LoDArray of CPU tensors
    (reference :128). ``pad_multiple`` rounds max_len up to a multiple."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    ml = int(max_len if max_len is not None
             else (lens.max() if len(lens) else 0))
    if pad_multiple > 1:
        ml = -(-ml // pad_multiple) * pad_multiple
    ml = max(ml, 1)
    first = np.asarray(seqs[0])
    dt = dtype or first.dtype
    out = np.zeros((len(seqs), ml) + first.shape[1:], dtype=dt)
    for i, s in enumerate(seqs):
        s = np.asarray(s, dtype=dt)
        out[i, :len(s)] = s
    return LoDArray(torch.from_numpy(out), torch.from_numpy(lens))


def lod_from_lens(lens) -> list:
    """Lengths -> the reference's level-1 offsets [[0, l0, l0+l1, ...]]."""
    offs = np.concatenate([[0], np.cumsum(np.asarray(lens))]).astype(np.int64)
    return [offs.tolist()]


def lens_from_lod(lod) -> np.ndarray:
    offs = np.asarray(lod[0] if isinstance(lod[0], (list, tuple, np.ndarray))
                      else lod)
    return np.diff(offs).astype(np.int32)


def flat_to_lodarray(flat, lod, pad_multiple=1):
    """The reference's feed form (concatenated [sum_len, *feat] array and
    its offset table of one or more levels, outermost first) -> a LoDArray
    of CPU tensors (reference :160)."""
    lod = list(lod)
    if lod and not isinstance(lod[0], (list, tuple, np.ndarray)):
        lod = [lod]
    flat = np.asarray(flat)
    seqs, start = [], 0
    for n in lens_from_lod([lod[-1]]):
        seqs.append(flat[start:start + int(n)])
        start += int(n)
    arr = pack_sequences(seqs, dtype=flat.dtype, pad_multiple=pad_multiple)
    if len(lod) > 1:
        arr.outer_lens = tuple(torch.from_numpy(lens_from_lod([lvl]))
                               for lvl in lod[:-1])
    return arr


def _host(t):
    return np.asarray(t.cpu() if torch.is_tensor(t) else t)


def lodarray_to_flat(arr: LoDArray):
    """LoDArray -> (concatenated numpy array, offset table with every
    level, outermost first): the fetch boundary's unpacker (reference
    :180)."""
    data, lens = _host(arr.data), _host(arr.lens)
    parts = [data[i, :int(n)] for i, n in enumerate(lens)]
    flat = np.concatenate(parts, axis=0) if parts \
        else np.zeros((0,) + data.shape[2:], data.dtype)
    lod = lod_from_lens(lens)
    for lvl in reversed(arr.outer_levels):
        lod = lod_from_lens(_host(lvl)) + lod
    return flat, lod


__all__ = ["LoDArray", "pack_sequences", "lod_from_lens",
           "lens_from_lod", "flat_to_lodarray", "lodarray_to_flat"]
