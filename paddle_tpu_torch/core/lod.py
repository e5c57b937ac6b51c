"""Level-1 LoD (ragged-sequence) tensors as padded torch tensors
(counterpart of paddle_tpu/core/lod.py).

A LoD tensor is a ``LoDArray``: padded dense data of shape
[batch, max_len, ...] plus an int32 ``lens`` vector of true lengths, both
tensors on one device. Sequence ops mask with
``arange(max_len) < lens[:, None]`` instead of walking offsets. The host
helpers keep the reference's feed forms: a list of per-sequence arrays
(``pack_sequences``) or the flat concatenation plus an offset table
(``flat_to_lodarray`` / ``lodarray_to_flat``).

Only the innermost level is ported; the reference's nested outer levels
(``outer_lens``) wait for the multi-level LoD ops.
"""

from __future__ import annotations

import numpy as np
import torch


class LoDArray:
    """Padded device form of a level-1 LoD tensor (reference :33).

    data: [batch, max_len, *feature], zero past each row's length
    lens: [batch] int32 true sequence lengths
    """

    __slots__ = ("data", "lens")

    def __init__(self, data, lens):
        self.data = data
        self.lens = lens

    @property
    def batch(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    def mask(self, dtype=torch.float32):
        """[batch, max_len] 1/0 validity mask (reference :106): position <
        length."""
        pos = torch.arange(self.data.shape[1], device=self.lens.device)
        return (pos[None, :] < self.lens[:, None]).to(dtype)

    def __repr__(self):
        return (f"LoDArray(data={tuple(self.data.shape)}, "
                f"lens={self.lens.tolist()})")


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
    its offset table) -> a LoDArray of CPU tensors (reference :160)."""
    lod = list(lod)
    if len(lod) > 1 and isinstance(lod[0], (list, tuple, np.ndarray)):
        raise NotImplementedError(
            "nested (multi-level) LoD is not ported yet; feed level-1 "
            "offsets [[0, l0, l0+l1, ...]]")
    flat = np.asarray(flat)
    seqs, start = [], 0
    for n in lens_from_lod(lod):
        seqs.append(flat[start:start + int(n)])
        start += int(n)
    return pack_sequences(seqs, dtype=flat.dtype, pad_multiple=pad_multiple)


def lodarray_to_flat(arr: LoDArray):
    """LoDArray -> (concatenated numpy array, offset table): the fetch
    boundary's unpacker (reference :180)."""
    data = np.asarray(arr.data.cpu() if torch.is_tensor(arr.data)
                      else arr.data)
    lens = np.asarray(arr.lens.cpu() if torch.is_tensor(arr.lens)
                      else arr.lens)
    parts = [data[i, :int(n)] for i, n in enumerate(lens)]
    flat = np.concatenate(parts, axis=0) if parts \
        else np.zeros((0,) + data.shape[2:], data.dtype)
    return flat, lod_from_lens(lens)


__all__ = ["LoDArray", "pack_sequences", "lod_from_lens",
           "lens_from_lod", "flat_to_lodarray", "lodarray_to_flat"]
