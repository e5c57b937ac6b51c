"""Checkpoint-compatibility helpers for weights trained in the reference.

Gate-layout contract divergence (documented in ops/rnn_ops.py): this
framework's LSTM weight/projected-input column order is [i, f, c, o]
(input, forget, candidate, output), while the reference's dynamic LSTM
weight layout is {W_ch, W_ih, W_fh, W_oh} = [c, i, f, o]
(paddle/fluid/operators/lstm_op.cc:125). GRU needs no
conversion — both use [u, r, c] and the same update
formula h = u*c + (1-u)*h_prev.

Use these to import reference-trained LSTM parameters; exporting back is
the same permutation (it is its own inverse composed appropriately via
``inverse=True``).
"""

from __future__ import annotations

import numpy as np

# reference column-block order -> ours:  ref [c, i, f, o], ours [i, f, c, o]
_REF_TO_OURS = (1, 2, 0, 3)   # ours[k] = ref[_REF_TO_OURS[k]]
_OURS_TO_REF = (2, 0, 1, 3)


def _permute_gate_blocks(arr, axis, perm):
    arr = np.asarray(arr)
    H4 = arr.shape[axis]
    if H4 % 4:
        raise ValueError(f"axis {axis} size {H4} is not a multiple of 4")
    H = H4 // 4
    blocks = np.split(arr, 4, axis=axis)
    return np.concatenate([blocks[p] for p in perm], axis=axis)


def convert_reference_lstm_weight(weight, axis=-1, inverse=False):
    """Permute an LSTM gate-blocked weight between reference ([c,i,f,o]) and
    this framework's ([i,f,c,o]) column order.

    Applies to the recurrent weight [H, 4H], and to the input-projection fc
    weight [D, 4H] that feeds ``dynamic_lstm`` (permute ``axis=-1`` in both
    cases).  ``inverse=True`` converts ours -> reference for export.
    """
    perm = _OURS_TO_REF if inverse else _REF_TO_OURS
    return _permute_gate_blocks(weight, axis, perm)


def convert_reference_lstm_bias(bias, peepholes=False, inverse=False):
    """Permute an LSTM bias [1, 4H] (or, with ``peepholes=True``, [1, 7H]:
    the first 4H gate biases are permuted, the 3 peephole blocks
    [Wic, Wif, Woc] after them are kept in place — lstm_op.cc:127-135).

    ``peepholes`` must be passed explicitly: shape alone cannot distinguish
    4H from 7H when H is a multiple of 4 (e.g. H=128 gives 896 = 7*128 =
    4*224)."""
    bias = np.asarray(bias)
    n = bias.shape[-1]
    perm = _OURS_TO_REF if inverse else _REF_TO_OURS
    if peepholes:
        if n % 7:
            raise ValueError(f"peephole bias size {n} is not a multiple of 7")
        H = n // 7
        gates = _permute_gate_blocks(bias[..., :4 * H], -1, perm)
        return np.concatenate([gates, bias[..., 4 * H:]], axis=-1)
    return _permute_gate_blocks(bias, -1, perm)
