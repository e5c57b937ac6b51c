"""UCI Boston housing dataset (reference python/paddle/v2/dataset/
uci_housing.py): readers yield (feature float32[13] normalized, price
float32[1]) — the fit_a_line book model's input. Synthetic fallback: a
fixed random linear model + noise over 13 features, same schema, trivially
learnable by linear regression.
"""

from __future__ import annotations

import os

import numpy as np

from . import common

URL = "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/housing.data"
FEATURE_DIM = 13
SYNTH_TRAIN, SYNTH_TEST = 404, 102


def _load_real():
    path = os.path.join(common.DATA_HOME, "uci_housing",
                        URL.split("/")[-1])
    data = np.loadtxt(path).astype(np.float32)
    feats, prices = data[:, :-1], data[:, -1:]
    mu, sigma = feats.mean(0), feats.std(0) + 1e-8
    return (feats - mu) / sigma, prices


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    w = np.linspace(-2, 2, FEATURE_DIM).astype(np.float32)
    feats = rng.normal(0, 1, (n, FEATURE_DIM)).astype(np.float32)
    prices = feats @ w[:, None] + 22.5 \
        + rng.normal(0, 0.5, (n, 1)).astype(np.float32)
    return feats, prices.astype(np.float32)


def _reader(start_frac, end_frac, synth_n, seed):
    def reader():
        if common.have_file(URL, "uci_housing"):
            feats, prices = _load_real()
            n = len(feats)
            feats = feats[int(start_frac * n):int(end_frac * n)]
            prices = prices[int(start_frac * n):int(end_frac * n)]
        else:
            feats, prices = _synthetic(synth_n, seed)
        for f, p in zip(feats, prices):
            yield f, p

    return reader


def train():
    return _reader(0.0, 0.8, SYNTH_TRAIN, 21)


def test():
    return _reader(0.8, 1.0, SYNTH_TEST, 23)


def convert(path):
    """Converts dataset to sharded recordio format (reference
    uci_housing.py:129)."""
    common.convert(path, train(), 1000, "uci_housing_train")
    common.convert(path, test(), 1000, "uci_housing_test")
