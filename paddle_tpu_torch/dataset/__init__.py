"""Canonical dataset modules in the v2 API shape (counterpart of
paddle_tpu/dataset/; Paddle's
python/paddle/v2/dataset/__init__.py): each module exposes reader creators
(train()/test()) yielding the reference's exact sample schema, reading real
cached files from DATA_HOME when present and deterministic synthetic
stand-ins otherwise (nothing is downloaded — see common.download).
"""

from . import (common, mnist, cifar, imdb, uci_housing, imikolov,
               movielens, conll05, flowers, voc2012, wmt14, wmt16, mq2007,
               sentiment)

# mirrors Paddle's python/paddle/v2/dataset/__init__.py __all__
__all__ = ["mnist", "imikolov", "imdb", "cifar", "movielens", "conll05",
           "sentiment", "uci_housing", "wmt14", "wmt16", "mq2007",
           "flowers", "voc2012", "common"]
