"""The port's dataset parsers (paddle_tpu_torch/dataset) against
tests/test_datasets.py's schemas, and against the JAX package's parsers:
the same module list, and every synthetic reader's first samples (and the
dictionaries they index) equal bit for bit."""

import os

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as dataset
from paddle_tpu_torch.recordio import loads, read_records


def _take(reader, n):
    out = []
    for i, s in enumerate(reader()):
        if i >= n:
            break
        out.append(s)
    assert out, "reader yielded nothing"
    return out


def _same(a, b, where="sample"):
    """Bitwise equality through tuples, lists, dicts and arrays."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(b, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(b, dict):
        assert list(a) == list(b), where
        for k in b:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_module_list_equals_the_reference():
    assert dataset.__all__ == jds.__all__
    for name in jds.__all__:
        assert hasattr(dataset, name), name


# (module, reader name, args (a callable of the package for dictionaries),
# samples compared)
READERS = [
    ("mnist", "train", (), 16), ("mnist", "test", (), 16),
    ("cifar", "train10", (), 8), ("cifar", "test10", (), 8),
    ("cifar", "train100", (), 8), ("cifar", "test100", (), 8),
    ("uci_housing", "train", (), 20), ("uci_housing", "test", (), 20),
    ("imikolov", "train", (lambda d: d.imikolov.build_dict(), 5), 20),
    ("imikolov", "test",
     (lambda d: d.imikolov.build_dict(), -1,
      lambda d: d.imikolov.DataType.SEQ), 10),
    ("imdb", "train", (lambda d: d.imdb.word_dict(),), 10),
    ("imdb", "test", (lambda d: d.imdb.word_dict(),), 10),
    ("movielens", "train", (), 20), ("movielens", "test", (), 20),
    ("conll05", "test", (), 10), ("conll05", "train", (), 10),
    ("sentiment", "train", (), 10), ("sentiment", "test", (), 10),
    ("wmt14", "train", (40,), 10), ("wmt14", "test", (40,), 10),
    ("wmt16", "train", (40, 40), 10), ("wmt16", "test", (40, 40), 10),
    ("wmt16", "validation", (40, 40), 5),
    ("mq2007", "train", (), 10), ("mq2007", "test", (), 4),
    ("flowers", "train", (), 2), ("flowers", "valid", (), 2),
    ("voc2012", "train", (), 2), ("voc2012", "val", (), 2),
]


def _reader(pkg, module, name, args):
    args = [a(pkg) if callable(a) else a for a in args]
    return getattr(getattr(pkg, module), name)(*args)


@pytest.mark.parametrize("module,name,args,n", READERS,
                         ids=[f"{m}.{r}" for m, r, _, _ in READERS])
def test_synthetic_samples_equal_the_reference(module, name, args, n):
    _same(_take(_reader(dataset, module, name, args), n),
          _take(_reader(jds, module, name, args), n), f"{module}.{name}")


@pytest.mark.parametrize("fmt", ["pointwise", "pairwise", "listwise"])
def test_mq2007_formats_equal_the_reference(fmt):
    _same(_take(dataset.mq2007.train(format=fmt), 8),
          _take(jds.mq2007.train(format=fmt), 8), fmt)


def test_dictionaries_equal_the_reference():
    for call in (lambda d: d.imikolov.build_dict(),
                 lambda d: d.imdb.word_dict(),
                 lambda d: d.conll05.get_dict(),
                 lambda d: d.conll05.get_embedding(),
                 lambda d: d.sentiment.get_word_dict(),
                 lambda d: d.movielens.get_movie_title_dict(),
                 lambda d: d.movielens.movie_categories(),
                 lambda d: (d.movielens.max_user_id(),
                            d.movielens.max_movie_id(),
                            d.movielens.max_job_id()),
                 lambda d: d.wmt14.get_dict(40, reverse=False),
                 lambda d: d.wmt16.get_dict("en", 40)):
        _same(call(dataset), call(jds), "dictionary")


def test_data_home_is_the_reference_variable():
    assert dataset.common.DATA_HOME == jds.common.DATA_HOME


def test_dataset_schemas():
    img, lbl = next(dataset.mnist.train()())
    assert img.shape == (784,) and img.dtype == np.float32
    assert -1.0 <= float(img.min()) and float(img.max()) <= 1.0
    assert isinstance(lbl, int) and 0 <= lbl <= 9
    img, lbl = next(dataset.cifar.train10()())
    assert img.shape == (3072,) and 0 <= lbl <= 9
    wd = dataset.imdb.word_dict()
    seq, sentiment = next(dataset.imdb.train(wd)())
    assert all(isinstance(t, int) and 0 <= t < len(wd) for t in seq)
    assert sentiment in (0, 1)
    feat, price = next(dataset.uci_housing.train()())
    assert feat.shape == (13,) and price.shape == (1,)


def test_imikolov_ngram_and_seq():
    word_idx = dataset.imikolov.build_dict()
    assert "<unk>" in word_idx and "<s>" in word_idx and "<e>" in word_idx
    for gram in _take(dataset.imikolov.train(word_idx, 5), 20):
        assert len(gram) == 5 and all(0 <= g < len(word_idx) for g in gram)
    for src, trg in _take(dataset.imikolov.test(
            word_idx, -1, dataset.imikolov.DataType.SEQ), 10):
        assert len(src) == len(trg)
        assert src[0] == word_idx["<s>"] and trg[-1] == word_idx["<e>"]


def test_movielens_and_conll05_schemas():
    n_cat = len(dataset.movielens.movie_categories())
    n_title = len(dataset.movielens.get_movie_title_dict())
    for s in _take(dataset.movielens.train(), 20):
        uid, gender, age, job, mid, cats, title, rating = s
        assert 1 <= uid <= dataset.movielens.max_user_id()
        assert 1 <= mid <= dataset.movielens.max_movie_id()
        assert gender in (0, 1) and 0 <= age < 7
        assert all(0 <= c < n_cat for c in cats)
        assert all(0 <= t < n_title for t in title)
        assert -5.0 <= rating[0] <= 5.0
    word_dict, _, label_dict = dataset.conll05.get_dict()
    assert dataset.conll05.get_embedding().shape[0] == len(word_dict)
    for s in _take(dataset.conll05.test(), 15):
        word, cn2, cn1, c0, cp1, cp2, pred, mark, label = s
        for seq in (cn2, cn1, c0, cp1, cp2, pred, mark, label):
            assert len(seq) == len(word)
        assert set(mark) <= {0, 1} and 1 in mark
        assert all(0 <= lb < len(label_dict) for lb in label)


def test_image_and_translation_schemas():
    for img, label in _take(dataset.flowers.train(), 2):
        assert img.shape == (3, 224, 224) and img.dtype == np.float32
        assert 0 <= label < 102
    for img, label in _take(dataset.voc2012.train(), 2):
        assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
        assert label.shape == img.shape[:2] and label.dtype == np.uint8
    for src, trg, trg_next in _take(dataset.wmt16.train(40, 40), 10):
        assert src[0] == 0 and src[-1] == 1 and trg[0] == 0
        assert trg_next[-1] == 1 and trg[1:] == trg_next[:-1]
    for label, better, worse in _take(
            dataset.mq2007.train(format="pairwise"), 10):
        assert label[0] == 1.0 and better.shape == worse.shape == (46,)


def test_dataset_convert_to_recordio(tmp_path):
    """convert(path) writes sharded recordio files through the port's
    recordio, which both packages read; samples round-trip."""
    from paddle_tpu.recordio import read_records as jread
    import pickle

    out = str(tmp_path / "rio")
    dataset.uci_housing.convert(out)
    shards = sorted(os.listdir(out))
    first = next(s for s in shards if s.startswith("uci_housing_train-"))
    path = os.path.join(out, first)
    x, y = loads(read_records(path)[0])
    want_x, want_y = next(dataset.uci_housing.train()())
    _same((x, y), (want_x, want_y))
    _same(pickle.loads(jread(path)[0]), (want_x, want_y))
    ref = str(tmp_path / "ref")
    jds.uci_housing.convert(ref)
    assert sorted(os.listdir(ref)) == shards
    for s in shards:
        assert open(os.path.join(ref, s), "rb").read() == \
            open(os.path.join(out, s), "rb").read(), s
    for mod in (dataset.mnist, dataset.cifar, dataset.conll05, dataset.imdb,
                dataset.imikolov, dataset.movielens, dataset.sentiment,
                dataset.uci_housing, dataset.wmt14, dataset.wmt16):
        assert callable(getattr(mod, "convert"))
