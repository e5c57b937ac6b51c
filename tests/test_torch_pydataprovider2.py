"""The @provider protocol (paddle_tpu_torch/trainer/PyDataProvider2.py)
and v2.data_feeder against the reference's: each scenario of
tests/test_pydataprovider2.py (tuple and bare samples, dict reordering,
init_hook state, check mode, the per-pass cache, shuffling under one
``random`` seed, the should_shuffle typo) run by both packages' provider
gives the same rows; the port's paddle_trainer pulls batches from a
provider module named by define_py_data_sources2; and DataFeeder packs
the same feeds."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.trainer.PyDataProvider2 as jp2
import paddle_tpu_torch.trainer.PyDataProvider2 as tp2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tuples(m):
    @m.provider(input_types=[m.dense_vector(3), m.integer_value(5)],
                should_shuffle=False)
    def process(settings, filename):
        for i in range(4):
            yield np.full(3, i, "float32"), i % 5
    return list(process(["fileA", "fileB"])())


def _bare(m):
    @m.provider(input_types=[m.dense_vector(2)], should_shuffle=False)
    def process(settings, filename):
        yield np.zeros(2, "float32")
        yield np.ones(2, "float32")
    return list(process(["f"])())


def _dicts(m):
    @m.provider(input_types={"label": m.integer_value(3),
                             "img": m.dense_vector(2)},
                should_shuffle=False)
    def process(settings, filename):
        yield {"img": np.array([1.0, 2.0], "float32"), "label": 2}
        yield {"label": 1, "img": np.array([3.0, 4.0], "float32")}
    return list(process(["f"], input_order=["img", "label"])())


def _init_hook(m):
    def hook(settings, file_list, is_train, word_dict=None, **kw):
        settings.word_dict = word_dict
        settings.input_types = [m.integer_value(len(word_dict))]

    @m.provider(init_hook=hook, should_shuffle=False)
    def process(settings, filename):
        for w in ("a", "b", "a"):
            yield settings.word_dict[w]
    return list(process(["f"], word_dict={"a": 0, "b": 1})())


def _check_drops(m):
    @m.provider(input_types=[m.integer_value(2)], should_shuffle=False,
                check=True, check_fail_continue=True)
    def drops(settings, filename):
        yield 0
        yield 7
        yield 1
    return list(drops(["f"])())


def _cache(m):
    calls = []

    @m.provider(input_types=[m.integer_value(10)], should_shuffle=False,
                cache=m.CacheType.CACHE_PASS_IN_MEM)
    def process(settings, filename):
        calls.append(filename)
        for i in range(3):
            yield i
    p = process(["f", "g"])
    return [list(p()), list(p()), calls]


def _shuffled(m):
    @m.provider(input_types=[m.integer_value(100)])
    def process(settings, filename):
        for i in range(50):
            yield i
    random.seed(11)
    p = process(["f"], is_train=True)
    return [p.should_shuffle, process(["f"], is_train=False).should_shuffle,
            list(p()), list(p())]


SCENARIOS = {f.__name__[1:]: f for f in (_tuples, _bare, _dicts, _init_hook,
                                          _check_drops, _cache, _shuffled)}


def _plain(v):
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.tolist())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_plain(x) for x in v])
    return v


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_provider_gives_the_reference_rows(scenario):
    got, want = SCENARIOS[scenario](tp2), SCENARIOS[scenario](jp2)
    assert _plain(got) == _plain(want)


def test_check_mode_raises_and_shuffle_typo_raises():
    for m in (tp2, jp2):
        @m.provider(input_types=[m.integer_value(2)], should_shuffle=False,
                    check=True)
        def raises(settings, filename):
            yield 7

        with pytest.raises(AssertionError):
            list(raises(["f"])())

        @m.provider(input_types=[m.integer_value(10)],
                    should_shuffle="ture")
        def typo(settings, filename):
            yield 0

        with pytest.raises(ValueError, match="ture"):
            typo(["f"], is_train=True)


_PROVIDER_MOD = '''
import numpy as np
from paddle.trainer.PyDataProvider2 import (provider, dense_vector,
                                            integer_value)

@provider(input_types={"data": dense_vector(12), "label": integer_value(4)},
          should_shuffle=False)
def process(settings, filename):
    rng = np.random.RandomState(3)
    for i in range(64):
        x = rng.normal(0, 1, 12).astype("float32")
        yield {"data": x, "label": int(np.abs(x[:4]).argmax())}
'''.replace("from paddle.trainer", "from paddle_tpu_torch.trainer")

_CONFIG = '''
from paddle.trainer_config_helpers import *

settings(batch_size=16, learning_rate=0.1,
         learning_method=MomentumOptimizer(0.9))
define_py_data_sources2(train_list="train.list", test_list=None,
                        module="dataprovider", obj="process")
net = data_layer("data", size=12)
net = fc_layer(input=net, size=16, act=ReluActivation())
net = fc_layer(input=net, size=4, act=SoftmaxActivation())
lab = data_layer("label", 4)
outputs(classification_cost(input=net, label=lab))
'''


def test_trainer_cli_pulls_from_a_provider(tmp_path):
    """define_py_data_sources2 over a @provider module: the port's
    paddle_trainer --job=train pulls its batches from it."""
    (tmp_path / "dataprovider.py").write_text(_PROVIDER_MOD)
    (tmp_path / "cfg.py").write_text(_CONFIG)
    (tmp_path / "train.list").write_text("dummy-file\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, str(tmp_path)]))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.v2.trainer_cli",
         f"--config={tmp_path}/cfg.py", "--job=train", "--num_passes=3",
         "--use_gpu=false"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    costs = [float(ln.split("cost=")[1]) for ln in r.stdout.splitlines()
             if ln.startswith("Pass")]
    assert len(costs) == 3 and costs[-1] < costs[0], costs


def test_data_feeder_packs_the_reference_feeds():
    from paddle_tpu.v2 import data_feeder as jdf, data_type as jdt
    from paddle_tpu_torch.v2 import data_feeder as tdf, data_type as tdt
    rng = np.random.RandomState(2)
    batch = [(int(rng.randint(0, 10)), rng.normal(0, 1, 4).astype("f4"),
              rng.randint(0, 9, int(rng.randint(1, 5))).tolist())
             for _ in range(3)]
    feeds = []
    for dt, df in ((tdt, tdf), (jdt, jdf)):
        types = [("image", dt.dense_vector(4)),
                 ("label", dt.integer_value(10)),
                 ("words", dt.integer_value_sequence(9))]
        feeds.append(df.DataFeeder(types, feeding={
            "image": 1, "label": 0, "words": 2})(batch))
    got, want = feeds
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        if hasattr(w, "lens"):
            np.testing.assert_array_equal(np.asarray(g.data),
                                          np.asarray(w.data))
            np.testing.assert_array_equal(np.asarray(g.lens),
                                          np.asarray(w.lens))
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
