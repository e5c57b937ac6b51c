"""The double buffer (paddle_tpu_torch/reader/prefetch.py) against the
host feed: the ragged lane's batches staged through ``double_buffer`` give
losses bitwise those of the same batches fed from host numpy, from one
startup state, on the CPU and (``-m cuda``) on the card, where the staging
pins, copies on a stream of its own and hands over with an event. This
file imports no JAX, so that the card case runs where there is none."""

import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.reader import double_buffer, prefetch
from paddle_tpu_torch.testing import ragged_lane as lane


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_double_buffered_feed_is_bitwise_the_host_feed(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_reader_card.py on the GPU machine)")
    place = fluid.CPUPlace() if device == "cpu" else fluid.CUDAPlace(0)
    samples = lane.corpus(160, 50, (2, 4), (10, 12))
    batches = [(samples[i:i + 8], 12) for i in range(0, 160, 8)]
    fluid.reset_unique_name()
    main, startup, loss = lane.build(fluid, vocab=50, emb=8, hidden=16,
                                     seed=1)
    exe = fluid.Executor(place)
    losses = {}
    for how in ("host", "staged"):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        prefetch.reset_staged()
        if how == "host":
            feeds = (lane.feed_of(c, b) for c, b in batches)
        else:
            feeds = double_buffer(lambda: iter(batches), place=place,
                                  convert=lambda cb: lane.feed_of(*cb))()
        losses[how] = [exe.run(main, feed=f, fetch_list=[loss],
                               scope=scope)[0] for f in feeds]
        if how == "staged":
            assert prefetch.staged["batches"] == \
                (len(batches) if device == "cuda" else 0)
    assert len(losses["staged"]) == len(batches) == 20
    for a, b in zip(losses["host"], losses["staged"]):
        assert a.tobytes() == b.tobytes()
