"""The port's ahead-of-time export on the card (``-m cuda``; JAX-free, so
that it runs where there is none): an artifact exported by an Executor on
the card loads there and launches the kernels through their operators.
On the GPU machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_aot_card.py``."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import aot
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
from paddle_tpu_torch.ops.cuda import rnn
from paddle_tpu_torch.testing.models import lstm_textcls, resnet


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_aot_card.py on the GPU "
                    "machine)")


def _export(tmp_path, build, feed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup):
        out = build()
    fluid.fuse_conv_bn(main)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    manifest = aot.export_inference_artifact(str(tmp_path), [feed], [out],
                                             exe, main_program=main,
                                             scope=scope)
    return aot.load_inference_artifact(str(tmp_path)), manifest


@pytest.mark.cuda
def test_fused_convnet_artifact_launches_conv_affine(tmp_path):
    _need_card()

    def build():
        img = fluid.layers.data("img", shape=[32, 32, 3])
        return fluid.layers.softmax(resnet(img, 10, counts=(1, 1, 1, 1),
                                           base=8))
    art, manifest = _export(tmp_path, build, "img")
    assert manifest["device"] == "cuda:0"
    x = np.random.RandomState(0).normal(0, 1, (4, 32, 32, 3)) \
        .astype("float32")
    cbk.reset_launches()
    out, = art.run({"img": x})
    assert cbk.launches["conv_affine"] == 13
    np.testing.assert_allclose(out.sum(1), 1.0, atol=1e-5)


@pytest.mark.cuda
def test_lstm_artifact_launches_lstm_seq_at_two_lengths(tmp_path):
    _need_card()

    def build():
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        return lstm_textcls(words, vocab=50, emb=8, hidden=32)
    art, manifest = _export(tmp_path, build, "words")
    assert manifest["dims"]["b"] == [1, rnn.MAX_BATCH]
    rng = np.random.RandomState(1)
    for lens in ((4, 9, 2), (17,)):
        seqs = [rng.randint(0, 50, (n, 1)).astype("int64") for n in lens]
        rnn.reset_launches()
        out, = art.run({"words": seqs})
        assert rnn.launches["lstm_seq"] == 2
        assert out.shape == (len(lens), 2)


@pytest.mark.cuda
def test_artifact_runs_under_the_exporting_tf32_switches(tmp_path):
    """The artifact records the exporting process's TF32 switches and runs
    under them: exported with TF32 off, it replies bitwise what the
    Executor replies with TF32 off, in a process that has TF32 on (the
    plain stem conv is cuDNN's, whose bits TF32 moves)."""
    _need_card()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", shape=[32, 32, 3])
            out = fluid.layers.softmax(resnet(img, 10, counts=(1, 1, 1, 1),
                                              base=8))
        test = main.clone(for_test=True)
        fluid.fuse_conv_bn(test)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        x = np.random.RandomState(0).normal(0, 1, (4, 32, 32, 3)) \
            .astype("float32")
        want, = exe.run(test, feed={"img": x}, fetch_list=[out],
                        scope=scope)
        manifest = aot.export_inference_artifact(
            str(tmp_path), ["img"], [out], exe, main_program=test,
            scope=scope)
        assert manifest["tf32"] == {"matmul": False, "cudnn": False}
        art = aot.load_inference_artifact(str(tmp_path))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        got, = art.run({"img": x})
        assert np.array_equal(got, want)
        assert torch.backends.cudnn.allow_tf32      # the caller's, restored
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_generation_phase_programs_launch_paged_attention(tmp_path):
    """The generation engine's exported phase programs on the card: a
    second engine loads every (phase, bucket) (its warmup runs no op
    loop), its greedy tokens are bitwise the op loop's, and every decode
    dispatch launches paged_attention once a layer from inside the
    exported decode program."""
    _need_card()
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.testing.models import export_tiny_lm

    d = str(tmp_path / "lm")
    export_tiny_lm(d, vocab=17, emb=32, heads=2, n_layers=2, max_pos=64,
                   seed=3)
    geom = dict(max_seqs=2, block_size=4, num_blocks=32, max_len=32,
                prefill_buckets=(8,))
    cache = str(tmp_path / "cache")

    def tokens(eng):
        out = []
        for prompt in ([3, 5, 7], [1, 2, 3, 4, 5]):
            h, toks, fin = eng.start(prompt, 10)
            got = list(toks)
            while not fin:
                for hh, tt, ff in eng.step():
                    if hh is h:
                        got += tt
                        fin = ff
            out.append(got)
        return out

    eager = GenerationEngine(d, exec_cache=False, **geom)
    eager.warmup()
    want = tokens(eager)
    GenerationEngine(d, exec_cache=cache, **geom).warmup()
    warm = GenerationEngine(d, exec_cache=cache, **geom)
    assert warm.warmup() == 0 and warm.stats()["warm_loaded"] == 2
    d0 = warm.stats()["phases"]["decode"][2]["dispatches"]
    pak.reset_launches()
    assert tokens(warm) == want
    decodes = warm.stats()["phases"]["decode"][2]["dispatches"] - d0
    assert decodes > 0 and pak.launches["paged_attention"] == 2 * decodes
    assert warm.stats()["exec_cache"]["rejects"]["run_failed"] == 0
