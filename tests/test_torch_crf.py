"""The port's linear-chain CRF ops against the reference's on the same
seeded ragged batches: linear_chain_crf's negative log-likelihood and its
grad (Emission@GRAD with the emission's LoD, Transition@GRAD) within
rtol 1e-5 / atol 1e-6 of the largest element, crf_decoding's Viterbi
paths and its 0/1 correctness against a Label exact, ties included."""

import numpy as np
import pytest

from torch_cross import op_both

D = 5


def _batch(seed, lens, integer=False):
    """Emissions, labels and a [D+2, D] Transition for sequences of
    ``lens``; ``integer`` draws small integers so the Viterbi argmaxes
    meet exact ties."""
    rng = np.random.RandomState(seed)

    def draw(*shape):
        if integer:
            return rng.randint(-2, 3, shape).astype("float32")
        return rng.normal(0, 1.5, shape).astype("float32")

    return ([draw(n, D) for n in lens],
            [rng.randint(0, D, (n, 1)).astype("int64") for n in lens],
            draw(D + 2, D))


LENS = {"ragged": (4, 1, 7, 3, 7), "one_step": (1, 1)}


@pytest.mark.parametrize("lens", sorted(LENS))
def test_linear_chain_crf_and_grad(lens):
    em, lab, w = _batch(len(lens), LENS[lens])
    feeds = {"em": em, "lab": lab, "w": w}
    nll, = op_both("linear_chain_crf",
                   {"Emission": ["em"], "Transition": ["w"],
                    "Label": ["lab"]},
                   {"LogLikelihood": ["nll"]}, {}, feeds, lod=("em", "lab"))
    assert nll.shape == (len(em), 1) and np.all(nll > 0)
    d = np.random.RandomState(9).normal(0, 1, nll.shape).astype("float32")
    op_both("linear_chain_crf_grad",
            {"Emission": ["em"], "Transition": ["w"], "Label": ["lab"],
             "LogLikelihood@GRAD": ["d"]},
            {"Emission@GRAD": ["dem"], "Transition@GRAD": ["dw"]}, {},
            {**feeds, "d": d}, lod=("em", "lab"))


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("lens", sorted(LENS))
def test_crf_decoding(lens, integer):
    em, lab, w = _batch(3 + len(lens), LENS[lens], integer)
    (flat, lod), = op_both("crf_decoding",
                           {"Emission": ["em"], "Transition": ["w"]},
                           {"ViterbiPath": ["path"]}, {},
                           {"em": em, "w": w}, lod=("em",))
    assert flat.dtype == np.int64
    assert lod[-1] == list(np.cumsum([0] + list(LENS[lens])))
    op_both("crf_decoding",
            {"Emission": ["em"], "Transition": ["w"], "Label": ["lab"]},
            {"ViterbiPath": ["ok"]}, {}, {"em": em, "w": w, "lab": lab},
            lod=("em", "lab"))


def test_viterbi_path_is_the_best_path():
    """The decoded path of each sequence scores highest among all D^n
    paths (small n), by the [D+2, D] layout: start, end, transitions."""
    import paddle_tpu_torch.fluid as tfluid
    from torch_cross import run_op
    lens = (1, 2, 3)
    em, _, w = _batch(21, lens)
    (flat, _), = run_op(tfluid, "crf_decoding",
                        {"Emission": ["em"], "Transition": ["w"]},
                        {"ViterbiPath": ["path"]}, {}, {"em": em, "w": w},
                        lod=("em",))
    at = 0
    for e, n in zip(em, lens):
        def score(p):
            return (w[0, p[0]] + w[1, p[-1]] + sum(e[t, p[t]]
                                                   for t in range(n))
                    + sum(w[2 + p[t - 1], p[t]] for t in range(1, n)))
        best = max(np.ndindex(*([D] * n)), key=score)
        got = tuple(int(t) for t in flat[at:at + n].ravel())
        assert got == best, (got, best)
        at += n
