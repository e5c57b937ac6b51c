"""The tests/book contracts of fit_a_line, machine translation, the memory
passes, word2vec and recognize_digits' v2 variant, run with the port's
fluid in the reference's place (``book_contract`` in torch_cross.py says
how; the reference modules a contract imports inside its body are the
port's there). The parallel variant runs on 8 ranks:
test_torch_book_parallel.py."""

import pytest

from torch_cross import book_contract, contract_cases, port_book  # noqa: F401

CONTRACTS, IDS = contract_cases(
    "test_fit_a_line_converges",
    "test_machine_translation_train_and_beam_decode",
    "test_memopt_fit_a_line_matches_unoptimized",
    "test_memopt_conv_classifier_converges",
    "test_recognize_digits_v2_style_with_infer",
    "test_word2vec_converges")


@pytest.fixture
def _v2_on_the_cpu():
    """v2's entry points default to the card; the contracts run here."""
    from paddle_tpu_torch import v2
    from paddle_tpu_torch.v2 import inference
    old = dict(inference._INIT)
    v2.init(use_gpu=False)
    yield
    inference._INIT.clear()
    inference._INIT.update(old)


@pytest.mark.parametrize("module,test,kwargs", CONTRACTS, ids=IDS)
def test_book_contract_on_the_port(port_book, tmp_path, _v2_on_the_cpu,
                                   module, test, kwargs):
    book_contract(port_book, tmp_path, module, test, kwargs)
