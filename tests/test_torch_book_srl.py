"""The book chapter label_semantic_roles: db_lstm with its CRF against the
reference (cost and Viterbi paths too), and the book's contract with its
decode and chunk F1, on the port. The shared parity check and contract
runner are ``book_parity`` and ``book_contract`` in torch_cross.py, which
says what they hold."""

import pytest

from torch_cross import (book_contract, book_parity, contract_cases,
                         port_book)  # noqa: F401

CONTRACTS, IDS = contract_cases("test_label_semantic_roles_converges_and_decodes")


@pytest.mark.parametrize("chapter", ["srl"])
def test_chapter_trains_like_the_reference(chapter):
    book_parity(chapter)


@pytest.mark.parametrize("module,test,kwargs", CONTRACTS, ids=IDS)
def test_book_contract_on_the_port(port_book, tmp_path, module, test,
                                   kwargs):
    book_contract(port_book, tmp_path, module, test, kwargs)
