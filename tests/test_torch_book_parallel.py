"""tests/book/test_recognize_digits.py's parallel variant on the port: the
book MLP trained SPMD by ``shard_program_step`` over an 8-rank dp mesh
(gloo ranks on the CPU, each fed its rows by ``place_feed``) must reach
the reference contract's accuracy. The contract runs unchanged on every
rank, with the port's fluid, dataset and parallel modules in the
reference's place (tests/torch_book_ranks.py)."""

import os
import pathlib

from paddle_tpu_torch.parallel.launch import RankPool

import torch_book_ranks
from torch_cross import contract_cases

TESTS = str(pathlib.Path(__file__).resolve().parent)


def test_recognize_digits_parallel_matches_reference_variant():
    (module, test, kwargs), = contract_cases(
        "test_recognize_digits_parallel_matches_reference_variant")[0]
    path = os.pathsep.join(p for p in (TESTS, os.environ.get("PYTHONPATH"))
                           if p)
    with RankPool(8, "gloo", timeout=300, env={"PYTHONPATH": path}) as pool:
        done = pool.run(torch_book_ranks.run_contract, module, test)
    assert done == [True] * 8
