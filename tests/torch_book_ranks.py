"""Rank-side runner of a tests/book contract with the port (the ranks of
tests/test_torch_book_parallel.py's RankPool import this module: it
imports nothing of JAX or of the reference package).

The contract's module imports ``paddle_tpu.fluid``, ``paddle_tpu.dataset``
and, in its body, ``paddle_tpu.parallel``; in a rank those names are the
port's modules (a stand-in ``paddle_tpu`` package holds them), so the
contract builds, shards and trains with the port. The contract makes its
executor without a place, which names the card in the port; the ranks run
on the CPU, so an unplaced executor resolves to the CPU here."""

import importlib.util
import pathlib
import sys
import types

BOOK = pathlib.Path(__file__).resolve().parent / "book"


def _port_in_place_of_the_reference():
    import paddle_tpu_torch.dataset as dataset
    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.parallel as parallel
    import torch
    from paddle_tpu_torch.core import executor

    stand_in = types.ModuleType("paddle_tpu")
    stand_in.__path__ = []
    for name, mod in (("fluid", fluid), ("dataset", dataset),
                      ("parallel", parallel)):
        setattr(stand_in, name, mod)
        sys.modules[f"paddle_tpu.{name}"] = mod
    sys.modules["paddle_tpu"] = stand_in
    real = executor.resolve_device
    executor.resolve_device = lambda place=None: (
        torch.device("cpu") if place is None else real(place))
    # tests/book/conftest.py's verifier settings
    fluid.set_flags({"verify_passes": True, "executor_verify": True})


def run_contract(module, test):
    """``test`` of tests/book/``module``.py on this rank, with the port."""
    _port_in_place_of_the_reference()
    spec = importlib.util.spec_from_file_location(
        f"_port_book_{module}", BOOK / f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    getattr(mod, test)()
    return True
