"""The port's program verifier and lint (paddle_tpu_torch/fluid/analysis)
against the reference's (paddle_tpu/fluid/analysis), on the CPU.

The cases of tests/test_program_verify.py whose ops the port registers,
built with the port's front end: known-good programs verify silently, each
programmatic corruption is caught with its stable PTL code and
provenance, and the wiring (verify_passes, executor_verify, the load-time
check, the command line) behaves as the reference's. Every program here is
also held across packages: the port's program goes through ``to_dict``
into the reference's ``Program.from_dict``, and both packages'
``verify_program(..., raise_on_error=False)`` and ``lint_program`` must
give the same (code, severity, block, op index, op type, var) lists.

The tensor-array arena case runs with and without its ``accuracy`` op
(its reference-mandated ``Out`` slot), and While programs (the sub-block,
its grad, a var dropped inside the block), the Seq2Seq NMT train and
decode programs and the book chapters' training programs are held the
same way.

The transpiled trainer and pserver startup programs (the
DistributeTranspiler's output, verified by the transpiler itself under
verify_passes) are held the same way, per-parameter and fused.

The memory-optimized program is held in
tests/test_torch_memory_optimization.py
(``test_memory_optimized_program_verifies_clean``). Left out, with the
module that brings each (ROADMAP §A): the OpTest harness (A8) and
``create_var``'s redefinition checks (framework, not the verifier).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.framework import Program as JProgram

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.analysis import (ProgramVerifyError, lint_program,
                                             verify_program)
from paddle_tpu_torch.fluid.analysis import diagnostics as D
from paddle_tpu_torch.fluid.analysis.verify import verify_calls
from paddle_tpu_torch.testing import models as M
from paddle_tpu_torch.testing.models import (build_mlp, build_convnet_slice,
                                             mlp_feed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _flags_off():
    yield
    fluid.set_flags({"verify_passes": False, "executor_verify": False})


def _codes(diags):
    return {d.code for d in diags}


def _find(diags, code):
    hits = [d for d in diags if d.code == code]
    assert hits, f"expected a {code} diagnostic, got " \
                 f"{[str(d) for d in diags]}"
    return hits[0]


def _key(diags):
    return [(d.code, d.severity, d.block_idx, d.op_idx, d.op_type, d.var)
            for d in diags]


def _parity(program, startup=None, feed_names=(), fetch_names=()):
    """Both packages' verifier and lint on the same serialized program
    must agree finding for finding. Returns the port's verify list."""
    jprog = JProgram.from_dict(program.to_dict())
    jstart = JProgram.from_dict(startup.to_dict()) if startup else None
    got = verify_program(program, feed_names=feed_names,
                         fetch_names=fetch_names, startup_program=startup,
                         raise_on_error=False)
    want = jfluid.verify_program(jprog, feed_names=feed_names,
                                 fetch_names=fetch_names,
                                 startup_program=jstart,
                                 raise_on_error=False)
    assert _key(got) == _key(want), ([str(d) for d in got],
                                     [str(d) for d in want])
    lint_got = lint_program(program, fetch_names=fetch_names)
    lint_want = jfluid.lint_program(jprog, fetch_names=fetch_names)
    assert _key(lint_got) == _key(lint_want), (
        [str(d) for d in lint_got], [str(d) for d in lint_want])
    return got


def _verify_errors(program, **kw):
    return [d for d in _parity(program, **kw) if d.severity == D.ERROR]


# ---------------------------------------------------------------------------
# clean programs verify silently
# ---------------------------------------------------------------------------

def test_clean_mlp_with_backward_and_optimizer():
    main, startup, _loss = build_mlp()
    assert _parity(main, startup=startup) == []
    assert _parity(startup) == []


def test_clean_convnet_and_fused_variant():
    main, startup, _loss = build_convnet_slice(bottleneck=True)
    assert _verify_errors(main, startup=startup) == []
    main2, startup2 = fluid.Program(), fluid.Program()
    with fluid.program_guard(main2, startup2):
        img = fluid.layers.data("img", shape=[8, 8, 3])
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                                bias_attr=False, data_format="NHWC")
        b = fluid.layers.batch_norm(c, act=None, data_layout="NHWC")
        out = fluid.layers.relu(b)
    fluid.set_flags({"verify_passes": True})
    assert fluid.fuse_conv_bn(main2) == 1
    assert _verify_errors(main2, fetch_names=[out.name]) == []


def test_clean_decode_engine_clones(tmp_path):
    from paddle_tpu_torch.serving.generate.decode_engine import \
        GenerationEngine
    M.export_tiny_lm(str(tmp_path / "lm"), place=fluid.CPUPlace())
    fluid.set_flags({"verify_passes": True})
    base = verify_calls()
    eng = GenerationEngine(str(tmp_path / "lm"), place=fluid.CPUPlace(),
                           max_seqs=2, max_len=32, block_size=4,
                           num_blocks=32, prefix_cache_blocks=4)
    # the load and the three phase rewrites each verified once
    assert verify_calls() == base + 4
    feeds = ["tokens", "positions"]
    for p in (eng._prefill_program, eng._decode_program,
              eng._chunk_program):
        assert _verify_errors(p, feed_names=feeds) == []


def test_clean_tensor_array_arena():
    """write_to_array's lazy-allocating Array read is an arena allocation
    site, not a use before definition, but only while the op rebinds the
    same name as its output (tests/test_program_verify.py:123, without its
    accuracy op)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        pred = fluid.layers.fc(x, size=3, act="softmax")
        i = fluid.layers.fill_constant(shape=(), dtype="int64", value=0)
        arr = fluid.layers.array_write(pred, i, cap=4)
        fluid.layers.array_read(arr, i)
    assert _verify_errors(main, startup=startup) == []
    block = main.global_block()
    wop = next(op for op in block.ops if op.type == "write_to_array")
    block.create_var(name="arr_detached", dtype=pred.dtype)
    wop.outputs["Out"] = ["arr_detached"]
    main._bump_version()
    d = _find(_verify_errors(main, startup=startup), D.USE_BEFORE_DEF)
    assert d.op_type == "write_to_array"


def test_clean_accuracy_and_tensor_array_arena():
    """tests/test_program_verify.py:123 in full: accuracy's
    reference-mandated 'Out' input slot verifies clean beside the lazy
    arena; the rebinding broken, the uninitialized read is PTL004."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred = fluid.layers.fc(x, size=3, act="softmax")
        fluid.layers.accuracy(input=pred, label=label)
        i = fluid.layers.fill_constant(shape=(), dtype="int64", value=0)
        arr = fluid.layers.array_write(pred, i, cap=4)
        fluid.layers.array_read(arr, i)
    assert _verify_errors(main, startup=startup) == []
    block = main.global_block()
    wop = next(op for op in block.ops if op.type == "write_to_array")
    block.create_var(name="arr_detached", dtype=pred.dtype)
    wop.outputs["Out"] = ["arr_detached"]
    main._bump_version()
    d = _find(_verify_errors(main, startup=startup), D.USE_BEFORE_DEF)
    assert d.op_type == "write_to_array"


def test_accuracy_slot_arity_is_checked():
    """accuracy's spec (installed now that the op is ported): a second
    Label var is a PTL002 arity error in both packages."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        fluid.layers.accuracy(input=fluid.layers.fc(x, 3, act="softmax"),
                              label=label)
    block = main.global_block()
    acc = next(op for op in block.ops if op.type == "accuracy")
    acc.inputs["Label"] = [label.name, label.name]
    main._bump_version()
    d = _find(_verify_errors(main, startup=startup), D.SLOT_ARITY)
    assert d.op_type == "accuracy"


@pytest.mark.parametrize("fused", [False, True])
def test_clean_transpiled_trainer_and_pserver_startup(fused):
    """tests/test_program_verify.py's transpiled case: the trainer
    program (optimize and accumulator ops stripped) and each endpoint's
    pruned startup verify clean, under verify_passes, in both packages;
    also from the fused_momentum form of the same model."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("img", shape=[16])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = fluid.layers.fc(fluid.layers.fc(x, 32, act="relu"), 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(0.1, 0.9, fused=fused).minimize(
            loss, startup)
    eps = "127.0.0.1:6174,127.0.0.1:6175"
    t = fluid.DistributeTranspiler()
    fluid.set_flags({"verify_passes": True})
    try:
        t.transpile(0, program=main, startup_program=startup, pservers=eps,
                    trainers=1)
        trainer = t.get_trainer_program()
        pstartups = [t.get_startup_program(e) for e in eps.split(",")]
    finally:
        fluid.set_flags({"verify_passes": False})
    assert _verify_errors(trainer, startup=startup) == []
    for pstartup in pstartups:
        assert _verify_errors(pstartup) == []


@pytest.mark.parametrize("chapter", ["digits_conv", "cifar_vgg",
                                     "sentiment_conv", "sentiment_lstm",
                                     "srl", "recommender"])
def test_clean_book_chapter_programs(chapter):
    """The book chapters' training programs (dropout, the sequence convs,
    the CRF, cos_sim, the metric ops) verify and lint as the reference
    does, their startups too."""
    build = {
        "digits_conv": lambda: M.digits_conv(fluid, filters=(4, 8)),
        "cifar_vgg": lambda: M.cifar_vgg(
            fluid, blocks=((4, 2, (0.3, 0.0)),), fc=8),
        "sentiment_conv": lambda: M.sentiment_conv(fluid, 30, emb=4, hid=4),
        "sentiment_lstm": lambda: M.sentiment_lstm(fluid, 30, emb=4,
                                                   hid=16),
        "srl": lambda: M.srl_db_lstm(fluid, 20, 5, 7, word_dim=4,
                                     mark_dim=2, hidden=16, depth=2),
        "recommender": lambda: M.recommender(fluid, 10, 4, 12, 5, 20),
    }[chapter]
    main, startup, v = build()
    assert _verify_errors(main, startup=startup,
                          fetch_names=[v["loss"].name]) == []
    assert _verify_errors(startup) == []


def _while_program(max_iters):
    """An fc accumulated in a While over slices staged in a tensor array,
    with its backward and SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3, 5])
        y = fluid.layers.data("y", shape=[2])
        pieces = fluid.layers.split(x, 3, dim=1)
        arr = None
        for t in range(3):
            it = fluid.layers.fill_constant(shape=[1], dtype="int64", value=t)
            arr = fluid.layers.array_write(
                fluid.layers.reshape(pieces[t], [4, 5]), it, array=arr,
                cap=3)
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="int64", value=3)
        acc = fluid.layers.fill_constant(shape=[4, 2], dtype="float32",
                                         value=0.0)
        cond = fluid.layers.less_than(i, limit)
        w = fluid.layers.While(cond, max_iters=max_iters)
        with w.block():
            h = fluid.layers.fc(fluid.layers.array_read(arr, i), size=2,
                                act="tanh")
            fluid.layers.assign(fluid.layers.elementwise_add(acc, h),
                                output=acc)
            fluid.layers.increment(i, value=1)
            fluid.layers.less_than(i, limit, cond=cond)
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(acc, y)))
        fluid.optimizer.SGD(0.1).minimize(loss, startup)
    return main, startup, loss


@pytest.mark.parametrize("max_iters", [3, None], ids=["max_iters",
                                                      "derived"])
def test_while_program_verifies_clean_and_runs(max_iters):
    fluid.set_flags({"verify_passes": True})
    base = verify_calls()
    main, startup, loss = _while_program(max_iters)
    assert verify_calls() > base            # append_backward verified
    assert len(main.blocks) == 2
    assert _verify_errors(main, startup=startup, feed_names=["x", "y"],
                          fetch_names=[loss.name]) == []
    rng = np.random.RandomState(0)
    feed = {"x": rng.normal(0, 1, (4, 3, 5)).astype("float32"),
            "y": rng.normal(0, 1, (4, 2)).astype("float32")}
    loss_v, = _run_verified(main, startup, feed, [loss], False)
    assert np.isfinite(loss_v).all()


def test_mutation_var_dropped_inside_while_block_PTL003():
    """A var the loop body reads, dropped from every block: caught at the
    while op that lists it (block 0) and inside the sub-block (block 1) at
    the reading op, as the reference's."""
    main, startup, loss = _while_program(3)
    sub = main.blocks[1]
    op_idx, op = next((k, o) for k, o in enumerate(sub.ops)
                      if o.type == "mul")
    victim = op.input("Y")[0]
    for b in main.blocks:
        b.vars.pop(victim, None)
    main._bump_version()
    found = {(d.block_idx, d.op_type, d.op_idx)
             for d in _verify_errors(main, startup=startup,
                                     feed_names=["x", "y"],
                                     fetch_names=[loss.name])
             if d.code == D.UNDEFINED_VAR and d.var == victim}
    assert (1, "mul", op_idx) in found
    assert any(b == 0 and t == "while" for b, t, _ in found), found


def test_nmt_programs_verify_clean():
    """The Seq2Seq NMT model's train program (verified by append_backward
    under verify_passes) and its beam-search decode program (While,
    tensor arrays, beam_search_decode)."""
    fluid.set_flags({"verify_passes": True})
    base = verify_calls()
    main, startup, loss, _ = M.nmt_train_program(fluid)
    assert verify_calls() > base
    assert _verify_errors(main, startup=startup,
                          feed_names=["src", "trg", "trg_next"],
                          fetch_names=[loss.name]) == []
    dmain, dstartup, sent_ids, sent_scores, _ = M.nmt_decode_program(
        fluid, 4)
    assert _verify_errors(
        dmain, startup=dstartup,
        feed_names=["src", "init_ids", "init_scores", "state_seed"],
        fetch_names=[sent_ids.name, sent_scores.name]) == []
    assert _verify_errors(startup) == [] and _verify_errors(dstartup) == []


def test_slot_catalogue_installs_39_of_39_specs():
    """The catalogue installs a spec for every op type the port registers:
    all 39 since delete_var was ported (35 before dropout, matmul and
    accuracy were, 38 until delete_var was)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.fluid.analysis import slots
    installed = [t for t in slots._SPECS if registry.has_op(t)
                 and registry.get_op_info(t).slots is not None]
    assert len(slots._SPECS) == 39 and len(installed) == 39
    assert registry.get_op_info("delete_var").slots.inputs == {"X": "+"}
    assert registry.get_op_info("reshape").slots.inputs == {"X": "1"}
    assert registry.get_op_info("accuracy").slots.inputs == {
        "Out": "1", "Indices": "1", "Label": "1"}


# ---------------------------------------------------------------------------
# defect classes: each caught with its stable code + provenance
# ---------------------------------------------------------------------------

def test_mutation_unknown_op_type_PTL001():
    main, _s, _l = build_mlp()
    block = main.global_block()
    victim = next(i for i, op in enumerate(block.ops) if op.type == "mul")
    block.ops[victim].type = "totally_bogus_op"
    d = _find(_verify_errors(main), D.UNKNOWN_OP)
    assert d.op_idx == victim and d.block_idx == 0
    assert "totally_bogus_op" in d.message


def test_mutation_dropped_var_PTL003():
    main, _s, _l = build_mlp()
    block = main.global_block()
    victim_op = next(i for i, op in enumerate(block.ops)
                     if op.type == "mul")
    name = block.ops[victim_op].input("Y")[0]  # the fc weight
    del block.vars[name]
    d = _find(_verify_errors(main), D.UNDEFINED_VAR)
    assert d.var == name and d.op_idx == victim_op and d.block_idx == 0


def test_mutation_swapped_slot_names_PTL002():
    main, startup, _l = build_convnet_slice()
    block = main.global_block()
    i, op = next((i, op) for i, op in enumerate(block.ops)
                 if op.type == "conv2d")
    op.inputs["X"] = op.inputs.pop("Input")  # wrong slot name
    d = _find(_verify_errors(main, startup=startup), D.SLOT_ARITY)
    assert d.op_idx == i and d.op_type == "conv2d"
    assert "'X'" in d.message or "'Input'" in d.message


def test_mutation_slot_arity_overflow_PTL002():
    main, _s, _l = build_mlp()
    block = main.global_block()
    i, op = next((i, op) for i, op in enumerate(block.ops)
                 if op.type == "mul")
    op.inputs["X"] = op.inputs["X"] * 2  # two vars in an arity-1 slot
    d = _find(_verify_errors(main), D.SLOT_ARITY)
    assert d.op_idx == i and "holds 2 vars" in d.message


def test_mutation_use_before_def_PTL004():
    main = fluid.Program()
    block = main.global_block()
    block.create_var(name="a", shape=(2, 2), dtype="float32")
    block.create_var(name="b", shape=(2, 2), dtype="float32")
    block.append_op("relu", {"X": ["a"]}, {"Out": ["b"]})
    d = _find(_verify_errors(main), D.USE_BEFORE_DEF)
    assert d.var == "a" and d.op_idx == 0 and d.block_idx == 0


def test_mutation_misshaped_output_PTL006():
    main, startup, _l = build_convnet_slice()
    block = main.global_block()
    i, op = next((i, op) for i, op in enumerate(block.ops)
                 if op.type == "conv2d")
    out = block.var(op.output("Output")[0])
    out.shape = tuple([out.shape[0]] + [s + 1 for s in out.shape[1:]])
    errs = _verify_errors(main, startup=startup)
    d = next(d for d in errs if d.code == D.SHAPE_MISMATCH
             and d.op_type == "conv2d")
    assert d.op_idx == i and d.block_idx == 0


def test_mutation_wrong_dtype_PTL007():
    main, startup, _l = build_convnet_slice()
    block = main.global_block()
    i, op = next((i, op) for i, op in enumerate(block.ops)
                 if op.type == "conv2d")
    block.var(op.output("Output")[0]).dtype = "int64"
    d = _find(_verify_errors(main, startup=startup), D.DTYPE_MISMATCH)
    assert d.op_idx == i and d.op_type == "conv2d"


def test_mutation_broken_in_place_pair_PTL008():
    main, _s, _l = build_mlp(opt="momentum")
    block = main.global_block()
    i, op = next((i, op) for i, op in enumerate(block.ops)
                 if op.type == "momentum")
    block.create_var(name="detached_out", shape=block.var(
        op.output("ParamOut")[0]).shape, dtype="float32")
    op.outputs["ParamOut"] = ["detached_out"]
    d = _find(_verify_errors(main), D.IN_PLACE_BROKEN)
    assert d.op_idx == i and d.var == "detached_out"


def test_mutation_orphaned_grad_var_PTL009():
    main, _s, _l = build_mlp()
    main.global_block().create_var(name="ghost@GRAD", shape=(3, 3),
                                   dtype="float32")
    d = _find(_verify_errors(main), D.GRAD_ORPHAN)
    assert d.var == "ghost@GRAD" and "ghost" in d.message


def test_mutation_grad_shape_disagrees_with_twin_PTL006():
    main, _s, _l = build_mlp()
    block = main.global_block()
    gname = next(n for n in block.vars
                 if n.endswith("@GRAD") and block.var(n).shape is not None
                 and len(block.var(n).shape) >= 2)
    block.var(gname).shape = tuple(s + 1 for s in block.var(gname).shape)
    errs = _verify_errors(main)
    assert any(d.code == D.SHAPE_MISMATCH and d.var == gname for d in errs)


def test_mutation_fetch_clobber_PTL010():
    main, _s, loss, logits = build_mlp(return_logits=True)
    block = main.global_block()
    clobber_idx = len(block.ops)
    block.append_op("relu", {"X": [loss.name]}, {"Out": [logits.name]})
    d = _find(_verify_errors(main, fetch_names=[logits.name]),
              D.FETCH_CLOBBER)
    assert d.op_idx == clobber_idx and d.var == logits.name


# ---------------------------------------------------------------------------
# lint rules
# ---------------------------------------------------------------------------

def test_lint_dead_op_PTL101():
    main, _s, loss = build_mlp()
    block = main.global_block()
    i = len(block.ops)
    block.create_var(name="nobody_reads_me", shape=(4,), dtype="float32")
    block.append_op("relu", {"X": [loss.name]},
                    {"Out": ["nobody_reads_me"]})
    _parity(main, fetch_names=[loss.name])
    diags = lint_program(main, fetch_names=[loss.name])
    d = _find(diags, D.DEAD_OP)
    assert d.op_idx == i
    assert not any(d2.code == D.DEAD_OP and d2.op_idx != i for d2 in diags)


def test_lint_unused_var_PTL102():
    main, _s, loss = build_mlp()
    main.global_block().create_var(name="decorative", shape=(4,),
                                   dtype="float32")
    _parity(main, fetch_names=[loss.name])
    d = _find(lint_program(main, fetch_names=[loss.name]), D.UNUSED_VAR)
    assert d.var == "decorative"


def test_lint_write_after_write_PTL103():
    main = fluid.Program()
    block = main.global_block()
    block.create_var(name="x", shape=(2,), dtype="float32", is_data=True)
    block.create_var(name="t", shape=(2,), dtype="float32")
    block.append_op("relu", {"X": ["x"]}, {"Out": ["t"]})
    block.append_op("sigmoid", {"X": ["x"]}, {"Out": ["t"]})  # WAW
    _parity(main, fetch_names=["t"])
    d = _find(lint_program(main, fetch_names=["t"]), D.WRITE_AFTER_WRITE)
    assert d.op_idx == 1 and d.var == "t"


def test_lint_sparse_grad_densified_PTL104():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[64, 8], is_sparse=True)
        loss = fluid.layers.mean(emb)
        fluid.append_backward(loss)
    block = main.global_block()
    table = next(op.input("W")[0] for op in block.ops
                 if op.type == "lookup_table")
    gname = table + "@GRAD"
    block.append_op("scale", {"X": [gname]}, {"Out": [gname]},
                    {"scale": 0.99})
    _parity(main, fetch_names=[loss.name])
    d = _find(lint_program(main, fetch_names=[loss.name]),
              D.SPARSE_DENSIFIED)
    assert d.op_type == "scale" and d.var == gname


def test_lint_fp16_boundary_PTL105():
    main = fluid.Program()
    block = main.global_block()
    block.create_var(name="half", shape=(4,), dtype="float16", is_data=True)
    block.create_var(name="full", shape=(4,), dtype="float32", is_data=True)
    block.create_var(name="mix", shape=(4,), dtype="float32")
    block.append_op("elementwise_add", {"X": ["half"], "Y": ["full"]},
                    {"Out": ["mix"]})
    _parity(main, fetch_names=["mix"])
    d = _find(lint_program(main, fetch_names=["mix"]), D.FP16_BOUNDARY)
    assert d.op_idx == 0


def test_lint_retrace_hazard_PTL106():
    main = fluid.Program()
    block = main.global_block()
    block.create_var(name="x", shape=(-1, 784), dtype="float32",
                     is_data=True)
    block.create_var(name="y", shape=(32, 784), dtype="float32")
    # a concrete batch size baked into the attr over a -1-batch input;
    # both packages register reshape, so the verifier's lists are held
    # across packages as the lint's are
    block.append_op("reshape", {"X": ["x"]}, {"Out": ["y"]},
                    {"shape": [32, 784]})
    jprog = JProgram.from_dict(main.to_dict())
    assert _key(lint_program(main, fetch_names=["y"])) == \
        _key(jfluid.lint_program(jprog, fetch_names=["y"]))
    got = verify_program(main, raise_on_error=False)
    assert _key(got) == _key(jfluid.verify_program(jprog,
                                                    raise_on_error=False))
    assert D.UNKNOWN_OP not in _codes(got)
    d = _find(lint_program(main, fetch_names=["y"]), D.RETRACE_HAZARD)
    assert d.op_idx == 0 and "32" in d.message


def test_lint_clean_program_is_quiet():
    main, _s, loss = build_mlp()
    _parity(main, fetch_names=[loss.name])
    assert lint_program(main, fetch_names=[loss.name]) == []


# ---------------------------------------------------------------------------
# wiring: flags, executor cache, typed errors, CLI
# ---------------------------------------------------------------------------

def test_verify_error_names_the_pass_and_carries_codes():
    main, _s, _l = build_mlp()
    main.global_block().ops[0].type = "bogus"
    _parity(main)
    with pytest.raises(ProgramVerifyError) as ei:
        verify_program(main, pass_name="unit_test_pass")
    e = ei.value
    assert e.pass_name == "unit_test_pass"
    assert "unit_test_pass" in str(e) and D.UNKNOWN_OP in e.codes
    assert isinstance(e, ValueError)


def test_executor_verify_once_per_version():
    main, startup, loss = build_mlp()
    _parity(main, startup=startup, fetch_names=[loss.name])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    fluid.set_flags({"executor_verify": True})
    exe.run(startup, scope=scope)
    base = verify_calls()
    exe.run(main, feed=mlp_feed(4), fetch_list=[loss.name], scope=scope)
    assert verify_calls() == base + 1
    for _ in range(3):  # steady state: memoized through the cache
        exe.run(main, feed=mlp_feed(4), fetch_list=[loss.name], scope=scope)
    assert verify_calls() == base + 1
    # a mutation bumps the version -> exactly one re-verify
    main.global_block().append_op("relu", {"X": [loss.name]},
                                  {"Out": [loss.name + "_r"]})
    main.global_block().create_var(name=loss.name + "_r",
                                   shape=loss.shape, dtype="float32")
    exe.run(main, feed=mlp_feed(4), fetch_list=[loss.name], scope=scope)
    assert verify_calls() == base + 2


def test_executor_verify_rejects_corrupt_program_typed():
    main, startup, loss = build_mlp()
    del main.global_block().vars[loss.name]
    _parity(main, startup=startup)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    fluid.set_flags({"executor_verify": True})
    exe.run(startup, scope=scope)
    with pytest.raises(ProgramVerifyError) as ei:
        exe.run(main, feed=mlp_feed(4), fetch_list=[loss.name], scope=scope)
    assert ei.value.pass_name == "executor"


def test_executor_verify_scope_bound_state_is_root():
    """A non-persistable name the caller binds in the scope is part of the
    Executor's input surface: executor_verify treats it as a dataflow
    root (the reference's case binds a reader; the port has no ``read``
    op, so a relu reads a scope-bound tensor)."""
    main = fluid.Program()
    b = main.global_block()
    b.create_var(name="r", shape=(2, 3), dtype="float32")
    b.create_var(name="out", shape=(2, 3), dtype="float32")
    b.append_op("relu", {"X": ["r"]}, {"Out": ["out"]})
    # without the scope binding the same program is a use-before-def
    assert D.USE_BEFORE_DEF in _codes(_parity(main, fetch_names=["out"]))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    scope.set("r", torch.tensor([[-1.0, 2.0, 3.0], [4.0, -5.0, 6.0]]))
    fluid.set_flags({"executor_verify": True})
    out, = exe.run(main, fetch_list=["out"], scope=scope)
    assert out.shape == (2, 3) and out.min() == 0.0


def test_executor_verify_per_fetch_surface():
    main, startup, loss = build_mlp()
    block = main.global_block()
    block.create_var(name="tmp", shape=loss.shape, dtype="float32")
    block.create_var(name="tmp_use", shape=loss.shape, dtype="float32")
    block.append_op("relu", {"X": [loss.name]}, {"Out": ["tmp"]})
    block.append_op("relu", {"X": ["tmp"]}, {"Out": ["tmp_use"]})
    block.append_op("relu", {"X": [loss.name]}, {"Out": ["tmp"]})
    _parity(main, fetch_names=["tmp"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    fluid.set_flags({"executor_verify": True})
    exe.run(startup, scope=scope)
    exe.run(main, feed=mlp_feed(4), fetch_list=[loss.name], scope=scope)
    with pytest.raises(ProgramVerifyError) as ei:
        exe.run(main, feed=mlp_feed(4), fetch_list=["tmp"], scope=scope)
    assert D.FETCH_CLOBBER in ei.value.codes


def test_verify_passes_flag_rejects_backward_over_corrupt_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        h = fluid.layers.fc(x, size=4)
        loss = fluid.layers.mean(h)
    del main.global_block().vars[x.name]
    fluid.set_flags({"verify_passes": True})
    with pytest.raises(ProgramVerifyError) as ei:
        with fluid.program_guard(main, startup):
            fluid.append_backward(loss)
    assert ei.value.pass_name == "append_backward"
    _parity(main, startup=startup)


def _saved_mlp(tmp_path, name="m"):
    main, startup, loss, logits = build_mlp(return_logits=True)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / name)
    fluid.io.save_inference_model(d, ["img"], [logits], exe, main,
                                  scope=scope)
    return d, exe, logits


def test_load_inference_model_rejects_structurally_corrupt_bundle(tmp_path):
    d, exe, _ = _saved_mlp(tmp_path)
    fluid.io.load_inference_model(d, exe, scope=fluid.Scope())
    meta = json.load(open(os.path.join(d, "__model__")))
    meta["blocks"][0]["ops"][0]["type"] = "op_from_the_future"
    json.dump(meta, open(os.path.join(d, "__model__"), "w"))
    _parity(fluid.Program.from_dict(meta), feed_names=["img"],
            fetch_names=meta["fetch_var_names"])
    # refused before any persistable is read: the .npy files are gone
    for f in os.listdir(d):
        if f.endswith(".npy"):
            os.remove(os.path.join(d, f))
    with pytest.raises(ValueError, match="structurally invalid") as ei:
        fluid.io.load_inference_model(d, exe, scope=fluid.Scope())
    assert repr(d) in str(ei.value)
    # the reference refuses the same bundle the same way
    with pytest.raises(ValueError, match="structurally invalid"):
        jfluid.io.load_inference_model(d, jfluid.Executor(jfluid.CPUPlace()),
                                       scope=jfluid.Scope())


def _cli(args, reference=False):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, os.path.join(REPO, "tools", "lint_program.py")] \
        if reference else \
        [sys.executable, "-m", "paddle_tpu_torch.tools.lint_program"]
    return subprocess.run(cmd + list(args), capture_output=True, text=True,
                          timeout=180, env=env, cwd=REPO)


def test_lint_cli_roundtrip(tmp_path):
    d, _, logits = _saved_mlp(tmp_path, "bundle")
    r = _cli([d])
    assert r.returncode == 0, r.stdout + r.stderr
    # the prune drops unreferenced declarations: no PTL102 noise either
    assert "0 finding(s), 0 error(s)" in r.stdout, r.stdout

    meta = json.load(open(os.path.join(d, "__model__")))
    kept = [v for v in meta["blocks"][0]["vars"]
            if v["name"] != logits.name]
    assert len(kept) < len(meta["blocks"][0]["vars"])
    meta["blocks"][0]["vars"] = kept
    json.dump(meta, open(os.path.join(d, "__model__"), "w"))
    r = _cli([d, "--json"])
    assert r.returncode == 1, r.stdout + r.stderr
    findings = json.loads(r.stdout)
    assert any(f["code"] == D.UNDEFINED_VAR for f in findings)
    # --strict fails on a warning-only program; a bare __model__ file reads
    strict = _cli([os.path.join(d, "__model__"), "--strict"])
    assert strict.returncode == 1

    r = _cli([str(tmp_path / "nope")])
    assert r.returncode == 2


def test_both_clis_print_the_same_lines(tmp_path):
    d, _, _ = _saved_mlp(tmp_path, "bundle")
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    meta = json.load(open(os.path.join(d, "__model__")))
    meta["blocks"][0]["ops"][1]["type"] = "op_from_the_future"
    meta["blocks"][0]["vars"].append(dict(meta["blocks"][0]["vars"][-1],
                                          name="decorative"))
    json.dump(meta, open(os.path.join(bad, "__model__"), "w"))
    for path, want_rc in ((d, 0), (bad, 1)):
        for extra in ([], ["--json"]):
            port = _cli([path] + extra)
            ref = _cli([path] + extra, reference=True)
            assert port.returncode == ref.returncode == want_rc, (
                port.stdout + port.stderr, ref.stdout + ref.stderr)
            assert port.stdout == ref.stdout


# ---------------------------------------------------------------------------
# every model of paddle_tpu_torch/testing/models.py, float32 and AMP
# ---------------------------------------------------------------------------

L = fluid.layers


def _train(build, opt):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        loss, feed = build()
        opt().minimize(loss, startup)
    return main, startup, loss, feed


def _ids(rng, n, hi):
    return rng.randint(0, hi, (n, 1)).astype("int64")


def _resnet():
    img = L.data("img", shape=[32, 32, 3])
    label = L.data("label", shape=[1], dtype="int64")
    logits = M.resnet(img, 10, counts=(1, 1, 1, 1), base=8)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    assert fluid.fuse_conv_bn(fluid.default_main_program()) == 17
    rng = np.random.RandomState(0)
    return loss, {"img": rng.normal(0, 1, (2, 32, 32, 3)).astype("float32"),
                  "label": _ids(rng, 2, 10)}


def _textcls(model):
    def build():
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        prob = model(words, vocab=50, emb=8, hidden=16)
        rng = np.random.RandomState(1)
        feed = {"words": fluid.pack_sequences(
            [_ids(rng, n, 50) for n in (3, 5, 2)]),
            "label": _ids(rng, 3, 2)}
        return L.mean(L.cross_entropy(prob, label)), feed
    return build


def _ctc():
    feat = L.data("feat", shape=[12], lod_level=1)
    label = L.data("label", shape=[1], dtype="int64", lod_level=1)
    _, loss = M.ctc_acoustic(feat, label, num_classes=5, hidden=32)
    rng = np.random.RandomState(2)
    return loss, {
        "feat": fluid.pack_sequences([rng.normal(0, 1, (n, 12))
                                      .astype("float32") for n in (9, 7)]),
        "label": fluid.pack_sequences([_ids(rng, n, 5) + 1
                                       for n in (3, 2)])}


def _word2vec():
    words = [L.data(f"w{i}", shape=[1], dtype="int64") for i in range(4)]
    nextw = L.data("nextw", shape=[1], dtype="int64")
    prob = M.ngram_lm(words, dict_size=50, emb=8, hidden=16, is_sparse=True)
    rng = np.random.RandomState(3)
    feed = {f"w{i}": _ids(rng, 4, 50) for i in range(4)}
    feed["nextw"] = _ids(rng, 4, 50)
    return L.mean(L.cross_entropy(prob, nextw)), feed


def _adam():
    return fluid.optimizer.Adam(2e-3, fused=True)


TRAINED = {
    "resnet": (_resnet, lambda: fluid.optimizer.Momentum(0.1, 0.9,
                                                         fused=True)),
    "lstm_textcls": (_textcls(M.lstm_textcls), _adam),
    "gru_textcls": (_textcls(M.gru_textcls), _adam),
    "ctc_acoustic": (_ctc, _adam),
    "ngram_lm": (_word2vec, lambda: fluid.optimizer.SGD(0.5, fused=True)),
}


def _run_verified(main, startup, feed, fetch, amp):
    """One step under executor_verify; returns the fetched values."""
    exe = fluid.Executor(fluid.CPUPlace(), amp=amp)
    scope = fluid.Scope()
    fluid.set_flags({"executor_verify": True})
    exe.run(startup, scope=scope)
    base = verify_calls()
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert verify_calls() == base + 1
    return out


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
@pytest.mark.parametrize("name", sorted(TRAINED))
def test_trained_model_verifies_clean(name, amp):
    build, opt = TRAINED[name]
    fluid.set_flags({"verify_passes": True})
    base = verify_calls()
    main, startup, loss, feed = _train(build, opt)
    assert verify_calls() > base        # append_backward verified
    assert _verify_errors(main, startup=startup,
                          fetch_names=[loss.name]) == []
    assert _verify_errors(startup) == []
    loss_v, = _run_verified(main, startup, feed, [loss], amp)
    assert np.isfinite(loss_v).all()


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
@pytest.mark.parametrize("name", ["mlp_momentum", "mlp_adam", "convnet",
                                  "convnet_bottleneck"])
def test_small_model_verifies_clean(name, amp):
    fluid.set_flags({"verify_passes": True})
    if name.startswith("mlp"):
        main, startup, loss = build_mlp(opt=name.split("_")[1])
        feed = mlp_feed(4)
    else:
        main, startup, loss = build_convnet_slice(
            bottleneck=name.endswith("bottleneck"))
        feed = M.convnet_feed(2)
    assert _verify_errors(main, startup=startup,
                          fetch_names=[loss.name]) == []
    loss_v, = _run_verified(main, startup, feed, [loss], amp)
    assert np.isfinite(loss_v).all()


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
def test_tiny_lm_models_verify_clean(tmp_path, amp):
    from paddle_tpu_torch.serving.generate.decode_engine import \
        GenerationEngine
    fluid.set_flags({"verify_passes": True})
    main, startup, logits = M.build_tiny_lm(vocab=17, emb=8, max_pos=64)
    feeds = ["tokens", "positions"]
    assert _verify_errors(main, startup=startup, feed_names=feeds,
                          fetch_names=[logits.name]) == []
    tok = np.arange(6, dtype=np.int64).reshape(1, 6, 1) % 17
    out, = _run_verified(main, startup, {"tokens": tok, "positions": tok},
                         [logits], amp)
    assert out.shape == (1, 6, 17)
    d = str(tmp_path / "lm")
    M.export_tiny_lm(d, place=fluid.CPUPlace(), vocab=17, emb=8,
                     max_pos=64)
    eng = GenerationEngine(d, place=fluid.CPUPlace(), max_seqs=2,
                           max_len=32, block_size=4, num_blocks=32,
                           prefill_buckets=(8,))
    for p in (eng._prefill_program, eng._decode_program):
        assert _verify_errors(p, feed_names=feeds) == []
    if amp:
        eng._exe.amp = True
    eng.warmup()
    h, toks, fin = eng.start([1, 2, 3], 3, {"mode": "greedy"})
    while not fin:
        for _h, t, f in eng.step():
            toks += t
            fin = fin or f
    assert len(toks) == 3
