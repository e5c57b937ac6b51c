"""The multi-device checks of the reference's ``dryrun_multichip``
(__graft_entry__.py:115-318) on the port: eight lanes, each run on every
rank of a process group, and each held to the same computation on one
device.

Rank-side functions (every rank of the group calls them, through
``parallel.launch.RankPool.run``; each returns plain numbers and numpy
arrays, the same on every rank):

* ``sharded_run`` / ``single_run``: a training program's losses (and
  parameters) under ``shard_program_step`` over a mesh, and under the plain
  Executor on the whole batch;
* ``ring_lane``, ``moe_lane``, ``pipeline_lane``, ``composed_lane``,
  ``dp_sp_lane``: ring attention, the MoE FFN, the pipeline, dp×pp×tp and
  dp×sp against their single-device folds, forward and gradient;
* ``moe_train`` / ``pipeline_train``: the reference tests' training loops;
* ``planned_run``: a candidate of the placement planner's report applied
  through ``apply_candidate`` beside the same mesh and ``ShardingPlan``
  built by hand, step for step (the loss bytes of both, and the plain
  Executor's losses on the whole batch).

``dryrun_multichip(n)`` runs the eight lanes on ``n`` gloo ranks of the
CPU and prints each lane's line as the reference does. The inputs come
from numpy seeds: the lanes' numbers are the port's own, not the
reference's draws.
"""

from __future__ import annotations

import numpy as np
import torch

# the lanes' limit on every error: the reference's printed errors
# (MULTICHIP_r05.json: 4.8e-07 at most outside one grad at 2.9e-06) are
# below it, so each lane is held to max(its reference error, 1e-5) = 1e-5
LANE_LIMIT = 1e-5
# the training lanes' parameters after their steps, which the reference
# does not print: Adam's g/√v carries a float32 sum-order difference of a
# gradient near 0 into a whole step (measured 6.0e-6 on the dp×tp MLP)
PARAM_LIMIT = 1e-4


def _fluid():
    import paddle_tpu_torch.fluid as fluid
    return fluid


def _place(device):
    fluid = _fluid()
    if device is None or device == "cpu":
        return fluid.CPUPlace()
    return fluid.CUDAPlace(torch.device(device).index or 0)


def _start(build, build_kw, exe, state):
    """Build (fresh names, so every process names the variables alike)
    and a scope from ``state`` (numpy, by name) or from the startup."""
    fluid = _fluid()
    fluid.framework.reset_unique_name()
    main, startup, loss = build(**(build_kw or {}))
    if state is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = fluid.io.scope_from_numpy(state, exe.device)
    return main, startup, loss, scope


def _params(main):
    return sorted(p.name for p in main.global_block().all_parameters())


def single_run(build, build_kw, feeds, state=None, device=None):
    """The plain Executor on each whole-batch feed: {"losses", "params"}."""
    fluid = _fluid()
    exe = fluid.Executor(_place(device))
    main, _, loss, scope = _start(build, build_kw, exe, state)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return {"losses": losses,
            "params": {n: scope.find_var(n).cpu().numpy()
                       for n in _params(main)}}


def sharded_run(build, build_kw, feeds, mesh_axes, plan_kw=None,
                state=None, shape=None, device=None, local_feeds=False):
    """``shard_program_step`` over a mesh of every rank, one step a feed:
    {"losses", "params" (whole, gathered), "specs"}. With ``local_feeds``
    each rank prepares its own slice of every feed's rows, as a rank
    reading its own data shard does (a LoD feed then takes the rank's own
    padded length), in place of ``place_feed``'s split of the whole."""
    from ..parallel import (ShardingPlan, make_mesh, place_feed,
                            shard_program_step)
    from ..parallel.sharding import unshard

    fluid = _fluid()
    exe = fluid.Executor(_place(device))
    main, _, loss, scope = _start(build, build_kw, exe, state)
    mesh = make_mesh(axes=mesh_axes, shape=shape)
    plan = ShardingPlan(mesh, **(plan_kw or {}))
    fn, st, _ = shard_program_step(exe, main, feeds[0], [loss], plan,
                                   scope=scope)
    specs = fn.__self__.specs
    block = main.global_block()
    losses = []
    for f in feeds:
        if local_feeds:
            n, i = mesh.size(plan.data_axis), mesh.index(plan.data_axis)
            fd = exe._prepare_feed(block, {
                k: v[i * len(v) // n:(i + 1) * len(v) // n]
                for k, v in f.items()})
        else:
            fd = exe._prepare_feed(block, dict(f))
            fd = {k: place_feed(v, plan, k) for k, v in fd.items()}
        st, fetches = fn(st, fd)
        losses.append(float(fetches[0]))
    return {"losses": losses,
            "params": {n: unshard(st[n], specs[n], mesh).cpu().numpy()
                       for n in _params(main)},
            "specs": {n: list(s) for n, s in specs.items()},
            "mesh": dict(mesh.shape)}


def build_lm_train(vocab=32, emb=16, heads=2, n_layers=2, max_pos=64,
                   lr=1e-3, seed=7):
    """The decoder LM (``models.build_tiny_lm``) with next-token labels
    [b, T, 1], reshape to [b·T, vocab], mean softmax_with_cross_entropy
    and Adam(lr, fused=True): (main, startup, loss)."""
    from . import models

    fluid = _fluid()
    main, startup, logits = models.build_tiny_lm(
        vocab=vocab, emb=emb, heads=heads, n_layers=n_layers,
        max_pos=max_pos, seed=seed)
    with fluid.program_guard(main, startup):
        labels = fluid.layers.data("labels", shape=[-1, 1], dtype="int64")
        flat = fluid.layers.reshape(logits, [-1, vocab])
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            flat, fluid.layers.reshape(labels, [-1, 1])))
        fluid.optimizer.Adam(lr, fused=True).minimize(loss, startup)
    return main, startup, loss


def lm_train_feed(batch, seq, vocab=32, seed=0):
    """Random ``tokens``, ``positions`` and next-token ``labels`` [batch,
    seq, 1] int64 for :func:`build_lm_train`."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (batch, seq + 1, 1)).astype(np.int64)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int64)[None, :, None],
                          (batch, seq, 1)).copy()
    return {"tokens": toks[:, :-1].copy(), "positions": pos,
            "labels": toks[:, 1:].copy()}


def _steps(exe, fn, state, block, plan, feeds):
    from ..parallel import place_feed

    out = []
    for f in feeds:
        fd = exe._prepare_feed(block, dict(f))
        state, fetches = fn(state, {k: place_feed(v, plan, k)
                                    for k, v in fd.items()})
        out.append(fetches[0].detach().cpu().numpy().tobytes())
    return out


def planned_run(build, build_kw, feeds, n, sizes, plan_kw=None,
                device=None):
    """On every rank of an ``n``-rank group: plan ``build``'s program for
    ``n`` devices (``measure=False``, no cap), take the ranked candidate
    with these axis ``sizes`` and ``plan_kw``, and run ``feeds`` through
    ``planner.apply_candidate``; then the same mesh and plan built by hand
    (``make_mesh(n, axes, shape)`` + ``ShardingPlan(mesh, **plan_kw)``)
    through ``shard_program_step`` from the same start. Returns {"planned",
    "hand": each step's loss bytes, "losses": the planned floats,
    "chosen": the report's choice, "mesh": the candidate's, "launches":
    {"planned", "hand": the kernel launches each made}}."""
    from ..ops.cuda import launch_counts
    from ..parallel import ShardingPlan, make_mesh, shard_program_step
    from ..parallel import planner as pl

    def delta(before):
        now = launch_counts()
        return {k: v - before.get(k, 0) for k, v in now.items()
                if v - before.get(k, 0)}

    fluid = _fluid()
    plan_kw = dict(plan_kw or {})
    exe = fluid.Executor(_place(device))
    main, _, loss, scope = _start(build, build_kw, exe, None)
    rep = pl.plan(main, feed_example=feeds[0], n_devices=n,
                  fetch_list=[loss], measure=False, max_candidates=0)
    want = {a: int(sizes.get(a, 1)) for a in ("dp", "ep", "pp", "tp", "sp")}
    cand = next(c for c in rep.ranked()
                if c.sizes == want and c.plan_kw == plan_kw)
    c0 = launch_counts()
    fn, state, _, splan = pl.apply_candidate(cand, exe, main, feeds[0],
                                             [loss], scope=scope)
    planned = _steps(exe, fn, state, main.global_block(), splan, feeds)
    planned_launches = delta(c0)
    exe2 = fluid.Executor(_place(device))
    main2, _, loss2, scope2 = _start(build, build_kw, exe2, None)
    hand_plan = ShardingPlan(make_mesh(n, axes=cand.axes, shape=cand.shape),
                             **plan_kw)
    c0 = launch_counts()
    fn2, state2, _ = shard_program_step(exe2, main2, feeds[0], [loss2],
                                        hand_plan, scope=scope2)
    hand = _steps(exe2, fn2, state2, main2.global_block(), hand_plan, feeds)
    return {"planned": planned, "hand": hand,
            "losses": [float(np.frombuffer(b, np.float32)[0])
                       for b in planned],
            "chosen": rep.chosen.describe(), "mesh": cand.describe(),
            "launches": {"planned": planned_launches, "hand": delta(c0)}}


def build_mlp_reduced(loss="reduce_mean", batch=16, fluid=None):
    """``models.build_mlp``'s widths with its loss taken over the batch by
    the reduce ops: ``"reduce_mean"`` over every element, ``"sum_rows"``
    reduce_sum over dim 0 (scaled by 1/batch, then ``mean`` of the one
    element), ``"mean_rows_keep"`` reduce_mean over [0] with keep_dim
    (then reduce_sum of the [1, 1]); ``"accuracy"`` adds an accuracy op
    (the sharded step sums its counts over dp), ``"reduce_max"`` and
    ``"auc"`` an op the sharded step has no collective form for. ``fluid``
    is this package's by default (the tests pass the reference's)."""
    fluid = fluid or _fluid()
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        img = layers.data("img", shape=[16])
        label = layers.data("label", shape=[1], dtype="int64")
        logits = layers.fc(layers.fc(img, size=32, act="relu"), size=4)
        ce = layers.softmax_with_cross_entropy(logits, label)
        if loss == "sum_rows":
            out = layers.mean(layers.scale(layers.reduce_sum(ce, dim=0),
                                           scale=1.0 / batch))
        elif loss == "mean_rows_keep":
            out = layers.reduce_sum(layers.reduce_mean(ce, dim=[0],
                                                       keep_dim=True))
        elif loss in ("accuracy", "auc"):
            out = layers.mean(ce)
            getattr(layers, loss)(layers.softmax(logits), label)
        else:
            out = getattr(layers, loss)(ce)
        fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
            out, startup)
    return main, startup, out


def build_sparse_embedding(vocab=12, emb=16, opt="sgd", lod=False,
                           seed=11, fluid=None):
    """tests/test_sparse.py's ``_embedding_program``: an ``is_sparse``
    embedding of ``vocab`` x ``emb`` over ``ids``, an fc to 4, the mean
    square error against ``y`` [4]; with ``lod`` the ids are a LoD
    sequence a row, summed by sequence_pool before the fc. ``opt`` "sgd"
    (0.1) or "momentum" (0.1, 0.9). ``fluid`` is this package's by
    default (the tests pass the reference's)."""
    fluid = fluid or _fluid()
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        ids = layers.data("ids", shape=[1], dtype="int64",
                          lod_level=1 if lod else 0)
        label = layers.data("y", shape=[4])
        e = layers.embedding(ids, size=[vocab, emb], is_sparse=True)
        e = layers.sequence_pool(e, pool_type="sum") if lod \
            else layers.reshape(e, [-1, emb])
        pred = layers.fc(e, size=4, act=None)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred,
                                                                 label)))
        if opt == "sgd":
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
        else:
            fluid.optimizer.Momentum(learning_rate=0.1,
                                     momentum=0.9).minimize(loss, startup)
    return main, startup, loss


def sparse_embedding_feed(vocab=12, batch=8, lod=False, seed=0):
    """tests/test_sparse.py's ``_feeds`` (one feed); with ``lod`` the ids
    are ``batch`` sequences of 1..5 ids each."""
    rng = np.random.RandomState(seed)
    if lod:
        ids = [rng.randint(0, vocab, (int(rng.randint(1, 6)), 1))
               .astype("int64") for _ in range(batch)]
    else:
        ids = rng.randint(0, vocab, (batch, 1)).astype("int64")
    return {"ids": ids,
            "y": rng.normal(0, 1, (batch, 4)).astype("float32")}


def accuracy_run(feed, mesh_axes=("dp",), state=None):
    """``build_mlp_reduced(loss="accuracy")``'s accuracy op fetched from one
    step of the sharded step over every rank and from the plain Executor
    on the whole batch, from one state (``state``, numpy by name, or this
    package's startup): {"sharded": [accuracy, correct, total],
    "single": [...]}."""
    from ..parallel import (ShardingPlan, make_mesh, place_feed,
                            shard_program_step)

    fluid = _fluid()
    exe = fluid.Executor(fluid.CPUPlace())
    kw = dict(loss="accuracy", batch=len(next(iter(feed.values()))))
    main, startup, _, scope = _start(build_mlp_reduced, kw, exe, state)
    if state is None:
        state = {v.name: scope.find_var(v.name).numpy()
                 for v in main.global_block().vars.values()
                 if v.persistable and scope.find_var(v.name) is not None}
    acc_op, = [op for op in main.global_block().ops if op.type == "accuracy"]
    fetch = [acc_op.output(s)[0] for s in ("Accuracy", "Correct", "Total")]
    single = exe.run(main, feed=feed, fetch_list=fetch,
                     scope=fluid.io.scope_from_numpy(state, exe.device))
    main, _, _, scope = _start(build_mlp_reduced, kw, exe, state)
    plan = ShardingPlan(make_mesh(axes=mesh_axes))
    fn, st, _ = shard_program_step(exe, main, feed, fetch, plan, scope=scope)
    fd = exe._prepare_feed(main.global_block(), dict(feed))
    _, got = fn(st, {k: place_feed(v, plan, k) for k, v in fd.items()})
    return {"sharded": [float(v) for v in got],
            "single": [float(v) for v in single]}


def sharded_error(build, build_kw, feed, mesh_axes, plan_kw=None):
    """The error ``shard_program_step`` raises for this program over a
    mesh of every rank (None where it builds)."""
    try:
        sharded_run(build, build_kw, [feed], mesh_axes, plan_kw)
    except NotImplementedError as e:
        return str(e)
    return None


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(0, 1, shape) * scale)
                            .astype(np.float32))


def _max_err(a, b):
    return float((a.detach() - b.detach()).abs().max())


def _psum_all(t, mesh):
    """A psum over every axis of the mesh (autograd: identity backward)."""
    from ..parallel.collectives import psum_ad
    for ax in mesh.axis_names:
        t = psum_ad(t, mesh.group(ax))
    return t


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def ring_inputs(b, seq, h, d, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.normal(0, 1, (b, seq, h, d)) * scale).astype(np.float32)
            for _ in range(3)]


def ring_lane(b, seq, h, d, seed, causal, axes=("sp",), shape=None,
              batch_axis=None, grads=False, scale=1.0):
    """Ring attention over the mesh's "sp" axis (and ``batch_axis``)
    against ``full_attention`` on the whole inputs: {"out", "err"} and,
    with ``grads``, the whole loss sum(out²) and dq/dk/dv with their
    errors."""
    from ..parallel import make_mesh
    from ..parallel.ring_attention import (full_attention, local_block,
                                           ring_attention)
    from ..parallel.sharding import P, unshard

    mesh = make_mesh(axes=axes, shape=shape)
    full = [torch.from_numpy(a).requires_grad_(grads)
            for a in ring_inputs(b, seq, h, d, seed, scale)]
    local = [local_block(t.detach(), mesh, "sp", batch_axis)
             .requires_grad_(grads) for t in full]
    out = ring_attention(*local, mesh, axis="sp", causal=causal,
                         batch_axis=batch_axis)
    spec = P(batch_axis, "sp", None, None)
    got = unshard(out.detach(), spec, mesh)
    want = full_attention(*full, causal=causal)
    res = {"out": got.numpy(), "err": _max_err(got, want)}
    if grads:
        loss = _psum_all((out * out).sum(), mesh)
        loss.backward()
        want_loss = (want * want).sum()
        want_loss.backward()
        got_loss, want_loss = loss.item(), want_loss.item()
        res["loss"] = got_loss
        res["loss_err"] = abs(got_loss - want_loss) / max(abs(want_loss),
                                                           1.0)
        for name, lt, ft in zip("qkv", local, full):
            g = unshard(lt.grad, spec, mesh)
            res["d" + name] = g.numpy()
            res["d" + name + "_err"] = _max_err(g, ft.grad)
        res["grad_err"] = max(res[f"d{n}_err"] for n in "qkv")
    return res


def ring_block_shape(b, seq, h, d, seed=1):
    """The shape of this rank's block of a ring attention output over an
    "sp" mesh of every rank."""
    from ..parallel import make_mesh
    from ..parallel.ring_attention import local_block, ring_attention

    mesh = make_mesh(axes=("sp",))
    q = local_block(torch.from_numpy(ring_inputs(b, seq, h, d, seed)[0]),
                    mesh)
    return tuple(ring_attention(q, q, q, mesh).shape)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_inputs(n, d, h, e, seed):
    """x [n, d] and the params (reference init's scales) as numpy."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return f(n, d), {"gate": f(d, e) * d ** -0.5,
                     "w_in": f(e, d, h) * d ** -0.5,
                     "w_out": f(e, h, d) * h ** -0.5}


def moe_lane(n, d, h, e, seed, capacity_factor=1.25):
    """The expert-sharded MoE over "ep" (every rank's tokens gathered)
    against the replicated computation: {"out", "aux", "err", "aux_err"}."""
    from ..parallel import make_mesh, moe_ffn, shard_moe_params
    from ..parallel.collectives import all_gather

    x, params = moe_inputs(n, d, h, e, seed)
    x = torch.from_numpy(x)
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    ref, ref_aux = moe_ffn(x, params, None, capacity_factor=capacity_factor)
    mesh = make_mesh(axes=("ep",))
    ep, me = mesh.size("ep"), mesh.index("ep")
    out, aux = moe_ffn(x.chunk(ep)[me], shard_moe_params(params, mesh),
                       mesh, capacity_factor=capacity_factor)
    got = all_gather(out, 0, mesh.group("ep"), ep)
    return {"out": got.numpy(), "aux": aux.item(),
            "ref_out": ref.numpy(), "ref_aux": ref_aux.item(),
            "err": _max_err(got, ref),
            "aux_err": abs(aux.item() - ref_aux.item())}


def moe_train(n, d, h, e, seed, steps, lr=0.1):
    """The reference test's MoE regression head trained ``steps`` SGD
    steps over "ep" (tokens split, experts sharded; the replicated gate's
    gradient summed over the axis): the losses and the count of experts
    that receive tokens at the end."""
    from ..parallel import make_mesh, moe_ffn, shard_moe_params
    from ..parallel.collectives import all_reduce, psum_ad

    rng = np.random.RandomState(seed)
    x, params = moe_inputs(n, d, h, e, seed)
    w_true = rng.normal(0, 1, (d, d)).astype(np.float32)
    y = np.tanh(x @ w_true)
    mesh = make_mesh(axes=("ep",))
    ep, me, group = mesh.size("ep"), mesh.index("ep"), mesh.group("ep")
    p = {k: v.requires_grad_(True) for k, v in shard_moe_params(
        {k: torch.from_numpy(v) for k, v in params.items()}, mesh).items()}
    xl = torch.from_numpy(x).chunk(ep)[me]
    yl = torch.from_numpy(y).chunk(ep)[me]
    losses = []
    for _ in range(steps):
        out, aux = moe_ffn(xl, p, mesh)
        loss = psum_ad(((out - yl) ** 2).sum(), group) / (n * d) \
            + 0.01 * aux
        for t in p.values():
            t.grad = None
        loss.backward()
        with torch.no_grad():
            p["gate"].grad = all_reduce(p["gate"].grad, group)
            for t in p.values():
                t -= lr * t.grad
        losses.append(loss.item())
    with torch.no_grad():
        routed = torch.softmax(xl @ p["gate"], -1).argmax(-1)
        hits = all_reduce(torch.bincount(routed, minlength=e), group)
    return {"losses": losses, "experts_used": int((hits > 0).sum())}


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def tanh_stage(w, x):
    return torch.tanh(x @ w)


def pipeline_inputs(s, m, mb, d, seed):
    rng = np.random.RandomState(seed)
    return ((rng.normal(0, 1, (s, d, d)) * 0.3).astype(np.float32),
            rng.normal(0, 1, (m, mb, d)).astype(np.float32))


def pipeline_lane(m, mb, d, seed):
    """The pipeline over "pp" (one stage a rank) against the sequential
    fold, forward and the gradient of sum(out²): {"out", "grad", "err",
    "grad_err"}."""
    from ..parallel import (make_mesh, pipeline_apply,
                            pipeline_stack_reference, shard_pipeline_params)
    from ..parallel.collectives import all_gather

    mesh = make_mesh(axes=("pp",))
    s = mesh.size("pp")
    ws, xs = (torch.from_numpy(a) for a in pipeline_inputs(s, m, mb, d,
                                                           seed))
    ws.requires_grad_(True)
    ref = pipeline_stack_reference(tanh_stage, ws, xs)
    (ref * ref).sum().backward()
    local = shard_pipeline_params(ws.detach(), mesh).requires_grad_(True)
    got = pipeline_apply(tanh_stage, local, xs, mesh)
    (got * got).sum().backward()
    grad = all_gather(local.grad, 0, mesh.group("pp"), s)
    return {"out": got.detach().numpy(), "grad": grad.numpy(),
            "err": _max_err(got, ref), "grad_err": _max_err(grad, ws.grad)}


def pipeline_train(m, mb, d, seed, steps, lr=0.5):
    """The reference test's pipeline trained ``steps`` SGD steps toward
    tanh(tanh(x @ W)): the losses."""
    from ..parallel import make_mesh, pipeline_apply, shard_pipeline_params

    mesh = make_mesh(axes=("pp",))
    s = mesh.size("pp")
    ws, xs = (torch.from_numpy(a) for a in pipeline_inputs(s, m, mb, d,
                                                           seed))
    rng = np.random.RandomState(seed + 1)
    target = torch.tanh(torch.tanh(xs @ torch.from_numpy(
        rng.normal(0, 1, (d, d)).astype(np.float32))))
    w = shard_pipeline_params(ws, mesh).requires_grad_(True)
    losses = []
    for _ in range(steps):
        loss = ((pipeline_apply(tanh_stage, w, xs, mesh) - target) ** 2) \
            .mean()
        w.grad = None
        loss.backward()
        with torch.no_grad():
            w -= lr * w.grad
        losses.append(loss.item())
    return {"losses": losses}


def composed_lane(seed, m=4, d=8, k=16, lr=0.1):
    """dp×pp×tp on one 3-axis mesh (the reference's _composed_check):
    microbatch rows over "dp", stages over "pp", each stage's two matmuls
    Megatron-split over "tp" (column-parallel w1, row-parallel w2, the
    partial products summed over tp). Forward, the gradients of every
    stage weight and one SGD step against the sequential fold: {"mesh",
    "err", "grad_err", "sgd_err"}."""
    from ..parallel import (make_mesh, pipeline_apply,
                            pipeline_stack_reference)
    from ..parallel.collectives import all_reduce, pcopy_ad, psum_ad
    from ..parallel.sharding import P, local_shard, unshard

    mesh = make_mesh(axes=("dp", "pp", "tp"))
    s, dp = mesh.size("pp"), mesh.size("dp")
    mb = 2 * dp
    rng = np.random.RandomState(seed)
    w1, w2 = (_normal(rng, *shape, scale=0.3)
              for shape in ((s, d, k), (s, k, d)))
    xs = _normal(rng, m, mb, d)
    tp = mesh.group("tp")

    def stage_full(params, x):
        return torch.tanh(x @ params[0]) @ params[1]

    def stage_tp(params, x):
        # f on the input (its cotangent summed over tp), the partial
        # product of this rank's columns and rows, g (a sum over tp)
        return psum_ad(stage_full(params, pcopy_ad(x, tp)), tp)

    full = [w.clone().requires_grad_(True) for w in (w1, w2)]
    ref = pipeline_stack_reference(stage_full, tuple(full), xs)
    (ref * ref).sum().backward()
    specs = (P("pp", None, "tp"), P("pp", "tp", None))
    local = tuple(local_shard(w, sp, mesh).requires_grad_(True)
                  for w, sp in zip((w1, w2), specs))
    xl = local_shard(xs, P(None, "dp"), mesh)
    got = pipeline_apply(stage_tp, local, xl, mesh,
                         data_spec=P(None, "dp"), param_specs=specs)
    psum_ad((got * got).sum(), mesh.group("dp")).backward()
    grads = [unshard(all_reduce(w.grad, mesh.group("dp")), sp, mesh)
             for w, sp in zip(local, specs)]
    upd = [unshard(w.detach() - lr * all_reduce(w.grad, mesh.group("dp")),
                   sp, mesh) for w, sp in zip(local, specs)]
    got_full = unshard(got.detach(), P(None, "dp"), mesh)
    return {"mesh": dict(mesh.shape), "err": _max_err(got_full, ref),
            "grad_err": max(_max_err(g, f.grad)
                            for g, f in zip(grads, full)),
            "sgd_err": max(_max_err(u, w - lr * f.grad)
                           for u, w, f in zip(upd, (w1, w2), full))}


def dp_sp_lane(seed, n_ranks):
    """dp×sp (the reference's _composed_dp_sp_check): a 2 x n/2 mesh, batch
    rows over dp and the sequence over sp through ring attention; the loss
    sum(out²) and its gradients against full attention."""
    shape = (2, n_ranks // 2) if n_ranks % 2 == 0 else None
    dp = shape[0] if shape else 1
    sp = n_ranks // dp
    res = ring_lane(2 * dp, 8 * sp, 2, 8, seed, causal=True,
                    axes=("dp", "sp"), shape=shape, batch_axis="dp",
                    grads=True, scale=0.5)
    res.update(dp=dp, sp=sp, seq=8 * sp)
    return res


# ---------------------------------------------------------------------------
# multi-host start-up (the reference's tests/multihost_worker.py)
# ---------------------------------------------------------------------------

def multihost_check(coordinator=None):
    """On every rank: join (again, from ``coordinator`` "host:port" when
    given, else env://) through ``init_multihost``, build the global mesh,
    sum every rank's row indices across the ranks (4 rows a rank), and run
    3 steps of the MLP's sharded step over it. Raises on any failure;
    returns {"info", "psum", "losses", "single"}."""
    import torch.distributed as dist

    from . import models
    from ..parallel import global_mesh, init_multihost
    from ..parallel.collectives import all_reduce

    if coordinator is not None:
        world, rank = dist.get_world_size(), dist.get_rank()
        dist.destroy_process_group()
        info = init_multihost(coordinator, world, rank, backend="gloo")
    else:
        info = init_multihost()
    n = info["process_count"]
    mesh = global_mesh(axes=("dp",))
    assert mesh.shape == {"dp": n}, mesh.shape
    rank = info["process_index"]
    local = torch.arange(4 * rank, 4 * rank + 4, dtype=torch.float32)
    total = float(all_reduce(local.sum(), mesh.group("dp")))
    assert total == sum(range(4 * n)), total
    kw = dict(dim=16, classes=4, hidden=16, opt="sgd")
    feeds = [models.mlp_feed(16, dim=16, classes=4)] * 3
    got = sharded_run(models.build_mlp, kw, feeds, ("dp",))["losses"]
    single = single_run(models.build_mlp, kw, feeds)["losses"]
    assert all(np.isfinite(got)) and got[-1] < got[0], got
    return {"info": info, "psum": total, "losses": got, "single": single}


def host_layout(axes):
    """This rank's coordinates in ``global_mesh(axes)`` and the mesh's
    shape."""
    from ..parallel import global_mesh

    mesh = global_mesh(axes=axes)
    return mesh.coords, mesh.shape


# ---------------------------------------------------------------------------
# the eight lanes
# ---------------------------------------------------------------------------

def _train_lane(title, build, build_kw, feed, mesh_axes, plan_kw, steps=2):
    single = single_run(build, build_kw, [feed] * steps)
    got = sharded_run(build, build_kw, [feed] * steps, mesh_axes, plan_kw)
    err = max(abs(a - b) for a, b in zip(got["losses"], single["losses"]))
    perr = max(float(np.max(np.abs(got["params"][n] - single["params"][n])))
               for n in single["params"])
    ok = (err <= LANE_LIMIT and perr <= PARAM_LIMIT
          and got["losses"][-1] < got["losses"][0]
          and all(np.isfinite(got["losses"])))
    return ok, (f"  {title} on mesh {got['mesh']}: loss "
                f"{got['losses'][0]:.4f} -> {got['losses'][-1]:.4f}, "
                f"max|sharded-single| loss {err:.1e}, params {perr:.1e}")


def lanes(n_ranks):
    """Every lane on this rank (all ranks call it): [(ok, line)]."""
    from . import models

    batch = max(8, n_ranks)
    out = [
        _train_lane("resnet_slice dp+zero1", models.build_convnet_slice,
                    dict(size=16, classes=8, nf=8, seed=3, bottleneck=True),
                    models.convnet_feed(batch, size=16, classes=8, seed=1),
                    ("dp",), {"shard_opt_state": True}),
        _train_lane("mlp dp×tp", models.build_mlp,
                    dict(dim=64, classes=8, hidden=64, opt="adam"),
                    models.mlp_feed(batch, dim=64, classes=8),
                    ("dp", "tp"), None),
        _train_lane("seq2seq(LoD) dp", models.build_seq_slice,
                    dict(vocab=16, emb=8, hid=8, seed=5),
                    models.seq_feed(batch, vocab=16, seed=2), ("dp",),
                    None),
    ]
    r = ring_lane(2, 8 * n_ranks, 2, 8, 0, causal=True)
    out.append((r["err"] <= LANE_LIMIT,
                f"  ring_attention sp={n_ranks} seq={8 * n_ranks}: "
                f"max|ring-full| = {r['err']:.1e}"))
    r = moe_lane(4 * n_ranks, 8, 16, n_ranks, 0)
    out.append((r["err"] <= LANE_LIMIT,
                f"  moe ep={n_ranks}: max|sharded-replicated| = "
                f"{r['err']:.1e}"))
    r = pipeline_lane(n_ranks + 1, 4, 8, 2)
    out.append((max(r["err"], r["grad_err"]) <= LANE_LIMIT,
                f"  pipeline pp={n_ranks} microbatches={n_ranks + 1}: "
                f"fwd err {r['err']:.1e}, grad err {r['grad_err']:.1e}"))
    r = composed_lane(4)
    out.append((max(r["err"], r["grad_err"], r["sgd_err"]) <= LANE_LIMIT,
                f"  composed dp×pp×tp {r['mesh']}: fwd err "
                f"{r['err']:.1e}, grad err {r['grad_err']:.1e}, sgd-step "
                f"err {r['sgd_err']:.1e}"))
    r = dp_sp_lane(7, n_ranks)
    out.append((max(r["loss_err"], r["grad_err"]) <= LANE_LIMIT,
                f"  composed dp×sp {r['dp']}×{r['sp']} seq={r['seq']}: "
                f"loss err {r['loss_err']:.1e}, grad err "
                f"{r['grad_err']:.1e}"))
    return out


def dryrun_multichip(n_ranks=8, timeout=300.0):
    """The eight lanes on ``n_ranks`` gloo ranks of the CPU, printed as
    the reference prints them; returns the lines and whether every lane
    met LANE_LIMIT (and, for the training lanes, its loss fell)."""
    from ..parallel.launch import RankPool

    with RankPool(n_ranks, "gloo", timeout=timeout) as pool:
        results = pool.run(lanes, n_ranks)
    ok = all(r == results[0] for r in results[1:]) \
        and all(good for good, _ in results[0])
    lines = [line for _, line in results[0]]
    for line in lines:
        print(line)
    print(f"dryrun_multichip({n_ranks}) {'ok' if ok else 'FAILED'}")
    return lines, ok
