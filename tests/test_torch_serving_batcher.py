"""The port's DynamicBatcher and TenantQuotas (paddle_tpu_torch/serving/
batcher.py) held to the reference's (paddle_tpu/serving/batcher.py).

Counterparts of tests/test_serving.py:133-366 (the eight DynamicBatcher
tests) and tests/test_serving_multitenant.py:211-246 (the token bucket and
the tenant-label funnel, rate 0 meaning unlimited). Each test runs the same
calls against both packages' classes (``pkg``) and asserts the same
outcome. Batches are held on events instead of sleeps, so which requests
coalesce does not depend on timing, and every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu.obs.metrics as jmetrics
import paddle_tpu.serving.batcher as jbatcher
import paddle_tpu_torch.obs.metrics as tmetrics
import paddle_tpu_torch.serving.batcher as tbatcher

WAIT_S = 5.0
# the bound on a held dispatch, released by the test well before it
GATE_S = 10.0
PKGS = {"port": (tbatcher, tmetrics), "reference": (jbatcher, jmetrics)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _wait_until(pred, timeout=WAIT_S):
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        tick.wait(0.005)
    return True


def _start(fn, n):
    ts = [threading.Thread(target=fn, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    return ts


def _join(ts):
    for t in ts:
        t.join(WAIT_S)
        assert not t.is_alive(), "a caller is still blocked"


def test_batcher_coalesces_and_routes_per_caller(pkg):
    mod, _ = pkg
    calls = []
    gate = threading.Event()

    def run_batch(feed):
        calls.append(int(feed["v"].shape[0]))
        gate.wait(GATE_S)            # the queue builds behind this batch
        return [feed["v"] * 2.0]

    b = mod.DynamicBatcher(run_batch, max_batch=8, max_delay_ms=30,
                           capacity=64)
    results = {}

    def caller(i):
        results[i] = b.submit({"v": np.full((1, 2), float(i))})

    ts = _start(caller, 8)
    assert _wait_until(lambda: b.stats()["requests"] == 8 and calls)
    gate.set()
    _join(ts)
    for i in range(8):              # each caller got ITS rows back
        np.testing.assert_array_equal(results[i][0],
                                      np.full((1, 2), 2.0 * i))
    st = b.stats()
    assert st["requests"] == 8 and st["rejected"] == 0
    assert st["batches"] == len(calls) <= 2         # coalescing happened
    assert sum(k * v for k, v in st["batch_size_hist"].items()) == 8
    assert b.close()


def test_batcher_full_bucket_dispatches_before_deadline(pkg):
    """A full batch does not wait out max_delay: 4 queued rows with a
    5 s deadline dispatch at once."""
    mod, _ = pkg
    seen = []

    def run_batch(feed):
        seen.append(feed["v"].shape[0])
        return [feed["v"]]

    b = mod.DynamicBatcher(run_batch, max_batch=4, max_delay_ms=5000,
                           capacity=64)
    start = threading.Barrier(4)
    t0 = time.monotonic()

    def caller(i):
        start.wait(WAIT_S)
        b.submit({"v": np.zeros((1, 1), np.float32)})

    _join(_start(caller, 4))
    assert time.monotonic() - t0 < 2.0   # nowhere near the 5 s deadline
    assert sum(seen) == 4
    assert b.close()


def test_batcher_overload_rejects_fast(pkg):
    mod, _ = pkg
    release = threading.Event()

    def slow_batch(feed):
        release.wait(GATE_S)
        return [feed["v"]]

    b = mod.DynamicBatcher(slow_batch, max_batch=1, max_delay_ms=1,
                           capacity=2)
    outcomes = []

    def caller(i):
        try:
            b.submit({"v": np.zeros((1, 1), np.float32)})
            outcomes.append("ok")
        except mod.ServerOverloaded:
            outcomes.append("overloaded")

    t0 = time.monotonic()
    ts = _start(caller, 6)
    # rejections are immediate — well before the worker unblocks
    assert _wait_until(lambda: outcomes.count("overloaded") >= 1)
    rejected_at = time.monotonic() - t0
    release.set()
    _join(ts)
    assert rejected_at < 1.0, "reject-fast took as long as the slow batch"
    assert outcomes.count("ok") + outcomes.count("overloaded") == 6
    assert b.stats()["rejected"] == outcomes.count("overloaded")
    assert b.close()


def test_batcher_never_coalesces_incompatible_requests(pkg):
    """A request of another dtype serves in a batch of its own: a mixed
    concatenate would upcast every batch-mate's rows."""
    mod, _ = pkg
    gate = threading.Event()
    batches = []

    def run_batch(feed):
        batches.append(feed["v"].dtype)
        gate.wait(GATE_S)
        return [feed["v"]]

    b = mod.DynamicBatcher(run_batch, max_batch=8, max_delay_ms=20,
                           capacity=64)
    results = {}

    def caller(i):
        dt = np.float32 if i % 2 == 0 else np.float64
        results[i] = b.submit({"v": np.full((1, 2), float(i), dt)})[0]

    ts = _start(caller, 6)
    assert _wait_until(lambda: b.stats()["requests"] == 6 and batches)
    gate.set()
    _join(ts)
    for i in range(6):              # each caller's dtype came back intact
        assert results[i].dtype == (np.float32 if i % 2 == 0
                                    else np.float64), (i, results[i].dtype)
        np.testing.assert_array_equal(results[i],
                                      np.full((1, 2), float(i)))
    assert b.close()


def test_batcher_rejects_non_per_row_fetches(pkg):
    mod, _ = pkg
    b = mod.DynamicBatcher(lambda feed: [np.float32(1.0)], max_batch=4,
                           max_delay_ms=1, capacity=8)
    with pytest.raises(ValueError, match="per-row"):
        b.submit({"v": np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="empty"):
        b.submit({"v": np.zeros((0, 1), np.float32)})
    with pytest.raises(ValueError, match="inconsistent"):
        b.submit({"v": np.zeros((1, 1)), "w": np.zeros((2, 1))})
    assert b.close()


def test_batcher_close_answers_queued_requests(pkg):
    """Requests already queued when close() lands are flushed: their
    callers get real results, not an error and never a hang."""
    mod, _ = pkg
    release = threading.Event()
    calls = []

    def gated(feed):
        calls.append(feed["v"].shape[0])
        release.wait(GATE_S)          # the first batch holds the worker
        return [feed["v"] * 2.0]

    b = mod.DynamicBatcher(gated, max_batch=1, max_delay_ms=1, capacity=16)
    results = {}

    def caller(i):
        results[i] = b.submit({"v": np.full((1, 1), float(i))})

    ts = _start(caller, 4)
    # the worker holds batch 0 AND the other three callers are queued
    # before close() lands
    assert _wait_until(lambda: calls and b.stats()["queue_depth"] == 3)
    closed = []
    ct = threading.Thread(target=lambda: closed.append(b.close(10.0)))
    ct.start()
    assert _wait_until(lambda: b._closed)
    release.set()                     # un-wedge: close must now flush
    ct.join(WAIT_S)
    _join(ts)
    assert closed == [True]
    for i in range(4):                # every queued caller was answered
        np.testing.assert_array_equal(results[i][0],
                                      np.full((1, 1), 2.0 * i))
    with pytest.raises(RuntimeError, match="closed"):
        b.submit({"v": np.zeros((1, 1), np.float32)})


def test_batcher_close_rejects_queued_typed_when_worker_wedged(pkg):
    """A run_batch that does not return must not hang queued callers across
    close(): the undispatched queue is rejected with a typed RuntimeError
    when the join times out."""
    mod, _ = pkg
    wedged, unwedge = threading.Event(), threading.Event()

    def black_hole(feed):
        wedged.set()
        unwedge.wait(10.0)            # "never" returns, within the test
        return [feed["v"]]

    b = mod.DynamicBatcher(black_hole, max_batch=1, max_delay_ms=1,
                           capacity=16)
    outcomes = {}

    def caller(i):
        try:
            b.submit({"v": np.full((1, 1), float(i))})
            outcomes[i] = "ok"
        except RuntimeError as e:
            outcomes[i] = e

    ts = _start(caller, 3)
    try:
        assert wedged.wait(WAIT_S)    # one caller's batch is in the hole
        assert _wait_until(lambda: b.stats()["queue_depth"] == 2)
        assert b.close(timeout=0.3) is False          # worker is wedged
        _wait_until(lambda: len(outcomes) == 2)
        rejected = [v for v in outcomes.values()
                    if isinstance(v, RuntimeError)]
        assert len(rejected) == 2     # ...with the typed rejection
        assert all("rejected without being served" in str(e)
                   for e in rejected)
    finally:
        unwedge.set()
        _join(ts)
    assert list(outcomes.values()).count("ok") == 1


def test_batcher_propagates_errors_and_flushes_on_close(pkg):
    mod, _ = pkg

    def failing(feed):
        raise ValueError("model exploded")

    b = mod.DynamicBatcher(failing, max_batch=4, max_delay_ms=1, capacity=8)
    with pytest.raises(ValueError, match="model exploded"):
        b.submit({"v": np.zeros((1, 1), np.float32)})
    assert b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit({"v": np.zeros((1, 1), np.float32)})


# ---------------------------------------------------------------------------
# tenant quotas (test_serving_multitenant.py:211-246)
# ---------------------------------------------------------------------------

def test_tenant_quotas_token_bucket_and_label_funnel(pkg):
    mod, metrics = pkg
    q = mod.TenantQuotas(rate=0.01, burst=2, overrides={"gold": (0.01, 5)},
                         label_cap=3)
    for _ in range(2):
        assert q.try_acquire("t0") == (True, 0.0)
    admitted, retry = q.try_acquire("t0")
    assert not admitted and retry > 0
    with pytest.raises(mod.QuotaExceeded) as ei:
        q.check("t0")
    assert ei.value.tenant == "t0" and ei.value.retry_after_s > 0
    # per-tenant override: gold's burst of 5 admits where t0 rejected
    for _ in range(5):
        assert q.try_acquire("gold")[0]
    assert not q.try_acquire("gold")[0]
    st = q.stats()
    assert st["tenants"]["t0"] == {"admitted": 2, "rejected": 2}
    assert st["tenants"]["gold"]["admitted"] == 5
    # past the label cap (and for non-identifier names) the metric
    # children collapse into __other__; enforcement stays exact
    for t in ("t1", "t2", "t3", "t4", "bad name!"):
        q.try_acquire(t)
    fam = metrics.REGISTRY.snapshot()["paddle_tpu_tenant_requests"]
    mine = {v["labels"]["tenant"] for v in fam["values"]
            if v["labels"]["instance"] == q.obs_instance}
    assert "__other__" in mine
    assert "t4" not in mine and "bad name!" not in mine
    assert len(st["overrides"]) == 1


def test_tenant_bucket_refills_at_its_rate(pkg):
    mod, _ = pkg
    q = mod.TenantQuotas(rate=2.0, burst=1)
    assert q.try_acquire("a", now=100.0) == (True, 0.0)
    ok, retry = q.try_acquire("a", now=100.1)
    assert not ok and retry == pytest.approx(0.4)
    assert q.try_acquire("a", now=100.6)[0]       # 0.2 + 0.5 * 2 >= 1


def test_rate_zero_means_unlimited(pkg):
    mod, _ = pkg
    q = mod.TenantQuotas(rate=0.0)
    for _ in range(50):
        assert q.try_acquire("anyone")[0]
    q.check("anyone")                      # never raises
    assert q.stats()["tenants"]["anyone"]["admitted"] == 51


def test_quota_defaults_follow_the_flags():
    from paddle_tpu_torch.core import flags
    assert (flags.get_flag("serving_tenant_rate"),
            flags.get_flag("serving_tenant_burst"),
            flags.get_flag("serving_tenant_label_cap")) == (0.0, 0, 16)
    old = flags.get_flag("serving_tenant_rate")
    try:
        flags.set_flags({"serving_tenant_rate": 3.5})
        q = tbatcher.TenantQuotas()
        assert q.rate == 3.5 and q.burst == 4      # ceil(rate)
    finally:
        flags.set_flags({"serving_tenant_rate": old})


def test_batcher_stress_every_caller_gets_its_own_rows(pkg):
    """More callers than cores, a shortened switch interval: every caller
    gets exactly its rows back and no request or row is lost or counted
    twice."""
    import sys
    mod, _ = pkg
    b = mod.DynamicBatcher(lambda feed: [feed["v"] * 2.0], max_batch=16,
                           max_delay_ms=1, capacity=1024)
    n_threads, per = 32, 10
    bad, rows = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def caller(i):
            for j in range(per):
                n = 1 + (i + j) % 3
                v = np.full((n, 2), float(i * per + j))
                out = b.submit({"v": v})[0]
                rows.append(n)
                if not np.array_equal(out, v * 2.0):
                    bad.append((i, j))

        ts = _start(caller, n_threads)
        for t in ts:
            t.join(30.0)
            assert not t.is_alive(), "a caller is still blocked"
    finally:
        sys.setswitchinterval(old)
    assert not bad and len(rows) == n_threads * per
    st = b.stats()
    assert st["requests"] == n_threads * per and st["rejected"] == 0
    assert sum(k * v for k, v in st["batch_size_hist"].items()) == sum(rows)
    assert st["batches"] == sum(st["batch_size_hist"].values())
    assert b.close()
