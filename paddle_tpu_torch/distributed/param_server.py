"""Host-side parameter server: sync barriers, async SGD, bounded staleness
(counterpart of paddle_tpu/distributed/param_server.py, ported whole: the
same rules, barriers, leases, dedup, snapshots, checkpoints and wire).

Reference capabilities reproduced (SURVEY.md §2.3 "DP (sync+async)"):

* sync mode — the listen_and_serv loop: block until ``fan_in`` trainers have
  pushed gradients + batch barriers, aggregate, run the optimizer, release
  (operators/listen_and_serv_op.cc:102-165; trainer side send_op.cc:52-103
  send-all -> batch barrier -> get-all).
* async mode — ParameterServer2-style asyncSGD (pserver/ParameterServer2.h:
  468): each push applies immediately; trainers proceed without waiting for
  each other, bounded by ``max_staleness``.
* sharding — parameters round-robin across servers by name
  (distribute_transpiler.py:92 split_dense_variable + round robin
  distributed_spliter.py:16), optimizer state living WITH the shard.
* fault tolerance — ``save_checkpoint`` persists params + optimizer state +
  progress counters + replay-dedup marks atomically (tmp + os.replace);
  ``serve(checkpoint_path=...)`` restores on startup and auto-checkpoints
  as updates apply. Trainer pushes carry a per-trainer monotonic sequence
  number, so a push replayed by an RPC retry is answered from the server's
  dedup table instead of double-applied.

The server is pure numpy (no torch): its arithmetic is the reference's bit
for bit, a checkpoint is a plain pickle of numpy state that either package
restores, and a shard process imports neither torch nor a device runtime
(distributed/launch.py starts it in a fresh interpreter). Trainers are this
package's executors: a fetched gradient (numpy, or a ``SparseRows`` whose
tensors lie on the card) goes on the wire as numpy, and
:func:`install_params` puts pulled values back into the scope's tensors on
the executor's device.
"""

from __future__ import annotations

import contextvars
import functools
import os
import pickle
import threading
import time
import warnings

import numpy as np

from ..core.flags import get_flag
from ..core.profiler import trace_context
from ..obs.metrics import REGISTRY as _METRICS, next_instance
from ..obs.recorder import record as _flight_record
from .rpc import RpcServer, RpcClient, SparseGrad, _host

# membership-churn counters (satellite of the lease-based barrier): a
# round that SHRANK waited only until a dead member's lease expired; a
# round that BROKE waited out the full barrier timeout and discarded its
# partial aggregation, failing every blocked pusher. Scraped off the
# shard child's registry into the fleet view (OnlineLearningLoop.stats).
_M_ROUND_SHRUNK = _METRICS.counter(
    "paddle_tpu_pserver_round_shrunk",
    "sync-round barrier members dropped mid-round (lease expired or "
    "trainer deregistered) so the round applied without them, per shard "
    "instance", labels=("instance",))
_M_ROUND_BROKEN = _METRICS.counter(
    "paddle_tpu_pserver_round_broken",
    "sync rounds invalidated by a barrier timeout (partial aggregation "
    "discarded, every blocked pusher failed with TimeoutError), per "
    "shard instance", labels=("instance",))


# ---------------------------------------------------------------------------
# server-side optimizers (the paddle/optimizer C++ lib the Go pserver links,
# paddle/optimizer/parameter_optimizer.h — numpy here).
#
# Each rule has two entry points: ``apply`` (dense, rebinds a fresh array)
# and ``apply_rows`` (sparse, the reference's lazy optimizer branches —
# operators/adam_op.h SparseAdamFunctor, sgd_op.cu): only the rows a
# SparseGrad touched are read and written, IN PLACE, so apply cost is
# O(touched rows) not O(table). ``rows`` must be duplicate-free
# (SparseGrad.merged_rows dedups first) — fancy-index in-place updates
# silently drop duplicate contributions otherwise.
# ---------------------------------------------------------------------------

class SgdRule:
    def __init__(self, lr=0.01):
        self.lr = lr

    def init(self, value):
        return {}

    def apply(self, value, grad, state):
        return value - self.lr * grad

    def apply_rows(self, value, rows, grows, state):
        value[rows] -= self.lr * grows


class MomentumRule:
    def __init__(self, lr=0.01, mu=0.9):
        self.lr, self.mu = lr, mu

    def init(self, value):
        return {"velocity": np.zeros_like(value)}

    def apply(self, value, grad, state):
        state["velocity"] = self.mu * state["velocity"] + grad
        return value - self.lr * state["velocity"]

    def apply_rows(self, value, rows, grows, state):
        v = state["velocity"]
        v[rows] = self.mu * v[rows] + grows
        value[rows] -= self.lr * v[rows]


class AdamRule:
    def __init__(self, lr=0.001, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, value):
        return {"m1": np.zeros_like(value), "m2": np.zeros_like(value),
                "t": 0}

    def apply(self, value, grad, state):
        # ``t`` is a scalar until the first sparse push converts it to a
        # per-row counter (lazy adam: each row's bias correction tracks how
        # often THAT row updated); the dense path handles both forms
        state["t"] = state["t"] + 1
        state["m1"] = self.b1 * state["m1"] + (1 - self.b1) * grad
        state["m2"] = self.b2 * state["m2"] + (1 - self.b2) * grad * grad
        t = state["t"]
        lr = self.lr * np.sqrt(1 - self.b2 ** t) / (1 - self.b1 ** t)
        if np.ndim(lr):
            lr = lr.astype(np.float32).reshape(
                lr.shape + (1,) * (value.ndim - 1))
        return value - lr * state["m1"] / (np.sqrt(state["m2"]) + self.eps)

    def apply_rows(self, value, rows, grows, state):
        if np.ndim(state["t"]) == 0:
            state["t"] = np.full((value.shape[0],), int(state["t"]),
                                 np.int64)
        t = state["t"]
        t[rows] += 1
        tr = t[rows]
        m1, m2 = state["m1"], state["m2"]
        m1[rows] = self.b1 * m1[rows] + (1 - self.b1) * grows
        m2[rows] = self.b2 * m2[rows] + (1 - self.b2) * grows * grows
        lr = (self.lr * np.sqrt(1 - self.b2 ** tr)
              / (1 - self.b1 ** tr)).astype(np.float32)
        lr = lr.reshape(lr.shape + (1,) * (value.ndim - 1))
        value[rows] = value[rows] - lr * m1[rows] \
            / (np.sqrt(m2[rows]) + self.eps)


OPTIMIZERS = {"sgd": SgdRule, "momentum": MomentumRule, "adam": AdamRule}


class ParameterServer:
    """One shard server. mode="sync" aggregates fan_in pushes per step;
    mode="async" applies each push immediately with bounded staleness.

    ``barrier_timeout_s`` bounds the sync fan-in barrier and the async
    staleness wait (default: the ``pserver_barrier_timeout_s`` flag).
    ``checkpoint_path`` + ``checkpoint_every`` enable crash tolerance: the
    full server state is persisted atomically every ``checkpoint_every``
    applied updates (sync rounds / async pushes), and ``restore()`` loads
    it back after a restart."""

    def __init__(self, optimizer="sgd", opt_kwargs=None, mode="async",
                 fan_in=1, max_staleness=None, barrier_timeout_s=None,
                 checkpoint_path=None, checkpoint_every=1,
                 trainer_lease_s=None):
        self._rule = OPTIMIZERS[optimizer](**(opt_kwargs or {}))
        self._mode = mode
        self._fan_in = fan_in
        self._max_staleness = max_staleness
        if barrier_timeout_s is None:
            barrier_timeout_s = get_flag("pserver_barrier_timeout_s")
        self._barrier_timeout = float(barrier_timeout_s)
        # lease-based sync membership (the elastic-trainer contract): a
        # trainer that register_trainer()s joins the lease set; a round's
        # barrier waits on the lease set SNAPSHOT taken at round-open,
        # and an expired/deregistered member shrinks the open round's
        # barrier instead of timing it out. With no registrations (or
        # trainer_lease_s=0) barriers stay purely count-based (fan_in).
        if trainer_lease_s is None:
            trainer_lease_s = get_flag("pserver_trainer_lease_s")
        self._lease_s = float(trainer_lease_s)
        self._leases = {}          # trainer_id -> monotonic lease expiry
        # the two-phase join (see register_trainer): the first round of
        # each joined trainer, and the trainers between prepare and commit
        # (while any is, no round opens here)
        self._joins = {}
        self._join_holds = set()
        self._round_members = None  # lease-set snapshot at round-open
        self._round_pushed = set()  # members that contributed this round
        self._params = {}
        self._opt_state = {}
        # params that have taken an in-place rowwise apply (copy-on-write
        # marker — see _apply_locked/pull)
        self._sparse_applied = set()
        self._lock = threading.Condition()
        # sync-mode accumulation
        self._pending = {}
        self._push_count = 0
        self._round = 0
        self._broken_round = -1  # round invalidated by a barrier timeout
        # async-mode staleness tracking
        self._trainer_steps = {}
        # replay dedup: per-trainer newest APPLIED seq (its gradient is in
        # the params) and the newest push's (seq, outcome) for answering
        # duplicates — outcome None while the original is still in flight
        self._applied_seq = {}
        self._seq_result = {}
        self._round_contribs = []  # (trainer_id, seq) in the open sync round
        # checkpointing: snapshots are TAKEN under the condition lock (at
        # the apply point, so dedup marks and params are captured at the
        # same instant) but WRITTEN outside it — disk IO must not stall
        # every other trainer's push/pull or the supervisor's heartbeat
        self._checkpoint_path = checkpoint_path
        self._checkpoint_every = int(checkpoint_every)
        self._updates_since_ckpt = 0
        self._state_version = 0       # bumped per applied update
        self._due_ckpt = None         # (version, snapshot) pending a write
        self._ckpt_io_lock = threading.Lock()
        self._ckpt_written_version = -1
        # wire counters of the RpcServer fronting this shard (serve() and
        # PServerProgram attach it) — surfaced through stats()
        self._wire_stats = None
        # consistent-cut snapshot store (online CheckpointFreezer):
        # tag -> frozen copy of (round, params). Bounded FIFO so a freezer
        # that dies between prepare and release cannot leak server memory
        # without bound; entries are private copies, so fetch can
        # serialize them OUTSIDE the lock with no torn bytes
        self._snapshots = {}
        self._snapshot_order = []
        self._snapshot_cap = 4
        self.obs_instance = next_instance("pserver")
        self._m_round_shrunk = _M_ROUND_SHRUNK.labels(
            instance=self.obs_instance)
        self._m_round_broken = _M_ROUND_BROKEN.labels(
            instance=self.obs_instance)

    def attach_wire_stats(self, wire_stats):
        self._wire_stats = wire_stats

    # ---- RPC surface ----
    def init_params(self, params):
        """First trainer wins (reference: startup program runs once;
        go/pserver InitParam) — which also makes a restarted server's
        RESTORED params win over a resuming trainer's re-init."""
        with self._lock:
            for name, value in params.items():
                if name not in self._params:
                    # own the buffer: sparse applies update rows of the
                    # stored array IN PLACE, which must never alias a
                    # caller's array
                    self._params[name] = np.array(value, dtype=np.float32)
                    self._opt_state[name] = self._rule.init(self._params[name])
            return True

    def pull(self, names=None):
        with self._lock:
            names = names or list(self._params)
            # params that have taken a rowwise apply mutate IN PLACE, and
            # the RPC layer serializes the response OUTSIDE the lock —
            # those must be copied under the lock or a concurrent sparse
            # push could tear the bytes mid-send. Dense-only params are
            # safe to return by reference: dense rules rebind fresh
            # arrays, and _apply_locked copy-on-writes a param before its
            # FIRST in-place apply, so an array handed out here is never
            # mutated afterwards.
            return {n: self._params[n].copy()
                    if n in self._sparse_applied else self._params[n]
                    for n in names}

    # ---- trainer membership leases (elastic sync barriers) ----
    def register_trainer(self, trainer_id, join=None):
        """Join (or renew) this shard's sync-membership lease for
        ``trainer_id``. Pushes renew an existing lease (see push), so a
        worker actively training stays a member without extra traffic; a
        SIGKILLed trainer stops renewing and the open round shrinks past
        it at expiry. Callers register when they acquire work and
        deregister when idle — an idle-but-alive member would stall its
        peers' barriers for the lease duration every round. Returns the
        lease duration for the client's renewal bookkeeping.

        Without ``join`` (the reference's form) a new member counts from
        this shard's next round-open. Shards open their rounds at
        different moments, so a registration that lands between two
        shards' round-opens would make the trainer a member of round r on
        one shard and of r + 1 on another, and their round counters part
        for good. ``join`` is the two-phase join that
        ``ParamClient.register_trainer`` sends to every shard instead:
        ``"prepare"`` renews a member's lease, and for a new member also
        holds back this shard's round-opens and answers ``next_round``,
        the first round not open here yet; ``join=R`` (the largest
        ``next_round`` of the shards) commits: the trainer is a member from
        round R on, here as on every shard, and a push of its made before
        round R waits for it. A prepared join that is never committed
        holds the round-opens until its lease expires."""
        with self._lock:
            if self._lease_s <= 0:
                return {"lease_s": 0.0}
            now = time.monotonic()
            new = self._leases.get(trainer_id, now) <= now
            self._leases[trainer_id] = now + self._lease_s
            out = {"lease_s": self._lease_s}
            if join == "prepare":
                if new or trainer_id in self._join_holds:
                    self._join_holds.add(trainer_id)
                    self._joins.pop(trainer_id, None)
                    out["next_round"] = self._round + (self._push_count > 0)
            elif join is not None:
                self._join_holds.discard(trainer_id)
                self._joins[trainer_id] = int(join)
            # waiters recompute their next-expiry wait slice
            self._lock.notify_all()
            return out

    def deregister_trainer(self, trainer_id):
        """Graceful leave: drop the lease NOW and shrink the open round
        (if this member had not pushed into it) without waiting for
        expiry. Returns True when a lease existed."""
        with self._lock:
            had = self._leases.pop(trainer_id, None) is not None
            self._drop_join_locked(trainer_id)
            if had:
                self._shrink_member_locked(trainer_id,
                                           reason="deregistered")
            return had

    def _drop_join_locked(self, trainer_id):
        self._joins.pop(trainer_id, None)
        if trainer_id in self._join_holds:
            self._join_holds.discard(trainer_id)
            self._lock.notify_all()

    def _live_lease_set_locked(self, now=None):
        """Reap already-expired leases and return the live trainer-id
        set. Called at round-open, so a long-dead trainer is never
        waited on even once."""
        now = time.monotonic() if now is None else now
        for t in [t for t, exp in self._leases.items() if exp <= now]:
            del self._leases[t]
            self._drop_join_locked(t)
            _flight_record("lease_expired", component=self.obs_instance,
                           trainer_id=t, round=self._round)
        return set(self._leases)

    def _round_member_set_locked(self):
        """The open round's barrier membership: the live leases, less the
        joins not yet committed or committed to a later round."""
        live = self._live_lease_set_locked()
        for t in [t for t, r in self._joins.items() if r <= self._round]:
            del self._joins[t]
        return {t for t in live
                if t not in self._join_holds and t not in self._joins}

    def _await_round_locked(self, trainer_id):
        """Hold a sync push back until it may go into a round: a push that
        would open one waits while a join is prepared and not committed,
        and a joined trainer's push waits for its first round. Where no
        other member is left to run the rounds before it, they are
        skipped empty (as a broken round is), so that this shard's
        counter stays in step with its peers'."""
        deadline = time.monotonic() + self._barrier_timeout
        waited = False
        while True:
            self._live_lease_set_locked()
            first = self._joins.get(trainer_id)
            if first is not None and first > self._round \
                    and self._push_count == 0 and not self._join_holds \
                    and not self._round_member_set_locked():
                self._round = first
                self._lock.notify_all()
            if not ((first is not None and first > self._round)
                    or (self._push_count == 0 and self._join_holds)):
                break
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError("sync push timed out waiting for its "
                                   "round to open")
            holders = [self._leases[t] for t in self._join_holds
                       if t in self._leases]
            wake = min([deadline] + holders)
            self._lock.wait(timeout=max(wake - now, 0.01))
            waited = True
        if waited and trainer_id in self._leases:
            # held back, not idle: the lease counts from the release
            self._leases[trainer_id] = time.monotonic() + self._lease_s

    def _next_lease_expiry_locked(self):
        """Earliest lease expiry among open-round members still being
        waited on — the wait-slice bound that lets a barrier waiter wake
        AT expiry instead of sleeping out the full barrier timeout."""
        pending = [exp for t, exp in self._leases.items()
                   if self._round_members is not None
                   and t in self._round_members
                   and t not in self._round_pushed]
        return min(pending) if pending else None

    def _shrink_member_locked(self, trainer_id, reason):
        """Drop one member from the open round's barrier (lease expired
        or deregistered). Members that already pushed are left alone —
        their gradient is in the round and nobody waits on them."""
        if (self._round_members is None
                or trainer_id not in self._round_members
                or trainer_id in self._round_pushed):
            return
        self._round_members.discard(trainer_id)
        self._m_round_shrunk.inc()
        # the membership-churn WHY an incident bundle needs: which
        # trainer the barrier stopped waiting for, and what remains
        _flight_record("round_shrunk", component=self.obs_instance,
                       trainer_id=trainer_id, round=self._round,
                       reason=reason,
                       remaining=sorted(map(str, self._round_members)))
        self._lock.notify_all()

    def _reap_expired_members_locked(self):
        now = time.monotonic()
        for t in [t for t, exp in self._leases.items() if exp <= now]:
            del self._leases[t]
            self._drop_join_locked(t)
            self._shrink_member_locked(t, reason="lease_expired")

    def push(self, grads, trainer_id=0, seq=None):
        """Apply (sync: accumulate) gradients. ``seq`` is the trainer's
        monotonic push counter (ParamClient assigns it): a replayed push —
        an RPC retry after the response was lost — is detected server-side
        and answered with the original outcome instead of re-applied. A
        replay of a push still blocked at the barrier joins the wait."""
        with self._lock:
            # any push is proof of life: renew an existing lease so a
            # trainer whose step time approaches the lease need not race
            # its own heartbeat
            if self._lease_s > 0 and trainer_id in self._leases:
                self._leases[trainer_id] = time.monotonic() + self._lease_s
            if seq is None:
                if self._mode == "sync":
                    out = self._push_sync(grads)
                else:
                    out = self._push_async(grads, trainer_id)
            else:
                newest = self._newest_seq_locked(trainer_id)
                if newest is not None and seq <= newest:
                    return self._replay_locked(trainer_id, seq)
                self._seq_result[trainer_id] = [seq, None]
                try:
                    if self._mode == "sync":
                        out = self._push_sync(grads, trainer_id, seq)
                    else:
                        out = self._push_async(grads, trainer_id, seq)
                except Exception as e:
                    self._seq_result[trainer_id] = [seq, ("err", e)]
                    self._lock.notify_all()
                    raise
                self._seq_result[trainer_id] = [seq, ("ok", out)]
                self._lock.notify_all()
            # claim any checkpoint this push made due BEFORE releasing the
            # lock (only the completing thread sees its own snapshot), then
            # write it outside the lock but before acking — durable state
            # always includes an acked update when checkpoint_every=1
            due, self._due_ckpt = self._due_ckpt, None
        if due is not None:
            self._write_checkpoint(self._checkpoint_path, *due)
        return out

    def _newest_seq_locked(self, trainer_id):
        rec = self._seq_result.get(trainer_id)
        newest = self._applied_seq.get(trainer_id)
        if rec is not None and (newest is None or rec[0] > newest):
            newest = rec[0]
        return newest

    def _replay_locked(self, trainer_id, seq):
        rec = self._seq_result.get(trainer_id)
        if rec is not None and rec[0] == seq:
            # duplicate of the newest push; the original may still be
            # blocked at the barrier (its connection died mid-wait)
            while rec is not None and rec[0] == seq and rec[1] is None:
                if not self._lock.wait(timeout=self._barrier_timeout):
                    raise TimeoutError(
                        "replayed push timed out waiting for the original")
                rec = self._seq_result.get(trainer_id)
            if rec is not None and rec[0] == seq:
                kind, payload = rec[1]
                if kind == "err":
                    raise payload
                return payload
        # older than the newest applied seq (or known only through a
        # restored checkpoint's dedup table): its effect is already in the
        # params — answer with the authoritative progress counter
        if self._mode == "sync":
            return self._round
        return self._trainer_steps.get(trainer_id, 0)

    def _accumulate_locked(self, name, g):
        """Fold one trainer's gradient into the open round's accumulator.
        Dense: the first push COPIES into an owned buffer and later pushes
        accumulate in place (``acc += g``) — no fresh allocation per
        trainer. Sparse: SparseGrads collect in a list (merged once at
        apply time); a round mixing dense and sparse pushes for the same
        param densifies the sparse side."""
        acc = self._pending.get(name)
        if isinstance(g, SparseGrad):
            if acc is None:
                self._pending[name] = [g]
            elif isinstance(acc, list):
                acc.append(g)
            else:                       # dense accumulator: scatter-add in
                rows, vals = g.merged_rows()
                np.add.at(acc, rows, vals)
        else:
            g = np.asarray(g, np.float32)
            if acc is None:
                self._pending[name] = np.array(g, dtype=np.float32)
            elif isinstance(acc, list):
                dense = _densify(acc, self._params[name].shape)
                dense += g
                self._pending[name] = dense
            else:
                acc += g

    def _apply_locked(self, name, g, divisor=1):
        """Run the optimizer on one accumulated gradient. Sparse grads
        (or lists of them from a sync round) merge duplicates and take the
        rowwise branch — O(touched rows); dense grads keep the rebind-only
        rule.apply path."""
        if isinstance(g, list):
            g = _concat_sparse(g)
        if isinstance(g, SparseGrad):
            if name not in self._sparse_applied:
                # copy-on-write before the param's FIRST in-place rowwise
                # update: references pull() handed out while the param was
                # dense-only stay immutable (see pull)
                self._params[name] = self._params[name].copy()
                self._sparse_applied.add(name)
            rows, vals = g.merged_rows()
            if divisor != 1:
                vals = vals / divisor
            self._rule.apply_rows(self._params[name], rows, vals,
                                  self._opt_state[name])
        else:
            g = np.asarray(g, np.float32)
            if divisor != 1:
                g = g / divisor
            self._params[name] = self._rule.apply(self._params[name], g,
                                                  self._opt_state[name])

    def _sync_ready_locked(self):
        """Is the open round complete? Lease mode: every member of the
        round-open snapshot (shrunk past expiries) has pushed. Count
        mode (no leases registered): the fan_in-th push arrived."""
        if self._round_members is not None:
            return (bool(self._round_members)
                    and self._round_members <= self._round_pushed)
        return self._push_count >= self._fan_in

    def _apply_round_locked(self):
        """Optimize with the round's accumulated gradients and release
        the barrier. Callable from the completing PUSHER (the classic
        fan-in release) or from a WAITER whose shrink just made the
        round complete — either way the whole apply happens in one
        critical section with the seq dedup marks."""
        for n, g in self._pending.items():
            self._apply_locked(n, g, divisor=self._push_count)
        self._pending = {}
        self._push_count = 0
        self._round += 1
        # every contributor's gradient is now IN the params; mark the
        # seqs applied in the SAME critical section (and checkpoint if
        # due) so no checkpoint can hold the update without its dedup
        # marks or the marks without the update
        for t, s in self._round_contribs:
            self._applied_seq[t] = s
        # a member that waited at the barrier was not idle: its lease
        # counts from the round's close, not from its push, so a wait on
        # a slow or dead peer does not age it out of the next round
        now = time.monotonic()
        for t in self._round_pushed:
            if t in self._leases:
                self._leases[t] = now + self._lease_s
        self._round_contribs = []
        self._round_members = None
        self._round_pushed = set()
        self._maybe_checkpoint_locked()
        self._lock.notify_all()

    def _break_round_locked(self, my_round):
        """Barrier timeout: discard the whole round's partial
        aggregation AND advance the round so retried pushes accumulate
        fresh, then fail every waiter. Nothing applied -> no seqs
        marked; a trainer-level retry re-sends in full. Typed counter +
        flight event: blocked pushers being discarded used to be
        invisible in incident bundles."""
        self._broken_round = my_round
        self._round += 1
        self._pending = {}
        self._push_count = 0
        self._round_contribs = []
        self._round_members = None
        self._round_pushed = set()
        self._m_round_broken.inc()
        _flight_record("round_broken", component=self.obs_instance,
                       round=my_round, waited_s=self._barrier_timeout)
        self._lock.notify_all()

    def _push_sync(self, grads, trainer_id=None, seq=None):
        """Accumulate; the round-completing push triggers the optimize
        step and wakes all waiters (the batch-barrier contract). With
        trainer leases registered, the barrier waits on the lease set
        snapshotted at round-open and an expired member SHRINKS it;
        without leases it is the classic fan_in count. A barrier timeout
        ABANDONS the round (advancing the round counter), so retried
        pushes start a fresh aggregation rather than double-counting
        into the broken one."""
        with self._lock:
            if self._lease_s > 0:
                self._await_round_locked(trainer_id)
            my_round = self._round
            if self._push_count == 0:
                # round-open: this round's barrier membership is the
                # CURRENT live lease set, less the joins of later rounds
                # (None -> count mode)
                self._round_pushed = set()
                self._round_members = (self._round_member_set_locked()
                                       or None) if self._lease_s > 0 \
                    else None
            for n, g in grads.items():
                self._accumulate_locked(n, g)
            if seq is not None:
                self._round_contribs.append((trainer_id, seq))
            self._push_count += 1
            if trainer_id is not None and self._round_members is not None:
                # a hot-joined trainer pushing mid-round contributes
                # immediately (it joins the snapshot as already-pushed,
                # so it never delays the barrier)
                self._round_members.add(trainer_id)
                self._round_pushed.add(trainer_id)
            if self._sync_ready_locked():
                self._apply_round_locked()
                return self._round
            deadline = time.monotonic() + self._barrier_timeout
            while (self._round == my_round
                   and self._broken_round != my_round):
                now = time.monotonic()
                if now >= deadline:
                    self._break_round_locked(my_round)
                    raise TimeoutError("sync barrier timed out")
                wait_s = deadline - now
                nxt = self._next_lease_expiry_locked()
                if nxt is not None:
                    # wake AT the next member lease expiry, not after
                    # the full barrier budget — the shrink path
                    wait_s = min(wait_s, max(nxt - now, 0.01))
                self._lock.wait(timeout=wait_s)
                if (self._round != my_round
                        or self._broken_round == my_round):
                    break
                if self._round_members is not None:
                    self._reap_expired_members_locked()
                    if self._sync_ready_locked():
                        self._apply_round_locked()
                        break
            if self._broken_round == my_round:
                raise TimeoutError("sync barrier broken by a peer "
                                   "timeout; round discarded")
            return self._round

    def _push_async(self, grads, trainer_id, seq=None):
        with self._lock:
            if self._max_staleness is not None and self._trainer_steps:
                # block while this trainer is too far ahead of the slowest
                def too_fast():
                    # check the step count AFTER this push would apply
                    me = self._trainer_steps.get(trainer_id, 0) + 1
                    others = [s for t, s in self._trainer_steps.items()
                              if t != trainer_id]
                    if not others:
                        return False
                    return me - min(others) > self._max_staleness

                while too_fast():
                    if not self._lock.wait(timeout=self._barrier_timeout):
                        raise TimeoutError("staleness wait timed out")
            for n, g in grads.items():
                self._apply_locked(n, g)
            self._trainer_steps[trainer_id] = \
                self._trainer_steps.get(trainer_id, 0) + 1
            if seq is not None:
                self._applied_seq[trainer_id] = seq
            self._maybe_checkpoint_locked()
            self._lock.notify_all()
            return self._trainer_steps[trainer_id]

    def stats(self):
        with self._lock:
            now = time.monotonic()
            out = {"params": sorted(self._params), "round": self._round,
                   "trainer_steps": dict(self._trainer_steps),
                   "applied_seq": dict(self._applied_seq),
                   # lease surface: who is a member, how long each lease
                   # has left, and the churn counters — what the elastic
                   # tests and incident bundles read
                   "trainer_leases": {t: round(exp - now, 3)
                                      for t, exp in self._leases.items()},
                   "round_members": (sorted(map(str, self._round_members))
                                     if self._round_members is not None
                                     else None),
                   "rounds_shrunk": int(self._m_round_shrunk.value),
                   "rounds_broken": int(self._m_round_broken.value)}
        if self._wire_stats is not None:
            # bytes in/out + per-method call counts and latency of the RPC
            # front-end (rpc.WireStats) — the reference pserver's
            # sendrecv byte accounting, queryable by trainers and tools
            out["wire"] = self._wire_stats.snapshot()
        return out

    # ---- consistent-cut snapshots (the online-learning freeze path) ----
    def snapshot_prepare(self, tag):
        """Freeze a private copy of this shard's params AT ITS CURRENT
        SYNC ROUND, keyed by ``tag``, and return ``{"round", "names"}``.
        The copy happens under the apply lock (one memcpy of the shard),
        so a concurrent push can never tear it; the caller (online
        CheckpointFreezer via ParamClient.snapshot_prepare) prepares the
        SAME tag on every shard and verifies the returned rounds agree —
        a barrier-consistent cut, taken between a single trainer's step
        boundaries where no push is in flight. The heavy transfer happens
        later through :meth:`snapshot_fetch`, OFF the training hot path.

        The store is bounded (oldest tag evicted) so a freezer that
        crashed between prepare and release cannot grow server memory.

        Re-preparing a LIVE tag answers from the stored cut (same round,
        no re-copy): the freezer's client retries on connection failures,
        and a resend whose first attempt landed must see the original
        answer, not an error — prepare is idempotent per tag, like push
        under its seq dedup."""
        with self._lock:
            snap = self._snapshots.get(tag)
            if snap is not None:
                return {"round": snap["round"],
                        "names": sorted(snap["params"])}
            while len(self._snapshot_order) >= self._snapshot_cap:
                old = self._snapshot_order.pop(0)
                self._snapshots.pop(old, None)
            self._snapshots[tag] = {
                "round": self._round,
                "params": {n: v.copy() for n, v in self._params.items()},
            }
            self._snapshot_order.append(tag)
            return {"round": self._round, "names": sorted(self._params)}

    def snapshot_fetch(self, tag, names=None):
        """Return the frozen cut ``{"round", "params": {name: array}}``.
        The arrays are the prepare-time private copies — nothing mutates
        them, so serializing the response outside the lock is safe and
        the bytes are bitwise the prepare-instant state."""
        with self._lock:
            snap = self._snapshots.get(tag)
            if snap is None:
                raise ValueError(
                    f"unknown snapshot tag {tag!r} on this shard (never "
                    "prepared, already released, or evicted — or the "
                    "shard restarted since prepare; re-cut)")
            params = snap["params"]
            if names is not None:
                params = {n: params[n] for n in names}
            return {"round": snap["round"], "params": params}

    def snapshot_release(self, tag):
        """Drop the frozen cut; returns True when the tag existed.
        Unknown tags are a no-op (release is the cleanup path of failed
        cuts, which must be safe to over-call)."""
        with self._lock:
            if tag in self._snapshot_order:
                self._snapshot_order.remove(tag)
            return self._snapshots.pop(tag, None) is not None

    # ---- checkpoint / restore (the Go pserver's crash contract) ----
    def save_checkpoint(self, path=None):
        """Atomically persist the full server state: params, optimizer
        state, sync round, per-trainer step counters, and the replay-dedup
        table. The dedup marks travel WITH the params: a restore rolls both
        back to the same instant, so a replayed push re-applies exactly
        when its effect was lost with the crash and never when it
        survived. Returns the path written."""
        path = path or self._checkpoint_path
        if not path:
            raise ValueError("no checkpoint path: pass path= or construct "
                             "with checkpoint_path=")
        with self._lock:
            version, snapshot = self._snapshot_locked()
        self._write_checkpoint(path, version, snapshot)
        return path

    def _snapshot_locked(self):
        """Consistent point-in-time copy of the server state. Arrays are
        DEEP-copied: the dense optimizer paths rebind fresh arrays, but
        the rowwise sparse branches (apply_rows) update rows in place —
        a shallow snapshot could be mutated between capture and the
        off-lock disk write. The copy is a straight memcpy under the
        lock, amortized by ``checkpoint_every``."""
        state = {
            "version": 1,
            "params": {n: v.copy() for n, v in self._params.items()},
            "opt_state": {n: {k: v.copy() if isinstance(v, np.ndarray)
                              else v for k, v in st.items()}
                          for n, st in self._opt_state.items()},
            "round": self._round,
            "trainer_steps": dict(self._trainer_steps),
            "applied_seq": dict(self._applied_seq),
            # only ACKED outcomes persist; in-flight pushes are covered by
            # applied_seq once their round lands
            "acked": {t: (rec[0], rec[1][1])
                      for t, rec in self._seq_result.items()
                      if rec[1] is not None and rec[1][0] == "ok"},
            # lease HOLDERS (not deadlines — monotonic clocks die with
            # the process) so a restarted shard re-opens rounds with the
            # same membership snapshot as its peers. Busy trainers renew
            # on push but only REGISTER when they acquire work, so a
            # restart that dropped the table would open rounds with a
            # smaller member set, occasionally apply on a lone pusher,
            # and drift its round counter permanently out of lockstep —
            # tearing every snapshot cut from then on.
            "lease_holders": list(self._leases),
        }
        return self._state_version, state

    def _write_checkpoint(self, path, version, state):
        """Serialize + write OUTSIDE the condition lock; the io lock
        serializes concurrent writers and the version guard keeps a slow
        older snapshot from clobbering a newer one on disk."""
        with self._ckpt_io_lock:
            if version <= self._ckpt_written_version:
                return  # a newer snapshot already reached the disk
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(state, f)
            os.replace(tmp, path)  # atomic (the master's snapshot pattern)
            self._ckpt_written_version = version

    def _maybe_checkpoint_locked(self):
        """Called at each applied update, under the lock: records the
        snapshot as due; the pushing thread writes it after releasing."""
        self._state_version += 1
        if not self._checkpoint_path or self._checkpoint_every <= 0:
            return
        self._updates_since_ckpt += 1
        if self._updates_since_ckpt >= self._checkpoint_every:
            self._updates_since_ckpt = 0
            self._due_ckpt = self._snapshot_locked()

    def restore(self, path=None):
        """Load a ``save_checkpoint`` file into this server. Returns True
        when state was restored; False when the file is missing or
        unreadable — a corrupt/truncated checkpoint warns and starts fresh
        (a crashed server must come back up), and a stale ``.tmp`` left by
        a crash mid-checkpoint is cleaned away."""
        path = path or self._checkpoint_path
        if not path:
            raise ValueError("no checkpoint path: pass path= or construct "
                             "with checkpoint_path=")
        tmp = path + ".tmp"
        with self._lock:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            if not os.path.exists(path):
                return False
            try:
                with open(path, "rb") as f:
                    state = pickle.load(f)
                # preserve stored dtypes exactly — a restore must be
                # bitwise, not a float32 re-coercion of what was saved
                params = {n: np.asarray(v)
                          for n, v in state["params"].items()}
                opt_state = state["opt_state"]
                rnd = int(state["round"])
                steps = dict(state["trainer_steps"])
                applied = dict(state["applied_seq"])
                acked = {t: [s, ("ok", payload)]
                         for t, (s, payload)
                         in state.get("acked", {}).items()}
                lease_holders = list(state.get("lease_holders", []))
            except Exception as e:  # corrupt/truncated/missing-field
                warnings.warn(
                    f"pserver checkpoint {path!r} unreadable "
                    f"({type(e).__name__}: {e}); starting fresh")
                return False
            self._params = params
            self._opt_state = opt_state
            # restored arrays are fresh (unpickled) — no outstanding pull
            # references; the next sparse apply re-marks (and re-COWs)
            self._sparse_applied = set()
            self._round = rnd
            self._trainer_steps = steps
            self._applied_seq = applied
            self._seq_result = acked
            self._pending = {}
            self._push_count = 0
            self._broken_round = -1
            self._round_contribs = []
            # re-grant the checkpointed lease holders a FRESH ttl: a
            # still-working trainer renews it with its next retried push
            # (it will not re-register — registration happens at task
            # acquisition), a genuinely dead one simply expires lease_s
            # later and shrinks the round, the normal failure path.
            # Restored membership keeps this shard's round-open snapshot
            # identical to its peers', which is what keeps the round
            # counters in lockstep across a shard crash.
            if self._lease_s > 0:
                now = time.monotonic()
                self._leases = {t: now + self._lease_s
                                for t in lease_holders}
            else:
                self._leases = {}
            self._joins = {}
            self._join_holds = set()
            self._round_members = None
            self._round_pushed = set()
            self._updates_since_ckpt = 0
            self._due_ckpt = None
            return True


def _concat_sparse(grads):
    """Concatenate a sync round's SparseGrads for one param into a single
    unmerged SparseGrad (duplicates across trainers merge at apply)."""
    if len(grads) == 1:
        return grads[0]
    rows = np.concatenate([g.rows for g in grads])
    vals = np.concatenate([g.values.astype(np.float32, copy=False)
                           for g in grads], axis=0)
    return SparseGrad(rows, vals, grads[0].nrows)


def _densify(grads, shape):
    """Scatter a list of SparseGrads into a dense fp32 gradient (the
    mixed dense+sparse sync-round path)."""
    out = np.zeros(shape, np.float32)
    for g in grads:
        rows, vals = g.merged_rows()
        np.add.at(out, rows, vals)
    return out


def parse_endpoint(endpoint, default_port=None):
    """'host:port' -> (host, port); ':port' defaults the host to loopback.
    A missing port is a loud ValueError unless default_port is given — a
    port-less pservers entry must fail at parse time, not as an obscure
    connect error later. The one parser for every consumer of endpoint
    strings (transpiler, master client)."""
    if isinstance(endpoint, (tuple, list)):
        # same contract as the string form: host defaults to loopback, the
        # port coerces to int, and a missing/non-numeric port is the same
        # loud ValueError
        host = endpoint[0] if len(endpoint) > 0 else ""
        port = endpoint[1] if len(endpoint) > 1 else None
        if port is None or str(port).strip() == "":
            if default_port is None:
                raise ValueError(
                    f"endpoint {endpoint!r} has no port (want 'host:port')")
            port = default_port
        try:
            port = int(port)
        except (TypeError, ValueError):
            raise ValueError(
                f"endpoint {endpoint!r} has a non-numeric port "
                "(want 'host:port')") from None
        return (host or "127.0.0.1", port)
    host, sep, port = str(endpoint).rpartition(":")
    if not sep:             # no ':' at all -> whole string is the host
        host, port = port, ""
    if not port.strip():
        if default_port is None:
            raise ValueError(
                f"endpoint {endpoint!r} has no port (want 'host:port')")
        port = str(default_port)
    return (host or "127.0.0.1", int(port))


def shard_names(names, n_shards):
    """Round-robin placement (reference distributed_spliter.py:16
    round_robin)."""
    shards = [[] for _ in range(n_shards)]
    for i, n in enumerate(sorted(names)):
        shards[i % n_shards].append(n)
    return shards


def serve(optimizer="sgd", opt_kwargs=None, mode="async", fan_in=1,
          max_staleness=None, address=("127.0.0.1", 0),
          barrier_timeout_s=None, checkpoint_path=None, checkpoint_every=1,
          fault_plan=None, trainer_lease_s=None):
    """Start a ParameterServer's RPC loop in this process (call in a forked
    child, the reference test_recv_op pattern). Returns (server, rpc).

    With ``checkpoint_path``, an existing checkpoint is restored BEFORE
    serving (the crash-restart path) and the server auto-checkpoints every
    ``checkpoint_every`` applied updates. ``fault_plan`` (fault.FaultPlan)
    deterministically injects drops/delays/crashes for tests."""
    ps = ParameterServer(optimizer, opt_kwargs, mode, fan_in, max_staleness,
                         barrier_timeout_s=barrier_timeout_s,
                         checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         trainer_lease_s=trainer_lease_s)
    if checkpoint_path:
        ps.restore()
    rpc = RpcServer(ps, address, fault_plan=fault_plan)
    ps.attach_wire_stats(rpc.wire_stats)
    return ps, rpc


class ParamClient:
    """Trainer-side client over one or more shard servers (reference
    ParameterClient2 sharding, pserver/ParameterClient2.h:216).

    Placement is DERIVED, not negotiated: round-robin over the sorted full
    parameter-name list, so every trainer that knows the names (via
    ``param_names`` or by calling ``init_params``) computes the identical
    layout. Multi-shard pushes go out concurrently — sequential pushes in
    trainer-specific orders would deadlock sync-mode barriers across shards
    (a lock-order inversion between trainers).

    Every ``push`` carries a monotonic sequence number (per trainer), so a
    server answering a retried push (rpc.RetryPolicy reconnect-and-resend
    after a lost response or a pserver restart) deduplicates instead of
    double-applying. ``trainer_id`` must therefore be unique per trainer
    process — two pushers sharing an id would collide in the dedup table.

    Wire: gradients travel on rpc.py's framed tensor codec (``wire=``
    selects the legacy pickle codec for A/B runs). A grad value that is a
    ``core.sparse.SparseRows`` (or rpc.SparseGrad) ships as ids + touched
    rows only — O(touched rows) bytes, the reference's sparse parameter
    update (ParameterServer2 sparse formats / SelectedRows send). The
    ``pserver_wire_dtype`` flag ("fp32"|"fp16") halves dense push bytes;
    the server always accumulates fp32. ``rpc_timeout`` defaults to the
    ``rpc_timeout_s`` flag."""

    def __init__(self, addresses, trainer_id=0, param_names=None,
                 retry=None, rpc_timeout=None, wire="framed",
                 sparse_param_names=()):
        self._clients = [RpcClient(a, timeout=rpc_timeout, retry=retry,
                                   wire=wire)
                         for a in addresses]
        self._placement = {}  # name -> client index
        self._trainer_id = trainer_id
        self._seq = 0
        self._seq_lock = threading.Lock()
        # params the transpiler marked sparse (embedding tables): a DENSE
        # gradient pushed for one of these is sparsified to its touched
        # rows before hitting the wire (see _wire_grad)
        self._sparse_names = set(sparse_param_names)
        self._pool = None   # lazy per-shard fan-out pool (see _fanout)
        if param_names is not None:
            self._set_placement(param_names)

    def _set_placement(self, names):
        for idx, shard in enumerate(shard_names(names, len(self._clients))):
            for n in shard:
                self._placement[n] = idx

    def _client_for(self, name):
        if name not in self._placement:
            raise KeyError(
                f"unplaced parameter {name!r}: pass param_names= at "
                "construction or call init_params first")
        return self._clients[self._placement[name]]

    def init_params(self, params):
        self._set_placement(params)
        by_client = {}
        for n, v in params.items():
            by_client.setdefault(self._placement[n], {})[n] = v
        for idx, shard in by_client.items():
            self._clients[idx].call("init_params", params=shard)

    @staticmethod
    def _wire_dtype():
        wire_dtype = get_flag("pserver_wire_dtype")
        if wire_dtype not in ("fp32", "fp16"):
            raise ValueError(
                f"pserver_wire_dtype must be 'fp32' or 'fp16', "
                f"got {wire_dtype!r}")
        return wire_dtype

    def _wire_grad(self, name, g, wire_dtype=None):
        """Convert one gradient to its wire form: SparseRows/SparseGrad →
        rpc.SparseGrad (ids + touched rows, sentinel padding filtered);
        a DENSE gradient for a param in ``sparse_param_names`` (the
        transpiler's is_sparse marking) is sparsified to its nonzero rows
        — a backward that densified an embedding grad (e.g. summed
        lookups) still ships O(touched rows) — when at most half the
        table moved; other dense grads ship as host ndarrays. Either
        form is downcast to fp16 when the ``pserver_wire_dtype`` flag
        asks for the half-width wire (``push`` validates the flag once
        per call and threads it through). A torch tensor, on any device,
        leaves as a host ndarray: nothing of torch reaches the wire."""
        if wire_dtype is None:
            wire_dtype = self._wire_dtype()
        if isinstance(g, SparseGrad):
            sg = g
        elif hasattr(g, "rows") and hasattr(g, "values") \
                and hasattr(g, "nrows"):
            sg = SparseGrad.from_sparse_rows(g)
        else:
            sg = None
            arr = _host(g)
            if name in self._sparse_names and arr.ndim and arr.shape[0]:
                touched = np.flatnonzero(
                    arr.reshape(arr.shape[0], -1).any(axis=1))
                if touched.size <= arr.shape[0] // 2:
                    sg = SparseGrad(touched, arr[touched], arr.shape[0],
                                    merged=True)
        if sg is not None:
            if wire_dtype == "fp16" and sg.values.dtype in (np.float32,
                                                            np.float64):
                sg = sg.astype(np.float16)
            return sg
        if wire_dtype == "fp16" and arr.dtype in (np.float32, np.float64):
            arr = arr.astype(np.float16)
        return arr

    def _fanout(self, method, requests):
        """Issue one RPC per shard concurrently (sequential per-shard calls
        in trainer-specific orders would deadlock sync-mode barriers across
        shards — a lock-order inversion between trainers) and aggregate ALL
        shard failures into one diagnosable error; a single failure keeps
        its original type."""
        with trace_context():
            return self._fanout_traced(method, requests)

    def _fanout_traced(self, method, requests):
        if len(requests) == 1:
            (idx, kwargs), = requests.items()
            return {idx: self._clients[idx].call(method, **kwargs)}
        if self._pool is None:
            # persistent pool, one worker per shard: per-step fan-outs
            # must not pay thread construction on the training hot path
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=len(self._clients),
                thread_name_prefix="param-client")
        # each per-shard call runs under a COPY of this context, so the
        # fan-out's one trace id (trace_context in _fanout) reaches every
        # shard — pool threads do not inherit contextvars by themselves
        futures = {idx: self._pool.submit(
                       contextvars.copy_context().run,
                       functools.partial(self._clients[idx].call, method,
                                         **kwargs))
                   for idx, kwargs in requests.items()}
        out, errors = {}, []
        for idx, fut in futures.items():
            try:
                out[idx] = fut.result()
            except Exception as e:
                errors.append((idx, e))
        if errors:
            if len(errors) == 1:
                raise errors[0][1]
            # a multi-shard outage must be diagnosable in one message, not
            # just whichever shard happened to fail first
            errors.sort(key=lambda ie: ie[0])
            detail = "; ".join(
                f"shard {idx} ({self._clients[idx]._address}): "
                f"{type(e).__name__}: {e}" for idx, e in errors)
            raise RuntimeError(
                f"{method} failed on {len(errors)} of {len(requests)} "
                f"shard(s): {detail}")
        return out

    def allocate_seq(self):
        """Claim the next push sequence number WITHOUT sending. A caller
        that must re-push the same gradients after a partial failure (a
        shard died after its peers applied) pushes with the SAME seq:
        shards that already applied answer from the dedup table, the
        restarted shard applies — exactly-once per shard, and the
        shards' sync rounds stay in lockstep (the online trainer's
        step-retry contract; a fresh seq would double-apply on the
        surviving shards)."""
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def push(self, grads, seq=None):
        wire_dtype = self._wire_dtype()   # read + validate once per push
        by_client = {}
        for n, g in grads.items():
            self._client_for(n)  # raise the friendly error on misuse
            by_client.setdefault(self._placement[n], {})[n] = \
                self._wire_grad(n, g, wire_dtype)
        if seq is None:
            seq = self.allocate_seq()
        return self._fanout("push", {
            idx: dict(grads=shard, trainer_id=self._trainer_id, seq=seq)
            for idx, shard in by_client.items()})

    def pull(self):
        if not self._placement:
            raise KeyError("no placement: pass param_names= at construction "
                           "or call init_params first")
        by_client = {}
        for n, idx in self._placement.items():
            by_client.setdefault(idx, []).append(n)
        shards = self._fanout("pull", {idx: {"names": names}
                                       for idx, names in by_client.items()})
        params = {}
        for part in shards.values():
            params.update(part)
        return params

    # ---- membership leases (elastic sync barriers) ----
    def register_trainer(self):
        """Register (or renew) this trainer's membership lease on EVERY
        shard concurrently — called when the worker acquires work (the
        master_task_reader contract: member while holding a task, not
        while idle-polling). A new member joins in two phases (see
        ``ParameterServer.register_trainer``): prepare on every shard,
        then commit the largest round they answered, so that its first
        round is the same on every shard. Returns the lease duration in
        seconds (0.0 when the servers run without leases)."""
        out = self._fanout("register_trainer", self._all_shards(
            trainer_id=self._trainer_id, join="prepare"))
        first = {i: r["next_round"] for i, r in out.items()
                 if "next_round" in r}
        if first:
            join = max(first.values())
            self._fanout("register_trainer",
                         {i: {"trainer_id": self._trainer_id, "join": join}
                          for i in first})
        return min((r.get("lease_s", 0.0) for r in out.values()),
                   default=0.0)

    def deregister_trainer(self):
        """Best-effort graceful leave on every shard: drop this
        trainer's lease NOW so open barriers shrink immediately instead
        of waiting out the expiry. Per-shard errors are swallowed — a
        leave is invoked precisely when shards may be restarting, and an
        undelivered deregister degrades to ordinary lease expiry.
        Returns True when at least one shard held a lease."""
        had = False
        for c in self._clients:
            try:
                had = bool(c.call("deregister_trainer",
                                  trainer_id=self._trainer_id)) or had
            except Exception:
                pass
        return had

    # ---- consistent-cut snapshots (online CheckpointFreezer) ----
    def _all_shards(self, **kwargs):
        return {idx: dict(kwargs) for idx in range(len(self._clients))}

    def snapshot_prepare(self, tag):
        """Prepare the cut ``tag`` on EVERY shard concurrently and return
        ``{shard_idx: round}``. The prepares are cheap in-memory copies;
        call this between step boundaries (no push in flight) and check
        the returned rounds all agree before trusting the cut (a
        disagreement is a torn cut — release the tag and re-cut). Any
        shard failure aggregates through the usual fan-out error path;
        the caller should release the tag."""
        out = self._fanout("snapshot_prepare", self._all_shards(tag=tag))
        return {idx: r["round"] for idx, r in out.items()}

    def snapshot_fetch(self, tag):
        """Pull the frozen cut from every shard (parallel, the pull
        fan-out path) -> ``(params, rounds)`` where params maps EVERY
        placed param name to its prepare-instant array."""
        shards = self._fanout("snapshot_fetch", self._all_shards(tag=tag))
        params, rounds = {}, {}
        for idx, res in shards.items():
            params.update(res["params"])
            rounds[idx] = res["round"]
        return params, rounds

    def snapshot_release(self, tag, wait=False):
        """Best-effort release on every shard — the cleanup path of a
        failed cut. Per-shard errors (shard restarted and lost the tag;
        shard briefly down) are swallowed, and by default the calls run
        on a background thread: release is invoked from the trainer's
        thread precisely when a shard is down, and waiting out the
        client RetryPolicy's budget there would stall training for
        seconds per failed cut. An unreleased snapshot is bounded
        server-side by the store cap, so fire-and-forget is safe.
        ``wait=True`` runs the calls inline (operator/test usage that
        needs the tags gone on return)."""
        import threading

        def _release(clients=list(self._clients)):
            for c in clients:
                try:
                    c.call("snapshot_release", tag=tag)
                except Exception:
                    pass

        if wait:
            _release()
        else:
            threading.Thread(target=_release, daemon=True,
                             name=f"snapshot-release-{tag}").start()

    def wire_stats(self):
        """Aggregate client-side wire counters (rpc.WireStats) across the
        shard connections: bytes sent/received + per-method call count and
        latency."""
        agg = {"bytes_sent": 0, "bytes_recv": 0, "calls": {}}
        for c in self._clients:
            snap = c.wire_stats.snapshot()
            agg["bytes_sent"] += snap["bytes_sent"]
            agg["bytes_recv"] += snap["bytes_recv"]
            for m, rec in snap["calls"].items():
                dst = agg["calls"].setdefault(
                    m, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                dst["count"] += rec["count"]
                dst["total_s"] += rec["total_s"]
                dst["max_s"] = max(dst["max_s"], rec["max_s"])
        return agg

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        for c in self._clients:
            c.close()


class OverlappedRemoteUpdater:
    """Pipelined trainer-side updater: grad push + param pull run on a
    background thread while the trainer computes its next batch — the
    reference's CONCURRENT RemoteParameterUpdater
    (paddle/trainer/RemoteParameterUpdater.h:180, which
    overlaps send/recv with the backward pass on a separate thread).

    Contract (one-step staleness, exactly the reference's):

        upd = OverlappedRemoteUpdater(client, scope, ["w", "b"],
                                      device=exe.device)
        for batch in data:
            upd.sync_in()                 # install freshest pulled params
            grads = run_fwd_bwd(batch)    # overlaps the in-flight comm
            upd.submit(grads)             # returns immediately
        upd.finish()

    ``submit`` enqueues push(grads)+pull() on the worker; ``sync_in`` waits
    for the previous round-trip and writes the pulled params into the
    scope (:func:`install_params`: into the tensors the scope holds, on
    their device; a name the scope lacks lands on ``device``, the
    executor's). The params a step sees therefore exclude the
    immediately preceding step's gradients — async-SGD staleness bounded
    at 1.
    """

    def __init__(self, client, scope, param_names, device=None):
        self._client = client
        self._scope = scope
        self._device = device
        self._names = set(param_names)   # install only these from pulls
        self._pulled = None
        self._error = None
        self._worker = None

    def sync_in(self):
        """Wait for the in-flight push+pull and install its params."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
            if self._error is not None:
                e, self._error = self._error, None
                raise e
            if self._pulled:
                install_params(self._scope, self._pulled, self._names,
                               self._device)
                self._pulled = None

    def submit(self, grads):
        import threading

        if self._worker is not None:
            raise RuntimeError("submit before sync_in of the previous round")

        def trip():
            try:
                self._client.push(dict(grads))
                self._pulled = self._client.pull()
            except Exception as e:   # surfaced at the next sync_in
                self._error = e

        self._worker = threading.Thread(target=trip, daemon=True)
        self._worker.start()

    def finish(self):
        """Drain the pipeline (join the last round-trip)."""
        self.sync_in()


def install_params(scope, params, names=None, device=None):
    """Put pulled numpy ``params`` (of ``names``, default all) into
    ``scope`` as tensors. A name the scope already holds is copied INTO
    that tensor, on its device, so a table is not reallocated every step;
    it must be a tensor of the pulled shape, and of its dtype or, both
    floating, of the dtype the value is cast to (a server's Adam rule
    returns float64, as the reference's does), else ValueError. A name
    the scope lacks gets a new tensor on ``device``, by default the device
    of the tensors the scope already holds (ValueError when it holds
    none). Returns the names installed. torch is imported here, not at
    module import: a shard process never loads it."""
    import torch

    done = []
    for n, v in params.items():
        if names is not None and n not in names:
            continue
        src = torch.from_numpy(np.ascontiguousarray(v))
        cur = scope.find_var(n)
        if cur is None:
            if device is None:
                device = _scope_device(scope)
            scope.set(n, src.to(device))
        elif isinstance(cur, torch.Tensor) and cur.shape == src.shape \
                and (cur.dtype == src.dtype
                     or cur.is_floating_point() and src.is_floating_point()):
            cur.copy_(src)
        else:
            what = (f"a {cur.dtype} tensor of shape {tuple(cur.shape)}"
                    if isinstance(cur, torch.Tensor)
                    else type(cur).__name__)
            raise ValueError(
                f"install_params: the scope holds {n!r} as {what}; the "
                f"pulled value is {src.dtype} of shape {tuple(src.shape)}")
        done.append(n)
    return done


def _scope_device(scope):
    """The device of the first tensor ``scope`` (or a parent) holds."""
    import torch

    s = scope
    while s is not None:
        for name in s.local_names():
            v = s.find_var(name)
            if isinstance(v, torch.Tensor):
                return v.device
        s = s.parent
    raise ValueError("install_params: the scope holds no tensor to take a "
                     "device from; pass device= (the executor's)")
