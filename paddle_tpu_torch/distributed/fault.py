"""Deterministic fault injection for the host RPC layer (counterpart of
paddle_tpu/distributed/fault.py, ported whole: it is pure Python).

A :class:`FaultPlan` names exact (method, call-index) pairs and what
happens there — delay the call, drop the request before it applies, drop
the response after it applies, or kill the whole server — so a test can
pin "the 2nd infer dies before it is served" and assert what the client
sees, in-process, with no sleeps or process kills.

Wiring: pass the plan to ``RpcServer(handler, address, fault_plan=plan)``
or ``ModelServer(..., fault_plan=plan)``. The server consults
``plan.on_call(method)`` once per received request; the connection
handler (rpc.py) executes the returned rule and marks it fired, so tests
can ``plan.wait(method, index)`` for the failure to have happened. Call
indices are 0-based and counted per method name across all connections
of the server. Plans hold thread primitives, so they coordinate
in-process servers only.
"""

from __future__ import annotations

import threading

# rule kinds
DELAY = "delay"                  # sleep, then serve normally
DROP_REQUEST = "drop_request"    # sever the connection; method NOT applied
DROP_RESPONSE = "drop_response"  # apply the method; sever before replying
DIE_BEFORE = "die_before"        # kill the server; method NOT applied
DIE_AFTER = "die_after"          # apply the method, then kill the server

KINDS = (DELAY, DROP_REQUEST, DROP_RESPONSE, DIE_BEFORE, DIE_AFTER)


class FaultRule:
    """One scheduled fault: what happens at (method, index)."""

    __slots__ = ("method", "index", "kind", "seconds", "fired")

    def __init__(self, method, index, kind, seconds=0.0):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; want one of "
                             f"{KINDS}")
        self.method = method
        self.index = int(index)
        self.kind = kind
        self.seconds = float(seconds)
        self.fired = threading.Event()

    def __repr__(self):
        return (f"FaultRule({self.method!r}, {self.index}, {self.kind!r}"
                + (f", {self.seconds}s" if self.kind == DELAY else "") + ")")


class FaultPlan:
    """Schedule of faults keyed by (method, 0-based call index).

        plan = (FaultPlan()
                .drop_response("push", 2)   # 3rd push applies, reply lost
                .die("push", 5))            # 6th push kills the server
        ps, rpc = serve(mode="sync", fan_in=2, fault_plan=plan)
        ...
        plan.wait("push", 5)                # block until the kill happened

    Chainable builders; thread-safe; one plan per server (indices count
    that server's calls).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._rules = {}    # (method, index) -> FaultRule
        self._counts = {}   # method -> calls seen so far
        self.history = []   # (method, index, kind) in firing order

    # ---- builders ----
    def _add(self, rule):
        with self._lock:
            key = (rule.method, rule.index)
            if key in self._rules:
                raise ValueError(f"duplicate fault rule for {key}")
            self._rules[key] = rule
        return self

    def delay(self, method, index, seconds):
        """Sleep ``seconds`` before serving that call (slow host channel)."""
        return self._add(FaultRule(method, index, DELAY, seconds))

    def drop_request(self, method, index):
        """Sever the connection before the call applies (lost request)."""
        return self._add(FaultRule(method, index, DROP_REQUEST))

    def drop_response(self, method, index):
        """Apply the call but sever before replying (lost response — the
        case that forces a client retry of an already-applied mutation)."""
        return self._add(FaultRule(method, index, DROP_RESPONSE))

    def die(self, method, index, before=False):
        """Kill the server at that call: close the listener and sever every
        live connection, as a crashed process would. ``before=True`` kills
        before the method applies; default is after (applied-but-unacked)."""
        return self._add(FaultRule(method, index,
                                   DIE_BEFORE if before else DIE_AFTER))

    # ---- pickling (ship a plan to a SPAWNED server child) ----
    # Thread primitives don't pickle, so a plan serializes as its rule
    # schedule and rebuilds fresh on the other side: counts reset and the
    # parent's wait()/history never observe child-side firings (the same
    # caveat as fork, documented above) — assert on observable server
    # behavior instead.
    def __getstate__(self):
        with self._lock:
            return [(r.method, r.index, r.kind, r.seconds)
                    for r in self._rules.values()]

    def __setstate__(self, rules):
        self.__init__()
        for method, index, kind, seconds in rules:
            self._add(FaultRule(method, index, kind, seconds))

    # ---- server side ----
    def on_call(self, method):
        """Count this call; return the rule scheduled for it, or None.
        Called by RpcServer once per received request."""
        with self._lock:
            i = self._counts.get(method, 0)
            self._counts[method] = i + 1
            rule = self._rules.get((method, i))
            if rule is not None:
                self.history.append((method, i, rule.kind))
            return rule

    # ---- test side ----
    def wait(self, method, index, timeout=30.0):
        """Block until the rule at (method, index) has fully executed
        (e.g. the server is dead for a ``die`` rule). Returns True if it
        fired within ``timeout``."""
        with self._lock:
            rule = self._rules[(method, index)]
        return rule.fired.wait(timeout)

    def calls_seen(self, method):
        with self._lock:
            return self._counts.get(method, 0)
