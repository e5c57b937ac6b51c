"""Multi-process launcher and the supervised child fleets — the
cluster-train entry point (counterpart of paddle_tpu/distributed/launch.py).

Reference capability: the k8s yamls and launch scripts that start N
trainer/pserver processes (benchmark/cluster/vgg16/fluid_trainer.yaml sets
TRAINERS/TRAINER_ID/PSERVER env vars for each pod;
paddle/scripts/cluster_train_v2/). Every process runs the SAME script;
``launch`` spawns them as the ranks of one ``torch.distributed`` group,
wired through the ``env://`` variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
that ``parallel.multihost.init_multihost`` reads, streaming each child's
output with a rank prefix.

    python -m paddle_tpu_torch.distributed.launch --nproc 2 train.py --lr 0.1

:class:`ChildSupervisor` runs children that serve RPC on fixed addresses
and restarts them. Each child is a fresh interpreter that loads the
target's module without this package's ``__init__`` (and so without
torch), for targets that need only numpy and ``distributed/``: a trainer
that has made a CUDA context, or runs threads, must not fork (PyTorch does
not support CUDA in a forked child, and a fork while another thread holds
a lock can hang the child), and a pserver shard needs none of torch. A
child exits when its parent dies.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
import socket
import subprocess
import sys
import threading
import time

from ..obs.metrics import REGISTRY as _METRICS
from ..obs.recorder import record as _flight_record

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# where free_port draws from: below the ephemeral range
_PORTS = (10000, 32768)

_M_RESTARTS = _METRICS.counter(
    "paddle_tpu_supervisor_restarts",
    "child restarts performed by a ChildSupervisor, per supervisor "
    "class and child index", labels=("supervisor", "child"))


def free_port():
    """A free local TCP port for a child to bind some seconds later. It is
    drawn from below the kernel's ephemeral range (Linux's default starts
    at 32768, IANA's at 49152), from which the kernel picks the port of
    every other socket that binds port 0 or connects meanwhile, so none of
    those can take it first."""
    rng = random.Random()
    for _ in range(64):
        port = rng.randrange(*_PORTS)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(script, script_args=(), nproc=2, devices_per_proc=None,
           coordinator=None, env_extra=None, timeout=None):
    """Spawn ``nproc`` copies of ``script`` as the ranks of one
    ``torch.distributed`` group (``env://``: ``coordinator`` "host:port"
    is the rendezvous, default a free local port). ``devices_per_proc``
    gives rank r the cards ``[r*k, (r+1)*k)`` through
    ``CUDA_VISIBLE_DEVICES``. Returns the list of exit codes; ranks still
    running ``timeout`` seconds after the start are killed (-9)."""
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    addr, _, port = coordinator.rpartition(":")
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(RANK=str(rank), WORLD_SIZE=str(nproc),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nproc),
                   MASTER_ADDR=addr or "127.0.0.1", MASTER_PORT=port)
        env.update(env_extra or {})
        if devices_per_proc:
            k = int(devices_per_proc)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(d) for d in range(rank * k, (rank + 1) * k))
            env["LOCAL_RANK"] = "0"
        p = subprocess.Popen([sys.executable, script, *script_args],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)

    # drain every child's pipe CONCURRENTLY: a sequential communicate()
    # would deadlock the group once any later rank fills its 64KB pipe
    # while an earlier rank blocks in a collective waiting on it
    outputs = [""] * nproc

    def drain(rank, p):
        outputs[rank] = "".join(p.stdout)

    threads = [threading.Thread(target=drain, args=(r, p), daemon=True)
               for r, p in enumerate(procs)]
    for t in threads:
        t.start()

    deadline = None if timeout is None else time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            remaining = None if deadline is None \
                else max(0.1, deadline - time.monotonic())
            p.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            for q in procs:   # kill the whole group: one hung rank wedges all
                if q.poll() is None:
                    q.kill()
            p.wait()
        codes.append(p.returncode)
    for t in threads:
        t.join(5.0)
    for rank in range(nproc):
        for line in outputs[rank].splitlines():
            print(f"[rank {rank}] {line}")
    return codes


# a child: load the target's module under a bare package entry
# (no package __init__, so no torch), watch the parent, run the target
_EXEC_BOOT = r"""
import os, pickle, sys, threading, time, types
root, pkg = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
if pkg not in sys.modules:
    m = types.ModuleType(pkg)
    m.__path__ = [os.path.join(root, pkg)]
    sys.modules[pkg] = m
parent = os.getppid()

def watch():
    while os.getppid() == parent:
        time.sleep(0.2)
    os._exit(1)

threading.Thread(target=watch, daemon=True).start()
target, args = pickle.loads(sys.stdin.buffer.read())
target(*args)
"""


class _ExecChild:
    """A fresh-interpreter child: ``start()``, ``is_alive()``,
    ``exitcode``, ``terminate()``, ``kill()``, ``join(timeout)``, ``pid``."""

    def __init__(self, target, args):
        self._spec = (target, tuple(args))
        self._p = None
        self.pid = None

    def start(self):
        target, args = self._spec
        pkg = target.__module__.split(".")[0]
        self._p = subprocess.Popen(
            [sys.executable, "-c", _EXEC_BOOT, _ROOT, pkg],
            stdin=subprocess.PIPE)
        self._p.stdin.write(pickle.dumps((target, args)))
        self._p.stdin.close()
        self.pid = self._p.pid

    def is_alive(self):
        return self._p is not None and self._p.poll() is None

    @property
    def exitcode(self):
        return None if self._p is None else self._p.poll()

    def terminate(self):
        if self.is_alive():
            self._p.terminate()

    def kill(self):
        if self.is_alive():
            self._p.kill()

    def join(self, timeout=None):
        if self._p is None:
            return
        try:
            self._p.wait(timeout)
        except subprocess.TimeoutExpired:
            pass


def spawn_child(target, args=()):
    """Start ``target(*args)`` in a fresh interpreter (see the module
    docstring): ``target`` is a module-level function. Returns a started
    handle with ``is_alive()``, ``exitcode``, ``terminate()``, ``kill()``,
    ``join(timeout)`` and ``pid``."""
    child = _ExecChild(target, args)
    child.start()
    return child


def _pserver_child(address, checkpoint_path, cfg):
    """Child-process entry: serve one pserver shard on a FIXED address,
    restoring from its checkpoint when one exists (the restart path).
    numpy only: it runs in a fresh interpreter without torch."""
    from .param_server import serve
    _ps, rpc = serve(address=tuple(address), checkpoint_path=checkpoint_path,
                     **cfg)
    rpc.serve_forever()


class ChildSupervisor:
    """Generic supervised child fleet: start N RPC-serving children on
    FIXED addresses, heartbeat each over RPC, and restart a dead (or
    alive-but-unresponsive, i.e. wedged) child on the SAME address with a
    per-child restart cap — so any client placement keyed on the address
    list stays valid across crashes and a ``rpc.RetryPolicy`` client
    reconnects straight through the restart. The reference analog is the
    etcd supervision loop of the v2 Go pserver/master (go/pserver,
    go/master/service.go: a crashed pod restarts, recovers its state, and
    its peers transparently reconnect).

    Subclasses provide the child by overriding :meth:`_child_spec`, which
    returns the ``(target, args)`` for one child process — called at EVERY
    (re)spawn, so args can carry state that moved since the last spawn
    (the serving fleet's current registry version). Two users:

    * :class:`PserverSupervisor` — parameter-server shards restarting from
      their checkpoints (heartbeat method ``stats``; the pserver path is
      numpy-only in-child, and the trainer that starts it may hold a CUDA
      context and running threads).
    * :class:`~..serving.fleet.FleetSupervisor` — inference replicas
      restarting from a model registry (heartbeat method ``health``; each
      replica imports torch and runs on the device its config names).

    ``startup_grace_s`` suppresses heartbeat-miss COUNTING for that long
    after each (re)spawn — a spawned replica pays a full interpreter +
    framework import plus model warmup before it binds, and terminating it
    for not answering during startup would crash-loop the fleet. A child
    that exits during the grace window is still restarted immediately
    (liveness is checked regardless). :class:`PserverSupervisor` gives
    its children 5 s: a fresh interpreter takes about a second to import
    numpy and bind.
    """

    def __init__(self, n_children, heartbeat_method="stats",
                 heartbeat_interval_s=0.25, heartbeat_timeout_s=None,
                 heartbeat_misses=3, max_restarts=5, startup_grace_s=0.0,
                 host="127.0.0.1"):
        from ..core.flags import get_flag

        if heartbeat_timeout_s is None:
            # derive from the process-wide rpc_timeout_s flag, but never
            # slower than the 5 s wedge-detection default — a 90 s response
            # deadline is fine for a pull, not for declaring a child dead
            heartbeat_timeout_s = min(5.0, float(get_flag("rpc_timeout_s")))

        self._host = host
        self.addresses = [(host, free_port()) for _ in range(n_children)]
        # per-child restart counters in the obs.metrics registry, labeled
        # by a process-unique supervisor instance id (concrete class +
        # sequence: "FleetSupervisor-3") and child index; the
        # ``restarts`` property and child_stats() derive from these
        # children, and distinct supervisors never share a series
        from ..obs.metrics import next_instance
        self.obs_instance = next_instance(type(self).__name__)
        self._m_restarts = [
            _M_RESTARTS.labels(supervisor=self.obs_instance,
                               child=str(i)) for i in range(n_children)]
        # wall-clock of each child's most recent RESTART (None until its
        # first one) — the observability surface OnlineLearningLoop.stats
        # aggregates; wall-clock (not monotonic) so operators can line it
        # up against logs across processes
        self.last_restart_at = [None] * n_children
        # WHY the child was last restarted ("exited code N" vs
        # "wedged: no heartbeat") — a dead child with no reason is
        # undebuggable in a fleet; surfaced via child_stats()
        self.last_restart_reason = [None] * n_children
        self._max_restarts = int(max_restarts)
        self._hb_method = str(heartbeat_method)
        self._interval = float(heartbeat_interval_s)
        self._hb_timeout = float(heartbeat_timeout_s)
        self._hb_misses_allowed = int(heartbeat_misses)
        self._hb_failures = [0] * n_children
        self._hb_clients = [None] * n_children
        self._hb_lock = threading.Lock()  # monitor + wait_ready share these
        self._grace = float(startup_grace_s)
        self._spawned_at = [0.0] * n_children
        self._procs = [None] * n_children
        self._stop = threading.Event()
        # incident trigger (obs.recorder.IncidentCollector.trigger or any
        # callable(reason, detail=)): fired after each child restart so a
        # crash leaves a fleet-wide flight-recorder bundle behind; None =
        # record the event locally only
        self.incident_hook = None
        # gates _spawn against stop(): without it the monitor could respawn
        # a child between stop()'s flag-set and its terminate sweep,
        # leaking a live child process on the fixed port
        self._spawn_lock = threading.Lock()
        for i in range(n_children):
            self._spawn(i)
        self._monitor = threading.Thread(target=self._watch, daemon=True)
        self._monitor.start()

    @property
    def restarts(self):
        """Per-child restart counts — derived from the registry counters
        (``paddle_tpu_supervisor_restarts``); indexable like the list it
        replaced."""
        return [int(c.value) for c in self._m_restarts]

    # ---- subclass hook ----
    def _child_spec(self, i):
        """Return ``(target, args)`` for child ``i`` — evaluated at every
        (re)spawn. ``target`` is a module-level function and ``args``
        are picklable."""
        raise NotImplementedError

    # ---- supervision loop ----
    def _spawn(self, i):
        with self._spawn_lock:
            self._spawn_locked(i)

    def _spawn_locked(self, i):
        if self._stop.is_set():
            return
        target, args = self._child_spec(i)
        p = _ExecChild(target, args)
        p.start()
        self._procs[i] = p
        self._hb_failures[i] = 0
        self._spawned_at[i] = time.monotonic()

    # ---- dynamic membership (the serving autoscaler's lever) ----
    def add_child(self):
        """Grow the fleet by ONE supervised child on a fresh fixed
        address: every parallel per-child structure gains its slot under
        the spawn lock (the monitor reads lengths per sweep and skips
        half-built slots via the IndexError guard), then the child spawns
        like any other. Returns the new child's ``(host, port)``."""
        with self._spawn_lock:
            if self._stop.is_set():
                raise RuntimeError(f"{self.obs_instance} is stopped; "
                                   "cannot add a child")
            i = len(self._procs)
            self.addresses.append((self._host, free_port()))
            self._m_restarts.append(_M_RESTARTS.labels(
                supervisor=self.obs_instance, child=str(i)))
            self.last_restart_at.append(None)
            self.last_restart_reason.append(None)
            self._hb_failures.append(0)
            with self._hb_lock:
                self._hb_clients.append(None)
            self._spawned_at.append(0.0)
            # _procs grows LAST: a monitor sweep that sees the new length
            # finds every sibling list already long enough
            self._procs.append(None)
            self._spawn_locked(i)
            address = self.addresses[i]
        _flight_record("child_added", component=self.obs_instance,
                       child=i, address=tuple(address))
        return tuple(address)

    def retire_child(self, timeout=10.0):
        """Shrink the fleet by ONE child — always the HIGHEST index, so
        surviving children keep their indices (and their addresses, and
        any client placement keyed on them). The slot is nulled first
        (the monitor skips None and its restart path re-checks slot
        identity), the child terminated and joined, then every parallel
        list pops its tail. Returns the retired child's address."""
        with self._spawn_lock:
            i = len(self._procs) - 1
            if i < 0:
                raise RuntimeError(f"{self.obs_instance} has no children "
                                   "to retire")
            p = self._procs[i]
            self._procs[i] = None    # monitor skips None from here on
            address = tuple(self.addresses[i])
        with self._hb_lock:
            c = self._hb_clients[i]
            self._hb_clients[i] = None
        if c is not None:
            c.close()
        if p is not None and p.is_alive():
            p.terminate()
        if p is not None:
            p.join(timeout)
        with self._spawn_lock:
            # pop the tail slot from every parallel list — only if no
            # concurrent add_child grew past it (then the lists stay; the
            # retired slot just remains a permanent None, still skipped)
            if i == len(self._procs) - 1:
                self._procs.pop()
                self.addresses.pop()
                self._m_restarts.pop()
                self.last_restart_at.pop()
                self.last_restart_reason.pop()
                self._hb_failures.pop()
                self._spawned_at.pop()
                with self._hb_lock:
                    if len(self._hb_clients) > i:
                        c2 = self._hb_clients.pop()
                        if c2 is not None:
                            c2.close()
        _flight_record("child_retired", component=self.obs_instance,
                       child=i, address=address)
        return address

    def _heartbeat_ok(self, i):
        from .rpc import RpcClient
        with self._hb_lock:
            try:
                if self._hb_clients[i] is None:
                    self._hb_clients[i] = RpcClient(
                        self.addresses[i], timeout=self._hb_timeout)
                self._hb_clients[i].call(self._hb_method)
                return True
            except Exception:
                c, self._hb_clients[i] = self._hb_clients[i], None
                if c is not None:
                    c.close()
                return False

    def _watch(self):
        while not self._stop.wait(self._interval):
            for i in range(len(self._procs)):
                try:
                    if self._watch_one(i):
                        return
                except IndexError:
                    # the fleet shrank under this sweep (retire_child
                    # popped the tail): nothing to supervise at i anymore
                    continue

    def _watch_one(self, i):
        """One sweep's supervision of child ``i``; returns True when the
        monitor should exit (stop() raced a restart)."""
        p = self._procs[i]
        if self._stop.is_set() or p is None:
            return False
        wedged = False
        if p.is_alive():
            if self._heartbeat_ok(i):
                self._hb_failures[i] = 0
                return False
            if (time.monotonic() - self._spawned_at[i]
                    < self._grace):
                return False   # still starting up: misses don't count
            self._hb_failures[i] += 1
            if self._hb_failures[i] < self._hb_misses_allowed:
                return False
            p.terminate()  # alive but not answering: wedged
            wedged = True
        p.join()
        if self._procs[i] is not p:
            # the slot changed hands while we watched this incarnation
            # die (retire_child nulled it): not ours to restart
            return False
        reason = "wedged: no heartbeat" if wedged \
            else f"exited code {p.exitcode}"
        self.last_restart_reason[i] = reason
        print(f"[{self.obs_instance}] child {i} "
              f"{self.addresses[i]} {reason}", file=sys.stderr,
              flush=True)
        if self._stop.is_set():
            return True
        if self.restarts[i] >= self._max_restarts:
            self._procs[i] = None  # crash-looping: give the child up
            return False
        self._m_restarts[i].inc()
        self.last_restart_at[i] = time.time()
        # flight recorder: a dead child with no WHY is
        # undebuggable — the restart and its reason land in this
        # process's ring (and, via incident_hook, trigger a
        # fleet-wide bundle capture)
        _flight_record(
            "child_restart", component=self.obs_instance,
            child=i, address=tuple(self.addresses[i]),
            reason=reason, restart_count=self.restarts[i])
        if self.incident_hook is not None:
            try:
                self.incident_hook(
                    "child_restart",
                    detail={"supervisor": self.obs_instance,
                            "child": i, "reason": reason})
            except Exception:
                pass             # monitoring never kills the monitor
        try:
            self._spawn(i)
        except Exception as e:
            # _child_spec can now fail at RESPAWN time (e.g. the
            # fleet's registry version was deleted out-of-band);
            # give this child up loudly instead of letting the
            # exception kill the monitor thread and silently end
            # supervision for every OTHER child
            import warnings
            warnings.warn(
                f"ChildSupervisor: respawn of child {i} failed "
                f"({type(e).__name__}: {e}); giving it up")
            self._procs[i] = None
        return False

    # ---- operator surface ----
    @property
    def n_children(self):
        """Live fleet size (add_child/retire_child move it)."""
        with self._spawn_lock:
            return len(self._procs)

    def child_stats(self):
        """Per-child supervision counters: ``[{address, alive,
        restart_count, last_restart_at, gave_up}]`` — ``gave_up`` marks a
        crash-looping child the supervisor stopped restarting
        (max_restarts). What OnlineLearningLoop.stats surfaces for both
        the pserver and serving-fleet supervisors."""
        out = []
        for i in range(len(self.addresses)):
            try:
                p = self._procs[i]
                out.append({
                    "address": tuple(self.addresses[i]),
                    "alive": p is not None and p.is_alive(),
                    "restart_count": self.restarts[i],
                    "last_restart_at": self.last_restart_at[i],
                    "last_restart_reason": self.last_restart_reason[i],
                    "gave_up": p is None,
                })
            except IndexError:
                break    # the fleet shrank mid-walk (retire_child)
        return out

    def child_alive(self, i):
        """Is child ``i`` a live process (a crash-looping child the
        supervisor gave up on reports False forever)?"""
        p = self._procs[i]
        return p is not None and p.is_alive()

    def kill(self, i):
        """Hard-kill child ``i`` (SIGKILL — no atexit, exactly a crash);
        the monitor restarts it on the same address. Test hook."""
        p = self._procs[i]
        if p is not None and p.is_alive():
            p.kill()

    def wait_ready(self, timeout=10.0):
        """Block until every live child answers an RPC — the post-start
        (or post-restart) barrier callers want before sending work."""
        deadline = time.monotonic() + timeout
        for i in range(len(self.addresses)):
            try:
                while self._procs[i] is not None \
                        and not self._heartbeat_ok(i):
                    if time.monotonic() > deadline:
                        return False
                    time.sleep(0.05)
            except IndexError:
                break    # the fleet shrank mid-wait (retire_child)
        return True

    def stop(self):
        self._stop.set()
        self._monitor.join(self._interval * 4 + self._hb_timeout + 1.0)
        for c in self._hb_clients:
            if c is not None:
                c.close()
        with self._spawn_lock:
            # after this acquisition no new child can start (_spawn sees
            # _stop), and any child a racing _spawn just started is in
            # _procs for this sweep
            procs = list(self._procs)
        for p in procs:
            if p is not None and p.is_alive():
                p.terminate()
        for p in procs:
            if p is not None:
                p.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class PserverSupervisor(ChildSupervisor):
    """Supervise N parameter-server processes: spawn each shard on a fixed
    address with a per-shard checkpoint file, heartbeat the children over
    RPC, and restart a dead (or wedged) shard from its latest checkpoint on
    the SAME address — so a trainer's ``ParamClient`` placement stays valid
    and its retry policy (rpc.RetryPolicy) reconnects straight through the
    restart. The spawn/heartbeat/restart loop itself lives in
    :class:`ChildSupervisor` (shared with the serving fleet supervisor);
    this subclass contributes the pserver child — serve the shard's config
    on its fixed address, restoring from its checkpoint when one exists.

        with PserverSupervisor(n_servers=2, checkpoint_dir=d) as sup:
            client = ParamClient(sup.addresses, retry=RetryPolicy())
            client.init_params(params)   # first-write-wins: a RESTORED
            ...                          # shard keeps its restored state

    A trainer resuming against a restarted shard just keeps pushing: it may
    re-run ``init_params`` (no-op against restored params) and the shard's
    sequence-number dedup absorbs any replayed push.
    """

    def __init__(self, n_servers=1, checkpoint_dir=None, optimizer="sgd",
                 opt_kwargs=None, mode="async", fan_in=1, max_staleness=None,
                 barrier_timeout_s=None, checkpoint_every=1,
                 heartbeat_interval_s=0.25, heartbeat_timeout_s=None,
                 heartbeat_misses=3, max_restarts=5, host="127.0.0.1",
                 trainer_lease_s=None):
        import tempfile

        self._cfg = dict(optimizer=optimizer, opt_kwargs=opt_kwargs,
                         mode=mode, fan_in=fan_in,
                         max_staleness=max_staleness,
                         barrier_timeout_s=barrier_timeout_s,
                         checkpoint_every=checkpoint_every,
                         trainer_lease_s=trainer_lease_s)
        self._ckpt_dir = checkpoint_dir or tempfile.mkdtemp(
            prefix="pdtorch_pserver_ckpt_")
        os.makedirs(self._ckpt_dir, exist_ok=True)
        super().__init__(
            n_servers, heartbeat_method="stats",
            heartbeat_interval_s=heartbeat_interval_s,
            heartbeat_timeout_s=heartbeat_timeout_s,
            heartbeat_misses=heartbeat_misses, max_restarts=max_restarts,
            host=host, startup_grace_s=5.0)

    def checkpoint_path(self, i):
        return os.path.join(self._ckpt_dir, f"pserver{i}.ckpt")

    def _child_spec(self, i):
        return _pserver_child, (self.addresses[i], self.checkpoint_path(i),
                                self._cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="spawn N ranks of one torch.distributed group on this "
                    "host")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=None,
                    help="cards per process (CUDA_VISIBLE_DEVICES slices)")
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    codes = launch(args.script, args.script_args, nproc=args.nproc,
                   devices_per_proc=args.devices_per_proc,
                   timeout=args.timeout)
    return max(codes, default=0)


if __name__ == "__main__":
    sys.exit(main())
