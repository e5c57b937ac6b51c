"""Online learning: continuous training that publishes into a live
serving fleet without dropping a request (counterpart of
paddle_tpu/online/).

The missing subsystem between this repo's training plane and serving
plane — the end-to-end loop the original Paddle v2 Go/etcd pserver
cluster was famous for (PAPER.md): a model trains on an unbounded
stream, periodically freezes into a versioned inference bundle, and
rolls onto a replica fleet that keeps answering throughout.

* :class:`StreamingTrainer` (trainer.py) — pull/step/push forever over
  a ``reader``-package stream; publish triggers fire at step boundaries
  (``online_publish_every_steps`` / ``online_publish_every_s``) without
  stalling the hot path; pserver restarts are ridden through.
* :class:`CheckpointFreezer` (freezer.py) — barrier-consistent cuts of
  the sharded pserver state (every shard at the same sync round — never
  a torn mix), stitched through ``save_inference_model`` and published
  with lineage metadata (global step, parent version, freeze round).
* :class:`RolloutController` (rollout.py) — registry watcher driving
  canary-gated ``rolling_reload`` with min-serve-time hysteresis,
  permanent quarantine of canary-rejected versions, and optional
  registry gc.
* :class:`TrainerPool` / :class:`BacklogAutoscaler` /
  :func:`master_task_reader` (pool.py) — the elastic trainer fleet: N
  workers lease data chunks from a ``Master`` queue and hold sync-round
  barrier membership via pserver leases only while they possess work;
  the pool hot-joins replacements for crashed workers and the
  autoscaler sizes it from the Master's backlog.
* :class:`OnlineLearningLoop` (loop.py) — the whole supervised process
  tree under one start/stats/stop, chaos-tolerant by construction: a
  pserver shard and a serving replica can be SIGKILLed mid-loop with
  zero failed infer requests and a monotonically advancing served
  version; pass ``chunks=``/``chunk_feeds=`` for the elastic
  Master-fed pool instead of a single reader.

The trainers, the freezer's export and the serving replicas run on the
card (``place=`` asks for the CPU); the parameter-server shards are numpy
processes, so the update itself runs no kernel.
"""

from .freezer import CheckpointFreezer, FreezeError
from .loop import OnlineLearningLoop
from .pool import BacklogAutoscaler, TrainerPool, master_task_reader
from .rollout import RolloutController
from .trainer import StreamingTrainer

__all__ = ["StreamingTrainer", "CheckpointFreezer", "FreezeError",
           "RolloutController", "OnlineLearningLoop", "TrainerPool",
           "BacklogAutoscaler", "master_task_reader"]
