"""Trainer events (reference python/paddle/v2/event.py): the user-facing
metrics/progress hook stream."""

from __future__ import annotations

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration",
           "TestResult"]


class WithMetric:
    def __init__(self, metrics=None):
        self.metrics = metrics or {}


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, metrics=None):
        super().__init__(metrics)
        self.pass_id = pass_id


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, metrics=None):
        super().__init__(metrics)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost


class TestResult(WithMetric):
    def __init__(self, cost, metrics=None):
        super().__init__(metrics)
        self.cost = cost
