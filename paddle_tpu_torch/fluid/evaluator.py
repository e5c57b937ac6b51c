"""Evaluators that accumulate a metric over batches (counterpart of
paddle_tpu/fluid/evaluator.py): ``Evaluator`` (reference :21), ``Accuracy``
(:44), ``ChunkEvaluator`` (:73), ``Auc`` (:102) and ``DetectionMAP``
(:130).

Each builds its metric ops into the program and keeps the batch's counts
in two places. The program adds them into persistable state variables
(one ``sum`` op a state, in place), which the startup program and the
evaluator's reset program set to zero, so ``eval(executor)`` reads the
pass's totals from the scope without any fetch. The reference's host
pattern works too: fetch ``metrics`` each run, ``update`` with the fetched
values and ``eval()``. ``DetectionMAP`` is the reference's host-side
evaluator: it keeps its detections in Python and builds no ops."""

from __future__ import annotations

import numpy as np
import torch

from . import layers
from .framework import Program, program_guard, unique_name
from ..ops.metrics import auc_from_stats

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator", "Auc",
           "DetectionMAP"]


class Evaluator:
    """Base: ``states`` (persistable, summed by the program), ``metrics``
    (the batch counts' names, for the host pattern), ``reset``,
    ``update`` and ``eval``. A subclass makes its batch counts, calls
    ``_track`` with them and defines ``_metric``."""

    def __init__(self, name=None):
        self._name = name or type(self).__name__
        self.states = []
        self._metrics = []
        self._reset_program = Program()

    @property
    def metrics(self):
        return self._metrics

    def _track(self, batch_vars):
        """A state per batch count, zeroed by the startup and reset
        programs and accumulated by the program being built."""
        from .framework import default_startup_program
        prefix = unique_name(f"{self._name}_state")
        for v in batch_vars:
            shape = tuple(v.shape) if v.shape is not None else ()
            state = v.block.create_var(
                name=f"{prefix}_{v.name}", shape=shape, dtype=v.dtype,
                persistable=True, stop_gradient=True)
            for prog in (default_startup_program(), self._reset_program):
                prog.global_block().create_var(
                    name=state.name, shape=shape, dtype=v.dtype,
                    persistable=True)
                with program_guard(prog):
                    layers.fill_constant(shape=list(shape), dtype=v.dtype,
                                         value=0, out=state)
            v.block.append_op("sum", inputs={"X": [state.name, v.name]},
                              outputs={"Out": [state.name]})
            self.states.append(state)
        self._metrics = [v.name for v in batch_vars]
        self.reset()

    def reset(self, executor=None, scope=None):
        """Zero the host totals and, given an executor, the states in
        ``scope`` (its reset program)."""
        self._host = None
        if executor is not None:
            executor.run(self._reset_program, scope=scope)

    def update(self, fetched):
        """Add one run's fetched ``metrics`` to the host totals."""
        vals = [np.asarray(v, np.float64) for v in fetched]
        self._host = vals if self._host is None else [
            a + b for a, b in zip(self._host, vals)]

    def eval(self, executor=None, scope=None):
        """The metric of the host totals, or given an executor, of the
        states in ``scope`` (the global scope by default)."""
        if executor is None:
            totals = self._host or [np.zeros(1)] * len(self._metrics)
        else:
            from ..core.scope import global_scope
            scope = scope or global_scope()
            totals = [np.asarray(torch.as_tensor(scope.find_var(s.name))
                                 .cpu(), np.float64) for s in self.states]
        return self._metric(totals)

    def _metric(self, totals):
        raise NotImplementedError


class Accuracy(Evaluator):
    """Top-k accuracy over the pass: Σ correct / Σ total."""

    def __init__(self, input, label, k=1, name=None):
        super().__init__(name)
        block = input.block
        correct = block.create_var(name=f"{self._name}_correct",
                                   dtype="int32", shape=())
        total = block.create_var(name=f"{self._name}_total", dtype="int32",
                                 shape=())
        self._acc = layers.accuracy(input=input, label=label, k=k,
                                    correct=correct, total=total)
        self._track([correct, total])

    def _metric(self, totals):
        correct, total = (float(np.sum(t)) for t in totals)
        return correct / max(total, 1.0)


class ChunkEvaluator(Evaluator):
    """Chunking precision, recall and F1 over the pass."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, name=None):
        super().__init__(name)
        *_, n_infer, n_label, n_correct = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self._track([n_infer, n_label, n_correct])

    def _metric(self, totals):
        n_infer, n_label, n_correct = (float(np.sum(t)) for t in totals)
        p = n_correct / n_infer if n_infer else 0.0
        r = n_correct / n_label if n_label else 0.0
        return p, r, (2 * p * r / (p + r) if p + r else 0.0)


class Auc(Evaluator):
    """AUC over the pass from the summed TP/FN/TN/FP threshold counts."""

    def __init__(self, input, label, curve="ROC", num_thresholds=200,
                 name=None):
        super().__init__(name)
        self._curve = curve
        _auc, stats = layers.auc(input=input, label=label, curve=curve,
                                 num_thresholds=num_thresholds)
        self._track(stats)

    def _metric(self, totals):
        tp, fn, tn, fp = (torch.tensor(np.asarray(t), dtype=torch.float32)
                          for t in totals)
        return float(auc_from_stats(tp, fn, tn, fp, self._curve))


class DetectionMAP:
    """Mean average precision over accumulated detections, on the host
    (reference :130). ``update(detections, gt_boxes)`` takes a batch's
    multiclass_nms output (a LoDArray of [b, K, 6] rows: label, score,
    box) and each image's ground truth as (label, x1, y1, x2, y2) tuples;
    ``eval()`` averages the 11-point interpolated AP over the classes that
    have ground truth."""

    def __init__(self, overlap_threshold=0.5, name=None):
        self._name = name or type(self).__name__
        self._thresh = overlap_threshold
        self._metrics = []
        self.reset()

    @property
    def metrics(self):
        return self._metrics

    def reset(self):
        self._dets = {}     # class -> list of (score, is_tp)
        self._n_gt = {}     # class -> count

    @staticmethod
    def _iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        iw, ih = max(ix2 - ix1, 0.0), max(iy2 - iy1, 0.0)
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gt_boxes):
        rows = np.asarray(torch.as_tensor(detections.data).cpu())
        lens = np.asarray(torch.as_tensor(detections.lens).cpu())
        for img, gts in enumerate(gt_boxes):
            for lbl, *_ in gts:
                self._n_gt[int(lbl)] = self._n_gt.get(int(lbl), 0) + 1
            matched = set()
            dets = sorted((rows[img][k] for k in range(int(lens[img]))),
                          key=lambda r: -r[1])
            for r in dets:
                lbl, score, box = int(r[0]), float(r[1]), r[2:6]
                # VOC's rule: match the one gt of the class with the most
                # overlap; a second detection of a matched gt is a false
                # positive
                best, best_j = 0.0, -1
                for j, (glbl, *gbox) in enumerate(gts):
                    if int(glbl) != lbl:
                        continue
                    ov = self._iou(box, gbox)
                    if ov > best:
                        best, best_j = ov, j
                tp = (best > self._thresh and best_j >= 0
                      and best_j not in matched)
                if tp:
                    matched.add(best_j)
                self._dets.setdefault(lbl, []).append((score, tp))

    def eval(self):
        """11-point interpolated mAP; a class with ground truth and no
        detection counts AP 0."""
        aps = []
        for lbl, n_gt in self._n_gt.items():
            dets = self._dets.get(lbl, [])
            if not dets:
                aps.append(0.0)
                continue
            dets = sorted(dets, key=lambda d: -d[0])
            tps = np.cumsum([1 if tp else 0 for _, tp in dets])
            fps = np.cumsum([0 if tp else 1 for _, tp in dets])
            recall = tps / n_gt
            precision = tps / np.maximum(tps + fps, 1)
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t].max() if (recall >= t).any() \
                    else 0.0
                ap += p / 11.0
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
