"""paddle.infer / Inference — the v2 generation's inference entry point
(counterpart of paddle_tpu/v2/inference.py).

Reference: python/paddle/v2/inference.py:24-125 — ``Inference(parameters,
output_layer=...)`` builds a testing GradientMachine, copies the trained
parameter buffers in, and ``infer(input, field=...)`` feeds a batch of
samples and returns the (concatenated) forward outputs. Every reference v2
example ends with ``paddle.infer(output_layer=prediction, parameters=params,
input=data)``.

Here the testing machine is the pruned for-test fluid Program (via
v2.topology.Topology) run by the Executor against the Parameters' scope;
``fileobj=`` loads a Topology.serialize_for_inference bundle instead, so a
model trained elsewhere (by either package) round-trips through a stream.

Inference runs on ``place``: the card unless the caller passes
``fluid.CPUPlace()`` or called ``paddle.init(use_gpu=False)`` first
(``default_place``). Nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import numpy as np

from . import topology as v2_topology

# paddle.init's arguments (v2/__init__.py ``init``)
_INIT: dict = {}


def default_place(place=None):
    """``place`` when given; else ``fluid.CPUPlace()`` after
    ``paddle.init(use_gpu=False)`` (or PADDLE_INIT_USE_GPU=0); else None,
    which the Executor takes as the card."""
    if place is not None:
        return place
    use_gpu = _INIT.get("use_gpu", True)
    if isinstance(use_gpu, str):
        use_gpu = use_gpu.strip().lower() not in ("0", "false", "no", "")
    if use_gpu:
        return None
    import paddle_tpu_torch.fluid as fluid
    return fluid.CPUPlace()


def scope_to_device(scope, device):
    """Move every tensor of ``scope`` onto ``device`` (in place): values
    loaded by ``Parameters.from_tar`` lie on the CPU until an executor
    reads them."""
    import torch
    for name, v in list(scope._vars.items()):
        if isinstance(v, torch.Tensor) and v.device != device:
            scope.set(name, v.to(device))


def build_feed(block, feed_order, data_batch, feeding=None):
    """Sample tuples -> executor feed dict. ``feeding`` maps data-layer name
    to the sample tuple position (the reference DataFeeder's feeding dict);
    default is declaration order."""
    feed = {}
    for pos, name in enumerate(feed_order):
        idx = feeding[name] if feeding else pos
        vals = [row[idx] if isinstance(row, (list, tuple)) else row
                for row in data_batch]
        v = block.var(name)
        if v.lod_level and v.lod_level > 0:
            seqs = []
            for s in vals:
                a = np.asarray(s)
                if a.ndim == 1:
                    a = a.reshape(-1, 1)
                seqs.append(a)
            feed[name] = seqs
        else:
            arrs = [np.asarray(s) for s in vals]
            if arrs and arrs[0].ndim == 0:
                arrs = [a.reshape(1) for a in arrs]
            feed[name] = np.stack(arrs)
    return feed


class Inference:
    """Inference(parameters, output_layer=...) or
    Inference(parameters, fileobj=serialized_topology_stream)."""

    def __init__(self, parameters, output_layer=None, fileobj=None,
                 place=None):
        import paddle_tpu_torch.fluid as fluid

        if output_layer is not None:
            topo = v2_topology.Topology(output_layer)
            self._program = topo.program
            self._feed_names = topo.feed_names
            self._fetch_names = topo.fetch_names
        elif fileobj is not None:
            (self._program, self._feed_names,
             self._fetch_names) = v2_topology.load_serialized(fileobj)
        else:
            raise ValueError("Either output_layer or fileobj must be set")

        # bind the trained parameter values (the reference copies each
        # buffer into the testing machine; here the executor reads the
        # Parameters' scope directly)
        scope = getattr(parameters, "_scope", None)
        if scope is None:
            raise RuntimeError(
                "parameters are not initialized: train them (v2.SGD binds "
                "its scope) or load values via Parameters.from_tar")
        self._scope = scope
        self._exe = fluid.Executor(default_place(place))
        scope_to_device(scope, self._exe.device)

    def iter_infer(self, input, feeding=None, batch_size=None):
        """Yield per-batch fetch lists. The reference iter_infer forwards
        the whole ``input`` as ONE batch; ``batch_size=`` chunks it instead
        (bounding peak memory for large inputs) and
        yields once per chunk — ``infer()`` concatenates the chunks back,
        so results are identical either way. Default ``None`` keeps the
        reference single-batch behavior."""
        block = self._program.global_block()
        samples = list(input)
        if batch_size is not None:
            batch_size = int(batch_size)
            if batch_size <= 0:
                raise ValueError(f"batch_size must be positive, "
                                 f"got {batch_size}")
        chunks = [samples] if batch_size is None else \
            [samples[i:i + batch_size]
             for i in range(0, len(samples), batch_size)]
        for chunk in chunks:
            feed = build_feed(block, self._feed_names, chunk, feeding)
            yield self._exe.run(self._program, feed=feed,
                                fetch_list=list(self._fetch_names),
                                scope=self._scope)

    def iter_infer_field(self, field, **kwargs):
        from paddle_tpu_torch.core.lod import LoDArray, lodarray_to_flat

        if not isinstance(field, (list, tuple)):
            field = [field]
        for result in self.iter_infer(**kwargs):
            item = []
            for f in field:
                for r in result:
                    if isinstance(r, LoDArray):
                        r = lodarray_to_flat(r)[0]
                    r = np.asarray(r)
                    if f == "id":
                        # reference: prediction labels (max_id); for a
                        # probability output take the argmax, for an
                        # integer output pass it through
                        if np.issubdtype(r.dtype, np.floating) and r.ndim > 1:
                            r = np.argmax(r, axis=-1)
                    item.append(r)
            yield item

    def infer(self, input, field="value", flatten_result=True, **kwargs):
        kwargs["input"] = input
        retv = None
        for item in self.iter_infer_field(field=field, **kwargs):
            if retv is None:
                retv = [[] for _ in item]
            for i, r in enumerate(item):
                retv[i].append(r)
        if retv is None:
            return []
        if flatten_result:
            retv = [np.concatenate(out) for out in retv]
        if len(retv) == 1:
            return retv[0]
        return retv


def infer(output_layer, parameters, input, feeding=None, field="value",
          batch_size=None, place=None):
    """paddle.infer(output_layer=prediction, parameters=params, input=batch)
    (reference inference.py:125-172). ``input`` is a list of sample tuples
    ordered like the network's data layers (or per ``feeding``); returns the
    prediction array(s). ``batch_size=`` chunks the input instead of
    forwarding it as one batch (results identical, concatenated);
    ``place=`` as ``Inference``'s."""
    inferer = Inference(output_layer=output_layer, parameters=parameters,
                        place=place)
    return inferer.infer(field=field, input=input, feeding=feeding,
                         batch_size=batch_size)


__all__ = ["infer", "Inference"]
