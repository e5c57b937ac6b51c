"""Persistence: save/load variables and inference-model export/load
(counterpart of paddle_tpu/fluid/io.py).

The on-disk format is the reference's: ``__model__`` is the Program's JSON
form plus the feed/fetch names, each persistable is one ``.npy`` file, and
``MANIFEST.json`` (written last, atomically) names every saved var with its
shape and dtype. A bundle written by either package loads in the other.

The reference also runs its program verifier (fluid/analysis) on save and
load; the verifier is not ported yet.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .framework import Program, default_main_program
from ..core.scope import Scope, global_scope

MODEL_FILENAME = "__model__"
MANIFEST_FILENAME = "MANIFEST.json"


def _is_persistable(var):
    return var.persistable and not var.is_data


def _to_numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def scope_from_numpy(arrays, device, scope=None) -> Scope:
    """Put host arrays (name -> np.ndarray, e.g. the reference scope's
    persistables as ``np.asarray`` of each) into a scope as tensors on
    ``device``. Fills ``scope`` when given, else a new one; returns it. The
    tensors are copies: they never alias the caller's arrays."""
    scope = scope if scope is not None else Scope()
    for name, arr in arrays.items():
        scope.set(name, torch.tensor(np.asarray(arr),
                                     device=torch.device(device)))
    return scope


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              scope=None):
    """Write each var via temp file + atomic rename, then MANIFEST.json
    (reference io.py:36). Vars absent from the scope are an error."""
    program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in program.global_block().vars.values()
                if (predicate or _is_persistable)(v)]
    os.makedirs(dirname, exist_ok=True)
    scope = scope or global_scope()
    missing = [v.name for v in vars if scope.find_var(v.name) is None]
    if missing:
        raise RuntimeError(
            f"save_vars: {len(missing)} requested vars absent from the "
            f"scope (did startup run?): {sorted(missing)[:8]}")
    manifest = {}
    for v in vars:
        val = _to_numpy(scope.find_var(v.name))
        path = os.path.join(dirname, v.name + ".npy")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, val)
        os.replace(tmp, path)
        manifest[v.name] = {"shape": list(val.shape),
                            "dtype": str(val.dtype),
                            "file": v.name + ".npy"}
    mtmp = os.path.join(dirname, MANIFEST_FILENAME + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(dirname, MANIFEST_FILENAME))


def save_persistables(executor, dirname, main_program=None, scope=None):
    save_vars(executor, dirname, main_program, scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              scope=None):
    """Load ``.npy`` vars onto the executor's device (reference io.py:84).
    With a MANIFEST present, every var it lists must be on disk with the
    recorded shape and dtype."""
    program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in program.global_block().vars.values()
                if (predicate or _is_persistable)(v)]
    manifest = None
    mpath = os.path.join(dirname, MANIFEST_FILENAME)
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    arrays = {}
    for v in vars:
        path = os.path.join(dirname, v.name + ".npy")
        if os.path.exists(path):
            val = np.load(path)
            if manifest is not None and v.name in manifest:
                m = manifest[v.name]
                if (list(val.shape) != m["shape"]
                        or str(val.dtype) != m["dtype"]):
                    raise RuntimeError(
                        f"checkpoint {dirname!r} is torn or mixed-"
                        f"generation: {v.name!r} on disk is "
                        f"{val.shape}/{val.dtype} but the manifest records "
                        f"{tuple(m['shape'])}/{m['dtype']}")
            arrays[v.name] = val
        elif manifest is not None and v.name in manifest:
            raise RuntimeError(
                f"checkpoint {dirname!r} is torn: manifest lists "
                f"{v.name!r} but {path!r} is missing")
    scope_from_numpy(arrays, executor.device, scope=scope or global_scope())


def load_persistables(executor, dirname, main_program=None, scope=None):
    load_vars(executor, dirname, main_program, scope=scope)


def _prune_program(program, feed_names, fetch_names):
    """Keep only ops needed to compute fetches from feeds, with every op in
    inference mode (reference io.py:130). Persistable vars are terminals:
    at inference time they load from disk."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()

    def is_persistable(name):
        return block.has_var(name) and block.var(name).persistable

    needed = set(fetch_names)
    keep = []
    for i in reversed(range(len(block.ops))):
        op = block.ops[i]
        if any(o in needed and not is_persistable(o)
               for o in op.output_arg_names()):
            keep.append(i)
            needed.update(op.input_arg_names())
    keep = set(keep)
    block.ops = [op for i, op in enumerate(block.ops) if i in keep]
    # drop var declarations nothing references; persistables and data vars
    # stay
    referenced = set(feed_names) | set(fetch_names)
    for b in pruned.blocks:
        for op in b.ops:
            referenced.update(op.input_arg_names())
            referenced.update(op.output_arg_names())
    for b in pruned.blocks:
        b.vars = {n: v for n, v in b.vars.items()
                  if n in referenced or v.persistable or v.is_data}
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, scope=None):
    """Prune to the fetches and write the bundle (reference io.py:170)."""
    program = main_program or default_main_program()
    fetch_names = [v if isinstance(v, str) else v.name for v in target_vars]
    pruned = _prune_program(program, feeded_var_names, fetch_names)
    os.makedirs(dirname, exist_ok=True)
    meta = pruned.to_dict()
    meta["feed_var_names"] = list(feeded_var_names)
    meta["fetch_var_names"] = fetch_names
    with open(os.path.join(dirname, MODEL_FILENAME), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, scope=scope)
    return fetch_names


def load_inference_model(dirname, executor, scope=None):
    """Load a ``save_inference_model`` bundle (reference io.py:191). A
    missing or corrupt model dir raises a ValueError naming the dirname."""
    path = os.path.join(dirname, MODEL_FILENAME)
    try:
        with open(path) as f:
            meta = json.load(f)
    except (FileNotFoundError, NotADirectoryError) as e:
        raise ValueError(
            f"load_inference_model: {dirname!r} is not a saved inference "
            f"model (no {MODEL_FILENAME!r} file: {e})") from e
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(
            f"load_inference_model: {dirname!r} holds a corrupt "
            f"{MODEL_FILENAME!r} ({type(e).__name__}: {e}); re-export the "
            "model with save_inference_model") from e
    program = Program.from_dict(meta)
    load_persistables(executor, dirname, program, scope=scope)
    feed_names = meta["feed_var_names"]
    fetch_vars = [program.global_block().var(n)
                  for n in meta["fetch_var_names"]]
    return program, feed_names, fetch_vars
