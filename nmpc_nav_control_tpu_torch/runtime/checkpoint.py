"""Checkpoint / resume for controller state.

Port of ``nmpc_nav_control_tpu/runtime/checkpoint.py``.  The reference has
no on-disk checkpointing — its warm-start state lives implicitly inside the
acados capsule plus the controller's carried ``x0`` (SURVEY.md §5).  Here
the entire navigation state (solver warm start, path window, status
machine) is one NamedTuple of tensors (``NodeState``, ``RTIState``, batched
``[B, ...]``, nested NamedTuples too), so checkpointing is a flat array
dump: save mid-mission, restart the process, resume the same mission with a
warm solver.

Format: one ``.npz`` of the leaves as ``leaf_i`` arrays, in field order,
plus ``__fields__``: the JSON list of each leaf's field path, with the
NamedTuple's type name at each level (``NodeState.window.PathWindow.count``).
It takes the place of the JAX package's ``str(treedef)``, which only JAX
can write.  Arrays load back with the dtypes they were saved with.

A node on the card holds its state in the static buffers of its captured
graph: restore it with ``node.set_state(load_state(path, node.state))``,
which copies into those buffers (``GraphedNavigator.load_state``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def _flatten(state, prefix=""):
    """(field paths, leaves) of a NamedTuple (or tuple) of tensors."""
    if not isinstance(state, tuple):
        return [prefix.rstrip(".")], [state]
    names = getattr(state, "_fields", None) or [str(i) for i in range(len(state))]
    paths, leaves = [], []
    for name, value in zip(names, state):
        p, v = _flatten(value, f"{prefix}{type(state).__name__}.{name}.")
        paths += p
        leaves += v
    return paths, leaves


def _unflatten(like, leaves):
    if not isinstance(like, tuple):
        return next(leaves)
    values = [_unflatten(v, leaves) for v in like]
    return type(like)(*values) if hasattr(like, "_fields") else type(like)(values)


def save_state(path: str, state) -> None:
    """Save a NamedTuple of tensors (NodeState, RTIState, batched fleets...)."""
    paths, leaves = _flatten(state)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)}
    arrays["__fields__"] = np.frombuffer(json.dumps(paths).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Load a checkpoint into the structure of ``like`` (a template with the
    same fields, e.g. a freshly ``node_init``-ed state or ``node.state``).

    The file must carry ``save_state``'s ``__fields__`` descriptor, and its
    field paths, number of leaves, and each leaf's shape and dtype must
    match the template; a missing descriptor or a mismatch raises
    ``ValueError``.  The tensors
    land on the template's devices.
    """
    paths_t, leaves_t = _flatten(like)
    with np.load(path) as data:
        if "__fields__" not in data.files:
            raise ValueError(
                f"{path} has no __fields__ descriptor: not a checkpoint of this "
                "package (a JAX checkpoint's leaves load through "
                "convert.node_state_from_numpy)"
            )
        saved = json.loads(bytes(data["__fields__"]).decode())
        if saved != paths_t:
            raise ValueError(
                "checkpoint structure does not match the template:\n"
                f"  checkpoint: {saved}\n"
                f"  template:   {paths_t}"
            )
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(leaves_t):
            raise ValueError(
                f"checkpoint has {n} leaves, template has {len(leaves_t)}"
            )
        leaves = []
        for i, tmpl in enumerate(leaves_t):
            arr = torch.from_numpy(np.array(data[f"leaf_{i}"]))
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"leaf {i} ({paths_t[i]}): checkpoint shape {tuple(arr.shape)} != "
                    f"template shape {tuple(tmpl.shape)}"
                )
            if arr.dtype != tmpl.dtype:
                raise ValueError(
                    f"leaf {i} ({paths_t[i]}): checkpoint dtype {arr.dtype} != "
                    f"template dtype {tmpl.dtype}"
                )
            leaves.append(arr.to(tmpl.device))
    return _unflatten(like, iter(leaves))
