"""Checkpoint/resume for pipeline state (PointBatch maps, pose graphs).

Port of pasture_tpu/utils/checkpoint.py.  Any tree of tensors and numpy
arrays (dicts, lists, tuples, ``None``) saves and restores.  An ``.npz``
path keeps the JAX package's layout — ``leaf_{i}`` in its flattening
order plus a ``__treedef__`` string — so files cross between the two
packages; any other path is one ``torch.save`` file.

The flattening order is the JAX package's (``jax.tree_util``): a plain
dict's keys sorted, an ``OrderedDict`` in insertion order, sequences in
order, ``None`` holding no leaf.  ``torch.utils._pytree`` keeps a dict's
insertion order instead, and would swap the leaves of a nested-dict file.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Any, Iterator, List, Union

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree"]


def _keys(node: dict) -> list:
    if isinstance(node, collections.OrderedDict):
        return list(node)
    return sorted(node)


def _flatten(tree: Any) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in _keys(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in _flatten(child)]
    return [tree]


def _treedef(tree: Any) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in _keys(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(c) for c in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(c) for c in tree) + ")"
    return "*"


def _restore_leaf(like: Any, value: np.ndarray) -> Any:
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(value)).to(like.device)
    return value


def _unflatten(like: Any, leaves: Iterator[np.ndarray]) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in _keys(like)}
        return type(like)((k, out[k]) for k in like)
    if isinstance(like, (list, tuple)):
        children = [_unflatten(c, leaves) for c in like]
        if hasattr(like, "_fields"):            # namedtuple
            return type(like)(*children)
        return type(like)(children)
    return _restore_leaf(like, next(leaves))


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(tree: Any, path: Union[str, Path]) -> None:
    """Save a tree of tensors/arrays to ``path`` (``.npz``: the JAX
    package's leaf layout; otherwise one ``torch.save`` file)."""
    path = Path(path)
    if path.suffix != ".npz":
        torch.save(tree, path)
        return
    leaves = _flatten(tree)
    np.savez(path,
             __treedef__=np.frombuffer(_treedef(tree).encode(), np.uint8),
             **{f"leaf_{i}": _host(v) for i, v in enumerate(leaves)})


def load_pytree(path: Union[str, Path], like: Any) -> Any:
    """Restore a tree saved by :func:`save_pytree` (or by the JAX
    package's, for ``.npz``); ``like`` gives the structure, and each leaf
    comes back as a tensor on ``like``'s leaf's device where that is a
    tensor, a numpy array otherwise.  A ``torch.save`` file is unpickled:
    load only files you trust."""
    path = Path(path)
    if path.exists() and path.suffix != ".npz":
        return torch.load(path, weights_only=False)
    if not path.exists() and path.with_suffix(".npz").exists():
        path = path.with_suffix(".npz")
    data = np.load(path)
    n = len(_flatten(like))
    return _unflatten(like, iter([data[f"leaf_{i}"] for i in range(n)]))
