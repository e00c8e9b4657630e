"""Checkpoint / resume of pipeline state (port of
``toyslam_tpu/utils/checkpoint.py``).

A state is a nest of NamedTuples and tuples whose leaves are tensors,
numpy arrays or scalars. It is saved as one NPZ keyed as JAX keys a pytree
leaf (``"/".join(str(path_entry))``: ``.field`` for a NamedTuple field,
``[i]`` for a tuple item), so that a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _flatten(tree, path=()):
    """``[(key path, leaf)]`` in JAX's order."""
    if hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, tuple):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(path, tree)]
    return [leaf for key, sub in items
            for leaf in _flatten(sub, path + (key,))]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str | Path, state) -> None:
    """Snapshot a nest of tensors / arrays to one compressed .npz file."""
    np.savez_compressed(path, **{"/".join(p): _to_numpy(leaf)
                                 for p, leaf in _flatten(state)})


def load_checkpoint(path: str | Path, template):
    """Restore a nest saved with :func:`save_checkpoint` (by either
    package). ``template`` gives the structure, each leaf's shape (checked),
    dtype (restored) and place: a tensor leaf comes back as a tensor on the
    template leaf's device, any other leaf as a writable numpy array."""
    data = np.load(path)
    restored = []
    for p, leaf in _flatten(template):
        key = "/".join(p)
        val = data[key]
        if isinstance(leaf, torch.Tensor):
            want_shape = tuple(leaf.shape)
            np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        else:
            want_shape, np_dtype = np.shape(leaf), np.asarray(leaf).dtype
        if val.shape != want_shape:
            raise ValueError(f"checkpoint mismatch at {key}: {val.shape} vs "
                             f"{want_shape}")
        val = np.array(val, dtype=np_dtype)
        if isinstance(leaf, torch.Tensor):
            val = torch.from_numpy(val).to(leaf.device)
        restored.append(val)
    return _unflatten(template, iter(restored))
