"""Atomic tree checkpointing (numpy ``.npz`` + JSON manifest), the twin of
``repro.checkpoint.ckpt`` and its on-disk format.

A tree is nested dicts, lists and tuples (named tuples included) whose
leaves are tensors, numpy arrays or scalars; ``None`` holds no leaf.  Leaf
keys are the reference's: dict keys and sequence indices joined by ``/``,
a named tuple's fields as ``.field``, dict keys in sorted order.  Tensors
are saved through ``.cpu().numpy()``.

Write protocol (crash-safe):
  1. serialise all leaves into ``<dir>.tmp/arrays.npz`` (keys joined by
     ``\\x1f``) + ``manifest.json`` (leaf shapes and dtypes, a sha256
     checksum of the npz, the caller's meta),
  2. fsync, then atomically ``rename`` the tmp dir into place.
A reader sees a complete checkpoint or none.  A checkpoint either package
writes loads in the other with ``like=None``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out += _leaves(v, prefix + (k,))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _leaves(tree)}


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def save_tree(path: str, tree, extra_meta: Dict | None = None) -> str:
    """Atomically save a tree to ``path`` (a directory)."""
    arrays = _flatten(tree)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **{k.replace("/", "\x1f"): v for k, v in arrays.items()})
    manifest = {
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "checksum": _sha256(npz_path),
        "meta": extra_meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _rebuild(like, it):
    """``like``'s structure with its leaves replaced, in flattening order,
    by the values ``it`` yields."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return type(like)((k, vals[k]) for k in like)
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), it)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def load_tree(path: str, like=None, verify: bool = True):
    """Load a checkpoint: ``(tree, meta)``.  With ``like`` given, the tree
    has ``like``'s structure, each leaf checked against its shape and cast
    to its dtype (a tensor leaf comes back as a tensor on its device);
    otherwise it is a nested dict of numpy arrays."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, "arrays.npz")
    if verify and _sha256(npz_path) != manifest["checksum"]:
        raise IOError(f"checkpoint {path} is corrupt (checksum mismatch)")
    data = np.load(npz_path)
    arrays = {k.replace("\x1f", "/"): data[k] for k in data.files}

    if like is None:
        nested: Dict = {}
        for key, arr in arrays.items():
            parts = key.split("/")
            d = nested
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = arr
        return nested, manifest["meta"]

    leaves = []
    for key, want in _leaves(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        got = arrays[key]
        shape = tuple(want.shape) if hasattr(want, "shape") else ()
        if tuple(got.shape) != shape:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {got.shape} vs model {shape}")
        if isinstance(want, torch.Tensor):
            leaves.append(torch.as_tensor(got, device=want.device).to(
                want.dtype))
        else:
            leaves.append(got.astype(np.asarray(want).dtype))
    return _rebuild(like, iter(leaves)), manifest["meta"]
