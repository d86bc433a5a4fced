"""Fault-tolerant checkpointing, the twin of ``repro.runtime.checkpoint``:
atomic save (tmp dir + rename), resume by step, a manifest with the arrays'
keys, and restore into a template.

The on-disk format is the JAX package's: ``ckpt_<step:010d>/`` holds one
``arr_<i:05d>.npy`` a leaf and ``manifest.json``, whose keys are the leaves'
paths as ``jax.tree_util.tree_flatten_with_path`` names them (dict keys
sorted, list indices: ``params/blocks/0/attn/wq``). So a checkpoint written
by either package restores in the other. Works for params, optimizer state
and (through ``extra``) the data stream's state.

bf16 leaves are written as ``np.save`` writes an ``ml_dtypes.bfloat16``
array (two raw bytes an element, the manifest naming the dtype), as the JAX
package writes them; restore reads those bytes back as bf16.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from ..bridge import _to_numpy, _to_tensor

MANIFEST = "manifest.json"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves by path: sorted dict keys and list indices joined by ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for key, sub in items:
        flat.update(_flatten(sub, f"{prefix}/{key}" if prefix else key))
    return flat


def _unflatten(template: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """``template``'s structure with the leaf at each path from ``leaves``."""
    join = (lambda k: f"{prefix}/{k}" if prefix else str(k))  # noqa: E731
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, join(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, join(i)) for i, v in enumerate(template))
    return leaves[prefix]


def config_fingerprint(cfg: Any) -> str:
    import dataclasses

    if dataclasses.is_dataclass(cfg):
        blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    else:
        blob = repr(cfg)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _as_numpy(leaf: Any) -> np.ndarray:
    return _to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomic: write to a tmp dir, fsync the manifest, rename to ckpt_<step>."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"ckpt_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory)
    try:
        manifest = {"step": step, "arrays": {}, "extra": extra or {}}
        for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
            arr = _as_numpy(leaf)
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["arrays"][key] = {"file": fname, "dtype": str(arr.dtype),
                                       "shape": list(arr.shape)}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("ckpt_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step: a directory without its
    manifest (a crash before the rename finished) does not count."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("ckpt_"))
    for d in reversed(ckpts):
        if os.path.exists(os.path.join(directory, d, MANIFEST)):
            return int(d.split("_")[1])
    return None


def _load(path: str, dtype: str) -> np.ndarray:
    arr = np.load(path)
    if dtype == "bfloat16" and arr.dtype.kind == "V":  # the raw bytes np.save wrote
        import ml_dtypes

        arr = arr.view(ml_dtypes.bfloat16)
    return arr


def restore_checkpoint(directory: str, template: Any, *,
                       step: Optional[int] = None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``template`` (a tree of tensors): each
    leaf in the template's dtype, on its device. Missing arrays and shape
    mismatches raise ``ValueError``; arrays the template lacks are skipped.
    Returns (tree, step, extra)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    cdir = os.path.join(directory, f"ckpt_{step:010d}")
    with open(os.path.join(cdir, MANIFEST)) as f:
        manifest = json.load(f)

    flat_template = _flatten(template)
    missing = set(flat_template) - set(manifest["arrays"])
    if missing:
        raise ValueError(f"checkpoint missing arrays: {sorted(missing)[:5]}")
    leaves = {}
    for key, tmpl in flat_template.items():
        info = manifest["arrays"][key]
        arr = _load(os.path.join(cdir, info["file"]), info["dtype"])
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs template {tuple(tmpl.shape)}")
        t = _to_tensor(arr, tmpl.device)
        leaves[key] = t if t.dtype == tmpl.dtype else t.to(tmpl.dtype)
    return _unflatten(template, leaves), step, manifest.get("extra", {})
