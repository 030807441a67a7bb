"""Checkpoint and restart with the pipeline's lineage in the manifest: the
reference's `repro/checkpoint/save_restore.py`, in its layout.

Recovery is a restart from the latest checkpoint plus a replay of the
deterministic data pipeline from the manifest's step counter (DESIGN.md
§2).  Layout, as the reference writes it:

    <dir>/step_000123/
        manifest.json        # {"step", "leaves": {key: {file, shape,
                             #  dtype}}, ...extra entries}
        <key>.npy            # one array a leaf, key "/"-joined with "/"
                             # written "__" in the file name

A tree is nested dicts whose leaves are torch tensors, numpy arrays or
scalars.  bfloat16 leaves are stored as their uint16 bits with the
logical dtype "bfloat16" in the index, as the reference stores them (numpy
has no bfloat16; `ml_dtypes` is not imported).  Saves are atomic (written
to `<step>.tmp`, then renamed) and, through `CheckpointManager`,
asynchronous: the tree is copied to the host at once and a background
thread writes it, keeping the newest `keep` checkpoints.  A checkpoint the
reference wrote restores here (its parameter and optimizer leaves then go
through `models/convert.params_from_jax` and `opt_state_from_jax`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the order JAX flattens a tree of dicts: keys
    sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            name = f"{prefix}/{k}" if prefix else str(k)
            out.extend(_flatten_with_names(tree[k], name))
        return out
    return [(prefix, tree)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _logical_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _snapshot(tree):
    """A host copy of every leaf (tensors copied, not aliased)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


def save_checkpoint(directory: str, step: int, tree: Dict[str, Any],
                    extra_manifest: Optional[Dict] = None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    index = {}
    for name, leaf in _flatten_with_names(tree):
        arr = _to_host(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        index[name] = {"file": fname, "shape": list(arr.shape),
                       "dtype": _logical_dtype(leaf)}
    manifest = {"step": step, "leaves": index}
    if extra_manifest:
        manifest.update(extra_manifest)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _load(path: str, meta: Dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       template: Optional[Dict[str, Any]] = None
                       ) -> Tuple[Dict[str, Any], Dict]:
    """Restore the given (or latest) step: (tree, manifest).  With
    `template`, each leaf takes the template leaf's place, dtype and device
    (a tensor leaf), or comes back as it was saved; otherwise a nested dict
    following the saved keys, of CPU tensors in the saved dtypes."""
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {name: _load(path, meta)
              for name, meta in manifest["leaves"].items()}
    if template is not None:
        def fill(tmpl, prefix=""):
            if isinstance(tmpl, dict):
                return {k: fill(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in tmpl.items()}
            arr = arrays[prefix]
            if isinstance(tmpl, torch.Tensor):
                return arr.to(device=tmpl.device, dtype=tmpl.dtype)
            return arr
        return fill(template), manifest
    nested: Dict[str, Any] = {}
    for name, arr in arrays.items():
        parts = name.split("/")
        d = nested
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = arr
    return nested, manifest


class CheckpointManager:
    """Asynchronous, retention-managed checkpointing."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Dict[str, Any],
             extra_manifest: Optional[Dict] = None) -> None:
        # copied to the host at once (the step loop goes on updating the
        # tensors in place), written in the background
        snapshot = _snapshot(tree)
        if self._thread is not None:
            self._thread.join()

        def work():
            save_checkpoint(self.directory, step, snapshot, extra_manifest)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore_latest(self, template=None):
        return restore_checkpoint(self.directory, None, template)

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
