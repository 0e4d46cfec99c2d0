"""Checkpointing substrate (the JAX package's ``checkpoint/manager.py``,
same on-disk format: a checkpoint of either package loads in the other).

Fault-tolerance properties:
  * **Atomicity** — each checkpoint is written to ``step_NNN.tmp`` and
    renamed only after the manifest (with per-leaf shapes/dtypes and a
    content checksum) is fully flushed; a crash mid-save never corrupts
    the latest restorable state.
  * **Restart** — ``CheckpointManager.restore_latest`` finds the newest
    complete checkpoint; combined with the pure-function data pipeline the
    run resumes from (params, opt_state, step).
  * **Device placement** — tensors are stored unsharded as numpy arrays;
    ``load_checkpoint`` puts every leaf on the device asked for, in its
    stored dtype. (Restoring onto a mesh belongs to distribution.)
  * **Retention** — ``keep`` newest checkpoints are retained; older ones
    are garbage-collected only after a newer one is durable.

Storage is a directory holding ``arrays.npz`` + ``manifest.json``. npz
cannot hold bfloat16, so a bfloat16 leaf is stored as its uint16 bit
pattern with ``"bfloat16"`` in the manifest, as the reference stores it;
torch's ``view(torch.int16)`` and numpy's ``view(np.uint16)`` carry the
bits without a conversion (and without ``ml_dtypes``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.params import flatten, unflatten

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as the array npz stores and its true dtype's name."""
    if isinstance(leaf, torch.Tensor):
        if type(leaf).__name__ == "DTensor":
            leaf = leaf.full_tensor()        # stored unsharded
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, device: torch.device
               ) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _sha256(path: str) -> str:
    checksum = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            checksum.update(block)
    return checksum.hexdigest()


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomically persist a tree of tensors; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _to_numpy(v) for k, v in flatten(tree).items()}
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(a.shape), "dtype": dtype}
                   for k, (a, dtype) in flat.items()},
        "checksum": _sha256(npz_path),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomicity barrier
    return final


def load_checkpoint(path: str, device: "str | torch.device" = "cuda",
                    verify: bool = True) -> tuple[Any, dict]:
    """Load a checkpoint: (tree of tensors on ``device``, manifest). Each
    leaf keeps its stored dtype; ``verify`` checks the checksum first."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, "arrays.npz")
    if verify and _sha256(npz_path) != manifest["checksum"]:
        raise IOError(f"checksum mismatch in {path}")
    with np.load(npz_path) as z:
        flat = {k: _to_tensor(z[k], manifest["leaves"][k]["dtype"], dev)
                for k in z.files}
    return unflatten(flat), manifest


class CheckpointManager:
    """Retention + latest-discovery around save/load."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        path = save_checkpoint(self.directory, step, tree, extra)
        self._gc()
        return path

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for entry in os.listdir(self.directory):
            m = _STEP_RE.match(entry)
            if m and os.path.exists(os.path.join(self.directory, entry,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, device: "str | torch.device" = "cuda"
                       ) -> Optional[tuple[Any, dict]]:
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"step_{step:08d}")
        return load_checkpoint(path, device)

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
