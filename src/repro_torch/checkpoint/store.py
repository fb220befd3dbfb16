"""Checkpointing: the fault-tolerance substrate of the training loop.

Port of ``repro/checkpoint/store.py``, with the reference's on-disk layout
(per step)::

    <dir>/step_000123/
        host_000.npz          the leaves, one array per tree path
        MANIFEST.json         step, hosts (1), per-leaf shape and dtype
        COMMIT                written LAST; a step without COMMIT is ignored

Tree paths come from walking the port's nested dicts and lists
(``repro_torch.tree.tree_paths``); bf16 leaves are stored as their uint16
bits with dtype "bfloat16" in the manifest, as the reference stores them.
The port runs on one card, so every leaf is whole in the one host file
(sharded save and restore wait for the multi-chip slice); restore puts
each leaf on the device of the matching leaf of ``like`` (or on
``device``).  ``CheckpointManager.save_async`` copies the state to host
memory inside the step boundary and writes it on a background thread.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map, tree_paths


def _to_numpy(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save_state(state: Any, directory: str, step: int) -> pathlib.Path:
    """Write the leaves of ``state`` for ``step`` and commit."""
    d = pathlib.Path(directory) / f"step_{step:06d}"
    d.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Dict] = {}
    for key, leaf in tree_paths(state):
        arr = _to_numpy(leaf)
        arrays[key] = arr
        meta[key] = {"shape": list(arr.shape),
                     "dtype": _dtype_name(leaf, arr)}
    np.savez(d / "host_000.npz", **arrays)
    (d / "MANIFEST.json").write_text(json.dumps(
        {"step": step, "n_hosts": 1, "leaves": meta}))
    (d / "COMMIT").write_text("ok")
    return d


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "COMMIT").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_state(like: Any, directory: str, step: int, *,
                  device=None) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor on
    ``device``, or on the device of ``like``'s leaf (the CPU for a leaf
    that is not a tensor)."""
    d = pathlib.Path(directory) / f"step_{step:06d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    if manifest["n_hosts"] != 1:
        raise ValueError(f"checkpoint {d} is sharded over "
                         f"{manifest['n_hosts']} hosts; restoring it waits "
                         f"for the multi-chip slice")
    with np.load(d / "host_000.npz") as z:
        data: Dict[str, np.ndarray] = {k: z[k] for k in z.files}
    out = []
    for key, leaf in tree_paths(like):
        arr = data[key]
        if manifest["leaves"][key]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = device if device is not None else (
            leaf.device if torch.is_tensor(leaf) else "cpu")
        out.append(t.to(dev))
    return tree_flatten(like)[1](out)


class CheckpointManager:
    """Async save + keep-k GC + auto-resume."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, state: Any, step: int) -> None:
        self.wait()
        # Snapshot to host memory synchronously (a consistent cut), write
        # on a background thread.
        snapshot = tree_map(lambda x: x.detach().to("cpu", copy=True)
                            if torch.is_tensor(x) else np.asarray(x), state)

        def _write():
            save_state(snapshot, str(self.directory), step)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.iterdir()
            if re.fullmatch(r"step_\d+", p.name) and (p / "COMMIT").exists())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s:06d}", ignore_errors=True)

    def restore_latest(self, like: Any, *, device=None):
        step = latest_step(str(self.directory))
        if step is None:
            return None, None
        return restore_state(like, str(self.directory), step,
                             device=device), step
