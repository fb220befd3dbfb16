"""Checkpointing: the fault-tolerance substrate of the training loop.

Port of ``repro/checkpoint/store.py``, with the reference's on-disk layout
(per step)::

    <dir>/step_000123/
        host_000.npz          one file per host: whole leaves, one array
        ...                   per tree path
        MANIFEST.json         step, hosts, per-leaf global shape and dtype
        COMMIT                written LAST; a step without COMMIT is ignored

Tree paths come from walking the port's nested dicts and lists
(``repro_torch.tree.tree_paths``); bf16 leaves are stored as their uint16
bits with dtype "bfloat16" in the manifest, as the reference stores them.

Elastic, as the reference's: every leaf is stored *global* (a DTensor leaf
gathered whole first), host ``h`` of ``n_hosts`` writes the leaves ``i``
with ``i % n_hosts == h``, and restore reads the union of whichever host
files exist and places each leaf by the placements it is given on the
*current* mesh (each rank keeps its chunk), so a state saved on one mesh
restarts on another, or on one device; a reference checkpoint (every leaf
in each host file) reads the same way.  Host 0 writes the manifest and,
once every host's file is there, ``COMMIT``.  Without placements a leaf
goes to the device of the matching leaf of ``like`` (or to ``device``).
Each host copies to host memory only the leaves it writes (a DTensor
leaf is gathered whole on every host, then freed by the hosts that do not
write it).  ``CheckpointManager.save_async`` takes that copy inside the
step boundary (the gathers are collectives: every rank calls it) and
writes it on a background thread.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as S
from repro_torch.tree import tree_flatten, tree_paths

# seconds host 0 waits for the other hosts' files before it commits
COMMIT_WAIT = 600.0


def _to_numpy(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _meta(leaf: Any) -> Dict[str, Any]:
    """A leaf's global shape and dtype name, as the manifest stores them
    (a DTensor's are its whole tensor's)."""
    if torch.is_tensor(leaf):
        return {"shape": list(leaf.shape),
                "dtype": str(leaf.dtype).removeprefix("torch.")}
    arr = np.asarray(leaf)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _host_share(state: Any, host_id: int, n_hosts: int):
    """(this host's leaves as host arrays, every leaf's manifest entry).
    A DTensor leaf is gathered whole on every host (a collective: each
    host calls this), copied to host memory only by the host that writes
    it, and freed before the next."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Dict] = {}
    for i, (key, leaf) in enumerate(tree_paths(state)):
        meta[key] = _meta(leaf)
        mine = i % n_hosts == host_id
        if isinstance(leaf, DTensor):
            whole = S.full_tensor(leaf)
            if mine:
                arrays[key] = _to_numpy(whole.to("cpu"))
            del whole
        elif mine:
            arrays[key] = _to_numpy(leaf.detach().to("cpu", copy=True)
                                    if torch.is_tensor(leaf) else leaf)
    return arrays, meta


def save_state(state: Any, directory: str, step: int, *, host_id: int = 0,
               n_hosts: int = 1) -> pathlib.Path:
    """Write this host's share of ``state``'s leaves for ``step``; host 0
    writes the manifest and commits once every host's file is there.
    DTensor leaves are gathered whole on every host (collectives: each
    host calls this)."""
    return _write_share(directory, step, *_host_share(state, host_id,
                                                      n_hosts),
                        host_id=host_id, n_hosts=n_hosts)


def _write_share(directory: str, step: int, arrays: Dict[str, np.ndarray],
                 meta: Dict[str, Dict], *, host_id: int,
                 n_hosts: int) -> pathlib.Path:
    d = pathlib.Path(directory) / f"step_{step:06d}"
    d.mkdir(parents=True, exist_ok=True)
    name = d / f"host_{host_id:03d}.npz"
    tmp = d / f"host_{host_id:03d}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, name)
    if host_id == 0:
        (d / "MANIFEST.json").write_text(json.dumps(
            {"step": step, "n_hosts": n_hosts, "leaves": meta}))
        deadline = time.monotonic() + COMMIT_WAIT
        while not all((d / f"host_{h:03d}.npz").exists()
                      for h in range(n_hosts)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{d}: host files missing after "
                                   f"{COMMIT_WAIT} s; not committed")
            time.sleep(0.05)
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


def read_leaves(directory: str, step: int) -> Dict[str, torch.Tensor]:
    """{tree path: whole leaf as a CPU tensor} from the union of the step's
    host files (bf16 leaves restored from their bits)."""
    d = pathlib.Path(directory) / f"step_{step:06d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    out: Dict[str, torch.Tensor] = {}
    for f in sorted(d.glob("host_*.npz")):
        if f.name.endswith(".tmp.npz"):
            continue
        with np.load(f) as z:
            for k in z.files:
                arr = z[k]
                if manifest["leaves"][k]["dtype"] == "bfloat16":
                    out[k] = torch.from_numpy(
                        arr.view(np.int16)).view(torch.bfloat16)
                else:
                    out[k] = torch.from_numpy(arr)
    missing = [k for k in manifest["leaves"] if k not in out]
    if missing:
        raise FileNotFoundError(f"{d}: no host file holds {missing[:3]} "
                                f"({len(missing)} leaves)")
    return out


def read_tree(directory: str, step: int) -> Any:
    """The step's leaves as a nested tree of CPU tensors, rebuilt from their
    paths (a level whose keys are all digits is a list): a checkpoint of
    another layout (the reference's stacked layers) in the shape it was
    saved."""
    root: Dict[str, Any] = {}
    for path, t in read_leaves(directory, step).items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def restore_state(like: Any, directory: str, step: int, *,
                  device=None, placements: Any = None, mesh=None) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor on
    ``device``, or on the device of ``like``'s leaf (the CPU for a leaf
    that is not a tensor); with ``placements`` (a tree like ``like``'s),
    a DTensor of this rank's chunk on ``mesh`` (the active one by
    default).  A DTensor leaf of ``like`` without placements given is
    restored to its own placements on its own mesh."""
    data = read_leaves(directory, step)
    pls = dict(tree_paths(placements)) if placements is not None else {}
    out = []
    for key, leaf in tree_paths(like):
        pl = pls.get(key)
        on = mesh
        if pl is None and isinstance(leaf, DTensor):
            pl, on = leaf.placements, leaf.device_mesh
        dev = device if device is not None else (
            (leaf.to_local() if isinstance(leaf, DTensor) else leaf).device
            if torch.is_tensor(leaf) else "cpu")
        t = data[key].to(dev)
        out.append(S.distribute(t, pl, on) if pl is not None else t)
    return tree_flatten(like)[1](out)


class CheckpointManager:
    """Async save + keep-k GC + auto-resume."""

    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: Optional[threading.Thread] = None

    def save_async(self, state: Any, step: int) -> None:
        self.wait()
        # Snapshot this host's share to host memory synchronously (a
        # consistent cut; DTensor leaves gathered whole), write it on a
        # background thread.
        arrays, meta = _host_share(state, self.host_id, self.n_hosts)

        def _write():
            _write_share(str(self.directory), step, arrays, meta,
                         host_id=self.host_id, n_hosts=self.n_hosts)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        if self.host_id != 0:
            return
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.iterdir()
            if re.fullmatch(r"step_\d+", p.name) and (p / "COMMIT").exists())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s:06d}", ignore_errors=True)

    def restore_latest(self, like: Any, *, device=None, placements=None,
                       mesh=None):
        step = latest_step(str(self.directory))
        if step is None:
            return None, None
        return restore_state(like, str(self.directory), step, device=device,
                             placements=placements, mesh=mesh), step
