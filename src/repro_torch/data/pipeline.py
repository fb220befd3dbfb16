"""Deterministic sharded data pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only): the same (seed, step,
host_id) gives the same batch, bit for bit, in both packages.

Production posture (1000+ nodes): every host deterministically derives its
own shard of each global batch from (seed, step, host_id) — no coordinator,
no filesystem contention, bit-identical restart after failover at any step
(the checkpoint only needs to store ``step``).  A background prefetch thread
keeps ``prefetch`` batches ready so host compute overlaps device compute.

The token source is a synthetic-but-deterministic LM stream (counter-based
threefry keys); swapping in a real tokenised corpus only replaces
``SyntheticLMDataset.batch_for``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2
    embed_dim: int = 0          # >0: emit precomputed embeddings (stub frontends)


class SyntheticLMDataset:
    """Counter-based deterministic token stream; O(1) random access by step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.host_batch = cfg.global_batch // cfg.n_hosts

    def batch_for(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[0, 0, step, cfg.host_id]))
        shape = (self.host_batch, cfg.seq_len + 1)
        toks = rng.integers(0, cfg.vocab, size=shape, dtype=np.int32)
        out: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.embed_dim:
            emb = rng.standard_normal(
                (self.host_batch, cfg.seq_len, cfg.embed_dim)).astype(np.float32)
            out = {"embeds": emb, "labels": toks[:, 1:]}
        return out


class ShardedLoader:
    """Background prefetch over a dataset; yields host-local numpy batches."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0):
        self.dataset = dataset
        self.step = start_step
        self._q: "queue.Queue[Any]" = queue.Queue(
            maxsize=max(dataset.cfg.prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = self.dataset.batch_for(s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self) -> None:
        self._stop.set()


def make_loader(cfg: DataConfig, start_step: int = 0) -> ShardedLoader:
    return ShardedLoader(SyntheticLMDataset(cfg), start_step=start_step)
