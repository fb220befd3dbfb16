"""Persistent plan cache: tune once per deployment, reload forever.

Port of ``repro/tuning/cache.py`` at the same schema (v6), with the same
v1-v5 migrations and the same warnings on a bad file, so a cache written
by either package loads in the other.  The port keys its entries with the
backend ``"cuda"`` on the card (``"cpu"`` on the CPU), so an entry tuned
for another backend never serves it.

A plan cache is a small versioned JSON document mapping a *layer key* to the
winning :class:`PlanEntry`.  Keys capture everything the decision depends on —
layer geometry, a bucketed sparsity (so near-equal densities share plans,
like the paper's kernel-customization table), dtype, and backend — and
nothing it doesn't (layer names, model names), so identical layers across
models share one entry.

Format (the reference's ``docs/autotuning.md`` documents it for humans):

    {"version": 6,
     "entries": {"<key>": {"method": "bsr", "te": 32, "tf": 32,
                           "block_m": 32, "block_n": 128, "fuse": true,
                           "value_dtype": "int8",
                           "est_s": 1.2e-4, "source": "roofline"}}}

Version history: v6 added ``value_dtype`` — the bank's value-storage dtype
("float32", or the quantised "int8"/"float8_e4m3fn" with per-output-channel
f32 scales and f32 accumulation); v5 added the ``bsr`` method (BCSR
conv) and its ``block_m``/``block_n`` tile shape; v4 added the halo DMA
schedule ``pipeline`` (double-buffered staging: cell i+1's input block
copies while cell i computes) and ``permute`` (nnz-balanced bank with the
inverse permutation applied to the output) to pallas entries; v3 added the
``fuse`` flag (in-kernel epilogue: bias / ReLU / bottleneck shortcut
applied to the f32 accumulator); v2 added the output spatial tile
``(te, tf)``.  Older documents load via migration — v1 entries get ``te =
tf = None`` (the untiled schedule the v1 kernel executed), v1/v2 entries
get ``fuse = False`` (those kernels always ran the unfused three-pass
epilogue), v1-v3 entries get ``pipeline = permute = False`` (those kernels
always staged with a blocking single-buffer DMA over natural-order banks),
v1-v4 entries get ``block_m = block_n = None`` (no pre-v5 kernel ran
blocked), and v1-v5 entries get ``value_dtype = "float32"`` (every pre-v6
kernel streamed f32 values) — and are re-persisted as v6 on the next save.
A (corrupt or hand-edited) pre-v5 entry claiming ``method="bsr"``
therefore migrates with no block shape; executors treat that as a stale
plan and fall back to dense.  Likewise a migrated (f32) entry executed
against an already-quantised bank falls back with the
``value_dtype_mismatch`` reason code rather than silently dequantising.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, Optional

from repro_torch.tuning.space import Candidate, ConvGeometry

CACHE_VERSION = 6
# Older schema versions load() can migrate in-memory (see module docstring).
MIGRATABLE_VERSIONS = (1, 2, 3, 4, 5)


class PlanCacheWarning(UserWarning):
    """A plan-cache file could not be loaded (or was partially dropped) and
    the deployment continues on an empty/reduced cache instead."""

# Sparsity bucket width for cache keys: layers within 5% density share plans.
SPARSITY_BUCKET = 0.05


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """The winning customization for one layer key."""

    method: str
    tm: Optional[int] = None
    pad_to: Optional[int] = None
    te: Optional[int] = None      # output spatial tile (None: untiled)
    tf: Optional[int] = None
    fuse: bool = False            # pallas/bsr: in-kernel epilogue
    pipeline: bool = False        # pallas: double-buffered halo DMA
    permute: bool = False         # pallas: nnz-balanced bank
    block_m: Optional[int] = None  # bsr: BCSR tile shape
    block_n: Optional[int] = None
    value_dtype: str = "float32"   # pallas/bsr: value-storage dtype
    est_s: float = 0.0
    source: str = "heuristic"     # measured | roofline | heuristic
    # Where this entry came from *this run* — freshly_tuned | cache_hit |
    # migrated | default (see ExecutionReport).  Ephemeral bookkeeping for
    # telemetry: excluded from equality (a reloaded plan must still compare
    # equal to the freshly-tuned one that produced it) and from to_dict()
    # (the on-disk schema is unchanged).
    provenance: str = dataclasses.field(default="freshly_tuned",
                                        compare=False, repr=False)

    @property
    def candidate(self) -> Candidate:
        return Candidate(method=self.method, tm=self.tm, pad_to=self.pad_to,
                         te=self.te, tf=self.tf, fuse=self.fuse,
                         pipeline=self.pipeline, permute=self.permute,
                         block_m=self.block_m, block_n=self.block_n,
                         value_dtype=self.value_dtype)

    def to_dict(self) -> dict:
        return {"method": self.method, "tm": self.tm, "pad_to": self.pad_to,
                "te": self.te, "tf": self.tf, "fuse": self.fuse,
                "pipeline": self.pipeline, "permute": self.permute,
                "block_m": self.block_m, "block_n": self.block_n,
                "value_dtype": self.value_dtype,
                "est_s": self.est_s, "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanEntry":
        # Migration: absent te/tf means the untiled schedule (v1), absent
        # fuse the unfused three-pass epilogue (v1/v2), absent
        # pipeline/permute the blocking single-buffer DMA over a
        # natural-order bank (v1-v3), absent block_m/block_n no BCSR tile
        # shape (v1-v4; executors fall back if such an entry claims
        # method="bsr"), absent value_dtype an f32 value stream (v1-v5) —
        # each the schedule those kernels ran.
        return cls(method=d["method"], tm=d.get("tm"), pad_to=d.get("pad_to"),
                   te=d.get("te"), tf=d.get("tf"),
                   fuse=bool(d.get("fuse", False)),
                   pipeline=bool(d.get("pipeline", False)),
                   permute=bool(d.get("permute", False)),
                   block_m=d.get("block_m"), block_n=d.get("block_n"),
                   value_dtype=d.get("value_dtype", "float32"),
                   est_s=float(d.get("est_s", 0.0)),
                   source=d.get("source", "heuristic"))


def sparsity_bucket(sparsity: float) -> float:
    return round(round(sparsity / SPARSITY_BUCKET) * SPARSITY_BUCKET, 2)


def layer_key(g: ConvGeometry, backend: str) -> str:
    """Cache key: geometry x epilogue x sparsity bucket x dtype x backend.

    The epilogue part (``ep<relu><residual>``) keys the fuse axis: two convs
    with identical geometry but different fused epilogues (e.g. a bottleneck
    tail with a shortcut vs a plain conv+ReLU) must never share an entry —
    their candidate spaces and traffic models differ.
    """
    return (f"m{g.m}_c{g.c}_h{g.h}w{g.w}_r{g.r}s{g.s}_st{g.stride}"
            f"_p{g.pad}_n{g.batch}_ep{int(g.relu)}{int(g.residual)}"
            f"_sp{sparsity_bucket(g.sparsity)}_{g.dtype}_{backend}")


class PlanCache:
    """In-memory plan table with JSON load/save."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, PlanEntry] = {}
        if path and os.path.exists(path):
            self.load(path)

    def get(self, key: str) -> Optional[PlanEntry]:
        return self.entries.get(key)

    def put(self, key: str, entry: PlanEntry) -> None:
        self.entries[key] = entry

    def load(self, path: Optional[str] = None, *,
             strict: bool = False) -> "PlanCache":
        """Load a plan-cache document, resiliently by default.

        A plan cache is an accelerator, not a correctness input, so a
        corrupt, truncated, or unknown-schema file must not take a deploy
        down.  By default every load failure — unreadable file, invalid
        JSON, a non-migratable version, a malformed document shape — emits
        a :class:`PlanCacheWarning` (plus the ``tuning.cache.load_errors``
        counter when telemetry is on) and leaves the cache *empty*, exactly
        as on a cold deploy; individually malformed entries are dropped the
        same way without discarding their healthy siblings.
        ``strict=True`` restores the raising behaviour (what a plan-cache
        audit uses to localise corruption).
        """
        path = path or self.path
        self.entries = {}
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict):
                raise ValueError(
                    f"plan cache {path} is not a JSON object "
                    f"(got {type(doc).__name__})")
            version = doc.get("version")
            if version != CACHE_VERSION and version not in MIGRATABLE_VERSIONS:
                raise ValueError(
                    f"plan cache {path} has version {version!r}, "
                    f"expected {CACHE_VERSION} (or migratable "
                    f"{MIGRATABLE_VERSIONS})")
            raw = doc.get("entries", {})
            if not isinstance(raw, dict):
                raise ValueError(
                    f"plan cache {path} 'entries' is not an object")
        except (OSError, json.JSONDecodeError, UnicodeDecodeError,
                ValueError) as exc:
            if strict:
                raise
            self._load_error(path, str(exc))
            return self
        # v1-v5 migration happens in from_dict: absent te/tf default to None
        # (the untiled schedule), absent fuse to False (the unfused
        # epilogue), absent pipeline/permute to False (blocking DMA,
        # natural row order), absent block_m/block_n to None (no BCSR
        # shape), and absent value_dtype to "float32" (f32 value stream).
        # save() re-persists as the current version.
        provenance = "cache_hit" if version == CACHE_VERSION else "migrated"
        dropped = []
        for k, v in raw.items():
            try:
                entry = PlanEntry.from_dict(v)
            except (TypeError, KeyError, ValueError, AttributeError) as exc:
                if strict:
                    raise ValueError(
                        f"plan cache {path} entry {k!r} is malformed: {exc}"
                    ) from exc
                dropped.append(k)
                continue
            self.entries[k] = dataclasses.replace(entry,
                                                  provenance=provenance)
        if dropped:
            self._load_error(
                path, f"dropped {len(dropped)} malformed entr"
                      f"{'y' if len(dropped) == 1 else 'ies'} "
                      f"(e.g. {dropped[0]!r})")
        from repro_torch import telemetry  # local: keep module deps one-way
        if telemetry.is_enabled():
            telemetry.counter("tuning.cache.loads").inc()
            telemetry.counter("tuning.cache.loaded_entries").inc(
                len(self.entries))
            if version != CACHE_VERSION:
                telemetry.counter("tuning.cache.load_migrations").inc(
                    len(self.entries))
        return self

    @staticmethod
    def _load_error(path: Optional[str], detail: str) -> None:
        """One non-strict load failure: warn + gated telemetry counter."""
        warnings.warn(
            f"plan cache {path}: {detail}; continuing with an empty cache "
            "(the planner will re-tune)", PlanCacheWarning, stacklevel=3)
        from repro_torch import telemetry  # local: keep module deps one-way
        if telemetry.is_enabled():
            telemetry.counter("tuning.cache.load_errors").inc()

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no cache path given")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        doc = {"version": CACHE_VERSION,
               "entries": {k: e.to_dict() for k, e in sorted(self.entries.items())}}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    def __len__(self) -> int:
        return len(self.entries)
