"""Plan-cache rules: audit a cache file without executing anything.

Port of ``repro/analysis/plan_rules.py``: the same v6 key grammar
(``KEY_RE``), schema, migrations (through the port's ``tuning.cache``) and
rule ids, with each pinned schedule replayed through the card's probes
(``schedule_rules.ell_schedule`` / ``bsr_schedule``, the engine's own
arguments).

A plan cache (``repro_torch.tuning.cache``) is the deployment artifact that
decides which kernel every layer runs.  These rules parse the document and
every entry the way the loader and the engine would — schema version and
migration chain, per-entry method validity, the v5 BCSR block-shape
contract, the layer-key grammar, geometry self-consistency, tiling
divisibility, and the weight-structure tag — and verify that every pinned
ELL/BCSR schedule has a kernel on the card at the geometry its key
encodes.

Rules:

  plan.unreadable          file unreadable / invalid JSON / malformed
                           document or entry shape
  plan.schema_version      non-migratable schema version (error); a
                           migratable pre-v5 version reports as info
  plan.stale_bsr_no_block  a ``bsr`` entry with no block shape (pre-v5
                           document, or a hand-edited v5 entry) -- the
                           engine silently runs dense for it
  plan.key_unparsable      layer key does not match the key grammar
  plan.geometry_mismatch   key parses but encodes an impossible geometry
                           (kernel larger than the padded input, ...)
  plan.unknown_method      entry method outside the executor's METHODS
  plan.structure_tag       malformed ``_bk`` weight-structure tag (error);
                           an untagged bsr entry reports as info (it was
                           priced from the block-structured estimate)

Schedule infeasibilities found while replaying an entry at its key's
geometry are reported under the ``sched.*`` rules (same ids the network
check uses), so one rule id names one failure mode everywhere.  That
includes the v6 value-dtype axis: an entry pinning an unknown value dtype,
or one its key's backend cannot execute (fp8 on ``cpu``), reports as
``sched.value_dtype``; quantised BCSR entries replay their probe with the
narrow tile bytes the kernel stages, so a schedule that only fits with
quantised values is caught at the dtype it will actually run.  Entries
keyed at bf16 activations replay at bf16 (half the slab and operand bytes,
as the reference's replay takes its key's item size); a ``pallas``/``bsr``
entry keyed at f16 reports as ``sched.dtype_policy``: the card's conv
kernels take f32 and bf16.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

from repro_torch.analysis.diagnostics import REASON_RULES, Diagnostic
from repro_torch.analysis.schedule_rules import (KERNEL_DTYPES, bsr_schedule,
                                                 ell_schedule)
from repro_torch.engine.program import ConvOp
from repro_torch.tuning.cache import CACHE_VERSION, MIGRATABLE_VERSIONS
from repro_torch.tuning.space import (METHODS, VALUE_DTYPES, ConvGeometry,
                                      allowed_value_dtypes)

RULES = {
    "plan.unreadable": (
        "error",
        "cache file unreadable, invalid JSON, or malformed entry shape",
    ),
    "plan.schema_version": (
        "error",
        "non-migratable schema version (info when migratable pre-v5)",
    ),
    "plan.stale_bsr_no_block": (
        "error",
        "bsr entry with no BCSR block shape; engine silently runs dense",
    ),
    "plan.key_unparsable": (
        "error",
        "layer key does not match the cache key grammar",
    ),
    "plan.geometry_mismatch": (
        "error",
        "layer key encodes an impossible geometry",
    ),
    "plan.unknown_method": (
        "error",
        "entry method outside the executor's method set",
    ),
    "plan.structure_tag": (
        "error",
        "malformed weight-structure tag (info when a bsr entry is untagged)",
    ),
}

# The grammar of tuning.cache.layer_key (+ the optional planner-appended
# weight-structure tag).  dtype/backend are single identifiers: layer_key
# never embeds underscores in either.
KEY_RE = re.compile(
    r"^m(?P<m>\d+)_c(?P<c>\d+)_h(?P<h>\d+)w(?P<w>\d+)"
    r"_r(?P<r>\d+)s(?P<s>\d+)_st(?P<st>\d+)_p(?P<p>\d+)_n(?P<n>\d+)"
    r"_ep(?P<relu>[01])(?P<res>[01])_sp(?P<sp>[0-9.]+)"
    r"_(?P<dtype>[A-Za-z][A-Za-z0-9]*)_(?P<backend>[A-Za-z][A-Za-z0-9]*)"
    r"(?:_bk(?P<bk>[0-9.]+))?$"
)


def _diag(rule: str, severity: str, message: str, key: Optional[str] = None):
    return Diagnostic(
        rule=rule, severity=severity, message=message, location=key
    )


def geometry_from_key(match: "re.Match") -> ConvGeometry:
    """Reconstruct the ConvGeometry a layer key encodes (name = the key)."""
    g = match.groupdict()
    return ConvGeometry(
        name=match.string,
        m=int(g["m"]),
        c=int(g["c"]),
        h=int(g["h"]),
        w=int(g["w"]),
        r=int(g["r"]),
        s=int(g["s"]),
        stride=int(g["st"]),
        pad=int(g["p"]),
        sparsity=float(g["sp"]),
        batch=int(g["n"]),
        dtype=g["dtype"],
        relu=g["relu"] == "1",
        residual=g["res"] == "1",
    )


def _conv_of(g: ConvGeometry) -> ConvOp:
    """The ConvOp the engine would lower for the geometry a key encodes
    (square filters: the engine's convs are)."""
    return ConvOp(name=g.name, src=0, out=1, c=g.c, h=g.h, w=g.w, m=g.m,
                  k=g.r, stride=g.stride, pad=g.pad, sparsity=g.sparsity,
                  e=g.e, f=g.f, fuse_relu=g.relu)


def _check_entry_schedule(
    key: str, g: ConvGeometry, entry: Dict[str, Any]
) -> List[Diagnostic]:
    """Replay a pallas/bsr entry's dispatch at its key's geometry, through
    the card's probes."""
    method = entry.get("method")
    if method not in ("pallas", "bsr"):
        return []
    if g.dtype not in KERNEL_DTYPES:
        return [_diag(
            "sched.dtype_policy", "error",
            f"{method} entry keyed at {g.dtype} activations, but the card's "
            f"conv kernels take {KERNEL_DTYPES} only", key)]
    op = _conv_of(g)
    vdt = entry.get("value_dtype", "float32") or "float32"
    if method == "pallas":
        tm = entry.get("tm")
        pipeline = bool(entry.get("pipeline", False))
        sched, reason = ell_schedule(op, batch=g.batch, tm=tm,
                                     pipeline=pipeline, dtype=g.dtype)
        if sched is None:
            return [_diag(
                REASON_RULES[reason], "error",
                f"pallas entry (tm={tm}) has no ELL kernel schedule on the "
                f"card at its key geometry: {reason}", key)]
        if pipeline and not sched.pipeline:
            return [_diag(
                "sched.pipeline_demoted", "warning",
                "entry asks for the pipelined ELL schedule but it does not "
                "fit (or the conv is 1x1); the kernel runs the blocking "
                "schedule", key)]
        return []
    bm, bn = entry.get("block_m"), entry.get("block_n")
    if bm is None or bn is None:
        return []  # reported as plan.stale_bsr_no_block already
    sched, reason = bsr_schedule(op, int(bm), int(bn), batch=g.batch,
                                 value_dtype=vdt, dtype=g.dtype)
    if sched is None:
        return [_diag(
            REASON_RULES[reason], "error",
            f"bsr entry (block={bm}x{bn}, {vdt}) has no BCSR kernel "
            f"schedule on the card at its key geometry: {reason}", key)]
    return []


def _check_entry(
    key: str, entry: Any, version: int
) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    if not isinstance(entry, dict) or "method" not in entry:
        out.append(
            _diag(
                "plan.unreadable",
                "error",
                "entry is not an object with a 'method' field",
                key,
            )
        )
        return out
    method = entry["method"]
    if method not in METHODS:
        out.append(
            _diag(
                "plan.unknown_method",
                "error",
                f"method {method!r} not one of {METHODS}",
                key,
            )
        )
        return out
    if method == "bsr" and (
        version < 5
        or entry.get("block_m") is None
        or entry.get("block_n") is None
    ):
        why = (
            f"pre-v{CACHE_VERSION} document: migrates with no block shape"
            if version < 5
            else "entry carries no block shape"
        )
        out.append(
            _diag(
                "plan.stale_bsr_no_block",
                "error",
                f"bsr entry cannot run ({why}); the engine silently falls "
                f"back to dense",
                key,
            )
        )
    m = KEY_RE.match(key)
    if m is None:
        out.append(
            _diag(
                "plan.key_unparsable",
                "error",
                "layer key does not match the cache key grammar "
                "m<M>_c<C>_h<H>w<W>_r<R>s<S>_st<ST>_p<P>_n<N>_ep<RL><RS>"
                "_sp<SP>_<dtype>_<backend>[_bk<frac>]",
                key,
            )
        )
        return out
    g = geometry_from_key(m)
    hp, wp = g.h + 2 * g.pad, g.w + 2 * g.pad
    if (
        min(g.m, g.c, g.h, g.w, g.r, g.s, g.stride) < 1
        or hp < g.r
        or wp < g.s
        or not 0.0 <= g.sparsity <= 1.0
    ):
        out.append(
            _diag(
                "plan.geometry_mismatch",
                "error",
                f"key encodes an impossible geometry (padded input "
                f"{hp}x{wp}, kernel {g.r}x{g.s}, stride {g.stride}, "
                f"sparsity {g.sparsity})",
                key,
            )
        )
        return out
    vdt = entry.get("value_dtype", "float32") or "float32"
    if method in ("pallas", "bsr") and vdt != "float32":
        if vdt not in VALUE_DTYPES:
            out.append(
                _diag(
                    "sched.value_dtype",
                    "error",
                    f"entry pins unknown value dtype {vdt!r}; one of "
                    f"{VALUE_DTYPES}",
                    key,
                )
            )
            return out
        backend = m.group("backend")
        allowed = allowed_value_dtypes(backend)
        if vdt not in allowed:
            out.append(
                _diag(
                    "sched.value_dtype",
                    "error",
                    f"entry pins value dtype {vdt!r} but its key's backend "
                    f"{backend!r} only executes {allowed}",
                    key,
                )
            )
            return out
    elif method not in ("pallas", "bsr") and vdt != "float32":
        out.append(
            _diag(
                "sched.value_dtype",
                "error",
                f"entry pins value dtype {vdt!r} on method {method!r}, "
                f"which has no quantised value-stream path",
                key,
            )
        )
        return out
    bk = m.group("bk")
    if bk is not None:
        try:
            frac = float(bk)
        except ValueError:
            frac = -1.0
        if not 0.0 <= frac <= 1.0:
            out.append(
                _diag(
                    "plan.structure_tag",
                    "error",
                    f"malformed weight-structure tag _bk{bk} (expected a "
                    f"kept-tile fraction in [0, 1])",
                    key,
                )
            )
    elif method == "bsr":
        out.append(
            _diag(
                "plan.structure_tag",
                "info",
                "untagged bsr entry: priced from the block-structured "
                "pruning estimate, not the bank's actual kept-tile "
                "structure",
                key,
            )
        )
    out += _check_entry_schedule(key, g, entry)
    return out


def check_plan_file(path: str) -> List[Diagnostic]:
    """Audit one plan-cache document; never raises, never executes."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
        return [
            _diag("plan.unreadable", "error", f"{path}: {exc}", None)
        ]
    out: List[Diagnostic] = []
    if not isinstance(doc, dict):
        return [
            _diag(
                "plan.unreadable",
                "error",
                f"{path}: document is not a JSON object",
                None,
            )
        ]
    version = doc.get("version")
    if version != CACHE_VERSION and version not in MIGRATABLE_VERSIONS:
        out.append(
            _diag(
                "plan.schema_version",
                "error",
                f"{path}: version {version!r} is neither current "
                f"({CACHE_VERSION}) nor migratable {MIGRATABLE_VERSIONS}",
                None,
            )
        )
        return out
    if version != CACHE_VERSION:
        out.append(
            _diag(
                "plan.schema_version",
                "info",
                f"{path}: migratable v{version} document; will be "
                f"re-persisted as v{CACHE_VERSION} on the next save",
                None,
            )
        )
    entries = doc.get("entries", {})
    if not isinstance(entries, dict):
        out.append(
            _diag(
                "plan.unreadable",
                "error",
                f"{path}: 'entries' is not an object",
                None,
            )
        )
        return out
    for key, entry in entries.items():
        out += _check_entry(key, entry, int(version))
    return out
