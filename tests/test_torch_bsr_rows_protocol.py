"""The ``rows`` schedule's mbarrier ring (``bsr_matmul.cu``), replayed on
the CPU from ``ref.rows_units`` and ``budget``.

A block's producer warp fills a ring of RSTAGES stages, each on a "full"
barrier, and refills a stage once its "empty" barrier has had RW consumer
arrivals; each consumer warp waits on a stage's full barrier before it
reads the stage and arrives on its empty barrier once done with it; a warp
with no piece in a unit's partial last stage releases that stage too.

Bookkeeping: for every block width, itemsize, pass and cluster ``budget``
allows, and units of 0, 1 and many tiles, each stage's empty barrier gets
exactly RW arrivals, every arrival and read follows the warp's wait on the
stage, and the producer and the consumers count the same stages a unit.

Interleavings: the ring run as a model of the hardware's barriers (a phase
count a barrier, ``try_wait.parity`` true while the current phase's parity
differs from the one asked for), its warps interleaved by seeded random
schedules and by adversaries that run one warp only when nothing else can
move.  The kernel's protocol must finish every schedule without a deadlock,
a stage refilled under a warp still reading it, or a read of the wrong
stage.  The control, the last-stage release of the source before it waited
for its stage, must fail under the adversary: a warp RSTAGES stages ahead
completes the slot's earlier phase without the slow warp's arrival, the
producer refills the slot, and the slow warp, finding the full barrier two
phases on, waits for ever (the stall seen in Jamba-1.5-Large's prefill).
"""
from __future__ import annotations

import os
import random

import pytest

from repro_torch.kernels import budget
from repro_torch.kernels.bsr_matmul import ablate
from repro_torch.kernels.bsr_matmul.ref import rows_units

RW = budget.BSR_MATMUL_ROWS_WARPS
RSTAGES = budget.BSR_MATMUL_ROWS_STAGES
PIECE = budget.BSR_MATMUL_PIECE
RCHUNK = 64            # pieces a block fetches x for at once (the source's)
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "bsr_matmul", "csrc",
    "bsr_matmul.cu")
TILE_COUNTS = (0, 1, 2, 3, 7, 8, 9, 31, 32, 33, 41, 42, 43, 64, 65, 100, 131)


class Geometry:
    """The kernel's walk of one launch shape: a stage's tiles and (16, 16)
    parts, whether it is the KS = 1 instance (waits at a warp's first part
    of a stage only), and a consumer warp's chunk (PF parts)."""

    def __init__(self, bn: int, itemsize: int, rows_pass: int):
        self.ks = bn // PIECE
        self.ks1 = bn == PIECE
        stage1 = 4096 // (PIECE * PIECE * itemsize)   # stage1_tiles<T>()
        self.stage_tiles = (stage1 if self.ks1 else
                            budget.bsr_matmul_rows_stage_tiles(bn, itemsize))
        self.sp = self.stage_tiles * self.ks
        self.pf = RCHUNK // RW // (rows_pass // 8) if itemsize == 2 else 4
        self.pj1 = stage1 // RW

    def stages(self, nt: int) -> int:
        """Stages of a unit of ``nt`` tiles (the producer's, and gbase's
        step)."""
        return -(-nt // self.stage_tiles)

    def warp_ops(self, warp: int, nt: int, release_waits: bool = True):
        """Consumer warp ``warp``'s barrier operations over a unit, in
        order: ("wait" | "read" | "arrive", stage of the unit)."""
        total, sp, ops = nt * self.ks, self.sp, []
        for c0 in range(0, total, RW * self.pf):
            for k in range(self.pf):
                q = c0 + warp + RW * k
                if q >= total:
                    continue
                s = q // sp
                if not self.ks1 or k % self.pj1 == 0:
                    ops.append(("wait", s))
                ops.append(("read", s))
                if q + RW >= total or (q + RW) // sp != s:
                    ops.append(("arrive", s))
        if total > 0 and warp >= total - (total - 1) // sp * sp:
            last = (total - 1) // sp
            if release_waits:
                ops.append(("wait", last))
            ops.append(("arrive", last))
        return ops


def allowed_geometries():
    """Every (bn, itemsize, pass) the rows schedule takes: widths up to the
    widest ``bsr_matmul_rows_width`` keeps whole."""
    out = []
    for itemsize, passes in ((2, budget.BSR_MATMUL_ROWS_PASS_BF16),
                             (4, budget.BSR_MATMUL_ROWS_PASS_F32)):
        for bn in range(PIECE, 880 + 1, PIECE):
            if budget.bsr_matmul_rows_width(bn) != bn:
                continue
            out += [(bn, itemsize, r) for r in passes]
    return out


GEOMETRIES = allowed_geometries()


def test_the_ks1_stage_is_budgets():
    """The KS = 1 instance ignores the launcher's stage size for its
    constant one: both must be the same tiles, dealing whole parts to
    every warp, a chunk holding whole stages."""
    for itemsize, passes in ((2, budget.BSR_MATMUL_ROWS_PASS_BF16),
                             (4, budget.BSR_MATMUL_ROWS_PASS_F32)):
        g = Geometry(PIECE, itemsize, passes[0])
        assert budget.bsr_matmul_rows_stage_tiles(PIECE, itemsize) == \
            g.stage_tiles
        for r in passes:
            g = Geometry(PIECE, itemsize, r)
            assert (RW * g.pf) % g.stage_tiles == 0
            assert g.stage_tiles % RW == 0


@pytest.mark.parametrize("bn, itemsize, rows_pass", GEOMETRIES, ids=str)
def test_every_stage_gets_rw_arrivals(bn, itemsize, rows_pass):
    g = Geometry(bn, itemsize, rows_pass)
    assert g.sp % RW == 0   # the launcher refuses other stage sizes
    for cluster in range(1, budget.BSR_MATMUL_ROWS_CLUSTER_MAX + 1):
        units = rows_units(list(TILE_COUNTS), cluster)
        for nt in {int(u[2] - u[1]) for u in units}:
            stages = g.stages(nt)
            arrivals = [0] * stages
            seen = set()
            for warp in range(RW):
                waited = set()
                for op, s in g.warp_ops(warp, nt):
                    assert 0 <= s < stages
                    if op == "wait":
                        waited.add(s)
                    else:   # a read or an arrival follows a wait
                        assert s in waited, (bn, itemsize, nt, warp, op, s)
                    if op == "arrive":
                        assert (warp, s) not in seen
                        seen.add((warp, s))
                        arrivals[s] += 1
            assert arrivals == [RW] * stages, (bn, itemsize, rows_pass, nt)


# -- the ring under interleavings ---------------------------------------------

class Ring:
    """One block's producer and RW consumer warps over ``nts`` (its units'
    tile counts) on modelled mbarriers."""

    def __init__(self, g: Geometry, nts, release_waits: bool):
        self.full = [0] * RSTAGES      # completed phases
        self.empty = [0] * RSTAGES
        self.pending = [0] * RSTAGES   # arrivals of the empty phase open
        self.content = [None] * RSTAGES
        self.holds = {}                # warp -> {slot: stage it reads}
        prod, cons, gbase = [], [[] for _ in range(RW)], 0
        for u, nt in enumerate(nts):
            for s in range(g.stages(nt)):
                gs = gbase + s
                if gs >= RSTAGES:
                    prod.append(("wait", "empty", gs % RSTAGES,
                                 (gs // RSTAGES - 1) & 1))
                prod.append(("load", gs))
            for warp in range(RW):
                for op, s in g.warp_ops(warp, nt, release_waits):
                    gs = gbase + s
                    if op == "wait":
                        cons[warp].append(("wait", "full", gs % RSTAGES,
                                           (gs // RSTAGES) & 1))
                    else:
                        cons[warp].append((op, gs))
                cons[warp].append(("sync", u))
            gbase += g.stages(nt)
        self.ops = [prod] + cons       # actor 0 the producer, 1 + w warp w
        self.at = [0] * len(self.ops)

    def _next(self, a):
        return self.ops[a][self.at[a]] if self.at[a] < len(self.ops[a]) \
            else None

    def enabled(self, a) -> bool:
        op = self._next(a)
        if op is None:
            return False
        if op[0] == "wait":
            phases = self.full if op[1] == "full" else self.empty
            return (phases[op[2]] & 1) != op[3]
        if op[0] == "sync":   # the consumer warps' bar.sync
            return all(self._next(b) == op for b in range(1, len(self.ops)))
        return True

    def step(self, a) -> None:
        op, warp = self._next(a), a - 1
        if op[0] == "sync":
            for b in range(1, len(self.ops)):
                self.at[b] += 1
            return
        self.at[a] += 1
        if op[0] == "wait" and op[1] == "full":
            self.holds.setdefault(warp, {})[op[2]] = None
        elif op[0] == "load":
            slot = op[1] % RSTAGES
            for w, held in self.holds.items():
                if slot in held:
                    raise AssertionError(f"stage {op[1]} refilled slot {slot} "
                                         f"under warp {w}")
            self.content[slot] = op[1]
            self.full[slot] += 1
        elif op[0] == "read":
            slot = op[1] % RSTAGES
            if self.content[slot] != op[1]:
                raise AssertionError(f"warp {warp} read stage "
                                     f"{self.content[slot]} for {op[1]}")
        elif op[0] == "arrive":
            slot = op[1] % RSTAGES
            self.holds.get(warp, {}).pop(slot, None)
            self.pending[slot] += 1
            if self.pending[slot] == RW:
                self.pending[slot] = 0
                self.empty[slot] += 1

    def run(self, pick) -> None:
        """Steps the actors ``pick`` chooses among the enabled ones until all
        are done; raises on a deadlock or a race."""
        while True:
            ready = [a for a in range(len(self.ops)) if self.enabled(a)]
            if not ready:
                stuck = [(a, self._next(a)) for a in range(len(self.ops))
                         if self._next(a) is not None]
                if stuck:
                    raise AssertionError(f"deadlock: {stuck}")
                return
            self.step(pick(ready))


def last_mover(victim: int):
    """An adversary: actor ``victim`` moves only when nothing else can."""
    def pick(ready):
        others = [a for a in ready if a != victim]
        return others[0] if others else victim
    return pick


# Jamba's prefill (bf16, (16, 16), passes of 64 rows), Yi-9B's decode at 4
# rows in (16, 16) and (128, 128) tiles, and f32 rows: units of the kinds a
# launch gives a block, a partial last stage of 1 to 3 parts RSTAGES or
# more stages into one of them
RING_CASES = [(16, 2, 64, (41, 102, 0, 1, 43)), (16, 2, 8, (42, 9, 33)),
              (16, 4, 32, (17, 1, 19)), (48, 2, 16, (17, 11, 4))]
# a (128, 128) bf16 stage is one tile, whose 8 parts fill it: no partial
# stage, nothing released unread
FULL_STAGE_CASES = [(128, 2, 8, (5, 0, 7, 3))]


@pytest.mark.parametrize("bn, itemsize, rows_pass, nts",
                         RING_CASES + FULL_STAGE_CASES, ids=str)
def test_the_ring_finishes_every_schedule(bn, itemsize, rows_pass, nts):
    g = Geometry(bn, itemsize, rows_pass)
    for victim in range(RW + 1):
        Ring(g, nts, release_waits=True).run(last_mover(victim))
    for seed in range(40):
        rng = random.Random(seed)
        Ring(g, nts, release_waits=True).run(rng.choice)


@pytest.mark.parametrize("bn, itemsize, rows_pass, nts", RING_CASES,
                         ids=str)
def test_the_unwaited_release_fails_under_the_adversary(bn, itemsize,
                                                        rows_pass, nts):
    g = Geometry(bn, itemsize, rows_pass)
    with pytest.raises(AssertionError, match="deadlock|refilled|read stage"):
        Ring(g, nts, release_waits=False).run(last_mover(1))


def test_the_source_releases_only_a_landed_stage():
    """The CUDA source's last-stage release waits on the stage's full
    barrier before its arrival, as the model above requires."""
    with open(SOURCE) as f:
        src = f.read()
    start = src.index("releases it too")
    release = src[start:src.index("gbase +=", start)]
    assert release.index("mbar_wait_warp(") < release.index("mbar_arrive(")


@pytest.mark.parametrize("name", ablate.STRESS_ORDER)
def test_each_stress_source_is_the_source_with_its_own_patches(name):
    """``ablate.py --stress``'s sources come from the CUDA source as it
    stands: the unwaited release only in the ``early_release`` controls,
    the pause only in the skewed ones (after the wait in ``_skew_late``),
    and each source's verdict: the kernel as built must run clean, a
    skewed control must be caught."""
    with open(SOURCE) as f:
        src = f.read()
    text = ablate.stress_source(src, name)
    early = name.startswith("early_release")
    unwaited = "        __syncwarp();\n        if (lane == 0) mbar_arrive("
    assert (unwaited in text) == early
    assert ("__nanosleep" in text) == ("_skew" in name)
    if "_skew" in name:
        pause = text.index("__nanosleep")
        wait = text.index("mbar_wait_warp(bars + 8 * slot,")
        assert (wait < pause) == name.endswith("_late")
    if name == "as_built":
        assert text == src
    assert ablate.stress_expect(name) == (
        "clean" if not early else "caught" if "_skew" in name else "either")


def test_an_unknown_stress_source_is_refused():
    with pytest.raises(ValueError, match="no stress source"):
        ablate.stress_source("", "as_built_late")
