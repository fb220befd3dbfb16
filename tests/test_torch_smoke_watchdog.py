"""``chip_smoke.py``'s per-phase deadlines, on the CPU (no CUDA needed).

Each case runs the script's own ``Watchdog`` in a subprocess: a phase that
overruns its deadline must end the process non-zero within a few seconds,
printing the phase's name, the launch counters as they stood (and those
launched in the phase) and every thread's stack; a phase blocked in C
while it holds the interpreter's lock ends by faulthandler's timer.  The
table of deadlines must name every phase ``main`` runs.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PRELUDE = f"""
import re, sys, time
sys.path.insert(0, {ROOT!r})
import chip_smoke as cs
"""

SLEEPY = PRELUDE + """
calls = []

def counters():
    calls.append(1)
    return {"bsr_matmul": 7 + 2 * (len(calls) - 1), "flash_attention": 3}

def sleepy_phase():
    time.sleep(60)

dog = cs.Watchdog(counters=counters, deadlines={"sleepy": 0.5},
                  stops=(lambda: print("stopped", flush=True),))
with dog.phase("sleepy"):
    sleepy_phase()
print("not reached", flush=True)
"""

# a regex that backtracks for ever inside the C matcher, which holds the
# interpreter's lock: the watchdog's Python thread cannot run, and
# faulthandler's C timer must end the process
HOLDS_LOCK = PRELUDE + """
cs.WATCHDOG_GRACE_S = 1.0

def stuck_phase():
    re.match(r"(a+)+$", "a" * 64 + "b")

dog = cs.Watchdog(deadlines={"stuck": 0.5})
with dog.phase("stuck"):
    stuck_phase()
print("not reached", flush=True)
"""

QUICK = PRELUDE + """
dog = cs.Watchdog(deadlines={"quick": 2.0})
with dog.phase("quick"):
    time.sleep(0.1)
time.sleep(3.0)   # past the deadline: the phase's timers are cancelled
print("done", flush=True)
"""


def _run(code: str):
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=ROOT)
    return proc, time.monotonic() - t0


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_phase_past_its_deadline_ends_with_its_name_counters_and_stacks():
    proc, took = _run(SLEEPY)
    assert proc.returncode == chip_smoke.WATCHDOG_EXIT, proc.stderr
    assert took < 15
    lines = _json_lines(proc.stdout)
    assert {"phase_start": "sleepy", "deadline_s": 0.5} in lines
    (dead,) = [line for line in lines if "phase_deadline" in line]
    assert dead["phase_deadline"] == "sleepy"
    assert dead["deadline_s"] == 0.5
    assert dead["launches"] == {"bsr_matmul": 9, "flash_attention": 3}
    assert dead["launches_in_phase"] == {"bsr_matmul": 2}
    assert "stopped" in proc.stdout
    assert "not reached" not in proc.stdout
    assert "phase 'sleepy' passed its deadline" in proc.stderr
    assert "most recent call first" in proc.stderr
    assert "in sleepy_phase" in proc.stderr


def test_phase_blocked_holding_the_lock_ends_by_faulthandler():
    proc, took = _run(HOLDS_LOCK)
    assert proc.returncode != 0
    assert took < 15
    assert {"phase_start": "stuck", "deadline_s": 0.5} in \
        _json_lines(proc.stdout)
    assert "not reached" not in proc.stdout
    assert "Timeout" in proc.stderr
    assert "in stuck_phase" in proc.stderr


def test_phase_within_its_deadline_leaves_no_timer_behind():
    proc, _ = _run(QUICK)
    assert proc.returncode == 0, proc.stderr
    assert "done" in proc.stdout
    assert "phase_deadline" not in proc.stdout


def test_no_phase_runs_past_the_run_deadline(capsys):
    dog = chip_smoke.Watchdog(deadlines={"late": 10_000})
    dog.t0 -= chip_smoke.RUN_DEADLINE_S - 5
    with dog.phase("late"):
        pass
    (start,) = _json_lines(capsys.readouterr().out)
    assert start["phase_start"] == "late"
    assert 0 < start["deadline_s"] <= 5


def test_every_phase_of_main_has_a_deadline():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    main = src[src.index("\ndef main("):]
    names = re.findall(r'phase\(\s*"([^"]+)"', main)
    assert names and len(names) == len(set(names))
    assert set(names) == set(chip_smoke.PHASE_DEADLINE_S)
    assert all(0 < s < chip_smoke.RUN_DEADLINE_S
               for s in chip_smoke.PHASE_DEADLINE_S.values())


def test_launched_counts_every_launch_across_resets():
    """What the watchdog prints: each counter's launches since the run
    began, though the counted runs set the counters to 0."""
    kernels = {}
    for fn, attr, *key in chip_smoke.COUNTERS.values():
        obj = kernels.setdefault(fn, type(fn, (), {})())
        setattr(obj, attr, {} if key else 0)
    mods = {"kernels": kernels}
    kernels["bsr_matmul"].launches = 5
    kernels["bsr_matmul"].by_block[("rows", 128, 128)] = 2
    chip_smoke.reset_counts(mods)
    assert kernels["bsr_matmul"].launches == 0
    kernels["bsr_matmul"].launches = 3
    kernels["flash_attention"].launches = 1
    got = chip_smoke.launched(mods)
    assert got["bsr_matmul"] == 8
    assert got["bsr_matmul_rows_b128"] == 2
    assert got["flash_attention"] == 1
    assert chip_smoke.read_counts(mods)["bsr_matmul"] == 3
