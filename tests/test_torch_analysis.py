"""The port's pre-flight static verifier against the JAX package's.

Every case of ``tests/test_analysis.py``, ported: rule packs, the plan-cache
fixtures, the program rules, the kernel-source lints (CUDA C++ here, the
Pallas ASTs there), the full sweep, the CLI and the engine's strict bind.
On top of them:

* parity: the program rules give the reference's ``(rule, severity,
  layer)`` set on the three nets at 224 px and on the reference's bad
  programs; the plan rules give the reference's ``(rule, key)`` set on
  each fixture and shipped plan, except where an entry's schedule is
  replayed -- the port replays the card's probes, and the test names each
  difference;
* completeness: every reason the engine's fallbacks and the card's
  schedule probes give has a rule in the catalogue;
* agreement: preflight flags a plan entry exactly when the engine's
  dispatch refuses it (``execution_report`` raises ``NoKernelSchedule``)
  or falls back, over AlexNet's full candidate space and one ResNet-50
  layer of each geometry, at 224 px and batch 8, with pinned bad entries.

Everything is static Python over shapes, plan documents and sources: no
kernel runs (the strict binds bind but never execute).
"""
import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import plan_rules as ref_plan_rules  # noqa: E402
from repro.analysis import program_rules as ref_program_rules  # noqa: E402
from repro.engine import program as ref_program  # noqa: E402
from repro_torch.analysis import (REASON_RULES, Diagnostic,  # noqa: E402
                                  PreflightError)
from repro_torch.analysis import (cuda_lints, plan_rules,  # noqa: E402
                                  program_rules)
from repro_torch.analysis.checker import (ALL_RULES,  # noqa: E402
                                          DEFAULT_NETS, default_kernel_paths,
                                          default_plan_path, preflight,
                                          run_check)
from repro_torch.analysis.cli import main as cli_main  # noqa: E402
from repro_torch.engine import (CnnEngine, NoKernelSchedule,  # noqa: E402
                                init_conv_params, lower)
from repro_torch.engine.program import ConvOp, Program, ReluOp  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.bsr_conv.ops import resolve_bsr_schedule  # noqa: E402
from repro_torch.kernels.sparse_conv.ops import resolve_schedule  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.telemetry.fallback import REASONS  # noqa: E402
from repro_torch.tuning import space  # noqa: E402
from repro_torch.tuning.cache import PlanEntry  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "plan_caches")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rules_of(diags, severity=None):
    return {d.rule for d in diags
            if severity is None or d.severity == severity}


# ---------------------------------------------------------------------------
# diagnostics vocabulary
# ---------------------------------------------------------------------------

# every reason the card's schedule probes return
PROBE_REASONS = {"smem_infeasible", "unsupported_tm", "unsupported_tp",
                 "unsupported_tile", "unsupported_block"}


def test_every_fallback_reason_has_a_static_rule():
    """Each runtime fallback reason, and each reason the card's schedule
    probes refuse with, has the static rule that catches it pre-flight."""
    assert set(REASON_RULES) == set(REASONS) | PROBE_REASONS
    for rule in REASON_RULES.values():
        assert rule in ALL_RULES, rule


def test_probe_reasons_are_the_ones_the_probes_give():
    """Completeness from the other side: drive each probe into each of its
    refusals and look the reason up."""
    got = {
        resolve_schedule(64, 32, 14, 14, c=32, r=3, s=3, tm=63)[1],
        resolve_schedule(64, 32, 14, 14, c=32, r=3, s=3, tp=48)[1],
        resolve_bsr_schedule(48, 128, 14, 14, m=96, crs=288)[1],
        resolve_bsr_schedule(8, 64, 14, 14, m=64, crs=288)[1],
        resolve_bsr_schedule(16, 128, 14, 14, m=64, crs=288, n_tile=8)[1],
        resolve_bsr_schedule(8, 128, 14, 14, m=64, crs=128 * 200000)[1],
        resolve_schedule(8, 32, 8, 8000, c=32, r=11, s=11, stride=4)[1],
    }
    assert got == PROBE_REASONS
    assert all(REASON_RULES[r] in ALL_RULES for r in got)


def test_diagnostic_severity_validated():
    with pytest.raises(ValueError):
        Diagnostic(rule="x", severity="fatal", message="m")


def test_rule_catalogue_ids_are_dotted_and_unique():
    for rule, (severity, doc) in ALL_RULES.items():
        pack, _, name = rule.partition(".")
        assert pack in ("sched", "plan", "prog", "lint") and name, rule
        assert severity in ("error", "warning", "info")
        assert doc
    # the card has no VMEM, and its ELL kernel covers a channel count its
    # tile does not divide: those two TPU rules have card counterparts
    assert "sched.vmem_tiling" not in ALL_RULES
    assert "sched.nondividing_tm" not in ALL_RULES


# ---------------------------------------------------------------------------
# plan-cache rules: known-bad fixtures -> exact rule ids
# ---------------------------------------------------------------------------

# (fixture, the port's rule, severity); None: the card runs it as planned.
# Where the reference differs: nondividing_tm.json pins tm = 7, which the
# reference flags as sched.nondividing_tm and the card as a tile the ELL
# kernel lacks; the two vmem_busting files bust the TPU's VMEM at their
# (te, tf) tiles, while the card's ELL kernel picks its own pixel tile and
# stages channel chunks that fit (no error, no demotion).
FIXTURE_RULES = [
    ("stale_v4_bsr.json", "plan.stale_bsr_no_block", "error"),
    ("nondividing_tm.json", "sched.unsupported_tm", "error"),
    ("vmem_busting_tiling.json", None, None),
    ("vmem_busting_pipeline.json", None, None),
    ("bad_key.json", "plan.key_unparsable", "error"),
    ("fp8_on_cpu.json", "sched.value_dtype", "error"),
    ("bad_value_dtype.json", "sched.value_dtype", "error"),
]


@pytest.mark.parametrize("fixture, rule, severity", FIXTURE_RULES)
def test_known_bad_fixture(fixture, rule, severity):
    diags = plan_rules.check_plan_file(os.path.join(FIXTURES, fixture))
    if rule is None:
        assert not rules_of(diags, "error") | rules_of(diags, "warning"), [
            d.format() for d in diags]
    else:
        assert rule in rules_of(diags, severity), [d.format() for d in diags]


def test_pipeline_fixture_demotes_but_does_not_error():
    """The pipelined tiling that busts the TPU's VMEM: the reference demotes
    it to the blocking schedule (a warning); the card fits both stages, so
    it neither errors nor demotes."""
    diags = plan_rules.check_plan_file(
        os.path.join(FIXTURES, "vmem_busting_pipeline.json"))
    assert not rules_of(diags, "error")
    assert "sched.pipeline_demoted" not in rules_of(diags)


def test_plan_rules_demote_a_pipelined_1x1(tmp_path):
    """A 1x1 conv stages nothing, so a pipelined entry runs blocking."""
    key = "m64_c256_h14w14_r1s1_st1_p0_n8_ep10_sp0.7_float32_cuda"
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"version": 6, "entries": {
        key: {"method": "pallas", "tm": 8, "pipeline": True}}}))
    diags = plan_rules.check_plan_file(str(p))
    assert rules_of(diags) == {"sched.pipeline_demoted"}
    assert rules_of(diags, "warning") == {"sched.pipeline_demoted"}


@pytest.mark.parametrize("entry, rule", [
    ({"method": "bsr", "block_m": 48, "block_n": 128},
     "sched.unsupported_block"),
    ({"method": "bsr", "block_m": 8, "block_n": 64},
     "sched.unsupported_block"),
    ({"method": "pallas", "tm": 63}, "sched.unsupported_tm"),
])
def test_plan_rules_replay_the_cards_probes(tmp_path, entry, rule):
    key = "m64_c32_h14w14_r3s3_st1_p1_n8_ep10_sp0.7_float32_cuda"
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"version": 6, "entries": {key: entry}}))
    assert rules_of(plan_rules.check_plan_file(str(p)), "error") == {rule}


def test_plan_rules_dtype_policy(tmp_path):
    """The card's conv kernels take f32 and bf16 activations: pallas and
    bsr entries keyed at bf16 replay at bf16 and give the reference's
    findings (none here); one keyed at f16 is an error on the card only
    (the reference admits f16; the port's kernels do not take it, a
    deliberate difference)."""
    key = "m64_c32_h14w14_r3s3_st1_p1_n8_ep10_sp0.7_bfloat16_cuda"
    k16 = key.replace("bfloat16", "float16")
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"version": 6, "entries": {
        key: {"method": "pallas", "tm": 8},
        key + "_bk0.3": {"method": "bsr", "block_m": 8, "block_n": 128},
        key + "_bk0.4": {"method": "dense"},
        k16: {"method": "pallas", "tm": 8}}}))
    diags = plan_rules.check_plan_file(str(p))
    found = {(d.rule, d.location) for d in diags if d.severity == "error"}
    ref = {(d.rule, d.location)
           for d in ref_plan_rules.check_plan_file(str(p))
           if d.severity == "error"}
    assert {x for x in found if x[1] != k16} == ref == set()
    assert found == {("sched.dtype_policy", k16)}


def test_plan_rules_replay_bf16_keys_at_half_the_bytes(tmp_path):
    """A bf16 key's ELL entry replays the schedule ``ops.sparse_conv``
    takes on bf16 inputs: a 3-row slab of a 20,000-wide row busts shared
    memory at f32 and fits at bf16."""
    key = "m8_c32_h10w20000_r3s3_st1_p0_n1_ep10_sp0.7_{}_cuda"
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"version": 6, "entries": {
        key.format(dt): {"method": "pallas", "tm": 8}
        for dt in ("float32", "bfloat16")}}))
    diags = plan_rules.check_plan_file(str(p))
    assert {(d.rule, d.location) for d in diags if d.severity == "error"} == {
        ("sched.smem_budget", key.format("float32"))}


def test_plan_rules_unreadable_and_schema(tmp_path):
    p = tmp_path / "corrupt.json"
    p.write_text("{not json")
    assert rules_of(plan_rules.check_plan_file(str(p))) == {"plan.unreadable"}
    p2 = tmp_path / "future.json"
    p2.write_text('{"version": 999, "entries": {}}')
    assert rules_of(plan_rules.check_plan_file(str(p2))) == {
        "plan.schema_version"}
    assert rules_of(plan_rules.check_plan_file(str(tmp_path / "absent.json")),
                    ) == {"plan.unreadable"}


def test_plan_rules_unknown_method_and_structure_tag(tmp_path):
    key = "m64_c32_h14w14_r3s3_st1_p1_n1_ep10_sp0.7_float32_cpu"
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"version": 5, "entries": {
        key: {"method": "winograd"},
        key + "_bk9.5": {"method": "dense"},
    }}))
    rules = rules_of(plan_rules.check_plan_file(str(p)), "error")
    assert "plan.unknown_method" in rules
    assert "plan.structure_tag" in rules


def test_plan_rules_geometry_mismatch(tmp_path):
    # Parses fine but 5x5 kernel cannot fit a 3x3 unpadded input.
    key = "m64_c32_h3w3_r5s5_st1_p0_n1_ep10_sp0.7_float32_cpu"
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"version": 5, "entries": {
        key: {"method": "dense"}}}))
    assert rules_of(plan_rules.check_plan_file(str(p)), "error") == {
        "plan.geometry_mismatch"}


def test_shipped_default_plans_are_clean():
    for net in DEFAULT_NETS:
        path = default_plan_path(net)
        assert path is not None, f"no shipped plan for {net}"
        diags = plan_rules.check_plan_file(path)
        assert not rules_of(diags, "error"), [d.format() for d in diags]


# the rules an entry's schedule replay gives, where the two packages replay
# different hardware's probes
SCHEDULE_REPLAY = {"sched.nondividing_tm", "sched.vmem_tiling",
                   "sched.pipeline_demoted", "sched.smem_budget",
                   "sched.unsupported_tm", "sched.unsupported_tile",
                   "sched.unsupported_block", "sched.halo_bounds",
                   "sched.dtype_policy"}
# ... and each fixture's expected difference, by name: (reference, port)
REPLAY_DIFFERENCES = {
    "nondividing_tm.json": ({"sched.nondividing_tm"},
                            {"sched.unsupported_tm"}),
    "vmem_busting_tiling.json": ({"sched.vmem_tiling"}, set()),
    "vmem_busting_pipeline.json": ({"sched.pipeline_demoted"}, set()),
}


@pytest.mark.parametrize("path", sorted(
    [os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)]
    + [default_plan_path(n) for n in DEFAULT_NETS]),
    ids=os.path.basename)
def test_plan_rules_match_the_reference(path):
    port = {(d.rule, d.severity, d.location)
            for d in plan_rules.check_plan_file(path)}
    ref = {(d.rule, d.severity, d.location)
           for d in ref_plan_rules.check_plan_file(path)}
    assert ({x for x in port if x[0] not in SCHEDULE_REPLAY}
            == {x for x in ref if x[0] not in SCHEDULE_REPLAY})
    want_ref, want_port = REPLAY_DIFFERENCES.get(
        os.path.basename(path), (set(), set()))
    assert {x[0] for x in ref if x[0] in SCHEDULE_REPLAY} == want_ref
    assert {x[0] for x in port if x[0] in SCHEDULE_REPLAY} == want_port
    # the replayed findings anchor at the same keys
    assert ({x[2] for x in port if x[0] in SCHEDULE_REPLAY}
            <= {x[2] for x in ref if x[0] in SCHEDULE_REPLAY})


# ---------------------------------------------------------------------------
# program rules
# ---------------------------------------------------------------------------

def _conv(name, src, out, c, h, w, m, k, stride, pad, e, f, mod=None, **kw):
    cls = mod.ConvOp if mod is not None else ConvOp
    return cls(name=name, src=src, out=out, c=c, h=h, w=w, m=m, k=k,
               stride=stride, pad=pad, sparsity=0.7, e=e, f=f, **kw)


def _bad_programs(mod=None):
    """The reference test file's bad programs, in either package's op
    classes (``mod`` the reference's ``engine.program``)."""
    P = mod.Program if mod is not None else Program
    R = mod.ReluOp if mod is not None else ReluOp
    c = lambda *a, **kw: _conv(*a, mod=mod, **kw)  # noqa: E731
    return {
        "geometry_chain": P(ops=(c("c1", 0, 1, c=3, h=8, w=8, m=4, k=3,
                                   stride=1, pad=1, e=9, f=9),),
                            out=1, in_shape=(3, 8, 8), conv_table=()),
        "input_mismatch": P(ops=(c("c1", 0, 1, c=16, h=8, w=8, m=4, k=3,
                                   stride=1, pad=1, e=8, f=8),),
                            out=1, in_shape=(3, 8, 8), conv_table=()),
        "ssa_and_out": P(ops=(
            c("c1", 0, 1, c=3, h=8, w=8, m=4, k=3, stride=1, pad=1, e=8, f=8),
            c("c2", 5, 2, c=4, h=8, w=8, m=4, k=3, stride=1, pad=1, e=8,
              f=8)), out=9, in_shape=(3, 8, 8), conv_table=()),
        "epilogue_signature": P(ops=(
            c("proj", 0, 1, c=3, h=8, w=8, m=8, k=1, stride=1, pad=0, e=8,
              f=8),
            c("tail", 0, 2, c=3, h=8, w=8, m=4, k=3, stride=1, pad=1, e=8,
              f=8, res=1)), out=2, in_shape=(3, 8, 8), conv_table=()),
        "unfused_relu_and_dead_value": P(ops=(
            c("c1", 0, 1, c=3, h=8, w=8, m=4, k=3, stride=1, pad=1, e=8, f=8),
            R(src=1, out=2),
            c("c2", 0, 3, c=3, h=8, w=8, m=4, k=3, stride=1, pad=1, e=8,
              f=8)), out=2, in_shape=(3, 8, 8), conv_table=()),
    }


def test_program_rules_clean_on_real_nets():
    for net in DEFAULT_NETS:
        program = lower(cnn.NETWORKS[net](), (3, 224, 224))
        diags = program_rules.check_program(program, net=net)
        assert not diags, [d.format() for d in diags]


def test_program_rules_geometry_chain():
    prog = _bad_programs()["geometry_chain"]
    assert "prog.geometry_chain" in rules_of(
        program_rules.check_program(prog), "error")


def test_program_rules_input_mismatch():
    prog = _bad_programs()["input_mismatch"]
    assert "prog.geometry_chain" in rules_of(
        program_rules.check_program(prog), "error")


def test_program_rules_ssa_and_out():
    rules = rules_of(program_rules.check_program(
        _bad_programs()["ssa_and_out"]), "error")
    assert "prog.ssa_form" in rules
    assert "prog.out_undefined" in rules


def test_program_rules_epilogue_signature():
    assert "prog.epilogue_signature" in rules_of(
        program_rules.check_program(_bad_programs()["epilogue_signature"]),
        "error")


def test_program_rules_unfused_relu_and_dead_value():
    rules = rules_of(program_rules.check_program(
        _bad_programs()["unfused_relu_and_dead_value"]), "warning")
    assert "prog.unfused_relu" in rules
    assert "prog.dead_value" in rules


def _triples(diags):
    return {(d.rule, d.severity, d.layer) for d in diags}


@pytest.mark.parametrize("name", sorted(_bad_programs()))
def test_program_rules_match_the_reference_on_bad_programs(name):
    port = program_rules.check_program(_bad_programs()[name])
    ref = ref_program_rules.check_program(_bad_programs(ref_program)[name])
    assert _triples(port) == _triples(ref) and port


def test_program_rules_match_the_reference_on_the_nets():
    from repro.engine import lower as ref_lower
    from repro.models import cnn as ref_cnn

    for net in DEFAULT_NETS:
        port = program_rules.check_program(
            lower(cnn.NETWORKS[net](), (3, 224, 224)), net=net)
        ref = ref_program_rules.check_program(
            ref_lower(ref_cnn.NETWORKS[net](), (3, 224, 224)), net=net)
        assert _triples(port) == _triples(ref)


# ---------------------------------------------------------------------------
# CUDA source lints: each rule on a known-bad snippet and its good twin
# ---------------------------------------------------------------------------

def _lint(tmp_path, source):
    p = tmp_path / "kern.cu"
    p.write_text(textwrap.dedent(source))
    return cuda_lints.check_source(str(p))


def test_lint_traced_branch(tmp_path):
    diags = _lint(tmp_path, """
        __global__ void k(float* y) {
          const int tid = threadIdx.x;
          const int warp = tid / 32;
          if (warp == 0) {
            y[tid] = 1.f;
            __syncthreads();
          }
        }
    """)
    assert rules_of(diags) == {"lint.traced_branch"}


def test_lint_traced_branch_through_a_helper_in_a_loop(tmp_path):
    """A loop whose bound reads the thread id, calling a helper that
    synchronises the block; and the else branch of a lane test."""
    diags = _lint(tmp_path, """
        __device__ void block_sync() { __syncthreads(); }
        __global__ void k(float* y, int n) {
          for (int i = threadIdx.x; i < n; i += blockDim.x) {
            y[i] = 0.f;
            block_sync();
          }
          int lane = threadIdx.x & 31;
          if (lane) y[0] = 1.f; else { __syncthreads(); }
        }
    """)
    assert rules_of(diags) == {"lint.traced_branch"} and len(diags) == 2


def test_lint_static_branch_ok(tmp_path):
    """Block-uniform loops and branches may hold the barrier, a named
    barrier may sit under a warp test, and a lane test without a barrier
    is fine."""
    diags = _lint(tmp_path, """
        __device__ void consumers_sync() {
          asm volatile("bar.sync 1, 128;\\n" ::: "memory");
        }
        __global__ void k(float* y, int n, bool pipeline) {
          const int tid = threadIdx.x;
          for (int kb = blockIdx.x; kb < n; ++kb) {
            y[kb] = tid;
            __syncthreads();
          }
          if (pipeline) { __syncthreads(); }
          if (tid < 128) consumers_sync();
          if (tid == 0) y[0] = 1.f;
          __syncthreads();
        }
    """)
    assert not diags


def test_lint_grid_alloc(tmp_path):
    diags = _lint(tmp_path, """
        __global__ void k(float* y) {
          float* p = (float*)malloc(16 * sizeof(float));
          y[0] = p[0];
        }
    """)
    assert rules_of(diags) == {"lint.grid_alloc"}


def test_lint_grid_alloc_outside_kernels_ok(tmp_path):
    """Allocation in host code, and in a helper no kernel calls, is not a
    kernel body's."""
    diags = _lint(tmp_path, """
        void host_side() { float* p = new float[4]; delete[] p; }
        __device__ float* unused() { return (float*)malloc(4); }
        __global__ void k(float* y) { y[0] = 1.f; }
    """)
    assert not diags


def test_lint_accum_dtype(tmp_path):
    diags = _lint(tmp_path, """
        __device__ void mma(unsigned a) {
          asm volatile("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 "
                       "{%0}, {%0};\\n" :: "r"(a));
        }
        __device__ void wg(unsigned a) {
          asm volatile("wgmma.mma_async.sync.aligned.m64n32k16.f16.bf16.bf16 "
                       "{%0};\\n" :: "r"(a));
        }
        __global__ void k(float* y) { mma(0); wg(1); }
    """)
    assert rules_of(diags) == {"lint.accum_dtype"} and len(diags) == 2


def test_lint_accum_dtype_f32_ok(tmp_path):
    diags = _lint(tmp_path, """
        __device__ void mma(unsigned a) {
          asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                       "{%0}, {%0};\\n" :: "r"(a));
        }
        __device__ void wg(unsigned a) {
          asm volatile("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                       "{%0};\\n" :: "r"(a));
        }
        __global__ void k(float* y) { mma(0); wg(1); }
    """)
    assert not diags


def test_lint_dma_pairing(tmp_path):
    diags = _lint(tmp_path, """
        __device__ void cp16(unsigned d, const void* s) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"
                       :: "r"(d), "l"(s));
        }
        __device__ void commit() {
          asm volatile("cp.async.commit_group;\\n" ::: "memory");
        }
        __device__ void expect(unsigned b) {
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                       "16;\\n" :: "r"(b));
        }
        __global__ void copies(float* y) { cp16(0, y); commit(); }
        __global__ void bulk(float* y) { expect(0); }
    """)
    assert rules_of(diags) == {"lint.dma_pairing"}
    assert {d.layer for d in diags} == {"copies", "bulk"}


def test_lint_dma_paired_ok(tmp_path):
    diags = _lint(tmp_path, """
        __device__ void cp16(unsigned d, const void* s) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"
                       :: "r"(d), "l"(s));
        }
        __device__ void commit() {
          asm volatile("cp.async.commit_group;\\n" ::: "memory");
        }
        template <int N> __device__ void wait() {
          asm volatile("cp.async.wait_group %0;\\n" :: "n"(N) : "memory");
        }
        __device__ void expect(unsigned b) {
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                       "16;\\n" :: "r"(b));
        }
        __device__ bool try_wait(unsigned b) {
          unsigned p;
          asm volatile("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                       "0;\\n" : "=r"(p) : "r"(b));
          return p;
        }
        __global__ void copies(float* y) { cp16(0, y); commit(); wait<0>(); }
        __global__ void bulk(float* y) { expect(0); while (!try_wait(0)) {} }
    """)
    assert not diags


def test_lint_wait_with_no_copy(tmp_path):
    diags = _lint(tmp_path, """
        __device__ bool try_wait(unsigned b) {
          unsigned p;
          asm volatile("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                       "0;\\n" : "=r"(p) : "r"(b));
          return p;
        }
        __global__ void k(float* y) { while (!try_wait(0)) {} }
    """)
    assert rules_of(diags) == {"lint.dma_pairing"}


def test_lint_skips_non_kernel_functions(tmp_path):
    diags = _lint(tmp_path, """
        // __global__ void k(float* y) { if (threadIdx.x) __syncthreads(); }
        static const char* doc = "__syncthreads() under if (threadIdx.x)";
        void wrapper(float* x) {
          if (x[0] > 0) { float* p = (float*)malloc(4); }
        }
        __device__ void helper() { if (threadIdx.x) __syncthreads(); }
    """)
    assert not diags


def test_repo_kernel_sources_pass_lints():
    """The shipped CUDA kernels satisfy their own hygiene rules, and the
    lints see every kernel of them."""
    paths = default_kernel_paths()
    assert [os.path.basename(p) for p in paths] == [
        "bsr_conv.cu", "bsr_matmul.cu", "flash_attention.cu",
        "sparse_conv.cu"]
    diags = cuda_lints.check_paths(paths)
    assert not diags, [d.format() for d in diags]
    kernels = {k for p in paths for k in cuda_lints.kernels_of(p)}
    assert {"sparse_conv_kernel", "sparse_conv_1x1_kernel",
            "bsr_conv_tc_kernel", "bsr_matmul_rows", "bsr_matmul_wgmma",
            "flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
            "flash_bwd_dkv_tc_kernel"} <= kernels


@pytest.mark.parametrize("source, kernel", [
    ("sparse_conv.cu", "sparse_conv_kernel"),
    ("bsr_matmul.cu", "bsr_matmul_rows")])
def test_lint_catches_a_barrier_planted_in_a_repo_kernel(tmp_path, source,
                                                          kernel):
    """A copy of a real kernel with a lane-dependent ``__syncthreads()``
    planted at the top of its body must fail: the lint parses the real
    sources, not just snippets."""
    path = next(p for p in default_kernel_paths() if p.endswith(source))
    text = open(path).read()
    at = text.index("{", text.index(f" {kernel}("))
    bad = (text[:at + 1] + "\n  if ((threadIdx.x & 31) == 0) __syncthreads();"
           + text[at + 1:])
    p = tmp_path / source
    p.write_text(bad)
    diags = cuda_lints.check_source(str(p))
    assert [(d.rule, d.layer) for d in diags] == [("lint.traced_branch",
                                                   kernel)]


# ---------------------------------------------------------------------------
# full sweep + CLI
# ---------------------------------------------------------------------------

def test_run_check_all_nets_and_shipped_plans_zero_errors():
    """The acceptance gate: every net, its shipped default plan, and the
    kernel sources verify clean."""
    report = run_check()
    assert report.ok, [d.format() for d in report.errors]
    assert not report.warnings, [d.format() for d in report.warnings]
    assert any(c.startswith("net:") for c in report.checked)
    assert any(c.startswith("plan:") for c in report.checked)
    assert any(c.startswith("lint:") for c in report.checked)


def test_run_check_on_the_card_backend_resolves_no_shipped_entry():
    """The shipped plans are keyed for ``cpu``: under backend ``cuda`` they
    are audited as files and bind no entry, so every sparse layer gets the
    coverage probes and none is flagged."""
    report = run_check(nets=["alexnet"], backend="cuda", batch=8,
                       lints=False)
    assert report.ok and not report.warnings
    assert "plan:alexnet.json" in report.checked


def test_run_check_flags_bad_cache():
    report = run_check(
        nets=["alexnet"],
        plan_caches=[os.path.join(FIXTURES, "stale_v4_bsr.json")],
    )
    assert not report.ok
    assert "plan.stale_bsr_no_block" in rules_of(report.errors)


def test_cli_json_and_exit_codes(tmp_path, capsys):
    rc = cli_main(["check", "--net", "alexnet", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"] is True
    assert doc["counts"]["error"] == 0
    assert "lint:4 kernel file(s)" in doc["checked"]
    rc = cli_main([
        "check", "--net", "alexnet", "--no-lints",
        "--plan-cache", os.path.join(FIXTURES, "nondividing_tm.json"),
    ])
    capsys.readouterr()
    assert rc == 1
    rc = cli_main(["check", "--net", "resnet50", "--no-lints", "--json",
                   "--backend", "cuda", "--batch", "8"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"] is True


def test_cli_rules_catalogue(capsys):
    assert cli_main(["rules"]) == 0
    out = capsys.readouterr().out
    for rule in ALL_RULES:
        assert rule in out


# ---------------------------------------------------------------------------
# agreement: preflight against the engine's dispatch
# ---------------------------------------------------------------------------

BATCH = 8


@pytest.fixture(scope="module")
def bound_nets():
    out = {}
    for i, name in enumerate(("alexnet", "resnet50")):
        program = lower(cnn.NETWORKS[name](), (3, 224, 224))
        params = init_conv_params(program, np.random.default_rng(i),
                                  device="cpu")
        out[name] = (program, params, CnnEngine(program, params,
                                                device="cpu"))
    return out


def _engine_accepts(engine, op, entry):
    """The engine's verdict on one entry: its dispatch resolves the entry
    with no refusal and no fallback."""
    try:
        report = engine.execution_report((BATCH, 3, 224, 224), "auto",
                                         plan_override={op.name: entry})
    except NoKernelSchedule as exc:
        assert [name for name, _ in exc.refused] == [op.name]
        return False
    return report.fallback_count == 0


def _pinned_bad(op):
    """Entries the card cannot run: tm = m - 1 (the chaos harness's
    corruption), tm = 63, a (48, 128) block."""
    return [PlanEntry(method="pallas", tm=op.m - 1),
            PlanEntry(method="pallas", tm=63, pipeline=True),
            PlanEntry(method="bsr", block_m=48, block_n=128)]


def _sweep(program, engine, ops):
    cases = 0
    for op in ops:
        g = space.ConvGeometry(
            name=op.name, m=op.m, c=op.c, h=op.h, w=op.w, r=op.k, s=op.k,
            stride=op.stride, pad=op.pad, sparsity=op.sparsity, batch=BATCH,
            relu=op.fuse_relu, residual=op.res is not None)
        entries = [PlanEntry(**{k: v for k, v in c.to_dict().items()})
                   for c in space.enumerate_candidates(
                       g, value_dtypes=space.allowed_value_dtypes("cpu"))]
        entries += _pinned_bad(op)
        for entry in entries:
            errors = [d for d in preflight(program, {op.name: entry},
                                           engine.params, batch=BATCH,
                                           backend="cpu")
                      if d.severity == "error"]
            assert (not errors) == _engine_accepts(engine, op, entry), (
                op.name, entry, [d.format() for d in errors])
            cases += 1
        for entry in _pinned_bad(op):
            assert not _engine_accepts(engine, op, entry)
    return cases


def test_preflight_agrees_with_the_engine_on_alexnet(bound_nets):
    """Every candidate of the tuning space (f32 and int8, every method,
    tile, block, fuse, pipeline and permute) and the pinned bad entries,
    on each sparse conv of AlexNet at 224 px and batch 8: preflight finds
    an error exactly where the engine refuses or falls back."""
    program, _, engine = bound_nets["alexnet"]
    ops = [op for op in program.conv_ops if op.sparsity > 0]
    assert _sweep(program, engine, ops) > 200


def test_preflight_agrees_with_the_engine_on_resnet50(bound_nets):
    """The same over one ResNet-50 conv of each sparse geometry."""
    program, _, engine = bound_nets["resnet50"]
    seen, ops = set(), []
    for op in program.conv_ops:
        key = (op.c, op.h, op.m, op.k, op.stride, op.res is not None)
        if op.sparsity > 0 and key not in seen:
            seen.add(key)
            ops.append(op)
    assert len(ops) >= 10
    assert _sweep(program, engine, ops) > 400


def test_policy_entries_are_flagged_and_refused_by_a_strict_bind(bound_nets):
    """A pinned entry can be policy, not schedule: an fp8 value stream on a
    ``cpu`` bind.  The non-strict CPU engine runs fp8 through the plain
    versions (which decode e4m3 bit for bit, held to the reference by
    ``test_torch_engine_auto.py``; the reference's own non-strict engine
    runs it too), so preflight flags it and a strict bind refuses it.
    bf16 activations are not policy any more: the card's conv kernels take
    them, and preflight at bf16 gives the reference's findings on the
    same layer (the reference's per-entry checks on its own ConvOp)."""
    program, params, engine = bound_nets["alexnet"]
    op = next(op for op in program.conv_ops if op.sparsity > 0)
    fp8 = {op.name: PlanEntry(method="pallas", tm=8,
                              value_dtype="float8_e4m3fn")}
    assert rules_of(preflight(program, fp8, params, batch=BATCH,
                              backend="cpu"), "error") == {"sched.value_dtype"}
    assert not rules_of(preflight(program, fp8, params, batch=BATCH,
                                  backend="cuda"), "error")
    with pytest.raises(PreflightError) as exc:
        CnnEngine(program, params, fp8, strict=True, device="cpu")
    assert {d.rule for d in exc.value.diagnostics} == {"sched.value_dtype"}
    from repro.analysis import schedule_rules as ref_schedule_rules
    from repro.tuning.cache import PlanEntry as RefPlanEntry
    ref_op = ref_program.ConvOp(**{f.name: getattr(op, f.name)
                                   for f in dataclasses.fields(op)})
    for method, kw in (("pallas", dict(tm=8)),
                       ("bsr", dict(block_m=8, block_n=128))):
        bf16 = preflight(program, {op.name: PlanEntry(method=method, **kw)},
                         params, batch=BATCH, dtype="bfloat16",
                         backend="cuda")
        check = getattr(ref_schedule_rules, f"check_{method}_entry")
        ref = check(ref_op, RefPlanEntry(method=method, **kw), batch=BATCH,
                    dtype="bfloat16", backend="cuda")
        assert rules_of(bf16, "error") == rules_of(ref, "error") == set()
    assert _engine_accepts(engine, op, fp8[op.name])


# ---------------------------------------------------------------------------
# engine strict mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def alexnet_bound():
    program = lower(cnn.NETWORKS["alexnet"](), (3, 224, 224))
    params = init_conv_params(program, np.random.default_rng(0),
                              device="cpu")
    return program, params


def test_strict_bind_clean(alexnet_bound):
    program, params = alexnet_bound
    CnnEngine(program, params, strict=True, device="cpu")  # does not raise
    sparse = [op.name for op in program.conv_ops if op.sparsity > 0]
    plan = {n: PlanEntry(method=("bsr", "pallas")[i % 2], tm=8, block_m=16,
                         block_n=128, fuse=True)
            for i, n in enumerate(sparse)}
    CnnEngine(program, params, plan, strict=True, device="cpu")


def test_strict_bind_rejects_poisoned_plan(alexnet_bound):
    program, params = alexnet_bound
    name = next(op.name for op in program.conv_ops if op.sparsity > 0)
    plan = {name: PlanEntry(method="pallas", tm=7, pad_to=8, te=8, tf=8)}
    with pytest.raises(PreflightError) as exc:
        CnnEngine(program, params, plan, strict=True, device="cpu")
    assert {d.rule for d in exc.value.diagnostics} == {
        "sched.unsupported_tm"}
    # Non-strict bind keeps the permissive behaviour; its dispatch refuses.
    eng = CnnEngine(program, params, plan, device="cpu")
    with pytest.raises(NoKernelSchedule, match=f"{name}.*unsupported_tm"):
        eng.execution_report((1, 3, 224, 224), "auto")


def test_strict_bind_rejects_stale_bsr_plan(alexnet_bound):
    program, params = alexnet_bound
    name = next(op.name for op in program.conv_ops if op.sparsity > 0)
    plan = {name: PlanEntry(method="bsr")}
    with pytest.raises(PreflightError) as exc:
        CnnEngine(program, params, plan, strict=True, device="cpu")
    assert {d.rule for d in exc.value.diagnostics} == {
        "plan.stale_bsr_no_block"}


def test_strict_bind_verifies_against_the_engines_device(alexnet_bound):
    """The bind's backend is the engine's device type: an fp8 entry passes
    the ``cuda`` policy and fails the ``cpu`` one."""
    program, params = alexnet_bound
    name = next(op.name for op in program.conv_ops if op.sparsity > 0)
    plan = {name: PlanEntry(method="bsr", block_m=8, block_n=128,
                            value_dtype="float8_e4m3fn")}
    assert not rules_of(preflight(program, plan, params, backend="cuda"),
                        "error")
    with pytest.raises(PreflightError):
        CnnEngine(program, params, plan, strict=True, device="cpu")


def test_no_layer_of_the_nets_takes_tm_m_minus_1():
    """The chaos harness pins tm = m - 1; on the card that is never one of
    the ELL kernel's tiles, on any conv of the three nets."""
    tiles = {t for t, _ in budget.ELL_TILES}
    for net in DEFAULT_NETS:
        program = lower(cnn.NETWORKS[net](), (3, 224, 224))
        assert not {op.m - 1 for op in program.conv_ops
                    if op.sparsity > 0 and op.m > 2} & tiles


def test_strict_preflight_is_dataclass_safe(alexnet_bound):
    """Entries are frozen dataclasses: preflight reads and never mutates
    them."""
    program, params = alexnet_bound
    name = next(op.name for op in program.conv_ops if op.sparsity > 0)
    entry = PlanEntry(method="pallas", tm=8, pipeline=True)
    before = dataclasses.asdict(entry)
    preflight(program, {name: entry}, params, backend="cpu")
    assert dataclasses.asdict(entry) == before
