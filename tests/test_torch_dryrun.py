"""The port's dry run (``launch/dryrun.py``, ``costs.py``, ``roofline.py``,
``enrich.py``, the registry of ``configs``) against the reference's, and
against the port's own meshed step.

Held exactly to the reference: the shape registry (``SHAPE_BY_NAME``,
``applicable_shapes``, ``skipped_shapes``, ``all_cells``, the reference's
``test_roofline_specs.py`` checks), ``model_flops_global`` and the
analytic flash FLOPs on all 31 cells, the ``Roofline`` properties with the
reference's constants put in, and the JSON's keys.

Held to the port's own run: on fake (2, 2) and (2, 2, 2) worlds (one
process, ``meta`` tensors) the counted FLOPs and collective bytes by kind
equal those of the same meshed step run for real over gloo at the same
shape (``tests/_torch_mesh.py``): train, prefill, and decode on a cache
split by sequence, by KV heads, and under ``--sparse-weights`` (the BCSR
kernel one registered op with a flop formula, counted alike on ``meta``
and on real banks); the 1- and
2-block probes extrapolate to the full-depth count, a decode cell's alias
is its cache's bytes, and no process group outlives a call.
"""
import ast
import dataclasses
import json
import os
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.devices()   # the backend is up before the reference's dryrun sets XLA_FLAGS
_flags_before = os.environ.get("XLA_FLAGS")
from repro import configs as ref_cfgs  # noqa: E402
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402

if _flags_before is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags_before

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _torch_mesh import rank_dryrun_counts, spawn_world  # noqa: E402
from repro_torch import configs as cfgs  # noqa: E402
from repro_torch.launch import costs, dryrun, enrich  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ALL = list(ref_cfgs.all_cells())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _names(cells):
    return [(a, s.name) for a, s in cells]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in cfgs.SHAPE_BY_NAME.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in ref_cfgs.SHAPE_BY_NAME.items()}
    assert cfgs.list_archs() == ref_cfgs.list_archs()
    for arch in cfgs.list_archs():
        assert ([s.name for s in cfgs.applicable_shapes(arch)]
                == [s.name for s in ref_cfgs.applicable_shapes(arch)])
        assert cfgs.skipped_shapes(arch) == ref_cfgs.skipped_shapes(arch)
    for skipped in (False, True):
        assert (_names(cfgs.all_cells(include_skipped=skipped))
                == _names(ref_cfgs.all_cells(include_skipped=skipped)))


def test_skip_table_matches_design():
    """The reference's ``test_skip_table_matches_design``, on the port."""
    skips = {arch: {n for n, _ in cfgs.skipped_shapes(arch)}
             for arch in cfgs.list_archs()}
    assert skips["jamba-1.5-large-398b"] == set()
    assert skips["mamba2-2.7b"] == set()
    assert skips["hubert-xlarge"] == {"decode_32k", "long_500k"}
    for dense_arch in ("yi-9b", "qwen1.5-0.5b", "mistral-large-123b",
                       "deepseek-v3-671b", "phi-3-vision-4.2b"):
        assert skips[dense_arch] == {"long_500k"}
    kinds = [s.kind for _, s in cfgs.all_cells()]
    assert len(kinds) == 31
    assert (kinds.count("train"), kinds.count("prefill"),
            kinds.count("decode")) == (10, 10, 11)


@pytest.mark.parametrize("arch, shape", _names(ALL))
def test_model_and_flash_flops_match_reference(arch, shape):
    """``model_flops_global`` and the analytic flash FLOPs, exactly, on
    every cell (the configs are the reference's copies)."""
    cfg, ref_cfg = cfgs.get_config(arch), ref_cfgs.get_config(arch)
    s, ref_s = cfgs.SHAPE_BY_NAME[shape], ref_cfgs.SHAPE_BY_NAME[shape]
    assert rl.model_flops_global(cfg, s) == ref_rl.model_flops_global(
        ref_cfg, ref_s)
    for n_dev in (256, 512):
        assert (dryrun._flash_analytic_flops(cfg, s, n_dev)
                == ref_dryrun._flash_analytic_flops(ref_cfg, ref_s, n_dev))


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def test_roofline_properties_match_reference_under_equal_constants(
        monkeypatch):
    """With the reference's rates put into the port's module (one link rate
    for both kinds of group), every property equals the reference's."""
    monkeypatch.setattr(rl, "BF16_FLOPS", ref_rl.PEAK_FLOPS)
    monkeypatch.setattr(rl, "HBM_BW", ref_rl.HBM_BW)
    monkeypatch.setattr(rl, "NVLINK_BW", ref_rl.LINK_BW)
    monkeypatch.setattr(rl, "FABRIC_BW", ref_rl.LINK_BW)
    for flops, hbm, coll, model, cross in (
            (197e12, 819e9 * 2, 50e9 * 0.5, 98.5e12, 0.0),
            (3e15, 1e12, 4e11, 1e15, 1e11), (1e12, 5e13, 0.0, 3e11, 0.0),
            (0.0, 0.0, 0.0, 0.0, 0.0)):
        kw = dict(arch="a", shape="s", mesh="m", flops=flops, hbm_bytes=hbm,
                  coll_bytes=coll, coll_breakdown={"all-gather": 1},
                  model_flops=model, peak_mem_bytes=7.0)
        got = rl.Roofline(coll_cross_bytes=cross, **kw).to_dict()
        want = ref_rl.Roofline(**kw).to_dict()
        assert got.pop("coll_cross_bytes") == cross
        assert got.pop("coll_breakdown") == want.pop("coll_breakdown")
        assert got == pytest.approx(want, rel=1e-12)


def test_roofline_prices_groups_by_node():
    """Groups inside a node move at NVLink's rate, groups across nodes at
    the fabric's; compute at the bf16 tensor-core peak."""
    r = rl.Roofline(arch="a", shape="s", mesh="m", flops=989e12,
                    hbm_bytes=3.35e12, coll_bytes=450e9 + 50e9,
                    coll_breakdown={}, model_flops=0.0,
                    coll_cross_bytes=50e9)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(2.0)
    assert r.bottleneck == "collective"


def _reference_json_keys():
    """The keys the reference's ``lower_cell`` writes: ``to_dict``'s and
    those of its ``out.update({...})``."""
    tree = ast.parse(Path(ref_dryrun.__file__).read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "update" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
    r = ref_rl.Roofline(arch="a", shape="s", mesh="m", flops=1.0,
                        hbm_bytes=1.0, coll_bytes=1.0, coll_breakdown={},
                        model_flops=1.0)
    return keys | set(r.to_dict())


def test_lower_cell_writes_the_references_json(tmp_path, monkeypatch):
    """Yi-9B cut to 2 layers at train_4k on the 16 x 16 mesh with the
    flash kernels (meta outputs) and probes: the reference's keys and the
    port's ``coll_cross_bytes``; every collective on these groups spans
    nodes; the group is gone afterwards."""
    cfg = dataclasses.replace(cfgs.get_config("yi-9b"), n_layers=2)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(dryrun.cfgs, "get_config", lambda arch: cfg)
    r = dryrun.lower_cell("yi-9b", "train_4k", multi_pod=False,
                          attn_impl="flash", tag="t", verbose=False)
    assert not dist.is_initialized()
    out = json.loads((tmp_path / "yi-9b__train_4k__16x16__t.json")
                     .read_text())
    assert set(out) == _reference_json_keys() | {"coll_cross_bytes"}
    assert out["compile_s"] == 0.0 and out["lower_s"] > 0
    assert out["flash_extra_flops"] == dryrun._flash_analytic_flops(
        cfg, cfgs.SHAPE_BY_NAME["train_4k"], 256) > 0
    assert out["flops"] == out["raw_scan_flops"] + out["flash_extra_flops"]
    assert out["probe_info"]["nblocks"] == 2
    assert out["coll_cross_bytes"] == out["coll_bytes"] > 0
    assert out["mem_alias_bytes"] > 0 and out["mem_temp_bytes"] > 0
    assert out["moe_constrain"] is None
    assert r.t_collective == pytest.approx(out["coll_bytes"] / rl.FABRIC_BW)


# ---------------------------------------------------------------------------
# the counts against the real meshed step
# ---------------------------------------------------------------------------

SMOKE_FLAGS = dict(REMAT="none", ATTN_IMPL="chunked", MOE_CAPACITY=1.25,
                   MOE_IMPL="gather", ATTN_CHUNK=1024)
TRAIN = dict(name="train_smoke", seq_len=32, global_batch=8, kind="train")
PREFILL = dict(name="prefill_smoke", seq_len=32, global_batch=8,
               kind="prefill")
DECODE = dict(name="decode_smoke", seq_len=16, global_batch=8,
              kind="decode")
QWEN, OLMOE = "qwen1.5-0.5b", "olmoe-1b-7b"
# qwen1.5-4b's smoke config has 5 KV heads: its cache splits by sequence
# over tp 2; yi-9b's 2 split by heads
CASES = {4: [dict(name="train22", arch=QWEN, shape=TRAIN, mesh=(2, 2)),
             dict(name="prefill22", arch=QWEN, shape=PREFILL, mesh=(2, 2)),
             dict(name="moe_ep22", arch=OLMOE, shape=TRAIN, mesh=(2, 2),
                  flags=dict(SMOKE_FLAGS, MOE_IMPL="ep")),
             dict(name="decode_seq22", arch="qwen1.5-4b", shape=DECODE,
                  mesh=(2, 2)),
             dict(name="decode_sparse22", arch="yi-9b", shape=DECODE,
                  mesh=(2, 2), sparsity=0.8, min_dim=16)],
         8: [dict(name="train222", arch=QWEN, shape=TRAIN, mesh=(2, 2, 2)),
             dict(name="decode_heads222", arch="yi-9b", shape=DECODE,
                  mesh=(2, 2, 2))]}


def _axes(mesh):
    return ("data", "model") if len(mesh) == 2 else ("pod", "data", "model")


@pytest.mark.parametrize("world", sorted(CASES))
def test_fake_world_counts_equal_the_gloo_step(tmp_path, world):
    """f32 smoke configs (Qwen1.5-0.5B; OLMoE-1B-7B under expert
    parallelism, its all-to-alls; the decode cases): rank 0's FLOPs and
    collective bytes by kind on ``meta`` in a fake world equal rank 0's of
    the same meshed step on real tensors in a spawned gloo world of the
    same size.  The sparse decode's FLOPs include the BCSR kernel's (its
    flop formula, ``test_bcsr_kernel_counts_as_one_op``)."""
    cases = [dict(c, axes=_axes(c["mesh"]),
                  flags=c.get("flags", SMOKE_FLAGS)) for c in CASES[world]]
    spawn_world(rank_dryrun_counts, world, cases, str(tmp_path))
    for c in cases:
        cfg = dataclasses.replace(cfgs.get_config(c["arch"], smoke=True),
                                  dtype="float32")
        want = json.loads((tmp_path / f"{c['name']}.json").read_text())
        with dryrun._flags(**c["flags"]), dryrun.fake_world(world):
            from repro_torch.launch.mesh import make_mesh
            mesh = make_mesh(c["mesh"], c["axes"], device_type="cpu")
            got, _, _ = dryrun.count_step(
                cfg, ShapeConfig(**c["shape"]), mesh,
                sparse_weights=c.get("sparsity", 0.0),
                min_dim=c.get("min_dim", 512))
        assert not dist.is_initialized()
        assert got.flops == want["flops"] > 0, c["name"]
        assert got.coll == want["coll"], c["name"]
        assert sum(got.coll.values()) > 0
    assert got.coll["all-to-all"] > 0 if c["arch"] == OLMOE else True


def test_probes_extrapolate_to_the_full_count():
    """probe1 + (n - 1) x (probe2 - probe1) is the full-depth count, for
    FLOPs, bytes and every collective kind (the counter sees each layer;
    the blocks are alike)."""
    cfg = dataclasses.replace(cfgs.get_config("qwen1.5-0.5b", smoke=True),
                              dtype="float32", n_layers=4)
    shape = ShapeConfig(**TRAIN)
    kw = dict(remat="none", attn_impl="chunked")
    mesh = ((2, 2), ("data", "model"))
    full, _, _ = dryrun.count_cell(cfg, shape, *mesh, **kw)
    p1, _, _ = dryrun.count_cell(dryrun._probe_cfg(cfg, 1), shape, *mesh,
                                 **kw)
    p2, _, _ = dryrun.count_cell(dryrun._probe_cfg(cfg, 2), shape, *mesh,
                                 **kw)
    n = 4
    assert p1.flops + (n - 1) * (p2.flops - p1.flops) == full.flops
    assert p1.hbm_bytes + (n - 1) * (p2.hbm_bytes - p1.hbm_bytes) \
        == full.hbm_bytes
    for k in full.coll:
        assert p1.coll[k] + (n - 1) * (p2.coll[k] - p1.coll[k]) \
            == full.coll[k]


def test_views_move_no_bytes():
    """A chain of views (view, t, transpose, slice, select, unsqueeze,
    expand, detach) adds 0 bytes, though expand's output is larger than its
    input; an add counts its two inputs and its output, an in-place add
    the tensor it reads and the one it writes."""
    x = torch.empty(64, 32, device="meta")
    nbytes = x.numel() * x.element_size()
    with costs.count(known=x) as c:
        y = x.view(32, 64).t().transpose(0, 1)[2:10].select(1, 3)
        y.unsqueeze(1).expand(8, 4096).detach()
    assert c.hbm_bytes == 0
    with costs.count(known=x) as c:
        x + x
    assert c.hbm_bytes == 3 * nbytes
    with costs.count(known=x) as c:
        x.add_(1.0)
    assert c.hbm_bytes == 2 * nbytes


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bcsr_kernel_counts_as_one_op(device):
    """The BCSR matmul kernel is one registered op to the counters, on the
    CPU (its plain version runs inside, unseen) as on ``meta``: its flop
    formula, 2 x rows x the bank's tiles x 16 x 16, and x, the bank and y
    each once."""
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul_kernel
    gm, kb, rows = 3, 2, 5
    g = torch.Generator().manual_seed(0)
    args = [torch.randn((rows, 64), generator=g),
            torch.randn((gm, kb, 16, 16), generator=g),
            torch.tensor([[0, 2], [1, 3], [0, 1]], dtype=torch.int32),
            torch.full((gm,), kb, dtype=torch.int32)]
    args = [t.to(device) for t in args]
    with costs.count(known=args) as c:
        y = bsr_matmul_kernel(*args)
    assert tuple(y.shape) == (rows, gm * 16) and y.device.type == device
    assert c.flops == 2 * rows * gm * kb * 16 * 16
    assert c.hbm_bytes == sum(t.numel() * t.element_size()
                              for t in args + [y])
    assert c.peak_new_bytes == y.numel() * y.element_size()


def _cut(monkeypatch, tmp_path, **layers):
    """``dryrun``'s configs cut to ``layers[arch]`` layers, its results
    under ``tmp_path``."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    get = cfgs.get_config
    monkeypatch.setattr(dryrun.cfgs, "get_config", lambda arch: (
        dataclasses.replace(get(arch), n_layers=layers[arch])
        if arch in layers else get(arch)))


def test_no_group_outlives_a_call(tmp_path, monkeypatch):
    """A fake world is destroyed after its run, also when the step raises
    inside it, and after a decode cell (Yi-9B cut to 2 layers)."""
    with pytest.raises(ZeroDivisionError):
        with dryrun.fake_world(4):
            assert dist.get_world_size() == 4
            1 / 0
    assert not dist.is_initialized()
    _cut(monkeypatch, tmp_path, **{"yi-9b": 2})
    r = dryrun.lower_cell("yi-9b", "decode_32k", multi_pod=False,
                          probes=False, verbose=False)
    assert not dist.is_initialized()
    assert r.flops > 0 and r.hbm_bytes > 0 and r.coll_bytes > 0


def test_cli_refuses_what_waits_for_meshed_decode(tmp_path, monkeypatch,
                                                  capsys):
    """``--moe-constrain`` is refused by name (no switch in the port: its
    layout always pins the expert dim).  ``--sparse-weights 0.8`` runs a
    decode cell (Yi-9B cut to 2 layers) and records its value; DeepSeek-V3's
    decode under it fails by name, as the reference's does (its absorbed
    MLA decode reads k_b / v_b dense), and is listed among the failures."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "yi-9b", "--shape", "train_4k",
                     "--moe-constrain"])
    assert exc.value.code == 2
    assert "--moe-constrain" in capsys.readouterr().err
    _cut(monkeypatch, tmp_path, **{"yi-9b": 2, "deepseek-v3-671b": 4})
    dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k",
                 "--sparse-weights", "0.8", "--no-probes"])
    out = json.loads((tmp_path / "yi-9b__decode_32k__16x16.json")
                     .read_text())
    assert out["sparse_weights"] == 0.8 and out["flops"] > 0
    assert "dry-run OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "deepseek-v3-671b", "--shape", "decode_32k",
                     "--sparse-weights", "0.8", "--no-probes"])
    assert exc.value.code == 1
    cap = capsys.readouterr()
    assert "FAILED cells: [('deepseek-v3-671b', 'decode_32k', '16x16')]" \
        in cap.out
    assert "absorbed MLA decode reads k_b" in cap.err


def test_decode_cell_aliases_its_cache(tmp_path, monkeypatch):
    """Yi-9B cut to 2 layers at decode_32k on 16 x 16: its KV cache (kv 4
    on tp 16) splits by sequence, so a device holds B / 16 rows x S / 16
    positions x 4 heads x 128 of K and of V a layer in bf16; the serve step
    updates it in place, so that is the alias, and the arguments hold
    it."""
    _cut(monkeypatch, tmp_path, **{"yi-9b": 2})
    dryrun.lower_cell("yi-9b", "decode_32k", multi_pod=False, probes=False,
                      verbose=False)
    out = json.loads((tmp_path / "yi-9b__decode_32k__16x16.json")
                     .read_text())
    cache = 2 * 2 * (128 // 16) * (32768 // 16) * 4 * 128 * 2
    assert out["mem_alias_bytes"] == cache
    assert out["mem_arg_bytes"] > cache
    assert out["sparse_weights"] == 0.0


def test_enrich_takes_the_single_pod_cells_without_probes(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    todo = enrich.pending()
    assert len(todo) == 31
    assert [s.kind for _, s in todo] == (["train"] * 10 + ["prefill"] * 10
                                         + ["decode"] * 11)
    arch, shape = todo[0]
    (tmp_path / f"{arch}__{shape.name}__16x16.json").write_text(
        json.dumps({"probe_info": {"nblocks": 2}}))
    assert (arch, shape) not in enrich.pending()


def test_meshed_path_has_no_data_dependent_ops():
    """A ``meta`` tensor has no values: the meshed train, prefill and
    decode path (the models, the steps, the sparse weights, AdamW, the
    collectives) reads none back."""
    paths = [*(ROOT / "src/repro_torch/models").glob("*.py"),
             ROOT / "src/repro_torch/launch/steps.py",
             ROOT / "src/repro_torch/launch/sparse_weights.py",
             ROOT / "src/repro_torch/optim/adamw.py",
             *(ROOT / "src/repro_torch/distributed").glob("*.py")]
    bad = re.compile(r"\.item\(\)|\.tolist\(\)|nonzero\(")
    found = [f"{p.name}:{i}" for p in paths
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if bad.search(line)]
    assert not found, found
