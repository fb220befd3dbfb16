"""The port's pure sharding functions against the reference's.

* ``resolve`` and ``default_rules`` over a table of logical specs on a
  ("data", "model") and a ("pod", "data", "model") mesh, and under the
  serving rules that map two names to one mesh dim (the first position
  keeps it): the same mesh names, entry for entry.  ``placements`` turns
  them into DTensor placements (``Shard`` on each named mesh dim, nested
  dims pod-major, dims that do not divide left whole).
* ``plan_remesh`` for every ``n_alive`` in 0..600, model in {1, 2, 16},
  with and without the pod dim.
* ``param_specs`` and ``cache_specs`` for every arch's smoke config at tp 1,
  2 and 16: the port's per-layer tree against the reference's stacked one
  unstacked (its leading scan dim dropped), tree path for tree path, the
  logical specs and their resolution on both meshes.
* ``input_specs`` (meta tensors where the reference has
  ``ShapeDtypeStruct``s): shapes, dtypes and specs of every applicable
  (arch, shape) cell of yi-9b, hubert-xlarge and mamba2-2.7b at tp 16 /
  dp 16, the decode cache's element count, and ``long_500k`` dropping "dp"
  (the port's versions of ``tests/test_roofline_specs.py``'s spec cases).
* ``compress_int8`` / ``decompress_int8`` bit for bit on seeded arrays.

Pure Python over stand-in meshes (names, sizes, a coordinate): no process
group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RP

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.runtime import elastic as ref_elastic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ALL_SHAPES  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402


class StubMesh:
    """What the sharding functions read of a ``DeviceMesh``: dim names,
    sizes and this rank's coordinate."""

    def __init__(self, names, shape, coord=None):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.coord = tuple(coord or (0,) * len(shape))

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, i):
        return self.coord[i]


MESHES = {"2d": (("data", "model"), (4, 2)),
          "3d": (("pod", "data", "model"), (2, 4, 2))}
SERVING_RULES = {"fsdp": "model", "tp": "model", "dp": ("data",),
                 "sp": None}
SPECS = [("fsdp", "tp"), ("dp", None), (None,), ("unknown",),
         (("dp", "sp"), None), ("tp", "tp"), ("fsdp", "fsdp"),
         ("dp", "sp", "tp"), (("fsdp", "tp"),), ("data", "model"),
         ("model", "tp"), (), (("dp",),), ("sp", ("dp", "tp")),
         ("pod", "dp"), (None, "fsdp", None)]


def _ref_mesh(names):
    dev = np.asarray(jax.devices()[:1]).reshape((1,) * len(names))
    return jax.sharding.Mesh(dev, names)


def _norm(spec):
    """A spec's entries with a one-name tuple as that name (jax's
    ``PartitionSpec`` normalises ``("data",)`` so; the same sharding)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _resolved(rules_of, names, spec):
    ref_mesh = _ref_mesh(names)
    mesh = StubMesh(names, MESHES["3d" if len(names) == 3 else "2d"][1])
    with ref_shd.use_rules(rules_of(ref_shd, ref_mesh), ref_mesh):
        want = _norm(ref_shd.resolve(RP(*spec)))
    with S.use_rules(rules_of(S, mesh), mesh):
        got = _norm(S.resolve(P(*spec)))
    return got, want


@pytest.mark.parametrize("rules", ["default", "serving"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_resolve_matches_reference(mesh, rules, spec):
    names = MESHES[mesh][0]
    pick = ((lambda mod, m: mod.default_rules(m)) if rules == "default"
            else (lambda mod, m: dict(SERVING_RULES)))
    got, want = _resolved(pick, names, spec)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_default_rules_match_reference(mesh):
    names, shape = MESHES[mesh]
    assert (S.default_rules(StubMesh(names, shape))
            == ref_shd.default_rules(_ref_mesh(names)))


def test_resolve_and_constrain_outside_a_mesh():
    assert S.get_mesh() is None
    x = torch.ones(4, 4)
    assert S.constrain(x, "dp", None) is x
    assert S.resolve(P("fsdp", "tp")) == P(None, None)
    assert S.named_sharding(P("dp")) is None


@pytest.mark.parametrize("spec, shape, want", [
    (("dp", None), None, [Shard(0), Shard(0), Replicate()]),
    (("fsdp", "tp"), None, [Replicate(), Shard(0), Shard(1)]),
    ((None, "fsdp"), None, [Replicate(), Shard(1), Replicate()]),
    (("dp", "sp", None), (16, 6, 3), [Shard(0), Shard(0), Shard(1)]),
    (("dp", "sp", None), (4, 5, 3), [Replicate(), Replicate(), Replicate()]),
    ((), None, [Replicate(), Replicate(), Replicate()]),
])
def test_placements(spec, shape, want):
    names, mshape = MESHES["3d"]
    mesh = StubMesh(names, mshape)
    with S.use_rules(S.default_rules(mesh), mesh):
        assert list(S.placements(P(*spec), mesh, shape)) == want


def test_local_chunk_is_pod_major():
    names, shape = MESHES["3d"]
    full = torch.arange(16 * 3).reshape(16, 3)
    seen = []
    for pod in range(2):
        for data in range(4):
            mesh = StubMesh(names, shape, (pod, data, 1))
            with S.use_rules(S.default_rules(mesh), mesh):
                seen.append(S.local_chunk(
                    full, S.placements(P("dp"), mesh), mesh))
    assert torch.equal(torch.cat(seen), full)
    mesh = StubMesh(names, shape)
    with S.use_rules(S.default_rules(mesh), mesh), pytest.raises(ValueError):
        S.local_chunk(torch.zeros(6, 3), S.placements(P("dp"), mesh), mesh)


@pytest.mark.parametrize("pod_axis", [False, True])
@pytest.mark.parametrize("model", [1, 2, 16])
def test_plan_remesh_matches_reference(model, pod_axis):
    for n in range(601):
        assert (elastic.plan_remesh(n, model=model, pod_axis=pod_axis)
                == ref_elastic.plan_remesh(n, model=model, pod_axis=pod_axis)
                ), n


def _unstack(ref_tree, cfg):
    """The reference's params/cache spec tree in the port's layout."""
    prefix, period, nblocks = T.stage_plan(cfg)
    layers = list(ref_tree.get("prefix", []))
    for _ in range(nblocks):
        for j in range(len(period)):
            layers.append(jax.tree.map(
                lambda s: RP(*tuple(s)[1:]), ref_tree["stack"][f"sub{j}"],
                is_leaf=lambda s: isinstance(s, RP)))
    out = {k: v for k, v in ref_tree.items() if k not in ("prefix", "stack")}
    out["layers"] = layers
    return out


def _spec_paths(tree, ref: bool):
    if ref:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, RP))
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): tuple(s) for path, s in flat}
    return {k: tuple(v) for k, v in tree_paths(tree)}


def _assert_specs(got_tree, ref_tree, cfg):
    got = _spec_paths(got_tree, False)
    want = _spec_paths(_unstack(ref_tree, cfg), True)
    assert sorted(got) == sorted(want)
    for names in (MESHES["2d"][0], MESHES["3d"][0]):
        for path, spec in want.items():
            g, w = _resolved(lambda mod, m: mod.default_rules(m), names, spec)
            assert tuple(got[path]) == spec, path
            assert g == w, (path, names)


ARCHS = configs.list_archs()


@pytest.mark.parametrize("tp", [1, 2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, tp):
    cfg = configs.get_config(arch, smoke=True)
    _assert_specs(T.param_specs(cfg, tp),
                  RT.param_specs(ref_configs.get_config(arch, smoke=True), tp),
                  cfg)
    # congruent with the params, and no deeper than each leaf
    params = dict(tree_paths(T.init_params(cfg, torch.Generator(), "meta")))
    for path, spec in tree_paths(T.param_specs(cfg, tp)):
        assert len(spec) <= params[path].dim(), path


@pytest.mark.parametrize("tp", [1, 2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, tp):
    cfg = configs.get_config(arch, smoke=True)
    _assert_specs(T.cache_specs(cfg, tp),
                  RT.cache_specs(ref_configs.get_config(arch, smoke=True), tp),
                  cfg)


def _cells():
    for arch in ("yi-9b", "hubert-xlarge", "mamba2-2.7b"):
        for shape in ALL_SHAPES:
            if shape.name in configs.REGISTRY[arch].SHAPES:
                yield arch, shape.name


@pytest.mark.parametrize("arch, shape_name", list(_cells()))
def test_input_specs_match_reference(arch, shape_name):
    cfg = configs.get_config(arch)
    shape = next(s for s in ALL_SHAPES if s.name == shape_name)
    ref_shape = ref_configs.SHAPE_BY_NAME[shape_name]
    got, parts = specs.input_specs(cfg, shape, tp=16, dp=16)
    want, ref_parts = ref_specs.input_specs(ref_configs.get_config(arch),
                                            ref_shape, tp=16, dp=16)
    for key in want:
        if key == "cache":
            n = sum(t.numel() for _, t in tree_paths(got["cache"]))
            assert n == sum(int(np.prod(x.shape))
                            for x in jax.tree.leaves(want["cache"]))
            assert all(t.device.type == "meta"
                       for _, t in tree_paths(got["cache"]))
            continue
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype).split(".")[-1] == str(
            jnp.dtype(want[key].dtype)), key
        assert got[key].device.type == "meta"
    for key in ref_parts:
        if key == "cache":
            _assert_specs(parts["cache"], ref_parts["cache"], cfg)
        else:
            assert tuple(parts[key]) == tuple(ref_parts[key]), key


def test_long_500k_batch1_drops_dp():
    cfg = configs.get_config("mamba2-2.7b")
    shape = next(s for s in ALL_SHAPES if s.name == "long_500k")
    _, parts = specs.input_specs(cfg, shape, tp=16, dp=16)
    leaves = tree_paths(parts)
    assert leaves
    for path, spec in leaves:
        assert isinstance(spec, P), path
        assert "dp" not in tuple(spec), (path, spec)


def _arrays():
    rs = np.random.RandomState(0)
    yield "normal", rs.randn(33, 17).astype(np.float32)
    yield "tiny", (rs.randn(64) * 1e-9).astype(np.float32)
    yield "zeros", np.zeros((5, 3), np.float32)
    yield "halves", (np.arange(-300, 301, dtype=np.float32) / 2.0)
    yield "wide", (rs.standard_cauchy(1000) * 1e4).astype(np.float32)


@pytest.mark.parametrize("name, arr", list(_arrays()),
                         ids=[n for n, _ in _arrays()])
def test_compress_int8_bit_for_bit(name, arr):
    q, scale = compression.compress_int8(torch.from_numpy(arr))
    rq, rscale = ref_comp.compress_int8(jnp.asarray(arr))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert np.float32(scale.item()) == np.float32(rscale)
    np.testing.assert_array_equal(
        compression.decompress_int8(q, scale).numpy(),
        np.asarray(ref_comp.decompress_int8(rq, rscale)))


def test_compress_int8_bf16_input():
    arr = np.random.RandomState(1).randn(40).astype(np.float32)
    q, scale = compression.compress_int8(
        torch.from_numpy(arr).to(torch.bfloat16))
    rq, rscale = ref_comp.compress_int8(jnp.asarray(arr, jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert np.float32(scale.item()) == np.float32(rscale)
