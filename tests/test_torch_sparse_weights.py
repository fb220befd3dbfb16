"""``launch/sparse_weights.abstract_sparse_params`` against the reference's.

For every arch with a decode cell, at its full config, sparsity 0.8,
``min_dim`` 512, over stand-in meshes (names, sizes, a coordinate; no
process group):

* the set of converted leaf paths equals the reference's BCSR leaves with
  its stacked layers unstacked (its ``SKIP``, 2-D and layer-stacked 3-D
  rules; a MoE layer's experts stay dense);
* each leaf follows the reference's block rule (``_abstract_bcsr``'s
  (M / tp, 128), else M or N whole): the BCSR of W^T of this rank's ``tp``
  shard on the 16 x 16 mesh in the reference's block of the whole weight,
  ceil(gn x 0.2) tiles a block-row, on ``meta``, in the model's dtype;
* leaf for leaf against the reference's tree: the same block, and where
  tp splits the output dim (the reference's block-rows over tp), the
  reference's leaf shard for shard: its blocks, block columns and counts
  over 16 ranks;
* each leaf's kept columns a block-row are within 128 of the reference's
  kept share of the same shard's width;
* on a (2, 2) mesh each BCSR leaf's placements are its dense leaf's on the
  ``tp`` dim and replicated on "data"; dense leaves keep theirs.
"""
import functools
import math

import jax
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as ref_cfgs  # noqa: E402
from repro.core.sparse_format import BcsrMatrix as RefBcsr  # noqa: E402
from repro.launch import sparse_weights as ref_sw  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs as cfgs  # noqa: E402
from repro_torch.core.sparse_format import BcsrMatrix  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import sparse_weights as SW  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402

ARCHS = sorted({a for a, s in cfgs.all_cells() if s.kind == "decode"})
SPARSITY = 0.8


class StubMesh:
    """What the sharding functions read of a ``DeviceMesh``."""

    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self.shape = tuple(shape)

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, i):
        return 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _port(arch, tp):
    """(leaves by path, placements by path, dense placements by path) on a
    (16, 16) stub mesh at tp 16, or a (2, 2) one at tp 2."""
    cfg = cfgs.get_config(arch)
    mesh = StubMesh((16 if tp == 16 else 2, tp))
    with S.use_rules(S.default_rules(mesh), mesh):
        tree, pls = SW.abstract_sparse_params(cfg, tp, SPARSITY)
        dense = tree_map(lambda s: S.placements(s, mesh),
                         T.param_specs(cfg, tp))
    return (dict(tree_paths(tree)), dict(tree_paths(pls)),
            dict(tree_paths(dense)))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's BCSR leaves (tp 16) by the port's per-layer paths."""
    cfg = ref_cfgs.get_config(arch)
    tree, _ = ref_sw.abstract_sparse_params(cfg, 16, SPARSITY)
    prefix, period, nblocks = RT.stage_plan(cfg)
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefBcsr))
    for path, leaf in flat:
        if not isinstance(leaf, RefBcsr):
            continue
        keys = [str(getattr(k, "key", getattr(k, "idx", None)))
                for k in path]
        if keys[0] == "prefix":
            out["/".join(["layers"] + keys[1:])] = leaf
        elif keys[0] == "stack":
            j = int(keys[1][len("sub"):])
            for bi in range(nblocks):
                i = len(prefix) + bi * len(period) + j
                out["/".join(["layers", str(i)] + keys[2:])] = leaf
        else:
            out["/".join(keys)] = leaf
    return out


def _bcsr(arch, tp=16):
    leaves, _, _ = _port(arch, tp)
    return {k: v for k, v in leaves.items() if isinstance(v, BcsrMatrix)}


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_leaves_match_reference(arch):
    got = set(_bcsr(arch))
    assert got == set(_reference(arch))
    assert got, arch


@functools.lru_cache(maxsize=None)
def _dense(arch, tp=16):
    """(specs by path, dense shapes by path) of the full config."""
    cfg = cfgs.get_config(arch)
    return (dict(tree_paths(T.param_specs(cfg, tp))),
            {k: tuple(v.shape) for k, v in tree_paths(T.init_params(
                cfg, torch.Generator().manual_seed(0), "meta"))})


def _shard_shape(arch, path, tp=16):
    """(out, in) of this rank's tp shard of the dense leaf at ``path``."""
    specs, shapes = _dense(arch, tp)
    dense = specs[path]
    n_in, n_out = shapes[path]
    if dense[0] == "tp":
        n_in //= tp
    if dense[1] == "tp":
        n_out //= tp
    return n_out, n_in


@pytest.mark.parametrize("arch", ARCHS)
def test_bcsr_leaves_follow_the_16x16_rule(arch):
    """(The name is the rule's before the blocks followed the reference's.)
    Each leaf: this rank's shard in the reference's block of the whole
    weight over tp 16."""
    dtype = getattr(torch, cfgs.get_config(arch).dtype)
    specs, shapes = _dense(arch)
    for path, w in _bcsr(arch).items():
        m, n = _shard_shape(arch, path)
        n_in, n_out = shapes[path]
        bm, bn = SW.reference_block(n_out, n_in, 16)
        assert bm == (n_out // 16 if n_out % 16 == 0 and n_out >= 128
                      else n_out)
        assert bn == (128 if n_in % 128 == 0 else n_in)
        gm, gn = -(-m // bm), -(-n // bn)
        kb = max(1, math.ceil(gn * (1 - SPARSITY)))
        assert w.shape == (m, n) and w.block == (bm, bn), path
        assert tuple(w.blocks.shape) == (gm, kb, bm, bn), path
        assert tuple(w.blockcol.shape) == (gm, kb), path
        assert tuple(w.nblocks.shape) == (gm,), path
        assert w.blocks.device.type == "meta" and w.blocks.dtype == dtype
        assert w.blockcol.dtype == w.nblocks.dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_are_the_references_shard_for_shard(arch):
    """Leaf for leaf against the reference's abstract tree at tp 16: the
    same block; a leaf tp does not split is the reference's leaf (a layer
    of its stack) shape for shape; where tp splits the output dim (the
    reference's block-rows, one a rank), this rank's shard of it: its
    blocks, block columns and counts cut to gm / 16 block-rows.  (Where tp
    splits the input dim, the port's shard keeps every block-row over its
    part of N: the rule test holds those.)"""
    ref = _reference(arch)
    specs, _ = _dense(arch)
    held = 0
    for path, w in _bcsr(arch).items():
        r = ref[path]
        assert w.block == tuple(r.block), path
        spec_in, spec_out = specs[path]
        if spec_in == "tp":
            continue
        held += 1
        for got, want, ndim in ((w.blocks, r.blocks, 4),
                                (w.blockcol, r.blockcol, 2),
                                (w.nblocks, r.nblocks, 1)):
            want = tuple(want.shape)[-ndim:]          # past a layer stack
            if spec_out == "tp":
                want = (want[0] // 16,) + want[1:]
            assert tuple(got.shape) == want, path
    assert held > 0, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_kept_columns_near_the_reference(arch):
    """The port keeps kb x bn of its shard's N columns a block-row; the
    reference kb_ref x bn_ref of its whole N: scaled to the shard's width,
    they differ by less than the reference's 128-wide block."""
    ref = _reference(arch)
    for path, w in _bcsr(arch).items():
        r = ref[path]
        n_ref = r.shape[1]
        kept_ref = r.blocks.shape[-3] * r.block[1] * w.shape[1] / n_ref
        kept = w.blocks.shape[1] * w.block[1]
        assert abs(kept - kept_ref) <= 128, (path, kept, kept_ref)
        assert kept >= w.shape[1] * (1 - SPARSITY) - 1e-9, path


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_on_a_2x2_mesh(arch):
    """Each BCSR leaf: the dense leaf's placement on "model" (Shard where
    its spec splits it over tp), Replicate on "data"; dense leaves keep
    their placements."""
    leaves, pls, dense = _port(arch, 2)
    sharded = 0
    for path, w in leaves.items():
        if not isinstance(w, BcsrMatrix):
            assert pls[path] == dense[path], path
            continue
        assert pls[path][0] == Replicate(), path
        assert pls[path][1] == dense[path][1], path
        sharded += isinstance(pls[path][1], Shard)
    assert sharded > 0, arch
