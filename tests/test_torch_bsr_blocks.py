"""The port's BCSR matmul at any block against the JAX package's.

The reference's product takes any (bm, bn) tiles: its Pallas kernel
(``bsr_matmul_pallas``, run here in interpret mode) and
``core.sparse_linear.bcsr_matmul`` (what ``apply_linear`` computes), with
its default block (128, 128).  The port's kernel takes any block whose
sides are multiples of 16, read as sub-rows of (16, bn) pieces, and
``ops.bsr_matmul`` re-tiles any other bank (``ref.retile_bcsr``) before
the kernel, or on the CPU before its plain version.  Held here, on seeded
numpy inputs:

* the port's ``bsr_matmul`` against both of the reference's at (16, 16),
  (32, 16), (64, 64), (128, 128), (16, 48), (8, 128) and (24, 40) tiles,
  f32 within 1e-5 x max(1, max |y|) (the same products summed in another
  order), bf16 within rtol = atol = 1e-2 (both round the f32 sums to bf16
  once, on either side of a tie);
* the sub-row walks' pure-torch mirrors (``ref.bsr_matmul_walk_plain``,
  the ``wgmma`` schedule's, with tiles across the 128-column chunk's edge;
  ``ref.bsr_matmul_rows_plain``, the ``rows`` schedule's) bit for bit
  against the plain version, on integer data whose sums are exact in f32,
  so that only a piece visited twice, missed or misplaced could differ;
* the re-tiled bank bit for bit against ``bcsr_to_dense``, its padding
  zero; a bank too wide for the ``rows`` ring cut side by side
  (``ref.split_bcsr``) likewise, and its product against the reference's
  in f32 and bf16;
* the ``rows`` work list at bm 16 as it was built before sub-rows, and at
  taller blocks covering each sub-row's kept tiles once;
* Yi-9B's smoke config pruned by ``sparsify_params(block=(128, 128))``,
  the reference's carried over and the port's own, against the
  reference's forward (rtol = atol = 1e-4, the transformer tests'
  tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.core import sparse_linear as ref_linear  # noqa: E402
from repro.kernels.bsr_matmul import ops as ref_ops  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.bsr_matmul import kernel as bk  # noqa: E402
from repro_torch.kernels.bsr_matmul import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.transformer import _tensor  # noqa: E402

BLOCKS = [(16, 16), (32, 16), (64, 64), (128, 128), (16, 48), (8, 128),
          (24, 40)]
M, N = 384, 512
XSHAPE = (3, 5, N)
BF16 = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(block, dtype):
    rng = np.random.default_rng(block[0] * 1000 + block[1])
    w = np.asarray(ref_pruning.block_prune(
        jnp.asarray(rng.standard_normal((M, N)).astype(np.float32)), 0.7,
        block)).astype(dtype)
    x = np.array(jnp.asarray(rng.standard_normal(XSHAPE), dtype=dtype))
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", BLOCKS, ids=str)
def test_any_block_matches_reference(block, dtype):
    x, w = _inputs(block, getattr(jnp, dtype))
    ref_bc = ref_fmt.bcsr_from_dense(w, block)
    want_kernel = np.asarray(ref_ops.bsr_matmul(
        jnp.asarray(x), ref_bc, interpret=True)).astype(np.float32)
    want_linear = np.asarray(ref_linear.bcsr_matmul(
        jnp.asarray(x), ref_bc)).astype(np.float32)
    bc = fmt.bcsr_from_dense(_tensor(w, "cpu"), block)
    got = ops.bsr_matmul(_tensor(x, "cpu"), bc)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want_kernel.shape == XSHAPE[:-1] + (M,)
    got = got.float().numpy()
    for want in (want_kernel, want_linear):
        if dtype == "float32":
            limit = 1e-5 * max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= limit
        else:
            np.testing.assert_allclose(got, want, **BF16)


def _integer_bank(m, n, block, seed):
    """A pruned bank of small integers (every product and sum exact in
    f32) with ragged counts, block-row 1 empty, NaN in its padding tiles;
    and integer x of 37 rows."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-3, 4, (m, n)).astype(np.float32)
    w = np.array(ref_pruning.block_prune(jnp.asarray(w), 0.6, block))
    w[block[0]:2 * block[0]] = 0.0
    bc = fmt.bcsr_from_dense(w, block, pad_to=3, device="cpu")
    blocks = bc.blocks.clone()
    kb = torch.arange(bc.kb)[None, :]
    blocks[kb >= bc.nblocks[:, None].long()] = float("nan")
    x = torch.from_numpy(rng.integers(-3, 4, (37, n)).astype(np.float32))
    return x, bc, blocks


# (M, N, block): sub-rows of 2 to 8 pieces, widths that divide the
# 128-column chunk, that do not (48, 80: tiles across its edge) and wider
# than it (256)
WALK_CASES = [(320, 384, (16, 16)), (256, 384, (32, 16)),
              (256, 512, (64, 64)), (384, 512, (128, 128)),
              (96, 480, (16, 48)), (192, 1024, (32, 256)),
              (288, 640, (48, 80))]


@pytest.mark.parametrize("m, n, block", WALK_CASES, ids=str)
def test_subrow_walks_bit_for_bit(m, n, block):
    x, bc, blocks = _integer_bank(m, n, block, m + n)
    counts = bc.nblocks.tolist()
    assert counts[1] == 0 and len(set(counts)) > 1
    plain = ref.bsr_matmul_plain(x, blocks, bc.blockcol, bc.nblocks)
    assert bool(torch.isfinite(plain).all())
    walk = ref.bsr_matmul_walk_plain(x, blocks, bc.blockcol, bc.nblocks)
    assert torch.equal(walk, plain)
    for cluster in (1, 3):
        units = ref.rows_units(ref.subrow_counts(bc.nblocks, block[0]),
                               cluster)
        rows = ref.bsr_matmul_rows_plain(x, blocks, bc.blockcol, bc.nblocks,
                                         units)
        assert torch.equal(rows, plain)
    dense = fmt.bcsr_to_dense(bc)[:m, :n]
    assert torch.equal(plain[:, :m], x @ dense.T)


def test_walk_of_a_tile_across_the_chunk_edge():
    """(16, 48) tiles at block columns 2 and 3 (columns 96-143, 144-191):
    the first crosses the 128-column edge, so chunk 0 takes its first two
    16-column parts and chunk 1 its third, the pointer passing it only
    then.  The walk relies on ascending block columns; the launcher's
    check refuses the bank in the other order before any launch."""
    blocks = torch.arange(2 * 16 * 48, dtype=torch.float32).reshape(
        1, 2, 16, 48) % 5 - 2
    cols = torch.tensor([[2, 3]], dtype=torch.int32)
    nb = torch.tensor([2], dtype=torch.int32)
    x = torch.arange(3 * 192, dtype=torch.float32).reshape(3, 192) % 7 - 3
    want = ref.bsr_matmul_plain(x, blocks, cols, nb)
    assert torch.equal(ref.bsr_matmul_walk_plain(x, blocks, cols, nb), want)
    with pytest.raises(ValueError, match="not strictly ascending"):
        bk._walkable(cols.flip(1), nb, 4)


RETILE_BLOCKS = [(8, 128), (24, 40), (100, 24), (12, 16), (16, 8)]


@pytest.mark.parametrize("block", RETILE_BLOCKS, ids=str)
def test_retile_matches_to_dense(block):
    """Each tile at the top left of a tile of the next multiples of 16,
    the rest zero: cut back to the original grid, the re-tiled bank's
    dense form is the bank's, bit for bit."""
    rng = np.random.default_rng(block[0] + block[1])
    w = np.asarray(ref_pruning.block_prune(jnp.asarray(
        rng.standard_normal((200, 210)).astype(np.float32)), 0.6, block))
    bc = fmt.bcsr_from_dense(w, block, device="cpu")
    rt = ref.retile_bcsr(bc)
    bm, bn = block
    bm2, bn2 = ref.retiled_block(block)
    assert rt.block == (bm2, bn2) and bm2 % 16 == bn2 % 16 == 0
    assert budget.bsr_matmul_native(bm2, bn2)
    assert torch.equal(rt.blockcol, bc.blockcol)
    assert torch.equal(rt.nblocks, bc.nblocks)
    gm, gn = bc.blocks.shape[0], -(-210 // bn)
    dense = fmt.bcsr_to_dense(rt).reshape(gm, bm2, gn, bn2)
    cut = dense[:, :bm, :, :bn].reshape(gm * bm, gn * bn)
    assert torch.equal(cut[:200, :210], fmt.bcsr_to_dense(bc))
    assert int(cut[200:].count_nonzero()) == int(
        cut[:, 210:].count_nonzero()) == 0
    assert int(dense[:, bm:].count_nonzero()) == 0
    assert int(dense[:, :, :, bn:].count_nonzero()) == 0
    np.testing.assert_array_equal(fmt.bcsr_to_dense(bc).numpy(), w)


def test_retiled_bank_is_made_once_and_meta_is_not_retiled():
    """``ops`` re-tiles a bank once (cached with the bank); a CPU product
    through it equals the plain version on the bank as it is; ``meta``
    tensors (the dry run) keep the reference's tiles, so the op's flop
    formula counts them."""
    x, w = _inputs((8, 128), jnp.float32)
    bc = fmt.bcsr_from_dense(_tensor(w, "cpu"), (8, 128))
    first = ops._bank(bc, torch.float32, True, 128)
    assert first is ops._bank(bc, torch.float32, True, 128)
    assert first.blocks.shape[2:] == (16, 128)
    xt = torch.from_numpy(x).reshape(-1, N)
    got = ops.bsr_matmul(xt, bc)
    want = ref.bsr_matmul_plain(xt, bc.blocks, bc.blockcol, bc.nblocks)
    limit = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want[:, :M]).abs().max()) <= limit
    meta = fmt.BcsrMatrix(
        blocks=bc.blocks.to("meta"), blockcol=bc.blockcol.to("meta"),
        nblocks=bc.nblocks.to("meta"), shape=bc.shape, block=bc.block)
    y = ops.bsr_matmul(xt.to("meta"), meta)
    assert y.device.type == "meta" and tuple(y.shape) == (xt.shape[0], M)
    gm, kb = bc.blocks.shape[:2]
    assert bk._flops(tuple(xt.shape), tuple(meta.blocks.shape)) == (
        2 * xt.shape[0] * gm * kb * 8 * 128)


# (block, N): a block too wide for a stage of the rows ring, cut to
# budget.bsr_matmul_rows_width: 1024 -> 512, 16 x 63 -> 144 (an odd
# count of pieces), and one re-tiled first, (8, 1000) -> (16, 1008) -> 144
WIDE_CASES = [((16, 1024), 2048), ((32, 1008), 2016), ((8, 1000), 2000)]


@pytest.mark.parametrize("block, n", WIDE_CASES, ids=str)
def test_split_of_a_wide_bank_matches_to_dense(block, n):
    """The rows schedule's width is the widest multiple of 16 dividing the
    (re-tiled) block that fits; the direct launch of the wider block is
    refused naming it; the cut bank's dense form is the bank's, bit for
    bit, each block-row's columns ascending."""
    bm2, bn2 = ref.retiled_block(block)
    width = budget.bsr_matmul_rows_width(bn2)
    assert width < bn2 and bn2 % width == 0 and width % 16 == 0
    n2 = -(-n // block[1]) * bn2   # x's columns as the kernel reads them
    assert budget.bsr_matmul_unsupported(bm2, width, n2, "rows") is None
    fault = budget.bsr_matmul_unsupported(bm2, bn2, n2, "rows")
    assert fault is not None and f"to {width} columns" in fault
    rng = np.random.default_rng(n)
    w = np.asarray(ref_pruning.block_prune(jnp.asarray(
        rng.standard_normal((96, n)).astype(np.float32)), 0.5, block))
    bc = ref.retile_bcsr(fmt.bcsr_from_dense(w, block, device="cpu"))
    cut = ref.split_bcsr(bc, width)
    assert cut.block == (bm2, width) and cut.shape == bc.shape
    assert torch.equal(fmt.bcsr_to_dense(cut), fmt.bcsr_to_dense(bc))
    for i, k in enumerate(cut.nblocks.tolist()):
        cols = cut.blockcol[i, :k]
        assert bool((cols[1:] > cols[:-1]).all()), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block, n", WIDE_CASES, ids=str)
def test_wide_block_matches_reference(block, n, dtype):
    """``ops.bsr_matmul`` over a bank too wide for the rows ring (cut once
    per bank, cached) against the reference's ``bcsr_matmul`` on the bank
    as it is, within the BLOCKS cases' tolerances."""
    rng = np.random.default_rng(n + 1)
    w = np.asarray(ref_pruning.block_prune(jnp.asarray(
        rng.standard_normal((96, n)).astype(np.float32)), 0.5,
        block)).astype(getattr(jnp, dtype))
    x = np.array(jnp.asarray(rng.standard_normal((7, n)),
                             dtype=getattr(jnp, dtype)))
    want = np.asarray(ref_linear.bcsr_matmul(
        jnp.asarray(x), ref_fmt.bcsr_from_dense(w, block))).astype(
            np.float32)
    bc = fmt.bcsr_from_dense(_tensor(w, "cpu"), block)
    got = ops.bsr_matmul(_tensor(x, "cpu"), bc)
    bm2, bn2 = ref.retiled_block(block)
    bank = ops._bank(bc, getattr(torch, dtype), (bm2, bn2) != block,
                     budget.bsr_matmul_rows_width(bn2))
    assert bank.block == (bm2, budget.bsr_matmul_rows_width(bn2))
    assert got.dtype == getattr(torch, dtype) and got.shape == (7, 96)
    got = got.float().numpy()
    if dtype == "float32":
        limit = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= limit
    else:
        np.testing.assert_allclose(got, want, **BF16)


@pytest.mark.parametrize("block", [(12, 16), (16, 8), (8, 128)], ids=str)
def test_kernel_refuses_a_block_it_cannot_take(block):
    """The launcher's shape check (what a CUDA tensor reaches; no
    fallback): a block with a side not a multiple of 16 is refused,
    naming the re-tiling; a multiple of 16 passes."""
    fault = bk._shape_fault(torch.bfloat16, torch.bfloat16, 4, 512, 8,
                            *block, "rows")
    assert fault is not None and "re-tiles" in fault
    for tall in ((32, 16), (128, 128), (256, 128)):
        assert bk._shape_fault(torch.bfloat16, torch.bfloat16, 4, 512, 8,
                               *tall, "wgmma") is None


@pytest.mark.parametrize("cluster", [1, 2, 8])
def test_rows_work_list_at_bm16_is_unchanged(cluster):
    """At bm 16 a sub-row is a block-row: the work list, its columns and
    the cluster size are what they were before sub-rows."""
    rng = np.random.default_rng(cluster)
    counts = torch.from_numpy(rng.integers(0, 9, 40).astype(np.int32))
    blockcol = torch.from_numpy(rng.integers(0, 50, (40, 9))
                                .astype(np.int32))
    assert ref.subrow_counts(counts, 16) == counts.tolist()
    units = ref.rows_units(ref.subrow_counts(counts, 16), cluster)
    assert torch.equal(units, ref.rows_units(counts, cluster))
    old = torch.zeros_like(ref.rows_cols(units, blockcol))
    for u, (row, kb0, kb1, _) in enumerate(units.tolist()):
        old[u, :kb1 - kb0] = blockcol[row, kb0:kb1]
    assert torch.equal(ref.rows_cols(units, blockcol, 16), old)
    total = int(counts.sum())
    for bn, size in ((16, 2), (128, 4)):
        want = max(1, min(budget.BSR_MATMUL_ROWS_CLUSTER_MAX,
                          -(-budget.SMS // 40),
                          total * 16 * bn * size // (40 * 2048)))
        assert budget.bsr_matmul_rows_cluster(40, total, 16, bn,
                                              size) == want


@pytest.mark.parametrize("bm", [32, 128])
def test_rows_work_list_covers_each_subrow_once(bm):
    """At bm = 16 s each block-row's tiles are listed once for each of its
    s sub-rows, cut into the cluster's units in order; each unit's
    columns are its block-row's."""
    counts = [3, 0, 7, 1]
    blockcol = torch.arange(4 * 7, dtype=torch.int32).reshape(4, 7)
    s = bm // 16
    units = ref.rows_units(ref.subrow_counts(counts, bm), 2)
    assert units.shape == (4 * s * 2, 4)
    cols = ref.rows_cols(units, blockcol, bm)
    seen = {}
    for u, (row, kb0, kb1, rank) in enumerate(units.tolist()):
        i = row // s
        assert rank == u % 2 and kb0 <= kb1 <= counts[i]
        assert cols[u, :kb1 - kb0].tolist() == blockcol[i, kb0:kb1].tolist()
        seen.setdefault(row, []).extend(range(kb0, kb1))
    assert {r: sorted(v) for r, v in seen.items()} == {
        r: list(range(counts[r // s])) for r in range(4 * s)}


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_yi9b_smoke_at_the_reference_default_tiles():
    """Yi-9B's f32 smoke config pruned at 0.8 with the reference's default
    (128, 128) tiles: the reference's ``sparsify_params`` carried over and
    the port's own on the carried dense weights, each forward within
    rtol = atol = 1e-4 of the reference's forward on its banks."""
    ref_cfg = dataclasses.replace(
        ref_configs.get_config("yi-9b", smoke=True), dtype="float32")
    cfg = dataclasses.replace(configs.get_config("yi-9b", smoke=True),
                              dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    ref_sparse = ref_serve.sparsify_params(ref_params, ref_cfg, 0.8,
                                           block=(128, 128))
    carried = T.params_from_reference(_to_numpy(ref_sparse), cfg, "cpu")
    own = serve.sparsify_params(
        T.params_from_reference(_to_numpy(ref_params), cfg, "cpu"), cfg, 0.8,
        block=(128, 128))
    blocks = {w.block for layer in own["layers"] for sub in layer.values()
              if isinstance(sub, dict) for w in sub.values()
              if isinstance(w, fmt.BcsrMatrix)}
    assert blocks == {(128, 128)}
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16),
                                             dtype=np.int32)
    want, _ = RT.forward(ref_sparse, jnp.asarray(toks), ref_cfg)
    for params in (carried, own):
        got, _ = T.forward(params, torch.from_numpy(toks), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
