"""The port's BCSR matmul against the JAX package's.

The same numpy inputs go through the reference's ``bsr_matmul`` (its Pallas
kernel in interpret mode), its ``core.sparse_linear.bcsr_matmul`` (the
product the model's ``apply_linear`` computes) and the port's ``bsr_matmul``
on CPU tensors (the kernel's plain version).  f32 inputs are held to
rtol = atol = 1e-5 (the same f32 products, summed in another order); bf16
inputs to 1e-2 (both cast the f32 sums back to bf16, which rounds at
2**-8 relative, and one rounding may land on either side).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.core import sparse_linear as ref_linear  # noqa: E402
from repro.kernels.bsr_matmul import ops as ref_ops  # noqa: E402
from repro.kernels.bsr_matmul.kernel import bsr_matmul_pallas  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core import sparse_linear  # noqa: E402
from repro_torch.kernels.bsr_matmul import kernel as bk  # noqa: E402
from repro_torch.kernels.bsr_matmul import ops, ref  # noqa: E402
from repro_torch.models.transformer import _tensor  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)

# (x shape, M, N, block, sparsity): leading batch dims, N not a multiple of
# bn, rows not a multiple of the reference's batch tile or of either CUDA
# schedule's row tile.
CASES = [
    ((8, 64), 64, 64, (16, 16), 0.5),
    ((2, 3, 96), 80, 96, (16, 16), 0.8),
    ((37, 72), 48, 72, (16, 16), 0.6),        # N % bn
    ((5, 200), 64, 200, (16, 128), 0.5),      # N % bn, bn 128
    ((2, 16, 128), 128, 128, (16, 16), 0.8),  # 32 rows, smoke prefill
    ((4, 1, 64), 128, 64, (16, 16), 0.8),     # decode: 4 rows of one token
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(case, dtype):
    xshape, m, n, block, sp = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    w = np.asarray(ref_pruning.block_prune(
        jnp.asarray(rng.standard_normal((m, n)).astype(np.float32)), sp,
        block)).astype(dtype)
    x = np.array(jnp.asarray(rng.standard_normal(xshape), dtype=dtype))
    return x, w


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bsr_matmul_f32_matches_reference(case):
    x, w = _inputs(case, jnp.float32)
    block = case[3]
    ref_bc = ref_fmt.bcsr_from_dense(w, block)
    want_kernel = np.asarray(ref_ops.bsr_matmul(jnp.asarray(x), ref_bc,
                                                interpret=True))
    want_linear = np.asarray(ref_linear.bcsr_matmul(jnp.asarray(x), ref_bc))
    bc = fmt.bcsr_from_dense(w, block, device="cpu")
    got = ops.bsr_matmul(torch.from_numpy(x), bc)
    assert got.dtype == torch.float32 and got.shape == want_kernel.shape
    np.testing.assert_allclose(got.numpy(), want_kernel, **F32)
    np.testing.assert_allclose(got.numpy(), want_linear, **F32)
    np.testing.assert_allclose(
        sparse_linear.bcsr_matmul(torch.from_numpy(x), bc).numpy(),
        want_linear, **F32)
    np.testing.assert_allclose(
        sparse_linear.dense_matmul(torch.from_numpy(x),
                                   torch.from_numpy(w)).numpy(),
        np.asarray(ref_linear.dense_matmul(jnp.asarray(x), jnp.asarray(w))),
        **F32)


@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_bsr_matmul_bf16_matches_reference(case):
    x, w = _inputs(case, jnp.bfloat16)
    block = case[3]
    ref_bc = ref_fmt.bcsr_from_dense(w, block)
    want = np.asarray(ref_ops.bsr_matmul(jnp.asarray(x), ref_bc,
                                         interpret=True)).astype(np.float32)
    bc = fmt.bcsr_from_dense(_tensor(w, "cpu"), block)
    got = ops.bsr_matmul(_tensor(x, "cpu"), bc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_plain_version_stops_at_nblocks():
    """Tiles past nblocks are never read: poisoned padding changes nothing."""
    w = np.zeros((32, 64), np.float32)
    w[16:, :16] = 1.0
    bc = fmt.bcsr_from_dense(w, (16, 16), pad_to=2, device="cpu")
    blocks = bc.blocks.clone()
    blocks[:, 1] = float("nan")               # every row keeps <= 1 tile
    out = bk.bsr_matmul_kernel(torch.ones((4, 64)), blocks, bc.blockcol,
                               bc.nblocks)
    np.testing.assert_array_equal(out[:, :16].numpy(), 0.0)
    np.testing.assert_array_equal(out[:, 16:].numpy(), 16.0)
    np.testing.assert_allclose(
        out.numpy(), ref.bsr_matmul_ref(torch.ones((4, 64)), bc).numpy())


def test_schedule_and_wrapper_checks():
    assert bk.schedule(4, torch.bfloat16) == "rows"
    assert bk.schedule(8192, torch.bfloat16) == "wgmma"
    assert bk.schedule(8192, torch.float32) == "rows"
    # the measured crossover: rows up to budget.BSR_MATMUL_ROWS_MAX
    from repro_torch.kernels import budget
    top = budget.BSR_MATMUL_ROWS_MAX
    assert bk.schedule(top, torch.bfloat16) == "rows"
    assert bk.schedule(top + 1, torch.bfloat16) == "wgmma"
    bc = fmt.bcsr_from_dense(np.ones((32, 64), np.float32), (16, 16),
                             device="cpu")
    with pytest.raises(ValueError, match="last dim"):
        ops.bsr_matmul(torch.ones((2, 63)), bc)
    before = bk.bsr_matmul_kernel.launches
    ops.bsr_matmul(torch.ones((2, 64)), bc)     # CPU: the plain version
    assert bk.bsr_matmul_kernel.launches == before
    # meta tensors (the dry run): an empty meta output of the result's
    # shape, nothing launched; a device with no kernel raises
    y = bk.bsr_matmul_kernel(torch.ones((2, 64), device="meta"),
                             bc.blocks.to("meta"), bc.blockcol.to("meta"),
                             bc.nblocks.to("meta"))
    assert (y.device.type, tuple(y.shape), y.dtype) == ("meta", (2, 32),
                                                        torch.float32)
    assert bk.bsr_matmul_kernel.launches == before
    xpu = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        bk.bsr_matmul_kernel(xpu, bc.blocks, bc.blockcol, bc.nblocks)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bf16_output_is_the_f32_sums_rounded_once(case):
    """``out_dtype=bfloat16`` rounds the f32 sums once: the f32 output cast
    to bf16, bit for bit; ``ops.bsr_matmul`` asks for x's dtype."""
    x, w = _inputs(case, jnp.bfloat16)
    m, n, block = case[1], case[2], case[3]
    bc = fmt.bcsr_from_dense(_tensor(w, "cpu"), block)
    xt = _tensor(x, "cpu")
    xb = torch.nn.functional.pad(xt.reshape(-1, n), (0, (-n) % block[1]))
    args = (xb, bc.blocks, bc.blockcol, bc.nblocks)
    f32 = bk.bsr_matmul_kernel(*args)
    b16 = bk.bsr_matmul_kernel(*args, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))
    got = ops.bsr_matmul(xt, bc)
    assert torch.equal(got, b16[:, :m].reshape(got.shape))


# (rows, M, N, block, sparsity, pad_to): rows not a multiple of 64, more
# block-rows than one group of 16, N over several 128-column chunks (the
# last ragged), tiles of 16 to 128 columns; every case has ragged nblocks,
# one block-row with no tile, and NaN in its padding tiles.
WALK_CASES = [
    (37, 320, 384, (16, 16), 0.8, 4),
    (100, 256, 512, (16, 16), 0.5, 1),
    (65, 96, 640, (16, 128), 0.6, 2),
    (130, 64, 192, (16, 32), 0.7, 3),
]


def _walk_inputs(case):
    rows, m, n, block, sp, pad_to = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    w = np.array(ref_pruning.block_prune(
        jnp.asarray(rng.standard_normal((m, n)).astype(np.float32)), sp,
        block))
    w[block[0]:2 * block[0]] = 0.0              # block-row 1 keeps no tile
    bc = fmt.bcsr_from_dense(w, block, pad_to=pad_to, device="cpu")
    blocks = bc.blocks.clone()
    kb = torch.arange(bc.kb)[None, :]
    blocks[kb >= bc.nblocks[:, None].long()] = float("nan")
    x = rng.standard_normal((rows, n)).astype(np.float32)
    return x, w, bc, blocks


@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_wgmma_walk_matches_reference_kernel(case):
    """The ``wgmma`` schedule's traversal (groups of 16 block-rows walking
    x in 128-column chunks, one pointer a block-row, stopping at nblocks)
    against the JAX package's Pallas kernel in interpret mode and the
    plain version, within f32 rounding of sums in another order: 1e-5 of
    the output's largest magnitude (the card's check is 1e-4)."""
    x, w, bc, blocks = _walk_inputs(case)
    counts = bc.nblocks.numpy()
    assert counts[1] == 0 and len(set(counts.tolist())) > 1
    assert bool(torch.isnan(blocks).any())
    tb = 64
    xp = np.pad(x, ((0, (-len(x)) % tb), (0, 0)))
    want = np.asarray(bsr_matmul_pallas(
        jnp.asarray(xp), jnp.asarray(blocks.numpy()),
        jnp.asarray(bc.blockcol.numpy()), jnp.asarray(counts), tb=tb,
        interpret=True))[:len(x)]
    got = ref.bsr_matmul_walk_plain(torch.from_numpy(x), blocks,
                                    bc.blockcol, bc.nblocks)
    assert bool(torch.isfinite(got).all())
    limit = 1e-5 * max(1.0, float(np.abs(want).max()))
    plain = ref.bsr_matmul_plain(torch.from_numpy(x), blocks, bc.blockcol,
                                 bc.nblocks).numpy()
    for other in (want, plain, x @ w.T):
        assert float(np.abs(got.numpy() - other).max()) <= limit


def test_wgmma_walk_needs_ascending_block_columns():
    """The walk (and the kernel's one pointer a block-row) takes a row's
    tiles in block-column order: a row listed out of order is refused."""
    w = np.zeros((16, 64), np.float32)
    w[:, :16] = 1.0
    w[:, 48:] = 2.0
    bc = fmt.bcsr_from_dense(w, (16, 16), device="cpu")
    x = torch.ones((3, 64))
    np.testing.assert_array_equal(
        ref.bsr_matmul_walk_plain(x, bc.blocks, bc.blockcol, bc.nblocks,
                                  chunk=32).numpy(), 48.0)
    with pytest.raises(ValueError, match="not ascending"):
        ref.bsr_matmul_walk_plain(x, bc.blocks.flip(1), bc.blockcol.flip(1),
                                  bc.nblocks, chunk=32)


def _two_tile_bank(cols):
    """One block-row of two (16, 16) tiles at ``cols``, N = 256."""
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(
        rng.standard_normal((1, 2, 16, 16)).astype(np.float32))
    return blocks, torch.tensor([cols], dtype=torch.int32), \
        torch.tensor([2], dtype=torch.int32)


@pytest.mark.parametrize("cols, fault", [
    ((9, 0), "not strictly ascending"),
    ((3, 3), "share a block column"),
    ((0, 16), "outside"),
])
def test_wgmma_launcher_refuses_a_bank_it_cannot_walk(cols, fault):
    """The bank of block columns [9, 0] that the walk would cut short, a
    repeated column that would overwrite its twin's slot, and a column past
    N: the launcher's host check refuses each; the plain version (and the
    ``rows`` schedule) sums them in any order."""
    from repro_torch.kernels.bsr_matmul.kernel import _walkable

    blocks, bcol, nb = _two_tile_bank(cols)
    with pytest.raises(ValueError, match=fault):
        _walkable(bcol, nb, 16)
    if fault != "outside":
        x = torch.from_numpy(
            np.random.default_rng(1).standard_normal((64, 256))
            .astype(np.float32))
        want = sum(x[:, c * 16:(c + 1) * 16] @ blocks[0, t].T
                   for t, c in enumerate(cols))
        got = ref.bsr_matmul_plain(x, blocks, bcol, nb)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_walk_check_runs_once_per_bank():
    """The check reads the bank back once; later launches on the same
    tensors skip it, and an in-place write to the bank checks it again."""
    from repro_torch.kernels import _build

    _, bcol, nb = _two_tile_bank((0, 9))
    calls = []
    for _ in range(3):
        _build.check_once("test_walk", (bcol, nb), lambda: calls.append(1))
    assert len(calls) == 1
    bcol[0, 1] = 5
    _build.check_once("test_walk", (bcol, nb), lambda: calls.append(1))
    assert len(calls) == 2
    assert fmt.block_column_fault(bcol, nb, 16) is None


# -- the rows schedule's work list and its plain mirror ------------------
# (tile counts a block-row, KB, units a block-row): empty block-rows, ragged
# counts, fewer tiles than units, one block-row holding every tile, and
# wk's 32 block-rows.
UNIT_CASES = [
    ([0, 3, 0, 7, 1, 0], 8, 2),
    ([5, 17, 2, 9, 13, 1, 4], 17, 4),
    ([0, 0, 64, 0], 64, 8),
    ([51, 48, 55, 50] * 8, 64, 8),     # GM 32, as wk (4096 -> 512)
    ([138, 140, 0, 135], 688, 1),
]


@pytest.mark.parametrize("counts, kb, cluster", UNIT_CASES, ids=str)
def test_rows_work_list_covers_every_kept_tile_once(counts, kb, cluster):
    """Each kept tile (kb < nblocks[i]) lies in exactly one unit, no unit
    reaches a padding tile, every block-row has ``cluster`` consecutive
    units in rank order (a cluster of blocks; an empty block-row's all
    empty: it writes zeros), a block-row's units differ in size by at
    most one tile, and each unit's block columns stand at a fixed
    stride."""
    units = ref.rows_units(torch.tensor(counts, dtype=torch.int32),
                           cluster).tolist()
    assert len(units) == len(counts) * cluster
    seen = {}
    for u, (row, kb0, kb1, rank) in enumerate(units):
        assert (row, rank) == divmod(u, cluster)
        assert 0 <= kb0 <= kb1 <= counts[row] <= kb
        for t in range(kb0, kb1):
            assert (row, t) not in seen
            seen[(row, t)] = u
    assert set(seen) == {(i, t) for i, n in enumerate(counts)
                         for t in range(n)}
    # each unit's block columns at a fixed stride, zeros past its tiles
    blockcol = torch.arange(len(counts) * kb, dtype=torch.int32).reshape(
        len(counts), kb)
    cols = ref.rows_cols(torch.tensor(units, dtype=torch.int32), blockcol)
    assert cols.shape == (len(units), max(
        [kb1 - kb0 for _, kb0, kb1, _ in units] + [1]))
    for u, (row, kb0, kb1, _) in enumerate(units):
        assert cols[u, :kb1 - kb0].tolist() == list(range(
            row * kb + kb0, row * kb + kb1))
        assert not cols[u, kb1 - kb0:].any()
    for i, n in enumerate(counts):
        mine = units[i * cluster:(i + 1) * cluster]
        sizes = [kb1 - kb0 for _, kb0, kb1, _ in mine]
        assert sum(sizes) == n and max(sizes) - min(sizes) <= 1
        assert [kb0 for _, kb0, _, _ in mine] == sorted(
            kb0 for _, kb0, _, _ in mine)


def test_rows_cluster_fills_the_card():
    """Yi-9B's banks at sparsity 0.8 in bf16: wk's 32 block-rows split over
    clusters of 5 (160 blocks, every SM), wq's, gate's and down's 256 or
    more block-rows not at all; f32 banks the same; a bank too small for
    units of 2 KB takes fewer."""
    from repro_torch.kernels import budget

    for gm, total, want in ((32, 1638, 5), (256, 13107, 1), (688, 35225, 1),
                            (256, 35225, 1)):
        for size in (2, 4):
            assert budget.bsr_matmul_rows_cluster(gm, total, 16, 16,
                                                  size) == want
    assert budget.bsr_matmul_rows_cluster(32, 64, 16, 16, 2) == 1
    assert budget.bsr_matmul_rows_cluster(4, 0, 16, 16, 2) == 1
    for bn, size in ((16, 2), (16, 4), (48, 2), (128, 2), (128, 4)):
        tiles = budget.bsr_matmul_rows_stage_tiles(bn, size)
        assert tiles * (bn // 16) % budget.BSR_MATMUL_ROWS_WARPS == 0
    assert budget.bsr_matmul_rows_pass(4, 2) == 8
    assert budget.bsr_matmul_rows_pass(129, 4) == 32
    assert budget.bsr_matmul_rows_pass(48, 2) == 64


def _rows_bank(gm, n, block, seed, pad_to=1):
    """A pruned bank over ``gm`` block-rows with ragged counts, block-row 1
    empty and the last holding every tile, NaN in its padding tiles."""
    bm, bn = block
    rng = np.random.default_rng(seed)
    w = np.array(ref_pruning.block_prune(jnp.asarray(
        rng.standard_normal((gm * bm, n)).astype(np.float32)), 0.8, block))
    w[bm:2 * bm] = 0.0
    w[-bm:] = rng.standard_normal((bm, n)).astype(np.float32)
    bc = fmt.bcsr_from_dense(w, block, pad_to=pad_to, device="cpu")
    blocks = bc.blocks.clone()
    kb = torch.arange(bc.kb)[None, :]
    blocks[kb >= bc.nblocks[:, None].long()] = float("nan")
    return w, bc, blocks


# (rows, M, N, block, units a block-row)
ROWS_MIRROR_CASES = [
    (4, 512, 256, (16, 16), 8),        # GM 32, as wk
    (1, 96, 640, (16, 16), 3),
    (8, 64, 512, (16, 128), 2),
    (37, 160, 384, (16, 32), 5),
]


@pytest.mark.parametrize("case", ROWS_MIRROR_CASES, ids=str)
def test_rows_mirror_matches_plain(case):
    """The rows schedule's partition and order of sums (a block-row's
    units, pieces dealt to 4 warps, warps then units added in order)
    against the plain version
    and the dense product, in f32: within 1e-5 x max(1, max |y|), sums in
    another order.  Padding tiles hold NaN and are never read."""
    rows, m, n, block, cluster = case
    w, bc, blocks = _rows_bank(m // block[0], n, block, rows, pad_to=4)
    units = ref.rows_units(bc.nblocks, cluster)
    x = np.random.default_rng(rows + 1).standard_normal(
        (rows, n)).astype(np.float32)
    got = ref.bsr_matmul_rows_plain(torch.from_numpy(x), blocks,
                                    bc.blockcol, bc.nblocks, units)
    want = ref.bsr_matmul_plain(torch.from_numpy(x), blocks, bc.blockcol,
                                bc.nblocks)
    limit = 1e-5 * max(1.0, float(want.abs().max()))
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= limit
    assert float(np.abs(got.numpy() - x @ w.T).max()) <= limit
    np.testing.assert_array_equal(got[:, block[0]:2 * block[0]].numpy(), 0.0)


@pytest.mark.parametrize("rows", [1, 4, 8])
def test_rows_mirror_matches_reference_kernel(rows):
    """At decode row counts, the rows schedule's mirror on Yi-9B-like
    (16, 16) tiles (GM 32, ragged, an empty block-row, one block-row with
    every tile, NaN padding) against the JAX package's Pallas kernel in
    interpret mode (x padded to its batch tile, as its ops pad it): within
    1e-5 x max(1, max |y|) in f32 (the same products, summed in another
    order)."""
    w, bc, blocks = _rows_bank(32, 256, (16, 16), 100 + rows, pad_to=2)
    units = ref.rows_units(bc.nblocks, 8)
    x = np.random.default_rng(rows).standard_normal(
        (rows, 256)).astype(np.float32)
    tb = 8
    xp = np.pad(x, ((0, (-rows) % tb), (0, 0)))
    want = np.asarray(bsr_matmul_pallas(
        jnp.asarray(xp), jnp.asarray(blocks.numpy()),
        jnp.asarray(bc.blockcol.numpy()), jnp.asarray(bc.nblocks.numpy()),
        tb=tb, interpret=True))[:rows]
    got = ref.bsr_matmul_rows_plain(torch.from_numpy(x), blocks,
                                    bc.blockcol, bc.nblocks, units)
    limit = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= limit
