"""The port's BCSR matmul against the JAX package's.

The same numpy inputs go through the reference's ``bsr_matmul`` (its Pallas
kernel in interpret mode), its ``core.sparse_linear.bcsr_matmul`` (the
product the model's ``apply_linear`` computes) and the port's ``bsr_matmul``
on CPU tensors (the kernel's plain version).  f32 inputs are held to
rtol = atol = 1e-5 (the same f32 products, summed in another order); bf16
inputs to 1e-2 (both cast the f32 sums back to bf16, which rounds at
2**-8 relative, and one rounding may land on either side).
"""
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
    bc = fmt.bcsr_from_dense(np.ones((32, 64), np.float32), (16, 16),
                             device="cpu")
    with pytest.raises(ValueError, match="last dim"):
        ops.bsr_matmul(torch.ones((2, 63)), bc)
    before = bk.bsr_matmul_kernel.launches
    ops.bsr_matmul(torch.ones((2, 64)), bc)     # CPU: the plain version
    assert bk.bsr_matmul_kernel.launches == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bk.bsr_matmul_kernel(torch.ones((2, 64), device="meta"), bc.blocks,
                             bc.blockcol, bc.nblocks)


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
