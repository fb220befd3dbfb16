"""The BCSR conv on quantised (int8, e4m3) banks and at block heights 32 and
64, against the JAX package.

The same seeded numpy weights are blocked (and quantised, bit for bit, as
``test_torch_quantize.py`` holds) by both packages and run through the
reference's ``bsr_conv`` (its Pallas kernel in interpret mode) and the
port's (the kernel's plain version on CPU tensors), within
1e-5 x max(1, max |y|): the reference scales each tile's contribution
before it adds it, the port (as its CUDA kernel) the f32 sum once, the
same function up to f32 rounding.  The port's split mirror on a quantised
bank takes the kernel's two products (the values are exact in TF32, their
lo half zero), and the schedule probe gives the tall blocks only the tiles
that hold whole block-rows.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.kernels.bsr_conv import ops as ref_ops  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.direct_conv import out_spatial, pad_in  # noqa: E402
from repro_torch.core.pruning import block_prune_conv  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.bsr_conv import ops  # noqa: E402
from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel  # noqa: E402
from repro_torch.kernels.bsr_conv.ref import (bsr_conv_plain,  # noqa: E402
                                              bsr_conv_split_plain,
                                              split_tf32)

VALUE_DTYPES = (None, "int8", "float8_e4m3fn")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (N, C, H, M, R, stride, pad, block, relu, residual)
CASES = [
    (2, 20, 8, 70, 3, 1, 1, (32, 128), True, False),   # M % 32, pad columns
    (1, 32, 9, 64, 1, 2, 0, (64, 128), True, True),    # stride-2 1x1 tail
    (2, 12, 7, 40, 3, 1, 1, (64, 128), False, True),   # M < 64: one block-row
    (1, 16, 10, 24, 5, 1, 2, (8, 128), True, False),
    (2, 24, 6, 48, 3, 2, 1, (16, 128), False, True),
]


def _inputs(case):
    n, c, h, m, r, stride, pad, block, relu, with_res = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    w = block_prune_conv(rng.standard_normal((m, c, r, r)).astype(np.float32),
                         0.5, block)
    e, f = out_spatial(h, h, r, r, stride, pad)
    bias = rng.standard_normal(m).astype(np.float32)
    res = (rng.standard_normal((n, m, e, f)).astype(np.float32)
           if with_res else None)
    return x, w, bias, res


def _banks(w, block, value_dtype):
    want = ref_fmt.bcsr_conv_from_dense(w, block=block)
    got = fmt.bcsr_conv_from_dense(w, block=block, device="cpu")
    if value_dtype is not None:
        want = ref_fmt.quantize_values(want, value_dtype)
        got = fmt.quantize_values(got, value_dtype)
    return want, got


@pytest.mark.parametrize("value_dtype", VALUE_DTYPES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_bsr_conv_matches_reference(case, value_dtype):
    n, c, h, m, r, stride, pad, block, relu, with_res = case
    x, w, bias, res = _inputs(case)
    ref_bank, bank = _banks(w, block, value_dtype)
    want = np.asarray(ref_ops.bsr_conv(
        jnp.asarray(x), ref_bank, stride=stride, padding=pad,
        bias=jnp.asarray(bias), fuse_relu=relu,
        residual=None if res is None else jnp.asarray(res), interpret=True))
    launches = bsr_conv_kernel.launches
    got = ops.bsr_conv(
        torch.from_numpy(x), bank, stride=stride, padding=pad,
        bias=torch.from_numpy(bias), fuse_relu=relu,
        residual=None if res is None else torch.from_numpy(res))
    assert bsr_conv_kernel.launches == launches   # the CPU runs no kernel
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("value_dtype", ("int8", "float8_e4m3fn"))
def test_quantised_split_mirror_takes_two_products(value_dtype):
    """The values of a quantised bank are exact in TF32: their lo half is
    zero, so the split mirror's x_hi w_lo product adds nothing and it is
    the kernel's two-product sum, within 1e-5 of the plain version."""
    n, c, h, m, r, stride, pad, block, relu, with_res = CASES[0]
    x, w, bias, _ = _inputs(CASES[0])
    _, bank = _banks(w, block, value_dtype)
    hi, lo = split_tf32(bank.blocks.float())
    assert torch.equal(hi, bank.blocks.float()) and not lo.any()
    e, f = out_spatial(h, h, r, r, stride, pad)
    mpad = bank.gbm * block[0]
    b = torch.zeros(mpad)
    b[:m] = torch.from_numpy(bias)
    args = (pad_in(torch.from_numpy(x), pad), bank.blocks, bank.blockcol,
            bank.nblocks, b)
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu,
              scale=bank.scale)
    want = bsr_conv_plain(*args, **kw)
    got = bsr_conv_split_plain(*args, **kw)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("bm", [8, 16, 32, 64])
@pytest.mark.parametrize("value_dtype", ("float32", "int8"))
def test_schedules_hold_whole_block_rows(bm, value_dtype):
    tiles = ops.bsr_tile_candidates(bm, 128, 14, 14, n=8, m=256, crs=2304,
                                    value_dtype=value_dtype)
    assert tiles and all(t % bm == 0 for t, _ in tiles)
    assert tiles == [(t, w) for t, w in budget.BSR_CONV_TILES if t % bm == 0]
    for t, w in tiles:
        assert budget.smem_fits(budget.bsr_conv_smem_bytes(
            bm, 128, t, 18, budget.value_itemsize(value_dtype)))
    sched, why = ops.resolve_bsr_schedule(bm, 128, 14, 14, n=8, m=256,
                                          crs=2304, n_tile=32,
                                          value_dtype=value_dtype)
    assert (sched is None) == (bm == 64)
    assert ops.resolve_bsr_schedule(128, 128, 7, 7)[1] == "unsupported_block"


def test_quantised_stages_are_smaller():
    f32 = budget.bsr_conv_smem_bytes(64, 128, 64, 36)
    q = budget.bsr_conv_smem_bytes(64, 128, 64, 36, 1)
    assert f32 - q == 2 * 64 * 128 * 3


def test_kernel_wrapper_pairs_scales_with_narrow_tiles():
    """The wrapper scales each channel's sum once (as the kernel does), the
    dequantised plain version each value before its product: every term
    differs by up to one f32 rounding of its |v*x|, and those do not cancel
    where the terms do.  So the bound scales with the summed terms'
    magnitude, sum |v*x|, not with |y| (over 2,000 seeds, 1e-5 x (1 + |y|)
    missed on 12 % of draws, by up to 2.3x; 1e-5 x (1 + sum |v*x|) held
    on all, by 17x)."""
    x, w, bias, _ = _inputs(CASES[0])
    _, bank = _banks(w, (32, 128), "int8")
    xp = pad_in(torch.from_numpy(x), 1)
    b = torch.zeros(bank.gbm * 32)
    kw = dict(rs=9, s=3, e=8, f=8)
    got = bsr_conv_kernel(xp, bank.blocks, bank.blockcol, bank.nblocks, b,
                          scale=bank.scale, **kw)
    dq = fmt.dequantize(bank).blocks
    want = bsr_conv_plain(xp, dq, bank.blockcol, bank.nblocks, b, **kw)
    mag = bsr_conv_plain(xp.abs(), dq.abs(), bank.blockcol, bank.nblocks, b,
                         **kw)
    assert bool(((got - want).abs() <= 1e-5 * (1 + mag)).all())
