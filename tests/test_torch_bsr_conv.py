"""The port's BCSR conv against the JAX package.

The same numpy inputs go through the reference's ``bsr_conv`` (its Pallas
kernel in interpret mode) and the port's ``bsr_conv`` on CPU tensors (the
kernel's plain version), with the (8, 128) and (16, 128) blocks and M not a
multiple of bm.  Both contract each tile in f32; the summation order inside
a tile differs, so they are held to rtol = atol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.kernels.bsr_conv import ops as ref_ops  # noqa: E402
from repro.kernels.bsr_conv import ref as ref_ref  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.direct_conv import out_spatial  # noqa: E402
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.kernels.bsr_conv import ops, ref  # noqa: E402
from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


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
    (2, 8, 10, 16, 3, 1, 1, (8, 128), True, False),
    (1, 16, 11, 20, 1, 2, 0, (8, 128), True, True),    # stride-2 1x1, M % 8
    (1, 6, 9, 12, 5, 1, 2, (16, 128), False, True),    # M < bm, 5x5
    (1, 12, 12, 40, 3, 4, 2, (16, 128), True, True),   # M % 16, stride 4
]


def _inputs(case):
    n, c, h, m, r, stride, pad, block, relu, with_res = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    wt = magnitude_prune(rng.standard_normal((m, c, r, r)).astype(np.float32),
                         0.6)
    e, f = out_spatial(h, h, r, r, stride, pad)
    bias = rng.standard_normal(m).astype(np.float32)
    res = (rng.standard_normal((n, m, e, f)).astype(np.float32)
           if with_res else None)
    return x, wt, bias, res


@pytest.mark.parametrize("case", CASES)
def test_bsr_conv_matches_reference(case):
    n, c, h, m, r, stride, pad, block, relu, with_res = case
    x, wt, bias, res = _inputs(case)
    kw = dict(stride=stride, padding=pad, fuse_relu=relu)
    want = ref_ops.bsr_conv(
        jnp.asarray(x), ref_fmt.bcsr_conv_from_dense(wt, block),
        bias=jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), interpret=True,
        **kw)
    launches = bsr_conv_kernel.launches
    got = ops.bsr_conv(
        torch.from_numpy(x), fmt.bcsr_conv_from_dense(wt, block, device="cpu"),
        bias=torch.from_numpy(bias),
        residual=None if res is None else torch.from_numpy(res), **kw)
    assert bsr_conv_kernel.launches == launches
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES[:3])
def test_blocked_ref_matches_reference_mirror(case):
    n, c, h, m, r, stride, pad, block, relu, with_res = case
    x, wt, bias, res = _inputs(case)
    kw = dict(stride=stride, padding=pad, fuse_relu=relu)
    want = ref_ref.bsr_conv_blocked_ref(
        jnp.asarray(x), ref_fmt.bcsr_conv_from_dense(wt, block),
        bias=jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), **kw)
    got = ref.bsr_conv_blocked_ref(
        torch.from_numpy(x), fmt.bcsr_conv_from_dense(wt, block, device="cpu"),
        bias=torch.from_numpy(bias),
        residual=None if res is None else torch.from_numpy(res), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_right_padding_columns_clamp_their_channel():
    """C*R*S = 27 is far from a multiple of bn = 128: the padding columns'
    channel decodes past C and must clamp (their weights are zero)."""
    case = (1, 3, 8, 8, 3, 1, 1, (8, 128), False, False)
    x, wt, bias, _ = _inputs(case)
    got = ops.bsr_conv(torch.from_numpy(x),
                       fmt.bcsr_conv_from_dense(wt, (8, 128), device="cpu"),
                       padding=1)
    want = torch.nn.functional.conv2d(torch.from_numpy(x),
                                      torch.from_numpy(wt), padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("block, reason", [((12, 128), "unsupported_block"),
                                           ((16, 4096), "smem_infeasible")])
def test_resolve_bsr_schedule_rejects(block, reason):
    assert ops.resolve_bsr_schedule(*block, 14, 14) == (None, reason)


def test_bsr_conv_raises_instead_of_falling_back():
    x, wt, _, _ = _inputs(CASES[0])
    bc = fmt.bcsr_conv_from_dense(wt, (4, 8), device="cpu")
    with pytest.raises(ValueError, match="unsupported_block"):
        ops.bsr_conv(torch.from_numpy(x), bc, padding=1, layer="conv2")
