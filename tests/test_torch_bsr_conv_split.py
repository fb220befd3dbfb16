"""The BCSR conv kernel's split arithmetic (``ref.bsr_conv_split_plain``)
against the JAX package's Pallas kernel, and through whole networks.

The CUDA kernel runs its products on the tensor cores in TF32 with both f32
operands split into hi = tf32(v) and lo = tf32(v - hi) halves, three
products x_hi w_hi + x_hi w_lo + x_lo w_hi summed in f32; the plain mirror
computes exactly those products.  The stated tolerances are the card's:
``chip_smoke.py``'s 1e-4 x (1 + max |y|) of the f32 result, and the card
test's elementwise rtol = atol = 1e-4.  The split keeps about 21 bits of
each operand and stays within both; one product on operands rounded once
to TF32 keeps 11 and must fail the first.
Through AlexNet and ResNet-50 at the test sizes the split mirror must
agree with ``dense`` within 1e-4 x max(1, max |dense|), the agreement the
card's path check asks of every kernel method.
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
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.bsr_conv import kernel as bk  # noqa: E402
from repro_torch.kernels.bsr_conv import ops, ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

BSR_TOL = 1e-4      # x (1 + max |y|)
PATH_RTOL = 1e-4    # x max(1, max |dense|)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (N, C, H, M, R, stride, pad, block, residual)
CASES = [
    (2, 16, 10, 16, 3, 1, 1, (8, 128), False),
    (1, 64, 11, 20, 1, 2, 0, (8, 128), True),     # stride-2 1x1, M % 8
    (1, 12, 9, 24, 5, 1, 2, (16, 128), True),     # 5x5, M % 16
    (2, 32, 7, 40, 3, 1, 1, (16, 128), False),    # 49 pixels an image
]


def _case(case):
    n, c, h, m, r, stride, pad, block, with_res = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    w = magnitude_prune(rng.standard_normal((m, c, r, r)).astype(np.float32),
                        0.6)
    e, f = out_spatial(h, h, r, r, stride, pad)
    bias = rng.standard_normal(m).astype(np.float32)
    res = (rng.standard_normal((n, m, e, f)).astype(np.float32)
           if with_res else None)
    return x, w, bias, res, e, f


def _split(case, lo):
    """The split mirror on the kernel's operands, sliced to M."""
    n, c, h, m, r, stride, pad, block, with_res = case
    x, w, bias, res, e, f = _case(case)
    bc = fmt.bcsr_conv_from_dense(w, block, device="cpu")
    mpad = bc.blocks.shape[0] * block[0]
    b = torch.zeros(mpad)
    b[:m] = torch.from_numpy(bias)
    rp = None
    if res is not None:
        rp = torch.zeros((n, mpad, e, f))
        rp[:, :m] = torch.from_numpy(res)
    out = ref.bsr_conv_split_plain(
        pad_in(torch.from_numpy(x), pad), bc.blocks, bc.blockcol, bc.nblocks,
        b, rp, rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=True, lo=lo)
    return out[:, :m].numpy()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_mirror_matches_reference_kernel_and_control_fails(case):
    n, c, h, m, r, stride, pad, block, with_res = case
    x, w, bias, res, e, f = _case(case)
    want = np.asarray(ref_ops.bsr_conv(
        jnp.asarray(x), ref_fmt.bcsr_conv_from_dense(w, block),
        stride=stride, padding=pad, bias=jnp.asarray(bias), fuse_relu=True,
        residual=None if res is None else jnp.asarray(res), interpret=True))
    limit = BSR_TOL * (1 + float(np.abs(want).max()))
    got = _split(case, True)
    assert float(np.abs(got - want).max()) <= limit
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert float(np.abs(_split(case, False) - want).max()) > limit


def test_split_weights_are_the_mirrors_halves():
    """The wrapper's TF32 halves are what the mirror splits the tiles into:
    f32 values with 10 mantissa bits, whose sum holds about 21 bits of each
    weight; TF32 rounds to nearest, ties away from zero."""
    _, w, _, _, _, _ = _case(CASES[0])
    bc = fmt.bcsr_conv_from_dense(w, (8, 128), device="cpu")
    hi, lo = bk.split_weights(bc.blocks)
    want_hi, want_lo = ref.split_tf32(bc.blocks)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi + lo - bc.blocks).abs()
    assert float((err - 2.0 ** -21 * bc.blocks.abs()).max()) <= 0.0
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert ref.round_tf32(ties).tolist() == [1.0 + 2.0 ** -10,
                                             -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("net, image", [("alexnet", 67), ("resnet50", 48)])
def test_split_mirror_through_a_network_matches_dense(net, image,
                                                      monkeypatch):
    """Every sparse layer through the kernel's split arithmetic (the CPU
    branch of the launcher pointed at the mirror): the logits agree with
    ``dense`` as the card's path check asks, over all the layers."""
    params = cnn.init_cnn(cnn.NETWORKS[net](), 3, np.random.default_rng(0),
                          image, device="cpu")
    x = (np.random.default_rng(1)
         .standard_normal((2, 3, image, image)).astype(np.float32))
    want = cnn.cnn_forward(cnn.NETWORKS[net](), params, x, "dense",
                           device="cpu")
    monkeypatch.setattr(bk, "bsr_conv_plain", ref.bsr_conv_split_plain)
    got = cnn.cnn_forward(cnn.NETWORKS[net](), params, x, "bsr",
                          device="cpu")
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= PATH_RTOL * scale


@pytest.mark.parametrize("pins, want", [
    (dict(n_tile=64, wgs=2), (64, 2)), (dict(n_tile=64), (64, 1)),
    (dict(wgs=2), (32, 2)), (dict(n_tile=32, wgs=1), (32, 1))])
def test_resolve_bsr_schedule_takes_pinned_tiles(pins, want):
    assert ops.resolve_bsr_schedule(8, 128, 14, 14, n=8, m=256, crs=2304,
                                    **pins) == (want, None)


def test_resolve_bsr_schedule_fills_the_card():
    """Unpinned, the largest tile whose blocks still give every SM one."""
    (n_tile, wgs), _ = ops.resolve_bsr_schedule(8, 128, 14, 14, n=8,
                                                m=1024, crs=256)
    assert (n_tile, wgs) == (64, 2)
    assert -(-8 * 196 // (64 * wgs)) * (1024 // n_tile) >= budget.SMS
    (n_tile, wgs), _ = ops.resolve_bsr_schedule(8, 128, 7, 7, n=8, m=512,
                                                crs=4608)
    assert (n_tile, wgs) == (32, 1)   # the smallest: too few pixels for more


@pytest.mark.parametrize("pins, reason", [
    (dict(n_tile=128), "unsupported_tile"), (dict(wgs=4), "unsupported_tile")])
def test_resolve_bsr_schedule_rejects_tiles_the_source_lacks(pins, reason):
    assert ops.resolve_bsr_schedule(8, 128, 14, 14, **pins) == (None, reason)
