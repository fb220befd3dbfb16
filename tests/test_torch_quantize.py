"""The port's quantised value streams and block pruning against the JAX
package.

The same seeded numpy weights go through the reference's
``quantize_values`` / ``dequantize`` and the port's: the int8 and e4m3
values (compared as bytes) and the f32 scales must agree bit for bit, for
ELL banks in natural and nnz-balanced order and for BCSR banks at every
block height of the autotuner's ladder.  ``block_prune_conv`` must give
the reference's kept mask.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.core.types import SparsityConfig as RefSparsityConfig  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.types import SparsityConfig  # noqa: E402
from repro_torch.kernels.bsr_conv.ops import BLOCK_CANDIDATES  # noqa: E402
from repro_torch.kernels.sparse_conv.ref import e4m3_to_f32  # noqa: E402

QUANT = ("int8", "float8_e4m3fn")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed, m=24, c=10, r=3, sp=0.7, zero_row=True):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, c, r, r)).astype(np.float32)
    w = w * (np.abs(w) > np.quantile(np.abs(w), sp))
    if zero_row:
        w[3] = 0.0   # an all-zero channel: scale 1, exact zeros
    return w.astype(np.float32)


def _bytes_np(a):
    return np.asarray(a).view(np.uint8)


def _bytes_torch(t):
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("value_dtype", QUANT)
@pytest.mark.parametrize("balance", [False, True])
def test_ell_quantize_bit_for_bit(value_dtype, balance):
    w = _weights(1)
    want = ref_fmt.quantize_values(
        ref_fmt.ell_from_dense_conv(w, balance=balance), value_dtype)
    got = fmt.quantize_values(
        fmt.ell_from_dense_conv(w, balance=balance, device="cpu"),
        value_dtype)
    assert got.value_dtype == want.value_dtype == value_dtype
    np.testing.assert_array_equal(_bytes_torch(got.value),
                                  _bytes_np(want.value))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[(got.perm == 3).nonzero() if balance else 3].item() \
        == 1.0
    if balance:
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(
        fmt.dequantize(got).value.numpy(),
        np.asarray(ref_fmt.dequantize(want).value))


@pytest.mark.parametrize("value_dtype", QUANT)
def test_balancing_a_quantised_bank_moves_its_scales(value_dtype):
    """A permuted bank's scales follow its rows, in either order of
    quantising and balancing (reference ``balance_ell_conv``)."""
    w = _weights(2, zero_row=False)
    want = ref_fmt.balance_ell_conv(ref_fmt.quantize_values(
        ref_fmt.ell_from_dense_conv(w), value_dtype))
    got = fmt.balance_ell_conv(fmt.quantize_values(
        fmt.ell_from_dense_conv(w, device="cpu"), value_dtype))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(_bytes_torch(got.value),
                                  _bytes_np(want.value))
    other = fmt.quantize_values(
        fmt.ell_from_dense_conv(w, balance=True, device="cpu"), value_dtype)
    np.testing.assert_array_equal(other.scale.numpy(), got.scale.numpy())


@pytest.mark.parametrize("value_dtype", QUANT)
@pytest.mark.parametrize("block", BLOCK_CANDIDATES)
def test_bcsr_quantize_bit_for_bit(value_dtype, block):
    w = _weights(3, m=70, c=20)
    want = ref_fmt.quantize_values(
        ref_fmt.bcsr_conv_from_dense(w, block=block), value_dtype)
    got = fmt.quantize_values(
        fmt.bcsr_conv_from_dense(w, block=block, device="cpu"), value_dtype)
    assert tuple(got.scale.shape) == (got.gbm, block[0])
    np.testing.assert_array_equal(_bytes_torch(got.blocks),
                                  _bytes_np(want.blocks))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        fmt.bcsr_conv_to_dense(got).numpy(),
        np.asarray(ref_fmt.bcsr_conv_to_dense(want)))


def test_quantize_refuses_twice_and_unknown_dtypes():
    ell = fmt.quantize_values(fmt.ell_from_dense_conv(_weights(4),
                                                      device="cpu"))
    with pytest.raises(ValueError, match="already quantised"):
        fmt.quantize_values(ell)
    with pytest.raises(ValueError, match="unsupported quantised"):
        fmt.quantize_values(fmt.ell_from_dense_conv(_weights(4),
                                                    device="cpu"), "int4")
    assert fmt.dequantize(fmt.dequantize(ell)).scale is None


def test_e4m3_decoder_is_the_dtype_cast():
    """The kernels decode e4m3 bytes by their bit fields; every finite byte
    decodes to what the dtype's own cast gives."""
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = b.view(torch.float8_e4m3fn).float()
    finite = torch.isfinite(want)
    torch.testing.assert_close(e4m3_to_f32(b)[finite], want[finite],
                               rtol=0, atol=0)


@pytest.mark.parametrize("block", [(8, 128), (32, 128), (64, 128), (16, 16)])
@pytest.mark.parametrize("sp", [0.5, 0.8])
def test_block_prune_conv_matches_reference_mask(block, sp):
    w = np.random.default_rng(5).standard_normal((96, 24, 3, 3)).astype(
        np.float32)
    want = np.asarray(ref_pruning.block_prune_conv(jnp.asarray(w), sp, block))
    got = pruning.block_prune_conv(w, sp, block)
    assert isinstance(got, np.ndarray) and got.shape == w.shape
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(got, want)
    t = pruning.block_prune_conv(torch.from_numpy(w), sp, block)
    np.testing.assert_array_equal(t.numpy(), got)


def test_prune_dispatches_as_the_reference():
    w = np.random.default_rng(6).standard_normal((32, 8, 3, 3)).astype(
        np.float32)
    for method, block in (("bcsr-mxu", (8, 128)), ("csr-direct", (8, 128))):
        cfg = SparsityConfig(sparsity=0.6, method=method, block=block,
                             enabled=True)
        ref_cfg = RefSparsityConfig(sparsity=0.6, method=method, block=block,
                                    enabled=True)
        want = np.asarray(ref_pruning.prune(jnp.asarray(w), ref_cfg))
        np.testing.assert_array_equal(pruning.prune(w, cfg) != 0, want != 0)
    off = SparsityConfig(sparsity=0.6, method="bcsr-mxu", enabled=False)
    assert pruning.prune(w, off) is w
