"""The port's sparse formats and pruning against the JAX package's.

Built from the same dense weights, every array of the port's ELL and BCSR
formats must be bit-identical to the reference's: same dtype, same shape,
same bits.  The port's ``magnitude_prune`` repeats ``jnp.quantile``'s f32
interpolation; its mask must agree with the reference's entry for entry
(across the cases below no entry differs, ties included).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402

CONV_SHAPES = [(8, 4, 3, 3), (16, 8, 1, 1), (5, 3, 5, 5), (12, 16, 3, 3),
               (7, 2, 11, 11)]


def _same(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


def _weights(shape, sparsity, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(ref_pruning.magnitude_prune(jnp.asarray(w), sparsity))


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("sparsity", [0.0, 0.6, 0.95])
@pytest.mark.parametrize("pad_to", [1, 8])
def test_ell_from_dense_conv_bit_identical(shape, sparsity, pad_to):
    w = _weights(shape, sparsity, seed=len(shape) + shape[0])
    want = ref_fmt.ell_from_dense_conv(w, pad_to=pad_to)
    got = fmt.ell_from_dense_conv(w, pad_to=pad_to, device="cpu")
    assert got.shape == want.shape and got.k == want.k
    for name in ("value", "cidx", "ridx", "sidx", "offset", "nnz"):
        _same(getattr(got, name), getattr(want, name), name)
    assert got.perm is None and want.perm is None


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_balance_ell_conv_bit_identical(shape):
    w = _weights(shape, 0.7, seed=3)
    want = ref_fmt.ell_from_dense_conv(w, balance=True)
    got = fmt.ell_from_dense_conv(w, balance=True, device="cpu")
    for name in ("value", "cidx", "ridx", "sidx", "offset", "nnz", "perm"):
        _same(getattr(got, name), getattr(want, name), name)
    _same(fmt.inverse_permutation(got.perm),
          ref_fmt.inverse_permutation(want.perm), "inverse_permutation")
    # balancing a balanced bank composes the permutations, as the reference
    _same(fmt.balance_ell_conv(got).perm,
          ref_fmt.balance_ell_conv(want).perm, "perm twice")


def test_all_zero_bank_keeps_one_padded_column():
    w = np.zeros((4, 3, 3, 3), np.float32)
    got = fmt.ell_from_dense_conv(w, device="cpu")
    want = ref_fmt.ell_from_dense_conv(w)
    assert got.k == want.k == 8
    _same(got.nnz, want.nnz, "nnz")
    bc = fmt.bcsr_conv_from_dense(w, device="cpu")
    assert bc.kb == 1 and int(bc.nblocks.sum()) == 0


@pytest.mark.parametrize("shape", [(10, 30), (64, 64), (3, 200)])
@pytest.mark.parametrize("sparsity", [0.0, 0.8])
def test_ell_from_dense_bit_identical(shape, sparsity):
    w = _weights(shape, sparsity, seed=shape[1])
    want = ref_fmt.ell_from_dense(w)
    got = fmt.ell_from_dense(w, device="cpu")
    assert got.shape == want.shape
    for name in ("value", "colidx", "nnz"):
        _same(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("block", [(8, 128), (16, 128), (4, 8), (3, 5)])
@pytest.mark.parametrize("pad_to", [1, 4])
def test_bcsr_from_dense_bit_identical(block, pad_to):
    w = _weights((37, 150), 0.9, seed=block[0])
    want = ref_fmt.bcsr_from_dense(w, block, pad_to=pad_to)
    got = fmt.bcsr_from_dense(w, block, pad_to=pad_to, device="cpu")
    for name in ("blocks", "blockcol", "nblocks"):
        _same(getattr(got, name), getattr(want, name), name)
    np.testing.assert_array_equal(fmt.bcsr_to_dense(got).numpy(), w)


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("block", [(8, 128), (16, 128), (4, 16)])
def test_bcsr_conv_from_dense_bit_identical(shape, block):
    w = _weights(shape, 0.7, seed=shape[1])
    want = ref_fmt.bcsr_conv_from_dense(w, block)
    got = fmt.bcsr_conv_from_dense(w, block, device="cpu")
    assert got.shape == want.shape and got.block == want.block
    for name in ("blocks", "blockcol", "nblocks"):
        _same(getattr(got, name), getattr(want, name), name)
    _same(fmt.bcsr_conv_to_dense(got), ref_fmt.bcsr_conv_to_dense(want),
          "to_dense")
    np.testing.assert_array_equal(fmt.bcsr_conv_to_dense(got).numpy(), w)


@pytest.mark.parametrize("shape", [(8, 4, 3, 3), (64, 32, 3, 3),
                                   (33, 7, 5, 5), (256, 128, 1, 1)])
@pytest.mark.parametrize("sparsity", [0.3, 0.62, 0.7, 0.9])
def test_magnitude_prune_mask_matches_reference(shape, sparsity):
    for seed in range(4):
        w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        want = np.asarray(ref_pruning.magnitude_prune(jnp.asarray(w), sparsity))
        got = pruning.magnitude_prune(w, sparsity)
        assert got.dtype == np.float32
        differ = int(((got != 0) != (want != 0)).sum())
        assert differ == 0, f"{differ} mask entries differ"
        np.testing.assert_array_equal(got, want)


def test_magnitude_prune_ties_and_zero_sparsity():
    w = np.array([[0.5, -0.5, 0.5, 1.0], [0.25, -0.25, 2.0, 0.5]], np.float32)
    for sp in (0.25, 0.5, 0.75):
        want = np.asarray(ref_pruning.magnitude_prune(jnp.asarray(w), sp))
        np.testing.assert_array_equal(pruning.magnitude_prune(w, sp), want)
    assert pruning.magnitude_prune(w, 0.0) is w
