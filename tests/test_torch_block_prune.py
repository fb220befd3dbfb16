"""The port's block pruning and BCSR converters against the JAX package's.

``block_prune`` repeats the reference's tile scoring and its f32 quantile;
its kept mask and its values must equal the reference's.  ``bcsr_from_dense``
(host path from numpy, device path from a tensor) and
``bcsr_stack_from_dense`` must give the reference's arrays bit for bit:
same dtype, same shape, same bits.  Shapes include ones that need padding
to the block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402

# (M, N, block, sparsity): smoke projection shapes, ragged ones, Yi-9B-like
# aspect ratios at small scale.
CASES = [
    (64, 128, (16, 16), 0.8),
    (128, 64, (16, 16), 0.8),
    (64, 64, (16, 16), 0.5),
    (100, 72, (16, 16), 0.8),      # pads both dims
    (37, 150, (8, 32), 0.6),
    (96, 176, (16, 128), 0.7),     # pads N to 256
    (256, 64, (32, 16), 0.9),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


def _weight(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_block_prune_matches_reference(case):
    m, n, block, sp = case
    for seed in range(3):
        w = _weight(m, n, seed)
        want = np.asarray(ref_pruning.block_prune(jnp.asarray(w), sp, block))
        got = pruning.block_prune(torch.from_numpy(w), sp, block)
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
        differ = int(((got.numpy() != 0) != (want != 0)).sum())
        assert differ == 0, f"{differ} mask entries differ"
        _same(got, want, "pruned weight")


def test_block_prune_keeps_the_dtype_and_zero_sparsity():
    w = torch.from_numpy(_weight(64, 96, 4)).to(torch.bfloat16)
    assert pruning.block_prune(w, 0.0, (16, 16)) is w
    got = pruning.block_prune(w, 0.75, (16, 16))
    assert got.dtype == torch.bfloat16
    tiles = (got != 0).reshape(4, 16, 6, 16).any(3).any(1)
    assert int(tiles.sum()) == 6  # 24 tiles, the top quarter kept


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bcsr_from_dense_device_path_bit_identical(case):
    m, n, block, sp = case
    w = np.array(ref_pruning.block_prune(jnp.asarray(_weight(m, n, 7)), sp,
                                           block))
    want = ref_fmt.bcsr_from_dense(w, block)
    host = fmt.bcsr_from_dense(w, block, device="cpu")
    dev = fmt.bcsr_from_dense(torch.from_numpy(w), block)
    for name in ("blocks", "blockcol", "nblocks"):
        _same(getattr(host, name), getattr(want, name), f"host {name}")
        _same(getattr(dev, name), getattr(want, name), f"device {name}")
    assert dev.shape == host.shape == tuple(want.shape)
    assert dev.block == tuple(want.block)


def test_bcsr_from_dense_device_path_keeps_dtype_and_pad_to():
    w = _weight(48, 80, 9)
    w[:16] = 0.0                   # an empty block-row
    bf = torch.from_numpy(w).to(torch.bfloat16)
    got = fmt.bcsr_from_dense(bf, (16, 16), pad_to=4)
    want = fmt.bcsr_from_dense(bf.float().numpy(), (16, 16), pad_to=4,
                               device="cpu")
    assert got.blocks.dtype == torch.bfloat16 and got.kb % 4 == 0
    torch.testing.assert_close(got.blocks.float(), want.blocks, rtol=0, atol=0)
    assert torch.equal(got.blockcol, want.blockcol)
    assert torch.equal(got.nblocks, want.nblocks)
    assert int(got.nblocks[0]) == 0


@pytest.mark.parametrize("shape, block", [((3, 64, 128), (16, 16)),
                                          ((4, 100, 72), (16, 16)),
                                          ((2, 96, 176), (16, 128))])
def test_bcsr_stack_from_dense_bit_identical(shape, block):
    rng = np.random.default_rng(shape[1])
    w3 = np.stack([np.asarray(ref_pruning.block_prune(
        jnp.asarray(rng.standard_normal(shape[1:]).astype(np.float32)),
        0.3 + 0.2 * i, block)) for i in range(shape[0])])
    want = ref_fmt.bcsr_stack_from_dense(w3, block)
    for src in (w3, torch.from_numpy(w3)):
        got = fmt.bcsr_stack_from_dense(src, block, device="cpu")
        for name in ("blocks", "blockcol", "nblocks"):
            _same(getattr(got, name), getattr(want, name), name)
        assert got.shape == tuple(want.shape)
