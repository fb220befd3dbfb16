"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card and
skips without one.  On a machine with an H100::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The geometries cover what the main path gives the kernels and where they are
likeliest to go wrong: stride-2 1x1 layers, ragged spatial tiles (E*F not a
multiple of the pixel tile), M not a multiple of the channel tile or block
height, K longer than one staged slab, the fused residual tail, a balanced
bank, and BCSR right-padding columns past C*R*S.

Tolerances: the ELL kernel rounds each multiply and add as its plain version
does, in the same nonzero order, so it agrees to 1e-6; the BCSR kernel sums
up to C*R*S products in another order than the library contraction of its
plain version, so it is held to rtol = atol = 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.direct_conv import out_spatial, pad_in  # noqa: E402
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.core.sparse_format import (bcsr_conv_from_dense,  # noqa: E402
                                            ell_from_dense_conv)
from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel  # noqa: E402
from repro_torch.kernels.bsr_conv.ops import bsr_conv  # noqa: E402
from repro_torch.kernels.bsr_conv.ref import bsr_conv_blocked_ref  # noqa: E402
from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel  # noqa: E402
from repro_torch.kernels.sparse_conv.ops import (pack_indices,  # noqa: E402
                                                 resolve_schedule, sparse_conv)
from repro_torch.kernels.sparse_conv.ref import sparse_conv_plain  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(seed, n, c, h, m, r, sp):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    w = rng.standard_normal((m, c, r, r)).astype(np.float32)
    return x, magnitude_prune(w, sp), rng


# (N, C, H, M, R, stride, pad, sparsity, residual, relu)
ELL_CASES = [
    (2, 16, 12, 24, 3, 1, 1, 0.7, False, True),
    (2, 32, 15, 20, 1, 2, 0, 0.7, True, True),      # stride-2 1x1, M % tm
    (1, 64, 9, 16, 3, 1, 1, 0.3, True, False),      # K > one slab of 256
    (3, 8, 23, 12, 5, 1, 2, 0.6, False, True),      # 5x5 pad 2, ragged E*F
    (2, 12, 19, 8, 3, 2, 0, 0.5, True, True),       # stride 2 ragged
]


@pytest.mark.parametrize("case", ELL_CASES)
def test_sparse_conv_kernel_matches_plain(cuda_device, case):
    n, c, h, m, r, stride, pad, sp, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, sp)
    ell = ell_from_dense_conv(w, device=cuda_device)
    e, f = out_spatial(h, h, r, r, stride, pad)
    xt = torch.from_numpy(x).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, m, e, f)).astype(np.float32))
           .to(cuda_device) if with_res else None)
    sched, reason = resolve_schedule(m, ell.k, e, f)
    assert reason is None
    tm, tp, ks = sched
    args = (pad_in(xt, pad), ell.value, pack_indices(ell), ell.nnz, bias, res)
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu)
    before = sparse_conv_kernel.launches
    got = sparse_conv_kernel(*args, tm=tm, tp=tp, ks=ks, **kw)
    torch.cuda.synchronize()
    assert sparse_conv_kernel.launches == before + 1
    want = sparse_conv_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_sparse_conv_balanced_bank_on_card(cuda_device):
    x, w, rng = _case(3, 2, 16, 10, 24, 3, 0.8)
    xt = torch.from_numpy(x).to(cuda_device)
    res = torch.from_numpy(
        rng.standard_normal((2, 24, 10, 10)).astype(np.float32)).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32)).to(cuda_device)
    nat = ell_from_dense_conv(w, device=cuda_device)
    bal = ell_from_dense_conv(w, balance=True, device=cuda_device)
    kw = dict(padding=1, bias=bias, fuse_relu=True, residual=res)
    torch.testing.assert_close(sparse_conv(xt, bal, **kw),
                               sparse_conv(xt, nat, **kw), rtol=0, atol=0)


# (N, C, H, M, R, stride, pad, block, residual, relu)
BSR_CASES = [
    (2, 16, 12, 20, 3, 1, 1, (8, 128), True, True),    # M % bm, CRS % bn
    (2, 64, 14, 32, 1, 2, 0, (16, 128), False, True),  # stride-2 1x1
    (1, 24, 17, 64, 5, 1, 2, (8, 128), True, False),   # ragged E*F
    (2, 40, 9, 60, 3, 1, 1, (16, 128), False, True),   # M % bm
]


@pytest.mark.parametrize("case", BSR_CASES)
def test_bsr_conv_kernel_matches_plain(cuda_device, case):
    n, c, h, m, r, stride, pad, block, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, 0.6)
    bc = bcsr_conv_from_dense(w, block=block, device=cuda_device)
    e, f = out_spatial(h, h, r, r, stride, pad)
    xt = torch.from_numpy(x).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, m, e, f)).astype(np.float32))
           .to(cuda_device) if with_res else None)
    kw = dict(stride=stride, padding=pad, bias=bias, fuse_relu=relu,
              residual=res)
    before = bsr_conv_kernel.launches
    got = bsr_conv(xt, bc, **kw)
    torch.cuda.synchronize()
    assert bsr_conv_kernel.launches == before + 1
    want = bsr_conv_blocked_ref(xt, bc, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_refused_launch_raises(cuda_device):
    x, w, _ = _case(5, 1, 4, 8, 8, 3, 0.5)
    ell = ell_from_dense_conv(w, device=cuda_device)
    xt = pad_in(torch.from_numpy(x).to(cuda_device), 1)
    bias = torch.zeros(8, device=cuda_device)
    # 2048 threads exceed what a block may have: CUDA refuses the launch,
    # and the wrapper raises instead of returning an unwritten output.
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        sparse_conv_kernel(xt, ell.value, pack_indices(ell), ell.nnz, bias,
                           rs=9, s=3, e=8, f=8, tp=2048)
