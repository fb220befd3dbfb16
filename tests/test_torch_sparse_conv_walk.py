"""The ELL kernel's walk (``ref.sparse_conv_walk_plain``) against its plain
version and the JAX package's Pallas kernel.

The walk mirrors the CUDA kernel's traversal on the CPU: pixel tiles flat
over (n, e, f), input slabs of a channel chunk staged per tile, one pointer
a row over its (c, r, s)-ordered nonzeros, offsets stretched into the
slab.  It forms each sum nonzero by nonzero in bank order with the multiply
and the add rounded separately, as ``sparse_conv_plain`` does, so the two
agree bit for bit; the reference's kernel (interpret mode, with the same
``pipeline`` schedule) sums in the same order, held to rtol = atol = 1e-5
as ``test_torch_sparse_conv.py`` holds the plain version.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.kernels.sparse_conv import ops as ref_ops  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.direct_conv import out_spatial, pad_in  # noqa: E402
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.sparse_conv import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (N, C, H, M, R, stride, pad, sparsity, residual, balance, pipeline, tp, cc)
CASES = [
    (2, 8, 12, 16, 3, 1, 1, 0.7, False, False, True, 64, 3),    # 3x3, chunks
    (3, 16, 11, 8, 1, 2, 0, 0.6, True, False, False, 32, 5),    # 1x1 stride 2
    (2, 6, 10, 10, 5, 1, 2, 0.8, True, True, True, 128, 2),     # 5x5, balanced
    (4, 12, 7, 24, 3, 1, 1, 0.7, False, False, False, 256, 4),  # tiles span images
    (2, 12, 9, 24, 3, 2, 1, 0.7, True, True, True, 32, 12),     # 3x3 stride 2
    (2, 32, 5, 16, 1, 1, 0, 0.5, True, False, None, 64, 7),     # 1x1, K > chunk
]


def _case(case):
    n, c, h, m, r, stride, pad, sp, with_res, balance, pipe, tp, cc = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    w = magnitude_prune(rng.standard_normal((m, c, r, r)).astype(np.float32),
                        sp)
    e, f = out_spatial(h, h, r, r, stride, pad)
    bias = rng.standard_normal(m).astype(np.float32)
    res = (rng.standard_normal((n, m, e, f)).astype(np.float32)
           if with_res else None)
    return x, w, bias, res, e, f


@pytest.mark.parametrize("case", CASES, ids=str)
def test_walk_is_the_plain_version_bit_for_bit(case):
    n, c, h, m, r, stride, pad, sp, with_res, balance, pipe, tp, cc = case
    x, w, bias, res, e, f = _case(case)
    ell = fmt.ell_from_dense_conv(w, balance=balance, device="cpu")
    sched, reason = ops.resolve_schedule(
        m, ell.k, e, f, n=n, c=c, r=r, s=r, stride=stride, hp=h + 2 * pad,
        wp=h + 2 * pad, tp=tp, pipeline=pipe)
    assert reason is None
    sched = dataclasses.replace(sched, cc=cc)
    args = (pad_in(torch.from_numpy(x), pad), ell.value,
            ops.pack_indices(ell), ell.nnz, torch.from_numpy(bias),
            None if res is None else torch.from_numpy(res))
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=True)
    got = ref.sparse_conv_walk_plain(*args, schedule=sched, **kw)
    want = ref.sparse_conv_plain(*args, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_walk_matches_reference_kernel(case):
    """The walk in bank order, un-permuted as ``ops.sparse_conv`` does,
    against the reference's ``sparse_conv`` with the same schedule."""
    n, c, h, m, r, stride, pad, sp, with_res, balance, pipe, tp, cc = case
    x, w, bias, res, e, f = _case(case)
    want = ref_ops.sparse_conv(
        jnp.asarray(x), ref_fmt.ell_from_dense_conv(w, balance=balance),
        stride=stride, padding=pad, bias=jnp.asarray(bias), fuse_relu=True,
        residual=None if res is None else jnp.asarray(res), pipeline=pipe,
        interpret=True)
    ell = fmt.ell_from_dense_conv(w, balance=balance, device="cpu")
    b, rs_ = torch.from_numpy(bias), None if res is None else torch.from_numpy(res)
    if ell.perm is not None:
        perm = ell.perm.long()
        b = b.index_select(0, perm)
        rs_ = None if rs_ is None else rs_.index_select(1, perm)
    sched, _ = ops.resolve_schedule(
        m, ell.k, e, f, n=n, c=c, r=r, s=r, stride=stride, hp=h + 2 * pad,
        wp=h + 2 * pad, tp=tp, pipeline=pipe)
    got = ref.sparse_conv_walk_plain(
        pad_in(torch.from_numpy(x), pad), ell.value, ops.pack_indices(ell),
        ell.nnz, b, rs_, rs=r * r, s=r, e=e, f=f, stride=stride,
        fuse_relu=True, schedule=dataclasses.replace(sched, cc=cc))
    if ell.perm is not None:
        got = got.index_select(1, fmt.inverse_permutation(ell.perm).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_walk_refuses_a_slab_taller_than_its_schedule():
    x, w, bias, _, e, f = _case(CASES[3])
    ell = fmt.ell_from_dense_conv(w, device="cpu")
    sched, _ = ops.resolve_schedule(24, ell.k, e, f, n=4, c=12, r=3, s=3,
                                    hp=9, wp=9, tp=256)
    with pytest.raises(ValueError, match="slab rows"):
        ref.sparse_conv_walk_plain(
            pad_in(torch.from_numpy(x), 1), ell.value, ops.pack_indices(ell),
            ell.nnz, torch.from_numpy(bias), rs=9, s=3, e=e, f=f,
            schedule=dataclasses.replace(sched, rows=sched.rows - 1))


def test_resolve_schedule_picks_the_copy_schedule():
    """``pipeline=None`` pipelines where two stages fit, ``False`` blocks,
    and both report it; the tile gives every SM a block where one can."""
    kw = dict(n=8, c=256, r=3, s=3, hp=16, wp=16)
    auto, _ = ops.resolve_schedule(256, 776, 14, 14, **kw)
    blocking, _ = ops.resolve_schedule(256, 776, 14, 14, pipeline=False, **kw)
    assert auto.pipeline and not blocking.pipeline
    # the same tile; the two stages of the pipeline share the slab budget
    assert (auto.tm, auto.tp, auto.rows) == (blocking.tm, blocking.tp,
                                             blocking.rows)
    assert blocking.cc in (2 * auto.cc, 2 * auto.cc + 1)
    blocks = -(-8 * 14 * 16 // auto.tp) * -(-256 // auto.tm)
    assert blocks >= budget.SMS
    assert budget.smem_fits(budget.ell_smem_bytes(
        auto.tm, auto.cc, 256, auto.rows, 16, 3, True))
    # at stride 1 the kernel's pixels run over the slab's 16 columns a row
    assert auto.rows == budget.ell_slab_rows(8, 14, 16, 16, 1, 3, auto.tp)


@pytest.mark.parametrize("tm, tp", [(8, 256), (16, 128), (32, 128),
                                    (32, 32), (8, 32)])
def test_resolve_schedule_takes_every_instantiated_tile(tm, tp):
    sched, reason = ops.resolve_schedule(64, 96, 14, 14, n=2, c=32, r=3,
                                         s=3, hp=16, wp=16, tm=tm, tp=tp)
    assert reason is None and (sched.tm, sched.tp) == (tm, tp)
    assert (tm, tp // 32) in budget.ELL_TILES


@pytest.mark.parametrize("pinned, reason", [
    (dict(tm=16, tp=256), "unsupported_tp"), (dict(tm=4), "unsupported_tm")])
def test_resolve_schedule_rejects_tiles_the_source_lacks(pinned, reason):
    assert ops.resolve_schedule(64, 96, 14, 14, **pinned) == (None, reason)


def test_strided_1x1_slab_is_the_sampled_pixels():
    """A strided 1x1 conv stages only the pixels it reads: its slab image is
    the output's (e, f), at stride 1."""
    assert ops.slab_geometry(56, 56, 1, 1, 28, 28, 2) == (28, 28, 1)
    assert ops.slab_geometry(16, 16, 3, 3, 14, 14, 1) == (16, 16, 1)
    assert ops.slab_geometry(9, 9, 3, 3, 4, 4, 2) == (9, 9, 2)
