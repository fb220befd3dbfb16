"""The ELL direct sparse conv on quantised (int8, e4m3) banks, against the
JAX package and against itself on the dequantised bank.

The same seeded numpy weights are quantised by both packages (bit for bit,
``test_torch_quantize.py``) and run through the reference's
``sparse_conv`` (its Pallas kernel in interpret mode, the scale operand
prefetched) and the port's (the kernel's plain version on CPU tensors):
within 1e-5 x max(1, max |y|), both forming each sum nonzero by nonzero in
f32.  The port's plain version on a quantised bank is bit for bit the plain
version on ``dequantize(bank)`` (each value times its row's scale, rounded
once, as the CUDA kernel decodes it), natural and nnz-balanced, 3x3-class
and 1x1; and the walk mirror, which decodes the kernel's 32-bit words
(offset above the value byte), is bit for bit both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.kernels.sparse_conv import ops as ref_ops  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.direct_conv import out_spatial, pad_in  # noqa: E402
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.kernels.sparse_conv import ops, ref  # noqa: E402
from repro_torch.kernels.sparse_conv.kernel import (QTYPES,  # noqa: E402
                                                    sparse_conv_kernel)

QUANT = ("int8", "float8_e4m3fn")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (N, C, H, M, R, stride, pad, sparsity, relu, residual, balance)
CASES = [
    (2, 8, 12, 16, 3, 1, 1, 0.7, True, False, False),
    (1, 16, 11, 8, 1, 2, 0, 0.6, True, True, False),    # stride-2 1x1 tail
    (1, 6, 10, 10, 5, 1, 2, 0.8, True, True, True),     # balanced, 5x5
    (2, 12, 9, 24, 3, 2, 1, 0.7, False, True, True),
    (2, 16, 7, 12, 1, 1, 0, 0.5, False, False, True),   # 1x1, balanced
]


def _inputs(case):
    n, c, h, m, r, stride, pad, sp, relu, with_res, balance = case
    rng = np.random.default_rng(sum(map(hash, map(str, case))) % 2**31)
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    w = magnitude_prune(rng.standard_normal((m, c, r, r)).astype(np.float32),
                        sp)
    e, f = out_spatial(h, h, r, r, stride, pad)
    bias = rng.standard_normal(m).astype(np.float32)
    res = (rng.standard_normal((n, m, e, f)).astype(np.float32)
           if with_res else None)
    return x, w, bias, res


@pytest.mark.parametrize("value_dtype", QUANT)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_quantised_sparse_conv_matches_reference(case, value_dtype):
    n, c, h, m, r, stride, pad, sp, relu, with_res, balance = case
    x, w, bias, res = _inputs(case)
    want = np.asarray(ref_ops.sparse_conv(
        jnp.asarray(x),
        ref_fmt.quantize_values(ref_fmt.ell_from_dense_conv(
            w, balance=balance), value_dtype),
        stride=stride, padding=pad, bias=jnp.asarray(bias), fuse_relu=relu,
        residual=None if res is None else jnp.asarray(res), interpret=True))
    bank = fmt.quantize_values(fmt.ell_from_dense_conv(
        w, balance=balance, device="cpu"), value_dtype)
    launches = sparse_conv_kernel.launches
    got = ops.sparse_conv(
        torch.from_numpy(x), bank, stride=stride, padding=pad,
        bias=torch.from_numpy(bias), fuse_relu=relu,
        residual=None if res is None else torch.from_numpy(res))
    assert sparse_conv_kernel.launches == launches   # the CPU runs no kernel
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("value_dtype", QUANT)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_quantised_plain_is_the_dequantised_plain_bit_for_bit(case,
                                                              value_dtype):
    n, c, h, m, r, stride, pad, sp, relu, with_res, balance = case
    x, w, bias, res = _inputs(case)
    q = fmt.quantize_values(fmt.ell_from_dense_conv(
        w, balance=balance, device="cpu"), value_dtype)
    d = fmt.dequantize(q)
    kw = dict(stride=stride, padding=pad, bias=torch.from_numpy(bias),
              fuse_relu=relu,
              residual=None if res is None else torch.from_numpy(res))
    xt = torch.from_numpy(x)
    yq = ops.sparse_conv(xt, q, **kw)
    torch.testing.assert_close(yq, ops.sparse_conv(xt, d, **kw), rtol=0,
                               atol=0)
    # the kernel's walk, decoding its words, both schedules
    e, f = out_spatial(h, h, r, r, stride, pad)
    xp = pad_in(xt, pad)
    b = torch.from_numpy(bias)
    rr = None if res is None else torch.from_numpy(res)
    if q.perm is not None:
        perm = q.perm.long()
        b = b.index_select(0, perm)
        rr = None if rr is None else rr.index_select(1, perm)
    for pipeline in (None, False):
        sched, why = ops.resolve_schedule(
            m, q.k, e, f, n=n, c=c, r=r, s=r, stride=stride,
            hp=xp.shape[2], wp=xp.shape[3], pipeline=pipeline)
        assert why is None
        walk = ref.sparse_conv_walk_plain(
            xp, q.value, ops.pack_indices(q), q.nnz, b, rr, rs=r * r, s=r,
            e=e, f=f, stride=stride, fuse_relu=relu, schedule=sched,
            scale=q.scale)
        if q.perm is not None:
            walk = walk.index_select(
                1, fmt.inverse_permutation(q.perm).long())
        torch.testing.assert_close(walk, yq, rtol=0, atol=0)


@pytest.mark.parametrize("value_dtype", QUANT)
def test_stretched_words_hold_offset_and_byte(value_dtype):
    """A quantised bank streams one 32-bit word a nonzero: the slab offset
    in words above the value's byte; an f32 bank (offset, value) pairs."""
    x, w, _, _ = _inputs(CASES[0])
    q = fmt.quantize_values(fmt.ell_from_dense_conv(w, device="cpu"),
                            value_dtype)
    d = fmt.dequantize(q)
    geo = dict(rs=9, s=3, ws=14, rows=10, cc=4, c=8)
    words, rowptr = ref.stretch_bank(q.value, ops.pack_indices(q), q.nnz,
                                     **geo)
    pairs, rowptr_f32 = ref.stretch_bank(d.value, ops.pack_indices(d), d.nnz,
                                         **geo)
    assert words.shape == q.value.shape and words.dtype == torch.int32
    assert pairs.shape == q.value.shape + (2,)
    torch.testing.assert_close(rowptr, rowptr_f32, rtol=0, atol=0)
    live = torch.arange(q.k)[None, :] < q.nnz[:, None]
    assert torch.equal((words.long() >> 8)[live],
                       (pairs[..., 0].long() // 4)[live])
    assert torch.equal((words & 0xFF).to(torch.uint8)[live],
                       q.value.view(torch.uint8)[live])
    off, val = ref.unstretch(words, q.value.dtype, q.scale)
    torch.testing.assert_close(val[live], d.value[live], rtol=0, atol=0)
    assert QTYPES[q.value.dtype] == (1 if value_dtype == "int8" else 2)


def test_word_offsets_past_the_limit_raise():
    q = fmt.quantize_values(fmt.ell_from_dense_conv(
        _inputs(CASES[1])[1], device="cpu"))
    with pytest.raises(ValueError, match="words"):
        ref.stretch_bank(q.value, ops.pack_indices(q), q.nnz, rs=1, s=1,
                         ws=ref.WORD_OFFSET_LIMIT, rows=1, cc=16, c=16)


def test_kernel_wrapper_takes_the_scale_with_a_narrow_bank():
    x, w, bias, _ = _inputs(CASES[0])
    q = fmt.quantize_values(fmt.ell_from_dense_conv(w, device="cpu"))
    xp = pad_in(torch.from_numpy(x), 1)
    args = (xp, q.value, ops.pack_indices(q), q.nnz, torch.from_numpy(bias))
    kw = dict(rs=9, s=3, e=12, f=12)
    got = sparse_conv_kernel(*args, scale=q.scale, **kw)
    want = ref.sparse_conv_plain(xp, fmt.dequantize(q).value, *args[2:],
                                 **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
