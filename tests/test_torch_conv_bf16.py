"""The two conv kernels' ops on bf16 activations, against the JAX package.

The reference's own bf16 cases (``test_kernels_sparse_conv.py``'s
``test_kernel_dtypes``, ``test_strided_bf16`` and
``test_fused_epilogue_parity_bf16``; ``test_kernels_bsr_conv.py``'s
``test_bsr_parity_bf16``), their inputs drawn as the reference draws them,
go through the reference's ``sparse_conv`` / ``bsr_conv`` (its Pallas
kernels in interpret mode) and the port's (the kernels' plain versions on
CPU tensors).  Both return bf16 and both round an f32 sum once; the sums
are taken in different orders (the reference's in its kernel's, the port's
in its CUDA kernel's), which can move a result across a bf16 rounding
boundary.  So each element is held within one bf16 ulp of the reference:
|got - ref| <= 2^-7 |ref| + 2^-8 max(1, max |ref|) (2^-7 is bf16's
relative spacing, the absolute term covers results near zero).

The ELL kernel's structural mirror at bf16 (bf16 slabs, the schedule
resolved at 2 bytes an element) is bit for bit the f32 mirror on the
exactly widened input, rounded once: staging at half the bytes changes the
chunks, not a sum.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import block_prune_conv as ref_block_prune  # noqa: E402
from repro.core import magnitude_prune as ref_magnitude_prune  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.kernels.bsr_conv import ops as ref_bsr_ops  # noqa: E402
from repro.kernels.sparse_conv import ops as ref_ops  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.direct_conv import out_spatial, pad_in  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.bsr_conv import ops as bsr_ops  # noqa: E402
from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel  # noqa: E402
from repro_torch.kernels.sparse_conv import ops  # noqa: E402
from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel  # noqa: E402
from repro_torch.kernels.sparse_conv.ref import (  # noqa: E402
    slab_width, sparse_conv_plain, sparse_conv_walk_plain)

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    """A reference bf16 (or f32) array as the same values in torch."""
    a = np.asarray(a)
    dt = BF16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(a, np.float32)).to(dt)


def within_one_ulp(got: torch.Tensor, want) -> None:
    assert got.dtype == BF16
    want = np.asarray(want, np.float32)
    g = got.float().numpy()
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * max(1.0, np.abs(want).max())
    bad = np.abs(g - want) > tol
    assert not bad.any(), (int(bad.sum()), float(np.abs(g - want).max()))


def _ell_pair(wt: np.ndarray, value_dtype=None):
    """The reference's and the port's ELL banks of ``wt`` with bf16 values
    (the reference's tests cast ``ell.value``), or quantised."""
    want = ref_fmt.ell_from_dense_conv(wt.astype(np.float32))
    got = fmt.ell_from_dense_conv(wt.astype(np.float32), device="cpu")
    if value_dtype is None:
        want = dataclasses.replace(want, value=want.value.astype(jnp.bfloat16))
        got = dataclasses.replace(got, value=got.value.to(BF16))
    else:
        want = ref_fmt.quantize_values(want, value_dtype)
        got = fmt.quantize_values(got, value_dtype)
    return want, got


# ---------------------------------------------------------------------------
# ELL: the reference's bf16 cases
# ---------------------------------------------------------------------------

def _dtypes_case():
    """test_kernel_dtypes[bfloat16]: (2, 4, 10, 10), 8 filters 3x3 at 0.8,
    padding 1."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 4, 10, 10)), dtype=jnp.bfloat16)
    wt = np.asarray(ref_magnitude_prune(jnp.asarray(
        rng.standard_normal((8, 4, 3, 3)).astype(np.float32)), 0.8))
    return x, wt, dict(padding=1)


def _strided_case(stride):
    """test_strided_bf16: (1, 4, 12, 12) at stride 2 or 4, padding 1."""
    rng = np.random.default_rng(23 + stride)
    x = jnp.asarray(rng.standard_normal((1, 4, 12, 12)), dtype=jnp.bfloat16)
    wt = np.asarray(ref_magnitude_prune(jnp.asarray(
        rng.standard_normal((8, 4, 3, 3)).astype(np.float32)), 0.8))
    return x, wt, dict(stride=stride, padding=1)


def _epilogue_case(stride, residual):
    """test_fused_epilogue_parity_bf16: bias, ReLU and a bf16 residual."""
    n, c, h, w, m, r, pad = 1, 4, 12, 12, 8, 3, 1
    rng = np.random.default_rng(2000 + 10 * stride + residual)
    x = jnp.asarray(rng.standard_normal((n, c, h, w)), dtype=jnp.bfloat16)
    wt = np.asarray(ref_magnitude_prune(jnp.asarray(
        rng.standard_normal((m, c, r, r)).astype(np.float32)), 0.8))
    bias = jnp.asarray(rng.standard_normal((m,)).astype(np.float32))
    e, f = out_spatial(h, w, r, r, stride, pad)
    res = (jnp.asarray(rng.standard_normal((n, m, e, f)), dtype=jnp.bfloat16)
           if residual else None)
    return x, wt, dict(stride=stride, padding=pad, bias=bias, fuse_relu=True,
                       residual=res)


ELL_CASES = ([("dtypes", _dtypes_case)]
             + [(f"strided{s}", lambda s=s: _strided_case(s)) for s in (2, 4)]
             + [(f"epilogue_s{s}_res{int(r)}",
                 lambda s=s, r=r: _epilogue_case(s, r))
                for s in (1, 2) for r in (False, True)])


def _port_kw(kw):
    return {k: (_t(v) if k in ("bias", "residual") and v is not None else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("name, make", ELL_CASES, ids=[c[0] for c in ELL_CASES])
def test_sparse_conv_bf16_matches_reference(name, make):
    x, wt, kw = make()
    ref_bank, bank = _ell_pair(wt)
    want = ref_ops.sparse_conv(x, ref_bank, interpret=True, **kw)
    assert want.dtype == jnp.bfloat16
    launches = sparse_conv_kernel.launches
    got = ops.sparse_conv(_t(x), bank, **_port_kw(kw))
    assert sparse_conv_kernel.launches == launches   # the CPU runs no kernel
    within_one_ulp(got, want)


@pytest.mark.parametrize("value_dtype", ("int8", "float8_e4m3fn"))
def test_sparse_conv_bf16_on_a_quantised_bank(value_dtype):
    """The reference takes bf16 activations with a quantised bank (its
    kernel scales each value, then widens the window); so does the port."""
    x, wt, kw = _epilogue_case(1, True)
    ref_bank, bank = _ell_pair(wt, value_dtype)
    want = ref_ops.sparse_conv(x, ref_bank, interpret=True, **kw)
    within_one_ulp(ops.sparse_conv(_t(x), bank, **_port_kw(kw)), want)


@pytest.mark.parametrize("name, make", ELL_CASES, ids=[c[0] for c in ELL_CASES])
def test_bf16_walk_is_the_f32_walk_on_the_widened_input(name, make):
    """The staged walk on bf16 slabs (offsets in 2-byte elements, the
    schedule resolved at 2 bytes) equals, bit for bit, the walk on f32
    slabs of the widened input rounded once, and the bf16 plain version."""
    x, wt, kw = make()
    _, bank = _ell_pair(wt)
    m, c, r, s = bank.shape
    stride, pad = kw.get("stride", 1), kw["padding"]
    xb = _t(x)
    n, _, h, w = xb.shape
    e, f = out_spatial(h, w, r, s, stride, pad)
    b = (_t(kw["bias"]) if kw.get("bias") is not None
         else torch.zeros(m))
    res = kw.get("residual")
    res = None if res is None else _t(res)
    packed = ops.pack_indices(bank)
    wp = w + 2 * pad
    outs = {}
    for dt, size in ((BF16, 2), (torch.float32, 4)):
        xp = pad_in(xb.to(dt), pad)
        width = slab_width(wp, size)
        xp = torch.nn.functional.pad(xp, (0, width - wp))
        sched, why = ops.resolve_schedule(
            m, bank.k, e, f, n=n, c=c, r=r, s=s, stride=stride, hp=h + 2 * pad,
            wp=wp, itemsize=size)
        assert sched is not None, why
        common = dict(rs=r * s, s=s, e=e, f=f, stride=stride,
                      fuse_relu=kw.get("fuse_relu", False))
        args = (xp, bank.value, packed, bank.nnz, b,
                None if res is None else res.to(dt))
        outs[dt] = sparse_conv_walk_plain(*args, schedule=sched, **common)
        if dt == BF16:
            plain = sparse_conv_plain(*args, **common)
    assert outs[BF16].dtype == BF16
    assert torch.equal(outs[BF16], outs[torch.float32].to(BF16))
    assert torch.equal(outs[BF16], plain)


def test_bf16_slabs_hold_twice_the_channels():
    """A bf16 slab is half an f32 one's bytes: the schedule's chunk of
    channels nearly doubles (each slab row's int32 source offset stays),
    and a conv whose one-channel f32 slab busts shared memory fits at
    bf16."""
    kw = dict(n=8, c=256, r=3, s=3, hp=16, wp=16)
    f32, _ = ops.resolve_schedule(256, 600, 14, 14, **kw)
    bf16, _ = ops.resolve_schedule(256, 600, 14, 14, itemsize=2, **kw)
    assert (bf16.tm, bf16.tp, bf16.rows) == (f32.tm, f32.tp, f32.rows)
    assert f32.cc < bf16.cc <= 2 * f32.cc
    assert budget.smem_fits(budget.ell_smem_bytes(
        bf16.tm, bf16.cc, 256, bf16.rows, 16, 3, bf16.pipeline, 2))
    # a 3-row slab of a 20,000-wide row: 240 KB at f32, 120 KB at bf16
    wide = dict(c=32, r=3, s=3)
    assert ops.resolve_schedule(8, 32, 8, 19998, **wide)[1] == "smem_infeasible"
    sched, why = ops.resolve_schedule(8, 32, 8, 19998, itemsize=2, **wide)
    assert sched is not None and not sched.pipeline, why


def test_odd_widths_are_padded_for_bf16_slabs():
    """An odd padded width takes one more zero column at bf16 (slab rows
    are copied 4 bytes at a time), which feeds only dropped pixels."""
    assert slab_width(13, 2) == 14 and slab_width(14, 2) == 14
    assert slab_width(13, 4) == 13
    x, wt, kw = _strided_case(2)       # 12 + 2 = 14: even
    _, bank = _ell_pair(wt)
    xo = _t(x)[..., :11]                # 11 + 2 = 13: odd
    got = ops.sparse_conv(xo, bank, stride=1, padding=1)
    want = ops.sparse_conv(xo.float(), dataclasses.replace(
        bank, value=bank.value.float()), stride=1, padding=1)
    assert torch.equal(got, want.to(BF16))


# ---------------------------------------------------------------------------
# BCSR: the reference's bf16 case
# ---------------------------------------------------------------------------

def _bsr_case(stride, block, value_dtype=None, *, seed_block=None):
    """test_bsr_parity_bf16: (1, 4, 12, 12) bf16, 8 filters 3x3 pruned at
    0.6 in ``block`` tiles, padding 1; the bank's tiles bf16 (or
    quantised).  ``seed_block`` keeps the reference's seed for a block
    the card's kernel takes."""
    n, c, h, w, m, r = 1, 4, 12, 12, 8, 3
    rng = np.random.default_rng(7000 + stride + (seed_block or block)[1])
    x = jnp.asarray(rng.standard_normal((n, c, h, w)), dtype=jnp.bfloat16)
    wt = np.asarray(ref_block_prune(jnp.asarray(
        rng.standard_normal((m, c, r, r)).astype(np.float32)), 0.6, block))
    want = ref_fmt.bcsr_conv_from_dense(wt.astype(np.float32), block=block)
    got = fmt.bcsr_conv_from_dense(wt.astype(np.float32), block=block,
                                   device="cpu")
    if value_dtype is None:
        want = dataclasses.replace(want,
                                   blocks=want.blocks.astype(jnp.bfloat16))
        got = dataclasses.replace(got, blocks=got.blocks.to(BF16))
    else:
        want = ref_fmt.quantize_values(want, value_dtype)
        got = fmt.quantize_values(got, value_dtype)
    return x, want, got


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("block", [(4, 8), (8, 32)])
def test_bsr_kernel_bf16_on_the_references_blocks(stride, block):
    """The reference's case at its own blocks, which the card's kernel does
    not take (its tiles are 128 wide): the kernel wrapper's CPU branch
    (the plain version) on the reference's bank, within one ulp."""
    x, ref_bank, bank = _bsr_case(stride, block)
    want = ref_bsr_ops.bsr_conv(x, ref_bank, stride=stride, padding=1,
                                interpret=True)
    m, _, r, s = bank.shape
    e, f = out_spatial(12, 12, r, s, stride, 1)
    mpad = bank.gbm * block[0]
    got = bsr_conv_kernel(pad_in(_t(x), 1), bank.blocks, bank.blockcol,
                          bank.nblocks, torch.zeros(mpad), rs=r * s, s=s,
                          e=e, f=f, stride=stride)[:, :m]
    within_one_ulp(got, want)


@pytest.mark.parametrize("stride, block, value_dtype", [
    (1, (8, 128), None), (2, (16, 128), None), (1, (16, 128), "int8")])
def test_bsr_conv_bf16_matches_reference(stride, block, value_dtype):
    """The same case at blocks the card's kernel takes, through both
    packages' ``bsr_conv``: bf16 out, within one ulp; a quantised bank on
    bf16 activations too (the reference takes it).  (The reference's
    interpret mode takes ~14 s a case at 128-wide tiles.)"""
    x, ref_bank, bank = _bsr_case(stride, block, value_dtype,
                                  seed_block=(8, 32))
    want = ref_bsr_ops.bsr_conv(x, ref_bank, stride=stride, padding=1,
                                interpret=True)
    assert want.dtype == jnp.bfloat16
    launches = bsr_conv_kernel.launches
    got = bsr_ops.bsr_conv(_t(x), bank, stride=stride, padding=1)
    assert bsr_conv_kernel.launches == launches
    within_one_ulp(got, want)


def test_bsr_bf16_refuses_f32_tiles_and_mixed_residuals():
    """bf16 activations take bf16 or quantised tiles (rounding f32 tiles
    would not be the reference's product); the residual shares x's
    dtype.  Both refusals hold on either device."""
    x, _, bank = _bsr_case(1, (8, 128), seed_block=(8, 32))
    f32 = dataclasses.replace(bank, blocks=bank.blocks.float())
    with pytest.raises(ValueError, match="bf16 activations"):
        bsr_ops.bsr_conv(_t(x), f32, padding=1)
    res = torch.zeros((1, 8, 12, 12))
    with pytest.raises(ValueError, match="residual"):
        bsr_ops.bsr_conv(_t(x), bank, padding=1, residual=res)
    _, wt, _ = _dtypes_case()
    _, ell = _ell_pair(wt)
    with pytest.raises(ValueError, match="residual"):
        ops.sparse_conv(_t(x), ell, padding=1, residual=res)


@pytest.mark.parametrize("value_dtype", ["bfloat16", "int8"])
def test_bf16_bcsr_stages_are_smaller(value_dtype):
    """A bf16 operand is half a TF32 one and has no lo half: a stage of
    bf16 tiles takes a quarter of the f32 split's bytes (the bf16 kernel
    keeps three stages to the f32 one's two); a quantised bank's bytes stay
    beside its converted operand."""
    v = budget.value_itemsize(value_dtype)
    f32 = budget.bsr_conv_smem_bytes(8, 128, 64, 36)
    half = budget.bsr_conv_smem_bytes(8, 128, 64, 36, v, 2)
    fixed = 4 * (3 * 128 + 9 * 36)
    extra = 1 if v == 1 else 0
    assert half - fixed == 3 * 64 * 128 * (2 + extra)
    assert f32 - fixed == 2 * 64 * 128 * 8
    assert bsr_ops.resolve_bsr_schedule(
        8, 128, 7, 7, n=8, m=512, crs=4608, value_dtype=value_dtype,
        itemsize=2)[0] is not None
