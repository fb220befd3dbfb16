"""The bf16 conv kernels' Hopper design, on the CPU, against the JAX package.

The ELL kernel on a bf16 bank and bf16 activations streams one 32-bit word a
nonzero (the slab offset above the value's bf16 bits), forms each sum with
one fmaf a nonzero and pixel, and, at stride 1, reads two neighbouring
pixels from one 32-bit word of a paired slab (plane 0 the slab as copied,
plane 1 shifted by one element).  Here:

* ``stretch_bank`` / ``unstretch`` round-trip the one-word format (staged,
  paired, 1x1) and refuse offsets past 2^16 by name;
* the structural mirror (``sparse_conv_walk_plain``) under a bf16 bank's
  schedules (the paired slab, blocking; pinned pipelined, the unpaired
  one), 1x1 and strided, is bit for bit
  ``sparse_conv_plain`` on bf16 inputs, and within one bf16 ulp of the
  reference's ``sparse_conv`` (its Pallas kernel in interpret mode) on the
  same inputs;
* the ground for ``fmaf``: a property (``hypothesis``) that the f32 product
  of two bf16 values whose product is a normal f32 equals their exact
  (f64) product, so rounding it changes nothing;
* the BCSR kernel's bf16 arithmetic at its wider channel groups (one f32
  sum a channel, no partial sums) is within one bf16 ulp of
  ``bsr_conv_plain`` and of the reference's ``bsr_conv``.

One bf16 ulp: |got - want| <= 2^-7 |want| + 2^-8 max(1, max |want|), as in
``test_torch_conv_bf16.py`` (the two packages sum in different orders and
round once each).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import block_prune_conv as ref_block_prune  # noqa: E402
from repro.core import magnitude_prune as ref_magnitude_prune  # noqa: E402
from repro.core import sparse_format as ref_fmt  # noqa: E402
from repro.kernels.bsr_conv import ops as ref_bsr_ops  # noqa: E402
from repro.kernels.sparse_conv import ops as ref_ops  # noqa: E402
from repro_torch.core import sparse_format as fmt  # noqa: E402
from repro_torch.core.direct_conv import out_spatial, pad_in  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels.bsr_conv import ops as bsr_ops  # noqa: E402
from repro_torch.kernels.bsr_conv import ref as bsr_ref  # noqa: E402
from repro_torch.kernels.sparse_conv import ops  # noqa: E402
from repro_torch.kernels.sparse_conv.ref import (  # noqa: E402
    BF16_OFFSET_LIMIT, entry_format, paired_slab_elems, plane_words,
    slab_width, sparse_conv_plain, sparse_conv_walk_plain, stretch_bank,
    unstretch)

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    dt = BF16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(a, np.float32)).to(dt)


def within_one_ulp(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    g = got.float().numpy()
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * max(1.0, np.abs(want).max())
    bad = np.abs(g - want) > tol
    assert not bad.any(), (int(bad.sum()), float(np.abs(g - want).max()))


def _bank(m, c, r, sparsity, seed):
    """A magnitude-pruned (m, c, r, r) bank in both packages, bf16 values."""
    rng = np.random.default_rng(seed)
    wt = np.asarray(ref_magnitude_prune(jnp.asarray(
        rng.standard_normal((m, c, r, r)).astype(np.float32)), sparsity))
    want = ref_fmt.ell_from_dense_conv(wt)
    want = dataclasses.replace(want, value=want.value.astype(jnp.bfloat16))
    got = fmt.ell_from_dense_conv(wt, device="cpu")
    return want, dataclasses.replace(got, value=got.value.to(BF16)), rng


# ---------------------------------------------------------------------------
# the one-word format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rs, s, paired", [(9, 3, False), (9, 3, True),
                                            (25, 5, True), (1, 1, False)])
def test_bf16_words_round_trip(rs, s, paired):
    """Each live entry's word decodes to its value (exactly: the bf16 bits)
    and to its offset: an element of the slab, a word of its planes
    (element o at plane o % 2, word o // 2), or a 1x1 conv's channel; the
    run bounds are the pairs' own."""
    r = rs // s
    _, bank, _ = _bank(6, 5, r, 0.5, 11 + rs + paired)
    packed = ops.pack_indices(bank)
    geo = dict(rs=rs, s=s, ws=10, rows=4, cc=2, c=5, itemsize=2)
    if rs == 1:
        geo.update(rows=7, cc=5)
    w, rowptr = stretch_bank(bank.value, packed, bank.nnz, words=True,
                             paired=paired, **geo)
    p, rowptr_pairs = stretch_bank(bank.value, packed, bank.nnz, **geo)
    assert w.dtype == torch.int32 and w.shape == packed.shape
    assert torch.equal(rowptr, rowptr_pairs)
    off, val = unstretch(w, BF16, None, 2, words=True)
    elems, val_pairs = unstretch(p, BF16, None, 2)
    live = torch.arange(bank.k)[None, :] < bank.nnz.long()[:, None]
    assert torch.equal(val[live], bank.value.float()[live])
    assert torch.equal(val[live], val_pairs[live])
    if rs == 1:
        want = elems // (geo["rows"] * geo["ws"])
    elif paired:
        pw = plane_words(paired_slab_elems(2, 4, 10, s))
        want = (elems % 2) * pw + elems // 2
    else:
        want = elems
    assert torch.equal(off[live], want[live])


def test_bf16_words_refuse_offsets_past_16_bits():
    """A slab of 2^16 elements or more has offsets a word cannot hold: the
    stretch refuses it by name, and the launcher's format takes the
    (offset, f32 value) pairs there, the same sums."""
    _, bank, _ = _bank(4, 3, 3, 0.3, 5)
    packed = ops.pack_indices(bank)
    geo = dict(rs=9, s=3, ws=40_000, rows=3, cc=1, c=3, itemsize=2)
    with pytest.raises(ValueError, match="one-word slab offsets reach 65536"):
        stretch_bank(bank.value, packed, bank.nnz, words=True, **geo)
    stretch_bank(bank.value, packed, bank.nnz, **geo)   # pairs hold them
    wide = ops.EllSchedule(8, 64, 1, 3, False, False)
    assert entry_format(BF16, 2, 9, 3, 40_000, wide) == (False, False)
    narrow = ops.EllSchedule(8, 64, 1, 3, False, True)
    assert entry_format(BF16, 2, 9, 3, 100, narrow) == (True, True)
    # f32 and quantised banks, and f32 activations, never take words
    assert entry_format(torch.float32, 2, 9, 3, 100, narrow) == (False, False)
    assert entry_format(torch.int8, 2, 9, 3, 100, narrow) == (False, False)
    assert entry_format(BF16, 4, 9, 3, 100, narrow) == (False, False)
    with pytest.raises(ValueError, match="bf16 bank's values"):
        stretch_bank(bank.value.float(), packed, bank.nnz, words=True, **geo)


# ---------------------------------------------------------------------------
# the paired slab: schedules and the structural mirror
# ---------------------------------------------------------------------------

def test_paired_schedules_at_resnet50_layers():
    """A bf16 bank at stride 1 takes the paired slab, blocking (its two
    planes hold as many channels as the unpaired bf16 slab's two pipelined
    stages, more than the f32 one's); strided convs, f32 and any other
    bank (``paired=False``) do not; every schedule fits shared memory and
    its plane words fit a word's offset."""
    cases = [(256, 256, 14, 3, 1, 1), (512, 512, 7, 3, 1, 1),
             (256, 96, 27, 5, 1, 2), (64, 64, 56, 3, 1, 1)]
    for m, c, h, r, stride, pad in cases:
        e = (h + 2 * pad - r) // stride + 1
        geo = dict(n=8, c=c, r=r, s=r, stride=stride, hp=h + 2 * pad,
                   wp=h + 2 * pad)
        pair, _ = ops.resolve_schedule(m, 600, e, e, itemsize=2,
                                       paired=True, **geo)
        flat, _ = ops.resolve_schedule(m, 600, e, e, itemsize=2, **geo)
        f32, _ = ops.resolve_schedule(m, 600, e, e, paired=True, **geo)
        assert pair.paired and not flat.paired and not f32.paired
        assert not pair.pipeline
        assert f32.cc <= pair.cc <= flat.cc
        ws = slab_width(h + 2 * pad, 2)
        assert budget.smem_fits(budget.ell_smem_bytes(
            pair.tm, pair.cc, c, pair.rows, ws, r, pair.pipeline, 2, True))
        assert 2 * plane_words(paired_slab_elems(
            pair.cc, pair.rows, ws, r)) <= BF16_OFFSET_LIMIT
    strided, _ = ops.resolve_schedule(8, 20, 6, 6, n=1, c=4, r=3, s=3,
                                      stride=2, hp=14, wp=14, tp=64,
                                      itemsize=2, paired=True)
    assert not strided.paired
    # a 1x1 conv pairs where two neighbouring pixels neighbour in xpad
    bank = dict(itemsize=2, paired=True)
    one, _ = ops.resolve_schedule(1024, 100, 14, 14, n=8, c=256, **bank)
    odd, _ = ops.resolve_schedule(2048, 100, 7, 7, n=8, c=512, **bank)
    s2, _ = ops.resolve_schedule(128, 100, 28, 28, n=8, c=256, stride=2,
                                 hp=56, wp=56, **bank)
    assert one.paired and not odd.paired and not s2.paired
    # one 32-wide pixel tile a lane has no pairs
    px1, _ = ops.resolve_schedule(8, 20, 10, 10, n=2, c=4, r=3, s=3,
                                  tp=32, **bank)
    assert not px1.paired
    # pinned pipelined: the unpaired slab (a paired one is never pipelined)
    piped, _ = ops.resolve_schedule(256, 600, 14, 14, n=8, c=256, r=3, s=3,
                                    hp=16, wp=16, pipeline=True, **bank)
    assert piped.pipeline and not piped.paired


# (N, C, H, M, R, stride, pad, residual, relu)
WALK_CASES = [
    (2, 6, 10, 8, 3, 1, 1, True, True),      # crosses images, residual
    (1, 5, 9, 12, 5, 1, 2, False, True),     # 5x5, odd width padded
    (3, 4, 7, 8, 3, 1, 1, False, False),     # 7x7 images, several a tile
    (2, 6, 12, 8, 3, 2, 1, True, True),      # strided: unpaired words
    (2, 8, 6, 10, 1, 1, 0, True, True),      # 1x1, paired loads
    (2, 8, 7, 10, 1, 1, 0, False, True),     # 1x1, odd width: unpaired
    (2, 8, 10, 6, 1, 2, 0, False, False),    # 1x1 strided
]


@pytest.mark.parametrize("case", WALK_CASES, ids=str)
@pytest.mark.parametrize("pipeline", [None, False, True])
def test_paired_walk_is_the_plain_version_bit_for_bit(case, pipeline):
    """The kernel's walk under a bf16 bank's schedule (the paired slab's
    pixel pairs read from its two planes by their words' plane offsets;
    pinned pipelined, the unpaired slab's words), 1x1 and strided, on a
    bf16 bank and bf16 activations: bit
    for bit the plain version, whose sums round each product and each add
    (the product of two bf16 values is exact, so the kernel's fmaf gives
    the same bits); and, through ``ops.sparse_conv``, within one bf16 ulp
    of the reference's kernel on the same bank."""
    n, c, h, m, r, stride, pad, with_res, relu = case
    ref_bank, bank, rng = _bank(m, c, r, 0.6, hash(case) % 2**31)
    x = jnp.asarray(rng.standard_normal((n, c, h, h)), dtype=jnp.bfloat16)
    e, f = out_spatial(h, h, r, r, stride, pad)
    bias = rng.standard_normal(m).astype(np.float32)
    res = (jnp.asarray(rng.standard_normal((n, m, e, f)), dtype=jnp.bfloat16)
           if with_res else None)
    xb = _t(x)
    wp = h + 2 * pad
    xpad = pad_in(xb, pad)
    if r > 1:
        xpad = torch.nn.functional.pad(xpad, (0, slab_width(wp, 2) - wp))
    geo = dict(n=n, c=c, r=r, s=r, stride=stride, hp=wp, wp=wp, itemsize=2)
    sched, why = ops.resolve_schedule(m, bank.k, e, f, tp=64,
                                      pipeline=pipeline, paired=True, **geo)
    assert sched is not None, why
    paired = stride == 1 and (r > 1 and pipeline is not True
                              or r == 1 and f % 2 == 0)
    assert sched.paired == paired
    assert entry_format(BF16, 2, r * r, r, xpad.shape[3], sched) == (
        True, paired)
    args = (xpad, bank.value, ops.pack_indices(bank), bank.nnz,
            torch.from_numpy(bias), None if res is None else _t(res))
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu)
    plain = sparse_conv_plain(*args, **kw)
    walk = sparse_conv_walk_plain(*args, schedule=sched, **kw)
    assert walk.dtype == BF16 and torch.equal(walk, plain)
    want = ref_ops.sparse_conv(x, ref_bank, stride=stride, padding=pad,
                               bias=jnp.asarray(bias), fuse_relu=relu,
                               residual=res, interpret=True)
    got = ops.sparse_conv(xb, bank, stride=stride, padding=pad, tp=64,
                          bias=torch.from_numpy(bias), fuse_relu=relu,
                          residual=None if res is None else _t(res),
                          pipeline=pipeline)
    assert torch.equal(got, plain)
    within_one_ulp(got, want)


# ---------------------------------------------------------------------------
# the ground for fmaf
# ---------------------------------------------------------------------------

def _bf16_values(data_bits):
    """bf16 values from 16-bit patterns, finite only."""
    bits = np.array(data_bits, np.uint32) << 16
    return bits.view(np.float32)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(0, 0xFFFF), min_size=2, max_size=64),
       st.lists(st.integers(0, 0xFFFF), min_size=2, max_size=64))
def test_a_bf16_product_is_exact_in_f32(a_bits, b_bits):
    """For any two finite bf16 values whose product is a normal f32 (or 0),
    the f32 product equals the exact product: 8 + 8 significant bits fit
    f32's 24.  So the rounded product the plain version adds is the exact
    one, and fmaf(v, x, acc), which rounds only the sum, gives the bits of
    acc + round(v * x).  (Below f32's normal range the rounded product
    loses bits and the two differ: the source states that exception.)"""
    k = min(len(a_bits), len(b_bits))
    a = _bf16_values(a_bits[:k])
    b = _bf16_values(b_bits[:k])
    ok = np.isfinite(a) & np.isfinite(b)
    a, b = a[ok], b[ok]
    exact = a.astype(np.float64) * b.astype(np.float64)
    tiny = np.finfo(np.float32).tiny
    normal = (exact == 0) | ((np.abs(exact) >= tiny)
                             & (np.abs(exact) <= np.finfo(np.float32).max))
    with np.errstate(over="ignore", under="ignore"):
        f32 = (a * b).astype(np.float64)
    assert np.array_equal(f32[normal], exact[normal])
    # and the fused sum: acc + v x rounded once equals the rounded sum of
    # the rounded product, for an f32 acc
    acc = np.float32(0.3183099)
    fused = np.float32(np.float64(acc) + exact[normal])
    with np.errstate(over="ignore"):
        two = np.float32(acc + (a * b)[normal])
    assert np.array_equal(fused[np.isfinite(two)], two[np.isfinite(two)])


def test_subnormal_products_are_the_stated_exception():
    """The exception the source states: a product below f32's normal range
    is rounded (here to a subnormal), so the fused and the unfused sums
    can differ there."""
    a = b = np.float32((1 + 2.0 ** -7) * 2.0 ** -70)   # a bf16 value
    exact = np.float64(a) * np.float64(b)
    with np.errstate(under="ignore"):
        assert np.float64(a * b) != exact


# ---------------------------------------------------------------------------
# BCSR at the wider bf16 channel groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride, block, n_tile", [
    (1, (8, 128), 128), (2, (16, 128), 128), (1, (8, 128), 32)])
def test_bsr_bf16_wide_groups_within_one_ulp(stride, block, n_tile):
    """The kernel's bf16 arithmetic at a wide channel group (its mirror,
    ``bsr_conv_bf16_plain``: every product exact, one f32 sum a channel
    added tile by tile, no partial sums) is within one bf16 ulp of the
    plain version and of the reference's ``bsr_conv``; the schedule takes
    the wide group at bf16 and fits shared memory."""
    n, c, h, m, r = 2, 20, 10, 40, 3
    rng = np.random.default_rng(7000 + stride + n_tile)
    x = jnp.asarray(rng.standard_normal((n, c, h, h)), dtype=jnp.bfloat16)
    wt = np.asarray(ref_block_prune(jnp.asarray(
        rng.standard_normal((m, c, r, r)).astype(np.float32)), 0.5, block))
    ref_bank = ref_fmt.bcsr_conv_from_dense(wt, block=block)
    ref_bank = dataclasses.replace(
        ref_bank, blocks=ref_bank.blocks.astype(jnp.bfloat16))
    bank = fmt.bcsr_conv_from_dense(wt, block=block, device="cpu")
    bank = dataclasses.replace(bank, blocks=bank.blocks.to(BF16))
    e, f = out_spatial(h, h, r, r, stride, 1)
    gbm = bank.blocks.shape[0]
    tile, why = bsr_ops.resolve_bsr_schedule(
        *block, e, f, n=n, m=gbm * block[0], crs=c * r * r, n_tile=n_tile,
        value_dtype="bfloat16", itemsize=2)
    assert tile is not None and tile[0] == n_tile, why
    mpad = gbm * block[0]
    bias = torch.zeros(mpad)
    args = (pad_in(_t(x), 1), bank.blocks, bank.blockcol, bank.nblocks, bias)
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=True)
    mirror = bsr_ref.bsr_conv_bf16_plain(*args, n_tile=n_tile, **kw)
    plain = bsr_ref.bsr_conv_plain(*args, **kw)
    assert mirror.dtype == BF16
    within_one_ulp(mirror, plain.float().numpy())
    want = ref_bsr_ops.bsr_conv(x, ref_bank, stride=stride, padding=1,
                                fuse_relu=True, interpret=True)
    within_one_ulp(mirror[:, :m], want)
