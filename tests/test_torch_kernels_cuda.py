"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and a smoke transformer through its kernels against the CPU (a forward with
decode steps, and a training step through the flash backward kernels).

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card and
skips without one.  On a machine with an H100::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The geometries cover what the main path gives the kernels and where they are
likeliest to go wrong: stride-2 1x1 layers, ragged spatial tiles (E*F not a
multiple of the pixel tile), pixel tiles spanning images (7 x 7 outputs),
M not a multiple of the channel tile or block height, K over several
channel chunks, the fused residual tail, a balanced bank, every tile the
conv sources instantiate, and BCSR right-padding columns past C*R*S.  The
BCSR matmul's ``wgmma`` schedule must refuse a bank it cannot walk.

The BCSR matmul cases cover both schedules (``rows``, ``wgmma``), (16, 16)
and (16, 128) tiles, ragged row counts and the prefill's 8192 rows, in f32
and bf16 output; the ``rows`` cases also every decode row count it serves
on a bank with an empty block-row, a block-row split over many units, 32
block-rows, columns out of order or repeated, and NaN padding; the flash cases GQA 8:1 at d = 128 with T = 200 (not a
multiple of either chunk), causal and full, S != T, MHA, and bf16 (the
tensor-core forward, dQ and dK/dV) at every head dimension of
``budget.FLASH_HEAD_DIMS``, causal and full, 80 (HuBERT-XLarge) and 96
(Phi-3-Vision) among them, GQA and MHA, ragged and not (a T of 2000 at
both, in f32, also against autograd through ``attention_ref``'s naive
attention in float64), and one mesh rank's heads (H / tp heads of
Qwen1.5-0.5B and OLMoE at tp 2, tensor-parallel mode A; Yi-9B's single kv
head a rank at tp 8 and 16, mode B); head dims above 128 (144, 256) run
the wide kernels (the output-column split).  A bf16
MoE group (cuBLAS products with f32 results) agrees
with the CPU's.  The counters show which kernel ran: bf16 operands the
tensor-core ones, f32 the split-TF32 forward, dQ and dK/dV (with its
group sum when a kv head serves more than one query head).

Tolerances: the ELL kernel rounds each multiply and add as its plain version
does, in the same nonzero order, so it agrees bit for bit, pipelined or
blocking; the BCSR kernel splits its f32 operands into TF32 halves (about
21 bits) and sums up to C*R*S products in another order than the library
contraction of its plain version, so it is held to rtol = atol = 1e-4,
and, as chip_smoke.py holds it, to 1e-4 x (1 + max |y|), which one
product on operands rounded once to TF32 exceeds.  The BCSR matmul sums each output
in f32 in its own order: 1e-4 of the output's largest magnitude.  Flash
attention rescales its sums chunk by chunk where the plain version takes
whole rows: O to 2e-5 in f32; in bf16 each element to one bf16 rounding of
the output plus 1e-3 of the output's rms, a limit that p v in bf16 exceeds;
lse to 1e-4.  The flash backward kernels sum in f32 in another order than
their plain version (in f32 from split TF32 products: about 21 bits of each
operand): in f32 each of dQ, dK and dV within 1e-4 of its rms;
in bf16 each element within one bf16 rounding plus 1e-3 of the rms, a
limit that the plain version with p rounded to bf16 exceeds.  dK and dV
of both dK/dV kernels sum each kv head's group in a fixed order, both dQ
kernels and the ``wgmma`` BCSR matmul write each output from one
thread, and the ``rows`` BCSR matmul adds a split block-row's partial sums
in a fixed order: two launches on the same operands agree bit for bit.  The BCSR
matmul's bf16 output is its f32 output rounded once, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.direct_conv import out_spatial, pad_in  # noqa: E402
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.core.sparse_format import (bcsr_conv_from_dense,  # noqa: E402
                                            ell_from_dense_conv)
from repro_torch.kernels import budget  # noqa: E402
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
    (1, 64, 9, 16, 3, 1, 1, 0.3, True, False),      # K over several chunks
    (3, 8, 23, 12, 5, 1, 2, 0.6, False, True),      # 5x5 pad 2, ragged E*F
    (2, 12, 19, 8, 3, 2, 0, 0.5, True, True),       # stride 2 ragged
    (8, 64, 7, 48, 3, 1, 1, 0.7, True, True),       # 49 pixels an image
]


def _ell_schedules(m, ell, n, c, h, r, stride, pad, e, f):
    """The pipelined and the blocking schedule ``ops.sparse_conv`` takes."""
    geo = dict(n=n, c=c, r=r, s=r, stride=stride, hp=h + 2 * pad,
               wp=h + 2 * pad)
    piped, reason = resolve_schedule(m, ell.k, e, f, **geo)
    assert reason is None
    blocking, _ = resolve_schedule(m, ell.k, e, f, pipeline=False, **geo)
    return piped, blocking


@pytest.mark.parametrize("case", ELL_CASES)
def test_sparse_conv_kernel_matches_plain(cuda_device, case):
    """Bit for bit: pipelined, blocking, every tile the source instantiates,
    and two launches of one schedule."""
    n, c, h, m, r, stride, pad, sp, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, sp)
    ell = ell_from_dense_conv(w, device=cuda_device)
    e, f = out_spatial(h, h, r, r, stride, pad)
    xt = torch.from_numpy(x).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, m, e, f)).astype(np.float32))
           .to(cuda_device) if with_res else None)
    piped, blocking = _ell_schedules(m, ell, n, c, h, r, stride, pad, e, f)
    # a 1x1 conv stages nothing, so it has no pipelined schedule
    assert piped.pipeline == (r > 1) and not blocking.pipeline
    args = (pad_in(xt, pad), ell.value, pack_indices(ell), ell.nnz, bias, res)
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu)
    want = sparse_conv_plain(*args, **kw)
    before = sparse_conv_kernel.launches
    got = sparse_conv_kernel(*args, schedule=piped, **kw)
    torch.cuda.synchronize()
    assert sparse_conv_kernel.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(sparse_conv_kernel(*args, schedule=piped, **kw),
                               got, rtol=0, atol=0)
    torch.testing.assert_close(
        sparse_conv_kernel(*args, schedule=blocking, **kw), got, rtol=0,
        atol=0)
    for tm, px in budget.ELL_TILES:
        sched, _ = resolve_schedule(m, ell.k, e, f, n=n, c=c, r=r, s=r,
                                    stride=stride, hp=h + 2 * pad,
                                    wp=h + 2 * pad, tm=tm, tp=32 * px)
        torch.testing.assert_close(
            sparse_conv_kernel(*args, schedule=sched, **kw), want, rtol=0,
            atol=0)


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
    torch.testing.assert_close(sparse_conv(xt, bal, pipeline=False, **kw),
                               sparse_conv(xt, nat, **kw), rtol=0, atol=0)


# (N, C, H, M, R, stride, pad, block, residual, relu)
BSR_CASES = [
    (2, 16, 12, 20, 3, 1, 1, (8, 128), True, True),    # M % bm, CRS % bn
    (2, 64, 14, 32, 1, 2, 0, (16, 128), False, True),  # stride-2 1x1
    (1, 24, 17, 64, 5, 1, 2, (8, 128), True, False),   # ragged E*F
    (2, 40, 9, 60, 3, 1, 1, (16, 128), False, True),   # M % bm
    (8, 64, 7, 72, 3, 1, 1, (8, 128), True, True),     # 49 pixels an image
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
    for n_tile, wgs in budget.BSR_CONV_TILES:
        torch.testing.assert_close(bsr_conv(xt, bc, n_tile=n_tile, wgs=wgs,
                                            **kw), want, rtol=1e-4, atol=1e-4)


def test_bsr_conv_check_rejects_one_product(cuda_device):
    """The kernel within 1e-4 x (1 + max |y|) of its plain version, as
    chip_smoke.py holds it, and one product on operands rounded once to
    TF32 (the split's control) outside it."""
    from repro_torch.kernels.bsr_conv.ref import (bsr_conv_plain,
                                                  bsr_conv_split_plain)

    x, w, rng = _case(11, 8, 64, 7, 72, 3, 0.7)
    bc = bcsr_conv_from_dense(w, block=(8, 128), device=cuda_device)
    xpad = pad_in(torch.from_numpy(x).to(cuda_device), 1)
    bias = torch.zeros(72, device=cuda_device)
    args = (xpad, bc.blocks, bc.blockcol, bc.nblocks, bias)
    kw = dict(rs=9, s=3, e=7, f=7)
    want = bsr_conv_plain(*args, **kw)
    limit = 1e-4 * (1 + float(want.abs().max()))
    got = bsr_conv_kernel(*args, **kw)
    assert float((got - want).abs().max()) <= limit
    assert float((bsr_conv_split_plain(*args, **kw) - want).abs().max()) <= limit
    assert float((bsr_conv_split_plain(*args, lo=False, **kw)
                  - want).abs().max()) > limit


def test_refused_launch_raises(cuda_device):
    x, w, _ = _case(5, 1, 4, 8, 8, 3, 0.5)
    ell = ell_from_dense_conv(w, device=cuda_device)
    xt = pad_in(torch.from_numpy(x).to(cuda_device), 1)
    bias = torch.zeros(8, device=cuda_device)
    sched, _ = resolve_schedule(8, ell.k, 8, 8, c=4, r=3, s=3, hp=10, wp=10)
    # a chunk of 4096 channels asks for more shared memory than a block may
    # have: CUDA refuses the launch, and the wrapper raises instead of
    # returning an unwritten output.
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        sparse_conv_kernel(xt, ell.value, pack_indices(ell), ell.nnz, bias,
                           rs=9, s=3, e=8, f=8,
                           schedule=dataclasses.replace(sched, cc=4096))


@pytest.mark.parametrize("cols, fault", [((9, 0), "not strictly ascending"),
                                         ((3, 3), "share a block column")])
def test_bsr_matmul_refuses_a_bank_it_cannot_walk(cuda_device, cols, fault):
    """The wgmma schedule's walk would skip the tile listed after a higher
    column, or overwrite a repeated one: 2112 bf16 rows (wgmma) of such a
    bank raise, checked once per bank, and the rows schedule sums it."""
    from repro_torch.kernels.bsr_matmul.kernel import (bsr_matmul_kernel,
                                                       schedule)
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    blocks = torch.randn((1, 2, 16, 16), generator=gen, device=cuda_device)
    bcol = torch.tensor([cols], dtype=torch.int32, device=cuda_device)
    nb = torch.tensor([2], dtype=torch.int32, device=cuda_device)
    x = torch.randn((2112, 256), generator=gen, device=cuda_device)
    assert schedule(2112, torch.bfloat16) == "wgmma"
    with pytest.raises(ValueError, match=fault):
        bsr_matmul_kernel(x.to(torch.bfloat16), blocks.to(torch.bfloat16),
                          bcol, nb)
    got = bsr_matmul_kernel(x[:4], blocks, bcol, nb)        # rows
    want = bsr_matmul_plain(x[:4], blocks, bcol, nb)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# -- BCSR matmul ---------------------------------------------------------
# (rows, M, N, block, dtype, schedule): (16, 16) tiles as the transformer's
# banks, (16, 128) tiles, rows not a multiple of either schedule's row tile
# (8 for rows, 128 for wgmma), bf16 row counts on both sides of
# budget.BSR_MATMUL_ROWS_MAX = 2048, which picks the schedule (the wgmma
# cases 2048 rows above it, with the same ragged tail of 128), more
# block-rows than one wgmma group (16) and N over several of its
# 128-column chunks, the last ragged; 8192 rows at Yi-9B's wq shape.
BSR_MATMUL_CASES = [
    (4, 256, 512, (16, 16), torch.bfloat16, "rows"),
    (13, 96, 256, (16, 16), torch.float32, "rows"),
    (2088, 64, 256, (16, 16), torch.bfloat16, "wgmma"),
    (2348, 160, 384, (16, 16), torch.bfloat16, "wgmma"),
    (29, 64, 512, (16, 128), torch.bfloat16, "rows"),
    (2563, 128, 1024, (16, 128), torch.bfloat16, "wgmma"),
    (129, 48, 256, (16, 128), torch.float32, "rows"),
    (2081, 400, 592, (16, 16), torch.bfloat16, "wgmma"),
    (2148, 272, 448, (16, 32), torch.bfloat16, "wgmma"),
    (8192, 4096, 4096, (16, 16), torch.bfloat16, "wgmma"),
    # taller blocks, read as sub-rows of (16, bn) pieces: the reference's
    # default (128, 128), (64, 128), widths that do not divide the wgmma
    # chunk (48, 80: tiles across its edge) or exceed it (256)
    (4, 1024, 1024, (128, 128), torch.bfloat16, "rows"),
    (37, 512, 768, (64, 128), torch.float32, "rows"),
    (2200, 1024, 1024, (128, 128), torch.bfloat16, "wgmma"),
    (2100, 384, 480, (32, 48), torch.bfloat16, "wgmma"),
    (2100, 288, 640, (48, 80), torch.bfloat16, "wgmma"),
    (2100, 256, 1024, (32, 256), torch.bfloat16, "wgmma"),
    (5, 288, 640, (48, 80), torch.bfloat16, "rows"),
]


@pytest.mark.parametrize("case", BSR_MATMUL_CASES, ids=str)
def test_bsr_matmul_kernel_matches_plain(cuda_device, case):
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense
    from repro_torch.kernels.bsr_matmul.kernel import (bsr_matmul_kernel,
                                                       schedule)
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

    rows, m, n, block, dtype, sched = case
    assert schedule(rows, dtype) == sched
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    w = torch.randn((m, n), generator=gen, device=cuda_device)
    bc = bcsr_from_dense(block_prune(w, 0.8, block).to(dtype), block)
    x = torch.randn((rows, n), generator=gen, device=cuda_device).to(dtype)
    args = (x, bc.blocks, bc.blockcol, bc.nblocks)
    before = (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches)
    got = bsr_matmul_kernel(*args)
    torch.cuda.synchronize()
    assert (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches) \
        == (before[0] + 1, before[1] + (sched == "wgmma"))
    want = bsr_matmul_plain(*args)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale
    # one rounding of the same f32 sums, and the same bits on every launch
    assert torch.equal(bsr_matmul_kernel(*args, out_dtype=torch.bfloat16),
                       got.to(torch.bfloat16))
    assert torch.equal(bsr_matmul_kernel(*args), got)


def test_bsr_matmul_padding_tiles_are_not_read(cuda_device):
    """The kernel stops at nblocks: poisoned padding tiles change nothing."""
    from repro_torch.core.sparse_format import bcsr_from_dense
    from repro_torch.kernels.bsr_matmul.kernel import (bsr_matmul_kernel,
                                                       schedule)

    w = torch.zeros((32, 64), device=cuda_device)
    w[:16, :] = 1.0            # block-row 0 keeps 4 tiles, block-row 1 none
    bc = bcsr_from_dense(w, (16, 16))
    blocks = bc.blocks.clone()
    blocks[1] = float("nan")
    x = torch.ones((2088, 64), device=cuda_device)
    for sched, dt in (("rows", torch.float32), ("wgmma", torch.bfloat16)):
        assert schedule(2088, dt) == sched
        got = bsr_matmul_kernel(x.to(dt), blocks.to(dt), bc.blockcol,
                                bc.nblocks)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :16], torch.full((2088, 16), 64.0,
                                                   device=cuda_device))
        assert torch.equal(got[:, 16:], torch.zeros((2088, 16),
                                                    device=cuda_device))


@pytest.mark.parametrize("rows", [4, 4096])
def test_bsr_matmul_f32_x_over_bf16_tiles(cuda_device, rows):
    """f32 activations over a bf16 model's tiles (f32 embeddings on a bf16
    model): ``ops.bsr_matmul`` casts the tiles to f32 once per bank and the
    kernel runs its ``rows`` schedule in f32 at any row count (``wgmma``
    takes bf16 only); the result is f32, within 1e-4 of the plain product
    of the same values."""
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul_kernel
    from repro_torch.kernels.bsr_matmul.ops import bsr_matmul
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    w = torch.randn((256, 512), generator=gen, device=cuda_device)
    bc = bcsr_from_dense(block_prune(w, 0.8, (16, 16)), (16, 16))
    bc.blocks = bc.blocks.to(torch.bfloat16)
    x = torch.randn((2, rows // 2, 512), generator=gen, device=cuda_device)
    before = (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches)
    got = bsr_matmul(x, bc)
    torch.cuda.synchronize()
    assert (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches) \
        == (before[0] + 1, before[1])
    assert got.dtype == torch.float32 and got.shape == (2, rows // 2, 256)
    want = bsr_matmul_plain(x.reshape(rows, 512).cpu(), bc.blocks.cpu(),
                            bc.blockcol.cpu(), bc.nblocks.cpu())
    scale = max(1.0, float(want.abs().max()))
    assert float((got.reshape(rows, 256).cpu() - want).abs().max()) <= \
        1e-4 * scale


# (block, N): banks ``ops.bsr_matmul`` re-tiles (a side not a multiple of
# 16), cuts (too wide for the rows ring: 1024 -> 512 columns) or both
# ((8, 1000) -> (16, 1008) -> 144 columns) before the kernel
OP_BLOCK_CASES = [((8, 128), 512), ((24, 40), 480), ((16, 1024), 2048),
                  ((8, 1000), 2000)]


@pytest.mark.parametrize("rows", [4, 2100])
@pytest.mark.parametrize("block, n", OP_BLOCK_CASES, ids=str)
def test_bsr_matmul_op_at_any_block_launches_the_kernel(cuda_device, block,
                                                        n, rows):
    """``ops.bsr_matmul`` on a bf16 bank the kernel cannot take as it is:
    one kernel launch on the schedule of the row count (never the plain
    version on a CUDA tensor), within 1e-2 of the plain product of the
    bank as it is (one bf16 rounding of the f32 sums)."""
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense
    from repro_torch.kernels.bsr_matmul.kernel import (bsr_matmul_kernel,
                                                       schedule)
    from repro_torch.kernels.bsr_matmul.ops import bsr_matmul
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_ref

    gen = torch.Generator(device=cuda_device).manual_seed(rows + n)
    w = torch.randn((96, n), generator=gen, device=cuda_device)
    bc = bcsr_from_dense(block_prune(w, 0.5, block).to(torch.bfloat16),
                         block)
    x = torch.randn((rows, n), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    before = (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches)
    got = bsr_matmul(x, bc)
    torch.cuda.synchronize()
    wgmma = schedule(rows, torch.bfloat16) == "wgmma"
    assert (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches) \
        == (before[0] + 1, before[1] + wgmma)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 96)
    cpu = dataclasses.replace(bc, blocks=bc.blocks.cpu(),
                              blockcol=bc.blockcol.cpu(),
                              nblocks=bc.nblocks.cpu())
    want = bsr_matmul_ref(x.cpu(), cpu)
    torch.testing.assert_close(got.float().cpu(), want, rtol=1e-2,
                               atol=1e-2)


# -- BCSR matmul, the rows schedule --------------------------------------
# (rows, dtype): bf16 at the decode row counts the schedule serves, f32 at
# the f32 decode step's 2 rows, the consistency forward's 128 and a ragged
# 129 (several passes of rows over the same units).
ROWS_CASES = [(1, torch.bfloat16), (2, torch.bfloat16), (4, torch.bfloat16),
              (16, torch.bfloat16), (32, torch.bfloat16), (2, torch.float32),
              (128, torch.float32), (129, torch.float32)]


def _rows_bank(device, dtype, seed):
    """GM 32 block-rows (wk's count) over N 1024: block-row 0 keeps no tile,
    block-row 1 every one of its 64, the rest about a fifth (ragged);
    block-rows 2-5 list their tiles in reverse column order, block-row 6
    names its first column twice; padding tiles hold NaN."""
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense

    gen = torch.Generator(device=device).manual_seed(seed)
    w = block_prune(torch.randn((512, 1024), generator=gen, device=device),
                    0.8, (16, 16))
    w[:16] = 0.0
    w[16:32] = torch.randn((16, 1024), generator=gen, device=device)
    bc = bcsr_from_dense(w.to(dtype), (16, 16))
    blocks, bcol = bc.blocks.clone(), bc.blockcol.clone()
    nb = bc.nblocks.tolist()
    for i in range(2, 6):
        blocks[i, :nb[i]] = blocks[i, :nb[i]].flip(0)
        bcol[i, :nb[i]] = bcol[i, :nb[i]].flip(0)
    bcol[6, 1] = bcol[6, 0]
    kb = torch.arange(bc.kb, device=device)[None, :]
    blocks[kb >= bc.nblocks[:, None]] = float("nan")
    return blocks, bcol, bc.nblocks


@pytest.mark.parametrize("case", ROWS_CASES, ids=str)
def test_bsr_matmul_rows_schedule_matches_plain(cuda_device, case):
    """The weight-streaming rows schedule on a bank with an empty block-row,
    a block-row of 64 tiles, GM 32 (each block-row a cluster of units),
    columns out of order and repeated, and NaN padding: within 1e-4 x max(1, max |y|) of the plain
    version and of its own mirror, the empty block-row exactly 0, two
    launches bit for bit, and the bf16 output the f32 one rounded once."""
    from repro_torch.kernels.bsr_matmul.kernel import (bsr_matmul_kernel,
                                                       rows_work, schedule)
    from repro_torch.kernels.bsr_matmul.ref import (bsr_matmul_plain,
                                                    bsr_matmul_rows_plain)

    rows, dtype = case
    assert schedule(rows, dtype) == "rows"
    blocks, bcol, nb = _rows_bank(cuda_device, dtype, rows)
    x = torch.randn((rows, 1024), generator=torch.Generator(
        device=cuda_device).manual_seed(rows + 1),
        device=cuda_device).to(dtype)
    args = (x, blocks, bcol, nb)
    before = (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches)
    got = bsr_matmul_kernel(*args)
    torch.cuda.synchronize()
    assert (bsr_matmul_kernel.launches, bsr_matmul_kernel.wgmma_launches) \
        == (before[0] + 1, before[1])
    units, cols, cluster = rows_work(bcol, nb, 16, 16, x.element_size())
    assert cluster > 1                  # each block-row over a cluster
    want = bsr_matmul_plain(*args)
    scale = max(1.0, float(want.abs().max()))
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    mirror = bsr_matmul_rows_plain(*args, units)
    assert float((got - mirror).abs().max()) <= 1e-4 * scale
    assert torch.equal(got[:, :16], torch.zeros_like(got[:, :16]))
    assert torch.equal(bsr_matmul_kernel(*args), got)
    assert torch.equal(bsr_matmul_kernel(*args, out_dtype=torch.bfloat16),
                       got.to(torch.bfloat16))


# -- flash attention forward ---------------------------------------------
# (B, H, KV, T, S, d, causal, dtype)
FLASH_CASES = [
    (2, 8, 1, 200, 200, 128, True, torch.bfloat16),    # GQA 8:1, ragged T
    (2, 8, 1, 200, 200, 128, False, torch.bfloat16),
    (1, 4, 4, 77, 77, 64, True, torch.float32),
    (1, 4, 2, 64, 96, 16, False, torch.float32),       # S != T, full
    (2, 32, 4, 256, 256, 128, True, torch.bfloat16),   # Yi-9B heads
    (1, 4, 4, 77, 77, 64, True, torch.bfloat16),       # MHA, ragged
    (1, 4, 2, 64, 96, 16, False, torch.bfloat16),      # S != T, full
    (2, 4, 1, 150, 130, 32, True, torch.bfloat16),     # S < T, ragged
    # head dims 80 (HuBERT-XLarge, non-causal) and 96 (Phi-3-Vision)
    (1, 16, 16, 200, 200, 80, False, torch.bfloat16),  # HuBERT heads
    (1, 16, 16, 200, 200, 80, False, torch.float32),
    (1, 8, 2, 150, 130, 80, True, torch.bfloat16),     # GQA 4:1, S < T
    (2, 32, 32, 256, 256, 96, True, torch.bfloat16),   # Phi-3-Vision heads
    (1, 8, 2, 77, 77, 96, True, torch.float32),        # GQA 4:1, ragged
    (1, 8, 4, 64, 96, 96, False, torch.bfloat16),      # S != T, full
    # one rank's heads on a mesh (tensor-parallel modes A and B)
    (1, 8, 8, 2048, 2048, 64, True, torch.bfloat16),   # Qwen-0.5B, tp 2
    (1, 8, 8, 2048, 2048, 128, True, torch.bfloat16),  # OLMoE, tp 2
    (1, 2, 1, 512, 512, 128, True, torch.bfloat16),    # Yi-9B tp 16: B
    (1, 4, 1, 300, 300, 128, True, torch.bfloat16),    # Yi-9B tp 8: B
    (2, 1, 1, 77, 77, 16, True, torch.float32),        # one q, one kv head
]
# bf16 O: per element, one bf16 rounding of the output (2^-8 of |O|) plus
# FLASH_O_ATOL of the output's rms.  p v with p rounded to bf16 (a fault
# that leaves the softmax, and so lse, right) must exceed it.
FLASH_O_ATOL = 1e-3


def _o_excess(o, want):
    """Largest error of ``o`` against the f32 ``want`` beyond one bf16
    rounding of the output, in units of ``want``'s rms."""
    err = (o.float() - want).abs() - 2.0 ** -8 * want.abs()
    return float(err.max() / want.pow(2).mean().sqrt())


def _pv_bf16(q, k, v, *, sc, causal):
    """The plain version with p rounded to bf16 before p v: the control
    that the O check must reject."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    qf = q.reshape(b, kv, h // kv, t, d).float() * sc
    logits = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2))
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(torch.bfloat16).float(), v.float()[:, :, None])
    out = out / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, t, d).to(q.dtype)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda_device, case):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    b, h, kv, t, s, d, causal, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(t + d)
    q = torch.randn((b, h, t, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((b, kv, s, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((b, kv, s, d), generator=gen, device=cuda_device).to(dtype)
    sc = d ** -0.5
    tc = dtype == torch.bfloat16
    before = (flash_attention_fwd.launches, flash_attention_fwd.tc_launches)
    o, lse = flash_attention_fwd(q, k, v, sc=sc, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_fwd.tc_launches) \
        == (before[0] + (not tc), before[1] + tc)
    # the plain version on f32 copies: O before its rounding to q's dtype
    o_want, lse_want = flash_attention_plain(q.float(), k.float(), v.float(),
                                             sc=sc, causal=causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.bfloat16:
        assert _o_excess(o, o_want) <= FLASH_O_ATOL
        assert _o_excess(_pv_bf16(q, k, v, sc=sc, causal=causal),
                         o_want) > FLASH_O_ATOL
    else:
        assert float((o - o_want).abs().max()) <= 2e-5
    assert float((lse - lse_want).abs().max()) <= 1e-4


def test_flash_attention_reads_the_model_layout(cuda_device):
    """ops.flash_attention_bthd hands the kernel transposed views of the
    (B, T, H, d) tensors and returns O in that layout."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bthd
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((2, 70, 8, 64), generator=gen, device=cuda_device)
    k = torch.randn((2, 70, 2, 64), generator=gen, device=cuda_device)
    v = torch.randn((2, 70, 2, 64), generator=gen, device=cuda_device)
    got = flash_attention_bthd(q, k, v, causal=True)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True).transpose(1, 2)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["yi-9b", "qwen1.5-0.5b"])
def test_smoke_transformer_on_the_card_matches_the_cpu(cuda_device, arch):
    """A smoke config at sparsity 0.8 under flash attention: the forward and
    a few decode steps on the card (both kernels) against the same params on
    the CPU (their plain versions)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import sparsify_params
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import flags
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype="float32")
    cpu = torch.device("cpu")
    params = sparsify_params(
        T.init_params(cfg, torch.Generator().manual_seed(0), cpu), cfg, 0.8)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        if isinstance(tree, torch.Tensor):
            return tree.to(cuda_device)
        return dataclasses.replace(tree, blocks=to_card(tree.blocks),
                                   blockcol=to_card(tree.blockcol),
                                   nblocks=to_card(tree.nblocks))

    on_card = to_card(params)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator()
                         .manual_seed(1))
    flags.set_attn_impl("flash")
    try:
        want, _ = T.forward(params, toks, cfg)
        got, _ = T.forward(on_card, toks.to(cuda_device), cfg)
    finally:
        flags.set_attn_impl("chunked")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    step = make_serve_step(cfg)
    c_cpu = T.init_cache(cfg, 2, 8, cpu)
    c_gpu = T.init_cache(cfg, 2, 8, cuda_device)
    for i in range(8):
        n_cpu, c_cpu = step(params, toks[:, i:i + 1], c_cpu, i)
        n_gpu, c_gpu = step(on_card, toks[:, i:i + 1].to(cuda_device), c_gpu, i)
        assert torch.equal(n_gpu.cpu(), n_cpu)


# -- flash attention backward --------------------------------------------
# (B, H, KV, T, S, d, causal, dtype)
FLASH_BWD_CASES = [
    (1, 4, 4, 128, 128, 64, True, torch.float32),      # MHA
    (2, 8, 2, 200, 200, 128, True, torch.bfloat16),    # GQA 4:1, ragged T
    (1, 8, 1, 77, 77, 128, True, torch.float32),       # MQA, ragged
    (1, 4, 2, 64, 96, 16, False, torch.float32),       # bidirectional, S != T
    (2, 4, 1, 150, 150, 32, False, torch.bfloat16),    # bidirectional, ragged
    (1, 32, 4, 256, 256, 128, True, torch.bfloat16),   # Yi-9B heads
    (1, 4, 4, 128, 128, 64, True, torch.bfloat16),     # MHA
    (1, 8, 1, 77, 77, 128, True, torch.bfloat16),      # GQA 8:1, ragged
    (1, 4, 2, 64, 96, 16, False, torch.bfloat16),      # bidirectional, S != T
    (1, 4, 2, 96, 64, 64, True, torch.bfloat16),       # S < T
    (1, 4, 2, 100, 100, 16, True, torch.bfloat16),     # d 16 causal, ragged
    (1, 8, 2, 70, 70, 32, True, torch.bfloat16),       # d 32 causal, ragged
    (1, 4, 1, 90, 90, 64, False, torch.bfloat16),      # d 64 full, ragged
    (1, 4, 4, 130, 130, 128, False, torch.bfloat16),   # d 128 full, ragged
    # head dims run in a larger instantiation (24 -> 32, 48 -> 64, 112 ->
    # 128), the columns past d zero on chip
    (1, 4, 4, 100, 100, 24, True, torch.bfloat16),
    (1, 4, 2, 130, 130, 24, False, torch.float32),
    (1, 8, 2, 90, 90, 48, True, torch.bfloat16),
    (1, 4, 4, 70, 70, 48, False, torch.float32),
    (1, 4, 1, 77, 77, 112, True, torch.bfloat16),
    # HuBERT-XLarge's d 80 (bidirectional) and Phi-3-Vision's d 96 (causal)
    (1, 16, 16, 2048, 2048, 80, False, torch.bfloat16),  # HuBERT heads
    (1, 16, 16, 2000, 2000, 80, False, torch.bfloat16),  # ragged
    (1, 32, 32, 512, 512, 96, True, torch.bfloat16),     # Phi-3 heads
    (1, 32, 8, 300, 300, 96, True, torch.bfloat16),      # GQA 4:1, ragged
    (1, 4, 2, 130, 130, 80, True, torch.bfloat16),       # d 80 causal, GQA
    (1, 4, 4, 200, 150, 96, False, torch.bfloat16),      # d 96 full, S != T
    (1, 16, 16, 512, 512, 80, False, torch.float32),  # split TF32, HuBERT heads
    (1, 4, 2, 130, 130, 80, True, torch.float32),  # split TF32, GQA, ragged
    (1, 32, 32, 256, 256, 96, True, torch.float32),  # split TF32, Phi-3 heads
    (1, 8, 2, 200, 200, 96, False, torch.float32),  # split TF32, full, ragged
    # one rank's heads on a mesh (tensor-parallel modes A and B)
    (1, 8, 8, 2048, 2048, 64, True, torch.bfloat16),     # Qwen-0.5B, tp 2
    (1, 2, 1, 300, 300, 128, True, torch.bfloat16),      # Yi-9B tp 16: B
    (2, 1, 1, 77, 77, 16, True, torch.float32),          # one q, one kv
]
# f32: max |error| / rms; bf16: beyond one bf16 rounding, over the rms
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


def _grad_excess(got, want, dtype):
    rounding = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    err = (got.float() - want).abs() - rounding * want.abs()
    return float(err.max() / want.pow(2).mean().sqrt())


def _bwd_p_bf16(q, k, v, o, lse, do, *, sc, causal):
    """The plain backward with p rounded to bf16 wherever it is used (dS
    and dV): the control that the gradient check must reject."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, kv, g, t, d).float()
    dof = do.reshape(b, kv, g, t, d).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    logits = torch.matmul(qf * sc, kf.transpose(-1, -2))
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.exp(logits - lse.reshape(b, kv, g, t, 1))
    p = p.to(torch.bfloat16).float()
    delta = (dof * o.reshape(b, kv, g, t, d).float()).sum(dim=-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * sc
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=2) * sc
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2)
    return dq.reshape(b, h, t, d), dk, dv


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_attention_bwd_kernels_match_plain(cuda_device, case):
    """Both backward kernels on the (B, H, T, d) views of (B, T, H, d)
    tensors, as the autograd Function hands them over, against
    ``flash_attention_bwd_plain`` on f32 copies."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain)

    b, h, kv, t, s, d, causal, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(t + d + h)

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           device=cuda_device).to(dtype).transpose(1, 2)

    q, k, v, do = rand(b, t, h, d), rand(b, s, kv, d), rand(b, s, kv, d), \
        rand(b, t, h, d)
    sc = d ** -0.5
    o, lse = flash_attention_fwd(q, k, v, sc=sc, causal=causal)
    delta = (do.float() * o.float()).sum(dim=-1)
    tc = dtype == torch.bfloat16

    key = ("tc" if tc else "tf32", d, budget.flash_head_dim(d))

    def counts():
        return (flash_attention_bwd_dq.launches,
                flash_attention_bwd_dq.tc_launches,
                flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dkv.tc_launches,
                flash_attention_bwd_dkv.reduce_launches,
                flash_attention_bwd_dkv.tf32_reduce_launches,
                flash_attention_bwd_dq.by_head_dim.get(key, 0),
                flash_attention_bwd_dkv.by_head_dim.get(key, 0))

    before = counts()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, sc=sc, causal=causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, sc=sc,
                                     causal=causal)
    torch.cuda.synchronize()
    assert counts() == (before[0] + (not tc), before[1] + tc,
                        before[2] + (not tc), before[3] + tc, before[4] + tc,
                        before[5] + (not tc and h != kv), before[6] + 1,
                        before[7] + 1)
    assert dq.stride() == q.stride() and dk.stride() == k.stride()
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype, dtype, dtype)
    f32 = [x.float() for x in (q, k, v, o)]
    want = flash_attention_bwd_plain(*f32, lse, do.float(), sc=sc,
                                     causal=causal)
    tol = FLASH_BWD_TOL[dtype]
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert bool(torch.isfinite(got).all()), name
        assert _grad_excess(got, w, dtype) <= tol, (name, _grad_excess(
            got, w, dtype))
    if dtype == torch.bfloat16:
        control = _bwd_p_bf16(q, k, v, o, lse, do, sc=sc, causal=causal)
        for name, c, w in zip(("dq", "dk", "dv"), control, want):
            assert _grad_excess(c, w, dtype) > tol, name


@pytest.mark.parametrize("d", [144, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_wide_head_dims_launch_and_match_plain(cuda_device, d, dtype):
    """A head dim above the largest instantiation (128) is no longer
    refused: the forward, dQ and dK/dV launch their wide kernels (the
    output-column split, two 128-column slices at 144 and 256), counted
    under ``(kind, d, "128x2")``, on GQA 4:2 at a ragged T of 70, and agree
    with the plain versions (O within 2e-5 of its largest magnitude in f32,
    one bf16 rounding plus 1e-3 of its rms in bf16; the gradients within
    FLASH_BWD_TOL)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain)

    assert d > budget.FLASH_HEAD_DIMS[-1] and budget.flash_wide(d)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v, do = (torch.randn((1, 70, h, d), generator=gen,
                               device=cuda_device).to(dtype).transpose(1, 2)
                   for h in (4, 2, 2, 4))
    sc = d ** -0.5
    tc = dtype == torch.bfloat16
    key = ("tc" if tc else "tf32", d, "128x2")
    assert budget.flash_instance(d) == key[2]
    wrappers = (fk.flash_attention_fwd, fk.flash_attention_bwd_dq,
                fk.flash_attention_bwd_dkv)
    before = [w.by_head_dim.get(key, 0) for w in wrappers]
    o, lse = fk.flash_attention_fwd(q, k, v, sc=sc, causal=True)
    delta = fk.bwd_delta(o, do)
    dq = fk.flash_attention_bwd_dq(q, k, v, do, lse, delta, sc=sc,
                                   causal=True)
    dk, dv = fk.flash_attention_bwd_dkv(q, k, v, do, lse, delta, sc=sc,
                                        causal=True)
    torch.cuda.synchronize()
    assert [w.by_head_dim.get(key, 0) for w in wrappers] == [
        n + 1 for n in before]
    want_o, want_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                             sc=sc, causal=True)
    assert bool(torch.isfinite(o).all())
    if tc:
        excess = ((o.float() - want_o).abs() - 2.0 ** -8 * want_o.abs())
        assert float(excess.max() / want_o.pow(2).mean().sqrt()) <= 1e-3
    else:
        assert float((o - want_o).abs().max() / want_o.abs().max()) <= 2e-5
    assert float((lse - want_lse).abs().max()) <= 1e-4
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), sc=sc,
                                     causal=True)
    tol = FLASH_BWD_TOL[dtype]
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert bool(torch.isfinite(got).all()), name
        assert _grad_excess(got, w, dtype) <= tol, (name, _grad_excess(
            got, w, dtype))


def _attention_f64(q, k, v, *, causal):
    """``attention_ref``'s naive softmax attention in float64 (it computes
    in f32): q (B, H, T, d), k/v (B, KV, S, d) -> (B, H, T, d)."""
    g = q.shape[1] // k.shape[1]
    k, v = (x.double().repeat_interleave(g, dim=1) for x in (k, v))
    logits = torch.matmul(q.double(), k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        t, s = logits.shape[-2:]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.matmul(torch.softmax(logits, dim=-1), v)


@pytest.mark.parametrize("d, causal", [(80, False), (96, True)])
def test_flash_backward_at_80_and_96_matches_attention_ref(cuda_device, d,
                                                           causal):
    """Autograd through ``flash_attention_bthd`` at a ragged T of 2000 in
    f32 (the split-TF32 dQ and dK/dV, whose counters at the head dim move,
    with its group sum: 8 query heads over 4) against
    autograd through ``attention_ref``'s naive attention in float64 on the
    same values: each gradient within 1e-4 of its largest magnitude
    (``chip_smoke.py``'s rule for the f32 kernels: causal dV's first keys
    sum up to 2000 terms and are far above its rms, and their f32 rounding
    reaches ~1.1e-4 of the rms).  (The f32 oracle itself sums by another
    formula, sum(p dp) for delta; in bf16 the kernels' O is rounded before
    delta = rowsum(dO O), and the bf16 cases hold the kernels to the plain
    backward on the same O, above.)"""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention_bthd

    gen = torch.Generator(device=cuda_device).manual_seed(d + 2000)
    leaves = [torch.randn((1, 2000, h, d), generator=gen, device=cuda_device)
              .requires_grad_() for h in (8, 4, 4)]
    co = torch.randn((1, 2000, 8, d), generator=gen, device=cuda_device)
    key = ("tf32", d, budget.flash_head_dim(d))
    before = (fk.flash_attention_bwd_dq.by_head_dim.get(key, 0),
              fk.flash_attention_bwd_dkv.by_head_dim.get(key, 0),
              fk.flash_attention_bwd_dkv.tf32_reduce_launches)
    (flash_attention_bthd(*leaves, causal=causal) * co).sum().backward()
    torch.cuda.synchronize()
    assert (fk.flash_attention_bwd_dq.by_head_dim[key],
            fk.flash_attention_bwd_dkv.by_head_dim[key],
            fk.flash_attention_bwd_dkv.tf32_reduce_launches) == (
                before[0] + 1, before[1] + 1, before[2] + 1)
    ref = [x.detach().double().transpose(1, 2).requires_grad_()
           for x in leaves]
    (_attention_f64(*ref, causal=causal).transpose(1, 2) * co.double()) \
        .sum().backward()
    for name, x, w in zip(("dq", "dk", "dv"), leaves, ref):
        got = x.grad.transpose(1, 2)
        assert bool(torch.isfinite(got).all()), name
        err = float((got.double() - w.grad).abs().max())
        assert err <= 1e-4 * float(w.grad.abs().max()), (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
def test_flash_dkv_is_bit_identical_across_launches(cuda_device, d, dtype):
    """Both dK/dV kernels (tensor-core for bf16, split TF32 for f32) sum
    each kv head's G query heads in a fixed order, with no atomics: two
    launches on the same operands agree bit for bit (GQA 8:1, causal,
    ragged)."""
    from repro_torch.kernels.flash_attention.kernel import (
        bwd_delta, flash_attention_bwd_dkv, flash_attention_fwd)

    gen = torch.Generator(device=cuda_device).manual_seed(d)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(
            dtype).transpose(1, 2)

    q, k, v, do = rand(2, 333, 16, d), rand(2, 333, 2, d), \
        rand(2, 333, 2, d), rand(2, 333, 16, d)
    sc = d ** -0.5
    o, lse = flash_attention_fwd(q, k, v, sc=sc, causal=True)
    delta = bwd_delta(o, do)
    first = flash_attention_bwd_dkv(q, k, v, do, lse, delta, sc=sc,
                                    causal=True)
    second = flash_attention_bwd_dkv(q, k, v, do, lse, delta, sc=sc,
                                     causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
def test_flash_dq_is_bit_identical_across_launches(cuda_device, d, dtype):
    """Both dQ kernels (tensor-core for bf16, split TF32 for f32) write
    each element from one thread, with no atomics: two launches on the same
    operands agree bit for bit (GQA 8:1, causal, ragged)."""
    from repro_torch.kernels.flash_attention.kernel import (
        bwd_delta, flash_attention_bwd_dq, flash_attention_fwd)

    gen = torch.Generator(device=cuda_device).manual_seed(d + 1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(
            dtype).transpose(1, 2)

    q, k, v, do = rand(2, 333, 16, d), rand(2, 333, 2, d), \
        rand(2, 333, 2, d), rand(2, 333, 16, d)
    sc = d ** -0.5
    o, lse = flash_attention_fwd(q, k, v, sc=sc, causal=True)
    delta = bwd_delta(o, do)
    attr = "tc_launches" if dtype == torch.bfloat16 else "launches"
    before = getattr(flash_attention_bwd_dq, attr)
    first, second = (flash_attention_bwd_dq(q, k, v, do, lse, delta, sc=sc,
                                            causal=True) for _ in range(2))
    torch.cuda.synchronize()
    assert getattr(flash_attention_bwd_dq, attr) == before + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_kernels_are_chosen_by_dtype(cuda_device, dtype):
    """f32 operands launch the split-TF32 forward, dQ and dK/dV (and its
    group sum: 8 query heads over 2), bf16 operands the tensor-core ones
    (and dK/dV's group sum); each wrapper counts its instantiation,
    ("tf32" | "tc", d)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention_bthd

    counters = ((fk.flash_attention_fwd, "launches"),
                (fk.flash_attention_fwd, "tc_launches"),
                (fk.flash_attention_bwd_dq, "launches"),
                (fk.flash_attention_bwd_dq, "tc_launches"),
                (fk.flash_attention_bwd_dkv, "launches"),
                (fk.flash_attention_bwd_dkv, "tc_launches"),
                (fk.flash_attention_bwd_dkv, "reduce_launches"),
                (fk.flash_attention_bwd_dkv, "tf32_reduce_launches"))
    tc = dtype == torch.bfloat16
    keys = ((fk.flash_attention_fwd, ("tc" if tc else "tf32", 64, 64)),
            (fk.flash_attention_bwd_dq, ("tc" if tc else "tf32", 64, 64)),
            (fk.flash_attention_bwd_dkv, ("tc" if tc else "tf32", 64, 64)))
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    leaves = [torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
              .requires_grad_() for shape in
              ((1, 96, 8, 64), (1, 96, 2, 64), (1, 96, 2, 64))]
    before = [getattr(fn, attr) for fn, attr in counters]
    by_dim = [fn.by_head_dim.get(key, 0) for fn, key in keys]
    flash_attention_bthd(*leaves, causal=True).sum().backward()
    torch.cuda.synchronize()
    ran = [getattr(fn, attr) - b_ for (fn, attr), b_ in zip(counters,
                                                             before)]
    assert ran == [int(not tc), int(tc), int(not tc), int(tc), int(not tc),
                   int(tc), int(tc), int(not tc)]
    assert [fn.by_head_dim.get(key, 0) - b_
            for (fn, key), b_ in zip(keys, by_dim)] == [1, 1, 1]


def test_flash_attention_is_differentiable_on_the_card(cuda_device):
    """flash_attention_bthd goes through the autograd Function: q, k and v
    get gradients on the card, from the backward kernels, that match the
    plain backward's on the CPU."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from repro_torch.kernels.flash_attention.ops import flash_attention_bthd

    gen = torch.Generator().manual_seed(4)
    leaves = [torch.randn(shape, generator=gen) for shape in
              ((2, 70, 8, 64), (2, 70, 2, 64), (2, 70, 2, 64))]
    w = torch.randn((2, 70, 8, 64), generator=gen)
    grads = {}
    for dev in ("cpu", cuda_device):
        q, k, v = [x.detach().to(dev).requires_grad_() for x in leaves]
        out = flash_attention_bthd(q, k, v, causal=True)
        node = out.grad_fn.next_functions[0][0]
        assert type(node).__name__ == "FlashAttentionBackward"
        before = (flash_attention_bwd_dq.launches,
                  flash_attention_bwd_dkv.launches)
        (out * w.to(dev)).sum().backward()
        after = (flash_attention_bwd_dq.launches,
                 flash_attention_bwd_dkv.launches)
        assert k.grad is not None
        assert after == (before if dev == "cpu" else
                         (before[0] + 1, before[1] + 1))
        grads[str(dev)] = [x.grad.cpu() for x in (q, k, v)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_smoke_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One ``make_train_step`` step of the f32 yi-9b smoke config under
    flash attention: on the card (forward and both backward kernels in every
    layer) and on the CPU (their plain versions), from the same state."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import flags
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(configs.get_config("yi-9b", smoke=True),
                              dtype="float32")
    opt_cfg = AdamWConfig()
    cpu = init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda x: x.to(cuda_device), cpu)
    toks = torch.randint(0, cfg.vocab, (2, 97),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, opt_cfg, total_steps=10)
    flags.set_attn_impl("flash")
    try:
        want, m_cpu = step(cpu, batch)
        counts = [k.launches for k in (flash_attention_fwd,
                                       flash_attention_bwd_dq,
                                       flash_attention_bwd_dkv)]
        got, m_card = step(card, batch)
        torch.cuda.synchronize()
    finally:
        flags.set_attn_impl("chunked")
    assert [k.launches - c for k, c in zip(
        (flash_attention_fwd, flash_attention_bwd_dq,
         flash_attention_bwd_dkv), counts)] == [cfg.n_layers] * 3
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_card[key].cpu(), m_cpu[key],
                                   rtol=1e-4, atol=1e-4)
    tree_map(lambda a, b_: torch.testing.assert_close(
        a.cpu(), b_, rtol=1e-4, atol=1e-4), got["params"], want["params"])


def test_bf16_moe_group_on_the_card_matches_the_cpu(cuda_device):
    """A bf16 OLMoE smoke layer's ``_moe_group`` on the card (cuBLAS
    products with f32 results) against the CPU (the operands multiplied
    in f32), on the same weights and tokens, with drops: every element
    within one bf16 rounding plus 1e-4 x max |cpu|, at most 1 % differ
    (f32 sums in another order round to the neighbouring bf16 value)."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_map

    cfg = configs.get_config("olmoe-1b-7b", smoke=True)
    cpu = L.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    card = tree_map(lambda x: x.to(cuda_device), cpu)
    xg = torch.randn((64, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)).to(
                         torch.bfloat16)
    cap = L.moe_capacity(64, cfg, 0.5)
    want = L._moe_group(cpu, xg, cfg, cap).float()
    got = L._moe_group(card, xg.to(cuda_device), cfg, cap).float().cpu()
    scale = float(want.abs().max())
    excess = (got - want).abs() - (2.0 ** -8 * want.abs() + 1e-4 * scale)
    assert float(excess.max()) <= 0.0
    assert float((got != want).float().mean()) <= 0.01


def test_bf16_expert_products_backward_on_the_card(cuda_device):
    """``_bmm_f32`` on bf16 operands on the card records a product whose
    backward runs on bf16 operands (the f32 gradient rounded once): its
    output and both gradients against the CPU's f32 products on the same
    values, within 1e-2 of the norm (one bf16 rounding of the gradient and
    of each result), the gradients in the operands' dtype."""
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(2)
    a = torch.randn((4, 64, 96), generator=gen).to(torch.bfloat16)
    b = torch.randn((4, 96, 80), generator=gen).to(torch.bfloat16)
    w = torch.randn((4, 64, 80), generator=gen)
    res = {}
    for dev in ("cpu", cuda_device):
        ad = a.to(dev).detach().requires_grad_()
        bd = b.to(dev).detach().requires_grad_()
        y = L._bmm_f32(ad, bd)
        (y * w.to(dev)).sum().backward()
        assert y.dtype == torch.float32
        assert ad.grad.dtype == bd.grad.dtype == torch.bfloat16
        res[str(dev)] = [t.detach().float().cpu() for t in (y, ad.grad,
                                                           bd.grad)]
    for got, want in zip(res[str(cuda_device)], res["cpu"]):
        assert float((got - want).norm() / want.norm()) <= 1e-2


# -- quantised banks, tall BCSR blocks, and method="auto" on the card -------

QUANT = ("int8", "float8_e4m3fn")


@pytest.mark.parametrize("value_dtype", QUANT)
@pytest.mark.parametrize("case", ELL_CASES)
def test_quantised_ell_kernel_is_the_f32_kernel_on_the_dequantised_bank(
        cuda_device, case, value_dtype):
    """Bit for bit, pipelined and blocking, natural and balanced: each
    value times its row's scale is rounded once, as ``dequantize``
    rounds it."""
    from repro_torch.core.sparse_format import dequantize, quantize_values

    n, c, h, m, r, stride, pad, sp, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, sp)
    e, f = out_spatial(h, h, r, r, stride, pad)
    xt = torch.from_numpy(x).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
        cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, m, e, f)).astype(
        np.float32)).to(cuda_device) if with_res else None)
    kw = dict(stride=stride, padding=pad, bias=bias, fuse_relu=relu,
              residual=res)
    for balance in (False, True):
        q = quantize_values(ell_from_dense_conv(w, balance=balance,
                                                device=cuda_device),
                            value_dtype)
        d = dequantize(q)
        for pipeline in (None, False):
            before = sparse_conv_kernel.launches
            got = sparse_conv(xt, q, pipeline=pipeline, **kw)
            torch.cuda.synchronize()
            assert sparse_conv_kernel.launches == before + 1
            torch.testing.assert_close(
                got, sparse_conv(xt, d, pipeline=pipeline, **kw), rtol=0,
                atol=0)
            sched, _ = _ell_schedules(m, q, n, c, h, r, stride, pad, e, f)
            xpad = pad_in(xt, pad)
            b, rr = bias, res
            if q.perm is not None:
                perm = q.perm.long()
                b = b.index_select(0, perm)
                rr = None if rr is None else rr.index_select(1, perm)
            plain = sparse_conv_plain(
                xpad, q.value, pack_indices(q), q.nnz, b, rr, rs=r * r,
                s=r, e=e, f=f, stride=stride, fuse_relu=relu, scale=q.scale)
            kern = sparse_conv_kernel(
                xpad, q.value, pack_indices(q), q.nnz, b, rr, rs=r * r,
                s=r, e=e, f=f, stride=stride, fuse_relu=relu,
                schedule=sched, scale=q.scale)
            torch.testing.assert_close(kern, plain, rtol=0, atol=0)


TALL_CASES = [
    (2, 16, 12, 70, 3, 1, 1, (32, 128), True, True),   # M % 32, CRS % bn
    (2, 64, 14, 64, 1, 2, 0, (64, 128), False, True),  # stride-2 1x1
    (8, 64, 7, 72, 3, 1, 1, (64, 128), True, True),    # 49 pixels an image
    (1, 24, 17, 40, 5, 1, 2, (32, 128), True, False),  # ragged E*F
]


@pytest.mark.parametrize("value_dtype", (None,) + QUANT)
@pytest.mark.parametrize("case", TALL_CASES + BSR_CASES[:2])
def test_quantised_and_tall_bsr_kernel_matches_plain(cuda_device, case,
                                                     value_dtype):
    """Within 1e-4 x (1 + max |y|) of the plain version (which scales the
    sums as the kernel does), at every tile that holds whole block-rows."""
    from repro_torch.core.sparse_format import quantize_values
    from repro_torch.kernels.bsr_conv.ref import bsr_conv_plain

    n, c, h, m, r, stride, pad, block, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, 0.6)
    bc = bcsr_conv_from_dense(w, block=block, device=cuda_device)
    if value_dtype is not None:
        bc = quantize_values(bc, value_dtype)
    e, f = out_spatial(h, h, r, r, stride, pad)
    mpad = bc.gbm * block[0]
    xpad = pad_in(torch.from_numpy(x).to(cuda_device), pad)
    bias = torch.zeros(mpad, device=cuda_device)
    bias[:m] = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
        cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, mpad, e, f)).astype(
        np.float32)).to(cuda_device) if with_res else None)
    args = (xpad, bc.blocks, bc.blockcol, bc.nblocks, bias, res)
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu,
              scale=bc.scale)
    want = bsr_conv_plain(*args, **kw)
    limit = 1e-4 * (1 + float(want.abs().max()))
    tiles = [(t, g) for t, g in budget.BSR_CONV_TILES if t % block[0] == 0]
    assert tiles
    for n_tile, wgs in tiles:
        before = bsr_conv_kernel.launches
        got = bsr_conv_kernel(*args, n_tile=n_tile, wgs=wgs, **kw)
        torch.cuda.synchronize()
        assert bsr_conv_kernel.launches == before + 1
        assert float((got - want).abs().max()) <= limit, (n_tile, wgs)
    if block[0] == 64:
        with pytest.raises(ValueError, match="whole block-rows"):
            bsr_conv_kernel(*args, n_tile=32, wgs=1, **kw)


def _alexnet_slice(device):
    import dataclasses as dc

    from repro_torch.engine import lower, spec
    from repro_torch.models import cnn

    convs = [l for l, _ in cnn.conv_layer_shapes(cnn.alexnet(), 3, 224)]
    picked = ([next(l for l in convs if l.sparsity == 0)]
              + [l for l in convs if l.sparsity > 0][:2])
    net = []
    for l in picked:
        net += [dc.replace(l, out_c=max(8, min(64, l.out_c // 4)), stride=1),
                spec.Relu()]
    params = cnn.init_cnn(net, 3, np.random.default_rng(0), 32, device=device)
    return net, lower(net, (3, 32, 32)), params


def test_auto_runs_a_wall_plan_on_the_card(cuda_device, tmp_path):
    """An AlexNet slice tuned in wall mode on the card (every method
    measured, the kernels included), the plan saved and reloaded with every
    layer a cache hit, then ``auto`` from it against ``dense``."""
    from repro_torch import telemetry
    from repro_torch.engine import CnnEngine
    from repro_torch.tuning import PlanCache, plan_program

    net, program, params = _alexnet_slice(cuda_device)
    path = str(tmp_path / "wall.json")
    plan = plan_program(program, batch=4, mode="wall",
                        cache=PlanCache(path), params=params,
                        device=cuda_device, iters=3)
    assert all(pe.source == "measured" for n, pe in plan.items()
               if params[n].get("ell") is not None)
    back = PlanCache(path)
    replan = plan_program(program, batch=4, mode="wall", cache=back,
                          params=params, device=cuda_device)
    assert replan == plan
    assert all(pe.provenance in ("cache_hit", "default")
               for pe in replan.values())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 3, 32, 32)).astype(np.float32)).to(cuda_device)
    eng = CnnEngine(program, params, replan, device=cuda_device)
    with telemetry.enabled():
        y = eng(x, "auto")
    assert eng.last_report.fallback_count == 0
    want = eng(x, "dense")
    torch.cuda.synchronize()
    assert float((y - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


def test_a_plan_pinning_a_tile_the_card_lacks_raises(cuda_device):
    from repro_torch.engine import CnnEngine
    from repro_torch.tuning import PlanEntry

    net, program, params = _alexnet_slice(cuda_device)
    layer = next(n for n, e in params.items()
                 if isinstance(e, dict) and "ell" in e)
    x = torch.zeros((1, 3, 32, 32), device=cuda_device)
    for entry, reason in ((PlanEntry(method="pallas", tm=4), "unsupported_tm"),
                          (PlanEntry(method="bsr", block_m=128,
                                     block_n=128), "unsupported_block")):
        eng = CnnEngine(program, params, {layer: entry}, device=cuda_device)
        with pytest.raises(ValueError, match=f"{layer}.*{reason}"):
            eng(x, "auto")


def test_strict_bind_on_the_card(cuda_device):
    """``strict=True`` verifies against the card: a plan the card's kernels
    run binds (fp8 included, allowed on ``cuda``) and its forward launches
    them; a tile the card lacks is refused at bind; and a statically clean
    entry launches while a flagged one raises from the forward."""
    from repro_torch.analysis import PreflightError
    from repro_torch.engine import CnnEngine
    from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel
    from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel
    from repro_torch.tuning import PlanEntry

    net, program, params = _alexnet_slice(cuda_device)
    sparse = [op.name for op in program.conv_ops if op.sparsity > 0]
    plan = {sparse[0]: PlanEntry(method="pallas", tm=8, fuse=True,
                                 pipeline=True),
            sparse[1]: PlanEntry(method="bsr", block_m=16, block_n=128,
                                 fuse=True, value_dtype="float8_e4m3fn")}
    eng = CnnEngine(program, params, plan, strict=True, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 3, 32, 32)).astype(np.float32)).to(cuda_device)
    launches = (sparse_conv_kernel.launches, bsr_conv_kernel.launches)
    y = eng(x, "auto")
    torch.cuda.synchronize()
    assert (sparse_conv_kernel.launches - launches[0],
            bsr_conv_kernel.launches - launches[1]) == (1, 1)
    want = eng(x, "dense")
    rel = float(torch.linalg.norm(y - want) / torch.linalg.norm(want))
    assert rel < 0.05
    bad = {sparse[0]: PlanEntry(method="pallas", tm=31)}
    with pytest.raises(PreflightError) as exc:
        CnnEngine(program, params, bad, strict=True, device=cuda_device)
    assert {d.rule for d in exc.value.diagnostics} == {"sched.unsupported_tm"}
    with pytest.raises(ValueError, match="unsupported_tm"):
        CnnEngine(program, params, bad, device=cuda_device)(x, "auto")


def test_slice_server_on_the_card(cuda_device):
    """``RobustCnnServer`` on the card over an AlexNet slice with a chaos
    seed that corrupts a pinned ELL plan: nothing lost, a rung dropped for
    ``sched.unsupported_tm``, each completed image within 1e-4 of a dense
    forward of its own padded image (f32 rungs; 0.05 relative norm on the
    int8 rung)."""
    from repro_torch.engine import CnnEngine
    from repro_torch.serving import (BucketSpec, ChaosConfig, ChaosInjector,
                                     InferenceRequest, RobustCnnServer,
                                     VirtualClock, arrival_trace)
    from repro_torch.tuning import PlanEntry

    net, program, params = _alexnet_slice(cuda_device)

    def pinned(prog, _batch):
        return {op.name: (PlanEntry(method="pallas", tm=8, fuse=True)
                          if op.sparsity > 0 else PlanEntry(method="dense"))
                for op in prog.conv_ops}

    chaos = ChaosInjector(ChaosConfig(seed=0, step_fault_rate=0.35,
                                      plan_corruption_rate=0.5,
                                      straggler_rate=0.1))
    buckets = [BucketSpec(3, 32, 32, batch=4), BucketSpec(3, 24, 24, batch=4)]
    srv = RobustCnnServer(net, params, buckets, plan=pinned, chaos=chaos,
                          clock=VirtualClock(), queue_depth=16,
                          max_attempts=6, device=cuda_device)
    trace = arrival_trace(32, [(3, 32, 32), (3, 24, 24), (3, 20, 20)],
                          seed=1, mean_gap_s=0.0005, deadline_s=(1.0, 2.0))
    rng = np.random.default_rng(3)
    images = {a.rid: rng.standard_normal(a.shape).astype(np.float32)
              for a in trace}
    rep = srv.run_trace(trace, request_factory=lambda a: InferenceRequest(
        rid=a.rid, x=images[a.rid], deadline_s=a.deadline_s)).verify()
    assert {r for d in rep.dropped_rungs for r in d["preflight_errors"]} == {
        "sched.unsupported_tm"}
    assert rep.completed > 0
    engines = {b.spec.key: b for b in srv._buckets}
    for r in srv.requests:
        if r.status != "done":
            continue
        spec = engines[r.bucket].spec
        x = np.zeros((1,) + spec.shape, np.float32)
        c, h, w = images[r.rid].shape
        x[0, :c, :h, :w] = images[r.rid]
        want = CnnEngine(engines[r.bucket].program, params,
                         device=cuda_device)(x, "dense").cpu().numpy()[0]
        if r.rung == "quantised":
            assert (np.linalg.norm(r.result - want)
                    / np.linalg.norm(want)) < 0.05
        else:
            np.testing.assert_allclose(
                r.result, want, rtol=0,
                atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_quickstart_on_the_card_matches_the_cpu(cuda_device, capsys):
    """``examples/quickstart.py`` on the card: the ELL conv and the BCSR
    matmul kernels launch, and every method's output is within the CNN
    methods' bound (1e-4 x max(1, max |dense|)) of the same script's
    ``dense`` output on the CPU."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul_kernel
    from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel

    want = quickstart.main(["--device", "cpu"])
    before = (sparse_conv_kernel.launches, bsr_matmul_kernel.launches)
    got = quickstart.main(["--device", "cuda"])
    assert "quickstart OK" in capsys.readouterr().out
    assert (sparse_conv_kernel.launches - before[0],
            bsr_matmul_kernel.launches - before[1]) == (1, 1)
    for name, out in got.items():
        ref = want["dense linear" if "linear" in name else "dense  (cuDNN)"]
        limit = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= limit, name


# ---------------------------------------------------------------------------
# the conv kernels on bf16 activations
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def _bf16_within_one_ulp(got, want):
    """bf16 results of f32 sums taken in two orders: within one bf16 ulp,
    2^-7 |want| + 2^-8 max(1, max |want|)."""
    assert got.dtype == want.dtype == BF16
    g, w = got.float(), want.float()
    tol = 2.0 ** -7 * w.abs() + 2.0 ** -8 * max(1.0, float(w.abs().max()))
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


@pytest.mark.parametrize("value_dtype", (None,) + QUANT)
@pytest.mark.parametrize("case", ELL_CASES)
def test_sparse_conv_kernel_bf16_matches_plain(cuda_device, case,
                                               value_dtype):
    """bf16 xpad, residual and output (a bf16 or quantised bank): bit for
    bit the plain version, pipelined, blocking and at every tile, through
    the launcher and through ``ops.sparse_conv`` (which pads an odd
    width); and within 3e-2 of the f32 kernel on the same weights."""
    from repro_torch.core.sparse_format import quantize_values
    from repro_torch.kernels.sparse_conv.ref import slab_width

    n, c, h, m, r, stride, pad, sp, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, sp)
    ell = ell_from_dense_conv(w, device=cuda_device)
    ell = (dataclasses.replace(ell, value=ell.value.to(BF16))
           if value_dtype is None else quantize_values(ell, value_dtype))
    e, f = out_spatial(h, h, r, r, stride, pad)
    xt = torch.from_numpy(x).to(cuda_device, BF16)
    bias = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
        cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, m, e, f)).astype(
        np.float32)).to(cuda_device, BF16) if with_res else None)
    wp = h + 2 * pad
    xpad = pad_in(xt, pad)
    if r > 1:
        xpad = torch.nn.functional.pad(xpad, (0, slab_width(wp, 2) - wp))
    args = (xpad, ell.value, pack_indices(ell), ell.nnz, bias, res)
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu,
              scale=ell.scale)
    want = sparse_conv_plain(*args, **kw)
    assert want.dtype == BF16
    # a bf16 bank asks for the paired slab, as ops.sparse_conv does
    geo = dict(n=n, c=c, r=r, s=r, stride=stride, hp=wp, wp=wp, itemsize=2,
               paired=value_dtype is None)
    for pipeline in (None, False, True):
        sched, reason = resolve_schedule(m, ell.k, e, f, pipeline=pipeline,
                                         **geo)
        assert reason is None
        before = sparse_conv_kernel.bf16_launches
        got = sparse_conv_kernel(*args, schedule=sched, **kw)
        torch.cuda.synchronize()
        assert sparse_conv_kernel.bf16_launches == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for tm, px in budget.ELL_TILES:
        sched, _ = resolve_schedule(m, ell.k, e, f, tm=tm, tp=32 * px, **geo)
        torch.testing.assert_close(
            sparse_conv_kernel(*args, schedule=sched, **kw), want, rtol=0,
            atol=0)
    ops_kw = dict(stride=stride, padding=pad, bias=bias, fuse_relu=relu)
    torch.testing.assert_close(sparse_conv(xt, ell, residual=res, **ops_kw),
                               want, rtol=0, atol=0)
    if value_dtype is None:
        f32 = sparse_conv(xt.float(), dataclasses.replace(
            ell, value=ell.value.float()), residual=None if res is None
            else res.float(), **ops_kw)
        torch.testing.assert_close(want.float(), f32, rtol=3e-2, atol=3e-2)


# (N, C, H, M, R, stride, pad, residual, relu): the bf16 bank's words,
# fmaf and the paired slab (or paired 1x1 loads) where stride 1 allows
BF16_DESIGN_CASES = [
    (2, 16, 12, 24, 3, 1, 1, True, True),      # 3x3, tiles cross images
    (2, 24, 13, 20, 3, 1, 1, False, True),     # odd padded width 15 -> 16
    (1, 12, 27, 32, 5, 1, 2, True, True),      # 5x5, 31 -> 32 wide
    (8, 64, 7, 48, 3, 1, 1, True, True),       # 49 pixels an image
    (2, 32, 14, 40, 1, 1, 0, True, True),      # 1x1, paired loads
    (2, 32, 7, 40, 1, 1, 0, False, True),      # 1x1, odd width: unpaired
    (2, 12, 19, 8, 3, 2, 1, True, True),       # stride 2: unpaired words
]


@pytest.mark.parametrize("case", BF16_DESIGN_CASES, ids=str)
def test_sparse_conv_bf16_words_and_pairs_match_plain(cuda_device, case):
    """A bf16 bank on bf16 activations: bit for bit the plain version at
    every tile the source instantiates, with the paired slab (blocking,
    its only schedule) and unpaired, pipelined and blocking; the bank
    widened to f32 (the (offset, f32 value) pairs, multiply and add
    rounded apart) gives the same bits, so fmaf changes none."""
    from repro_torch.kernels.sparse_conv.ref import entry_format, slab_width

    n, c, h, m, r, stride, pad, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, 0.6)
    ell = ell_from_dense_conv(w, device=cuda_device)
    ell = dataclasses.replace(ell, value=ell.value.to(BF16))
    e, f = out_spatial(h, h, r, r, stride, pad)
    xt = torch.from_numpy(x).to(cuda_device, BF16)
    bias = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
        cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, m, e, f)).astype(
        np.float32)).to(cuda_device, BF16) if with_res else None)
    wp = h + 2 * pad
    xpad = pad_in(xt, pad)
    if r > 1:
        xpad = torch.nn.functional.pad(xpad, (0, slab_width(wp, 2) - wp))
    args = (xpad, ell.value, pack_indices(ell), ell.nnz, bias, res)
    wide = (xpad, ell.value.float()) + args[2:]
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu)
    want = sparse_conv_plain(*args, **kw)
    geo = dict(n=n, c=c, r=r, s=r, stride=stride, hp=wp, wp=wp, itemsize=2)
    paired_seen = False
    for tm, px in budget.ELL_TILES:
        for pipeline in (None, False, True):
            for paired in (True, False):
                sched, reason = resolve_schedule(
                    m, ell.k, e, f, tm=tm, tp=32 * px, pipeline=pipeline,
                    paired=paired, **geo)
                assert reason is None
                words, pairs = entry_format(BF16, 2, r * r, r,
                                            xpad.shape[3], sched)
                assert words and pairs == sched.paired
                paired_seen |= pairs
                before = sparse_conv_kernel.bf16_launches
                got = sparse_conv_kernel(*args, schedule=sched, **kw)
                torch.cuda.synchronize()
                assert sparse_conv_kernel.bf16_launches == before + 1
                torch.testing.assert_close(got, want, rtol=0, atol=0)
                torch.testing.assert_close(
                    sparse_conv_kernel(*wide, schedule=sched, **kw), want,
                    rtol=0, atol=0)
    assert paired_seen == (stride == 1 and (r > 1 or f % 2 == 0))


@pytest.mark.parametrize("value_dtype", (None, "int8"))
@pytest.mark.parametrize("case", BSR_CASES + TALL_CASES[:2])
def test_bsr_conv_kernel_bf16_matches_plain(cuda_device, case, value_dtype):
    """bf16 xpad, residual and output on bf16 (or int8) tiles, one bf16
    wgmma a 16-deep step: within one bf16 ulp of the plain version at
    every bf16 tile holding whole block-rows (N = 128 included), and within
    3e-2 of the f32 kernel on the widened tiles."""
    from repro_torch.core.sparse_format import quantize_values
    from repro_torch.kernels.bsr_conv.ref import bsr_conv_plain

    n, c, h, m, r, stride, pad, block, with_res, relu = case
    x, w, rng = _case(hash(case) % 2**31, n, c, h, m, r, 0.6)
    bc = bcsr_conv_from_dense(w, block=block, device=cuda_device)
    bc = (dataclasses.replace(bc, blocks=bc.blocks.to(BF16))
          if value_dtype is None else quantize_values(bc, value_dtype))
    e, f = out_spatial(h, h, r, r, stride, pad)
    mpad = bc.gbm * block[0]
    xt = torch.from_numpy(x).to(cuda_device, BF16)
    bias = torch.zeros(mpad, device=cuda_device)
    bias[:m] = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
        cuda_device)
    res = (torch.from_numpy(rng.standard_normal((n, mpad, e, f)).astype(
        np.float32)).to(cuda_device, BF16) if with_res else None)
    args = (pad_in(xt, pad), bc.blocks, bc.blockcol, bc.nblocks, bias, res)
    kw = dict(rs=r * r, s=r, e=e, f=f, stride=stride, fuse_relu=relu,
              scale=bc.scale)
    want = bsr_conv_plain(*args, **kw)
    for n_tile, wgs in [(t, g) for t, g in budget.bsr_conv_tiles(2)
                        if t % block[0] == 0]:
        before = bsr_conv_kernel.bf16_launches
        got = bsr_conv_kernel(*args, n_tile=n_tile, wgs=wgs, **kw)
        torch.cuda.synchronize()
        assert bsr_conv_kernel.bf16_launches == before + 1
        _bf16_within_one_ulp(got, want)
    if value_dtype is None:
        f32 = bsr_conv_kernel(args[0].float(), bc.blocks.float(), *args[2:5],
                              None if res is None else res.float(), **kw)
        torch.testing.assert_close(want.float(), f32, rtol=3e-2, atol=3e-2)
        with pytest.raises(ValueError, match="bf16 activations"):
            bsr_conv_kernel(args[0], bc.blocks.float(), *args[2:], **kw)
