"""The numerical design of the split-TF32 flash backward kernels, on the CPU.

The f32 dQ and dK/dV kernels (``flash_bwd_dq_tf32_kernel``,
``flash_bwd_dkv_tf32_kernel``) run every product on the tensor cores in
TF32: each f32 operand x as two halves, hi = x itself and lo = x - hi's
top 19 bits, which the tensor cores read with their low 13 bits cleared
(``tf32``), and three products hi hi + hi lo + lo hi summed in f32.  The
port's plain
mirror of that arithmetic (``flash_attention_bwd_tf32_plain``) goes against
the JAX package's kernel (``flash_attention`` in interpret mode, f32
throughout, and ``jax.grad`` through it) on the same seeded inputs, GQA
4:1, d 64, 80 and 128, causal and bidirectional, T a multiple of the
reference's 64-row chunk.  Each gradient is held to the card's check
(``chip_smoke.FLASH_F32_TOL``): max |error| within 1e-4 of the reference's
largest magnitude.  The control, one TF32 product on operands rounded once,
must exceed the same limit, or the check could not tell the design from
the fault it guards against.

The kernels keep p and dS in registers: an f32 accumulator's 8-column
block is, register for register, the A fragment of a TF32 step whose k
slots hold its columns in the order (0, 2, 4, 6, 1, 3, 5, 7), and the
transposed B tiles (K^T for dQ, q^T and dO^T for dK/dV) are written in that
order.  A CPU model of the fragment index maps (wgmma's accumulator and A
layouts, the shared-memory descriptor's core matrices) reproduces dS K
exactly; the maps are read from the kernel source.

The kernels' source itself runs here too: compiled with g++ against a
stand-in for the CUDA features and inline PTX they use
(``tests/_cuda_emu.h``, ``tests/_torch_cuda_emu.py``: a block as threads,
wgmma computed by the warpgroup's threads together from the posted
fragments and the descriptors), at small shapes covering every head dim's
chunk and layout, causal and bidirectional, GQA (with the group sum),
ragged T and S != T, against the plain backward within 1e-5 of its largest
magnitude (the emulator sums each step's products in double; the card
sums in f32).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels import _build, budget  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_bwd_tf32_plain,
    flash_attention_plain, split_tf32, tf32)

import _torch_cuda_emu  # noqa: E402

LIMIT = 1e-4        # chip_smoke.FLASH_F32_TOL, x max |reference|
CHUNK = 64          # the reference's cq = ck
# (B, H, KV, T = S, d, causal)
CASES = [(1, 8, 2, 128, d, causal) for d in (64, 80, 128)
         for causal in (True, False)]
SOURCE = _build.SOURCES["flash_attention"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, h, kv, t, d, seed):
    """q, k, v, dO (B, heads, T, d) as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, t, d), (b, kv, t, d), (b, kv, t, d), (b, h, t, d))]


def _over_max(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tf32_backward_matches_reference_kernel(case):
    b, h, kv, t, d, causal = case
    qn, kn, vn, don = _inputs(b, h, kv, t, d, seed=t + d + causal)
    sc = d ** -0.5

    def loss(q_, k_, v_):
        o_ = flash_attention(q_, k_, v_, sc, causal, CHUNK, CHUNK, True)
        return jnp.sum(o_ * don)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    q, k, v, do = (torch.from_numpy(x) for x in (qn, kn, vn, don))
    o, lse = flash_attention_plain(q, k, v, sc=sc, causal=causal)
    got = flash_attention_bwd_tf32_plain(q, k, v, o, lse, do, sc=sc,
                                         causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32, name
        assert _over_max(g, w) <= LIMIT, (name, _over_max(g, w))
    control = flash_attention_bwd_tf32_plain(q, k, v, o, lse, do, sc=sc,
                                             causal=causal, lo=False)
    for name, c, w in zip(("dq", "dk", "dv"), control, want):
        assert _over_max(c, w) > LIMIT, (name, _over_max(c, w))
    # the mirror and the plain backward (the card's reference) agree far
    # inside the limit
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, sc=sc,
                                      causal=causal)
    for g, p in zip(got, plain):
        assert _over_max(g, p.numpy()) <= LIMIT / 10


def test_tf32_reads_a_word_as_the_tensor_cores_do():
    """A word's low 13 bits cleared (toward zero); infinities and NaNs
    unchanged; and the kernels' split is the mirror's: hi the word itself,
    lo = x - hi's top 19 bits."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 4, 1.0 + ulp / 2, 1.0 + 3 * ulp / 4,
                      1.0 + ulp, -(1.0 + 3 * ulp / 4), 2.0 ** -130,
                      float("inf"), -float("inf")])
    want = [1.0, 1.0, 1.0, 1.0, 1.0 + ulp, -1.0, 2.0 ** -130, float("inf"),
            -float("inf")]
    assert tf32(x).tolist() == want
    assert torch.isnan(tf32(torch.tensor([float("nan")]))).all()
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32))
    bits = tf32(r).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    body = re.search(r"void split_tf32\(float x, uint32_t& hi,\s*uint32_t& "
                     r"lo\) \{([^}]*)\}", _source()).group(1)
    assert [line.strip() for line in body.strip().splitlines()] == [
        "hi = __float_as_uint(x);",
        "lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));"]


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_split_keeps_twenty_bits(scale):
    """hi + lo is within 2^-20 of |x| (TF32 keeps 11 bits, the two halves
    about 20), where hi alone is off by up to 2^-10."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        scale / 8, scale, 4096).astype(np.float32))
    hi, lo = split_tf32(x)
    assert torch.equal(hi, tf32(x)) and torch.equal(lo, tf32(lo))
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double()).max()) <= 2.0 ** -20
    assert float(((hi - x).abs() / x).max()) > 2.0 ** -13


def _source() -> str:
    return SOURCE.read_text()


def _tslot_from_source():
    """``tslot`` as the kernel source writes it, as a Python function."""
    body = re.search(r"int tslot\(int p\) \{\s*return ([^;]+);", _source())
    expr = body.group(1)
    assert expr == "(p & ~7) | ((p & 7) >> 1) | ((p & 1) << 2)"
    return lambda p: eval(expr, {"p": p})


def _acc_to_a_from_source():
    """``acc_frags``'s map: fragment register j of step n8 takes
    accumulator register 4 n8 + off[j]."""
    fn = _source()[_source().index("void acc_frags("):]
    fn = fn[:fn.index("\n}\n")]
    off = {}
    for m in re.finditer(r"split_tf32\(x\[4 \* n8(?: \+ (\d))?\], "
                         r"hi\[n8\]\[(\d)\]", fn):
        off[int(m.group(2))] = int(m.group(1) or 0)
    assert sorted(off) == [0, 1, 2, 3]
    return [off[j] for j in range(4)]


def _acc_position(t, idx):
    """wgmma's f32 accumulator: register idx of thread t (of the
    warpgroup's 128) -> (row, column) of the 64 x N tile."""
    warp, gid, tig = t // 32, (t % 32) // 4, t % 4
    n8, r = idx // 4, idx % 4
    return warp * 16 + gid + 8 * (r >> 1), n8 * 8 + tig * 2 + (r & 1)


def _a_position(t, reg):
    """wgmma's TF32 A fragment: register reg of thread t -> (row, k slot)
    of the 64 x 8 step."""
    warp, gid, tig = t // 32, (t % 32) // 4, t % 4
    return warp * 16 + gid + 8 * (reg & 1), tig + 4 * (reg >> 1)


def _trn_word(d, row, s):
    """The transposed tile's word of (row, slot s), as the kernel lays it."""
    return (s // 4) * (4 * d + 4) + 4 * row + s % 4


def _desc_word(d, kk, n, k):
    """The word wgmma reads for B's (n, k) at step kk through
    ``desc_trn``: start 2 (16 d + 16) kk bytes, leading byte offset 16 d +
    16 between the two 4-slot core matrices, stride byte offset 128
    between 8-row groups, 16 bytes a core-matrix row."""
    lbo, sbo = 16 * d + 16, 128
    byte = (kk * 2 * (16 * d + 16) + (k // 4) * lbo + (n // 8) * sbo
            + (n % 8) * 16 + (k % 4) * 4)
    assert byte % 4 == 0
    return byte // 4


@pytest.mark.parametrize("d, chunk", [(80, 64), (128, 32), (16, 64)])
def test_accumulator_as_a_fragment_reproduces_ds_k(d, chunk):
    """A CPU model of the kernels' product part = ds K over one chunk: ds
    (64 x chunk) held as the accumulator's registers and turned into A
    fragments by ``acc_frags``'s map, K written into the transposed tile
    in ``tslot`` order and read back through the descriptor's core
    matrices, summed over the chunk's steps: exactly ds K."""
    tslot, off = _tslot_from_source(), _acc_to_a_from_source()
    rng = np.random.default_rng(d + chunk)
    ds = rng.standard_normal((64, chunk))
    kmat = rng.standard_normal((chunk, d))
    regs = np.zeros((128, chunk // 2))
    for t in range(128):
        for idx in range(chunk // 2):
            regs[t, idx] = ds[_acc_position(t, idx)]
    tile = np.full(chunk * (d + 1), np.nan)
    for p in range(chunk):
        for row in range(d):
            tile[_trn_word(d, row, tslot(p))] = kmat[p, row]
    got = np.zeros((64, d))
    for kk in range(chunk // 8):
        a = np.full((64, 8), np.nan)
        for t in range(128):
            for reg in range(4):
                a[_a_position(t, reg)] = regs[t, 4 * kk + off[reg]]
        b = np.array([[tile[_desc_word(d, kk, n, k)] for k in range(8)]
                      for n in range(d)])
        got += a @ b.T
    np.testing.assert_allclose(got, ds @ kmat, rtol=1e-12, atol=1e-12)


def test_slot_order_is_the_accumulators():
    """Within each 8-block, the accumulator's columns 2 tig and 2 tig + 1
    of a thread land in k slots tig and tig + 4 of its A fragment, and
    ``tslot`` puts chunk position p in the slot that holds it."""
    tslot, off = _tslot_from_source(), _acc_to_a_from_source()
    for g in range(4):
        assert sorted(tslot(8 * g + w) for w in range(8)) == list(
            range(8 * g, 8 * g + 8))
    for t in range(128):
        for reg in range(4):
            row_a, slot = _a_position(t, reg)
            row_c, col = _acc_position(t, off[reg])
            assert row_a == row_c and tslot(col) == slot


def test_split_pass_and_fragment_loads_hit_32_banks():
    """The split pass's transposed stores (a warp on 32 neighbouring chunk
    positions of one row) and the A fragments' loads from a raw tile (rows
    gid and gid + 8 of a warp's 16, columns tig and tig + 4) each touch
    32 distinct banks at every head dim the kernels take."""
    tslot = _tslot_from_source()
    for d in budget.FLASH_HEAD_DIMS:
        for row in (0, d - 1):
            banks = {_trn_word(d, row, tslot(p)) % 32 for p in range(32)}
            assert len(banks) == 32, (d, row)

        def raw_word(r, c):
            if d % 32 == 0:
                return r * d + (c ^ ((r & 7) << 2))
            return r * (d + 4) + c

        for kk in range(d // 8):
            for step in (0, 4):
                banks = {raw_word(16 + gid, 8 * kk + tig + step) % 32
                         for gid in range(8) for tig in range(4)}
                assert len(banks) == 32, (d, kk)


def test_every_head_dim_fits_shared_memory():
    """Both split-TF32 kernels fit a block's shared memory at every head
    dim they are built for, with the chunk the source picks."""
    rule = re.search(r"int tf32_chunk\(int d\) \{\s*return d <= (\d+) \? "
                     r"(\d+) : (\d+);", _source())
    wide_max, wide, narrow = (int(g) for g in rule.groups())
    assert (wide_max, wide, narrow) == (budget.FLASH_TF32_WIDE_MAX_D,
                                        budget.FLASH_TF32_CHUNK,
                                        budget.FLASH_TF32_CHUNK // 2)
    for d in budget.FLASH_HEAD_DIMS:
        assert budget.flash_tf32_chunk(d) == (wide if d <= wide_max
                                              else narrow)
        for nbytes in (budget.flash_bwd_dq_smem_bytes(d),
                       budget.flash_bwd_dkv_smem_bytes(d)):
            assert budget.smem_fits(nbytes), (d, nbytes)
    assert budget.flash_bwd_dq_smem_bytes(80) == 209_408
    assert budget.flash_bwd_dkv_smem_bytes(80) == 225_280
    assert budget.flash_bwd_dq_smem_bytes(128) == 229_632


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = _torch_cuda_emu.emulated_library(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the emulated kernels")
    return lib


# (B, H, KV, T, S, d, causal): every head dim's chunk and raw-tile layout
# (padded at 16 and 80, swizzled at 32, 64, 96, 128), GQA with its group
# sum, a ragged T, S != T both ways
EMU_CASES = [(1, 2, 1, 130, 130, 16, True),
             (1, 2, 2, 64, 64, 32, False),
             (1, 4, 2, 100, 100, 64, True),
             (1, 2, 2, 200, 200, 80, False),
             (1, 2, 1, 100, 70, 96, False),
             (1, 2, 2, 64, 96, 128, True)]


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_kernel_source_matches_plain_on_an_emulated_block(emulated, case):
    b, h, kv, t, s, d, causal = case
    rng = np.random.default_rng(t + s + d)

    def view(n, length):
        # the model's (B, T, H, d) tensors, seen as (B, H, T, d)
        return torch.from_numpy(rng.standard_normal(
            (b, length, n, d)).astype(np.float32)).transpose(1, 2)

    q, k, v, do = view(h, t), view(kv, s), view(kv, s), view(h, t)
    sc = d ** -0.5
    o, lse = flash_attention_plain(q, k, v, sc=sc, causal=causal)
    delta = (do * o).sum(-1).contiguous()
    got = _torch_cuda_emu.bwd_tf32(emulated, q, k, v, do, lse.contiguous(),
                                   delta, sc=sc, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, sc=sc,
                                     causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _over_max(g, w.numpy()) <= 1e-5, (name, _over_max(g, w.numpy()))


# (H, KV, which part pointers are null): null parts where a kv head has G > 1
# query heads, or one null and one not
REFUSED_PARTS = [(2, 1, (True, True)), (2, 2, (True, False)),
                 (2, 2, (False, True))]


@pytest.mark.parametrize("case", REFUSED_PARTS, ids=str)
def test_dkv_launcher_refuses_parts_that_disagree_with_the_group(emulated,
                                                                 case):
    """The wrapper alone chooses where the dK/dV kernel writes: null part
    pointers for dK and dV directly, which the launcher takes only when
    each kv head has one query head, and never one of the two."""
    h, kv, null = case
    b, t, s, d = 1, 64, 64, 32
    rng = np.random.default_rng(h + kv + sum(null))
    q, do = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, kv, s, d)).astype(
        np.float32)) for _ in range(2))
    lse, delta = torch.zeros((b, h, t)), torch.zeros((b, h, t))
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    parts = [None if n else torch.zeros((b, h, s, d)) for n in null]
    err = _torch_cuda_emu.dkv_tf32(emulated, q, k, v, do, lse, delta, dk, dv,
                                   *parts, sc=d ** -0.5, causal=False)
    assert err != 0
    assert bool(torch.isnan(dk).all()) and bool(torch.isnan(dv).all())
