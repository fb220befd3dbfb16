"""The split-TF32 flash forward (``flash_fwd_tf32_kernel``), on the CPU.

The f32 forward runs both of its products on the tensor cores in TF32, as
the split-TF32 backward kernels do: each f32 operand x as two halves, hi =
x itself and lo = x - hi's top 19 bits, which the tensor cores read with
their low 13 bits cleared, and three products hi hi + hi lo + lo hi summed
in f32; s = q K^T, then p V a chunk of keys at a time under the online
softmax.  The port's plain mirror of that arithmetic
(``flash_attention_fwd_tf32_plain``) goes against the JAX package's forward
kernel (``_fwd_call`` in interpret mode, f32) on the same seeded inputs,
GQA 4:1, d 64, 80, 96 and 128, causal and bidirectional, T a multiple of
the reference's 64-row chunk: O within 1e-4 of the reference's largest
magnitude (``chip_smoke.FLASH_F32_TOL``), lse within 1e-4
(``chip_smoke.FLASH_LSE_TOL``).  The control, one TF32 product on operands
rounded once, must exceed the O limit, or the check could not tell the
design from the fault it guards against.

The kernel keeps p in registers: the score accumulator's 8-column blocks
are the A fragments of p V (``acc_frags``), and V's chunk is written
transposed with its chunk positions in ``tslot`` order by the split pass.
A CPU model of those index maps, read from the kernel source, reproduces
p V exactly.

The kernel's source itself runs here too, compiled with g++ against a
stand-in for the CUDA features and inline PTX it uses
(``tests/_cuda_emu.h``, ``tests/_torch_cuda_emu.py``: a block as threads,
wgmma computed by the warpgroup's threads together, shuffles through a
warp barrier), at small shapes covering every head dim's chunk and raw-tile
layout, causal and bidirectional, GQA, ragged T and S != T, against the
plain forward within 1e-5 of max |O| and 1e-5 on lse (the emulator sums
each step's products in double; the card sums in f32).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import kernel as ref_kernel  # noqa: E402
from repro_torch.kernels import _build, budget  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_fwd_tf32_plain, flash_attention_plain)

import _torch_cuda_emu  # noqa: E402

LIMIT = 1e-4        # chip_smoke.FLASH_F32_TOL, x max |reference|
LSE_LIMIT = 1e-4    # chip_smoke.FLASH_LSE_TOL
EMU_LIMIT = 1e-5
CHUNK = 64          # the reference's cq = ck
# (B, H, KV, T = S, d, causal)
CASES = [(1, 8, 2, 128, d, causal) for d in (64, 80, 96, 128)
         for causal in (True, False)]
SOURCE = _build.SOURCES["flash_attention"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _source() -> str:
    return SOURCE.read_text()


def _over_max(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


def _abs_err(got, want) -> float:
    return float(np.abs(got.double().numpy()
                        - np.asarray(want, dtype=np.float64)).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tf32_forward_matches_reference_kernel(case):
    b, h, kv, t, d, causal = case
    rng = np.random.default_rng(t + d + causal)
    qn, kn, vn = (rng.standard_normal(shape).astype(np.float32) for shape in
                  ((b, h, t, d), (b, kv, t, d), (b, kv, t, d)))
    sc = d ** -0.5
    want_o, want_lse = ref_kernel._fwd_call(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), sc=sc,
        causal=causal, cq=CHUNK, ck=CHUNK, interpret=True)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    o, lse = flash_attention_fwd_tf32_plain(q, k, v, sc=sc, causal=causal)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert _over_max(o, want_o) <= LIMIT, _over_max(o, want_o)
    assert _abs_err(lse, want_lse) <= LSE_LIMIT, _abs_err(lse, want_lse)
    control, _ = flash_attention_fwd_tf32_plain(q, k, v, sc=sc,
                                                causal=causal, lo=False)
    assert _over_max(control, want_o) > LIMIT, _over_max(control, want_o)
    # the mirror and the plain forward (the card's reference) agree far
    # inside the limit
    plain_o, plain_lse = flash_attention_plain(q, k, v, sc=sc, causal=causal)
    assert _over_max(o, plain_o.numpy()) <= LIMIT / 10
    assert _abs_err(lse, plain_lse.numpy()) <= LSE_LIMIT / 10


def _tslot_from_source():
    body = re.search(r"int tslot\(int p\) \{\s*return ([^;]+);", _source())
    return lambda p: eval(body.group(1), {"p": p})


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


def _trn_word_from_source(d):
    """The split pass's transposed store as the source writes it: (row,
    slot s) of a transposed tile -> its word, for row = 4 c4 + j."""
    fn = _source()[_source().index("void split_tile("):]
    fn = fn[:fn.index("\n}\n")]
    t0 = re.search(r"const int t0 = ([^;]+);", fn).group(1)
    assert re.search(r"th\[t0 \+ 4 \* j\] = __uint_as_float\(hi\[j\]\);", fn)
    assert re.search(r"tl\[t0 \+ 4 \* j\] = __uint_as_float\(lo\[j\]\);", fn)

    def word(row, s):
        return eval(t0, {"s": s, "D": d, "c4": row // 4}) + 4 * (row % 4)
    return word


def _forward_body() -> str:
    src = _source()
    start = src.index("flash_fwd_tf32_kernel(")
    return src[start:src.index("\n}\n", start)]


def test_forward_wires_p_and_v_transposed():
    """The forward splits V's chunk into the transposed tiles only (its
    natural lo is never read) and K's into its natural lo, takes p V from
    the score accumulator and V^T into a fresh partial, and adds that to
    the rescaled O with rounded adds."""
    body = _forward_body()
    assert "split_tile<D, L, true, false>(Kh, Kl, nullptr, nullptr" in body
    assert "split_tile<D, L, false, true>(Vh, nullptr, VTh, VTl" in body
    assert "scores_tf32<D, L, false>(s, s, Xq, Xq, smem_u32(Kh), " \
        "smem_u32(Kl)" in body
    products = re.findall(r"chunk_product<D, L>\((\w+), s, "
                          r"smem_u32\(VTh\), smem_u32\(VTl\)\)", body)
    assert products == ["part"]
    assert "acc[i] = __fadd_rn(acc[i] * alpha[(i >> 1) & 1], part[i]);" \
        in body


def _acc_position(t, idx):
    warp, gid, tig = t // 32, (t % 32) // 4, t % 4
    n8, r = idx // 4, idx % 4
    return warp * 16 + gid + 8 * (r >> 1), n8 * 8 + tig * 2 + (r & 1)


def _a_position(t, reg):
    warp, gid, tig = t // 32, (t % 32) // 4, t % 4
    return warp * 16 + gid + 8 * (reg & 1), tig + 4 * (reg >> 1)


def _desc_word(d, kk, n, k):
    """The word wgmma reads for B's (n, k) at step kk through ``desc_trn``
    (start 2 (16 d + 16) kk bytes, leading byte offset 16 d + 16, stride
    byte offset 128, 16 bytes a core-matrix row)."""
    desc = re.search(r"uint64_t desc_trn\(uint32_t tile, int kk\) \{\s*"
                     r"return smem_desc\(([^;]+)\);", _source()).group(1)
    assert desc == "tile + kk * 2 * (16 * D + 16), 16 * D + 16, 128"
    lbo, sbo = 16 * d + 16, 128
    byte = (kk * 2 * (16 * d + 16) + (k // 4) * lbo + (n // 8) * sbo
            + (n % 8) * 16 + (k % 4) * 4)
    return byte // 4


@pytest.mark.parametrize("d", budget.FLASH_HEAD_DIMS)
def test_score_accumulator_times_v_transposed_is_p_v(d):
    """A CPU model of the forward's p V over one chunk at each head dim's
    chunk: p (64 x chunk) held as the score accumulator's registers, turned
    into A fragments by ``acc_frags``'s map; V written into the transposed
    tile by the split pass's store (the source's expression) in ``tslot``
    order and read back through the descriptor: exactly p V."""
    chunk = budget.flash_tf32_chunk(d)
    tslot, off = _tslot_from_source(), _acc_to_a_from_source()
    word = _trn_word_from_source(d)
    rng = np.random.default_rng(d)
    p = rng.uniform(0, 1, (64, chunk))
    vmat = rng.standard_normal((chunk, d))
    regs = np.zeros((128, chunk // 2))
    for t in range(128):
        for idx in range(chunk // 2):
            regs[t, idx] = p[_acc_position(t, idx)]
    tile = np.full(chunk * (d + 1), np.nan)
    for pos in range(chunk):
        for row in range(d):
            tile[word(row, tslot(pos))] = vmat[pos, row]
    got = np.zeros((64, d))
    for kk in range(chunk // 8):
        a = np.full((64, 8), np.nan)
        for t in range(128):
            for reg in range(4):
                a[_a_position(t, reg)] = regs[t, 4 * kk + off[reg]]
        bmat = np.array([[tile[_desc_word(d, kk, n, k)] for k in range(8)]
                         for n in range(d)])
        got += a @ bmat.T
    np.testing.assert_allclose(got, p @ vmat, rtol=1e-12, atol=1e-12)


def test_forward_shared_memory_is_the_sources():
    """``budget.flash_fwd_tf32_smem_bytes`` is the source's
    ``fwd_tf32_smem_bytes`` at every head dim, and fits a block."""
    expr = re.search(r"size_t fwd_tf32_smem_bytes\(int d\) \{\s*return "
                     r"([^;]+);", _source()).group(1)
    expr = re.sub(r"static_cast<size_t>\(([^()]*(?:\([^()]*\))?)\)", r"(\1)",
                  expr)
    for d in budget.FLASH_HEAD_DIMS:
        got = eval(expr, {"d": d, "TC_BQ": 64,
                          "raw_row": lambda x: x if x % 32 == 0 else x + 4,
                          "tf32_chunk": budget.flash_tf32_chunk})
        assert got == budget.flash_fwd_tf32_smem_bytes(d), d
        assert budget.smem_fits(got), d


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = _torch_cuda_emu.emulated_library(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the emulated kernels")
    return lib


# (B, H, KV, T, S, d, causal): every head dim's chunk and raw-tile layout
# (padded at 16 and 80, swizzled at 32, 64, 96, 128), GQA, a ragged T over
# two blocks of 128 rows, S != T both ways
EMU_CASES = [(1, 2, 1, 130, 130, 16, True),
             (1, 2, 2, 64, 64, 32, False),
             (1, 4, 2, 100, 100, 64, True),
             (1, 2, 2, 160, 160, 80, False),
             (1, 2, 1, 100, 70, 96, False),
             (1, 2, 2, 64, 96, 128, True)]


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_forward_source_matches_plain_on_an_emulated_block(emulated, case):
    b, h, kv, t, s, d, causal = case
    rng = np.random.default_rng(t + s + d)

    def view(n, length):
        # the model's (B, T, H, d) tensors, seen as (B, H, T, d)
        return torch.from_numpy(rng.standard_normal(
            (b, length, n, d)).astype(np.float32)).transpose(1, 2)

    q, k, v = view(h, t), view(kv, s), view(kv, s)
    sc = d ** -0.5
    o, lse = _torch_cuda_emu.fwd_tf32(emulated, q, k, v, sc=sc,
                                      causal=causal)
    want_o, want_lse = flash_attention_plain(q, k, v, sc=sc, causal=causal)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert _over_max(o, want_o.numpy()) <= EMU_LIMIT
    assert _abs_err(lse, want_lse.numpy()) <= EMU_LIMIT
