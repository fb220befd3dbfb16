"""The port's kernel build (``repro_torch.kernels._build``), without a
compiler: where the libraries go, how a source edit changes their name, how
a missing ``nvcc`` or a failed launch is reported.  The compile itself runs
only where there is a card (``chip_smoke.py``)."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_every_kernel_source_is_in_the_package():
    assert set(_build.SOURCES) == {"sparse_conv", "bsr_conv", "bsr_matmul",
                                   "flash_attention"}
    for src in _build.SOURCES.values():
        text = src.read_text()
        assert 'extern "C" int' in text
        assert "cudaGetLastError()" in text


def test_flags_target_hopper_with_the_a_suffix():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags and "-O3" in flags


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setitem(_build.SOURCES, "k", src)
    first = _build.library_path("k")
    assert first.parent == tmp_path and first.name.startswith("k-")
    assert _build.library_path("k") == first
    src.write_text("// two\n")
    assert _build.library_path("k") != first


def test_default_build_dir_is_the_checkouts_ignored_build(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = _build.KERNELS_DIR.parents[2]
    assert _build.build_dir() == root / "build" / "kernels"
    assert "/build/" in (root / ".gitignore").read_text().split()


def test_missing_nvcc_is_an_error_naming_the_fix(monkeypatch):
    for var in ("NVCC", "CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="NVCC or CUDA_HOME"):
        _build.nvcc_path()


def test_nonzero_cuda_error_raises():
    _build.check(0, "sparse_conv")
    with pytest.raises(RuntimeError, match="bsr_conv: CUDA launch failed"):
        _build.check(9, "bsr_conv")


def test_operand_checks_name_the_kernel_and_the_fault():
    import torch

    t = torch.zeros((2, 3))
    cpu = torch.device("cpu")
    _build.check_operand("k", "x", t, torch.float32, (2, 3), cpu)
    for args, kw, msg in [
            ((t, torch.int32, (2, 3), cpu), {}, "k: x has dtype"),
            ((t, torch.float32, (3, 2), cpu), {}, "k: x has shape"),
            ((t, torch.float32, (2, 3), torch.device("meta")), {}, "k: x is on"),
            ((t.T, torch.float32, (3, 2), cpu), {}, "k: x is not contiguous"),
            ((t.T, torch.float32, (3, 2), cpu), {"rows_strided": True},
             "k: x is not contiguous")]:
        with pytest.raises(ValueError, match=msg):
            _build.check_operand("k", "x", *args, **kw)
    # a transposed view of (B, T, H, d) has a contiguous last axis
    _build.check_operand("k", "x", torch.zeros((2, 4, 3, 8)).transpose(1, 2),
                         torch.float32, (2, 3, 4, 8), cpu, rows_strided=True)


def test_new_kernels_fit_the_cards_shared_memory():
    from repro_torch.kernels import budget

    # the rows schedule at decode: x staged (32 KB at N 4096, 88 KB at
    # 11008), opted in above 48 KB; wk's cluster of 8 slots
    for bm in budget.BSR_MATMUL_BM:
        for n, cluster in ((4096, 8), (11008, 1)):
            assert budget.smem_fits(budget.bsr_matmul_smem_bytes(
                bm, 16, 2, 4, n, cluster))
    assert budget.bsr_matmul_smem_bytes(16, 16, 2, 4, 4096) == 51_328
    for d in budget.FLASH_HEAD_DIMS:  # dynamic, opted in above 48 KB
        assert budget.smem_fits(budget.flash_fwd_tf32_smem_bytes(d))
    assert budget.flash_fwd_tf32_smem_bytes(128) == 147_712
    assert budget.bsr_matmul_unsupported(16, 16, 4096) is None
    assert "block height" in budget.bsr_matmul_unsupported(64, 16, 4096)
    assert "multiple of 16" in budget.bsr_matmul_unsupported(16, 8, 4096)
    assert "not a multiple of the block width" in \
        budget.bsr_matmul_unsupported(16, 16, 4100)
    # the tensor-core schedules: dQ at every head dim, the BCSR matmul's
    # wgmma ring, and the block widths its 128-column chunks take
    for d in budget.FLASH_HEAD_DIMS:
        assert budget.smem_fits(budget.flash_bwd_dq_tc_smem_bytes(d))
    assert budget.flash_bwd_dq_tc_smem_bytes(128) == 131_072
    # every backward kernel at every head dim it is built for (80 and 96
    # among them), FMA and tensor-core
    assert {80, 96} <= set(budget.FLASH_HEAD_DIMS)
    for d in budget.FLASH_HEAD_DIMS:
        for nbytes in (budget.flash_bwd_dq_smem_bytes(d),
                       budget.flash_bwd_dkv_smem_bytes(d),
                       budget.flash_bwd_dq_tc_smem_bytes(d),
                       budget.flash_bwd_dkv_tc_smem_bytes(d)):
            assert budget.smem_fits(nbytes), d
    assert budget.flash_bwd_dq_tc_smem_bytes(96) == 98_304
    assert budget.flash_bwd_dkv_tc_smem_bytes(96) == 91_136
    assert budget.bsr_matmul_wgmma_smem_bytes() == 229_504
    assert budget.smem_fits(budget.bsr_matmul_wgmma_smem_bytes())
    for bn in (16, 32, 64, 128):
        assert budget.bsr_matmul_unsupported(16, bn, 4096, "wgmma") is None
    assert budget.bsr_matmul_unsupported(16, 256, 4096) is None
    assert "does not divide" in budget.bsr_matmul_unsupported(
        16, 256, 4096, "wgmma")


def test_conv_kernels_fit_the_cards_shared_memory():
    """The two conv kernels' schedules at the main path's largest layers
    fit a block's shared memory: the ELL slab stages (res5a/3x3, K 1504,
    and AlexNet conv2, 5x5), and the BCSR kernel's two stages of TF32
    halves at its widest tile, N = 64 (two stages at N = 128 would not)."""
    from repro_torch.kernels import budget
    from repro_torch.kernels.sparse_conv import ops as ell_ops

    for m, k, e, c, r, hp in ((512, 1504, 7, 512, 3, 9),
                              (256, 976, 26, 96, 5, 30)):
        for pipe in (True, False):
            sched, reason = ell_ops.resolve_schedule(
                m, k, e, e, n=8, c=c, r=r, s=r, hp=hp, wp=hp, pipeline=pipe)
            assert reason is None and sched.pipeline == pipe
            assert budget.smem_fits(budget.ell_smem_bytes(
                sched.tm, sched.cc, c, sched.rows, hp, r, pipe))
    kbc = -(-512 * 9 // 128)
    assert budget.bsr_conv_smem_bytes(8, 128, 64, kbc) == 131_072 + 4 * (
        3 * 128 + 9 * kbc)
    assert budget.smem_fits(budget.bsr_conv_smem_bytes(8, 128, 64, kbc))
    assert not budget.smem_fits(budget.bsr_conv_smem_bytes(8, 128, 128, kbc))
    assert max(t for t, _ in budget.BSR_CONV_TILES) == 64


def test_bsr_matmul_argtypes_match_the_c_entry_point():
    """The launcher's ctypes argument list has one entry a parameter of
    ``extern "C" int bsr_matmul(...)``, pointers where the source takes
    ``void*`` and ints where it takes ``int``: a mismatch would pass
    pointers cut to 32 bits, or raise only on the card."""
    import ctypes
    import re

    from repro_torch.kernels.bsr_matmul.kernel import ARGTYPES

    text = _build.SOURCES["bsr_matmul"].read_text()
    params = re.search(r'extern "C" int bsr_matmul\(([^)]*)\)', text).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert ARGTYPES == kinds


@pytest.mark.parametrize("kernel, module, symbol", [
    ("sparse_conv", "repro_torch.kernels.sparse_conv.kernel",
     "sparse_conv_ell"),
    ("bsr_conv", "repro_torch.kernels.bsr_conv.kernel", "bsr_conv_tc")])
def test_conv_argtypes_match_the_c_entry_points(kernel, module, symbol):
    """As for bsr_matmul: the conv launchers' ctypes argument lists (the
    scale operand and the value type among them) match their sources'
    ``extern "C"`` parameters one for one."""
    import ctypes
    import importlib
    import re

    text = _build.SOURCES[kernel].read_text()
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    mod = importlib.import_module(module)
    assert mod._SYMBOL == symbol and mod.ARGTYPES == kinds
