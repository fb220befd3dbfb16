"""The port's kernel build (``repro_torch.kernels._build``), without a
compiler: where the libraries go, how a source edit changes their name, how
a missing ``nvcc`` or a failed launch is reported.  The compile itself runs
only where there is a card (``chip_smoke.py``)."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_every_kernel_source_is_in_the_package():
    assert set(_build.SOURCES) == {"sparse_conv", "bsr_conv"}
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
