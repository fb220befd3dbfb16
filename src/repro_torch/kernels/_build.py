"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` under ``repro_torch/kernels`` is one shared library with a
plain C interface, compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<digest>.so <name>.cu

into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), at first use.  The file name carries a digest of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  ``build()`` starts one ``nvcc`` per missing library, all at once,
and waits for them together.  ``REPRO_TORCH_BUILD_DIR`` moves the build
directory; ``NVCC`` or ``CUDA_HOME`` name the compiler.

Nothing here runs at import: the CPU tests import every module, and a
build only happens where there is a card and a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNELS_DIR = Path(__file__).resolve().parent
SOURCES: Dict[str, Path] = {
    "sparse_conv": KERNELS_DIR / "sparse_conv" / "csrc" / "sparse_conv.cu",
    "bsr_conv": KERNELS_DIR / "bsr_conv" / "csrc" / "bsr_conv.cu",
    "bsr_matmul": KERNELS_DIR / "bsr_matmul" / "csrc" / "bsr_matmul.cu",
    "flash_attention": (KERNELS_DIR / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each library built by
# this process, by kernel name.
BUILD_LOGS: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels -> the checkout's root
    return KERNELS_DIR.parents[2] / "build" / "kernels"


def nvcc_path() -> str:
    if os.environ.get("NVCC"):
        return os.environ["NVCC"]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME to build the "
                       "port's CUDA kernels")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` each, all started together; raise with the compiler's output if
    any fails.  Returns each library's path."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def check_operand(kernel: str, name: str, t, dtype, shape, device, *,
                  rows_strided: bool = False) -> None:
    """Raise unless operand ``t`` of ``kernel`` lies on ``device`` with
    ``dtype`` and ``shape`` and is contiguous (with ``rows_strided``, only
    its last axis need be)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not (t.stride(-1) == 1 if rows_strided else t.is_contiguous()):
        raise ValueError(f"{kernel}: {name} is not contiguous")


_CACHED: Dict[tuple, tuple] = {}


def cached(kind: str, tensors, key, make):
    """``make()``'s result for ``tensors`` and ``key``, made the first time
    they are seen together and again only after one of the tensors has been
    written in place (its ``_version`` moved).  What a launcher derives
    from a weight (a check that reads it back to the host, a stretched
    copy) then costs once per weight, not once per launch.  Entries go with
    the first tensor."""
    ident = (kind,) + tuple(id(t) for t in tensors) + tuple(key)
    state = tuple(t._version for t in tensors)
    entry = _CACHED.get(ident)
    if (entry is not None and entry[1] == state
            and all(r() is t for r, t in zip(entry[0], tensors))):
        return entry[2]
    value = make()
    if entry is None:
        weakref.finalize(tensors[0], _CACHED.pop, ident, None)
    _CACHED[ident] = (tuple(weakref.ref(t) for t in tensors), state, value)
    return value


def check_once(kind: str, tensors, check) -> None:
    """Run ``check()`` (which raises on a fault) once per ``tensors``, as
    ``cached`` makes its values: one read-back per weight, none per
    launch."""
    cached(kind, tensors, (), check)


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
