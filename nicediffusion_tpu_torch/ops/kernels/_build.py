"""Builds the package's CUDA C++ kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ctypes. The library
lands in ``nicediffusion_tpu_torch/_build/`` (listed in .gitignore) under a
name keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. nvcc's stderr (ptxas's register and spill report) is kept beside the
library as ``lib<name>-<hash>.log`` and read back with it.
:func:`build_all` starts one nvcc per source at once. Only the package's own
sources and the installed toolkit's headers are used. A failed build raises
with nvcc's stderr; nothing falls back.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BuildError", "build", "build_all", "load_library", "bind", "set_signatures",
           "launch_error", "build_logs"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> (ctypes library, nvcc stderr of its build, seconds this process
# spent building it: 0 if it was cached); filled once per process by load_library
_LIBS: dict[str, tuple[ctypes.CDLL, str, float]] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise BuildError("nvcc not found on PATH, in $CUDA_HOME or /usr/local/cuda")
    return str(path)


def build(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless a build of the same source and flags
    exists. Returns (library path, nvcc stderr of its build, seconds spent
    building now: 0 for a cached build)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text(), 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build to a temporary name and rename, so a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise BuildError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}"
            )
        # the log first: a library on disk always has its log beside it
        log.write_text(proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stderr, time.perf_counter() - t0


def load_library(name: str, built: tuple[Path, str, float] | None = None) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process.
    ``built`` is the result of a :func:`build` of ``name`` made already."""
    if name not in _LIBS:
        path, log, seconds = built or build(name)
        _LIBS[name] = (ctypes.CDLL(str(path)), log, seconds)
    return _LIBS[name][0]


def bind(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """:func:`load_library` of ``name`` with :func:`set_signatures`."""
    return set_signatures(load_library(name), signatures)


def set_signatures(lib: ctypes.CDLL, signatures: dict[str, list]) -> ctypes.CDLL:
    """Set the argument types of ``lib``'s C functions once: ``signatures``
    maps each name to its ctypes argument types (each returns an int, the
    CUDA error code), and ``nd_cuda_error_string`` (every source has it)
    maps a code to its text."""
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.nd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_error(lib: ctypes.CDLL, err: int, what: str, detail: str) -> RuntimeError:
    """The error a wrapper raises for a launch that returned CUDA error
    ``err``: what failed, the CUDA text, and the call's shapes."""
    return RuntimeError(f"{what} launch failed: {lib.nd_cuda_error_string(err).decode()} "
                        f"({detail})")


def build_all(names: tuple[str, ...] = ("attention", "attention_bwd", "resblock",
                                         "groupnorm", "int8conv", "bf16conv",
                                         "winograd")) -> None:
    """Build several sources, one nvcc process per source, all started
    together (nvcc is a subprocess, so threads are enough), and load each
    through :func:`load_library`."""
    todo = [n for n in names if n not in _LIBS]
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        for name, built in zip(todo, pool.map(build, todo)):
            load_library(name, built)


def build_logs() -> dict[str, tuple[str, float]]:
    """nvcc stderr (register and shared-memory use from ``-Xptxas -v``) and
    build seconds (0 if cached) of every library this process loaded."""
    return {name: (log, seconds) for name, (_, log, seconds) in _LIBS.items()}
