"""ctypes bindings for the native C++ data-loading runtime.

Copy of nicediffusion_tpu/training/native_loader.py (numpy + ctypes). Builds
native/nicediffusion_native.cc, which lies beside the packages and is read in
place, on demand (g++, cached by source mtime) into the package's build
directory, exposing `native_emnist_batches` with the same generator
interface as training.data.emnist_batches but with
parsing/normalization/prefetch in C++ on a background thread (the
reference's 4-worker torch DataLoader, reference scripts/train.py:47).
`is_available()` says whether a toolchain built it; the caller then takes
the numpy pipeline instead. This is a host-side data choice and touches no
device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator

import numpy as np

_SRC = os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "nicediffusion_native.cc"
)
_LIB_CACHE = os.path.join(os.path.dirname(__file__), "..", "_build")
_lib = None
_lib_error: str | None = None


def _build_lib() -> str:
    os.makedirs(_LIB_CACHE, exist_ok=True)
    src = os.path.abspath(_SRC)
    out = os.path.join(_LIB_CACHE, "libnicediffusion_native.so")
    if (
        not os.path.exists(out)
        or os.path.getmtime(out) < os.path.getmtime(src)
    ):
        subprocess.run(
            [
                "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                "-o", out, src, "-lz", "-lpthread",
            ],
            check=True,
            capture_output=True,
        )
    return out


def _load():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build_lib())
    except (OSError, subprocess.CalledProcessError, FileNotFoundError) as e:
        _lib_error = str(e)
        return None
    lib.ndl_open.restype = ctypes.c_void_p
    lib.ndl_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ndl_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ndl_start.restype = ctypes.c_int
    lib.ndl_start.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.ndl_next.restype = ctypes.c_int
    lib.ndl_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ndl_close.argtypes = [ctypes.c_void_p]
    lib.ndl_last_error.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


class NativeIdxLoader:
    """Handle to the C++ prefetching loader over one idx(.gz) pair."""

    def __init__(
        self,
        images_path: str,
        labels_path: str,
        batch_size: int,
        seed: int = 0,
        prefetch_depth: int = 4,
        transpose: bool = True,
        rescale: bool = True,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_lib_error}")
        self._lib = lib
        self._handle = lib.ndl_open(
            images_path.encode(), labels_path.encode()
        )
        if not self._handle:
            raise FileNotFoundError(lib.ndl_last_error().decode())
        n = ctypes.c_int64()
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        lib.ndl_info(self._handle, n, rows, cols)
        self.num_examples, self.rows, self.cols = n.value, rows.value, cols.value
        self.batch_size = batch_size
        if lib.ndl_start(
            self._handle, batch_size, seed, prefetch_depth,
            int(transpose), int(rescale),
        ):
            raise RuntimeError(lib.ndl_last_error().decode())

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        images = np.empty(
            (self.batch_size, self.rows, self.cols, 1), dtype=np.float32
        )
        labels = np.empty((self.batch_size,), dtype=np.int32)
        rc = self._lib.ndl_next(
            self._handle,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc:
            raise RuntimeError(self._lib.ndl_last_error().decode())
        return images, labels

    def close(self):
        if self._handle:
            self._lib.ndl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        while True:
            yield self.next()


def native_emnist_batches(
    batch_size: int,
    root: str = "data/EMNIST/raw",
    split: str = "letters",
    seed: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Drop-in native replacement for training.data.emnist_batches."""
    img = os.path.join(root, f"emnist-{split}-train-images-idx3-ubyte.gz")
    lbl = os.path.join(root, f"emnist-{split}-train-labels-idx1-ubyte.gz")
    if not os.path.exists(img):
        img, lbl = img[:-3], lbl[:-3]  # uncompressed layout
    loader = NativeIdxLoader(img, lbl, batch_size, seed=seed)
    return iter(loader)
