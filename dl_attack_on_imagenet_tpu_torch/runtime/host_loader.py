"""ctypes bindings for the native C++ host data loader.

Port of ``dl_attack_on_imagenet_tpu/runtime/host_loader.py`` over the same
source, ``native/host_loader.cpp``, used unchanged: libjpeg decode and the
reference transform (shorter side resized to 256, center crop, [0, 1]
float NHWC) on a thread pool, and a ring-buffer prefetching batch loader.

The port builds its own copy of the library with ``g++`` into
``.kernel_build/`` beside the CUDA kernels, named by a hash of the source
and the flags, and never writes into ``native/``. Nothing is built at
import. Where the build or the load fails (no compiler, no libjpeg),
:func:`get_runtime` returns None, as the JAX package's does, and keeps the
reason in ``build_error``; callers then decode with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops.native import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "native" / "host_loader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LINK_FLAGS = ("-ljpeg", "-lpthread")

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_INT64_P = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libadil_host-{digest[:16]}.so"


def build() -> Path:
    """Compile ``native/host_loader.cpp`` unless it is built already; returns
    the library's path. Raises RuntimeError with the compiler's output where
    the build fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing")
    target = library_path()
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: g++ is not on PATH and CXX is not set")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(f"{cxx} failed for {SOURCE.name} (rc {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, target)
    return target


class NativeRuntime:
    """The loaded native library."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.adil_decode_batch.restype = ctypes.c_int
        lib.adil_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, _FLOAT_P,
        ]
        lib.adil_loader_create.restype = ctypes.c_void_p
        lib.adil_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _INT64_P, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.adil_loader_next_indexed.restype = ctypes.c_int64
        lib.adil_loader_next_indexed.argtypes = [ctypes.c_void_p, _FLOAT_P, _INT64_P, _INT64_P]
        lib.adil_loader_num_batches.restype = ctypes.c_int64
        lib.adil_loader_num_batches.argtypes = [ctypes.c_void_p]
        lib.adil_loader_destroy.restype = None
        lib.adil_loader_destroy.argtypes = [ctypes.c_void_p]

    def decode_batch(self, paths: Sequence[str], size: int = 224,
                     resize: int = 256) -> np.ndarray:
        """Thread-pool decode of JPEG files -> (N, size, size, 3) float32."""
        n = len(paths)
        out = np.zeros((n, size, size, 3), np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = self._lib.adil_decode_batch(arr, n, size, resize, out.ctypes.data_as(_FLOAT_P))
        if rc != 0:
            raise IOError(f"native decode failed for {-rc} of {n} files")
        return out


class HostLoader:
    """Prefetching batch iterator over (paths, labels) on C++ threads.

    :meth:`iter_indexed` yields ``(batch index, images (B, S, S, 3) float32,
    labels (B,) int64, rows (B,) int64)``: ``rows`` are the dataset rows of
    the slots, which address the per-image codes under shuffling. Label -1
    marks a padding slot of the last batch (row -1) and -2 a file that
    failed to decode; keep ``labels >= 0``.
    """

    def __init__(self, runtime: NativeRuntime, paths: Sequence[str], labels: Sequence[int],
                 batch_size: int, image_size: int = 224, resize: int = 256,
                 shuffle: bool = False, seed: int = 0, queue_depth: int = 4,
                 n_threads: int = 0):
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} paths but {len(labels)} labels")
        self._rt = runtime
        self._batch = batch_size
        self._size = image_size
        n = len(paths)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        lab = np.ascontiguousarray(labels, np.int64)
        self._handle = runtime._lib.adil_loader_create(
            arr, lab.ctypes.data_as(_INT64_P), n, batch_size, image_size, resize,
            int(shuffle), seed, queue_depth, n_threads)
        self.num_batches = int(runtime._lib.adil_loader_num_batches(self._handle))

    def iter_indexed(self):
        for _ in range(self.num_batches):
            images = np.empty((self._batch, self._size, self._size, 3), np.float32)
            labels = np.empty((self._batch,), np.int64)
            rows = np.empty((self._batch,), np.int64)
            idx = self._rt._lib.adil_loader_next_indexed(
                self._handle, images.ctypes.data_as(_FLOAT_P),
                labels.ctypes.data_as(_INT64_P), rows.ctypes.data_as(_INT64_P))
            if idx < 0:
                return
            yield int(idx), images, labels, rows

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._rt._lib.adil_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


_runtime: Optional[NativeRuntime] = None
_tried = False
_lock = threading.Lock()
build_error: Optional[str] = None  # why get_runtime() returned None, if it did


def _library(build_it: bool) -> Path:
    if build_it:
        return build()
    path = library_path()
    if not path.exists():
        raise RuntimeError(f"{path} is not built, and get_runtime(build=False) builds nothing")
    return path


def get_runtime(build: bool = True) -> Optional[NativeRuntime]:
    """The native runtime, built on first use; None where it cannot be built
    or loaded (the reason is kept in ``build_error``). ``build=False`` only
    loads a library built before, as in the JAX package. The first call
    decides, and later calls return its result."""
    global _runtime, _tried, build_error
    with _lock:
        if not _tried:
            _tried = True
            try:
                _runtime = NativeRuntime(ctypes.CDLL(str(_library(build))))
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                build_error = str(e)
        return _runtime
