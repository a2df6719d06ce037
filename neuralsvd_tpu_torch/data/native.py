"""The native host-side data path: the C++ pair sampler, bound with ctypes.

Port of ``neuralsvd_tpu/data/native.py``.  ``csrc/pair_sampler.cpp`` (the
port's own copy of the JAX package's source) draws the class-balanced
(sketch, photo) index pairs of a CDK batch and gathers feature rows; at
batch 4096 it fills a batch's indices in microseconds where the Python
loop takes milliseconds.

The library is built with ``g++`` at first use into ``csrc/build/``
(ignored by git), named by a hash of the source and flags and written by
an atomic rename, as ``ops/cuda_build.py`` builds the CUDA kernels, so
processes that build at once each load a whole file.  A failed build
raises ``RuntimeError`` naming the compiler; nothing here falls back to
the Python loop (a loader runs it only when asked, ``use_native=False``).

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = "pair_sampler.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
CXX_TIMEOUT_S = 120

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def find_cxx() -> str:
    """The C++ compiler: ``CXX`` if set, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native pair sampler "
                           "(neuralsvd_tpu_torch/csrc/pair_sampler.cpp) needs a "
                           "C++ compiler; set CXX or put g++ on PATH")
    return cxx


def library_path(build_dir=None) -> Path:
    """The library's path in ``build_dir`` (default: ``BUILD_DIR``)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update((CSRC / SOURCE).read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libpair_sampler_{digest.hexdigest()[:16]}.so"


def build(build_dir=None) -> Path:
    """Compile the sampler unless a library for this source already exists."""
    lib = library_path(build_dir)
    if lib.is_file():
        return lib
    cxx = find_cxx()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{os.getpid()}.{uuid.uuid4().hex}.{lib.name}")
    cmd = [cxx, *CXX_FLAGS, str(CSRC / SOURCE), "-o", str(tmp)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=CXX_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{cxx} could not build {SOURCE}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SOURCE} "
                               f"(exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.sample_pairs.argtypes = [_I32P, _I32P, _I32P, _I32P,
                                 ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_uint64, ctypes.c_uint64,
                                 _I32P, _I32P, _I32P]
    lib.sample_pairs.restype = None
    lib.gather_rows_f32.argtypes = [_F32P, _I32P, ctypes.c_int32, ctypes.c_int32, _F32P]
    lib.gather_rows_f32.restype = None
    return lib


def get_lib(build_dir=None) -> ctypes.CDLL:
    """The sampler library, built if needed and loaded once per file."""
    return _load(str(build(build_dir)))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _pack(idx_per_class: dict, classes) -> tuple:
    """{class: [indices]} -> (offsets (C + 1,), flat indices) int32."""
    offsets = np.zeros(len(classes) + 1, np.int32)
    flat = []
    for i, c in enumerate(classes):
        members = idx_per_class.get(c, [])
        flat.extend(members)
        offsets[i + 1] = offsets[i] + len(members)
    return offsets, np.asarray(flat, np.int32)


class NativePairSampler:
    """Class-balanced pair sampler on the C++ library.

    Built from {class: [indices]} dicts of the two sides and the class
    list; ``sample(batch_size, counter)`` -> (sketch_idx, photo_idx, cls)
    int32 arrays, ``cls`` the position in ``classes``.  Deterministic in
    (seed, counter), and equal to the JAX package's sampler on the same
    arguments.  Builds the library (``build_dir``) when constructed.
    """

    def __init__(self, sketch_idx_per_class: dict, photo_idx_per_class: dict,
                 classes, seed: int = 0, build_dir=None):
        self.classes = list(classes)
        self.seed = seed
        self._lib = get_lib(build_dir)
        self.sk_off, self.sk_flat = _pack(sketch_idx_per_class, self.classes)
        self.ph_off, self.ph_flat = _pack(photo_idx_per_class, self.classes)
        # the C loop cycles until the batch is full: a class with members on
        # both sides must exist
        self._drawable = bool(((np.diff(self.sk_off) > 0)
                               & (np.diff(self.ph_off) > 0)).any())

    def sample(self, batch_size: int, counter: int):
        if batch_size < 0 or counter < 0:
            raise ValueError(f"batch_size {batch_size} and counter {counter} "
                             "must be non-negative")
        if batch_size and not self._drawable:
            raise ValueError("no class has both a sketch and a photo to draw")
        out_sk = np.empty(batch_size, np.int32)
        out_ph = np.empty(batch_size, np.int32)
        out_cls = np.empty(batch_size, np.int32)
        self._lib.sample_pairs(
            _i32p(self.sk_off), _i32p(self.sk_flat),
            _i32p(self.ph_off), _i32p(self.ph_flat),
            ctypes.c_int32(len(self.classes)), ctypes.c_int32(batch_size),
            ctypes.c_uint64(self.seed), ctypes.c_uint64(counter),
            _i32p(out_sk), _i32p(out_ph), _i32p(out_cls))
        return out_sk, out_ph, out_cls

    def gather(self, src: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """``gather_rows(src, idx)`` on this sampler's library."""
        return _gather(self._lib, src, idx)


def _gather(lib: ctypes.CDLL, src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    if src.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"gather_rows takes a 2-D src and 1-D idx, got "
                         f"{src.shape} and {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(f"row index out of range for {src.shape[0]} rows")
    out = np.empty((idx.shape[0], src.shape[1]), np.float32)
    lib.gather_rows_f32(src.ctypes.data_as(_F32P), _i32p(idx),
                        ctypes.c_int32(idx.shape[0]), ctypes.c_int32(src.shape[1]),
                        out.ctypes.data_as(_F32P))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray, build_dir=None) -> np.ndarray:
    """``src[idx]`` for a 2-D ``src`` as float32, by the native row copy
    (a float32 copy of ``src`` is made first where it is another dtype or
    not contiguous)."""
    return _gather(get_lib(build_dir), src, idx)
