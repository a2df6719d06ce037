"""Build and load the hand-written CUDA kernels: one nvcc call, ctypes.

The sources under ``neuralsvd_tpu_torch/csrc/`` have a plain C interface
and include no PyTorch header, so a single
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared``
builds them in seconds.  The library is built at first use into
``csrc/build/`` (ignored by git), named by a hash of the sources and flags,
and written by an atomic rename, so parallel processes and rebuilds never
see a half-written file.  ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside it as ``<library>.log``.

Nothing here runs at import time.  The first load runs in the set-up span
``setup.kernels`` (``utils/tracing.py``), an nvcc run inside it in
``setup.kernels.build``; the counters ``kernels.builds`` and
``kernels.loads`` count nvcc runs and loads.
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

from neuralsvd_tpu_torch.utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("gram_kernels.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of the C launchers in csrc/gram_kernels.cu
_SIGNATURES = {
    "gram_masked_gram_pair": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P],
    "gram_weighted_dot": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gram_metric_grads": [_P, _P, _P, _P, _F, _F, _P, _P, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then
    ``DEFAULT_NVCC``."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH "
        "to build neuralsvd_tpu_torch/csrc")


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    return Path(build_dir) / f"libgram_kernels_{digest.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources unless a library for them already exists."""
    lib = library_path(build_dir)
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{os.getpid()}.{uuid.uuid4().hex}.{lib.name}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    tracing.count("kernels.builds")
    try:
        with tracing.timed("setup.kernels.build"):
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        lib.with_name(lib.name + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
@tracing.timed("setup.kernels")
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build()))
    tracing.count("kernels.loads")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gram_error_string.argtypes = [ctypes.c_int]
    lib.gram_error_string.restype = ctypes.c_char_p
    return lib
