"""The CUDA kernels' own source, run on the CPU against the plain versions.

``neuralsvd_tpu_torch/csrc/gram_kernels.cu`` is compiled with the host C++
compiler against ``tests/torch_cuda_emulator.h``, a stand-in for the CUDA
runtime: each block runs as host threads with real barriers and warp
shuffles, and the ``cp.async`` copies land either at once or only at the
wait that must see them.  The launch syntax and the three ``cp.async``
helpers are the only parts of the source that are replaced.  So the index
arithmetic, the copy mapping, the SYRK tile table, the split-K plan, the
ring's waits and barriers and the fixed-order sums are checked here, on
every CPU run, before a GPU sees them; speed and the PTX itself are not.

K1 and K3 are held to 1e-5 of their plain versions on |inputs| (the f32
rounding scale, as on the card), the grams must come out exactly
symmetric, and a second call must repeat every bit.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralsvd_tpu_torch.ops import cuda_build, cuda_gram
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)

TESTS = Path(__file__).resolve().parent
KERNEL_RTOL = 1e-5
# (rows, modes, nesting): widths on both sides of the 64-wide tiles, of
# K3's 96-wide tiles and of the 16-byte copies; row counts that leave
# ragged chunks and ragged stages
CASES = [(33, 1, "joint"), (40, 16, "sequential"), (100, 63, "joint"),
         (70, 64, "sequential"), (50, 65, "joint"), (40, 129, "sequential"),
         (300, 130, "joint")]


def _emulated_source() -> str:
    src = (cuda_build.CSRC / "gram_kernels.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "torch_cuda_emulator.h"')
    src, n = re.subn(
        r"template <int kBytes>\n__device__ __forceinline__ void cp_async_zfill.*?"
        r"template <int kPending>\n__device__ __forceinline__ void cp_async_wait\(\) \{.*?\n\}\n",
        "", src, flags=re.S)
    assert n == 1, "the cp.async helpers moved"

    def launch(m):
        depth, cut = 0, None
        for i, ch in enumerate(m.group(2)):
            depth += ch in "(["
            depth -= ch in ")]"
            if ch == "," and depth == 0:
                if cut is None:
                    cut = i
                else:
                    grid, threads = m.group(2)[:cut], m.group(2)[cut + 1:i]
                    break
        return f"emu_launch(dim3({grid}), {threads}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    src, n = re.subn(r"(\w+(?:<\d+>)?)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
    assert n == 8, f"{n} launches"
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("emulated")
    (out / "gram_kernels_emulated.cpp").write_text(_emulated_source())
    lib = out / "libgram_emulated.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
         "-I", str(TESTS), "-o", str(lib), str(out / "gram_kernels_emulated.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in cuda_build._SIGNATURES.items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = ctypes.c_int
    return dll


def _k1(dll, f1, f2, mmask):
    """K1 through the C launcher, with the wrapper's plan and tile table."""
    B, L = f1.shape
    plan = cuda_gram.k1_plan(B, L)
    tiles = torch.as_tensor(cuda_gram.upper_tiles(L))
    partial = torch.full((plan.nchunk, 2, L, L), float("nan"))
    loss_part = torch.full((plan.finish_blocks,), float("nan"))
    out = torch.full((4, L, L), float("nan"))
    loss = torch.full((), float("nan"))
    lam1, lam2, mlam1, mlam2 = out.unbind(0)
    rc = dll.gram_masked_gram_pair(
        f1.data_ptr(), f2.data_ptr(), mmask.data_ptr(), tiles.data_ptr(), len(tiles),
        partial.data_ptr(), loss_part.data_ptr(), lam1.data_ptr(), lam2.data_ptr(),
        mlam1.data_ptr(), mlam2.data_ptr(), loss.data_ptr(), B, L, plan.rows_per_chunk,
        cuda_gram._vec(L, f1, f2, partial), None)
    assert rc == 0
    return loss, lam1, lam2, mlam1, mlam2


def _k3(dll, f1, f2, mlam1, mlam2, s1, s2):
    B, L = f1.shape
    g1 = torch.full_like(f1, float("nan"))
    g2 = torch.full_like(f2, float("nan"))
    rc = dll.gram_metric_grads(f1.data_ptr(), f2.data_ptr(), mlam1.data_ptr(),
                               mlam2.data_ptr(), s1, s2, g1.data_ptr(), g2.data_ptr(),
                               B, L, cuda_gram._vec(L, f1, f2, mlam1, mlam2, g1, g2), None)
    assert rc == 0
    return g1, g2


def _within(got, want, scale):
    for a, b, sc in zip(got, want, scale):
        assert torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= KERNEL_RTOL * sc.abs().max().item(), err


def _check(dll, f1, f2, nesting, defer):
    ctypes.c_int.in_dll(dll, "emu_defer").value = int(defer)
    B, L = f1.shape
    masks = (joint_nesting_masks(step_weights(L)) if nesting == "joint"
             else sequential_nesting_masks(L))
    mmask = torch.as_tensor(masks[1])
    got = _k1(dll, f1, f2, mmask)
    _within(got, cuda_gram.masked_gram_pair_ref(f1, f2, mmask),
            cuda_gram.masked_gram_pair_ref(f1.abs(), f2.abs(), mmask))
    assert torch.equal(got[1], got[1].T) and torch.equal(got[2], got[2].T)
    again = _k1(dll, f1, f2, mmask)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    mlam1, mlam2 = got[3], got[4]
    s1, s2 = 2.0 / B, 3.0 / B
    grads = _k3(dll, f1, f2, mlam1, mlam2, s1, s2)
    _within(grads, cuda_gram.metric_grads_ref(f1, f2, mlam1, mlam2, s1, s2),
            cuda_gram.metric_grads_ref(f1.abs(), f2.abs(), mlam1.abs(), mlam2.abs(), s1, s2))
    assert all(torch.equal(a, b)
               for a, b in zip(grads, _k3(dll, f1, f2, mlam1, mlam2, s1, s2)))
    assert ctypes.c_int.in_dll(dll, "emu_faults").value == 0


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("B,L,nesting", CASES)
def test_emulated_k1_k3_match_plain_versions(emulated, B, L, nesting, defer):
    rng = np.random.default_rng(B * 1000 + L)
    f1, f2 = (torch.as_tensor(rng.standard_normal((B, L), dtype=np.float32))
              for _ in range(2))
    _check(emulated, f1, f2, nesting, defer)


def test_emulated_kernels_take_4_byte_copies_of_misaligned_rows(emulated):
    """Rows that start off a 16-byte boundary (a view one float into its
    storage) take the 4-byte path even where L % 4 == 0."""
    B, L = 40, 64
    flat = torch.as_tensor(np.random.default_rng(7).standard_normal(
        2 * B * L + 1, dtype=np.float32))
    f1 = flat[1:1 + B * L].view(B, L)
    f2 = flat[1 + B * L:].view(B, L)
    assert cuda_gram._vec(L, f1, f2) == 1
    _check(emulated, f1, f2, "joint", defer=True)
