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

K1, K2 and K3 are held to 1e-5 of their plain versions on |inputs| (the
f32 rounding scale, as on the card), the grams must come out exactly
symmetric, and a second call must repeat every bit.  K2's blocks also run
in reverse order, so the block that draws its last ticket (and sums the
partials) is block 0 instead of the last one, and its ticket counter
must be back at zero after every launch.
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
         (300, 130, "joint"), (256, 7, "sequential")]  # the last: the FP recipe's halves


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


def _k2(dll, f, tf, w, slots=None):
    """K2 through the C launcher, with the wrapper's plan or with ``slots``
    warps a row chunk; the ticket counter must come back to zero."""
    B, L = f.shape
    vec = cuda_gram._vec(L, f, tf, w)
    plan = cuda_gram.k2_plan(B, L, vec)
    if slots is not None:
        cols = L // vec
        nchunks = 1 if cols <= 32 else -(-cols // 32)
        plan = cuda_gram.K2Plan(slots=slots, blocks=-(-slots * nchunks // cuda_gram.DOT_WARPS))
    partial = torch.full((plan.blocks,), float("nan"))
    ticket = torch.zeros((1,), dtype=torch.int32)
    out = torch.full((), float("nan"))
    rc = dll.gram_weighted_dot(f.data_ptr(), tf.data_ptr(), w.data_ptr(),
                               partial.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                               B, L, plan.slots, plan.blocks, vec, None)
    assert rc == 0
    assert int(ticket) == 0
    return out, vec


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


# (rows, modes, slots): E4, a narrow odd width, widths on both sides of a
# warp's 32 vectors and of the 16-byte loads, with the wrapper's plan
# (slots None); and with a few slots, so that each warp strides over many
# rounds of row groups in every chunk, as the grid's cap makes it do at
# the CDK pair (4096 x 513: 17 chunks, 248 slots, ~4 rounds), at a
# fraction of its 527 blocks
K2_CASES = [(512, 16, None), (96, 5, None), (33, 1, None), (70, 128, None), (40, 129, None),
            (200, 129, None), (100, 512, None), (64, 513, 5), (300, 512, 3), (2000, 129, 7),
            (512, 7, None)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,L,slots", K2_CASES)
def test_emulated_k2_matches_plain_version(emulated, B, L, slots, reverse):
    """One launch per call at every shape; within 1e-5 of the plain
    version on |inputs|, bit for bit on a second call, with the copy width
    the wrapper picks (16 bytes where L % 4 == 0); where L % 4 == 0 a row
    view one float off its storage's alignment takes the 4-byte path."""
    ctypes.c_int.in_dll(emulated, "emu_reverse").value = int(reverse)
    rng = np.random.default_rng(B * 7 + L)
    flat = torch.as_tensor(rng.standard_normal(2 * B * L + 1, dtype=np.float32))
    w = torch.as_tensor(rng.random(L, dtype=np.float32))
    views = [(flat[:B * L].view(B, L), flat[B * L:2 * B * L].view(B, L))]
    if L % 4 == 0:  # the same rows one float off: 4-byte loads
        views.append((flat[1:1 + B * L].view(B, L), flat[1 + B * L:].view(B, L)))
    try:
        for f, tf in views:
            got, vec = _k2(emulated, f, tf, w, slots)
            want = cuda_gram.weighted_dot_ref(f, tf, w)
            scale = cuda_gram.weighted_dot_ref(f.abs(), tf.abs(), w)
            assert abs(got.item() - want.item()) <= KERNEL_RTOL * scale.item()
            assert torch.equal(got, _k2(emulated, f, tf, w, slots)[0])
            assert vec == (4 if L % 4 == 0 and f.data_ptr() % 16 == 0 else 1)
    finally:
        ctypes.c_int.in_dll(emulated, "emu_reverse").value = 0
    assert ctypes.c_int.in_dll(emulated, "emu_faults").value == 0
