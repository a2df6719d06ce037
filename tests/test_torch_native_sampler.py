"""The port's native pair sampler against the JAX package's C++ source.

The reference library is the JAX package's ``csrc/pair_sampler.cpp``
compiled here into a temporary directory and loaded with ctypes (not
through ``neuralsvd_tpu/data/native.py``, which builds in place).  The
port's loader on native draws is held to the features at the reference
library's indices, batch n at counter n across epochs.
"""
import ctypes
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from neuralsvd_tpu.data.sketchy import SketchyVGGDataLoader as JaxSketchyLoader
from neuralsvd_tpu_torch.data import native
from neuralsvd_tpu_torch.data.native import NativePairSampler, gather_rows
from neuralsvd_tpu_torch.data.sketchy import SketchyVGGDataLoader, write_feature_files

ROOT = Path(__file__).resolve().parent.parent
JAX_SOURCE = ROOT / "neuralsvd_tpu" / "csrc" / "pair_sampler.cpp"


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "libref_pair_sampler.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(JAX_SOURCE),
                    "-o", str(out)], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sample_pairs.argtypes = [i32p, i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_uint64, ctypes.c_uint64, i32p, i32p, i32p]
    lib.sample_pairs.restype = None
    return lib


def _ref_sample(lib, sk, ph, classes, batch, seed, counter):
    """The reference library's draw, packed as the JAX package packs."""
    def pack(idx_per_class):
        off = np.zeros(len(classes) + 1, np.int32)
        flat = []
        for i, c in enumerate(classes):
            flat.extend(idx_per_class.get(c, []))
            off[i + 1] = len(flat)
        return off, np.asarray(flat, np.int32)

    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    (so, sf), (po, pf) = pack(sk), pack(ph)
    out = [np.empty(batch, np.int32) for _ in range(3)]
    lib.sample_pairs(p(so), p(sf), p(po), p(pf), len(classes), batch, seed, counter,
                     *(p(o) for o in out))
    return out


@pytest.fixture
def idx_maps():
    rng = np.random.default_rng(0)
    classes = [f"c{i}" for i in range(12)]
    sk = {c: list(rng.choice(1000, size=rng.integers(3, 40), replace=False)) for c in classes}
    ph = {c: list(rng.choice(2000, size=rng.integers(3, 60), replace=False)) for c in classes}
    return classes, sk, ph


@pytest.mark.parametrize("seed,counter,batch", [(0, 0, 64), (0, 1, 4096), (7, 3, 100),
                                                (42, 2 ** 40, 37), (2 ** 63 + 5, 11, 12)])
def test_indices_equal_the_reference_bit_for_bit(ref_lib, idx_maps, seed, counter, batch):
    classes, sk, ph = idx_maps
    got = NativePairSampler(sk, ph, classes, seed=seed).sample(batch, counter)
    want = _ref_sample(ref_lib, sk, ph, classes, batch, seed, counter)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_pairs_are_class_consistent_and_balanced(idx_maps):
    classes, sk, ph = idx_maps
    out_sk, out_ph, out_cls = NativePairSampler(sk, ph, classes, seed=1).sample(
        4 * len(classes), counter=0)
    for s, p, c in zip(out_sk, out_ph, out_cls):
        assert s in sk[classes[c]] and p in ph[classes[c]]
    assert (np.bincount(out_cls, minlength=len(classes)) == 4).all()


def test_a_class_without_photos_is_skipped_and_none_drawable_raises(ref_lib, idx_maps):
    classes, sk, ph = idx_maps
    ph = dict(ph, c3=[])
    got = NativePairSampler(sk, ph, classes, seed=2).sample(50, 1)
    np.testing.assert_array_equal(got[2], _ref_sample(ref_lib, sk, ph, classes, 50, 2, 1)[2])
    assert 3 not in got[2]
    with pytest.raises(ValueError, match="no class"):
        NativePairSampler(sk, {}, classes).sample(4, 1)
    assert NativePairSampler({}, {}, []).sample(0, 1)[0].shape == (0,)


def test_gather_rows_matches_numpy():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(500, 64)).astype(np.float32)
    idx = rng.integers(0, 500, size=200).astype(np.int32)
    for n in (200, 1, 0):
        np.testing.assert_array_equal(gather_rows(src, idx[:n]), src[idx[:n]])
    src64 = rng.normal(size=(20, 3))
    np.testing.assert_array_equal(gather_rows(src64, [3, 0, 19]),
                                  src64[[3, 0, 19]].astype(np.float32))
    with pytest.raises(IndexError):
        gather_rows(src, [500])
    with pytest.raises(ValueError):
        gather_rows(src[0], [0])


def test_native_beats_the_python_loop(idx_maps):
    """At batch 4096 the native draw is at least 5x faster than the
    Python loop of the loader's use_native=False path."""
    classes, sk, ph = idx_maps
    s = NativePairSampler(sk, ph, classes, seed=0)
    B, reps = 4096, 20
    s.sample(B, 0)
    t0 = time.perf_counter()
    for t in range(reps):
        s.sample(B, t)
    t_native = (time.perf_counter() - t0) / reps
    r = random.Random(0)

    def python_pick():
        cl = list(classes)
        r.shuffle(cl)
        out, i = [], 0
        while len(out) < B:
            c = cl[i % len(cl)]
            i += 1
            out.append((r.choice(sk[c]), r.choice(ph[c])))
        return out

    python_pick()
    t0 = time.perf_counter()
    for _ in range(reps):
        python_pick()
    t_python = (time.perf_counter() - t0) / reps
    assert t_native < t_python / 5, (t_native, t_python)


def test_a_failed_build_raises_naming_the_compiler(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="/bin/false failed to build pair_sampler.cpp"):
        native.build(tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler could not build"):
        native.build(tmp_path / "build")
    assert not any((tmp_path / "build").iterdir())
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.build(tmp_path / "build")


def test_the_loader_raises_where_the_sampler_cannot_build(tmp_path, monkeypatch):
    """No quiet fallback: the default (native) loader raises; the Python
    loop runs only under use_native=False."""
    _write_files(tmp_path / "root")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="failed to build"):
        SketchyVGGDataLoader(8, root_path=str(tmp_path / "root"), split="1")
    loader = SketchyVGGDataLoader(8, root_path=str(tmp_path / "root"), split="1",
                                  use_native=False)
    assert next(iter(loader))[0].shape == (8, 12)


def test_two_processes_building_at_once_both_load(tmp_path):
    code = ("import sys; from neuralsvd_tpu_torch.data.native import NativePairSampler; "
            "s = NativePairSampler({'a': [0, 1]}, {'a': [2]}, ['a'], seed=3, "
            "build_dir=sys.argv[1]); print(s.sample(4, 1)[0].tolist())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build")],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    assert outs[0][0] == outs[1][0]
    assert [f.name for f in (tmp_path / "build").iterdir()] == [native.library_path().name]


def _write_files(root, n_cls=5, per_cls=(9, 13), D=12, seed=0):
    rng = np.random.default_rng(seed)
    for phase in ("train", "test", "valid"):
        for kind, n in zip(("sketch", "photo"), per_cls):
            cls = np.repeat([f"cls{i}" for i in range(n_cls)], n)
            feats = rng.normal(size=(len(cls), D)).astype(np.float32)
            write_feature_files(str(root), "1", phase, kind, feats, cls)


@pytest.mark.parametrize("batch", [7, 64])
def test_loader_batches_are_the_reference_draws(ref_lib, tmp_path, batch):
    """Batch n (from 1, across two epochs) holds the features at the
    reference library's draw for (seed, n), with its class numbers."""
    _write_files(tmp_path)
    seed = 5
    port = SketchyVGGDataLoader(batch, root_path=str(tmp_path), split="1", seed=seed)
    ref = JaxSketchyLoader(batch, root_path=str(tmp_path), split="1", seed=seed,
                           use_native=False)
    assert port.max_steps == ref.max_steps
    n = 0
    for _ in range(2):
        for x, y, cls in port:
            n += 1
            si, pi, ci = _ref_sample(ref_lib, ref.sketch_idx_per_class,
                                     ref.photo_idx_per_class, ref.classes, batch, seed, n)
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, ref.sketch_features[si])
            np.testing.assert_array_equal(y, ref.photo_features[pi])
            np.testing.assert_array_equal(cls, ci)
    assert n == 2 * ref.max_steps
