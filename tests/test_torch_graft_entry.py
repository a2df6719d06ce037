"""The port's entry points (neuralsvd_tpu_torch/graft_entry.py), the cases of
tests/test_graft_entry.py: the dryrun provisions its own ranks in a
subprocess from a bare process, never asks the caller's process about its
devices, and raises on the child's timeout and on its failure; and
``entry()`` evaluates the flagship model."""
import os
import subprocess
import sys

import torch

from neuralsvd_tpu_torch import graft_entry as g

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_self_provisions_from_one_process():
    """A bare process that holds no process group runs the dryrun on four
    gloo ranks (dp=2 x tp=2, and dp=4 for the CDK step)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as dist; assert not dist.is_initialized(); "
         "from neuralsvd_tpu_torch import graft_entry as g; g.dryrun_multichip(4)"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


def test_dryrun_never_probes_caller_backend(monkeypatch):
    """The dryrun does not ask the caller's torch about its cards (here
    every such question raises) and runs a bounded subprocess that sees no
    card."""
    def _probed(*a, **k):
        raise AssertionError("dryrun_multichip probed the caller's CUDA devices")

    for name in ("is_available", "device_count", "init", "current_device"):
        monkeypatch.setattr(torch.cuda, name, _probed)
    seen = {}

    def _fake_run(cmd, env=None, **kw):
        seen.update(cmd=cmd, env=env, timeout=kw.get("timeout"))
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(g.subprocess, "run", _fake_run)
    g.dryrun_multichip(8)
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == ""
    assert seen["cmd"][-2:] == ["--dryrun", "8"]
    assert seen["timeout"] and seen["timeout"] <= 3600


def test_dryrun_subprocess_timeout_raises(monkeypatch):
    def _hang(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw.get("timeout", 0), output=b"partial")

    monkeypatch.setattr(g.subprocess, "run", _hang)
    try:
        g.dryrun_multichip(8)
    except RuntimeError as e:
        assert "timed out" in str(e) and "partial" in str(e)
    else:
        raise AssertionError("expected RuntimeError on subprocess timeout")


def test_dryrun_subprocess_failure_raises(monkeypatch):
    monkeypatch.setattr(
        g.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 7, stdout="out", stderr="boom"))
    try:
        g.dryrun_multichip(8)
    except RuntimeError as e:
        assert "rc=7" in str(e) and "boom" in str(e)
    else:
        raise AssertionError("expected RuntimeError on subprocess failure")


def test_entry_evaluates_the_flagship_model():
    """entry(): the L 36 flagship wavefunction on 512 points, finite; the
    default device is the card (a CPU-only torch raises rather than falling
    back)."""
    fn, args = g.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (512, 36) and torch.isfinite(out).all()
    if not torch.cuda.is_available():
        try:
            g.entry()
        except RuntimeError as e:
            assert "cpu" in str(e).lower() or "cuda" in str(e).lower()
        else:
            raise AssertionError("entry() ran without a card")
