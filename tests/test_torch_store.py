"""The experiment store, ``MetricsLogger`` and ``latest_checkpoint``
against the JAX package's (``neuralsvd_tpu/utils/store.py``,
``utils/logging.py:29``, ``training/checkpoint.py:142``): each package
reads the run directories the other writes (tests/test_spectrum_store.py's
round trip, :94 and :105), and both write the same metric lines.  The
checkpoint files are each package's own; only their names and markers
are shared.
"""
import os

import numpy as np
import pytest
import torch

from neuralsvd_tpu.training.checkpoint import latest_checkpoint as jax_latest_checkpoint
from neuralsvd_tpu.utils import store as jax_store
from neuralsvd_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from neuralsvd_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    latest_iteration_checkpoint,
)
from neuralsvd_tpu_torch.utils import store
from neuralsvd_tpu_torch.utils.logging import MetricsLogger

ARGS = {"lr": 1e-3, "neigs": 4, "nested": {"step": 1}, "dtype": np.float32}


def _write_run(mod, run_dir, state):
    w = mod.ExperimentLogWriter(run_dir)
    w.save_args(ARGS)
    w.init_data_dict("train", ["iter", "loss"])
    for i in range(5):
        w.append("train", {"iter": i, "loss": 1.0 / (i + 1), "extra": "ignored"})
    w.save_checkpoint(state, step=50)
    w.close()


def _read_run(mod, root, run_dir):
    r = mod.RunReader(run_dir)
    assert r.args["lr"] == 1e-3 and r.args["nested"] == {"step": 1}
    assert r.args["dtype"] == repr(np.float32)
    rows = r.data("train")
    assert len(rows) == 5 and float(rows[-1]["loss"]) == 0.2 and set(rows[0]) == {"iter", "loss"}
    assert r.latest_step() == 50 and r.latest_step("best") is None
    reader = mod.ExperimentLogReader(root)
    assert [os.path.basename(run.log_dir) for run in reader.runs()] == ["exp1"]
    assert len(reader.resume_killed()) == 1


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_store_runs_read_across_packages(tmp_path, writer, reader):
    """A run written by one package (args.json, a csv data-dict, a
    checkpoint with its ``latest_ckpt`` marker) is read by the other's
    ``RunReader`` and ``ExperimentLogReader``; ``mark_done`` of the writer
    takes the run out of the reader's ``resume_killed``."""
    mods = {"torch": store, "jax": jax_store}
    root = str(tmp_path / "runs")
    run_dir = os.path.join(root, "exp1")
    state = ({"w": torch.ones(3)} if writer == "torch" else {"w": np.ones(3)})
    _write_run(mods[writer], run_dir, state)
    assert os.path.exists(os.path.join(run_dir, "ckpt_50"))
    _read_run(mods[reader], root, run_dir)
    mods[writer].mark_done(run_dir)
    assert mods[reader].ExperimentLogReader(root).resume_killed() == []


def test_store_checkpoint_round_trip(tmp_path):
    """``load_latest`` gives back what ``save_checkpoint`` stored, and
    (None, None) before any checkpoint."""
    run_dir = str(tmp_path / "exp")
    w = store.ExperimentLogWriter(run_dir)
    assert store.RunReader(run_dir).load_latest() == (None, None)
    w.save_checkpoint({"w": torch.arange(3.0)}, step=10)
    w.save_checkpoint({"w": torch.arange(4.0)}, step=20, tag="best")
    state, step = store.RunReader(run_dir).load_latest()
    assert step == 10 and torch.equal(state["w"], torch.arange(3.0))
    state, step = store.RunReader(run_dir).load_latest("best")
    assert step == 20 and torch.equal(state["w"], torch.arange(4.0))


def test_metrics_logger_writes_the_jax_lines(tmp_path):
    """The same events logged by both packages' ``MetricsLogger`` give the
    same file, appended to across loggers."""
    for mod, sub in ((MetricsLogger, "torch"), (JaxMetricsLogger, "jax")):
        for start in (0, 10):
            log = mod(str(tmp_path / sub))
            log.log(start + 1, loss=0.5, lr=np.float32(1e-3))
            log.log(start + 2, loss=torch.tensor(0.25).item())
            log.close()
    got, want = ((tmp_path / sub / "metrics.jsonl").read_text() for sub in ("torch", "jax"))
    assert got == want and len(got.splitlines()) == 6


def test_latest_checkpoint_matches_jax(tmp_path):
    """The largest integer step of ``<prefix><step>`` entries; others and a
    missing directory give what JAX's gives."""
    for name in ("ckpt_100", "ckpt_2000", "ckpt_30", "ckpt_x", "ckpt_", "best_5000", "notes"):
        (tmp_path / name).write_text("")
    for args in ((str(tmp_path),), (str(tmp_path), "best_"), (str(tmp_path), "none_"),
                 (str(tmp_path / "missing"),)):
        assert latest_checkpoint(*args) == jax_latest_checkpoint(*args), args
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_2000")


def test_latest_checkpoint_one_rule(tmp_path):
    """``latest_checkpoint`` and the CLI's resume scan share one rule: a
    step is digits only, so names that Python's ``int`` would also read
    (a sign, a space, an underscore) are passed over by both."""
    for name in ("ckpt_40", "ckpt_+9000", "ckpt_ 8000", "ckpt_7_000", "ckpt_-5"):
        (tmp_path / name).write_text("")
    path = str(tmp_path / "ckpt_40")
    assert latest_iteration_checkpoint(str(tmp_path)) == (40, path)
    assert latest_checkpoint(str(tmp_path)) == path
    assert latest_iteration_checkpoint(str(tmp_path), "best_") is None
