"""Experiment store: per-run directories and readers of them.

Port of ``neuralsvd_tpu/utils/store.py``: ``ExperimentLogWriter`` (:17),
``RunReader`` (:63), ``ExperimentLogReader`` (:103) and ``mark_done``
(:125).  The files are the JAX package's: ``args.json`` (values JSON
cannot hold as their ``repr``), ``<name>.csv`` data-dicts appended to,
``<tag>_<step>`` checkpoints with a ``latest_<tag>`` marker holding the
step, and a ``done`` marker; so either package reads the other's runs.
The checkpoint files themselves are each package's own
(training/checkpoint.py: ``torch.save`` here, Orbax in JAX); states cross
between them through ``convert.py``.
"""
from __future__ import annotations

import csv
import glob
import json
import os
from typing import Any, Dict, List, Optional

from neuralsvd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["ExperimentLogReader", "ExperimentLogWriter", "RunReader", "mark_done"]


class ExperimentLogWriter:
    """Owns one run directory: args.json, csv data-dicts, checkpoints."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._csv: Dict[str, csv.DictWriter] = {}
        self._files: Dict[str, Any] = {}

    def save_args(self, args: Any):
        data = vars(args) if hasattr(args, "__dict__") else dict(args)
        with open(os.path.join(self.log_dir, "args.json"), "w") as fh:
            json.dump({k: v if _jsonable(v) else repr(v) for k, v in data.items()},
                      fh, indent=2)

    def init_data_dict(self, name: str, fieldnames: List[str]):
        fh = open(os.path.join(self.log_dir, f"{name}.csv"), "a", newline="")
        writer = csv.DictWriter(fh, fieldnames=fieldnames, extrasaction="ignore")
        if fh.tell() == 0:
            writer.writeheader()
        self._csv[name] = writer
        self._files[name] = fh

    def append(self, name: str, row: dict):
        self._csv[name].writerow(row)
        self._files[name].flush()

    def save_checkpoint(self, state, step: int, tag: str = "ckpt") -> str:
        """``<tag>_<step>`` (training/checkpoint.py), then the
        ``latest_<tag>`` marker the resume scans read."""
        path = save_checkpoint(os.path.join(self.log_dir, f"{tag}_{step}"), state)
        with open(os.path.join(self.log_dir, f"latest_{tag}"), "w") as fh:
            fh.write(str(step))
        return path

    def close(self):
        for fh in self._files.values():
            fh.close()


class RunReader:
    """Read one run directory: args, csv data-dicts, the latest checkpoint."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    @property
    def args(self) -> dict:
        path = os.path.join(self.log_dir, "args.json")
        if not os.path.exists(path):
            return {}
        with open(path) as fh:
            return json.load(fh)

    def data(self, name: str) -> List[dict]:
        path = os.path.join(self.log_dir, f"{name}.csv")
        if not os.path.exists(path):
            return []
        with open(path) as fh:
            return list(csv.DictReader(fh))

    def latest_step(self, tag: str = "ckpt") -> Optional[int]:
        marker = os.path.join(self.log_dir, f"latest_{tag}")
        if not os.path.exists(marker):
            return None
        with open(marker) as fh:
            return int(fh.read().strip())

    def load_latest(self, tag: str = "ckpt"):
        """(state, step) of the latest checkpoint, (None, None) without
        one; tensors on the CPU."""
        step = self.latest_step(tag)
        if step is None:
            return None, None
        return load_checkpoint(os.path.join(self.log_dir, f"{tag}_{step}")), step


class ExperimentLogReader:
    """The runs under a root directory."""

    def __init__(self, root: str):
        self.root = root

    def runs(self, pattern: str = "*") -> List[RunReader]:
        dirs = sorted(d for d in glob.glob(os.path.join(self.root, pattern))
                      if os.path.isdir(d))
        return [RunReader(d) for d in dirs]

    def resume_killed(self, tag: str = "ckpt") -> List[RunReader]:
        """Runs with a latest checkpoint but no ``done`` marker: the
        candidates for resumption."""
        return [run for run in self.runs()
                if run.latest_step(tag) is not None
                and not os.path.exists(os.path.join(run.log_dir, "done"))]


def mark_done(log_dir: str):
    with open(os.path.join(log_dir, "done"), "w") as fh:
        fh.write("done")


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False
