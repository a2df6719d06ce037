"""Metric meters and classification accuracy.

Port of ``neuralsvd_tpu/utils/meters.py`` (numpy, the port's own copy):
``AverageMeter``, ``ProgressMeter``, ``accuracy`` (top-k, in percent, of
numpy arrays or tensors), ``Metric`` and ``create_metric``.
"""
from __future__ import annotations

import numpy as np
import torch


class AverageMeter:
    """Tracks current value, running average, sum and count."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        width = len(str(self.num_batches))
        entries = [f"{self.prefix}[{batch:{width}d}/{self.num_batches}]"]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def accuracy(logits, targets, topk=(1,)):
    """Top-k accuracies in percent (a list, one per k)."""
    logits = _numpy(logits)
    targets = _numpy(targets)
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == targets[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


class Metric:
    """Running best ("max", "min") or average ("avg") of a scalar."""

    def __init__(self, kind: str = "avg"):
        if kind not in ("avg", "max", "min"):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.kind = kind
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._n = 0
        self.curr_val = (-np.inf if self.kind == "max"
                         else np.inf if self.kind == "min" else None)

    def update(self, value):
        if self.kind == "max":
            self.curr_val = max(self.curr_val, value)
        elif self.kind == "min":
            self.curr_val = min(self.curr_val, value)
        else:
            self._sum += value
            self._n += 1
            self.curr_val = self._sum / self._n
        return self.curr_val

    def val(self):
        return self.curr_val


def create_metric(kind: str) -> Metric:
    return Metric(kind)
