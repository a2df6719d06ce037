"""Outlier-robust exponentially weighted monitoring and blow-up detection.

Port (a numpy copy) of ``neuralsvd_tpu/training/ewm.py``: the host-side
consumer of the per-step (9, L) statistics the train step computes on the
device with ``monitor=True`` (``training/train_operator.py::batch_stats``).
Tracks an EWM mean, variance and squared error per statistic with outlier
rejection; ``stat_outlier`` or more statistics out at once arm a "blowup"
state with an indicator.  Blow-ups are reported, not acted on.
"""
from __future__ import annotations

import math

import numpy as np

STAT_LABELS = "-3s -2s -1s med +1s +2s +3s mean mean_slow".split()
STAT_INDEX = {label: i for i, label in enumerate(STAT_LABELS)}


class EWMAverage:
    """EWM of a statistic vector with outlier-robust updates."""

    def __init__(self, init: int = 5, outlier: float = 3.0,
                 outlier_maxlen: int = 3, max_alpha: float = 0.999,
                 decay_alpha: float = 10.0):
        self.step = 0
        self._init = init
        self._outlier = outlier
        self._outlier_maxlen = outlier_maxlen
        self._max_alpha = max_alpha
        self._decay_alpha = decay_alpha
        self._mean = None
        self._var = None
        self._sqerr = None
        self._n_outlier = None

    def _alpha(self, n: int) -> float:
        return min(self._max_alpha, 1 - 1 / (2 + n / self._decay_alpha))

    @property
    def mean(self):
        return self._mean

    @property
    def std(self):
        return np.sqrt(self._var)

    @property
    def mean_stderr(self):
        return np.sqrt(self._sqerr)

    def update(self, x, alpha=None):
        x = np.asarray(x, dtype=np.float64)
        a = np.asarray(alpha if alpha is not None else self._alpha(self.step))
        if self.step >= self._init:
            is_outlier = ((np.abs(x - self._mean) > self._outlier * np.sqrt(self._var))
                          & (self._n_outlier <= self._outlier_maxlen))
        else:
            is_outlier = np.zeros_like(x, dtype=bool)
        no_update = is_outlier | np.isnan(x)
        if self.step == 0:
            self._mean = x.copy()
            self._var = np.zeros_like(x)
            self._sqerr = np.zeros_like(x)
            self._n_outlier = np.zeros_like(x)
        else:
            var = (1 - a) * (x - self._mean) ** 2 + a * self._var
            mean = (1 - a) * x + a * self._mean
            sqerr = (1 - a) ** 2 * self._var + a ** 2 * self._sqerr
            self._var = np.where(no_update, self._var, var)
            self._mean = np.where(no_update, self._mean, mean)
            self._sqerr = np.where(no_update, self._sqerr, sqerr)
            self._n_outlier = np.where(is_outlier, self._n_outlier + 1, 0)
        self.step += 1
        return is_outlier


class EWMMonitor(EWMAverage):
    """Per-mode blow-up detector over erf-spaced percentile statistics."""

    def __init__(self, stat_outlier: int = 6, blowup_maxlen: int = 25,
                 blowup_thre: float = 0.5, **kwargs):
        super().__init__(max_alpha=1.0, **kwargs)
        self.blowup = {}
        self._stat_outlier = stat_outlier
        self._blowup_maxlen = blowup_maxlen
        self._blowup_thre = blowup_thre

    def mean_of(self, label: str):
        """(mean, stderr) of a tracked statistic."""
        i = STAT_INDEX[label]
        return self._mean[i], float(np.sqrt(self._sqerr[i]))

    def update_stats(self, stat: np.ndarray):
        """Consume a precomputed (9,) statistic vector (device-side stats)."""
        I = STAT_INDEX
        stat = np.asarray(stat, dtype=np.float64)
        a = np.empty_like(stat)
        alpha = self._alpha(self.step)
        a[: I["mean_slow"]] = min(0.96, alpha)
        a[I["mean_slow"]] = min(0.999, alpha)
        is_outlier = super().update(stat, a)
        if is_outlier[: I["mean_slow"]].sum() >= self._stat_outlier:
            if not self.blowup:
                self.blowup = {"init": self.step, "step": self.step,
                               "start": self._mean[I["mean"]]}
            else:
                self.blowup["step"] = self.step
        if self.blowup and self.step - self.blowup["step"] > self._blowup_maxlen:
            self.blowup = {}
        if self.blowup:
            denom = np.sqrt(self._var[I["mean"]])
            self.blowup["indicator"] = (
                (self._mean[I["mean"]] - self.blowup["start"]) / denom
                if denom > 0 else 0.0)
            self.blowup["in_blowup"] = self.blowup["indicator"] > self._blowup_thre
        return is_outlier, stat

    def update(self, x):
        """Full-batch update path: compute the 9 statistics from raw values."""
        pts = [math.erf(v / math.sqrt(2)) for v in range(-3, 4)]
        percentiles = 100 * (1 + np.array(pts)) / 2
        x = np.asarray(x)
        stat = np.empty(len(STAT_LABELS))
        stat[: len(percentiles)] = np.percentile(x, percentiles)
        stat[STAT_INDEX["mean"]:] = x.mean()
        return self.update_stats(stat)
