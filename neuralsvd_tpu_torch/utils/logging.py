"""CSV and JSONL metric logging.

Port of ``neuralsvd_tpu/utils/logging.py``: ``MetricsLogger`` (:29), and
``CSVLogger``, with one fault of
the original repaired: it names the file by the second it was opened and
opens it with "w", so a second logger in the same directory within the
same second truncated the first one's rows (a resumed run that starts
quickly loses the earlier epochs' log).  Here such a name gets a counter.
"""
from __future__ import annotations

import csv
import datetime
import json
import os
from typing import Sequence


class CSVLogger:
    def __init__(self, log_dir: str, fieldnames: Sequence[str],
                 name: str = "log"):
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.datetime.now().isoformat(timespec="seconds")
        base = os.path.join(log_dir, f"{name}_{stamp}")
        self.path, n = f"{base}.csv", 0
        while True:
            try:
                self._file = open(self.path, "x", newline="")
                break
            except FileExistsError:
                n += 1
                self.path = f"{base}_{n}.csv"
        self._writer = csv.DictWriter(self._file, fieldnames=fieldnames,
                                      extrasaction="ignore")
        self._writer.writeheader()

    def writerow(self, row: dict):
        self._writer.writerow(row)
        self._file.flush()

    def close(self):
        self._file.close()


class MetricsLogger:
    """Append-only JSONL scalar log, ``log_dir/name``: one line per scalar,
    ``{"step", "tag", "value"}``, as the JAX package writes it."""

    def __init__(self, log_dir: str, name: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, name), "a")

    def log(self, step: int, **scalars):
        for tag, value in scalars.items():
            self._fh.write(json.dumps(
                {"step": int(step), "tag": tag, "value": float(value)}) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
