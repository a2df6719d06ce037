"""CSV metric logging.

Port of ``neuralsvd_tpu/utils/logging.py::CSVLogger``, with one fault of
the original repaired: it names the file by the second it was opened and
opens it with "w", so a second logger in the same directory within the
same second truncated the first one's rows (a resumed run that starts
quickly loses the earlier epochs' log).  Here such a name gets a counter.
"""
from __future__ import annotations

import csv
import datetime
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
