"""Checkpoints through ``torch.save``, replaced atomically.

Port of ``neuralsvd_tpu/training/checkpoint.py::save_checkpoint`` /
``load_checkpoint`` for the CDK trainer and the PDE CLI (whose
``ckpt_<it>`` files ``latest_iteration_checkpoint`` finds for
``--resume``, as ``neuralsvd_tpu/cli/pde.py:213-229`` does), without two
faults of the original:
its save deletes the old checkpoint before the new one is written
(checkpoint.py:26), so a failed save loses the last good one, and its
resumable loader swallows every exception (checkpoint.py:136).  Here the
state is written to a temporary file beside the target and moved over it
with ``os.replace``, so the target is either the old checkpoint or the new
one; ``load_checkpoint`` raises on a missing or corrupt file.

A state is nested dicts, lists and tuples of tensors and Python scalars;
tensors come back on the CPU and are moved by the caller.
"""
from __future__ import annotations

import os
import re
import uuid
from typing import Any, Optional, Tuple

import torch


def save_checkpoint(path: str, state: Any) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.{uuid.uuid4().hex}.tmp")
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str) -> Any:
    """Restore a state saved by :func:`save_checkpoint` (tensors on the
    CPU); raises on a missing or unreadable file."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def latest_iteration_checkpoint(log_dir: str) -> Optional[Tuple[int, str]]:
    """(it, path) of the ``ckpt_<it>`` file in ``log_dir`` with the largest
    ``it``, or None when there is none."""
    found = [(int(m.group(1)), name) for name in os.listdir(log_dir)
             if (m := re.fullmatch(r"ckpt_(\d+)", name))]
    if not found:
        return None
    it, name = max(found)
    return it, os.path.join(log_dir, name)
