"""Checkpoints through ``torch.save``, replaced atomically.

Port of ``neuralsvd_tpu/training/checkpoint.py``: ``save_checkpoint`` /
``load_checkpoint`` for the CDK trainer and the PDE CLI (whose
``ckpt_<it>`` files ``latest_iteration_checkpoint`` finds for
``--resume``, as ``neuralsvd_tpu/cli/pde.py:213-229`` does),
``latest_checkpoint`` (:142), and the
checkpoint API of the validation harnesses, ``save_resumable``,
``load_resumable`` and ``load_pretrained`` (:41-155), without two faults
of the original: its save deletes the old checkpoint before the new one
is written (checkpoint.py:26), so a failed save loses the last good one,
and its resumable loader swallows every exception (checkpoint.py:136).
Here the state is written to a temporary file beside the target and moved
over it with ``os.replace``, so the target is either the old checkpoint or
the new one; ``load_checkpoint`` and ``load_resumable`` raise on a corrupt
or truncated file (a recorded departure: JAX's ``load_resumable`` warns
and returns None).  There is no legacy pickle format to read: JAX-trained
states come across through ``convert.py``.

A state is nested dicts, lists and tuples of tensors and Python scalars;
tensors come back on the CPU and are moved by the caller.
"""
from __future__ import annotations

import os
import re
import uuid
from typing import Any, Dict, Optional, Tuple

import torch

from neuralsvd_tpu_torch.training.train_state import (
    TrainState,
    load_state_tree,
    state_tree,
)


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


def latest_iteration_checkpoint(log_dir: str,
                                prefix: str = "ckpt_") -> Optional[Tuple[int, str]]:
    """(step, path) of the ``<prefix><step>`` entry of ``log_dir`` with the
    largest step, or None (no such entry, or no directory).  A step is
    digits only, the rule of the JAX CLI's resume
    (``neuralsvd_tpu/cli/pde.py:215-216``): a name that Python's ``int``
    would also read (a sign, spaces, underscores) is not a checkpoint."""
    if not os.path.isdir(log_dir):
        return None
    pattern = re.compile(re.escape(prefix) + r"(\d+)")
    found = [(int(m.group(1)), name) for name in os.listdir(log_dir)
             if (m := pattern.fullmatch(name))]
    if not found:
        return None
    step, name = max(found)
    return step, os.path.join(log_dir, name)


def latest_checkpoint(log_dir: str, prefix: str = "ckpt_") -> Optional[str]:
    """The path alone of ``latest_iteration_checkpoint``, the JAX
    package's signature (``neuralsvd_tpu/training/checkpoint.py:142``)."""
    latest = latest_iteration_checkpoint(log_dir, prefix)
    return None if latest is None else latest[1]


def save_resumable(path: str, ts: TrainState, chunk: int) -> str:
    """Save a mid-run snapshot {TrainState, chunk index} at ``path``,
    replaced atomically (``save_checkpoint``)."""
    return save_checkpoint(path, {"ts": state_tree(ts), "chunk": int(chunk)})


def load_resumable(path: str, template: TrainState) -> Optional[Tuple[TrainState, int]]:
    """(TrainState, chunk) saved by :func:`save_resumable`, copied in place
    into ``template`` (a TrainState of the same run, e.g. from
    ``init_train_state``, on the device it should live on), which is
    returned; None when ``path`` does not exist.  A corrupt or truncated
    file raises."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    saved = load_checkpoint(path)
    load_state_tree(template, saved["ts"])
    return template, int(saved["chunk"])


def load_pretrained(path: str, template: Dict[str, torch.Tensor],
                    strip_prefixes: tuple = ("module.", "backbone."),
                    keys: tuple = ("params", "ema_params", "model")) -> Dict[str, torch.Tensor]:
    """Model parameters {name: tensor} for ``template`` (e.g.
    ``dict(model.named_parameters())``) from a checkpoint that may hold
    more: a TrainState (``ckpt_<it>`` of the PDE CLI), a state dict, or
    either nested under wrapper keys.  A level whose keys cover the
    template's is taken; else the first of ``keys`` found that holds one
    (JAX's order: ``params``, ``ema_params``, ``model``; pass
    ``keys=("ema_params",)`` for the EMA), else the level with each key's
    ``strip_prefixes`` removed (``module.`` of DataParallel).  Extra
    entries are ignored; a missing one raises KeyError, a shape that
    differs ValueError.  The tensors come back in the template's dtypes,
    on its devices."""
    restored = load_checkpoint(path)
    names = set(template)

    def unwrap(d):
        if not isinstance(d, dict):
            raise KeyError(path)
        if names <= set(d) and all(isinstance(d[k], torch.Tensor) for k in names):
            return d
        for key in keys:
            if key in d:
                try:
                    return unwrap(d[key])
                except KeyError:
                    pass
        stripped = {}
        for k, v in d.items():
            for p in strip_prefixes:
                if isinstance(k, str) and k.startswith(p):
                    k = k[len(p):]
                    break
            stripped[k] = v
        if set(stripped) != set(d):
            return unwrap(stripped)
        raise KeyError(f"checkpoint at {path} does not contain the parameters "
                       f"{sorted(names)}")

    found = unwrap(restored)
    out = {}
    for k, t in template.items():
        v = found[k]
        if v.shape != t.shape:
            raise ValueError(f"{k}: stored shape {tuple(v.shape)}, template {tuple(t.shape)}")
        out[k] = v.to(device=t.device, dtype=t.dtype)
    return out
