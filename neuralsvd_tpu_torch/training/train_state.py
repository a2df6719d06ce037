"""Training state: step, params, optimizer state, parameter EMA, method state.

Port of ``neuralsvd_tpu/training/train_state.py``.  The JAX state is a
pytree rebuilt by every step; here every tensor of the state is a fixed
buffer that the train step overwrites in place (``assign_state``), and the
step counter is a device tensor, so a step captured in a CUDA graph reads
and writes the live state on every replay.  ``params`` are the model's own
``nn.Parameter``s by name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


@dataclass
class TrainState:
    step: torch.Tensor  # () int64 on the params' device
    params: Dict[str, torch.Tensor]
    opt_state: Any
    ema_params: Dict[str, torch.Tensor]
    method_state: Any


def ema_decay_at(decay: float, step=None):
    """torch_ema's num_updates ramp: min(decay, (1+t)/(10+t)); a float32
    device tensor for a tensor ``step`` (no host read), else a float."""
    if step is None:
        return decay
    if isinstance(step, torch.Tensor):
        t = step.to(torch.float32)
        return torch.clamp((1.0 + t) / (10.0 + t), max=decay)
    t = float(step)
    return min(decay, (1.0 + t) / (10.0 + t))


def ema_update(ema_params, params, decay: float, step=None):
    """EMA with torch_ema semantics: ema <- d*ema + (1-d)*param, with the
    num_updates ramp d = min(decay, (1+t)/(10+t)) when ``step`` is given."""
    d = ema_decay_at(decay, step)
    return {k: d * e + (1 - d) * params[k].detach()
            for k, e in ema_params.items()}


def assign_state(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst`` (dicts, lists, tuples and NamedTuples of tensors); other leaves
    must be equal.  Raises where the structures differ."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"state keys differ: {sorted(dst)} vs {sorted(src)}")
        for k, v in dst.items():
            assign_state(v, src[k])
    elif isinstance(dst, (tuple, list)):
        if len(dst) != len(src):
            raise ValueError(f"state lengths differ: {len(dst)} vs {len(src)}")
        for a, b in zip(dst, src):
            assign_state(a, b)
    elif dst != src:
        raise ValueError(f"state leaves differ: {dst!r} vs {src!r}")


STATE_FIELDS = ("step", "params", "opt_state", "ema_params", "method_state")


def clone_tree(tree, device=None):
    """A copy of a nest of dicts, lists and tuples (NamedTuples included)
    of tensors as dicts and lists of detached tensors on ``device``
    (default: where each is)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [clone_tree(v, device) for v in tree]
    return tree


def state_pointers(ts: TrainState) -> tuple:
    """The device address of every tensor of the state, in a fixed order:
    equal before and after a step that updates the state in place."""
    ptrs = []

    def walk(tree):
        if isinstance(tree, torch.Tensor):
            ptrs.append(tree.data_ptr())
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                walk(v)

    for name in STATE_FIELDS:
        walk(getattr(ts, name))
    return tuple(ptrs)


def state_tree(ts: TrainState) -> dict:
    """The state as nested dicts and lists of CPU tensors (what
    ``torch.load(weights_only=True)`` restores); ``load_state_tree``
    copies it back into a TrainState made by ``init_train_state``."""
    return {name: clone_tree(getattr(ts, name), "cpu") for name in STATE_FIELDS}


def load_state_tree(ts: TrainState, tree: dict) -> None:
    """Copy a ``state_tree`` into ``ts`` in place."""
    with torch.no_grad():
        for name in STATE_FIELDS:
            assign_state(getattr(ts, name), tree[name])


def init_train_state(model: torch.nn.Module, optimizer, method) -> TrainState:
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        params=params,
        opt_state=optimizer.init(params),
        ema_params={k: p.detach().clone() for k, p in params.items()},
        method_state=method.init_state(params),
    )
