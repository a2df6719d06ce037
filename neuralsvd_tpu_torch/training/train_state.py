"""Training state: params, optimizer state, parameter EMA, method state.

Port of ``neuralsvd_tpu/training/train_state.py``.  ``params`` are the
model's own ``nn.Parameter``s by name; the train step updates them in
place (the JAX state is rebuilt each step instead).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    ema_params: Dict[str, torch.Tensor]
    method_state: Any


def ema_decay_at(decay: float, step=None) -> float:
    """torch_ema's num_updates ramp: min(decay, (1+t)/(10+t))."""
    if step is None:
        return decay
    t = float(step)
    return min(decay, (1.0 + t) / (10.0 + t))


def ema_update(ema_params, params, decay: float, step=None):
    """EMA with torch_ema semantics: ema <- d*ema + (1-d)*param, with the
    num_updates ramp d = min(decay, (1+t)/(10+t)) when ``step`` is given."""
    d = ema_decay_at(decay, step)
    return {k: d * e + (1 - d) * params[k].detach()
            for k, e in ema_params.items()}


def init_train_state(model: torch.nn.Module, optimizer, method) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        ema_params={k: p.detach().clone() for k, p in params.items()},
        method_state=method.init_state(params),
    )
