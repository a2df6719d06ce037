"""RMSprop with the update order of ``torch.optim.RMSprop``, written out.

Port of ``neuralsvd_tpu/training/optimizers.py:26-50`` (``torch_rmsprop``):
    v <- alpha*v + (1-alpha)*g²;  update = -lr · g / (sqrt(v) + eps)
(eps outside the sqrt), with optional momentum.  It is written out as a
functional ``init``/``update`` pair, like the optax transformation it
ports, so the train step can keep the old state where a step is skipped
without a host sync (training/train_operator.py); it computes what
``torch.optim.RMSprop(lr, alpha, eps, momentum)`` computes.  The other
optimizers and schedules are not ported yet (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch


class TorchRMSpropState(NamedTuple):
    nu: Dict[str, torch.Tensor]
    momentum: Dict[str, torch.Tensor]


class TorchRMSprop(NamedTuple):
    init: Callable
    update: Callable


def torch_rmsprop(learning_rate: float, alpha: float = 0.999,
                  eps: float = 1e-10, momentum: float = 0.0) -> TorchRMSprop:
    """A constant learning rate (the schedules are not ported yet)."""

    def init(params):
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        buf = ({k: torch.zeros_like(p) for k, p in params.items()}
               if momentum > 0 else {})
        return TorchRMSpropState(nu=zeros, momentum=buf)

    def update(grads, state: TorchRMSpropState):
        nu = {k: alpha * state.nu[k] + (1 - alpha) * g * g
              for k, g in grads.items()}
        scaled = {k: g / (torch.sqrt(nu[k]) + eps) for k, g in grads.items()}
        if momentum > 0:
            buf = {k: momentum * state.momentum[k] + s
                   for k, s in scaled.items()}
            out = buf
        else:
            buf = state.momentum
            out = scaled
        updates = {k: -learning_rate * u for k, u in out.items()}
        return updates, TorchRMSpropState(nu=nu, momentum=buf)

    return TorchRMSprop(init, update)
