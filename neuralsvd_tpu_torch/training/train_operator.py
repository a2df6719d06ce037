"""Operator-EVD training step.

Port of ``neuralsvd_tpu/training/train_operator.py:39-124``
(``make_train_step``).  One step: draw a batch, apply the operator, take
the NestedLoRA loss and its custom backward, clip, update with the
optimizer, and update the parameter EMA.

A non-finite loss or gradient norm skips the whole update: parameters and
optimizer state keep their old values, selected on the device with
``torch.where``, so the step never waits for the host.  ``metrics`` stay on
the device; reading one (``float(metrics["loss"])``) synchronises.
Stochastic operators (``needs_key``: the Hutchinson Laplacian) get a
probe generator of their own, seeded from the step generator's seed and
the step number, so the sample stream is the one the exact operator sees
(JAX folds 0x0BE5 into the step key for the same end).

The multi-step ``lax.scan`` path becomes the caller's Python loop.  Not
ported yet (ROADMAP queue 1, item 8): monitor statistics, the host loop
``train_operator`` (eval cadence, rescue, profiling) and data parallelism.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from neuralsvd_tpu_torch.training.optimizers import select_state
from neuralsvd_tpu_torch.training.train_state import TrainState, ema_update


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


PROBE_STREAM = 0x0BE5


def probe_seed(seed: int, step: int) -> int:
    """The probe generator's seed at ``step`` of a run seeded ``seed``."""
    return hash((seed, PROBE_STREAM, step)) & (2 ** 63 - 1)


def make_train_step(method, operator, optimizer, sampler: Callable,
                    importance: Optional[Callable] = None,
                    ema_decay: float = 0.99, grad_clip: float = 0.0):
    """Build the train step: (TrainState, generator) -> (TrainState, metrics).

    ``sampler(generator)`` returns the batch; ``grad_clip`` > 0 clips the
    global gradient norm.  The state's params are updated in place; the
    same TrainState object is returned with its other fields replaced.
    """
    stochastic_op = getattr(operator, "needs_key", False)
    probe_gens: Dict[torch.device, torch.Generator] = {}

    def step(ts: TrainState, generator) -> tuple:
        x = sampler(generator)
        x = x.reshape(x.shape[0], -1)
        op = operator
        if stochastic_op:
            if x.device not in probe_gens:
                probe_gens[x.device] = torch.Generator(device=x.device)
            probes = probe_gens[x.device].manual_seed(
                probe_seed(generator.initial_seed(), ts.step))
            op = lambda f, xv, importance=None: operator(  # noqa: E731
                f, xv, importance, generator=probes)
        loss, grads, _, method_state = method.loss_and_grad(
            ts.params, ts.method_state, x, op, importance)
        gnorm = global_norm(grads.values())
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        with torch.no_grad():
            if grad_clip > 0:
                scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
                grads = {k: g * scale for k, g in grads.items()}
            grads = {k: torch.where(finite, g, torch.zeros_like(g))
                     for k, g in grads.items()}
            updates, opt_state = optimizer.update(grads, ts.opt_state)
            for k, p in ts.params.items():
                p.copy_(torch.where(finite, p + updates[k], p))
            opt_state = select_state(finite, opt_state, ts.opt_state)
            ts.ema_params = ema_update(ts.ema_params, ts.params, ema_decay,
                                       step=ts.step)
        ts.opt_state = opt_state
        ts.method_state = method_state
        ts.step += 1
        metrics = {"loss": loss, "gnorm": gnorm,
                   "skipped": torch.logical_not(finite)}
        return ts, metrics

    return step

