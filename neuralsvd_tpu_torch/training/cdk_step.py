"""The CDK (paired-sample) train step.

Port of ``make_cdk_train_step`` (``neuralsvd_tpu/cli/sketchy.py:98``),
which the Sketchy CLI and the CDK step on a mesh
(``parallel.sharding.make_mesh_cdk_step``) both build on.
"""
from __future__ import annotations

import torch

from neuralsvd_tpu_torch.parallel.collectives import psum, psum_flat
from neuralsvd_tpu_torch.parallel.mesh import check_method_axis
from neuralsvd_tpu_torch.training.optimizers import grad_norm, select_state
from neuralsvd_tpu_torch.utils.tracing import span, spanned

__all__ = ["make_cdk_train_step"]


def make_cdk_train_step(method, optimizer, grad_clip: float = 0.0,
                        dp_axis=None, shards=None):
    """CDK step (params, opt_state, method_state, x, y, skip_count) ->
    (params, opt_state, method_state, loss, aux, skip_count).

    The gradient is clipped to ``grad_clip`` by global norm, scale
    min(1, c/(‖g‖+1e-6)).  If any clipped gradient entry is not finite the
    update is dropped: parameters and every optimizer-state tensor
    (schedule counts included) keep their old values, selected on the
    device, and the device counter ``skip_count`` goes up by one.  The
    loss's finiteness is not tested, as in the JAX step.  Parameters are
    updated in place; nothing waits for the host.  The (B, B)
    density-ratio gram is not computed here: see
    ``cli.sketchy.make_density_ratio_fn``.  ``dp_axis``: a data-parallel
    group, or None; the method must be built with the same ``axis_name``
    (else ValueError).  With a group the gradients are summed over it in
    one flat all-reduce before the clip (``parallel.sharding.
    make_mesh_cdk_step`` is the step on a mesh).  Under a profiler the step
    records the spans ``train.step``, ``train.loss_and_grad``,
    ``train.clip`` and ``train.optimizer`` (``utils/tracing.py``).

    ``shards``: the ``ModeShards`` of a tp mesh, the towers' last layers
    held by mode columns (``parallel.sharding.make_mesh_cdk_step``).  The
    hidden layers' gradients, this rank's modes' part of each, are summed
    over tp before the dp sum; the clip reads the whole gradient's norm,
    and the finite test counts the non-finite slices over tp, so every
    rank takes the same decision.
    """
    check_method_axis(method, dp_axis)
    pre_gather = [] if shards is None else sorted(shards.pre_gather)

    @spanned("train.step")
    def step(params, opt_state, method_state, x, y, skip_count):
        with span("train.loss_and_grad"):
            loss, grads, aux, method_state = method.loss_and_grad(
                params, method_state, x, y)
        if pre_gather:
            grads.update(zip(pre_gather, psum_flat([grads[k] for k in pre_gather],
                                                   shards.group)))
        if dp_axis is not None:
            grads = dict(zip(grads, psum_flat(grads.values(), dp_axis)))
        with torch.no_grad():
            with span("train.clip"):
                if grad_clip > 0:
                    scale = torch.clamp(
                        grad_clip / (grad_norm(grads, shards) + 1e-6), max=1.0)
                    grads = {k: g * scale for k, g in grads.items()}
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads.values()]).all()
                if shards is not None:
                    bad = psum(torch.logical_not(finite).to(torch.float32), shards.group)
                    finite = bad == 0
            with span("train.optimizer"):
                updates, new_opt_state = optimizer.update(grads, opt_state, params)
                for k, p in params.items():
                    p.copy_(torch.where(finite, p + updates[k], p))
                opt_state = select_state(finite, new_opt_state, opt_state)
                skip_count = skip_count + torch.logical_not(finite).to(skip_count.dtype)
        return params, opt_state, method_state, loss, aux, skip_count

    return step
