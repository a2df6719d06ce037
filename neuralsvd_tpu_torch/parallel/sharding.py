"""The data-parallel train steps on a ``torch.distributed`` mesh.

Port of the ``dp`` axis of ``neuralsvd_tpu/parallel/sharding.py``:
``make_shard_map_train_step`` (:171-219) as ``make_dp_train_step`` and
``make_shard_map_cdk_step`` (:292-357) as ``make_dp_cdk_step``.  Each rank
runs the whole step on its own rows, and the method's grams and the
gradients are reduced over the dp group inside it (``axis_name`` is the
group, parallel/collectives.py).  Parameters and optimizer state stay
replicated, since every rank applies the same summed gradient.  The mesh
itself, ``parse_mesh_spec`` and ``make_mesh``, is in parallel/mesh.py.

A ``tp`` axis above 1 (the GSPMD mode sharding of ParallelMLP and of the
CDK towers' last layer: ``mode_sharded_params``, ``state_shardings``,
``make_sharded_train_step``, ``shard_batch_sampler``,
``cdk_mode_shardings``, ``make_gspmd_cdk_step``) raises
``NotImplementedError`` naming ROADMAP item [9b].
"""
from __future__ import annotations

from typing import Optional

from neuralsvd_tpu_torch.parallel.collectives import all_gather_rows
from neuralsvd_tpu_torch.parallel.mesh import dp_group
from neuralsvd_tpu_torch.training.cdk_step import make_cdk_train_step
from neuralsvd_tpu_torch.training.train_operator import ScannedTrainStep, make_train_step

__all__ = ["make_dp_cdk_step", "make_dp_train_step"]


def _group(mesh, dp_axis):
    group = dp_group(mesh, dp_axis)
    if group is None:
        raise ValueError(f"the mesh {mesh} has no {dp_axis!r} axis")
    return group


def make_dp_train_step(method, operator, optimizer, sampler, mesh,
                       importance=None, ema_decay: float = 0.99,
                       dp_axis: str = "dp", grad_clip: float = 0.0,
                       monitor: bool = False,
                       steps_per_call: Optional[int] = None, seed: int = 0,
                       use_graph: bool = True):
    """The data-parallel train step on ``mesh``'s ``dp_axis`` group.

    ``training.train_operator.make_train_step(dp_axis=group)``: each rank
    draws its own local batch of the sampler's size (global batch = ranks x
    sampler batch), the method (built with ``axis_name=group``, else
    ValueError) averages its grams over the group, the step sums the
    gradients (the local rows' partial sums of the global gradient) and
    averages the method state over the group, each in one flat all-reduce,
    before the finite/clip/skip decision, so every rank takes the same
    update.

    ``steps_per_call=None`` -> ``(ts, generator[, probes]) -> (ts,
    metrics)``, each rank passing its own generators; ``steps_per_call=k``
    -> a ``ScannedTrainStep`` of k steps whose generators are seeded from
    (seed, block start, rank), a CUDA graph with ``use_graph`` (NCCL only).
    """
    group = _group(mesh, dp_axis)
    step = make_train_step(method, operator, optimizer, sampler,
                           importance=importance, ema_decay=ema_decay,
                           grad_clip=grad_clip, monitor=monitor, dp_axis=group)
    if steps_per_call is None:
        return step
    return ScannedTrainStep(step, steps_per_call, seed=seed, use_graph=use_graph,
                            group=group)


def make_dp_cdk_step(method, optimizer, mesh, grad_clip: float = 0.0,
                     dp_axis: str = "dp"):
    """Data parallelism for the CDK (paired-sample) step, the signature of
    ``training.cdk_step.make_cdk_train_step``::

        step(params, opt_state, method_state, x, y, skip_count)
          -> (params, opt_state, method_state, loss, aux, skip_count)

    where ``x``, ``y`` are this rank's rows of the pair batch (pairing
    kept).  The method must be built with ``axis_name`` the dp group (else
    ValueError): its marginal grams and operator term are averaged over the
    ranks, its backward divides by the global batch, and the step sums the
    gradients (one flat all-reduce) and clips the global gradient before
    the finite test.  ``loss`` and aux's ``loss_operator``/``loss_metric``
    are the global batch's already (JAX's extra pmean of them changes
    nothing); aux's per-sample ``f`` and ``g`` are gathered in global batch
    order.  The (B, B) density-ratio gram is not computed here.
    """
    group = _group(mesh, dp_axis)
    local = make_cdk_train_step(method, optimizer, grad_clip, dp_axis=group)

    def step(params, opt_state, method_state, x, y, skip_count):
        params, opt_state, method_state, loss, aux, skip_count = local(
            params, opt_state, method_state, x, y, skip_count)
        aux = dict(aux, f=all_gather_rows(aux["f"], group),
                   g=all_gather_rows(aux["g"], group))
        return params, opt_state, method_state, loss, aux, skip_count

    return step
