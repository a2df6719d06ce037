"""The data- and tensor-parallel train steps on a ``torch.distributed`` mesh.

Port of ``neuralsvd_tpu/parallel/sharding.py``.  ``make_mesh_train_step``
and ``make_mesh_cdk_step`` are the train and CDK steps on any mesh.  The
``dp`` axis: ``make_shard_map_train_step`` (:171-219) and
``make_shard_map_cdk_step`` (:292-357).  Each rank
runs the whole step on its own rows, and the method's grams and the
gradients are reduced over the dp group inside it (``axis_name`` is the
group, parallel/collectives.py).  Parameters and optimizer state stay
replicated, since every rank applies the same summed gradient.  The mesh
itself, ``parse_mesh_spec`` and ``make_mesh``, is in parallel/mesh.py.

The ``tp`` axis, which the JAX package leaves to GSPMD, written out by
hand: ``mode_shards`` and ``shard_module`` are the counterparts of
``mode_sharded_params`` (:98) and ``cdk_mode_shardings`` (:222), a rank's
share of a model; ``ModeShards.narrow_tree``/``gather_tree``
(parallel/mesh.py) those of ``state_shardings`` (:113) and
``_shardings_like`` (:245), a rank's share of a state tree and the whole
tree back, matched by parameter name; the two mesh steps with a tp axis
those of ``make_sharded_train_step`` (:129) with ``shard_batch_sampler``
(:155) and of ``make_gspmd_cdk_step`` (:267).  A tp
rank holds the modes ``mesh.mode_range`` of every per-mode parameter
(ParallelMLP's stacks, the exponential mask's scales, a two-tower
network's last layers), computes those modes' f (and Tf) for its rows,
and gathers all L modes before the loss, whose backward hands each rank
its modes' slice; the replicated parameters used before the gather have
their gradients summed over tp.  A model with no per-mode parameter (a
shared trunk) is replicated whole on the tp ranks, as JAX replicates it:
no gather and no sum.
"""
from __future__ import annotations

import copy
import functools
from typing import Optional

import torch
from torch import nn

from neuralsvd_tpu_torch.models.mlp import ParallelMLP, _is_split
from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork
from neuralsvd_tpu_torch.parallel.collectives import all_gather_rows, gather_modes
from neuralsvd_tpu_torch.parallel.mesh import ModeShards, dp_group, mode_layout, tp_group
from neuralsvd_tpu_torch.training.cdk_step import make_cdk_train_step
from neuralsvd_tpu_torch.training.train_operator import ScannedTrainStep, make_train_step

__all__ = ["make_mesh_cdk_step", "make_mesh_train_step", "mode_shards",
           "shard_module"]


def make_mesh_train_step(method, operator, optimizer, sampler, mesh,
                         shards: Optional[ModeShards] = None, importance=None,
                         ema_decay: float = 0.99, grad_clip: float = 0.0,
                         monitor: bool = False,
                         steps_per_call: Optional[int] = None, seed: int = 0,
                         use_graph: bool = True):
    """The train step on ``mesh``: ``training.train_operator.make_train_step``
    with ``dp_axis`` its dp group and ``tp_axis`` its tp group.

    Without tp, each rank draws its own local batch of the sampler's size
    (global batch = ranks x sampler batch), the method (built with
    ``axis_name`` the dp group, else ValueError) averages its grams over
    the group, and the step sums the gradients and averages the method
    state over the group, each in one flat all-reduce, before the
    finite/clip/skip decision, so every rank takes the same update.

    With tp, ``sampler`` draws the global batch (JAX's GSPMD sampler) and
    each rank keeps its dp rank's share of each half (JAX pins the rows to
    dp, ``shard_batch_sampler``); the method, built on
    ``shard_module(model, shards)`` with ``mode_axis`` the tp group and
    ``axis_name`` the dp group, gathers the modes before the loss, and the
    state is this rank's share (``shards.narrow_tree``; ``shards`` None for
    a model with no per-mode parameter).

    ``steps_per_call=None`` -> ``(ts, generator[, probes]) -> (ts,
    metrics)``, each rank passing its own generators; ``steps_per_call=k``
    -> a ``ScannedTrainStep`` of k steps whose generators are seeded from
    (seed, block start) and, without tp, the rank; a CUDA graph with
    ``use_graph`` (NCCL only).
    """
    group, tp = dp_group(mesh), tp_group(mesh)
    step = make_train_step(method, operator, optimizer, sampler,
                           importance=importance, ema_decay=ema_decay,
                           grad_clip=grad_clip, monitor=monitor, dp_axis=group,
                           tp_axis=tp, shards=shards)
    if steps_per_call is None:
        return step
    return ScannedTrainStep(step, steps_per_call, seed=seed, use_graph=use_graph,
                            group=group, tp_group=tp)


def make_mesh_cdk_step(method, optimizer, mesh, grad_clip: float = 0.0,
                       shards: Optional[ModeShards] = None):
    """The CDK (paired-sample) step on ``mesh``, the signature of
    ``training.cdk_step.make_cdk_train_step``::

        step(params, opt_state, method_state, x, y, skip_count)
          -> (params, opt_state, method_state, loss, aux, skip_count)

    where ``x``, ``y`` are this dp rank's rows of the pair batch (pairing
    kept; all of it without dp).  The method must be built with
    ``axis_name`` the dp group (else ValueError): its marginal grams and
    operator term are averaged over the ranks, its backward divides by the
    global batch, and the step sums the gradients (one flat all-reduce) and
    clips the global gradient before the finite test.  ``loss`` and aux's
    ``loss_operator``/``loss_metric`` are the global batch's already
    (JAX's extra pmean of them changes nothing); with dp, aux's per-sample
    ``f`` and ``g`` are gathered in global batch order.  The (B, B)
    density-ratio gram is not computed here.

    With tp, the method is built on ``shard_module(model, shards)`` (its
    towers' last layers on this rank's mode columns, the modes gathered
    before the row norm) and the step also sums the hidden layers'
    gradients over tp.
    """
    group = dp_group(mesh)
    local = make_cdk_train_step(method, optimizer, grad_clip, dp_axis=group,
                                shards=shards)
    if group is None:
        return local

    def step(params, opt_state, method_state, x, y, skip_count):
        params, opt_state, method_state, loss, aux, skip_count = local(
            params, opt_state, method_state, x, y, skip_count)
        aux = dict(aux, f=all_gather_rows(aux["f"], group),
                   g=all_gather_rows(aux["g"], group))
        return params, opt_state, method_state, loss, aux, skip_count

    return step


def mode_shards(model: nn.Module, group, n_modes: int) -> Optional[ModeShards]:
    """The ``ModeShards`` of ``model`` on the tp ``group``: its per-mode
    parameters and the replicated ones that act before the gather
    (``mesh.mode_layout``).  None without a group, or for a model with no
    per-mode parameter, which the tp ranks then hold whole."""
    axes, pre = mode_layout(model)
    if group is None or not axes:
        return None
    return ModeShards(group, n_modes, axes, pre)


def shard_module(model: nn.Module, shards: ModeShards) -> nn.Module:
    """A copy of ``model`` built on this rank's modes: each per-mode
    parameter replaced by its slice (a new leaf), a ParallelMLP's split
    precision ('<head>@<k>,<tail>') moved to the rank's first mode, and a
    two-tower network set to gather its modes before its row norm.  The
    copy's outputs are this rank's modes (a wavefunction's) or all of them
    (a two-tower network's)."""
    local = copy.deepcopy(model)
    lo, hi = shards.range
    with torch.no_grad():
        for name, axis in shards.axes.items():
            owner, _, leaf = name.rpartition(".")
            module = local.get_submodule(owner)
            full = getattr(module, leaf)
            module.register_parameter(leaf, nn.Parameter(
                full.narrow(axis, lo, hi - lo).clone(), requires_grad=full.requires_grad))
    for module in local.modules():
        if isinstance(module, ParallelMLP) and _is_split(module.precision):
            _, head, k, tail = module.precision
            k -= lo
            module.precision = (head if k >= hi - lo else tail if k <= 0
                                else ("split", head, k, tail))
        if isinstance(module, HeteroNetwork):
            module.mode_gather = functools.partial(
                gather_modes, group=shards.group, n_modes=shards.n_modes)
    return local
