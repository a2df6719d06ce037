"""PDE solver entry point: python -m neuralsvd_tpu_torch.cli.pde [flags].

Port of ``neuralsvd_tpu/cli/pde.py:35-253``: the problem, the wavefunction
model, the sampler, the validation grid (or Monte-Carlo set), the method,
the optimizer (cosine schedule, spike rejection, per-mode tail LR) and the
host driver ``train_operator``; a checkpoint ``ckpt_<it>``, the JAX CLI's
spectrum and eigenfunction figures (PNG, drawn without matplotlib) and the
arrays they draw (``.npz``, utils/plotting.py) after every eval, ``--resume`` from the latest checkpoint, and
``stats.npz`` at the end.

The flags are the JAX CLI's (utils/config.py) plus ``--device`` (default:
the GPU); every ``--loss`` (neuralsvd, nestedlora, neuralef, spin and
spinx, whose NTK weights are refreshed after each eval, on every
Laplacian: finite differences, the forward engine, nested JVPs and
Hutchinson probes), every potential of ``--problem sch``, the
Fokker–Planck problem ``--problem fp``, the exponential mask, ``--rescue
true`` (the mode rescue at evals) and ``--matmul_precision
default|high|highest`` or a split spec ``'<head>@<k>,<tail>'`` (the towers'
products only, models/mlp.py) run.  As in the JAX CLI,
``--weight_normalization`` reaches no model.

``--mesh dp[=N]`` trains data-parallel over the default process group
(parallel/mesh.py): ``torchrun --standalone --nproc-per-node N -m
neuralsvd_tpu_torch.cli.pde --mesh dp ...`` on N cards, or ``--mesh dp``
alone for a one-rank NCCL group on one card.  Each rank samples
``batch_size // dp`` rows (``batch_size`` stays the global batch and must
divide by 2·dp), the method's grams are averaged over the ranks, and only
rank 0 writes the log directory's files.

``--mesh tp=M`` or ``--mesh dp=N,tp=M`` (N·M ranks under ``torchrun``)
shards the modes of the per-mode towers over tp (parallel/sharding.py) with
the JAX GSPMD path's semantics (``neuralsvd_tpu/cli/pde.py:47-66``): every
rank draws the global batch and keeps its dp share of each half, so the
run is the one-process run up to reduction order; the evals, the rescue
and the checkpoints (which do not depend on the mesh) see the gathered
state.  Every ``--loss`` runs under tp: SpIN's Jacobian average is sharded
with the modes (``methods/spin.py``) and gathered into each checkpoint, and
SpINx's NTK refresh takes the whole gradient's norms.
"""
from __future__ import annotations

import logging
import os
from types import SimpleNamespace

import numpy as np
import torch

from neuralsvd_tpu_torch.data.samplers import get_sampler, make_val_grid, make_val_mc
from neuralsvd_tpu_torch.device import resolve_device
from neuralsvd_tpu_torch.methods.factories import get_evd_method
from neuralsvd_tpu_torch.models.mlp import parse_dims
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.parallel.collectives import axis_size
from neuralsvd_tpu_torch.parallel.mesh import (
    barrier,
    dp_group,
    half_rows,
    is_writer,
    make_mesh,
    mesh_sizes,
    method_state_axes,
    rank_device,
    tp_group,
)
from neuralsvd_tpu_torch.parallel.sharding import mode_shards, shard_module
from neuralsvd_tpu_torch.training.checkpoint import (
    latest_iteration_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from neuralsvd_tpu_torch.training.optimizers import (
    assert_mode_axis_unambiguous,
    build_optimizer,
    chain,
    cosine_annealing,
    per_mode_lr,
)
from neuralsvd_tpu_torch.training.train_operator import train_operator
from neuralsvd_tpu_torch.training.train_state import (
    STATE_FIELDS,
    init_train_state,
    load_state_tree,
    state_tree,
)
from neuralsvd_tpu_torch.utils import tracing
from neuralsvd_tpu_torch.utils.config import PDEConfig, parse_pde_config, run_name
from neuralsvd_tpu_torch.utils.logging import CSVLogger
from neuralsvd_tpu_torch.utils.plotting import (
    plot_1d_eigfuncs,
    plot_2d_eigfuncs,
    plot_and_save_spectrum,
)

log = logging.getLogger("neuralsvd_tpu_torch.pde")


def check_ported(cfg: PDEConfig) -> None:
    """Raise ValueError for a ``--mesh`` that does not fit the ranks or
    whose dp does not divide the batch into even half-batches."""
    if cfg.mesh:
        dp = mesh_sizes(cfg.mesh).get("dp", 1)
        if cfg.batch_size % (2 * dp):
            raise ValueError(
                f"batch_size {cfg.batch_size} must divide by 2*dp={2 * dp} "
                "(even per-rank metric half-batches)")


@tracing.timed("setup.build")
def build(cfg: PDEConfig, dev=None, axis_name=None, tp_axis=None) -> SimpleNamespace:
    """The run's parts as the JAX CLI wires them: operator, ground_truth,
    n_particles, model, sample, importance_train, val_data, val_batches,
    importance_val, method, optimizer and rescue_init_fn (None without
    ``--rescue``), on ``dev`` (default: ``cfg.device``).  ``axis_name``: the
    data-parallel group, whose ranks sample ``batch_size // dp`` rows each.
    ``tp_axis``: the tensor-parallel group; the sampler then draws the
    global batch, ``shards`` (None for a shared trunk) says which modes this
    rank holds, ``local_model`` and ``method`` are this rank's share and
    ``eval_method`` the method on the whole ``model``.  Without one
    ``local_model`` is ``model`` and ``eval_method`` is ``method``."""
    dev = resolve_device(cfg.device if dev is None else dev)
    operator, ground_truth, n_particles = get_problem(
        problem=cfg.problem, potential_type=cfg.potential_type,
        ndim=cfg.ndim, neigs=cfg.neigs, lim=cfg.lim, charge=cfg.charge,
        hydrogen_mol_ion_R=cfg.hydrogen_mol_ion_R, mol_name=cfg.mol_name,
        laplacian_eps=cfg.laplacian_eps, laplacian_mode=cfg.laplacian_mode,
        laplacian_probes=cfg.laplacian_probes,
        operator_scale=cfg.operator_scale, operator_shift=cfg.operator_shift,
        scale_operator=cfg.scale_operator)

    model_kw = dict(
        ndim=cfg.ndim, neigs=cfg.neigs,
        mlp_hidden_dims=parse_dims(cfg.mlp_hidden_dims),
        nonlinearity=cfg.nonlinearity, n_particles=n_particles,
        parallel=cfg.parallel,
        use_fourier_feature=cfg.use_fourier_feature,
        fourier_mapping_size=cfg.fourier_mapping_size,
        fourier_scale=cfg.fourier_scale,
        fourier_deterministic=cfg.fourier_deterministic,
        fourier_append_raw=cfg.fourier_append_raw,
        fourier_append_radial=cfg.fourier_append_radial,
        fourier_append_envelopes=tuple(
            float(v) for v in cfg.fourier_append_envelopes.split(",") if v),
        fourier_seed=cfg.seed,
        apply_boundary=cfg.apply_boundary, boundary_mode=cfg.boundary_mode,
        lim=cfg.lim, apply_exp_mask=cfg.apply_exp_mask,
        exp_mask_init_scale=cfg.exp_mask_init_scale,
        hard_mul_const=cfg.hard_mul_const,
        matmul_precision=cfg.matmul_precision or None)
    model = make_wavefunctions(**model_kw, seed=cfg.seed, device=dev)

    scale = cfg.sampling_scale
    weights = None
    if cfg.sampling_mode == "gaussian_mixture":
        scale = tuple(float(v) for v in cfg.sampling_scales.split(",") if v)
        if cfg.sampling_weights:
            weights = tuple(float(v) for v in cfg.sampling_weights.split(",") if v)
    sample, importance_train = get_sampler(
        cfg.sampling_mode,
        cfg.batch_size // (1 if tp_axis is not None else axis_size(axis_name)), n_particles,
        cfg.ndim, scale, sampling_weights=weights, device=dev)

    val_batches = importance_val = val_data = None
    if cfg.ndim in (1, 2) and n_particles == 1:
        val_data, val_batches, importance_val = make_val_grid(
            cfg.ndim, cfg.lim, cfg.val_eps, cfg.batch_size)
    elif cfg.val_mc_size > 0:
        val_data, val_batches, importance_val = make_val_mc(
            cfg.sampling_mode, cfg.val_mc_size, n_particles, cfg.ndim, scale,
            cfg.batch_size, seed=cfg.seed + 777, sampling_weights=weights,
            device=dev)

    method_opts = {"neuralef": cfg.loss.neuralef, "spin": cfg.loss.spin,
                   "spinx": cfg.loss.spin}.get(cfg.loss.name, cfg.loss.neuralsvd)
    shards = mode_shards(model, tp_axis, cfg.neigs)
    local_model = model if shards is None else shard_module(model, shards)
    method = get_evd_method(cfg.loss.name, local_model, cfg.neigs, sort=cfg.sort,
                            axis_name=axis_name,
                            mode_axis=None if shards is None else shards.group,
                            **vars(method_opts))
    eval_method = method if shards is None else get_evd_method(
        cfg.loss.name, model, cfg.neigs, sort=cfg.sort, **vars(method_opts))

    lr_schedule = (cosine_annealing(cfg.lr, cfg.num_iters)
                   if cfg.use_lr_scheduler else None)
    optimizer = build_optimizer(
        cfg.optimizer, cfg.lr, momentum=cfg.momentum,
        rmsprop_decay=cfg.rmsprop_decay, adam_eps=cfg.adam_eps,
        lr_schedule=lr_schedule, spike_reject_factor=cfg.spike_reject_factor,
        shards=shards)
    if cfg.tail_lr_boost != 1.0:
        # per-mode LR on the slow truncation-edge towers, safe under
        # sequential nesting; the leading-axis == neigs heuristic needs
        # per-mode towers and no shared parameter
        if not cfg.parallel:
            raise ValueError("--tail_lr_boost requires --parallel true "
                             "(per-mode towers)")
        assert_mode_axis_unambiguous(dict(model.named_parameters()), cfg.neigs)
        scales = np.where(np.arange(cfg.neigs) >= cfg.tail_lr_start,
                          cfg.tail_lr_boost, 1.0).astype(np.float32)
        optimizer = chain(optimizer, per_mode_lr(scales, cfg.neigs, shards))
        log.info("tail LR boost %.2fx from mode %d", cfg.tail_lr_boost,
                 cfg.tail_lr_start)

    rescue_init_fn = None
    if cfg.rescue:
        # the rescue's surgery recognises per-mode tensors by their leading
        # axis; a shared parameter of that size would be taken for one
        assert_mode_axis_unambiguous(dict(model.named_parameters()), cfg.neigs)

        def rescue_init_fn(generator):
            """Fresh parameters of the same model, drawn from ``generator``."""
            fresh = make_wavefunctions(**model_kw, generator=generator, device="cpu")
            return {k: p.detach() for k, p in fresh.named_parameters()}

    return SimpleNamespace(
        operator=operator, ground_truth=ground_truth, n_particles=n_particles,
        model=model, sample=sample, importance_train=importance_train,
        val_data=val_data, val_batches=val_batches,
        importance_val=importance_val, method=method, optimizer=optimizer,
        rescue_init_fn=rescue_init_fn, shards=shards, local_model=local_model,
        eval_method=eval_method)


def main(cfg: PDEConfig, timings=None, use_graph: bool = True):
    """Train as the JAX CLI does; returns (TrainState, all_eigvals,
    all_norms), under tp the TrainState gathered from every rank's share.
    ``timings`` and ``use_graph``: see ``train_operator``."""
    logging.basicConfig(level=logging.INFO)
    check_ported(cfg)
    mesh = group = tp = everyone = None
    if cfg.mesh:
        mesh = make_mesh(cfg.mesh, device=cfg.device)
        group, tp = dp_group(mesh), tp_group(mesh)
        everyone = torch.distributed.group.WORLD
        dev = rank_device(cfg.device)
        log.info("mesh %s (dp %d, tp %d; sampler batch %d)", mesh, axis_size(group),
                 axis_size(tp), cfg.batch_size // (1 if tp is not None else axis_size(group)))
    else:
        dev = resolve_device(cfg.device)
    torch.set_float32_matmul_precision("highest")
    writer = is_writer()

    log_dir = os.path.join(cfg.log_dir, run_name(cfg))
    exists = os.path.exists(log_dir)
    barrier(everyone)  # every rank has looked before rank 0 makes it
    if exists and not (cfg.overwrite or cfg.resume):
        raise ValueError(f"{log_dir} exists and --overwrite not set")
    if writer:
        os.makedirs(log_dir, exist_ok=True)
    barrier(everyone)
    log.info("log dir: %s", log_dir)

    run = build(cfg, dev, axis_name=group, tp_axis=tp)
    method, optimizer = run.method, run.optimizer
    val_data = run.val_data

    logger = (CSVLogger(log_dir, ["iter", "train_loss", "time", "steps_per_sec"])
              if writer else None)

    def checkpoint_fn(ts, it, outputs):
        normalize = method.name in ("nestedlora", "neuralsvd")
        plot_and_save_spectrum(
            {"RQ": outputs["eigvals"],
             "Norms^2": outputs["norms"] if normalize else None},
            outputs["cov"], ground_truth_spectrum=run.ground_truth,
            log_dir=log_dir, tag=f"it{it}")
        if cfg.ndim == 1 and val_data is not None:
            plot_1d_eigfuncs(val_data, outputs["eigfuncs"], log_dir, tag=f"it{it}")
        if cfg.ndim == 2 and val_data is not None:
            plot_2d_eigfuncs(outputs["eigfuncs"], log_dir, tag=f"it{it}")
        save_checkpoint(os.path.join(log_dir, f"ckpt_{it}"), state_tree(ts))

    spinx_refresh = None
    if cfg.loss.name == "spinx":
        def spinx_refresh(ts, generator):
            """SpINx's NTK weights from one batch drawn from ``generator``
            (under tp this dp rank's share of the global batch, as a step
            takes it)."""
            x = run.sample(generator)
            x = x.reshape(x.shape[0], -1)
            if tp is not None:
                x = half_rows(x, group)
            method.refresh_weights(ts.params, ts.method_state, x, run.operator,
                                   run.importance_train)

    # --resume: restart from the latest ckpt_<it>; the generators are seeded
    # from the absolute iteration, so sampling continues exactly
    initial_ts, start_iter = None, 0
    if cfg.resume:
        latest = latest_iteration_checkpoint(log_dir)
        if latest is not None:
            start_iter, path = latest
            initial_ts = init_train_state(run.local_model, optimizer, method)
            tree = load_checkpoint(path)
            if run.shards is not None:  # a checkpoint holds every mode
                tree = run.shards.narrow_fields({name: tree[name] for name in STATE_FIELDS},
                                                method_state_axes(method))
            load_state_tree(initial_ts, tree)
            log.info("resuming from %s at iter %d", path, start_iter)

    try:
        ts, all_eigvals, all_norms = train_operator(
            method, run.operator, run.sample, optimizer, run.local_model,
            num_iters=cfg.num_iters,
            importance_train=run.importance_train,
            importance_val=run.importance_val, val_batches=run.val_batches,
            ema_decay=cfg.ema_decay, eval_freq=cfg.eval_freq,
            print_freq=cfg.print_freq, log_writer=logger,
            seed=cfg.seed, monitor=cfg.print_local_energies,
            post_align=cfg.post_align, checkpoint_fn=checkpoint_fn,
            spinx_refresh=spinx_refresh,
            profile_dir=(os.path.join(log_dir, "profile") if cfg.profile
                         else None),
            profile_start=cfg.profile_start, profile_steps=cfg.profile_steps,
            grad_clip=cfg.grad_clip,
            mesh=mesh if group is not None or tp is not None else None,
            shards=run.shards, eval_method=run.eval_method,
            rescue_init_fn=run.rescue_init_fn,
            rescue_until=cfg.rescue_until, initial_ts=initial_ts,
            start_iter=start_iter, use_graph=use_graph, timings=timings)
    finally:
        if logger is not None:
            logger.close()

    if writer:
        np.savez(os.path.join(log_dir, "stats.npz"),
                 all_eigvals=np.asarray(all_eigvals),
                 all_norms=np.asarray(all_norms))
    barrier(everyone)
    log.info("set-up seconds %s; counters %s", tracing.timed_seconds(), tracing.counts())
    log.info("done; stats saved to %s", log_dir)
    return ts, all_eigvals, all_norms


if __name__ == "__main__":
    main(parse_pde_config())
