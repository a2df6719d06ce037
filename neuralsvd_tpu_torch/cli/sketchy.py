"""Sketchy CDK training: python -m neuralsvd_tpu_torch.cli.sketchy [flags].

Port of ``neuralsvd_tpu/cli/sketchy.py``.  Two-tower training on
precomputed VGG features (the files of ``data/sketchy.py``, pairs drawn by
the native sampler) with the NestedLoRA CDK loss; per epoch the
retrieval eval (P@K / mAP) on test and valid, a CSV row, the best
parameters by valid P@K, a resumable checkpoint and the density ratios of
the last batch; at the end the spectrum/orthogonality check and the
truncated-dimension sweep with a random-permutation control.

The JAX CLI plots the spectrum and the density-ratio histograms with
matplotlib; this one writes the arrays it would plot to
``spectrum_<tag>.npz`` and ``ratios_<tag>.npz`` (plots: ROADMAP queue 1,
item 10).  ``--device`` (default: the GPU) is the port's own flag.  Every
flag of the paper script (scripts/exps/sketchy.sh) runs, ``--compute_dtype
bf16`` (the towers' chain in bfloat16, float32 master weights and CDK
loss) and every ``--optimizer`` included; ``main`` pins float32 matmuls
to IEEE (``torch.set_float32_matmul_precision("highest")``), as the JAX
CLI pins float32.  A departure: ``main`` raises on an empty valid split
before training, where the JAX CLI fails at the first epoch's valid eval.

``--mesh dp[=N]`` trains data-parallel (parallel/sharding.py,
``make_mesh_cdk_step``): every rank runs the same loader with the same seed
and keeps its contiguous 1/dp of each batch's pairs (a ragged tail past a
multiple of dp dropped, as in JAX), so a dp run sees the batches of a
single process; the grams are averaged over the ranks and the gradients
summed, and ``--grad_clip`` clips the global gradient.  Every rank runs the
retrieval evals on its replicated parameters, so all take the same best
P@K decision; only rank 0 writes the log, the checkpoints and the arrays.

``--mesh tp=M`` or ``--mesh dp=N,tp=M`` (the JAX CLI's GSPMD path,
``neuralsvd_tpu/cli/sketchy.py:188-235``; ``--neigs`` must divide by tp)
shards the towers' last layers by mode columns over tp
(parallel/sharding.py ``make_mesh_cdk_step``): a rank computes its modes of
f and g for its dp share of the pairs, the towers gather all modes before
the row norm, and the hidden layers' gradients are summed over tp.  The
evals, the checkpoints (which do not depend on the mesh) and the returned
parameters are the whole model's, gathered after each epoch.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from neuralsvd_tpu_torch.data.sketchy import SketchyVGGDataLoader
from neuralsvd_tpu_torch.device import resolve_device
from neuralsvd_tpu_torch.eval.retrieval import Retrieval
from neuralsvd_tpu_torch.methods.factories import get_cdk_method
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_svd
from neuralsvd_tpu_torch.models.mlp import parse_dims
from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork
from neuralsvd_tpu_torch.ops.nestedlora import cdk_inputs, density_ratios
from neuralsvd_tpu_torch.parallel.collectives import axis_size
from neuralsvd_tpu_torch.parallel.mesh import (
    barrier,
    dp_group,
    is_writer,
    local_rows,
    make_mesh,
    rank_device,
    tp_group,
)
from neuralsvd_tpu_torch.parallel.sharding import (
    make_mesh_cdk_step,
    mode_shards,
    shard_module,
)
from neuralsvd_tpu_torch.training.cdk_step import make_cdk_train_step
from neuralsvd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from neuralsvd_tpu_torch.training.optimizers import build_optimizer, warmup_cosine_schedule
from neuralsvd_tpu_torch.utils.logging import CSVLogger

log = logging.getLogger("neuralsvd_tpu_torch.sketchy")


def get_args(argv=None):
    """The JAX CLI's flags, parsed the same way, plus ``--device``."""
    p = argparse.ArgumentParser("Sketchy CDK retrieval")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_dir", type=str, default="./log/sketchy")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--root_dir", type=str, default="~")
    p.add_argument("--sketchy_split", type=str, default="1")
    p.add_argument("--metric", type=str, default="inner_product",
                   choices=["euclidean", "inner_product"])
    p.add_argument("--n_retrievals", type=int, default=100)
    p.add_argument("--n_retrievals_to_save", type=int, default=0)
    p.add_argument("--ap_ver", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--trunc_dims", nargs="*", type=int, default=[])
    p.add_argument("--randperm", action="store_true")
    p.add_argument("--return_map_all", action="store_true")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--resume", action="store_true")
    # optimizer
    p.add_argument("--optimizer", default="sgd",
                   choices=["adam", "adamw", "sgd", "lars"])
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--base_lr", type=float, default=5e-3)
    p.add_argument("--final_lr", type=float, default=0.0)
    p.add_argument("--warmup_lr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--use_lr_scheduler", action="store_true")
    p.add_argument("--grad_clip", type=float, default=0.0)
    # model
    p.add_argument("--network_dims", type=str, default="8192,512")
    p.add_argument("--activation", type=str, default="lrelu0.2")
    p.add_argument("--mu", type=float, default=16.0)
    p.add_argument("--regularize_mode", type=str, default="l2_ball",
                   choices=["l2_ball", "l2_sphere", "clip", "tanh"])
    p.add_argument("--compute_dtype", type=str, default="f32",
                   choices=["f32", "bf16"])
    # loss
    p.add_argument("--neigs", type=int, default=512)
    p.add_argument("--loss", dest="loss_name", default="neuralsvd")
    p.add_argument("--neuralsvd.step", dest="nsvd_step", type=int, default=1)
    p.add_argument("--neuralsvd.sequential", dest="nsvd_sequential",
                   action="store_true")
    p.add_argument("--neuralsvd.set_first_mode_const", dest="nsvd_const",
                   type=lambda v: str(v).lower() in ("1", "true"),
                   default=True)
    p.add_argument("--use_pallas", type=str, default="auto",
                   choices=["auto", "true", "false"])
    p.add_argument("--mesh", type=str, default="")
    # the port's own: where tensors live (default: the GPU)
    p.add_argument("--device", type=str, default=None)
    return p.parse_args(argv)


def make_density_ratio_fn(model, set_first_mode_const: bool):
    """Once-an-epoch diagnostic: (params, x, y) -> (rs_joint, rs_indep),
    the diagonal and off-diagonal of the (B, B) f(x)ᵀg(y) gram."""

    def rs(params, x, y):
        with torch.no_grad():
            fx, gy = functional_call(model, params, (x, y))
            return density_ratios(*cdk_inputs(fx, gy, set_first_mode_const))

    return rs


class Trainer(NamedTuple):
    model: HeteroNetwork  # the whole model (evals, checkpoints)
    params: dict  # the trained parameters: this rank's share under tp
    method: object
    opt_state: object
    step: object
    device: torch.device
    group: object  # the data-parallel process group, None without --mesh
    shards: object = None  # the ModeShards of a tp mesh, else None


def make_trainer(args, input_dim: int, steps_per_epoch: int) -> Trainer:
    """The two-tower model (initialised from ``args.seed``), the CDK method,
    the optimizer with its schedule, and the train step; with ``--mesh``
    the data-parallel step on its dp group, or with a tp axis the step on
    this rank's share of the modes (``Trainer.params``, the method's model:
    ``shard_module``)."""
    mesh = group = tp = None
    if args.mesh:
        mesh = make_mesh(args.mesh, device=args.device)
        group, tp = dp_group(mesh), tp_group(mesh)
        dev = rank_device(args.device)
        if args.batch_size % axis_size(group):
            raise ValueError(f"batch_size {args.batch_size} must divide by "
                             f"dp={axis_size(group)} for dp sharding")
        if args.neigs % axis_size(tp):
            raise ValueError(f"neigs {args.neigs} must divide by "
                             f"tp={axis_size(tp)} (mode-axis sharding)")
        log.info("mesh %s", mesh)
    else:
        dev = resolve_device(args.device)
    model = HeteroNetwork(
        input_dim=input_dim, network_dims=parse_dims(args.network_dims),
        nonlinearity=args.activation, mu=args.mu,
        regularize_mode=args.regularize_mode,
        generator=torch.Generator().manual_seed(args.seed),
        compute_dtype=args.compute_dtype).to(dev)
    shards = mode_shards(model, tp, parse_dims(args.network_dims)[-1])
    local = model if shards is None else shard_module(model, shards)
    params = dict(local.named_parameters())
    method = get_cdk_method(args.loss_name, local, args.neigs,
                            step=args.nsvd_step,
                            sequential=args.nsvd_sequential,
                            set_first_mode_const=args.nsvd_const,
                            axis_name=group, use_pallas=args.use_pallas)
    lr_schedule = None
    if args.use_lr_scheduler:
        lr_schedule = warmup_cosine_schedule(
            args.base_lr, args.warmup_lr, args.final_lr,
            args.warmup_epochs * steps_per_epoch,
            args.num_epochs * steps_per_epoch)
    optimizer = build_optimizer(args.optimizer, args.base_lr,
                                momentum=args.momentum,
                                weight_decay=args.weight_decay,
                                lr_schedule=lr_schedule, shards=shards)
    step = (make_cdk_train_step(method, optimizer, args.grad_clip) if mesh is None
            else make_mesh_cdk_step(method, optimizer, mesh, args.grad_clip, shards))
    return Trainer(model, params, method, optimizer.init(params), step, dev, group, shards)


def _to(tree, device):
    """Every tensor of a nest of dicts/tuples moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _detached(params):
    return {k: p.detach().clone() for k, p in params.items()}


def _synced_clock(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@contextlib.contextmanager
def _span(timings, name, dev):
    """Append the block's wall seconds, its device work included, to
    ``timings[name]``."""
    t0 = _synced_clock(dev)
    yield
    timings.setdefault(name, []).append(_synced_clock(dev) - t0)


def main(args, timings=None):
    """Train on the feature files under ``--root_dir`` (pairs drawn by the
    native sampler); returns what ``run_training`` returns (``timings``:
    see there).  Raises ``ValueError`` before training where the valid
    split is empty (files of split "1" or "2", made without "_<seed>")."""
    logging.basicConfig(level=logging.INFO)
    torch.set_float32_matmul_precision("highest")
    os.makedirs(args.log_dir, exist_ok=True)
    loaders = [SketchyVGGDataLoader(args.batch_size, root_path=args.root_dir,
                                    split=args.sketchy_split,
                                    train_or_test=phase,
                                    seed=args.seed if phase == "train" else 0)
               for phase in ("train", "test", "valid")]
    if loaders[2].sketch_features.shape[0] == 0:
        # the JAX CLI fails later, at the first epoch's valid eval
        # (np.concatenate of no embedding batch)
        raise ValueError(
            f"the valid split of --sketchy_split {args.sketchy_split} under "
            f"{args.root_dir} is empty: the best parameters are chosen by valid "
            "P@K, so extract the features with a split of the form 1_<seed> "
            "(or 2_<seed>), which carves a valid split out of the training "
            "classes")
    return run_training(args, *loaders,
                        input_dim=loaders[0].sketch_features.shape[1], timings=timings)


def run_training(args, train_loader, test_loader, valid_loader, input_dim,
                 timings=None):
    """Shared training loop (also used by the tests with synthetic loaders).
    Returns (params, trunc_results); ``params`` hold the best parameters
    by valid P@K, of the whole model under tp.

    The wall seconds of each part of the run are logged at the end and,
    given a dict ``timings``, appended to ``timings[part]``: once an epoch
    for ``steps`` (loader, host to device copies and train steps), ``eval``
    (test and valid retrieval), ``checkpoint`` and ``ratios``, and once for
    ``spectrum`` and ``trunc_sweep``.  Each span ends in a device sync.
    """
    timings = {} if timings is None else timings
    tr = make_trainer(args, input_dim, train_loader.max_steps)
    model, params, method, step_fn, dev, group, shards = (
        tr.model, tr.params, tr.method, tr.step, tr.device, tr.group, tr.shards)
    writer = is_writer()
    everyone = torch.distributed.group.WORLD if args.mesh else None
    opt_state = tr.opt_state
    # the whole model's parameters, which the evals read: ``params`` itself
    # without tp, else gathered from every rank's share after each epoch
    full = params if shards is None else dict(model.named_parameters())

    def gather_full():
        if shards is not None:
            with torch.no_grad():
                for k, v in shards.gather_tree(params).items():
                    full[k].copy_(v)

    gather_full()
    method_state = method.init_state(params)
    rs_fn = make_density_ratio_fn(model, args.nsvd_const)

    retrieval_test = Retrieval(test_loader, n_retrievals=args.n_retrievals,
                               metric=args.metric,
                               batch_size=args.batch_size, device=dev)
    retrieval_valid = Retrieval(valid_loader, n_retrievals=args.n_retrievals,
                                metric=args.metric,
                                batch_size=args.batch_size, device=dev)
    logger = CSVLogger(args.log_dir,
                       ["epoch", "loss", "test_P@K", "test_mAP@all",
                        "valid_P@K", "valid_mAP@all", "skips"]) if writer else None

    skip_count = torch.zeros((), dtype=torch.int32, device=dev)
    best_valid_pk = -1.0
    best_params = _detached(full)
    start_epoch = 0

    ckpt_path = os.path.join(args.log_dir, "ckpt")
    best_path = os.path.join(args.log_dir, "best")
    if args.resume and os.path.exists(ckpt_path):
        restored = load_checkpoint(ckpt_path)
        with torch.no_grad():
            for k, p in full.items():
                p.copy_(restored["params"][k])
            if shards is not None:  # a checkpoint holds every mode
                for k, p in params.items():
                    p.copy_(shards.narrow(k, restored["params"][k]))
        opt_state = _to(restored["opt_state"] if shards is None
                        else shards.narrow_tree(restored["opt_state"]), dev)
        start_epoch = int(restored["epoch"])
        best_valid_pk = float(restored["best_valid_pk"])
        # the JAX CLI keeps its fresh initial parameters as the "best"
        # ones here; the best checkpoint is what they stand for
        best_params = (_to(load_checkpoint(best_path), dev)
                       if os.path.exists(best_path) else _detached(full))
        log.info("resumed from epoch %d", start_epoch)

    model_x = lambda v: model.apply_single(v, "x")  # noqa: E731
    model_y = lambda v: model.apply_single(v, "y")  # noqa: E731
    for epoch in range(start_epoch, args.num_epochs):
        if args.eval_only:
            break
        losses = []
        last_batch = None
        with _span(timings, "steps", dev):
            for x, y, _ in train_loader:
                if x.shape[0] < axis_size(group):
                    continue  # no row for every rank
                params, opt_state, method_state, loss, _, skip_count = step_fn(
                    params, opt_state, method_state,
                    torch.as_tensor(local_rows(x, group), device=dev),
                    torch.as_tensor(local_rows(y, group), device=dev), skip_count)
                losses.append(loss)
                last_batch = (x, y)
            gather_full()

        with _span(timings, "eval", dev):
            test_pk, test_ap = retrieval_test.evaluate(
                model_x, model_y, ap_ver=args.ap_ver,
                return_map_all=args.return_map_all, tag=f"test_e{epoch}")
            valid_pk, valid_ap = retrieval_valid.evaluate(
                model_x, model_y, ap_ver=args.ap_ver,
                return_map_all=args.return_map_all, tag=f"valid_e{epoch}")
        mean_loss = (torch.stack(losses).double().mean().item() if losses
                     else float("nan"))
        row = {"epoch": epoch, "loss": mean_loss,
               "test_P@K": float(test_pk.mean()),
               "test_mAP@all": float(test_ap.mean()),
               "valid_P@K": float(valid_pk.mean()),
               "valid_mAP@all": float(valid_ap.mean()),
               "skips": int(skip_count)}
        log.info("%s", row)
        if writer:
            logger.writerow(row)

        with _span(timings, "checkpoint", dev):
            if row["valid_P@K"] > best_valid_pk:
                best_valid_pk = row["valid_P@K"]
                best_params = _detached(full)
                if writer:
                    save_checkpoint(best_path, _to(best_params, "cpu"))
            whole_opt = opt_state if shards is None else shards.gather_tree(opt_state)
            if writer:
                save_checkpoint(ckpt_path, {
                    "params": _to(_detached(full), "cpu"),
                    "opt_state": _to(whole_opt, "cpu"),
                    "epoch": epoch + 1,
                    "best_valid_pk": best_valid_pk,
                })
            barrier(everyone)
        if last_batch is not None and writer:
            with _span(timings, "ratios", dev):
                rs_joint, rs_indep = rs_fn(full, *(torch.as_tensor(a, device=dev)
                                                     for a in last_batch))
                np.savez(os.path.join(args.log_dir, f"ratios_e{epoch}.npz"),
                         rs_joint=rs_joint.cpu().numpy(),
                         rs_indep=rs_indep.cpu().numpy())
    if logger is not None:
        logger.close()

    # final: spectrum/orthogonality + truncation sweep on the best params
    with torch.no_grad():
        for k, p in full.items():
            p.copy_(best_params[k])
    with _span(timings, "spectrum", dev):
        spectrum, orth_x, orth_y = compute_spectrum_svd(
            model, iter(test_loader), sort=False,
            set_first_mode_const=args.nsvd_const, device=dev)
        if writer:
            np.savez(os.path.join(args.log_dir, "spectrum_final.npz"),
                     singvals=spectrum, orth_x=orth_x, orth_y=orth_y)

    if args.n_retrievals_to_save > 0 and writer:
        retrieval_test.evaluate(model_x, model_y, ap_ver=args.ap_ver)
        retrieval_test.save_retrievals(args.log_dir,
                                       n_queries=args.n_retrievals_to_save,
                                       tag="_best")

    trunc_results = {}
    perm = None
    if args.randperm:
        perm = np.random.default_rng(args.seed).permutation(args.neigs)
    with _span(timings, "trunc_sweep", dev):
        for dim in args.trunc_dims:
            pk, ap = retrieval_test.evaluate(
                model_x, model_y, ap_ver=args.ap_ver,
                return_map_all=args.return_map_all, trunc_dim=dim, perm=perm,
                tag=f"trunc{dim}")
            trunc_results[dim] = {"P@K": float(pk.mean()),
                                  "mAP@all": float(ap.mean())}
            log.info("trunc %d: %s", dim, trunc_results[dim])

    if writer:
        np.savez(os.path.join(args.log_dir, "best_stats.npz"),
                 spectrum=spectrum, orth_x=orth_x, orth_y=orth_y,
                 trunc_results=json.dumps(trunc_results))
    barrier(everyone)
    log.info("seconds by part: %s", timings)
    return full, trunc_results


if __name__ == "__main__":
    main(get_args())
