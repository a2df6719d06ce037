"""Ranks of the data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_cli_mesh.py).

``run_ranks(fn, tmp_path, ...)`` spawns one process per rank
(``neuralsvd_tpu_torch.parallel.launch``): each joins a gloo group that
meets through a ``FileStore`` under ``tmp_path`` (never a TCP port: several
test workers run at once) and calls ``fn(rank, d, *args)`` with ``d`` a
directory of its own.  Every spawn is joined with a timeout of its own; on
timeout the ranks are killed and the test fails.  The
functions here import only torch, numpy and the port: the JAX references
are made in the test process and handed over as .npz files, and the ranks
hand their results back the same way.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from neuralsvd_tpu_torch.parallel import launch

SPAWN_TIMEOUT_S = 120
L = 4


def run_ranks(fn, tmp_path, *args, world: int = 2, timeout: float = SPAWN_TIMEOUT_S):
    """Run ``fn(rank, d, *args)`` on ``world`` gloo ranks; returns ``d``
    (``neuralsvd_tpu_torch.parallel.launch.run_ranks``)."""
    return launch.run_ranks(fn, tmp_path, *args, world=world, timeout=timeout)


def _save(path, tree):
    np.savez(path, **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v)) for k, v in tree.items()})


def _mesh():
    from neuralsvd_tpu_torch.parallel.mesh import dp_group, make_mesh

    mesh = make_mesh("dp=2", device="cpu")
    return mesh, dp_group(mesh)


def _rows(a, rank, world=2):
    k = a.shape[0] // world
    return a[rank * k:(rank + 1) * k]


# -- the losses -------------------------------------------------------------------

def losses_rank(rank, d, inputs):
    """The EVD, SVD and CDK losses on this rank's rows of every input, with
    the group; the loss and the input gradients (local rows)."""
    from neuralsvd_tpu_torch.ops.nestedlora import (
        nestedlora_cdk_loss,
        nestedlora_evd_loss,
        nestedlora_svd_loss,
    )

    _, group = _mesh()
    z = np.load(inputs)
    t = {k: torch.tensor(_rows(z[k], rank) if k not in ("vm", "mm", "vm1", "mm1") else z[k],
                         requires_grad=k in ("f", "f1", "f2", "g"))
         for k in z.files}
    out = {}
    loss = nestedlora_evd_loss(t["f"], t["Tf"], t["f1"], t["f2"], t["vm"], t["mm"], group)
    out["evd_loss"] = loss
    for k, g in zip(("f", "f1", "f2"), torch.autograd.grad(loss, [t["f"], t["f1"], t["f2"]])):
        out[f"evd_d{k}"] = g
    loss = nestedlora_svd_loss(t["f"], t["Tf"], t["g"], t["Tg"], t["vm"], t["mm"], group)
    out["svd_loss"] = loss
    for k, g in zip(("f", "g"), torch.autograd.grad(loss, [t["f"], t["g"]])):
        out[f"svd_d{k}"] = g
    loss, loss_op, loss_met, _, _ = nestedlora_cdk_loss(
        True, t["f"], t["g"], t["vm1"], t["mm1"], axis_name=group)
    out.update(cdk_loss=loss, cdk_loss_operator=loss_op, cdk_loss_metric=loss_met)
    for k, g in zip(("f", "g"), torch.autograd.grad(loss, [t["f"], t["g"]])):
        out[f"cdk_d{k}"] = g
    _save(os.path.join(d, f"out.{rank}.npz"), out)


# -- the methods ------------------------------------------------------------------

def methods_rank(rank, d, inputs, cases):
    """Each method's ``loss_and_grad`` with the group in float64 on this
    rank's rows and ``weighted_operator``: loss, gradients and new state,
    flattened to ``<case>/<name>``.  Then NeuralEF on the forward engine
    (its duals through the batch norm's mean) on the same rows on both
    ranks, with the group ("forward-dp") and without ("forward-single")."""
    from neuralsvd_tpu_torch.methods.factories import get_evd_method
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
    from neuralsvd_tpu_torch.operators.problems import get_problem

    _, group = _mesh()
    z = np.load(inputs)
    out = {}

    def run(case, name, parallel, opts, x, operator, axis_name):
        model = make_wavefunctions(**dict(METHOD_MODEL, parallel=parallel), device="cpu")
        model.load_state_dict({k[len(case) + 7:]: torch.tensor(z[k]) for k in z.files
                               if k.startswith(f"{case}/param/")})
        params = dict(model.double().named_parameters())
        method = get_evd_method(name, model, L, axis_name=axis_name, **opts)
        return method.loss_and_grad(params, method.init_state(params), x, operator)

    for case, (name, parallel, opts) in cases.items():
        x = torch.tensor(_rows(z[f"{case}/x"], rank))
        loss, grads, _, new = run(case, name, parallel, opts, x, weighted_operator, group)
        out[f"{case}/loss"] = loss
        out.update({f"{case}/grad/{k}": g for k, g in grads.items()})
        out.update({f"{case}/state/{k}": v for k, v in _flat(new)})
    op, _, _ = get_problem("sch", "hydrogen", 2, L, laplacian_eps=-1.0,
                           laplacian_mode="forward", operator_scale=10.0)
    x = torch.tensor(_rows(z["neuralef/x"], 0))
    for tag, axis_name in (("forward-dp", group), ("forward-single", None)):
        loss, grads, _, new = run("neuralef", "neuralef", True, {}, x, op, axis_name)
        out[f"{tag}/loss"] = loss
        out.update({f"{tag}/grad/{k}": g for k, g in grads.items()})
        out.update({f"{tag}/state/{k}": v for k, v in _flat(new)})
    _save(os.path.join(d, f"out.{rank}.npz"), out)


METHOD_MODEL = dict(ndim=2, neigs=L, mlp_hidden_dims=[8, 8], nonlinearity="softplus",
                    use_fourier_feature=True, fourier_mapping_size=8, fourier_scale=0.1,
                    apply_boundary=False)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/" if isinstance(v, dict) else f"{prefix}{k}")
    else:
        yield prefix, tree


# -- the dp train steps -----------------------------------------------------------

def weighted_operator(f, x, importance=None, **kw):
    """A cheap self-adjoint operator: a fixed radial weight times f
    (tests/test_parallel.py's)."""
    fs = f(x)
    return torch.exp(-torch.sum(x ** 2, -1, keepdim=True)) * fs, fs


def evd_setup():
    """(model, optimizer) of the dp train-step test: ParallelMLP towers and
    SGD, whose update is linear in the gradient, so a gradient averaged
    over the ranks where it must be summed, or a clip not applied, moves
    the parameters by another amount.  (RMSprop's first update,
    lr·g/√((1-ρ)g²), is the same for g and g/2.)"""
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
    from neuralsvd_tpu_torch.training.optimizers import build_optimizer

    model = make_wavefunctions(ndim=2, neigs=L, mlp_hidden_dims=[8], nonlinearity="softplus",
                               parallel=True, apply_boundary=False, seed=0, device="cpu")
    return model, build_optimizer("sgd", 1e-3)


TRAIN_CASES = {"plain": dict(), "clip": dict(grad_clip=10.0), "nonfinite": dict()}


def train_step_rank(rank, d, inputs):
    """``make_mesh_train_step`` on this rank's fixed local batch, one step per
    case of TRAIN_CASES from the same initial state (the "nonfinite" case
    has a NaN row on rank 1), plus the refusals that need a group."""
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA, NestedLoRAForCDK
    from neuralsvd_tpu_torch.parallel.mesh import require_capturable
    from neuralsvd_tpu_torch.parallel.sharding import make_mesh_cdk_step, make_mesh_train_step
    from neuralsvd_tpu_torch.training.cdk_step import make_cdk_train_step
    from neuralsvd_tpu_torch.training.train_operator import make_train_step
    from neuralsvd_tpu_torch.training.train_state import init_train_state

    mesh, group = _mesh()
    z = np.load(inputs)
    out = {}
    for case, kw in TRAIN_CASES.items():
        model, opt = evd_setup()
        method = NestedLoRA(model, L, sequential=True, axis_name=group)
        x = torch.tensor(z[f"{case}/x{rank}"])
        step = make_mesh_train_step(method, weighted_operator, opt, lambda g: x, mesh,
                                  ema_decay=0.9, **kw)
        ts = init_train_state(model, opt, method)
        _, metrics = step(ts, torch.Generator())
        out[f"{case}/loss"] = metrics["loss"]
        out[f"{case}/skipped"] = metrics["skipped"]
        out[f"{case}/gnorm"] = metrics["gnorm"]
        for k, p in ts.params.items():
            out[f"{case}/param/{k}"] = p
    # the refusals: a method without the group, a step without the
    # method's group, use_pallas=True with one, a graph on gloo
    model, opt = evd_setup()
    for make, method in ((make_mesh_train_step, NestedLoRA(model, L)),
                         (make_mesh_cdk_step, NestedLoRAForCDK(model, L))):
        args = ((method, weighted_operator, opt, None, mesh) if make is make_mesh_train_step
                else (method, opt, mesh))
        _expect(ValueError, "axis_name", make, *args)
    _expect(ValueError, "axis_name", make_train_step, NestedLoRA(model, L, axis_name=group),
            weighted_operator, opt, None)
    _expect(ValueError, "axis_name", make_cdk_train_step,
            NestedLoRAForCDK(model, L, axis_name=group), opt)
    _expect(ValueError, "use_pallas", NestedLoRA, model, L, axis_name=group, use_pallas=True)
    _expect(ValueError, "use_pallas", NestedLoRAForCDK, model, L, axis_name=group,
            use_pallas="true")
    assert NestedLoRA(model, L, axis_name=group).use_pallas is False  # "auto": plain
    _expect(ValueError, "gloo", require_capturable, group, "cuda")
    _save(os.path.join(d, f"out.{rank}.npz"), out)


def _expect(exc, match, fn, *args, **kw):
    try:
        fn(*args, **kw)
    except exc as e:
        assert match in str(e), (match, str(e))
        return
    raise AssertionError(f"{fn.__name__} did not raise {exc.__name__}")


def cdk_setup(L_cdk=4, dim=6):
    from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork
    from neuralsvd_tpu_torch.training.optimizers import build_optimizer

    model = HeteroNetwork(input_dim=dim, network_dims=[16, L_cdk], nonlinearity="lrelu0.2",
                          mu=16.0, regularize_mode="l2_ball",
                          generator=torch.Generator().manual_seed(0))
    return model, build_optimizer("sgd", 1e-2)


CDK_STEPS = 3


def cdk_step_rank(rank, d, inputs, grad_clip):
    """``make_mesh_cdk_step``: CDK_STEPS steps on this rank's rows of the
    pairs."""
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRAForCDK
    from neuralsvd_tpu_torch.parallel.sharding import make_mesh_cdk_step

    mesh, group = _mesh()
    z = np.load(inputs)
    model, opt = cdk_setup()
    method = NestedLoRAForCDK(model, 4, axis_name=group)
    step = make_mesh_cdk_step(method, opt, mesh, grad_clip=grad_clip)
    params = dict(model.named_parameters())
    state, skips = opt.init(params), torch.zeros((), dtype=torch.int32)
    x, y = (torch.tensor(_rows(z[k], rank)) for k in ("x", "y"))
    for _ in range(CDK_STEPS):
        params, state, _, loss, aux, skips = step(params, state, {}, x, y, skips)
    out = {"loss": loss, "f": aux["f"], "g": aux["g"], "skips": skips,
           "loss_operator": aux["loss_operator"], "loss_metric": aux["loss_metric"]}
    out.update({f"param/{k}": p for k, p in params.items()})
    _save(os.path.join(d, f"out.{rank}.npz"), out)


# -- the CLIs ---------------------------------------------------------------------

def synth_loaders(rng, n_cls=6, per_cls=32, D=16, batch=64):
    """Correlated (x, y) pairs: class-dependent means + noise
    (tests/test_cdk_retrieval.py:63-77); 192 pairs = 3 batches of 64."""
    from neuralsvd_tpu_torch.data.sketchy import ArrayPairLoader

    centers_x = 3 * rng.normal(size=(n_cls, D)).astype(np.float32)
    centers_y = 3 * rng.normal(size=(n_cls, D)).astype(np.float32)

    def split(seed):
        r = np.random.default_rng(seed)
        cls = np.repeat(np.arange(n_cls), per_cls)
        x = centers_x[cls] + r.normal(size=(len(cls), D)).astype(np.float32)
        y = centers_y[cls] + r.normal(size=(len(cls), D)).astype(np.float32)
        return ArrayPairLoader(x, y, cls, batch_size=batch, seed=seed)

    return split(1), split(2), split(3)


SKETCHY_ARGV = ["--device", "cpu", "--num_epochs", "2", "--batch_size", "64",
                "--network_dims", "32,8", "--neigs", "8", "--optimizer", "adam",
                "--base_lr", "1e-3", "--mu", "4.0", "--n_retrievals", "10",
                "--grad_clip", "0.5"]


def sketchy_rank(rank, d, log_dir):
    """``run_training`` with ``--mesh dp=2`` on the synthetic loaders."""
    from neuralsvd_tpu_torch.cli.sketchy import get_args, run_training

    train, test, valid = synth_loaders(np.random.default_rng(0))
    args = get_args(["--log_dir", log_dir, "--mesh", "dp=2"] + SKETCHY_ARGV)
    params, _ = run_training(args, train, test, valid, input_dim=16)
    _save(os.path.join(d, f"out.{rank}.npz"), params)


PDE_TINY = dict(seed=3, neigs=L, mlp_hidden_dims="16,16", batch_size=64, lim=4.0,
                val_eps=0.5, lr=1e-3, use_fourier_feature=True, fourier_mapping_size=8,
                fourier_scale=0.1, operator_scale=10.0, parallel=True, rescue=True,
                rescue_until=0.9, print_freq=10, eval_freq=20, optimizer="adam")
DUP = (0, 2)  # slot DUP[0] copied to DUP[1] before the resumed run that rescues


def pde_rank(rank, d, log_dir):
    """The PDE CLI with ``--mesh dp=2``, eager: a straight run to 40 (evals
    at 20 and 40); its resume from ckpt_20 (ckpt_40 removed) to 40; and a
    resume to 80 from ckpt_40 with mode DUP[0] copied into DUP[1], whose
    eval at 60 rescues it.  Each run's final parameters, and rank 0's log."""
    from neuralsvd_tpu_torch.cli import pde
    from neuralsvd_tpu_torch.parallel.mesh import barrier
    from neuralsvd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from neuralsvd_tpu_torch.utils.config import PDEConfig, run_name

    group = dist.group.WORLD
    handler = logging.FileHandler(os.path.join(d, f"log.{rank}"))
    logging.getLogger("neuralsvd_tpu_torch").addHandler(handler)
    logging.getLogger("neuralsvd_tpu_torch").setLevel(logging.INFO)

    def cfg(**kw):
        return PDEConfig(log_dir=log_dir, device="cpu", mesh="dp=2", **dict(PDE_TINY, **kw))

    out = {}
    for run, kw in (("straight", dict(num_iters=40)),
                    ("resumed", dict(num_iters=40, resume=True)),
                    ("rescued", dict(num_iters=80, resume=True))):
        if run == "resumed" and rank == 0:
            run_dir = os.path.join(log_dir, run_name(cfg(num_iters=40)))
            os.rename(os.path.join(run_dir, "ckpt_40"), os.path.join(d, "ckpt_40"))
        if run == "rescued" and rank == 0:
            tree = load_checkpoint(os.path.join(d, "ckpt_40"))
            _duplicate_mode(tree, L, *DUP)
            save_checkpoint(os.path.join(log_dir, run_name(cfg(**kw)), "ckpt_40"), tree)
        barrier(group)
        ts, eigvals, _ = pde.main(cfg(**kw))
        for k, p in ts.params.items():
            out[f"{run}/param/{k}"] = p
        out[f"{run}/eigvals"] = np.asarray(eigvals)
    handler.close()
    _save(os.path.join(d, f"out.{rank}.npz"), out)


def _duplicate_mode(tree, neigs, src, dst):
    """Copy mode slot ``src`` to ``dst`` in every per-mode tensor (leading
    size ``neigs``) of a state tree's params, EMA and optimizer state."""
    def walk(t):
        if isinstance(t, torch.Tensor):
            if t.ndim and t.shape[0] == neigs:
                t[dst] = t[src]
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    for name in ("params", "ema_params", "opt_state"):
        walk(tree[name])
