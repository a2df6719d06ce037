"""Ranks of the tensor-parallel tests (tests/test_torch_tp.py).

They run through ``torch_dp_workers.run_ranks`` (gloo over a ``FileStore``,
each spawn bounded by its own timeout), import only torch, numpy and the
port, and take their inputs and hand back their results as .npz files.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from torch_dp_workers import SKETCHY_ARGV, _save, synth_loaders, weighted_operator

GATHER_LS = (4, 5)  # even and uneven at tp=2
STEP_L = 8
STEP_CASES = {"plain": dict(), "clip": dict(grad_clip=0.05)}


def _mesh(spec):
    from neuralsvd_tpu_torch.parallel.mesh import dp_group, make_mesh, tp_group

    mesh = make_mesh(spec, device="cpu")
    return mesh, dp_group(mesh), tp_group(mesh)


# -- the collectives and the optimizers' reductions (tp=2) ---------------------------

def gather_rank(rank, d, inputs):
    """``gather_modes`` forward and backward and ``all_gather_modes`` on
    both state layouts at each L of GATHER_LS; ``narrow_tree``/
    ``gather_tree``; and ``grad_norm``, LARS, ``reject_spikes`` and
    ``per_mode_lr`` on this rank's slices of the inputs' tensors."""
    from neuralsvd_tpu_torch.parallel.collectives import all_gather_modes, gather_modes
    from neuralsvd_tpu_torch.parallel.mesh import ModeShards, mode_range
    from neuralsvd_tpu_torch.training.optimizers import (
        grad_norm,
        lars,
        per_mode_lr,
        reject_spikes,
    )

    _, _, tp = _mesh("tp=2")
    z = np.load(inputs)
    out = {}
    for n in GATHER_LS:
        lo, hi = mode_range(n, tp)
        out[f"{n}/range"] = np.array([lo, hi])
        f = torch.tensor(z[f"{n}/f"])[:, lo:hi].clone().requires_grad_(True)
        g = gather_modes(f, tp, n)
        (df,) = torch.autograd.grad(torch.sum(torch.tensor(z[f"{n}/w"]) * g), f)
        out[f"{n}/gathered"], out[f"{n}/df"] = g, df
        out[f"{n}/state0"] = all_gather_modes(torch.tensor(z[f"{n}/s0"])[lo:hi], tp, n, 0)
        out[f"{n}/state1"] = all_gather_modes(torch.tensor(z[f"{n}/s1"])[:, lo:hi], tp, n, 1)
    n = GATHER_LS[1]
    shards = ModeShards(tp, n, {"a": 0, "c": 1})
    full = {k: torch.tensor(z[f"opt/{k}"]) for k in ("a", "c", "r")}
    tree = {"params": full, "moments": [{"a": full["a"], "count": torch.tensor(3)}]}
    local = shards.narrow_tree(tree)
    out["tree/a"] = local["params"]["a"]
    out["tree/back_a"] = shards.gather_tree(local)["moments"][0]["a"]
    params = {k: v.clone() for k, v in local["params"].items()}
    grads = [shards.narrow_tree({k: torch.tensor(z[f"opt/g{i}/{k}"]) for k in full})
             for i in range(3)]
    out["opt/gnorm"] = grad_norm(grads[0], shards)
    for name, opt in (("lars", lars(0.5, weight_decay=1e-2, momentum=0.9, shards=shards)),
                      ("spikes", reject_spikes(1.5, warmup=1, shards=shards)),
                      ("tail", per_mode_lr(z["opt/scales"], n, shards))):
        state = opt.init(params)
        for i, g in enumerate(grads):
            u, state = opt.update(g, state, params)
            out.update({f"opt/{name}/{i}/{k}": v for k, v in u.items()})
        if name == "spikes":
            out["opt/spikes/rejected"] = state["rejected"]
    _save(os.path.join(d, f"out.{rank}.npz"), out)


# -- the tp train step at dp=2, tp=2 (four ranks) -----------------------------------

def step_model(neigs=STEP_L):
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions

    return make_wavefunctions(ndim=2, neigs=neigs, mlp_hidden_dims=[8, 8],
                              nonlinearity="softplus", parallel=True,
                              apply_boundary=False, device="cpu")


def tp_step_rank(rank, d, inputs):
    """``make_mesh_train_step`` on a dp=2 x tp=2 mesh, one step per case of
    STEP_CASES on the inputs' global batch from the inputs' parameters;
    the whole parameters gathered, the shapes each rank holds, the
    half-split grams and the refusal of a mesh that leaves ranks out."""
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
    from neuralsvd_tpu_torch.ops.gram import compute_gram
    from neuralsvd_tpu_torch.parallel.collectives import pmean
    from neuralsvd_tpu_torch.parallel.mesh import half_rows, make_mesh
    from neuralsvd_tpu_torch.parallel.sharding import (
        make_mesh_train_step,
        mode_shards,
        shard_module,
    )
    from neuralsvd_tpu_torch.training.optimizers import torch_rmsprop
    from neuralsvd_tpu_torch.training.train_state import init_train_state

    mesh, dp, tp = _mesh("dp=2,tp=2")
    z = np.load(inputs)
    x = torch.tensor(z["x"])
    out = {}
    for case, kw in STEP_CASES.items():
        model = step_model()
        model.load_state_dict({k[6:]: torch.tensor(z[k]) for k in z.files
                               if k.startswith("param/")})
        shards = mode_shards(model, tp, STEP_L)
        local = shard_module(model, shards)
        method = NestedLoRA(local, STEP_L, sequential=True, axis_name=dp, mode_axis=tp)
        opt = torch_rmsprop(1e-3)
        step = make_mesh_train_step(method, weighted_operator, opt, lambda g: x, mesh,
                                    shards, ema_decay=0.9, **kw)
        ts = init_train_state(local, opt, method)
        _, metrics = step(ts, torch.Generator())
        out[f"{case}/loss"], out[f"{case}/gnorm"] = metrics["loss"], metrics["gnorm"]
        for k, p in shards.gather_tree(ts.params).items():
            out[f"{case}/param/{k}"] = p
        for k in ts.params:
            out[f"{case}/held/{k}"] = np.array([ts.params[k].shape[0],
                                                ts.opt_state.nu[k].shape[0],
                                                ts.ema_params[k].shape[0]])
    f = torch.tensor(z["f"])
    f1, f2 = torch.chunk(half_rows(f, dp), 2)
    out["gram1"], out["gram2"] = pmean(compute_gram(f1), dp), pmean(compute_gram(f2), dp)
    try:
        make_mesh("dp=2", device="cpu")
    except ValueError as e:
        out["span_refusal"] = np.array(str(e))
    _save(os.path.join(d, f"out.{rank}.npz"), out)


# -- the CLIs -----------------------------------------------------------------------

def sketchy_rank(rank, d, log_dir, mesh):
    """``run_training --mesh <mesh>`` on the synthetic loaders."""
    from neuralsvd_tpu_torch.cli.sketchy import get_args, run_training

    train, test, valid = synth_loaders(np.random.default_rng(0))
    args = get_args(["--log_dir", log_dir, "--mesh", mesh] + SKETCHY_ARGV)
    params, _ = run_training(args, train, test, valid, input_dim=16)
    _save(os.path.join(d, f"out.{rank}.npz"), params)


def pde_rank(rank, d, runs):
    """``cli.pde.main`` eagerly for each (tag, config kwargs, checkpoint to
    resume from or None) of ``runs``; the gathered parameters, method state
    and the eigenvalues of each."""
    from neuralsvd_tpu_torch.cli import pde
    from neuralsvd_tpu_torch.training.rescue import named_leaves
    from neuralsvd_tpu_torch.utils.config import PDEConfig, run_name

    out = {}
    for tag, kw, resume_from in runs:
        cfg = PDEConfig(**kw)
        if resume_from is not None:
            run_dir = os.path.join(cfg.log_dir, run_name(cfg))
            if rank == 0:
                os.makedirs(run_dir, exist_ok=True)
                shutil.copy(resume_from, os.path.join(run_dir, os.path.basename(resume_from)))
            dist.barrier()
        ts, eigvals, _ = pde.main(cfg, use_graph=False)
        out.update({f"{tag}/param/{k}": p for k, p in ts.params.items()})
        out.update({f"{tag}/state/{k}": v for k, v in named_leaves(ts.method_state)})
        out[f"{tag}/eigvals"] = np.asarray(eigvals)
    _save(os.path.join(d, f"out.{rank}.npz"), out)


# -- the methods' kernel-operator path (tp=2) -----------------------------------------

KERNEL_CASES = (("nestedlora", False), ("nestedlora", True), ("neuralef", False),
                ("neuralef", True))


def kernel_model(neigs=5):
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions

    return make_wavefunctions(ndim=2, neigs=neigs, mlp_hidden_dims=[8, 8],
                              nonlinearity="softplus", parallel=True, apply_exp_mask=True,
                              exp_mask_init_scale=(1.0, 4.0), apply_boundary=False,
                              seed=2, device="cpu")


def rbf(a, b):
    return torch.exp(-0.5 * torch.cdist(a, b) ** 2)


def kernel_rank(rank, d, inputs):
    """``loss_and_grad_kernel`` of NestedLoRA and NeuralEF (the batch norm
    and its EMAs) on this rank's share of an uneven L 5 (3 + 2 modes, the
    exponential mask's scales sharded) at tp=2, with and without
    ``split_batch``: the loss, the gathered gradients and the new state."""
    from neuralsvd_tpu_torch.methods.factories import get_evd_method
    from neuralsvd_tpu_torch.operators.base import KernelOperator
    from neuralsvd_tpu_torch.parallel.sharding import mode_shards, shard_module

    _, _, tp = _mesh("tp=2")
    x = torch.tensor(np.load(inputs)["x"])
    model = kernel_model()
    shards = mode_shards(model, tp, 5)
    local = shard_module(model, shards)
    out = {}
    for name, split in KERNEL_CASES:
        method = get_evd_method(name, local, 5, mode_axis=tp)
        params = dict(local.named_parameters())
        loss, grads, _, new = method.loss_and_grad_kernel(
            params, method.init_state(params), x, lambda lm: KernelOperator(rbf, lm),
            split_batch=split)
        tag = f"{name}/{int(split)}"
        out[f"{tag}/loss"] = loss
        out.update({f"{tag}/grad/{k}": g for k, g in shards.gather_tree(grads).items()})
        out.update({f"{tag}/state/{k}": v for k, v in new.items()})
    _save(os.path.join(d, f"out.{rank}.npz"), out)


# -- SpIN and SpINx on the tp axis ------------------------------------------------------

SPIN_L = 4  # the step against JAX's GSPMD step (the CLI runs take an odd L)
SPIN_STEPS = 2
SPIN_LOSSES = ("spin", "spinx")


def spin_model(neigs=SPIN_L):
    """tests/test_cli_mesh.py:35's wavefunction: 1D, per-mode 16x16
    softplus towers, the box mask at lim 4."""
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions

    return make_wavefunctions(ndim=1, neigs=neigs, mlp_hidden_dims=[16, 16],
                              nonlinearity="softplus", parallel=True, apply_boundary=True,
                              boundary_mode="dir_box_sqrt", lim=4.0, device="cpu")


def _spin_steps(name, model, mesh, x, n_modes, steps=SPIN_STEPS):
    """``steps`` SGD steps of ``make_mesh_train_step`` with SpIN or SpINx
    (``name``) on this rank's share of ``model`` and the global batch
    ``x``, then SpINx's refresh on the same batch: the losses, the gathered
    parameters and method state, and the shapes of this rank's ``j_avg``."""
    from neuralsvd_tpu_torch.methods.factories import get_evd_method
    from neuralsvd_tpu_torch.parallel.mesh import (
        dp_group,
        half_rows,
        method_state_axes,
        tp_group,
    )
    from neuralsvd_tpu_torch.parallel.sharding import (
        make_mesh_train_step,
        mode_shards,
        shard_module,
    )
    from neuralsvd_tpu_torch.training.optimizers import build_optimizer
    from neuralsvd_tpu_torch.training.rescue import named_leaves
    from neuralsvd_tpu_torch.training.train_state import init_train_state

    dp, tp = dp_group(mesh), tp_group(mesh)
    shards = mode_shards(model, tp, n_modes)
    local = shard_module(model, shards)
    method = get_evd_method(name, local, n_modes, axis_name=dp, mode_axis=tp)
    opt = build_optimizer("sgd", 1e-3)
    step = make_mesh_train_step(method, weighted_operator, opt, lambda g: x, mesh, shards,
                                ema_decay=0.9)
    ts = init_train_state(local, opt, method)
    out = {}
    for i in range(steps):
        _, metrics = step(ts, torch.Generator())
        out[f"{name}/loss{i}"] = metrics["loss"]
    if name == "spinx":
        method.refresh_weights(ts.params, ts.method_state, half_rows(x, dp),
                               weighted_operator)
    state = shards.gather_state(ts.method_state, method_state_axes(method))
    out.update({f"{name}/param/{k}": p for k, p in shards.gather_tree(ts.params).items()})
    out.update({f"{name}/state/{k}": v for k, v in named_leaves(state)})
    if name == "spin":
        out.update({f"{name}/held/{k}": np.array(j.shape)
                    for k, j in ts.method_state["j_avg"].items()})
        out[f"{name}/state_bytes"] = np.array(method.state_bytes(ts.params))
    return out


def spin_step_rank(rank, d, inputs):
    """SpIN and SpINx (SPIN_LOSSES) on a dp=2 x tp=2 mesh: SPIN_STEPS steps
    each from the inputs' parameters on their global batch (``_spin_steps``)."""
    mesh, _, _ = _mesh("dp=2,tp=2")
    z = np.load(inputs)
    x = torch.tensor(z["x"])
    out = {}
    for name in SPIN_LOSSES:
        model = spin_model()
        model.load_state_dict({k[6:]: torch.tensor(z[k]) for k in z.files
                               if k.startswith("param/")})
        out.update(_spin_steps(name, model, mesh, x, SPIN_L))
    _save(os.path.join(d, f"out.{rank}.npz"), out)


class ScaledInput(torch.nn.Module):
    """A wavefunction behind a learnable input scale: a replicated parameter
    that acts before the modes are gathered, whose gradient each tp rank
    holds only in part (no wavefunction of the package has one)."""

    def __init__(self, inner, ndim):
        super().__init__()
        self.inner = inner
        self.scale = torch.nn.Parameter(torch.linspace(0.8, 1.2, ndim))

    def forward(self, x):
        return self.inner(x * self.scale)

    def per_mode_parameters(self):
        return [f"inner.{k}" for k in self.inner.per_mode_parameters()]

    def mode_axes(self):
        return {f"inner.{k}": a for k, a in self.inner.mode_axes().items()}


def upstream_model():
    """``ScaledInput`` over kernel_model's L 5 wavefunction, in float64."""
    return ScaledInput(kernel_model(), 2).double()


SPIN_KERNEL_CASES = tuple((name, split) for name in SPIN_LOSSES for split in (False, True))


def spin_local_rank(rank, d, inputs):
    """At tp=2 in float64: (a) ``loss_and_grad_kernel`` of SpIN and SpINx
    (SPIN_KERNEL_CASES) on this rank's share of kernel_model's uneven L 5
    (the exponential mask's scales sharded): the loss, the gathered
    gradients and new state, this rank's ``j_avg`` shapes and bytes; (b)
    ``_spin_steps`` of both on ``upstream_model`` (a replicated leaf
    upstream of the gather)."""
    from neuralsvd_tpu_torch.methods.factories import get_evd_method
    from neuralsvd_tpu_torch.operators.base import KernelOperator
    from neuralsvd_tpu_torch.parallel.mesh import method_state_axes
    from neuralsvd_tpu_torch.parallel.sharding import mode_shards, shard_module
    from neuralsvd_tpu_torch.training.rescue import named_leaves

    mesh, _, tp = _mesh("tp=2")
    x = torch.tensor(np.load(inputs)["x"], dtype=torch.float64)
    model = kernel_model().double()
    shards = mode_shards(model, tp, 5)
    local = shard_module(model, shards)
    out = {}
    for name, split in SPIN_KERNEL_CASES:
        method = get_evd_method(name, local, 5, mode_axis=tp)
        params = dict(local.named_parameters())
        state = method.init_state(params)
        tag = f"kernel/{name}/{int(split)}"
        if name == "spin":
            out[f"{tag}/held"] = np.array([j.shape[1] for j in state["j_avg"].values()])
            out[f"{tag}/state_bytes"] = np.array(method.state_bytes(params))
        loss, grads, _, new = method.loss_and_grad_kernel(
            params, state, x, lambda lm: KernelOperator(rbf, lm), split_batch=split)
        out[f"{tag}/loss"] = loss
        out.update({f"{tag}/grad/{k}": g for k, g in shards.gather_tree(grads).items()})
        new = shards.gather_state(new, method_state_axes(method))
        out.update({f"{tag}/state/{k}": v for k, v in named_leaves(new)})
    for name in SPIN_LOSSES:
        out.update({f"upstream/{k}": v for k, v in
                    _spin_steps(name, upstream_model(), mesh, x, 5).items()})
    _save(os.path.join(d, f"out.{rank}.npz"), out)
