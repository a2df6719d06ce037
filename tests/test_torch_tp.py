"""Tensor parallelism: the port's ``tp`` mesh axis on gloo ranks.

The mode all-gather and the optimizers' reductions across mode slices at
tp=2; the tp train step at dp=2 x tp=2 (four ranks) against JAX's GSPMD
step (``make_sharded_train_step``) on the 8 virtual CPU devices of
tests/conftest.py at tests/test_parallel.py:37's tolerances (loss rtol
1e-5, parameters rtol 1e-5, atol 1e-6), with the parameters carried across
by convert.py; and both CLIs at dp=2 x tp=2 and tp=2 against one process
at tests/test_cli_mesh.py's tolerances (rtol 2e-4, atol 2e-5, eigenvalues
rtol 1e-3).  The ranks run in spawned processes
(tests/torch_tp_workers.py through torch_dp_workers.run_ranks, each spawn
bounded by its own timeout); the references are made here.  The experiment
store's files are read across the two packages.
"""
import os

import jax
import numpy as np
import pytest
import torch

import torch_dp_workers as dp_workers
import torch_tp_workers as workers
from neuralsvd_tpu.methods.nestedlora import NestedLoRA as JaxNestedLoRA
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.parallel import make_mesh as jax_make_mesh
from neuralsvd_tpu.parallel import make_sharded_train_step
from neuralsvd_tpu.training.optimizers import torch_rmsprop as jax_torch_rmsprop
from neuralsvd_tpu.training.train_operator import make_train_step as jax_make_train_step
from neuralsvd_tpu.training.train_state import init_train_state as jax_init_train_state
from neuralsvd_tpu_torch.cli.sketchy import get_args, run_training
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.ops.gram import compute_gram
from neuralsvd_tpu_torch.training.optimizers import (
    global_norm,
    lars,
    per_mode_lr,
    reject_spikes,
)
from neuralsvd_tpu_torch.utils.config import PDEConfig


def _outs(d, world):
    return [dict(np.load(f"{d}/out.{r}.npz")) for r in range(world)]


# -- the collectives and the optimizers ---------------------------------------------

def test_mode_gather_and_the_optimizers_reductions_at_tp2(tmp_path):
    """At L 4 (2 + 2 modes) and 5 (3 + 2, GSPMD's padding): the gather
    gives every rank the whole (B, L, 2) tensor, its backward this rank's
    slice of the cotangent; the state gathers along axis 0 and 1.  On the
    slices of (L, 3) "a", (3, L) "c" and a replicated "r": the gradient's
    norm, three LARS, spike-rejection and per-mode-LR updates equal the
    one-process ones on the whole tensors (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    inputs = {}
    for n in workers.GATHER_LS:
        inputs.update({f"{n}/f": rng.normal(size=(6, n, 2)), f"{n}/w": rng.normal(size=(6, n, 2)),
                       f"{n}/s0": rng.normal(size=(n, 3, 2)), f"{n}/s1": rng.normal(size=(3, n))})
    n = workers.GATHER_LS[1]
    shapes = {"a": (n, 3), "c": (3, n), "r": (4,)}
    full = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    inputs.update({f"opt/{k}": v for k, v in full.items()})
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[2] = {k: 30 * g for k, g in grads[2].items()}  # a spike
    for i, g in enumerate(grads):
        inputs.update({f"opt/g{i}/{k}": v for k, v in g.items()})
    inputs["opt/scales"] = np.linspace(1, 3, n).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **inputs)
    d = dp_workers.run_ranks(workers.gather_rank, tmp_path, str(tmp_path / "inputs.npz"))
    outs = _outs(d, 2)
    for r, got in enumerate(outs):
        for n in workers.GATHER_LS:
            lo, hi = got[f"{n}/range"]
            assert (lo, hi) == ((0, 2), (2, 4))[r] if n == 4 else ((0, 3), (3, 5))[r]
            np.testing.assert_array_equal(got[f"{n}/gathered"], inputs[f"{n}/f"])
            np.testing.assert_array_equal(got[f"{n}/df"], inputs[f"{n}/w"][:, lo:hi])
            np.testing.assert_array_equal(got[f"{n}/state0"], inputs[f"{n}/s0"])
            np.testing.assert_array_equal(got[f"{n}/state1"], inputs[f"{n}/s1"])
    lo = (0, 3)
    for r, got in enumerate(outs):
        np.testing.assert_array_equal(got["tree/a"], full["a"][lo[r]:lo[r] + (3, 2)[r]])
        np.testing.assert_array_equal(got["tree/back_a"], full["a"])
    t = {k: torch.tensor(v) for k, v in full.items()}
    tg = [{k: torch.tensor(v) for k, v in g.items()} for g in grads]
    want_norm = global_norm(tg[0].values()).item()
    for got in outs:
        np.testing.assert_allclose(got["opt/gnorm"], want_norm, rtol=1e-6)
    axes = {"a": 0, "c": 1}
    for name, opt in (("lars", lars(0.5, weight_decay=1e-2, momentum=0.9)),
                      ("spikes", reject_spikes(1.5, warmup=1)),
                      ("tail", per_mode_lr(inputs["opt/scales"], n))):
        state = opt.init(t)
        for i, g in enumerate(tg):
            u, state = opt.update(g, state, t)
            for r, got in enumerate(outs):
                for k, v in u.items():
                    want = v.numpy()
                    if k in axes:
                        want = np.take(want, range(lo[r], lo[r] + (3, 2)[r]), axis=axes[k])
                    np.testing.assert_allclose(got[f"opt/{name}/{i}/{k}"], want, rtol=1e-6,
                                               atol=1e-7, err_msg=f"rank {r} {name} {i} {k}")
        if name == "spikes":
            assert int(state["rejected"]) == 1
            assert all(int(got["opt/spikes/rejected"]) == 1 for got in outs)


# -- the train step against JAX's GSPMD step ------------------------------------------

def _jax_gspmd_step(params, x, grad_clip):
    """JAX's tests/test_parallel.py:37 step on the conftest's dp=4 x tp=2
    mesh, on the pointwise operator of the port's test."""
    import jax.numpy as jnp

    _, apply = jax_make_wavefunctions(ndim=2, neigs=workers.STEP_L, mlp_hidden_dims=[8, 8],
                                      nonlinearity="softplus", parallel=True,
                                      apply_boundary=False)

    def operator(f, xv, importance=None):
        fs = f(xv)
        return jnp.exp(-jnp.sum(xv ** 2, -1, keepdims=True)) * fs, fs

    method = JaxNestedLoRA(apply, neigs=workers.STEP_L, sequential=True)
    opt = jax_torch_rmsprop(1e-3)
    step = jax_make_train_step(method, operator, opt, lambda key: jnp.asarray(x),
                               ema_decay=0.9, grad_clip=grad_clip)
    ts0 = jax_init_train_state(params, opt, method)
    jitted, ts = make_sharded_train_step(step, jax_make_mesh(8), ts0)
    new, metrics = jitted(ts, jax.random.key(1))
    assert new.params["base"]["ws"][0].sharding.spec[0] == "tp"
    return new.params, metrics


def test_tp_step_at_dp2_tp2_matches_jax_gspmd(tmp_path):
    """``make_mesh_train_step`` on four ranks (dp=2 x tp=2) against JAX's
    GSPMD step on the same global batch and parameters, without and with a
    clip: loss, gradient norm and the gathered parameters on every rank;
    each rank holds 4 of the 8 modes of every stack, of its RMSprop
    moments and of its EMA.  The dp mean of the ranks' half-split grams is
    the global halves' grams (rtol 1e-6), and a mesh that leaves ranks out
    is refused."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 2)).astype(np.float32)
    init, _ = jax_make_wavefunctions(ndim=2, neigs=workers.STEP_L, mlp_hidden_dims=[8, 8],
                                     nonlinearity="softplus", parallel=True,
                                     apply_boundary=False)
    params = init(jax.random.key(0))
    f = rng.normal(size=(32, 3)).astype(np.float32)
    inputs = {"x": x, "f": f}
    inputs.update({f"param/{k}": v.numpy() for k, v in params_from_jax(params).items()})
    np.savez(tmp_path / "inputs.npz", **inputs)
    d = dp_workers.run_ranks(workers.tp_step_rank, tmp_path, str(tmp_path / "inputs.npz"),
                             world=4)
    outs = _outs(d, 4)
    for case, kw in workers.STEP_CASES.items():
        new, metrics = _jax_gspmd_step(params, x, kw.get("grad_clip", 0.0))
        want = params_from_jax(new)
        for r, got in enumerate(outs):
            np.testing.assert_allclose(got[f"{case}/loss"], float(metrics["loss"]), rtol=1e-5,
                                       err_msg=f"rank {r} {case} loss")
            np.testing.assert_allclose(got[f"{case}/gnorm"], float(metrics["gnorm"]),
                                       rtol=1e-5, err_msg=f"rank {r} {case} gnorm")
            for k, v in want.items():
                np.testing.assert_allclose(got[f"{case}/param/{k}"], v.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=f"rank {r} {case} {k}")
                assert tuple(got[f"{case}/held/{k}"]) == (workers.STEP_L // 2,) * 3
    if "clip" in workers.STEP_CASES:
        _, m = _jax_gspmd_step(params, x, 0.0)
        assert workers.STEP_CASES["clip"]["grad_clip"] < float(m["gnorm"])
    halves = torch.chunk(torch.tensor(f), 2)
    for got in outs:
        for i, h in enumerate(halves):
            np.testing.assert_allclose(got[f"gram{i + 1}"], compute_gram(h).numpy(), rtol=1e-6,
                                       atol=1e-7)
        assert "must span all 4 ranks" in str(got["span_refusal"])


# -- the CLIs -----------------------------------------------------------------------

PDE_MESH_CFG = dict(seed=1, problem="sch", potential_type="harmonic_oscillator", ndim=1,
                    neigs=4, parallel=True, operator_shift=10.0, laplacian_eps=0.1, lim=4.0,
                    mlp_hidden_dims="16,16", nonlinearity="softplus", apply_boundary=True,
                    boundary_mode="dir_box_sqrt", sampling_mode="gaussian",
                    sampling_scale=1.0, batch_size=64, num_iters=400, print_freq=200,
                    eval_freq=400, optimizer="adam", lr=1e-3, device="cpu")


def _close_runs(got, want_params, want_eigvals, tag, rtol=2e-4, atol=2e-5):
    for k, p in want_params.items():
        np.testing.assert_allclose(got[f"{tag}/param/{k}"], p.detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{tag} {k}")
    np.testing.assert_allclose(got[f"{tag}/eigvals"][-1], np.asarray(want_eigvals[-1]),
                               rtol=1e-3, err_msg=f"{tag} eigvals")


def test_pde_cli_dp2_tp2_matches_a_single_process(tmp_path):
    """tests/test_cli_mesh.py:35's runs: ``cli.pde.main --mesh dp=2,tp=2``
    (four ranks) against one process, every parameter rtol 2e-4, atol
    2e-5, the last eval's eigenvalues rtol 1e-3; all ranks alike."""
    ts, eigvals, _ = pde.main(PDEConfig(log_dir=str(tmp_path / "single"), **PDE_MESH_CFG))
    runs = [("dptp", dict(PDE_MESH_CFG, log_dir=str(tmp_path / "dptp"), mesh="dp=2,tp=2"),
             None)]
    d = dp_workers.run_ranks(workers.pde_rank, tmp_path, runs, world=4)
    outs = _outs(d, 4)
    for got in outs:
        _close_runs(got, ts.params, eigvals, "dptp")
        for k in got:
            np.testing.assert_array_equal(got[k], outs[0][k], err_msg=k)


PDE_OPTIONS_CFG = dict(dp_workers.PDE_TINY, rescue=False, num_iters=120, print_freq=30,
                       eval_freq=60, device="cpu", overwrite=True)
PDE_OPTION_RUNS = {
    "clip_spikes_tail": dict(grad_clip=0.05, spike_reject_factor=25.0, tail_lr_boost=3.0,
                             tail_lr_start=2, use_lr_scheduler=True),
    "lars": dict(optimizer="lars", momentum=0.9, lr=0.5, num_iters=60, eval_freq=60),
    "neuralef": dict(loss=dict(name="neuralef"), num_iters=60, eval_freq=60),
}


def _cfg(log_dir, mesh="", **kw):
    from neuralsvd_tpu_torch.utils import config

    kw = dict(PDE_OPTIONS_CFG, **kw)
    if "loss" in kw:
        kw["loss"] = config.LossConfig(**kw["loss"])
    return dict(kw, log_dir=log_dir, mesh=mesh)


def test_pde_cli_options_and_checkpoints_under_tp2(tmp_path):
    """``--mesh tp=2`` against one process with ``--grad_clip``,
    ``--spike_reject_factor`` and ``--tail_lr_boost`` (a cosine schedule),
    with ``--optimizer lars`` and with ``--loss neuralef`` (rtol 2e-4,
    atol 2e-5); the tp=2 run's ckpt_60 resumed in one process, and the
    one process's ckpt_60 resumed at tp=2, each land on the straight
    one-process run."""
    single = {}
    for tag, kw in PDE_OPTION_RUNS.items():
        ts, eigvals, _ = pde.main(PDEConfig(**_cfg(str(tmp_path / "single"), **kw)),
                                  use_graph=False)
        single[tag] = (ts.params, eigvals)
    first = PDE_OPTION_RUNS["clip_spikes_tail"]
    run_dir = tmp_path / "single" / pde.run_name(PDEConfig(**_cfg("", **first)))
    runs = [(tag, _cfg(str(tmp_path / "tp"), mesh="tp=2", **kw), None)
            for tag, kw in PDE_OPTION_RUNS.items()]
    runs.append(("resumed_tp", _cfg(str(tmp_path / "resumed_tp"), mesh="tp=2", resume=True,
                                    **first), os.path.join(run_dir, "ckpt_60")))
    d = dp_workers.run_ranks(workers.pde_rank, tmp_path, runs)
    outs = _outs(d, 2)
    for got in outs:
        for tag in PDE_OPTION_RUNS:
            _close_runs(got, *single[tag], tag)
        _close_runs(got, *single["clip_spikes_tail"], "resumed_tp")
    tp_dir = tmp_path / "tp" / pde.run_name(PDEConfig(**_cfg("", mesh="tp=2", **first)))
    resumed_dir = tmp_path / "resumed_single" / pde.run_name(PDEConfig(**_cfg("", **first)))
    os.makedirs(resumed_dir)
    os.link(tp_dir / "ckpt_60", resumed_dir / "ckpt_60")
    ts, eigvals, _ = pde.main(PDEConfig(**_cfg(str(tmp_path / "resumed_single"), resume=True,
                                               **first)), use_graph=False)
    want_params, want_eigvals = single["clip_spikes_tail"]
    for k, p in want_params.items():
        np.testing.assert_allclose(ts.params[k].detach().numpy(), p.detach().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=f"resumed in one process {k}")
    np.testing.assert_allclose(eigvals[-1], want_eigvals[-1], rtol=1e-3)


@pytest.mark.parametrize("mesh,world", [("dp=2,tp=2", 4), ("tp=2", 2)])
def test_sketchy_cli_under_tp_matches_a_single_process(tmp_path, mesh, world):
    """tests/test_cli_mesh.py:69's comparison: ``run_training --mesh
    <mesh>`` with ``--grad_clip 0.5`` on the synthetic loaders against one
    process, every parameter of the whole model rtol 2e-4, atol 2e-5; the
    ranks alike bit for bit."""
    train, test, valid = dp_workers.synth_loaders(np.random.default_rng(0))
    args = get_args(["--log_dir", str(tmp_path / "single")] + dp_workers.SKETCHY_ARGV)
    single, _ = run_training(args, train, test, valid, input_dim=16)
    d = dp_workers.run_ranks(workers.sketchy_rank, tmp_path, str(tmp_path / "tp"), mesh,
                             world=world)
    outs = _outs(d, world)
    for k, p in single.items():
        for got in outs:
            np.testing.assert_array_equal(got[k], outs[0][k], err_msg=k)
        np.testing.assert_allclose(outs[0][k], p.detach().numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    assert {"ckpt", "best", "best_stats.npz"} <= set(os.listdir(tmp_path / "tp"))


def test_kernel_path_methods_at_tp2_match_a_single_process(tmp_path):
    """The kernel-operator path of NestedLoRA and NeuralEF (batch norm on)
    at tp=2 on an uneven L 5 with the exponential mask's scales sharded,
    with and without ``split_batch``, against the one-process methods on
    the whole model: loss rtol 1e-5, gradients rtol 1e-4, atol 1e-6 of the
    largest (tests/test_pallas_gram.py's), the norm state rtol 1e-5."""
    from neuralsvd_tpu_torch.methods.factories import get_evd_method
    from neuralsvd_tpu_torch.operators.base import KernelOperator

    x = np.random.default_rng(5).normal(size=(64, 2)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", x=x)
    d = dp_workers.run_ranks(workers.kernel_rank, tmp_path, str(tmp_path / "inputs.npz"))
    model = workers.kernel_model()
    params = dict(model.named_parameters())
    for name, split in workers.KERNEL_CASES:
        method = get_evd_method(name, model, 5)
        loss, grads, _, new = method.loss_and_grad_kernel(
            params, method.init_state(params), torch.tensor(x),
            lambda lm: KernelOperator(workers.rbf, lm), split_batch=split)
        tag = f"{name}/{int(split)}"
        for r, got in enumerate(_outs(d, 2)):
            np.testing.assert_allclose(got[f"{tag}/loss"], loss.item(), rtol=1e-5,
                                       err_msg=f"rank {r} {tag}")
            for k, g in grads.items():
                g = g.numpy()
                np.testing.assert_allclose(got[f"{tag}/grad/{k}"], g, rtol=1e-4,
                                           atol=1e-6 * np.abs(g).max(), err_msg=f"{tag} {k}")
            for k, v in new.items():
                np.testing.assert_allclose(got[f"{tag}/state/{k}"], v.numpy(), rtol=1e-5,
                                           err_msg=f"{tag} {k}")
