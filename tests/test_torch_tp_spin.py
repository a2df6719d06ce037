"""SpIN and SpINx on the port's ``tp`` mesh axis, on gloo ranks.

Each rank holds its modes' share of the towers and of SpIN's Jacobian
average ``j_avg`` ((L, hi-lo, ...): its slots, on axis 1), and gathers φ
and Tφ before σ and π (methods/spin.py, spinx.py).  Checked here:

- the PDE CLI (``cli.pde.main``) at ``--mesh tp=2`` and ``dp=2,tp=2``
  against one process on an odd L (5: 3 + 2 modes, GSPMD's padding), SGD:
  parameters, the gathered ``j_avg``, ``sigma_avg`` and ``chol`` at
  tests/test_cli_mesh.py:62's rtol 2e-4 / atol 2e-5, eigenvalues rtol
  1e-3, SpINx's refreshed weights rtol 1e-3 (the float32 refresh itself
  moves its weights by ~2e-4 of themselves under a 1e-7 relative change of
  the parameters, so two reduction orders of the same run agree no
  closer); SpIN's checkpoints across meshes and ``--resume`` under tp;
- the train step at dp=2 x tp=2 against JAX's GSPMD step
  (``make_sharded_train_step`` on the 8 virtual CPU devices of
  tests/conftest.py) on tests/test_cli_mesh.py:35's wavefunction, with the
  parameters carried across by convert.py: losses rtol 1e-5, parameters
  and state at rtol 2e-4 / atol 2e-5, weights rtol 1e-3;
- in float64 at tp=2 (rtol 1e-8, atol 1e-10 of the largest entry): the
  kernel-operator path of both methods, split and not, on an uneven L 5
  with the exponential mask's scales sharded, and the train step on a
  model with a replicated leaf upstream of the gather (SpIN's dense σ
  channel, summed over tp by the step; SpINx's NTK norms, whose partial
  gradients are summed before they are squared).

The ranks run in spawned processes (tests/torch_tp_workers.py through
torch_dp_workers.run_ranks, each spawn bounded by its own timeout).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as dp_workers
import torch_tp_workers as workers
from neuralsvd_tpu.methods.factories import get_evd_method as jax_get_evd_method
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.parallel import make_mesh as jax_make_mesh
from neuralsvd_tpu.parallel import make_sharded_train_step
from neuralsvd_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from neuralsvd_tpu.training.train_operator import make_train_step as jax_make_train_step
from neuralsvd_tpu.training.train_state import init_train_state as jax_init_train_state
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.convert import method_state_from_jax, params_from_jax
from neuralsvd_tpu_torch.methods.factories import get_evd_method
from neuralsvd_tpu_torch.operators.base import KernelOperator
from neuralsvd_tpu_torch.training.checkpoint import load_checkpoint
from neuralsvd_tpu_torch.training.optimizers import build_optimizer
from neuralsvd_tpu_torch.training.rescue import named_leaves
from neuralsvd_tpu_torch.training.train_operator import make_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state, load_state_tree
from neuralsvd_tpu_torch.utils.config import LossConfig, PDEConfig, run_name

TP_TOL = (2e-4, 2e-5)  # (rtol, atol): tests/test_cli_mesh.py:62-63
WEIGHTS_RTOL = 1e-3
F64_TOL = (1e-8, 1e-10)  # (rtol, atol of the largest entry)
SPAWN_TIMEOUT_S = 180


def _outs(d, world):
    return [dict(np.load(f"{d}/out.{r}.npz")) for r in range(world)]


def _close(got, want, what, rtol=TP_TOL[0], atol=TP_TOL[1]):
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _close_f64(got, want, what):
    want = want.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=F64_TOL[0],
                               atol=F64_TOL[1] * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _close_state(got, state, tag, close=_close):
    """Every leaf of a method state (named_leaves) against ``got``'s
    ``<tag>/state/<leaf>``; SpINx's weights at WEIGHTS_RTOL under TP_TOL."""
    for k, v in named_leaves(state):
        if k == "weights" and close is _close:
            close(got[f"{tag}/state/{k}"], v, f"{tag} {k}", rtol=WEIGHTS_RTOL)
        else:
            close(got[f"{tag}/state/{k}"], v, f"{tag} {k}")


# -- the PDE CLI against one process ----------------------------------------------------

SPIN_CLI_CFG = dict(seed=1, problem="sch", potential_type="harmonic_oscillator", ndim=1,
                    neigs=5, parallel=True, operator_shift=10.0, laplacian_eps=0.1,
                    lim=4.0, mlp_hidden_dims="16,16", nonlinearity="softplus",
                    apply_boundary=True, boundary_mode="dir_box_sqrt",
                    sampling_mode="gaussian", sampling_scale=1.0, batch_size=64,
                    num_iters=10, print_freq=5, eval_freq=5, optimizer="sgd", lr=1e-3,
                    device="cpu")


def _cli_cfg(log_dir, name, mesh="", **kw):
    return dict(SPIN_CLI_CFG, log_dir=str(log_dir), mesh=mesh, loss=LossConfig(name=name),
                **kw)


def _run_dir(log_dir, name, **kw):
    return os.path.join(str(log_dir), run_name(PDEConfig(**_cli_cfg(log_dir, name, **kw))))


@pytest.mark.parametrize("mesh,world", [("tp=2", 2), ("dp=2,tp=2", 4)])
def test_spin_methods_through_the_cli_under_tp_match_a_single_process(tmp_path, mesh, world):
    """``cli.pde.main --mesh <mesh> --loss spin|spinx`` against one process
    at L 5 (module docstring's tolerances), all ranks alike bit for bit; at
    tp=2 also: the run resumed from the one process's ckpt_5 lands on the
    straight run, the tp run's ckpt_10 loads into a one-process TrainState
    with its gathered state bit for bit, and one process resumed from the
    tp run's ckpt_5 lands on the straight run."""
    single = {}
    for name in workers.SPIN_LOSSES:
        single[name] = pde.main(PDEConfig(**_cli_cfg(tmp_path / "single", name)),
                                use_graph=False)
    runs = [(name, _cli_cfg(tmp_path / "tp", name, mesh=mesh), None)
            for name in workers.SPIN_LOSSES]
    if world == 2:
        runs.append(("resumed", _cli_cfg(tmp_path / "resumed", "spin", mesh=mesh, resume=True),
                     os.path.join(_run_dir(tmp_path / "single", "spin"), "ckpt_5")))
    d = dp_workers.run_ranks(workers.pde_rank, tmp_path, runs, world=world,
                             timeout=SPAWN_TIMEOUT_S)
    outs = _outs(d, world)
    for got in outs:
        for k in got:
            np.testing.assert_array_equal(got[k], outs[0][k], err_msg=k)
    got = outs[0]
    init = dict(pde.build(PDEConfig(**_cli_cfg(tmp_path / "x", "spin")), "cpu")
                .model.named_parameters())
    for name, (ts, eigvals, _) in single.items():
        moved = max((p - init[k]).abs().max().item() for k, p in ts.params.items())
        assert moved > 10 * TP_TOL[1], f"{name}: the parameters moved {moved:.3g}"
        for k, p in ts.params.items():
            _close(got[f"{name}/param/{k}"], p, f"{name} {k}")
        _close_state(got, ts.method_state, name)
        assert {k for k, _ in named_leaves(ts.method_state)} == {
            k.split("/state/")[1] for k in got if k.startswith(f"{name}/state/")}
        np.testing.assert_allclose(got[f"{name}/eigvals"][-1], np.asarray(eigvals[-1]),
                                   rtol=1e-3, err_msg=f"{name} eigvals")
    if world != 2:
        return
    ts, eigvals, _ = single["spin"]
    for k, p in ts.params.items():
        _close(got[f"resumed/param/{k}"], p, f"resumed {k}")
    _close_state(got, ts.method_state, "resumed")
    # the tp run's checkpoint holds every mode: it loads in one process
    run = pde.build(PDEConfig(**_cli_cfg(tmp_path / "x", "spin")), "cpu")
    template = init_train_state(run.model, run.optimizer, run.method)
    tp_dir = _run_dir(tmp_path / "tp", "spin", mesh=mesh)
    load_state_tree(template, load_checkpoint(os.path.join(tp_dir, "ckpt_10")))
    for k, p in template.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), got[f"spin/param/{k}"], err_msg=k)
    for k, v in named_leaves(template.method_state):
        np.testing.assert_array_equal(v.numpy(), got[f"spin/state/{k}"], err_msg=k)
    resumed_dir = _run_dir(tmp_path / "resumed_single", "spin")
    os.makedirs(resumed_dir)
    os.link(os.path.join(tp_dir, "ckpt_5"), os.path.join(resumed_dir, "ckpt_5"))
    again, _, _ = pde.main(PDEConfig(**_cli_cfg(tmp_path / "resumed_single", "spin",
                                                resume=True)), use_graph=False)
    for k, p in ts.params.items():
        _close(again.params[k].detach().numpy(), p, f"resumed in one process {k}")
    for (k, v), (_, w) in zip(named_leaves(again.method_state), named_leaves(ts.method_state)):
        _close(v.numpy(), w, f"resumed in one process {k}")


# -- the train step against JAX's GSPMD step --------------------------------------------

def _jax_operator(f, xv, importance=None):
    fs = f(xv)
    return jnp.exp(-jnp.sum(xv ** 2, -1, keepdims=True)) * fs, fs


def _jax_gspmd_steps(name, params, x):
    """SPIN_STEPS of JAX's GSPMD step (conftest's dp=4 x tp=2 mesh, SGD) on
    the pointwise operator of the port's test, then SpINx's refresh: the
    losses, parameters and method state."""
    _, apply = jax_make_wavefunctions(ndim=1, neigs=workers.SPIN_L, mlp_hidden_dims=[16, 16],
                                      nonlinearity="softplus", parallel=True,
                                      apply_boundary=True, boundary_mode="dir_box_sqrt",
                                      lim=4.0)
    method = jax_get_evd_method(name, apply, workers.SPIN_L)
    opt = jax_build_optimizer("sgd", 1e-3)
    step = jax_make_train_step(method, _jax_operator, opt, lambda key: jnp.asarray(x),
                               ema_decay=0.9)
    jitted, ts = make_sharded_train_step(step, jax_make_mesh(8),
                                         jax_init_train_state(params, opt, method))
    losses = []
    for i in range(workers.SPIN_STEPS):
        ts, metrics = jitted(ts, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    assert ts.params["base"]["ws"][0].sharding.spec[0] == "tp"
    state = ts.method_state
    if name == "spinx":
        state = method.refresh_weights(ts.params, state, jnp.asarray(x), _jax_operator)
    return losses, ts.params, state


def test_spin_methods_step_at_dp2_tp2_matches_jax_gspmd(tmp_path):
    """SpIN and SpINx through ``make_mesh_train_step`` on four ranks (dp=2
    x tp=2, SGD) against JAX's GSPMD step on the same global batch and
    parameters for SPIN_STEPS steps, then SpINx's refresh: losses,
    parameters, ``j_avg`` (JAX's dense blocks off the diagonal are zero),
    ``sigma_avg``, ``chol`` and the weights (module docstring's
    tolerances); each rank holds 2 of the 4 slots of every ``j_avg`` leaf
    and half its bytes."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 1)).astype(np.float32)
    init, _ = jax_make_wavefunctions(ndim=1, neigs=workers.SPIN_L, mlp_hidden_dims=[16, 16],
                                     nonlinearity="softplus", parallel=True,
                                     apply_boundary=True, boundary_mode="dir_box_sqrt",
                                     lim=4.0)
    params = init(jax.random.key(3))
    inputs = {"x": x, **{f"param/{k}": v.numpy() for k, v in params_from_jax(params).items()}}
    np.savez(tmp_path / "inputs.npz", **inputs)
    d = dp_workers.run_ranks(workers.spin_step_rank, tmp_path, str(tmp_path / "inputs.npz"),
                             world=4, timeout=SPAWN_TIMEOUT_S)
    outs = _outs(d, 4)
    per_mode = workers.spin_model().per_mode_parameters()
    whole = sum(p.numel() * workers.SPIN_L * 4 for p in workers.spin_model().parameters())
    for name in workers.SPIN_LOSSES:
        losses, new_params, state = _jax_gspmd_steps(name, params, x)
        want_params = params_from_jax(new_params)
        want_state = method_state_from_jax(jax.device_get(state), per_mode)
        for r, got in enumerate(outs):
            for i, loss in enumerate(losses):
                np.testing.assert_allclose(got[f"{name}/loss{i}"], loss, rtol=1e-5,
                                           err_msg=f"rank {r} {name} loss {i}")
            for k, p in want_params.items():
                _close(got[f"{name}/param/{k}"], p, f"rank {r} {name} {k}")
            _close_state(got, want_state, name)
            if name == "spin":
                for k in per_mode:
                    assert got[f"spin/held/{k}"][:2].tolist() == [workers.SPIN_L,
                                                                 workers.SPIN_L // 2]
                assert int(got["spin/state_bytes"]) * 2 == whole


# -- float64 at tp=2: the kernel path, and a replicated leaf upstream of the gather -----

def _single_steps(name, model, x, n_modes):
    """One process's counterpart of torch_tp_workers._spin_steps."""
    method = get_evd_method(name, model, n_modes)
    opt = build_optimizer("sgd", 1e-3)
    step = make_train_step(method, workers.weighted_operator, opt, lambda g: x, ema_decay=0.9)
    ts = init_train_state(model, opt, method)
    losses = [step(ts, torch.Generator())[1]["loss"] for _ in range(workers.SPIN_STEPS)]
    if name == "spinx":
        method.refresh_weights(ts.params, ts.method_state, x, workers.weighted_operator)
    return losses, ts


def test_spin_methods_at_tp2_in_float64_match_a_single_process(tmp_path):
    """At tp=2 in float64 (rtol 1e-8, atol 1e-10 of the largest entry):
    SpIN's and SpINx's ``loss_and_grad_kernel`` on an uneven L 5 (3 + 2
    slots a rank, ``j_avg`` leaves (5, 3, ...) and (5, 2, ...)), with and
    without ``split_batch``: loss, gradients, new state; and two train
    steps with SpINx's refresh on a model whose input scale is a replicated
    leaf upstream of the gather (SpIN keeps its dense (L, L, 2) Jacobian
    average, a rank its columns): losses, parameters, state, weights."""
    x = np.random.default_rng(7).normal(size=(64, 2))
    np.savez(tmp_path / "inputs.npz", x=x)
    d = dp_workers.run_ranks(workers.spin_local_rank, tmp_path, str(tmp_path / "inputs.npz"),
                             timeout=SPAWN_TIMEOUT_S)
    outs = _outs(d, 2)
    xt = torch.tensor(x)
    model = workers.kernel_model().double()
    params = dict(model.named_parameters())
    whole_bytes = None
    for name, split in workers.SPIN_KERNEL_CASES:
        method = get_evd_method(name, model, 5)
        state = method.init_state(params)
        if name == "spin":
            whole_bytes = method.state_bytes(params)
        loss, grads, _, new = method.loss_and_grad_kernel(
            params, state, xt, lambda lm: KernelOperator(workers.rbf, lm), split_batch=split)
        tag = f"kernel/{name}/{int(split)}"
        for r, got in enumerate(outs):
            _close_f64(got[f"{tag}/loss"], loss, f"rank {r} {tag} loss")
            for k, g in grads.items():
                _close_f64(got[f"{tag}/grad/{k}"], g, f"rank {r} {tag} {k}")
            _close_state(got, new, tag, _close_f64)
            if name == "spin":
                assert set(got[f"{tag}/held"]) == {(3, 2)[r]}
        if name == "spin":
            assert sum(int(got[f"{tag}/state_bytes"]) for got in outs) == whole_bytes
    for name in workers.SPIN_LOSSES:
        model = workers.upstream_model()
        losses, ts = _single_steps(name, model, xt, 5)
        if name == "spin":
            assert ts.method_state["j_avg"]["scale"].shape == (5, 5, 2)
        for r, got in enumerate(outs):
            for i, loss in enumerate(losses):
                _close_f64(got[f"upstream/{name}/loss{i}"], loss, f"rank {r} {name} loss {i}")
            for k, p in ts.params.items():
                _close_f64(got[f"upstream/{name}/param/{k}"], p, f"rank {r} {name} {k}")
            _close_state(got, ts.method_state, f"upstream/{name}", _close_f64)
