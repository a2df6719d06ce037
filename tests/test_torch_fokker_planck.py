"""The Fokker–Planck problem: the port against the JAX package.

The operator -K f = -(∇²f + ∇V·∇f + f ∇²V) (times scale_operator) under
finite differences, the forward-Laplacian engine and nested JVPs, with
and without a sampling density; ``get_problem("fp")`` in every dimension
the JAX package has constants for; the FP recipe's training step
(NestedLoRA, sequential nesting) against JAX's scanned block; and the CLI
on ``--problem fp`` with a resume.  Inputs are numpy arrays from seeded
generators and JAX parameters are carried across with ``params_from_jax``.
Tolerances are those of tests/test_torch_operators.py for operators: Tf
rtol 1e-4, atol 1e-5 of its largest entry (float32 second derivatives),
fs rtol 1e-5, atol 1e-6 of its largest entry; losses rtol 1e-5.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.methods.nestedlora import NestedLoRA as JaxNestedLoRA
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.operators.fokker_planck import sin_of_cos_potential as jax_sin_of_cos
from neuralsvd_tpu.operators.problems import _FP_CS as JAX_FP_CS
from neuralsvd_tpu.operators.problems import get_problem as jax_get_problem
from neuralsvd_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from neuralsvd_tpu.training.train_operator import (
    make_scanned_train_step as jax_make_scanned_train_step,
)
from neuralsvd_tpu.training.train_state import init_train_state as jax_init_train_state
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.ops import forward_laplacian
from neuralsvd_tpu_torch.operators.base import DeviceConstant, device_constant
from neuralsvd_tpu_torch.operators.fokker_planck import sin_of_cos_potential
from neuralsvd_tpu_torch.operators.problems import _FP_CS, get_problem
from neuralsvd_tpu_torch.training.optimizers import build_optimizer
from neuralsvd_tpu_torch.training.train_operator import make_scanned_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state, state_tree
from neuralsvd_tpu_torch.utils import config

L, B = 4, 48


def _small(ndim):
    return dict(ndim=ndim, neigs=L, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
                parallel=True, use_fourier_feature=True, fourier_mapping_size=4 * ndim,
                fourier_scale=1.0, fourier_deterministic=True, apply_boundary=False)


def _carried(ndim):
    jinit, japply = jax_make_wavefunctions(**_small(ndim))
    params = jinit(jax.random.key(0))
    model = make_wavefunctions(**_small(ndim), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, japply, model


def _x(ndim, n=B, seed=0):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (n, ndim)).astype(np.float32)


def _assert_operator_close(got, want):
    (Tf, fs), (Tf_j, fs_j) = got, want
    Tf_j, fs_j = np.asarray(Tf_j), np.asarray(fs_j)
    assert not Tf.requires_grad and fs.requires_grad
    np.testing.assert_allclose(Tf.numpy(), Tf_j, rtol=1e-4, atol=1e-5 * np.abs(Tf_j).max())
    np.testing.assert_allclose(fs.detach().numpy(), fs_j, rtol=1e-5,
                               atol=1e-6 * np.abs(fs_j).max())


def test_fp_constants_are_copies():
    assert _FP_CS == JAX_FP_CS


@pytest.mark.parametrize("ndim", [1, 2, 5, 10])
def test_sin_of_cos_potential_matches_jax(ndim):
    x = _x(ndim, seed=ndim)
    want = np.asarray(jax_sin_of_cos(jnp.asarray(x), _FP_CS[ndim]))
    got = sin_of_cos_potential(torch.as_tensor(x), _FP_CS[ndim])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("importance", [False, True], ids=["plain", "uniform"])
@pytest.mark.parametrize("eps,mode", [(0.1, "forward"), (-1.0, "forward"), (-1.0, "jvp")],
                         ids=["fd0.1", "forward", "jvp"])
def test_fp_operator_matches_jax(eps, mode, importance):
    """(Tf, fs) of the 2D FP operator (scale_operator 3, operator_scale 2,
    shift 1) on the JAX init; Tf carries no graph, fs does; the forward
    engine makes no fallback call (the potential needs sin and cos)."""
    params, japply, model = _carried(2)
    kw = dict(ndim=2, neigs=L, laplacian_eps=eps, laplacian_mode=mode, operator_scale=2.0,
              operator_shift=1.0, scale_operator=3.0)
    jop, jgt, _ = jax_get_problem("fp", **kw)
    op, gt, n = get_problem("fp", **kw)
    assert n == 1
    np.testing.assert_array_equal(gt, jgt)
    _, jimp = jax_get_sampler("uniform", B, 1, 2, np.pi)
    _, imp = get_sampler("uniform", B, 1, 2, np.pi, device="cpu")
    x = _x(2)
    want = jop(lambda z: japply(params, z), jnp.asarray(x), jimp if importance else None)
    forward_laplacian.fallback_rule.calls = 0
    got = op(model, torch.as_tensor(x), imp if importance else None)
    assert forward_laplacian.fallback_rule.calls == 0
    _assert_operator_close(got, want)


def test_fp_importance_is_not_clipped():
    """Under a Gaussian density that falls below 1e-10 at some points (√w
    below VectorizedLaplacian's 1e-5 clip, above 1e-7), the FP operator
    divides by the unclipped √w, as the JAX operator does: (Tf, fs) match
    JAX's, and fs is f itself there (rtol 1e-5), where a clip would have
    scaled it by √w / 1e-5."""
    params, japply, model = _carried(2)
    _, jimp = jax_get_sampler("gaussian", B, 1, 2, 0.6)
    _, imp = get_sampler("gaussian", B, 1, 2, 0.6, device="cpu")
    x = _x(2, seed=3)
    sqrt_w = imp(torch.as_tensor(x)).sqrt().ravel()
    low = sqrt_w < 1e-5
    assert low.any() and (sqrt_w > 1e-7).all()
    jop, _, _ = jax_get_problem("fp", ndim=2, neigs=L, laplacian_eps=-1.0)
    op, _, _ = get_problem("fp", ndim=2, neigs=L, laplacian_eps=-1.0)
    want = jop(lambda z: japply(params, z), jnp.asarray(x), jimp)
    got = op(model, torch.as_tensor(x), imp)
    _assert_operator_close(got, want)
    with torch.no_grad():
        f = model(torch.as_tensor(x))
    np.testing.assert_allclose(got[1][low].detach().numpy(), f[low].numpy(), rtol=1e-5)


@pytest.mark.parametrize("ndim", [1, 2, 5, 10])
def test_get_problem_fp_matches_jax(ndim):
    """Every dimension with constants, scale_operator 0.5, operator_scale
    2, shift 4: (Tf, fs) on the forward engine and the ground truth
    (zeros, mapped) exactly."""
    params, japply, model = _carried(ndim)
    kw = dict(ndim=ndim, neigs=L, laplacian_eps=-1.0, operator_scale=2.0,
              operator_shift=4.0, scale_operator=0.5)
    jop, jgt, _ = jax_get_problem("fp", **kw)
    op, gt, _ = get_problem("fp", **kw)
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_array_equal(gt, np.full(L, 4.0))
    x = _x(ndim, seed=ndim)
    _assert_operator_close(op(model, torch.as_tensor(x)),
                           jop(lambda z: japply(params, z), jnp.asarray(x)))


def test_get_problem_fp_refuses_other_dimensions():
    with pytest.raises(ValueError, match="ndim 3"):
        get_problem("fp", ndim=3)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel-route"])
def test_fp_driver_steps_match_jax_scanned_block(use_pallas):
    """The FP recipe's step at a small width (2D, per-mode towers on
    deterministic Fourier features, uniform sampling on [-π, π]², the
    forward engine with return_grad, shift 4, sequential NestedLoRA, Adam
    at lr 1e-3 on a cosine schedule): three steps of the port's block
    against JAX's lax.scan block on JAX's draws.  Losses rtol 1e-5;
    parameters and EMA rtol 1e-5, atol 1e-6 of each tensor's largest
    entry."""
    from neuralsvd_tpu_torch.training.optimizers import cosine_annealing
    from neuralsvd_tpu.training.optimizers import cosine_annealing as jax_cosine

    params, japply, model = _carried(2)
    n, start, lr = 3, 0, 1e-3
    kw = dict(ndim=2, neigs=L, laplacian_eps=-1.0, operator_shift=4.0)
    jop, _, _ = jax_get_problem("fp", **kw)
    op, _, _ = get_problem("fp", **kw)
    jsample, jimp = jax_get_sampler("uniform", 64, 1, 2, np.pi)
    _, imp = get_sampler("uniform", 64, 1, 2, np.pi, device="cpu")
    base_key = jax.random.key(11)
    batches = [np.array(jsample(jax.random.fold_in(base_key, start + i))) for i in range(n)]
    jm = JaxNestedLoRA(japply, L, sequential=True)
    jopt = jax_build_optimizer("adam", lr, lr_schedule=jax_cosine(lr, 100))
    jblock = jax.jit(jax_make_scanned_train_step(jm, jop, jopt, jsample, importance=jimp,
                                                 ema_decay=0.995, steps_per_call=n))
    jts, jmetrics = jblock(jax_init_train_state(params, jopt, jm), base_key, start)

    tm = NestedLoRA(model, L, sequential=True, use_pallas=use_pallas)
    opt = build_optimizer("adam", lr, lr_schedule=cosine_annealing(lr, 100))
    feed = iter(batches)
    block = make_scanned_train_step(tm, op, opt, lambda gen: torch.as_tensor(next(feed)),
                                    importance=imp, ema_decay=0.995, steps_per_call=n)
    fresh = make_wavefunctions(**_small(2), device="cpu")
    fresh.load_state_dict(model.state_dict())
    ts, metrics = block(init_train_state(fresh, opt, tm), start)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]),
                               rtol=1e-5)
    assert not metrics["skipped"].any()
    for got, want in ((ts.params, jts.params), (ts.ema_params, jts.ema_params)):
        for k, w in params_from_jax(jax.tree.map(np.asarray, want)).items():
            w = w.numpy()
            np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)


def _cli_cfg(log_dir, **kw):
    base = dict(log_dir=str(log_dir), device="cpu", seed=2, problem="fp", ndim=2, neigs=L,
                mlp_hidden_dims="16,16", nonlinearity="softplus", parallel=True,
                fourier_deterministic=True, fourier_mapping_size=8, fourier_scale=1.0,
                apply_boundary=False, sampling_mode="uniform", sampling_scale=np.pi,
                lim=np.pi, val_eps=0.5, laplacian_eps=-1.0, operator_shift=4.0,
                optimizer="adam", lr=1e-3, use_lr_scheduler=True, batch_size=64,
                num_iters=6, print_freq=3, eval_freq=3,
                loss=config.LossConfig(neuralsvd=config.NeuralSVDOpts(sequential=True)))
    base.update(kw)
    return config.PDEConfig(**base)


def test_cli_fp_resume_reproduces_the_straight_run(tmp_path):
    """--problem fp through cli.pde.main (the FP recipe's flags at a small
    width): finite eigenvalues at both evals; two blocks straight equal
    the first block's checkpoint, --resume and one more block, bit for
    bit."""
    ts_a, ev_a, _ = pde.main(_cli_cfg(tmp_path / "a"))
    assert len(ev_a) == 2 and all(np.isfinite(e).all() and e.shape == (L,) for e in ev_a)
    run_a = next(r for r, _, files in os.walk(tmp_path / "a") if "stats.npz" in files)
    assert os.path.basename(os.path.dirname(run_a)).startswith("fp_ndim2")
    run_b = run_a.replace(str(tmp_path / "a"), str(tmp_path / "b"))
    os.makedirs(run_b)
    shutil.copy(os.path.join(run_a, "ckpt_3"), run_b)
    ts_b, ev_b, _ = pde.main(_cli_cfg(tmp_path / "b", resume=True))
    a, b = state_tree(ts_a), state_tree(ts_b)
    for name in ("params", "ema_params"):
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    assert int(ts_b.step) == 6
    np.testing.assert_array_equal(ev_a[-1], ev_b[-1])


def test_potential_constants_are_made_once_per_device_and_dtype(monkeypatch):
    """A potential's constants are held by the operator that
    ``get_problem`` builds, one tensor per (dtype, device), made at the
    first call: a step captured in a CUDA graph after an eager warm-up then
    copies nothing from the host.  A potential called with a plain array
    gets a new copy."""
    x = torch.as_tensor(_x(2))
    c = DeviceConstant(_FP_CS[2])
    a = device_constant(c, x)
    assert a is device_constant(c, x) and a.dtype == torch.float32
    assert device_constant(c, x.double()).dtype == torch.float64
    assert device_constant(c, x.double()) is device_constant(c, x.double())
    assert device_constant(DeviceConstant(_FP_CS[2]), x) is not a
    assert device_constant(_FP_CS[2], x) is not device_constant(_FP_CS[2], x)
    np.testing.assert_array_equal(device_constant(np.eye(3), x).numpy(), np.eye(3))
    idx = device_constant(DeviceConstant(np.array([0, 2])), x, torch.int64)
    assert idx.dtype == torch.int64 and idx.tolist() == [0, 2]
    pot = get_problem("fp", ndim=2, neigs=L)[0].operator.local_potential_ftn
    made = []
    real_tensor = torch.tensor

    def counting(*args, **kwargs):
        made.append(args)
        return real_tensor(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", counting)
    first, second = pot(x), pot(x)
    assert len(made) == 1 and torch.equal(first, second)
