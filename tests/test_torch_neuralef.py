"""NeuralEF, the gram and Nyström: the port against the JAX package.

Inputs are numpy arrays from seeded generators; JAX parameters are carried
across with ``params_from_jax`` and JAX method states with
``method_state_from_jax``.  Tolerances are the JAX tests': rtol 1e-5 on
losses and states, rtol 1e-4 / atol 1e-6 of the largest entry on
gradients.  Finite differences at eps 0.1 carry ~1/eps² = 100 times the
model's rounding into Tφ, and in float32 the two packages' losses then
differ by ~1e-4; so those cases run the model and the operator in float64
in both packages and the loss in float32, as tests/test_torch_recipes.py
does.
"""
import copy
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.methods.factories import get_evd_method as jax_get_evd_method
from neuralsvd_tpu.methods.neuralef import NeuralEigenfunctions as JaxNEF
from neuralsvd_tpu.methods.neuralef import neuralef_loss as jax_neuralef_loss
from neuralsvd_tpu.methods.nystrom import Nystrom as JaxNystrom
from neuralsvd_tpu.methods.nystrom import run_nystrom as jax_run_nystrom
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.ops.gram import compute_gram as jax_compute_gram
from neuralsvd_tpu.operators.base import KernelOperator as JaxKernelOperator
from neuralsvd_tpu.operators.problems import get_problem as jax_get_problem
from neuralsvd_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from neuralsvd_tpu.training.train_operator import (
    make_scanned_train_step as jax_make_scanned_train_step,
)
from neuralsvd_tpu.training.train_state import init_train_state as jax_init_train_state
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.convert import _named_leaves, method_state_from_jax, params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.factories import get_evd_method
from neuralsvd_tpu_torch.methods.neuralef import NeuralEigenfunctions, neuralef_loss
from neuralsvd_tpu_torch.methods.nystrom import Nystrom, run_nystrom
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.base import KernelOperator
from neuralsvd_tpu_torch.ops import forward_laplacian
from neuralsvd_tpu_torch.ops.gram import compute_gram
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.training.optimizers import build_optimizer
from neuralsvd_tpu_torch.training.train_operator import make_scanned_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state, state_tree
from neuralsvd_tpu_torch.utils import config

L, B = 4, 64
MIX = (0.5, 2.0, 6.0, 16.0)
SMALL = dict(ndim=2, neigs=L, mlp_hidden_dims=[16, 16, 16], nonlinearity="softplus",
             parallel=True, use_fourier_feature=True, fourier_mapping_size=16,
             fourier_scale=0.1, fourier_append_radial=True,
             fourier_append_envelopes=(2.0, 2 / 3), apply_boundary=False)


def _x(n=B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice(MIX, size=(n, 1)) * rng.normal(size=(n, 2))


@pytest.fixture(scope="module")
def carried():
    """(JAX params, JAX apply, the port's model carrying them)."""
    jinit, japply = jax_make_wavefunctions(**SMALL)
    params = jinit(jax.random.key(0))
    model = make_wavefunctions(**SMALL, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, japply, model


def _assert_grads_close(got, ref):
    for k, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(got[k]), r, rtol=1e-4,
                                   atol=1e-6 * np.abs(r).max(), err_msg=k)


def _jax_grads(tree):
    """A JAX per-mode tower tree as {port name: float64 array}."""
    return {f"base.{g}.{i}": np.asarray(leaf, np.float64)
            for g in ("ws", "bs") for i, leaf in enumerate(tree["base"][g])}


# -- the loss and the gram ----------------------------------------------------

@pytest.mark.parametrize("include_diag", [False, True], ids=["offdiag", "diag"])
@pytest.mark.parametrize("unbiased", [True, False], ids=["unbiased", "quad"])
def test_neuralef_loss_and_its_backward_match_jax(unbiased, include_diag):
    """Forward rtol 1e-5; the custom backward (4x the variance term, 2x
    each align term, nothing for Tφ) rtol 1e-4, atol 1e-6 of the largest
    entry, for φ, φ1 and φ2 given as separate inputs."""
    rng = np.random.default_rng(1)
    phi, Tphi = (rng.normal(size=(16, L)).astype(np.float32) for _ in range(2))
    args = (phi, Tphi, phi[:8], Tphi[:8], phi[8:], Tphi[8:])
    diagonal = 0 if include_diag else 1
    jfn = lambda *a: jax_neuralef_loss(None, unbiased, diagonal, *a)  # noqa: E731
    jloss = float(jfn(*map(jnp.asarray, args)))
    jgrads = jax.grad(jfn, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    loss = neuralef_loss(unbiased, diagonal, *targs)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    grads = torch.autograd.grad(loss, targs, allow_unused=True, materialize_grads=True)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(jg).max(), 1.0), err_msg=str(i))
    for i in (1, 3, 5):  # Tφ gets nothing
        assert not grads[i].any()
    np.testing.assert_allclose(grads[0].numpy(), -4 * Tphi / 16, rtol=1e-5)


@pytest.mark.parametrize("shape,cross", [((32, 5), False), ((32, 5), True),
                                         ((32, 5, 3), True)], ids=["self", "cross", "3d"])
def test_compute_gram_matches_jax(shape, cross):
    """E[f gᵀ], rtol 1e-5, atol 1e-6 of the largest entry."""
    rng = np.random.default_rng(2)
    f = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32) if cross else None
    want = np.asarray(jax_compute_gram(jnp.asarray(f), None if g is None else jnp.asarray(g)))
    got = compute_gram(torch.as_tensor(f), None if g is None else torch.as_tensor(g))
    assert got.shape == (shape[1], shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


# -- loss_and_grad and the norm state -----------------------------------------

def _to_f32(operator, cast):
    """``operator`` with its (Tf, fs) cast to float32 for the loss."""
    return lambda f, x, importance=None: tuple(cast(a) for a in operator(f, x, importance))


def _loss_and_grad_pair(carried, mode, eps, importance, state=None, unbiased=True):
    """(JAX (loss, grads, state), port (loss, grads, state)) on one batch."""
    params, japply, model = carried
    x = _x()
    jop, _, _ = jax_get_problem("sch", "hydrogen", 2, L, laplacian_eps=eps,
                                operator_scale=10.0)
    op, _, _ = get_problem("sch", "hydrogen", 2, L, laplacian_eps=eps, operator_scale=10.0)
    _, jimp = jax_get_sampler("gaussian_mixture", B, 1, 2, MIX)
    _, imp = get_sampler("gaussian_mixture", B, 1, 2, MIX, device="cpu")
    fd = eps > 0
    dtype = torch.float64 if fd else torch.float32
    tmodel = copy.deepcopy(model).to(dtype)
    tmodel_params = dict(tmodel.named_parameters())
    jm = JaxNEF(japply, L, batchnorm_mode=mode, unbiased=unbiased)
    tm = NeuralEigenfunctions(tmodel, L, batchnorm_mode=mode, unbiased=unbiased)
    with jax.enable_x64(fd):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64 if fd else jnp.float32),
                          params)
        jstate = jm.init_state(jp) if state is None else jax.tree.map(jnp.asarray, state)
        jl, jg, _, jns = jm.loss_and_grad(
            jp, jstate, jnp.asarray(x if fd else x.astype(np.float32)),
            _to_f32(jop, lambda a: a.astype(jnp.float32)) if fd else jop,
            jimp if importance else None)
        jout = (float(jl), _jax_grads(jg), {k: np.asarray(v) for k, v in jns.items()})
    tstate = (tm.init_state(tmodel_params) if state is None
              else method_state_from_jax(state))
    tl, tg, _, tns = tm.loss_and_grad(
        tmodel_params, tstate, torch.as_tensor(x, dtype=dtype),
        _to_f32(op, lambda a: a.float()) if fd else op, imp if importance else None)
    return jout, (tl.item(), tg, tns), tm


def _assert_state_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype == np.bool_:
            assert got[k].dtype == torch.bool and bool(got[k]) == bool(w), k
        else:
            np.testing.assert_allclose(got[k].double().numpy(), w, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("importance", [False, True], ids=["plain", "importance"])
@pytest.mark.parametrize("eps", [0.1, -1.0], ids=["fd0.1", "forward"])
@pytest.mark.parametrize("mode", ["biased", "unbiased", "none"])
def test_loss_and_grad_matches_jax(carried, mode, eps, importance):
    """Loss rtol 1e-5, grads rtol 1e-4 / atol 1e-6 of the largest entry,
    the new norm state rtol 1e-5; the forward engine on the normalised
    model makes no fallback call."""
    forward_laplacian.fallback_rule.calls = 0
    (jl, jg, js), (tl, tg, ts_), _ = _loss_and_grad_pair(carried, mode, eps, importance)
    assert forward_laplacian.fallback_rule.calls == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_grads_close({k: v.double().numpy() for k, v in tg.items()}, jg)
    _assert_state_close(ts_, js)
    if mode != "none":
        assert bool(ts_["initialized"])


@pytest.mark.parametrize("mode", ["biased", "unbiased"])
def test_norm_ema_after_initialization_matches_jax(carried, mode):
    """From an initialized state with norms away from one, the EMA update
    of both norms (rtol 1e-5) on the forward engine."""
    rng = np.random.default_rng(3)
    state = {"norm_biased": rng.uniform(0.5, 2.0, (1, L)).astype(np.float32),
             "norm_unbiased": rng.uniform(0.5, 2.0, (1, L)).astype(np.float32),
             "initialized": np.ones((), np.bool_)}
    (jl, jg, js), (tl, tg, ts_), _ = _loss_and_grad_pair(carried, mode, -1.0, True,
                                                         state=state, unbiased=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_grads_close({k: v.numpy() for k, v in tg.items()}, jg)
    _assert_state_close(ts_, js)


def test_fd_phi_comes_from_the_stacked_call(carried, monkeypatch):
    """At the CLI's default eps 0.1 the loss and gradients differ from
    JAX's when φ is taken from a separate call on the B rows (the batch
    norm then sees other rows): the gradients by more than ten times the
    tolerance.  So the parity test above fails without the stacked call."""
    orig = NeuralEigenfunctions._train_model

    def separate(self, params, state):
        model, collect = orig(self, params, state)
        return (lambda x: model(x)), collect  # loses the batch_coupled mark

    monkeypatch.setattr(NeuralEigenfunctions, "_train_model", separate)
    (jl, jg, _), (tl, tg, _), _ = _loss_and_grad_pair(carried, "unbiased", 0.1, False)
    excess = max(np.max(np.abs(tg[k].double().numpy() - r)
                        / (1e-4 * np.abs(r) + 1e-6 * np.abs(r).max()))
                 for k, r in jg.items())
    assert excess > 10, excess
    assert abs(tl / jl - 1) > 1e-5


def test_nonfinite_batch_skips_the_step_but_moves_the_norms(carried):
    """A non-finite batch skips the parameter update; the norm EMA is taken
    from that batch all the same, as the JAX step keeps it."""
    params, japply, model = carried
    op, _, _ = get_problem("sch", "hydrogen", 2, L, laplacian_eps=-1.0, operator_scale=10.0)
    method = NeuralEigenfunctions(model, L)
    opt = build_optimizer("sgd", 1e-3)
    x = torch.as_tensor(_x(), dtype=torch.float32)
    x[3] = float("nan")
    block = make_scanned_train_step(method, op, opt, lambda gen: x, steps_per_call=1)
    ts = init_train_state(make_wavefunctions(**SMALL, device="cpu"), opt, method)
    before = state_tree(ts)
    ts, metrics = block(ts, 0)
    assert bool(metrics["skipped"][0])
    for k, p in ts.params.items():
        assert torch.equal(p.detach(), before["params"][k])
    assert bool(ts.method_state["initialized"])
    assert torch.isnan(ts.method_state["norm_unbiased"]).all()


def test_register_norm_and_eval_apply_match_jax(carried):
    """register_norm over 1000 points in batches of 128 (a ragged tail),
    then eval_apply: rtol 1e-5."""
    params, japply, model = carried
    data = _x(1000, seed=4).astype(np.float32)
    tparams = dict(model.named_parameters())
    for mode in ("biased", "unbiased", "none"):
        jm = JaxNEF(japply, L, batchnorm_mode=mode)
        tm = NeuralEigenfunctions(model, L, batchnorm_mode=mode)
        jstate = jm.register_norm(params, jm.init_state(params), data, batch_size=128)
        tstate = tm.register_norm(tparams, tm.init_state(tparams), data, batch_size=128)
        _assert_state_close(tstate, {k: np.asarray(v) for k, v in jstate.items()})
        want = np.asarray(jm.eval_apply(params, jstate, jnp.asarray(data[:100])))
        with torch.no_grad():
            got = tm.eval_apply(tparams, tstate, torch.as_tensor(data[:100]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_registered_eigvals_reorder_the_training_outputs(carried):
    """sort_indices reorder the raw outputs as JAX's _raw does (rtol 1e-5)."""
    params, japply, model = carried
    eigvals = np.array([0.3, 2.0, -1.0, 0.9])
    jm, tm = JaxNEF(japply, L), NeuralEigenfunctions(model, L)
    jm.register_eigvals(eigvals)
    tm.register_eigvals(eigvals)
    np.testing.assert_array_equal(tm.sort_indices, jm.sort_indices)
    x = _x(16).astype(np.float32)
    with torch.no_grad():
        got = tm._raw(dict(model.named_parameters()), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm._raw(params, jnp.asarray(x))),
                               rtol=1e-5)
    tm.reset_eigvals()
    assert tm.sort_indices is None and tm.eigvals is None


def test_factory_defaults_and_refusals(carried):
    """get_evd_method("neuralef") takes the JAX defaults, and so do SpIN and
    SpINx (decay 0.01); the kernel-operator path runs and gives JAX's loss
    (rtol 1e-5) and gradients; an unknown batchnorm_mode raises."""
    params, japply, model = carried
    jm = jax_get_evd_method("neuralef", japply, L)
    tm = get_evd_method("neuralef", model, L)
    assert (tm.batchnorm_mode, tm.unbiased, tm.diagonal, tm.momentum) == (
        jm.batchnorm_mode, jm.unbiased, jm.diagonal, jm.momentum) == ("unbiased", False, 1, 0.9)
    for name in ("spin", "spinx"):
        jspin, tspin = jax_get_evd_method(name, japply, L), get_evd_method(name, model, L)
        assert (tspin.name, tspin.neigs, tspin.decay) == (jspin.name, jspin.neigs,
                                                          jspin.decay) == (name, L, 0.01)
    x = _x(seed=9) / 4
    jl, jg, _, _ = jm.loss_and_grad_kernel(
        params, jm.init_state(params), jnp.asarray(x, jnp.float32),
        lambda lm: JaxKernelOperator(lambda a, b: jnp.exp(-jnp.sum((a[:, None] - b[None]) ** 2, -1)),
                                     lm))
    tparams = dict(model.named_parameters())
    tl, tg, _, _ = tm.loss_and_grad_kernel(
        tparams, tm.init_state(tparams), torch.as_tensor(x, dtype=torch.float32),
        lambda lm: KernelOperator(lambda a, b: torch.exp(-torch.cdist(a, b) ** 2), lm))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _assert_grads_close({k: g.numpy() for k, g in tg.items()},
                        {k: np.asarray(v) for k, v in _named_leaves(jg)})
    with pytest.raises(ValueError, match="batchnorm_mode"):
        NeuralEigenfunctions(model, L, batchnorm_mode="layer")


# -- driver steps against JAX's scanned block --------------------------------

def test_driver_steps_match_jax_scanned_block(carried):
    """Three steps of the port's block (make_scanned_train_step, eager on
    the CPU) against JAX's lax.scan block on the same batches (JAX's own
    draws for fold_in(key, start + i)), forward engine, √w conjugation,
    SGD with momentum: losses rtol 1e-5; parameters, EMA and the norm
    state rtol 1e-5 / atol 1e-6 of each tensor's largest entry."""
    params, japply, model = carried
    n, start = 3, 5
    jop, _, _ = jax_get_problem("sch", "hydrogen", 2, L, laplacian_eps=-1.0,
                                operator_scale=10.0)
    op, _, _ = get_problem("sch", "hydrogen", 2, L, laplacian_eps=-1.0, operator_scale=10.0)
    jsample, jimp = jax_get_sampler("gaussian_mixture", B, 1, 2, MIX)
    _, imp = get_sampler("gaussian_mixture", B, 1, 2, MIX, device="cpu")
    base_key = jax.random.key(7)
    batches = [np.array(jsample(jax.random.fold_in(base_key, start + i))) for i in range(n)]
    jm = JaxNEF(japply, L, unbiased=True)
    jopt = jax_build_optimizer("sgd", 1e-3, momentum=0.9)
    jblock = jax.jit(jax_make_scanned_train_step(jm, jop, jopt, jsample, importance=jimp,
                                                 ema_decay=0.995, steps_per_call=n))
    jts, jmetrics = jblock(jax_init_train_state(params, jopt, jm), base_key, start)

    fresh = make_wavefunctions(**SMALL, device="cpu")
    fresh.load_state_dict(model.state_dict())
    tm = NeuralEigenfunctions(fresh, L, unbiased=True)
    opt = build_optimizer("sgd", 1e-3, momentum=0.9)
    feed = iter(batches)
    block = make_scanned_train_step(tm, op, opt, lambda gen: torch.as_tensor(next(feed)),
                                    importance=imp, ema_decay=0.995, steps_per_call=n)
    ts, metrics = block(init_train_state(fresh, opt, tm), start)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]),
                               rtol=1e-5)
    assert not metrics["skipped"].any() and not np.asarray(jmetrics["skipped"]).any()
    for got, want in ((ts.params, jts.params), (ts.ema_params, jts.ema_params)):
        for k, w in params_from_jax(jax.tree.map(np.asarray, want)).items():
            w = w.numpy()
            np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)
    _assert_state_close(ts.method_state,
                        {k: np.asarray(v) for k, v in jts.method_state.items()})


# -- the CLI ------------------------------------------------------------------

def _cli_cfg(log_dir, **kw):
    base = dict(log_dir=str(log_dir), device="cpu", seed=1, neigs=L,
                mlp_hidden_dims="16,16", batch_size=64, lim=4.0, val_eps=0.5,
                num_iters=6, print_freq=3, eval_freq=3, lr=1e-3, parallel=True,
                apply_boundary=False, use_fourier_feature=True, fourier_mapping_size=8,
                fourier_scale=0.1, operator_scale=10.0, ema_decay=0.995,
                loss=config.LossConfig(name="neuralef",
                                       neuralef=config.NeuralEFOpts(unbiased=True)))
    base.update(kw)
    return config.PDEConfig(**base)


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("eps", [0.1, -1.0], ids=["fd", "forward"])
def test_cli_neuralef_resume_reproduces_the_straight_run(tmp_path, eps):
    """--loss neuralef through cli.pde.main: two blocks straight equal the
    first block's checkpoint, --resume and one more block, bit for bit,
    the norm state and its bool ``initialized`` included."""
    ts_a, ev_a, _ = pde.main(_cli_cfg(tmp_path / "a", laplacian_eps=eps))
    assert ts_a.method_state["initialized"].dtype == torch.bool
    assert bool(ts_a.method_state["initialized"])
    assert not torch.equal(ts_a.method_state["norm_unbiased"], torch.ones(1, L))
    assert len(ev_a) == 2 and all(np.isfinite(e).all() for e in ev_a)
    run_a = next(r for r, _, files in os.walk(tmp_path / "a") if "stats.npz" in files)
    run_b = run_a.replace(str(tmp_path / "a"), str(tmp_path / "b"))
    os.makedirs(run_b)
    shutil.copy(os.path.join(run_a, "ckpt_3"), run_b)
    ts_b, ev_b, _ = pde.main(_cli_cfg(tmp_path / "b", laplacian_eps=eps, resume=True))
    _assert_trees_equal(state_tree(ts_a), state_tree(ts_b))
    np.testing.assert_array_equal(ev_a[-1], ev_b[-1])


# -- Nyström ------------------------------------------------------------------

def _feats(x, xp):
    lam = xp.asarray([2.0, 1.0, 0.5], dtype=xp.float32)
    k = xp.arange(1, 4, dtype=xp.float32)
    return lam, math.sqrt(2.0) * xp.sin(math.pi * k * x.reshape(-1, 1))


def _jax_kernel(x, y):
    lam, fx = _feats(jnp.asarray(x), jnp)
    return (fx * lam) @ _feats(jnp.asarray(y), jnp)[1].T


def _torch_kernel(x, y):
    lam, fx = _feats(x, torch)
    return (fx * lam) @ _feats(y, torch)[1].T


def _nystrom_data():
    rng = np.random.default_rng(5)
    return (rng.uniform(0, 1, size=600).astype(np.float32),
            np.linspace(0, 1, 200).astype(np.float32))


def test_nystrom_matches_jax(tmp_path):
    """A rank-3 kernel on 600 uniform points: eigvals rtol 1e-5, the
    out-of-sample eigenfunctions on 200 points equal JAX's up to each
    mode's sign (rtol 1e-4, atol 1e-5 of the largest entry); run_nystrom
    writes eigvals.npz; an empirical kernel passed in gives the same."""
    xs, xval = _nystrom_data()
    jny = JaxNystrom(_jax_kernel, xs, dim=3)
    ny = Nystrom(_torch_kernel, xs, dim=3, device="cpu")
    np.testing.assert_allclose(ny.eigvals.numpy(), np.asarray(jny.eigvals), rtol=1e-5)
    jev, jef, _ = jax_run_nystrom(_jax_kernel, 3, xs, xval)
    ev, ef, seconds = run_nystrom(_torch_kernel, 3, xs, xval, log_dir=str(tmp_path),
                                  device="cpu")
    assert seconds >= 0 and os.path.exists(tmp_path / "eigvals.npz")
    np.testing.assert_allclose(ev, np.asarray(jev), rtol=1e-5)
    jef = np.asarray(jef)
    signs = np.sign(np.sum(ef * jef, axis=0))
    np.testing.assert_allclose(ef * signs, jef, rtol=1e-4, atol=1e-5 * np.abs(jef).max())
    emp = _torch_kernel(torch.as_tensor(xs), torch.as_tensor(xs))
    ny2 = Nystrom(_torch_kernel, xs, dim=3, emp_kernel=emp, device="cpu")
    np.testing.assert_array_equal(ny2.eigvals.numpy(), ny.eigvals.numpy())
    with pytest.raises(ValueError, match="kernel"):
        Nystrom(None, xs, dim=3, device="cpu")


def test_nystrom_takes_the_card_by_default_and_the_kernel_dtype(monkeypatch):
    """With no device Nyström resolves to the card (it raises where torch
    sees none, as every entry point of the port does); a float64 empirical
    kernel with a float32 kernel gives a float32 extension equal to JAX's,
    which casts the eigenpairs to float32 too."""
    xs, xval = _nystrom_data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Nystrom(_torch_kernel, xs, dim=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_nystrom(_torch_kernel, 3, xs, xval)
    emp = np.asarray(_jax_kernel(xs, xs), dtype=np.float64)
    jny = JaxNystrom(_jax_kernel, xs, dim=3, emp_kernel=emp)
    ny = Nystrom(_torch_kernel, xs, dim=3, emp_kernel=emp, device="cpu")
    assert ny.xs.device.type == "cpu" and ny.eigvecs.dtype == torch.float32
    ef, jef = ny(xval), np.asarray(jny(xval))
    assert ef.dtype == torch.float32
    np.testing.assert_allclose(ny.eigvals.numpy(), np.asarray(jny.eigvals), rtol=1e-5)
    signs = np.sign(np.sum(ef.numpy() * jef, axis=0))
    np.testing.assert_allclose(ef.numpy() * signs, jef, rtol=1e-4,
                               atol=1e-5 * np.abs(jef).max())
