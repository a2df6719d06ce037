"""SpIN and SpINx: the port against the JAX package.

Inputs are numpy arrays from seeded generators; JAX parameters are carried
across with ``params_from_jax`` and JAX method states with
``method_state_from_jax``.  Finite differences at eps 0.01 carry ~1/eps² =
10⁴ times the model's rounding into Tφ, so the parity cases run model,
operator and method in float64 in both packages: rtol 1e-6, atol 1e-9 of
the largest entry.  The port keeps a per-mode parameter's Jacobian
average as its diagonal blocks (methods/spin.py); JAX's blocks off the
diagonal are checked to be exactly zero.
"""
import copy
import importlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.methods.factories import get_evd_method as jax_get_evd_method
from neuralsvd_tpu.methods.spin import SpIN as JaxSpIN
from neuralsvd_tpu.methods.spin import spin_grad_matrices as jax_spin_grad_matrices
from neuralsvd_tpu.methods.spin import spin_step as jax_spin_step
from neuralsvd_tpu.methods.spinx import SpINx as JaxSpINx
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.operators.problems import get_problem as jax_get_problem
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.convert import _named_leaves, method_state_from_jax, params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.factories import get_evd_method
from neuralsvd_tpu_torch.parallel import mesh as mesh_module
from neuralsvd_tpu_torch.methods.spin import (
    SpIN,
    require_device_bytes,
    spin_grad_matrices,
    spin_step,
)
from neuralsvd_tpu_torch.methods.spinx import SpINx
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.base import KernelOperator
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.ops import forward_laplacian as engine
from neuralsvd_tpu_torch.training.optimizers import build_optimizer
from neuralsvd_tpu_torch.training.train_operator import (
    REFRESH_STREAM,
    block_seed,
    make_scanned_train_step,
    train_operator,
)
from neuralsvd_tpu_torch.training.train_state import init_train_state, state_tree
from neuralsvd_tpu_torch.utils import config

L, B = 4, 64
MIX = (0.5, 2.0, 6.0, 16.0)
TINY_MODEL = dict(ndim=2, neigs=L, mlp_hidden_dims=[8, 8], nonlinearity="softplus",
                  parallel=True, use_fourier_feature=True, fourier_mapping_size=8,
                  fourier_scale=0.1, fourier_append_radial=True,
                  fourier_append_envelopes=(2.0, 2 / 3), apply_boundary=False)
RTOL, ATOL = 1e-6, 1e-9  # atol in units of the largest entry
# the routes of the three-step parity test: (per-mode towers, eps, mode,
# Hutchinson probes)
ROUTES = {"fd-towers": (True, 0.01, "forward", 0), "fd-shared": (False, 0.01, "forward", 0),
          "jvp-towers": (True, -1.0, "jvp", 0), "forward-towers": (True, -1.0, "forward", 0),
          "hutchinson-towers": (True, -1.0, "forward", 2)}
# the Laplacians of the SpINx and operator parity tests: (eps, mode, probes)
LAPLACIANS = {"fd": (0.01, "forward", 0), "jvp": (-1.0, "jvp", 0),
              "forward": (-1.0, "forward", 0), "hutchinson": (-1.0, "forward", 2)}
PROBE_SEED = 11  # the shared Hutchinson probes: the port's draw from this seed
# the JAX engine's module (the package's ops/__init__ exports a function
# of the same name)
jax_engine = importlib.import_module("neuralsvd_tpu.ops.forward_laplacian")


def _x(seed, n=B):
    rng = np.random.default_rng(seed)
    return rng.choice(MIX, size=(n, 1)) * rng.normal(size=(n, 2))


def _close(got, want, what):
    got = np.asarray(got.detach().double().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def params_from_jax_f64(tree):
    """A JAX parameter-shaped tree as {port parameter name: float64 array}."""
    return {k: np.asarray(v, np.float64) for k, v in _named_leaves(tree)}


class _Pair:
    """The JAX and port sides of one configuration in float64: model,
    operator, importance and method, with the JAX init carried across."""

    def __init__(self, parallel=True, eps=0.01, mode="forward", method="spin",
                 decay=0.3, seed=0, probes=0, monkeypatch=None):
        kw = dict(TINY_MODEL, parallel=parallel)
        jinit, self.japply = jax_make_wavefunctions(**kw)
        params = jinit(jax.random.key(seed))
        model = make_wavefunctions(**kw, device="cpu")
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        self.model = model.double()
        self.params = dict(self.model.named_parameters())
        self.jparams = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        problem = dict(laplacian_eps=eps, laplacian_mode=mode, operator_scale=10.0,
                       operator_shift=1.0, laplacian_probes=probes)
        self.jop, _, _ = jax_get_problem("sch", "hydrogen", 2, L, **problem)
        self.op, _, _ = get_problem("sch", "hydrogen", 2, L, **problem)
        if probes:
            self._share_probes(probes, monkeypatch)
        _, self.jimp = jax_get_sampler("gaussian_mixture", B, 1, 2, MIX)
        _, self.imp = get_sampler("gaussian_mixture", B, 1, 2, MIX, device="cpu")
        jcls, tcls = (JaxSpIN, SpIN) if method == "spin" else (JaxSpINx, SpINx)
        self.jm = jcls(self.japply, L, decay=decay)
        self.tm = tcls(self.model, L, decay=decay)

    def _share_probes(self, n, monkeypatch):
        """Both operators take the Hutchinson estimator on the same probes:
        the port's draw from a generator seeded PROBE_SEED at every call,
        handed to the JAX engine in place of its own key's draw."""
        probes = engine.rademacher((n, B, 2), torch.Generator().manual_seed(PROBE_SEED),
                                   torch.float64, "cpu").numpy()

        def shared(f, xs, key, num_probes):
            out = jax_engine._run(f, xs.reshape(xs.shape[0], -1), jnp.asarray(probes))
            return jax_engine._l_mat(out) / num_probes, out.v

        monkeypatch.setattr(jax_engine, "hutchinson_laplacian", shared)
        op, jop = self.op, self.jop
        self.op = lambda f, x, imp=None, **kw: op(  # noqa: E731
            f, x, imp, generator=torch.Generator().manual_seed(PROBE_SEED), **kw)
        self.jop = lambda f, x, imp=None: jop(f, x, imp, key=jax.random.key(0))  # noqa: E731

    def jax_step(self, jstate, x):
        with jax.enable_x64(True):
            jp = jax.tree.map(jnp.asarray, self.jparams)
            if jstate is None:
                jstate = self.jm.init_state(jp)
            loss, grads, aux, new = self.jm.loss_and_grad(
                jp, jstate, jnp.asarray(x), self.jop, self.jimp)
            return (float(loss), params_from_jax_f64(grads),
                    jax.tree.map(lambda a: np.asarray(a, np.float64), new), aux)

    def port_step(self, state, x):
        if state is None:
            state = self.tm.init_state(self.params)
        loss, grads, aux, new = self.tm.loss_and_grad(
            self.params, state, torch.as_tensor(x), self.op, self.imp)
        assert new is state
        return loss.item(), grads, new, aux


def _assert_spin_state(pair, got, want):
    _close(got["sigma_avg"], want["sigma_avg"], "sigma_avg")
    _close(got["chol"], want["chol"], "chol")
    jj = params_from_jax_f64(want["j_avg"])
    assert set(got["j_avg"]) == set(jj)
    for k, dense in jj.items():
        if k in pair.tm.per_mode:
            off = ~np.eye(L, dtype=bool)
            assert not np.any(dense[:, off]), k  # exactly zero off the diagonal
            dense = np.moveaxis(np.diagonal(dense, axis1=1, axis2=2), -1, 1)
        _close(got["j_avg"][k], dense, f"j_avg[{k}]")


# -- the whitening step ---------------------------------------------------------

@pytest.mark.parametrize("n", [3, 8])
def test_spin_step_and_grad_matrices_match_jax(n):
    """Random SPD σ and symmetric π (float64): chol, chol⁻¹, Λ, eigvals,
    the loss, gσ and gπ at rtol 1e-6, atol 1e-9 of the largest entry."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, n))
    sigma = a @ a.T / n + 0.1 * np.eye(n)
    pi = rng.normal(size=(n, n))
    pi = (pi + pi.T) / 2
    with jax.enable_x64(True):
        want = [np.asarray(v) for v in jax_spin_step(jnp.asarray(sigma), jnp.asarray(pi))]
        want += [np.asarray(v) for v in jax_spin_grad_matrices(jnp.asarray(sigma),
                                                               jnp.asarray(pi))]
    got = list(spin_step(torch.as_tensor(sigma), torch.as_tensor(pi)))
    got += list(spin_grad_matrices(torch.as_tensor(sigma), torch.as_tensor(pi)))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, str(i))


def test_not_positive_definite_gives_nan_without_raising():
    """A σ that is not positive definite gives JAX's factor (NaN on and
    below the diagonal, zero above) and a NaN loss, and raises nothing."""
    sigma = torch.diag(torch.tensor([1.0, -1.0, 2.0], dtype=torch.float64))
    pi = torch.eye(3, dtype=torch.float64)
    chol = spin_step(sigma, pi)[0]
    with jax.enable_x64(True):
        jchol = np.asarray(jax_spin_step(jnp.asarray(sigma.numpy()), jnp.asarray(pi.numpy()))[0])
    np.testing.assert_array_equal(chol.numpy(), jchol)
    assert np.isnan(jchol[np.tril_indices(3)]).all() and torch.isnan(spin_grad_matrices(sigma, pi)[0])


# -- SpIN.loss_and_grad ---------------------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spin_three_steps_match_jax(route, monkeypatch):
    """Three consecutive loss_and_grad calls on fresh batches, the state
    carried (hydrogen, √w conjugation, scale 10, shift 1; finite
    differences, nested JVPs, the forward engine and Hutchinson on shared
    probes): loss, grads, sigma_avg, chol and j_avg (compact against JAX's
    diagonal blocks, whose other blocks are exactly zero; dense on the
    shared trunk)."""
    parallel, eps, mode, probes = ROUTES[route]
    pair = _Pair(parallel=parallel, eps=eps, mode=mode, probes=probes,
                 monkeypatch=monkeypatch)
    assert bool(pair.tm.per_mode) == parallel
    jstate = state = None
    for step in range(3):
        x = _x(step)
        jl, jg, jstate, jaux = pair.jax_step(jstate, x)
        tl, tg, state, aux = pair.port_step(state, x)
        _close(tl, jl, f"loss {step}")
        _close(aux["eigvals"], np.asarray(jaux["eigvals"]), f"eigvals {step}")
        assert set(tg) == set(jg)
        for k, w in jg.items():
            _close(tg[k], w, f"grad {k} step {step}")
        _assert_spin_state(pair, state, jstate)


def test_compact_equals_dense_on_the_towers():
    """The per-mode towers' j_avg and grads by the compact route (L passes)
    equal those of the dense route (L² one-hot passes) that the same
    method takes when it is told no parameter is per-mode."""
    pair = _Pair()
    dense = SpIN(pair.model, L, decay=0.3)
    dense.per_mode = frozenset()
    x = torch.as_tensor(_x(5))
    s_c, s_d = pair.tm.init_state(pair.params), dense.init_state(pair.params)
    for _ in range(2):
        _, g_c, _, _ = pair.tm.loss_and_grad(pair.params, s_c, x, pair.op, pair.imp)
        _, g_d, _, _ = dense.loss_and_grad(pair.params, s_d, x, pair.op, pair.imp)
    for k, j in s_d["j_avg"].items():
        _close(g_c[k], g_d[k].numpy(), f"grad {k}")
        diag = torch.diagonal(j, dim1=1, dim2=2).movedim(-1, 1)
        _close(s_c["j_avg"][k], diag.numpy(), f"j_avg {k}")
        assert not j[:, ~torch.eye(L, dtype=torch.bool)].any()


def test_per_mode_parameters_are_declared():
    """The towers and the exponential mask declare every parameter; the
    shared trunk declares none, and SpIN keeps it dense (L, L, *shape)."""
    towers = make_wavefunctions(**TINY_MODEL, apply_exp_mask=True, device="cpu")
    assert set(towers.per_mode_parameters()) == {k for k, _ in towers.named_parameters()}
    assert "mask.scales" in towers.per_mode_parameters()
    trunk = make_wavefunctions(**dict(TINY_MODEL, parallel=False), device="cpu")
    assert trunk.per_mode_parameters() == []
    state = SpIN(trunk, L).init_state(dict(trunk.named_parameters()))
    for k, p in trunk.named_parameters():
        assert state["j_avg"][k].shape == (L, L) + p.shape


def test_state_size_check_names_the_bytes():
    """init_state refuses a j_avg and its refill that the device cannot
    hold, naming the bytes; at hydrogen.sh's width the compact state is
    36·P·4 bytes and the dense one 36x that."""
    model = make_wavefunctions(**TINY_MODEL, device="cpu")
    params = dict(model.named_parameters())
    method = SpIN(model, L)
    nbytes = method.state_bytes(params)
    assert nbytes == L * sum(p.numel() for p in params.values()) * 4
    with pytest.raises(MemoryError, match=str(2 * nbytes)):
        require_device_bytes(2 * nbytes, "cuda", free=2 * nbytes - 1)
    require_device_bytes(2 * nbytes, "cuda", free=2 * nbytes)
    require_device_bytes(10 ** 15, "cpu")  # no check on the host
    dense = SpIN(model, L)
    dense.per_mode = frozenset()
    assert dense.state_bytes(params) == L * nbytes


def test_spin_numpy_oracle_and_eval_orthonormality():
    """tests/test_methods.py:19-77 in the port: a linear model and a matrix
    operator local to this test, against closed-form numpy (its
    tolerances: loss rtol 1e-4, grads rtol 1e-3 / atol 1e-4, state rtol
    1e-4 / atol 1e-6); then, with no memory (decay 1), the whitened eval
    outputs are orthonormal to the jitter's 1e-2."""
    rng = np.random.default_rng(0)
    Bo, D, Lo, decay = 12, 5, 3, 0.3
    X = rng.normal(size=(Bo, D)).astype(np.float32)
    A = rng.normal(size=(Bo, Bo)).astype(np.float32)
    A = (A + A.T) / 2
    W = rng.normal(size=(D, Lo)).astype(np.float32)

    class Linear(nn.Module):
        def __init__(self, w):
            super().__init__()
            self.W = nn.Parameter(torch.as_tensor(w))

        def forward(self, x):
            return x @ self.W

    def matrix_operator(mat):
        mat = torch.as_tensor(mat)
        return lambda f, x, importance=None, with_graph=False: (mat @ f(x), f(x))

    model = Linear(W)
    params = dict(model.named_parameters())
    spin = SpIN(model, Lo, decay=decay)
    assert not spin.per_mode
    loss, grads, aux, state = spin.loss_and_grad(
        params, spin.init_state(params), torch.as_tensor(X), matrix_operator(A))
    phi = X @ W
    Tphi = A @ phi
    sigma_avg = decay * phi.T @ phi / Bo
    pi = phi.T @ Tphi / Bo
    chol = np.linalg.cholesky(sigma_avg + 1e-3 * np.eye(Lo))
    chol_inv = np.linalg.inv(chol)
    lam = chol_inv @ pi @ chol_inv.T
    dci = np.diag(np.diag(chol_inv))
    gsigma = chol_inv.T @ np.triu(lam @ dci)
    gpi = -chol_inv.T @ dci
    grad_pi = X.T @ (Tphi @ gpi / Bo + A.T @ (phi @ gpi / Bo))
    grad_sigma = decay * (2.0 / Bo) * X.T @ phi @ gsigma
    np.testing.assert_allclose(loss.item(), np.trace(lam), rtol=1e-4)
    np.testing.assert_allclose(grads["W"].numpy(), grad_pi + grad_sigma, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(state["sigma_avg"].numpy(), sigma_avg, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(aux["eigvals"].numpy(), np.diag(lam), rtol=1e-4)
    np.testing.assert_allclose(state["chol"].numpy(), chol, rtol=1e-4, atol=1e-6)

    Bo, D = 400, 4
    X = rng.normal(size=(Bo, D)).astype(np.float32)
    model = Linear(rng.normal(size=(D, Lo)).astype(np.float32))
    params = dict(model.named_parameters())
    spin = SpIN(model, Lo, decay=1.0)
    _, _, _, state = spin.loss_and_grad(params, spin.init_state(params), torch.as_tensor(X),
                                        matrix_operator(np.eye(Bo, dtype=np.float32)))
    with torch.no_grad():
        out = spin.eval_apply(params, state, torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(out.T @ out / Bo, np.eye(Lo), atol=1e-2)


def test_not_positive_definite_sigma_skips_the_step_and_moves_the_state():
    """A sigma_avg that is not positive definite: the loss is NaN in both
    packages, the driver skips the parameter update, and the state is
    written all the same (as the JAX step keeps it)."""
    pair = _Pair()
    x = _x(0)
    bad_sigma = -10 * np.eye(L)
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, pair.jparams)
        jstate = dict(pair.jm.init_state(jp), sigma_avg=jnp.asarray(bad_sigma))
        jl = float(pair.jm.loss_and_grad(jp, jstate, jnp.asarray(x), pair.jop, pair.jimp)[0])
    assert np.isnan(jl)

    model = copy.deepcopy(pair.model).float()  # the driver's traces are float32
    method = SpIN(model, L)
    opt = build_optimizer("sgd", 1e-3)
    block = make_scanned_train_step(method, pair.op, opt,
                                    lambda gen: torch.as_tensor(x, dtype=torch.float32),
                                    importance=pair.imp, steps_per_call=1)
    ts = init_train_state(model, opt, method)
    with torch.no_grad():
        ts.method_state["sigma_avg"].copy_(torch.as_tensor(bad_sigma))
    before = state_tree(ts)
    ts, metrics = block(ts, 0)
    assert bool(metrics["skipped"][0]) and torch.isnan(metrics["loss"][0])
    for k, p in ts.params.items():
        assert torch.equal(p.detach(), before["params"][k])
    assert torch.isnan(torch.diagonal(ts.method_state["chol"])).all()
    assert not torch.equal(ts.method_state["sigma_avg"], before["method_state"]["sigma_avg"])
    assert any(j.any() for j in ts.method_state["j_avg"].values())


# -- SpINx ----------------------------------------------------------------------

@pytest.mark.parametrize("lap", sorted(LAPLACIANS))
def test_spinx_steps_and_refresh_match_jax(lap, monkeypatch):
    """Two SpINx steps (the state carried), then refresh_weights on a
    third batch and one more step with the refreshed weights: loss, grads,
    sigma_avg, chol and the weights at rtol 1e-6, atol 1e-9 of the largest
    entry; the refresh writes the state's own tensor.  Finite differences,
    nested JVPs, the forward engine and Hutchinson on shared probes."""
    eps, mode, probes = LAPLACIANS[lap]
    pair = _Pair(eps=eps, mode=mode, method="spinx", probes=probes, monkeypatch=monkeypatch)
    jstate = state = None
    for step in range(3):
        x = _x(step)
        if step == 2:
            with jax.enable_x64(True):
                jstate = pair.jm.refresh_weights(
                    jax.tree.map(jnp.asarray, pair.jparams), jstate, jnp.asarray(x),
                    pair.jop, pair.jimp)
            weights = state["weights"]
            assert pair.tm.refresh_weights(pair.params, state, torch.as_tensor(x),
                                           pair.op, pair.imp) is state
            assert state["weights"] is weights and not torch.all(weights == 1)
            _close(state["weights"], np.asarray(jstate["weights"]), "weights")
        jl, jg, jstate, _ = pair.jax_step(jstate, x)
        tl, tg, state, aux = pair.port_step(state, x)
        assert aux["eigvals"] is None
        _close(tl, jl, f"loss {step}")
        for k, w in jg.items():
            _close(tg[k], w, f"grad {k} step {step}")
        for k in ("sigma_avg", "chol", "weights"):
            _close(state[k], jstate[k], f"{k} step {step}")


# -- Tφ with a graph --------------------------------------------------------------

@pytest.mark.parametrize("lap", sorted(LAPLACIANS))
def test_operator_vjp_with_graph_matches_jax(lap, monkeypatch):
    """with_graph=True: the VJP of (Tf, fs) through the operator (√w
    conjugation, scale and shift) equals jax.vjp's, on finite differences,
    nested JVPs, the forward engine and Hutchinson on shared probes; by
    default Tf carries no graph and fs does."""
    eps, mode, probes = LAPLACIANS[lap]
    pair = _Pair(eps=eps, mode=mode, probes=probes, monkeypatch=monkeypatch)
    x = _x(3)
    rng = np.random.default_rng(9)
    cot_T, cot_f = rng.normal(size=(B, L)), rng.normal(size=(B, L))
    with jax.enable_x64(True):
        def fwd(p):
            return pair.jop(lambda xx: pair.japply(p, xx), jnp.asarray(x), pair.jimp)

        (jT, jf), vjp = jax.vjp(fwd, jax.tree.map(jnp.asarray, pair.jparams))
        jg = params_from_jax_f64(vjp((jnp.asarray(cot_T), jnp.asarray(cot_f)))[0])
    Tf, fs = pair.op(pair.model, torch.as_tensor(x), pair.imp, with_graph=True)
    _close(Tf, np.asarray(jT), "Tf")
    _close(fs, np.asarray(jf), "fs")
    names = list(pair.params)
    grads = torch.autograd.grad([Tf, fs], [pair.params[k] for k in names],
                                [torch.as_tensor(cot_T), torch.as_tensor(cot_f)],
                                allow_unused=True, materialize_grads=True)
    for k, g in zip(names, grads):
        _close(g, jg[k], k)
    Tf0, fs0 = pair.op(pair.model, torch.as_tensor(x), pair.imp)
    assert not Tf0.requires_grad and fs0.requires_grad
    _close(Tf0, np.asarray(jT), "Tf without a graph")


def test_fokker_planck_vjp_with_graph_matches_jax():
    """The Fokker–Planck operator under finite differences with a sampling
    density: the VJP through Tf (∇V·∇f and f∇²V) equals jax.vjp's."""
    kw = dict(TINY_MODEL, neigs=3, fourier_append_radial=False, fourier_append_envelopes=())
    jinit, japply = jax_make_wavefunctions(**kw)
    params = jinit(jax.random.key(1))
    model = make_wavefunctions(**kw, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.double()
    jop, _, _ = jax_get_problem("fp", ndim=2, neigs=3, laplacian_eps=0.01)
    op, _, _ = get_problem("fp", ndim=2, neigs=3, laplacian_eps=0.01)
    _, jimp = jax_get_sampler("gaussian", B, 1, 2, 2.0)
    _, imp = get_sampler("gaussian", B, 1, 2, 2.0, device="cpu")
    x = _x(4)
    cot = np.random.default_rng(2).normal(size=(B, 3))
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        (jT, _), vjp = jax.vjp(lambda p: jop(lambda xx: japply(p, xx), jnp.asarray(x), jimp), jp)
        jg = params_from_jax_f64(vjp((jnp.asarray(cot), jnp.zeros((B, 3))))[0])
    Tf, _ = op(model, torch.as_tensor(x), imp, with_graph=True)
    _close(Tf, np.asarray(jT), "Tf")
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(Tf, list(model.parameters()), torch.as_tensor(cot))
    for k, g in zip(names, grads):
        _close(g, jg[k], k)


# -- refusals ---------------------------------------------------------------------

def test_refusals_name_their_items(monkeypatch):
    """Nothing of SpIN and SpINx is refused now (a tp mesh axis runs too:
    tests/test_torch_tp_spin.py).  A graph through Tf on the forward engine
    or the Hutchinson estimator runs and gives the default route's values
    with a graph; check_ported passes SpIN and SpINx on every Laplacian and
    on a tp axis (two ranks, through a stand-in rank count);
    loss_and_grad_kernel runs on a kernel operator."""
    model = make_wavefunctions(**TINY_MODEL, device="cpu")
    x = torch.as_tensor(_x(0), dtype=torch.float32)
    for kw in (dict(laplacian_eps=-1.0), dict(laplacian_eps=-1.0, laplacian_probes=2)):
        op, _, _ = get_problem("sch", "hydrogen", 2, L, **kw)
        Tf, fs = op(model, x, generator=torch.Generator().manual_seed(0), with_graph=True)
        assert Tf.requires_grad and fs.requires_grad
        Tf0, fs0 = op(model, x, generator=torch.Generator().manual_seed(0))
        assert not Tf0.requires_grad
        assert torch.equal(Tf0, Tf.detach()) and torch.equal(fs0, fs.detach())
    for name in ("spin", "spinx"):
        for kw in (dict(laplacian_eps=-1.0), dict(laplacian_probes=2),
                   dict(laplacian_eps=-1.0, laplacian_mode="jvp", laplacian_probes=2)):
            pde.check_ported(config.PDEConfig(loss=config.LossConfig(name=name), **kw))
        with monkeypatch.context() as m:
            m.setattr(mesh_module, "_world_size", lambda: 2)
            pde.check_ported(config.PDEConfig(loss=config.LossConfig(name=name), mesh="tp=2"))
        method = get_evd_method(name, model, L)
        params = dict(model.named_parameters())
        loss, grads, _, _ = method.loss_and_grad_kernel(
            params, method.init_state(params), x,
            lambda lm: KernelOperator(lambda a, b: torch.exp(-torch.cdist(a, b) ** 2), lm),
            split_batch=True)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())


def test_factories_take_the_jax_defaults():
    model = make_wavefunctions(**TINY_MODEL, device="cpu")
    for name, cls in (("spin", SpIN), ("spinx", SpINx)):
        jm = jax_get_evd_method(name, lambda p, x: x, L)
        tm = get_evd_method(name, model, L)
        assert isinstance(tm, cls) and tm.name == jm.name == name
        assert tm.decay == jm.decay == 0.01 and tm.neigs == L
        assert get_evd_method(name, model, L, decay=0.5).decay == 0.5


# -- the JAX state carried across --------------------------------------------------

def test_jax_state_converts_and_the_next_step_agrees():
    """A JAX SpIN state after one step converts to the port's (j_avg
    flattened, the towers' diagonal blocks kept), and the next step from
    it matches JAX's next step; an off-diagonal block that is not zero is
    refused."""
    pair = _Pair()
    _, _, jstate, _ = pair.jax_step(None, _x(0))
    state = method_state_from_jax(jstate, per_mode=pair.tm.per_mode, dtype=torch.float64)
    _assert_spin_state(pair, state, jstate)
    jl, jg, jstate2, _ = pair.jax_step(jstate, _x(1))
    tl, tg, state, _ = pair.port_step(state, _x(1))
    _close(tl, jl, "loss")
    for k, w in jg.items():
        _close(tg[k], w, k)
    _assert_spin_state(pair, state, jstate2)
    broken = copy.deepcopy(jstate)
    broken["j_avg"]["base"]["ws"][0][0, 1, 2] += 1.0
    with pytest.raises(ValueError, match="off the diagonal"):
        method_state_from_jax(broken, per_mode=pair.tm.per_mode)


# -- the CLI ------------------------------------------------------------------------

def _cli_cfg(log_dir, name, **kw):
    base = dict(log_dir=str(log_dir), device="cpu", seed=1, neigs=L,
                mlp_hidden_dims="8,8", batch_size=32, lim=4.0, val_eps=0.5,
                num_iters=4, print_freq=2, eval_freq=2, lr=1e-3, parallel=True,
                apply_boundary=False, use_fourier_feature=True, fourier_mapping_size=8,
                fourier_scale=0.1, operator_scale=10.0, laplacian_eps=0.01,
                loss=config.LossConfig(name=name, spin=config.SpINOpts(decay=0.1)))
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


@pytest.mark.parametrize("name", ["spin", "spinx"])
def test_cli_trains(tmp_path, name):
    """--loss spin|spinx through cli.pde.main on the CPU (finite
    differences, per-mode towers): finite eigenvalues at both evals, a
    checkpoint at each, and the state moved: SpIN's compact j_avg, SpINx's
    weights refreshed after each eval."""
    ts, eigvals, _ = pde.main(_cli_cfg(tmp_path, name))
    assert int(ts.step) == 4 and len(eigvals) == 2
    assert all(np.isfinite(e).all() for e in eigvals)
    assert len(list(tmp_path.rglob("ckpt_*"))) == 2
    state = ts.method_state
    if name == "spin":
        assert all(j.any() for j in state["j_avg"].values())
        assert state["j_avg"]["base.ws.0"].shape == (L,) + ts.params["base.ws.0"].shape
    else:
        assert torch.isfinite(state["weights"]).all() and not (state["weights"] == 1).all()


def test_cli_spin_resume_reproduces_the_straight_run(tmp_path):
    """Two SpIN blocks straight equal the first block's checkpoint,
    --resume and one more block, bit for bit, j_avg included."""
    ts_a, ev_a, _ = pde.main(_cli_cfg(tmp_path / "a", "spin"))
    run_a = next(r for r, _, files in os.walk(tmp_path / "a") if "stats.npz" in files)
    run_b = run_a.replace(str(tmp_path / "a"), str(tmp_path / "b"))
    os.makedirs(run_b)
    shutil.copy(os.path.join(run_a, "ckpt_2"), run_b)
    ts_b, ev_b, _ = pde.main(_cli_cfg(tmp_path / "b", "spin", resume=True))
    _assert_trees_equal(state_tree(ts_a), state_tree(ts_b))
    np.testing.assert_array_equal(ev_a[-1], ev_b[-1])


def test_driver_refreshes_after_each_checkpoint(tmp_path):
    """train_operator calls spinx_refresh after checkpoint_fn at every eval
    with a generator seeded from (seed, iteration, REFRESH_STREAM), and
    raises where a refresh replaced a tensor of the state."""
    cfg = _cli_cfg(tmp_path, "spinx")
    run = pde.build(cfg)
    kw = dict(importance_train=run.importance_train, importance_val=run.importance_val,
              val_batches=run.val_batches, eval_freq=2, print_freq=2, seed=cfg.seed)
    events = []
    train_operator(run.method, run.operator, run.sample, run.optimizer, run.model, 4,
                   checkpoint_fn=lambda ts, it, out: events.append(("checkpoint", it)),
                   spinx_refresh=lambda ts, gen: events.append(("refresh", gen.initial_seed())),
                   **kw)
    assert events == [("checkpoint", 2), ("refresh", block_seed(cfg.seed, 2, REFRESH_STREAM)),
                      ("checkpoint", 4), ("refresh", block_seed(cfg.seed, 4, REFRESH_STREAM))]

    def rebinds(ts, gen):
        ts.method_state["weights"] = torch.ones(L + 1)

    with pytest.raises(RuntimeError, match="replaced a tensor"):
        train_operator(run.method, run.operator, run.sample, run.optimizer, run.model, 2,
                       spinx_refresh=rebinds, **kw)
