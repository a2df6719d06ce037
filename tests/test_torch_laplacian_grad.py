"""The exact Laplacian's engines with an autograd graph: the port's
forward-Laplacian engine and Hutchinson estimator run in grad mode
(``with_graph=True``) against ``jax.grad`` through the JAX engine, and
against the port's nested JVPs taken in grad mode.

Same numpy inputs and, through ``convert.params_from_jax``, the same
weights in both packages.  Parameter gradients at the JAX tests'
tolerance: rtol 1e-4, atol 1e-6 of the largest entry; values and losses at
rtol 1e-5.  The default (no-graph) route must give the same values bit for
bit and carry no graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.ops.forward_laplacian import _run as jax_run
from neuralsvd_tpu.ops.forward_laplacian import forward_laplacian as jax_forward
from neuralsvd_tpu_torch.convert import _named_leaves, params_from_jax
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.diff_ops import _nested_jvp_laplacian
from neuralsvd_tpu_torch.ops import forward_laplacian as engine

# the JAX engine test's grad case (tests/test_forward_laplacian.py:69-91):
# ParallelMLP on Fourier features, √w conjugation by a Gaussian density
TOWERS = dict(ndim=2, neigs=4, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
              parallel=True, use_fourier_feature=True, fourier_mapping_size=8,
              fourier_scale=1.0, apply_boundary=False)
# a shared trunk on the raw input, for the function without a rule
TRUNK = dict(ndim=2, neigs=3, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
             parallel=False, use_fourier_feature=False, apply_boundary=False)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6


def _carried(kw, seed):
    jinit, japply = jax_make_wavefunctions(**kw)
    params = jinit(jax.random.key(seed))
    model = make_wavefunctions(**kw, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, japply, model


def _x(n=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


def _close_grads(got, want):
    """{name: tensor} against {name: array}: rtol 1e-4, atol 1e-6 of the
    largest entry of each."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max(), err_msg=k)


def _port_grads(model, loss):
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


def _jax_grads(tree):
    return {k: np.asarray(v) for k, v in _named_leaves(tree)}


def _gauss_imp(xp):
    """The standard 2D Gaussian density in ``xp`` (jnp or torch)."""
    keep = {"keepdims": True} if xp is jnp else {"keepdim": True}

    def imp(x):
        return xp.exp(-0.5 * xp.sum(x ** 2, -1, **keep)) / (2 * np.pi)
    return imp


def _loss(lap, grad, fs, sum_fn):
    """A loss on all three channels: Σ lap·fs + Σ grad²/10."""
    return sum_fn(lap * fs) + 0.1 * sum_fn(grad * grad)


def test_forward_engine_grad_matches_jax_and_nested_jvps():
    """jax.grad of a loss on (l, j, v) through the JAX engine, under √w
    conjugation, against torch.autograd.grad through the port's engine in
    grad mode and through nested JVPs in grad mode."""
    params, japply, model = _carried(TOWERS, 1)
    x = _x()
    jimp, timp = _gauss_imp(jnp), _gauss_imp(torch)

    def jloss(p):
        g = lambda xx: jnp.sqrt(jimp(xx)) * japply(p, xx)  # noqa: E731
        lap, grad, fs = jax_forward(g, jnp.asarray(x), return_grad=True)
        return _loss(lap, grad, fs, jnp.sum)

    jl, jg = jax.value_and_grad(jloss)(params)
    g = lambda xx: torch.sqrt(timp(xx)) * model(xx)  # noqa: E731
    engine.fallback_rule.calls = 0
    lap, grad, fs = engine.forward_laplacian(g, torch.as_tensor(x), return_grad=True,
                                             with_graph=True)
    assert engine.fallback_rule.calls == 0
    assert lap.requires_grad and grad.requires_grad and fs.requires_grad
    loss = _loss(lap, grad, fs, torch.sum)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    got = _port_grads(model, loss)
    _close_grads(got, _jax_grads(jg))

    # nested JVPs in grad mode (reverse over forward)
    lap2, grads2 = _nested_jvp_laplacian(g, torch.as_tensor(x))
    loss2 = _loss(lap2, torch.movedim(grads2, 0, -1), g(torch.as_tensor(x)), torch.sum)
    _close_grads(got, {k: v.numpy() for k, v in _port_grads(model, loss2).items()})


def test_default_route_has_no_graph_and_the_same_bits():
    """Without ``with_graph`` the engine runs under no_grad (no graph), and
    its values equal the grad-mode run's bit for bit."""
    _, _, model = _carried(TOWERS, 2)
    x = torch.as_tensor(_x(seed=3))
    plain = engine.forward_laplacian(model, x, return_grad=True)
    graph = engine.forward_laplacian(model, x, return_grad=True, with_graph=True)
    for a, b in zip(plain, graph):
        assert not a.requires_grad and b.requires_grad
        assert torch.equal(a, b.detach())


def test_fallback_rule_keeps_a_graph_in_grad_mode():
    """torch.prod has no rule: the fallback (nested torch.func.jvp) runs
    in grad mode and its Laplacian's parameter gradients equal nested JVPs'
    in grad mode and jax.grad through the JAX engine's fallback."""
    params, japply, model = _carried(TRUNK, 4)
    x = _x(seed=5)

    def jloss(p):
        f = lambda xx: jnp.prod(japply(p, xx), -1, keepdims=True)  # noqa: E731
        lap, _, fs = jax_forward(f, jnp.asarray(x))
        return jnp.sum(lap) + jnp.sum(fs * fs)

    jl, jg = jax.value_and_grad(jloss)(params)
    f = lambda xx: torch.prod(model(xx), -1, keepdim=True)  # noqa: E731
    engine.fallback_rule.calls = 0
    lap, _, fs = engine.forward_laplacian(f, torch.as_tensor(x), with_graph=True)
    assert engine.fallback_rule.calls > 0
    loss = torch.sum(lap) + torch.sum(fs * fs)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    got = _port_grads(model, loss)
    _close_grads(got, _jax_grads(jg))
    lap2, _ = _nested_jvp_laplacian(f, torch.as_tensor(x))
    ref = _port_grads(model, torch.sum(lap2) + torch.sum(f(torch.as_tensor(x)) ** 2))
    _close_grads(got, {k: v.numpy() for k, v in ref.items()})


@pytest.mark.parametrize("conjugated", [False, True])
def test_hutchinson_grad_on_shared_probes_matches_jax(conjugated):
    """Three Rademacher probes from numpy seed both engines: jax.grad of a
    loss on (l, v) through JAX's ``_run`` against the port's engine in grad
    mode; ``hutchinson_laplacian(with_graph=True)`` is that l channel over
    its probes, with a graph, equal to the no-graph estimate."""
    params, japply, model = _carried(TOWERS, 6)
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(12, 2)) * 2.0).astype(np.float32)
    probes = rng.choice([-1.0, 1.0], size=(3, 12, 2)).astype(np.float32)
    jimp, timp = _gauss_imp(jnp), _gauss_imp(torch)

    def jloss(p):
        f = lambda xx: japply(p, xx)  # noqa: E731
        g = (lambda xx: jnp.sqrt(jimp(xx)) * f(xx)) if conjugated else f  # noqa: E731
        out = jax_run(g, jnp.asarray(x), jnp.asarray(probes))
        return jnp.sum(out.l * out.v) / 3

    jl, jg = jax.value_and_grad(jloss)(params)
    g = (lambda xx: torch.sqrt(timp(xx)) * model(xx)) if conjugated else model  # noqa: E731
    v, _, l = engine.propagate(g, torch.as_tensor(x), torch.as_tensor(probes),
                               with_graph=True)
    loss = torch.sum(l * v) / 3
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    _close_grads(_port_grads(model, loss), _jax_grads(jg))

    xt = torch.as_tensor(x)
    est, fs = engine.hutchinson_laplacian(g, xt, torch.Generator().manual_seed(8), 3,
                                          with_graph=True)
    r = engine.rademacher((3, 12, 2), torch.Generator().manual_seed(8), xt.dtype, xt.device)
    v2, _, l2 = engine.propagate(g, xt, r, with_graph=True)
    assert est.requires_grad and fs.requires_grad
    assert torch.equal(est, l2 / 3) and torch.equal(fs, v2)
    plain, _ = engine.hutchinson_laplacian(g, xt, torch.Generator().manual_seed(8), 3)
    assert not plain.requires_grad and torch.equal(plain, est.detach())
