"""The port's forward-Laplacian engine against JAX's, and against closed
forms and the port's own nested-JVP Laplacian.

Same numpy inputs and, through ``convert.params_from_jax``, the same
weights go through ``neuralsvd_tpu.ops.forward_laplacian`` and
``neuralsvd_tpu_torch.ops.forward_laplacian``.  Tolerances are the JAX
engine tests' (tests/test_forward_laplacian.py): ``_rel`` (largest error
over the largest entry) under 3e-6 on values, 3e-5 on gradients and
Laplacians; 1e-6 / 1e-5 / 1e-5 where the JAX tests use those.  Every
module on the E4 path must run without the fallback rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.methods.nestedlora import NestedLoRA as JaxNestedLoRA
from neuralsvd_tpu.models.fourier import make_fourier_features as jax_fourier
from neuralsvd_tpu.models.mlp import make_parallel_mlp as jax_parallel_mlp
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.operators.diff_ops import VectorizedLaplacian as JaxVectorizedLaplacian
from neuralsvd_tpu.operators.problems import get_problem as jax_get_problem
from neuralsvd_tpu.ops.forward_laplacian import forward_laplacian as jax_forward
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.models.fourier import FourierFeatures
from neuralsvd_tpu_torch.models.mlp import ParallelMLP
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.diff_ops import VectorizedLaplacian, exact_laplacian
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.ops import forward_laplacian as engine
from neuralsvd_tpu_torch.ops.forward_laplacian import forward_laplacian

MIX = (0.5, 2.0, 6.0, 16.0)
# the JAX engine test's hydrogen-features wavefunction (L 6, 16-16 towers,
# 8 Fourier maps, radial + three envelopes)
HYDROGEN = dict(ndim=2, neigs=6, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
                parallel=True, use_fourier_feature=True, fourier_mapping_size=8,
                fourier_scale=1.0, fourier_append_radial=True,
                fourier_append_envelopes=(2.0, 0.667, 0.4), apply_boundary=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


def _x(n=8, d=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.choice(MIX, size=(n, 1)) * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture
def no_fallback():
    """The test's engine calls must not reach the fallback rule."""
    engine.fallback_rule.calls = 0
    yield
    assert engine.fallback_rule.calls == 0


@pytest.fixture(scope="module")
def hydrogen():
    jinit, japply = jax_make_wavefunctions(**HYDROGEN)
    params = jinit(jax.random.key(0))
    model = make_wavefunctions(**HYDROGEN, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (lambda x: japply(params, x)), model


def _assert_engines_agree(jf, tf, x, tol=(3e-6, 3e-5, 3e-5)):
    lj, gj, vj = jax_forward(jf, jnp.asarray(x), return_grad=True)
    lt, gt, vt = forward_laplacian(tf, torch.as_tensor(x), return_grad=True)
    assert _rel(vj, vt) < tol[0]
    assert _rel(gj, gt) < tol[1]
    assert _rel(lj, lt) < tol[2]


def test_wavefunction_matches_jax_engine(hydrogen, no_fallback):
    """The E4 wavefunction at a small width: value, gradient, Laplacian."""
    jf, model = hydrogen
    _assert_engines_agree(jf, model, _x())


def test_conjugated_laplacian_matches_jax(hydrogen, no_fallback):
    """√w conjugation by the gaussian_mixture density through
    VectorizedLaplacian(exact_mode="forward") in both packages."""
    jf, model = hydrogen
    x = _x(48)
    _, jimp = jax_get_sampler("gaussian_mixture", 8, 1, 2, MIX)
    _, timp = get_sampler("gaussian_mixture", 8, 1, 2, MIX, device="cpu")
    lj, gj, fj = JaxVectorizedLaplacian(eps=-1.0, exact_mode="forward")(
        jf, jnp.asarray(x), jimp, return_grad=True)
    with torch.no_grad():
        lt, gt, ft = VectorizedLaplacian(eps=-1.0, exact_mode="forward")(
            model, torch.as_tensor(x), timp, return_grad=True)
    assert _rel(fj, ft) < 3e-6
    assert _rel(gj, gt) < 3e-5
    assert _rel(lj, lt) < 3e-5


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_e4_loss_and_grads_match_jax_on_the_forward_engine(hydrogen, use_pallas,
                                                          no_fallback):
    """The slice as a whole at a small width: the E4 problem (hydrogen,
    operator_scale 100, gaussian_mixture √w conjugation, sequential
    nesting) on the default forward Laplacian in both packages; the
    NestedLoRA loss (rtol 1e-5) and its gradients (rtol 1e-4, atol 1e-6
    of the largest entry) on one batch, through the plain loss and through
    the kernel packaging (whose wrappers take their plain versions on the
    CPU)."""
    jf, model = hydrogen
    x = _x(64, seed=4)
    _, jimp = jax_get_sampler("gaussian_mixture", 64, 1, 2, MIX)
    _, timp = get_sampler("gaussian_mixture", 64, 1, 2, MIX, device="cpu")
    kw = dict(problem="sch", potential_type="hydrogen", ndim=2, neigs=6,
              laplacian_eps=-1.0, operator_scale=100.0)
    jop, _, _ = jax_get_problem(**kw)
    top, _, _ = get_problem(**kw)
    jinit, japply = jax_make_wavefunctions(**HYDROGEN)
    params = jinit(jax.random.key(0))
    jloss, jgrads = JaxNestedLoRA(japply, neigs=6, sequential=True).loss_and_grad(
        params, {}, jnp.asarray(x), jop, jimp)[:2]
    method = NestedLoRA(model, neigs=6, sequential=True, use_pallas=use_pallas)
    loss, grads, _, _ = method.loss_and_grad(dict(model.named_parameters()), {},
                                             torch.as_tensor(x), top, timp)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, ref in params_from_jax(jax.tree.map(np.asarray, jgrads)).items():
        ref = ref.numpy()
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)


def test_fourier_features_match_jax(no_fallback):
    """models/fourier.py: sin/cos, raw, radial sqrt(Σx² + 1e-12) and the
    envelopes exp(-κr), through the engine, at points near the origin too
    (where the radial feature's second derivative grows as 1/r)."""
    kw = dict(input_dim=2, mapping_size=8, scale=1.0, append_raw=True,
              append_radial=True, append_envelopes=(2.0, 0.667), seed=3)
    _, japply = jax_fourier(**kw)
    feats = FourierFeatures(**kw)
    x = np.concatenate([_x(), np.array([[1e-2, -2e-2], [0.3, 1e-3]], np.float32)])
    _assert_engines_agree(lambda xx: japply({}, xx), feats, x)


def test_parallel_mlp_matches_jax(no_fallback):
    """models/mlp.py: the per-mode einsum chain (one stacked product a
    layer), biases on v only, softplus, and the (B, L, O) -> (B, L) tail."""
    jinit, japply = jax_parallel_mlp(input_dim=2, mlp_hidden_dims=[8, 8], num_copies=3,
                                     nonlinearity="softplus", bias=True)
    params = jax.tree.map(np.asarray, jinit(jax.random.key(1)))
    params["bs"] = [b + 0.1 for b in params["bs"]]  # biases are zero at init
    model = ParallelMLP(2, [8, 8], num_copies=3, nonlinearity="softplus", bias=True)
    state = params_from_jax({"base": {"ws": params["ws"], "bs": params["bs"]}})
    model.load_state_dict({k.removeprefix("base."): v for k, v in state.items()})
    _assert_engines_agree(lambda xx: japply(params, xx), model, _x())


@pytest.mark.parametrize("weights", [None, (4.0, 1.0, 1.0, 2.0)])
def test_mixture_density_matches_jax(weights, no_fallback):
    """data/samplers.py: the gaussian_mixture density through the engine
    (logsumexp with the max held constant), and its square root."""
    _, jimp = jax_get_sampler("gaussian_mixture", 8, 1, 2, MIX, sampling_weights=weights)
    _, timp = get_sampler("gaussian_mixture", 8, 1, 2, MIX, sampling_weights=weights,
                          device="cpu")
    x = _x(32)
    _assert_engines_agree(jimp, timp, x)
    _assert_engines_agree(lambda xx: jnp.sqrt(jimp(xx)), lambda xx: torch.sqrt(timp(xx)), x)


def test_matches_nested_jvp_on_the_port(hydrogen, no_fallback):
    """The engine against the port's own nested-JVP Laplacian."""
    _, model = hydrogen
    x = torch.as_tensor(_x(16))
    l1, g1, v1 = exact_laplacian(model, x, return_grad=True)
    l2, g2, v2 = forward_laplacian(model, x, return_grad=True)
    assert _rel(v1.detach(), v2) < 3e-6
    assert _rel(g1.detach(), g2) < 3e-5
    assert _rel(l1.detach(), l2) < 3e-5


def test_gaussian_closed_form(no_fallback):
    """f(x) = exp(-|x|²/2): ∇f = -x f, ∇²f = (|x|² - D) f."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32))
    lap, grad, fs = forward_laplacian(
        lambda xx: torch.exp(-0.5 * torch.sum(xx ** 2, -1, keepdim=True)), x,
        return_grad=True)
    r2 = torch.sum(x ** 2, -1, keepdim=True)
    np.testing.assert_allclose(fs.numpy(), torch.exp(-0.5 * r2).numpy(), rtol=1e-6)
    np.testing.assert_allclose(lap.numpy(), ((r2 - 3) * fs).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), (-x[:, None, :] * fs[..., None]).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fallback_rule_prod():
    """torch.prod has no rule of its own: the exact local nested-JVP rule
    takes it, mixed into the specialized rules, and is counted."""
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 2)).astype(np.float32))

    def f(xx):
        return torch.prod(16.0 - xx ** 2, dim=-1, keepdim=True) * torch.sin(xx[:, :1])

    engine.fallback_rule.calls = 0
    l2, g2, v2 = forward_laplacian(f, x, return_grad=True)
    assert engine.fallback_rule.calls == 1
    l1, g1, v1 = exact_laplacian(f, x, return_grad=True)
    assert _rel(v1, v2) < 1e-6
    assert _rel(g1, g2) < 1e-5
    assert _rel(l1, l2) < 1e-5


def test_piecewise_clamp_where_maximum_match_nested_jvp(no_fallback):
    """clamp, where, maximum, abs: the channels follow the branch the value
    takes, as the nested-JVP path computes."""
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(32, 2)).astype(np.float32))

    def f(xx):
        return torch.where(
            xx[:, :1] > 0.0,
            torch.clamp(xx ** 2, 0.05, 2.0).sum(-1, keepdim=True),
            torch.abs(xx[:, 1:]) * xx[:, :1]) + torch.maximum(xx[:, :1] ** 3, xx[:, 1:])

    l1, g1, v1 = exact_laplacian(f, x, return_grad=True)
    l2, g2, v2 = forward_laplacian(f, x, return_grad=True)
    assert _rel(v1, v2) < 1e-6
    assert _rel(g1, g2) < 1e-5
    assert _rel(l1, l2) < 1e-5


# one function per rule family; each is held to the nested-JVP path
RULE_CASES = {
    "unary": lambda x: (torch.exp(x[:, :1]) * torch.cos(x[:, 1:]) + torch.tanh(x)
                        + torch.sigmoid(x) + torch.log1p(x ** 2) + torch.erf(x)
                        + torch.rsqrt(1.0 + x ** 2) + torch.relu(x) ** 2),
    "softplus_beta": lambda x: torch.nn.functional.softplus(3.0 * x, beta=2.0, threshold=5.0),
    "div_pow": lambda x: (1.0 / (2.0 + x ** 2)) + x / 3.0 + (1.5 + x ** 2) ** 1.5
    - x.pow(3) + torch.square(x) / (1.0 + x[:, :1] ** 2),
    "structural": lambda x: torch.cat(
        [x.reshape(-1, 1, 2).expand(-1, 3, 2).permute(0, 2, 1).flatten(1),
         torch.stack([x[:, 0], x[:, 1] ** 2], dim=-1),
         x.unsqueeze(-1).squeeze(-1).mean(dim=-1, keepdim=True),
         torch.chunk(x, 2, dim=1)[1] * x.transpose(0, 1).T[:, :1],
         torch.stack(list(x.T), dim=1).float().contiguous().clone().view(-1, 2),
         -x.unbind(1)[0][:, None] ** 3], dim=-1),
    "products": lambda x: (torch.einsum("bd,de->be", x, torch.ones(2, 3)) @ torch.ones(3, 2)
                           + torch.nn.functional.linear(x, torch.eye(2), torch.ones(2))
                           + torch.einsum("bd,bd->b", x, x)[:, None]
                           + torch.matmul(x[:, :, None], x[:, None, :]).sum(-1)),
    "logsumexp": lambda x: torch.logsumexp(torch.stack([x, 2 * x, -x ** 2], dim=-1), dim=-1),
}


@pytest.mark.parametrize("name", sorted(RULE_CASES))
def test_rules_match_nested_jvp(name, no_fallback):
    f = RULE_CASES[name]
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(16, 2)).astype(np.float32))
    l1, g1, v1 = exact_laplacian(f, x, return_grad=True)
    l2, g2, v2 = forward_laplacian(f, x, return_grad=True)
    assert _rel(v1, v2) < 1e-6
    assert _rel(g1, g2) < 1e-5
    assert _rel(l1, l2) < 1e-5


def test_in_place_ops_on_a_dual_raise():
    x = torch.zeros(4, 2)

    def f(xx):
        xx.add_(1.0)
        return xx

    with pytest.raises(RuntimeError, match="in-place"):
        forward_laplacian(f, x)


def test_whitened_eval_outputs_take_no_fallback(hydrogen, no_fallback):
    """SpIN's and SpINx's eval outputs, the model whitened by a Cholesky
    factor (``solve_triangular``), through the port's rule against the JAX
    engine (whose ``triangular_solve`` takes its fallback): value,
    gradient and Laplacian at the engine tests' tolerances."""
    jf, model = hydrogen
    rng = np.random.default_rng(11)
    a = rng.normal(size=(6, 6))
    chol = np.linalg.cholesky(a @ a.T / 6 + 0.5 * np.eye(6)).astype(np.float32)
    jchol, tchol = jnp.asarray(chol), torch.as_tensor(chol)
    _assert_engines_agree(
        lambda xx: jax.scipy.linalg.solve_triangular(jchol, jf(xx).T, lower=True).T,
        lambda xx: torch.linalg.solve_triangular(tchol, model(xx).T, upper=False).T, _x())
