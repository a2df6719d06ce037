"""The port's Hutchinson Laplacian: probes through the forward engine, the
``needs_key`` operators that take a probe generator, and the train step
that binds one.

The l channel on shared probes (made with numpy and handed to both
packages) is held to JAX's ``_run`` within 1e-5 of its largest entry
(j within the engine tests' 3e-5 on gradients);
the estimator's mean over draws to the exact operator (ported from
tests/test_hutchinson_training.py); and the train step's sample stream to
the exact operator's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.ops.forward_laplacian import _run as jax_run
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_evd
from neuralsvd_tpu_torch.models.mlp import MLP
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.base import OperatorWrapper
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.operators.schrodinger import (
    NegativeHamiltonian,
    harmonic_oscillator_potential,
)
from neuralsvd_tpu_torch.ops import forward_laplacian as engine
from neuralsvd_tpu_torch.training.optimizers import torch_rmsprop
from neuralsvd_tpu_torch.training.train_operator import (
    PROBE_STREAM,
    block_seed,
    make_train_step,
)
from neuralsvd_tpu_torch.training.train_state import init_train_state

MIX = (0.5, 2.0, 6.0, 16.0)
SMALL = dict(ndim=2, neigs=4, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
             parallel=True, use_fourier_feature=True, fourier_mapping_size=8,
             fourier_scale=0.5, fourier_append_radial=True,
             fourier_append_envelopes=(2.0, 2 / 3), apply_boundary=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


@pytest.fixture(scope="module")
def carried():
    jinit, japply = jax_make_wavefunctions(**SMALL)
    params = jinit(jax.random.key(0))
    model = make_wavefunctions(**SMALL, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (lambda x: japply(params, x)), model


@pytest.mark.parametrize("conjugated", [False, True])
def test_l_channel_on_shared_probes_matches_jax(carried, conjugated):
    """Three Rademacher probes from numpy seed both engines' j channel:
    the l channel (Σ_k r_kᵀ H r_k) agrees within 1e-5 of its largest
    entry, j within the engine tests' gradient tolerance (3e-5), with and
    without √w conjugation."""
    jf, model = carried
    rng = np.random.default_rng(5)
    x = (rng.choice(MIX, size=(24, 1)) * rng.normal(size=(24, 2))).astype(np.float32)
    probes = rng.choice([-1.0, 1.0], size=(3, 24, 2)).astype(np.float32)
    if conjugated:
        _, jimp = jax_get_sampler("gaussian_mixture", 8, 1, 2, MIX)
        _, timp = get_sampler("gaussian_mixture", 8, 1, 2, MIX, device="cpu")
        jg = lambda xx: jnp.sqrt(jimp(xx)) * jf(xx)  # noqa: E731
        tg = lambda xx: torch.sqrt(timp(xx)) * model(xx)  # noqa: E731
    else:
        jg, tg = jf, model
    out = jax_run(jg, jnp.asarray(x), jnp.asarray(probes))
    engine.fallback_rule.calls = 0
    v, j, l = engine.propagate(tg, torch.as_tensor(x), torch.as_tensor(probes))
    assert engine.fallback_rule.calls == 0
    assert _rel(out.v, v) < 1e-6
    assert _rel(out.j, j) < 3e-5
    assert _rel(out.l, l) < 1e-5


def test_estimate_is_the_l_channel_of_its_probes(carried):
    """hutchinson_laplacian is the engine's l channel over its probes,
    divided by their number; the probes are ±1."""
    _, model = carried
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(16, 2)).astype(np.float32))
    lap, fs = engine.hutchinson_laplacian(model, x, torch.Generator().manual_seed(3), 5)
    r = engine.rademacher((5, 16, 2), torch.Generator().manual_seed(3), x.dtype, x.device)
    assert set(r.unique().tolist()) == {-1.0, 1.0}
    v, _, l = engine.propagate(model, x, r)
    assert torch.equal(lap, l / 5) and torch.equal(fs, v)


def test_diagonal_hessian_is_exact_and_gaussian_converges():
    """f = |x|²: H = 2I, so rᵀHr = 2D for every Rademacher draw; the
    Gaussian's Laplacian (|x|² - D)·f is estimated within 15% at 256
    probes (ported from tests/test_forward_laplacian.py)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, 5)).astype(np.float32))
    lap, fs = engine.hutchinson_laplacian(lambda xx: torch.sum(xx ** 2, -1, keepdim=True), x,
                                          torch.Generator().manual_seed(0), 1)
    np.testing.assert_allclose(lap.numpy(), 10.0, rtol=1e-5)
    np.testing.assert_allclose(fs.numpy(), torch.sum(x ** 2, -1, keepdim=True).numpy(),
                               rtol=1e-6)
    x = torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32))
    g = lambda xx: torch.exp(-0.5 * torch.sum(xx ** 2, -1, keepdim=True))  # noqa: E731
    est, fs = engine.hutchinson_laplacian(g, x, torch.Generator().manual_seed(1), 256)
    truth = (torch.sum(x ** 2, -1, keepdim=True) - 3) * fs
    err = (est - truth).abs().mean() / truth.abs().mean()
    assert err < 0.15, err


@pytest.fixture(scope="module")
def mlp_problem():
    model = MLP([3, 16, 16, 2], "softplus", generator=torch.Generator().manual_seed(0))
    op = NegativeHamiltonian(local_potential_ftn=harmonic_oscillator_potential,
                             laplacian_eps=-1.0, laplacian_probes=4)
    return model, OperatorWrapper(op, scale=1.0, shift=4.0)


def test_operator_unbiased_vs_exact(mlp_problem):
    """E over draws of the keyed operator -> the key-less call, which is
    the exact engine (ported from tests/test_hutchinson_training.py:35)."""
    model, op = mlp_problem
    assert op.needs_key
    x = torch.randn((32, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        Tf_exact, fs_exact = op(model, x)
        Tf_exact2, _ = op(model, x)
        assert torch.equal(Tf_exact, Tf_exact2)
        draws = [op(model, x, generator=torch.Generator().manual_seed(k))[0]
                 for k in range(64)]
        assert not torch.allclose(draws[0], draws[1])
        _, fs = op(model, x, generator=torch.Generator().manual_seed(99))
    np.testing.assert_allclose(fs.numpy(), fs_exact.numpy(), rtol=1e-6)
    mean = torch.stack(draws).mean(0)
    err = (mean - Tf_exact).abs().mean() / Tf_exact.abs().mean()
    assert err < 0.08, err


def test_train_step_binds_probes_and_keeps_the_sample_stream(mlp_problem):
    """make_train_step gives a needs_key operator a probe generator of its
    own, seeded once from the step generator's seed (it then advances from
    step to step; the driver's blocks seed it at every block start): the
    step runs with a finite loss, repeats for one seed and moves with
    another, and draws the same batches as the exact operator's step."""
    model, op = mlp_problem
    exact = OperatorWrapper(NegativeHamiltonian(
        local_potential_ftn=harmonic_oscillator_potential, laplacian_eps=-1.0),
        scale=1.0, shift=4.0)
    assert not exact.needs_key
    method = NestedLoRA(model, neigs=2, sequential=True)
    opt = torch_rmsprop(1e-3)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    seen = []

    def sampler(gen):
        x = torch.randn((64, 3), generator=gen)
        seen.append(x)
        return x

    def run(operator, seed, steps=2):
        model.load_state_dict(start)
        step = make_train_step(method, operator, opt, sampler)
        ts = init_train_state(model, opt, method)
        gen = torch.Generator().manual_seed(seed)
        seen.clear()
        losses = [float(step(ts, gen)[1]["loss"]) for _ in range(steps)]
        return losses, [x.clone() for x in seen]

    l1, x1 = run(op, 1)
    l2, _ = run(op, 1)
    l3, _ = run(op, 2)
    le, xe = run(exact, 1)
    assert np.isfinite(l1).all() and l1 == l2 and l1 != l3
    assert all(torch.equal(a, b) for a, b in zip(x1, xe)) and len(x1) == 2
    assert l1[0] != le[0]  # the probes, not the batch, differ
    assert (block_seed(1, 0, PROBE_STREAM) != block_seed(1, 1, PROBE_STREAM)
            != block_seed(2, 1, PROBE_STREAM) != block_seed(2, 1))


def test_spectrum_eval_takes_the_exact_engine(mlp_problem):
    """compute_spectrum_evd passes no generator: the probe operator gives
    the exact operator's numbers."""
    model, op = mlp_problem
    exact = OperatorWrapper(NegativeHamiltonian(
        local_potential_ftn=harmonic_oscillator_potential, laplacian_eps=-1.0),
        scale=1.0, shift=4.0)
    x = torch.randn((32, 3), generator=torch.Generator().manual_seed(4))
    a = compute_spectrum_evd(model, [x], op, device="cpu")
    b = compute_spectrum_evd(model, [x], exact, device="cpu")
    for k in ("cov", "quad", "eigvals"):
        np.testing.assert_array_equal(a[k], b[k])


def test_get_problem_probes_need_a_key():
    """laplacian_probes reaches the Hamiltonian (ported from
    tests/test_hutchinson_training.py:145)."""
    op, _, _ = get_problem(problem="sch", potential_type="harmonic_oscillator", ndim=2,
                           neigs=3, laplacian_eps=-1.0, laplacian_probes=2,
                           operator_shift=8.0)
    assert op.needs_key
    op2, _, _ = get_problem(problem="sch", potential_type="harmonic_oscillator", ndim=2,
                            neigs=3, laplacian_eps=-1.0, operator_shift=8.0)
    assert not op2.needs_key
