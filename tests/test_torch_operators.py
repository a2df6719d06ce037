"""Port's samplers, Laplacians and Hamiltonians vs the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.operators import ground_truths as jax_gt
from neuralsvd_tpu.operators.diff_ops import batched_fd_laplacian as jax_fd
from neuralsvd_tpu.operators.diff_ops import exact_laplacian as jax_exact
from neuralsvd_tpu.operators.problems import get_problem as jax_get_problem
from neuralsvd_tpu.ops.forward_laplacian import forward_laplacian as jax_forward
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators import ground_truths
from neuralsvd_tpu_torch.operators.diff_ops import batched_fd_laplacian, exact_laplacian
from neuralsvd_tpu_torch.operators.problems import get_problem

MIX = (0.5, 2.0, 6.0, 16.0)
SMALL = dict(ndim=2, neigs=4, mlp_hidden_dims=[16, 16, 16],
             nonlinearity="softplus", parallel=True, use_fourier_feature=True,
             fourier_mapping_size=16, fourier_scale=0.1,
             fourier_append_radial=True, fourier_append_envelopes=(2.0, 2 / 3),
             apply_boundary=False)


def _x(n=48, seed=0):
    rng = np.random.default_rng(seed)
    scales = rng.choice(MIX, size=(n, 1))
    return (scales * rng.normal(size=(n, 2))).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    jinit, japply = jax_make_wavefunctions(**SMALL)
    params = jinit(jax.random.key(0))
    model = make_wavefunctions(**SMALL, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (lambda x: japply(params, x)), model


@pytest.mark.parametrize("mode,scale,weights", [
    ("gaussian", 2.0, None),
    ("gaussian_mixture", MIX, None),
    ("gaussian_mixture", MIX, (4.0, 1.0, 1.0, 2.0)),
])
def test_sampler_densities_match_jax(mode, scale, weights):
    """Same x, same density (float32 logsumexp: rtol 1e-5)."""
    _, jimp = jax_get_sampler(mode, 8, 1, 2, scale, sampling_weights=weights)
    _, timp = get_sampler(mode, 8, 1, 2, scale, sampling_weights=weights,
                          device="cpu")
    x = np.concatenate([_x(), np.zeros((1, 2), np.float32)])
    np.testing.assert_allclose(timp(torch.as_tensor(x)).numpy(),
                               np.asarray(jimp(jnp.asarray(x))), rtol=1e-5)


def test_mixture_sampler_draws_its_density():
    """P(|x| < 1) of a 2D centred-Gaussian mixture is
    Σ_k w_k (1 - exp(-1/(2 s_k²))); 20000 draws hold it within 0.015
    (~5 binomial standard deviations)."""
    n = 20000
    sample, _ = get_sampler("gaussian_mixture", n, 1, 2, MIX, device="cpu")
    x = sample(torch.Generator().manual_seed(0))
    assert x.shape == (n, 2) and x.dtype == torch.float32
    frac = (x.norm(dim=1) < 1.0).float().mean().item()
    expect = np.mean([1 - np.exp(-1 / (2 * s ** 2)) for s in MIX])
    assert abs(frac - expect) < 0.015


def test_exact_laplacian_matches_jax_jvp_and_forward_engine(carried):
    """Nested torch.func JVPs vs JAX's nested JVPs and its forward
    -Laplacian engine (float32 second derivatives: rtol 1e-4, atol 1e-5 of
    the Laplacian's scale)."""
    jf, model = carried
    x = _x()
    lap_j, grad_j, fs_j = jax_exact(jf, jnp.asarray(x), return_grad=True)
    lap_f, _, _ = jax_forward(jf, jnp.asarray(x))
    with torch.no_grad():
        lap_t, grad_t, fs_t = exact_laplacian(model, torch.as_tensor(x),
                                              return_grad=True)
    scale = np.abs(np.asarray(lap_j)).max()
    for ref in (lap_j, lap_f):
        np.testing.assert_allclose(lap_t.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5 * scale)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(grad_j)).max())
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(fs_j)).max())


def test_fd_laplacian_matches_jax(carried):
    """Central differences at eps = 0.1 amplify f32 rounding by 1/eps²:
    atol 1e-3 of the function's scale."""
    jf, model = carried
    x = _x()
    lap_j, grad_j, fs_j = jax_fd(jf, jnp.asarray(x), 0.1, return_grad=True)
    with torch.no_grad():
        lap_t, grad_t, fs_t = batched_fd_laplacian(model, torch.as_tensor(x), 0.1,
                                                   return_grad=True)
    fscale = np.abs(np.asarray(fs_j)).max()
    np.testing.assert_allclose(lap_t.numpy(), np.asarray(lap_j), rtol=1e-4,
                               atol=1e-3 * fscale)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=1e-4,
                               atol=1e-5 * fscale)


@pytest.mark.parametrize("potential,eps,scale,shift,port_mode", [
    pytest.param("hydrogen", -1.0, 100.0, 0.0, "jvp", id="hydrogen--1.0-100.0-0.0"),
    pytest.param("hydrogen", -1.0, 1.0, 3.0, "jvp", id="hydrogen--1.0-1.0-3.0"),
    pytest.param("harmonic_oscillator", 0.1, 1.0, 10.0, "jvp",
                 id="harmonic_oscillator-0.1-1.0-10.0"),
    pytest.param("hydrogen", -1.0, 100.0, 0.0, "forward", id="hydrogen-forward"),
    pytest.param("harmonic_oscillator", -1.0, 1.0, 10.0, "forward",
                 id="harmonic_oscillator-forward"),
])
def test_hamiltonian_matches_jax(carried, potential, eps, scale, shift, port_mode):
    """(Tf, fs) of -H under √w conjugation and the affine wrapper, the
    port's Laplacian taken by nested JVPs or by its forward engine, against
    JAX's nested-JVP path and, for the exact Laplacian, its forward engine
    too (rtol 1e-4, atol 1e-5 of Tf's scale: float32 Laplacian)."""
    jf, model = carried
    x = _x()
    _, jimp = jax_get_sampler("gaussian_mixture", 8, 1, 2, MIX)
    _, timp = get_sampler("gaussian_mixture", 8, 1, 2, MIX, device="cpu")
    kw = dict(problem="sch", potential_type=potential, ndim=2, neigs=4,
              laplacian_eps=eps, operator_scale=scale, operator_shift=shift)
    top, tgt, _ = get_problem(**kw, laplacian_mode=port_mode)
    Tf_t, fs_t = top(model, torch.as_tensor(x), timp)
    modes = ("jvp", "forward") if eps <= 0 else ("jvp",)
    for mode in modes:
        jop, jgt, _ = jax_get_problem(**kw, laplacian_mode=mode)
        Tf_j, fs_j = jop(jf, jnp.asarray(x), jimp)
        np.testing.assert_allclose(Tf_t.numpy(), np.asarray(Tf_j), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(Tf_j)).max())
        np.testing.assert_allclose(fs_t.detach().numpy(), np.asarray(fs_j),
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(fs_j)).max())
    np.testing.assert_allclose(tgt, jgt)
    assert top.singular_at_origin == jop.singular_at_origin == (potential == "hydrogen")


def test_tf_carries_no_gradient_and_fs_does(carried):
    _, model = carried
    _, timp = get_sampler("gaussian_mixture", 8, 1, 2, MIX, device="cpu")
    op, _, _ = get_problem("sch", "hydrogen", 2, 4, laplacian_eps=-1.0,
                           laplacian_mode="jvp", operator_scale=100.0,
                           operator_shift=1.0)
    Tf, fs = op(model, torch.as_tensor(_x()), timp)
    assert not Tf.requires_grad
    assert fs.requires_grad
    grads = torch.autograd.grad(fs.sum(), list(model.parameters()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


# ids as when the forward engine and the Hutchinson probes were the first
# two cases; kw2, the cosine potential, and kw3, the Fokker–Planck
# problem, are ported now and match JAX
@pytest.mark.parametrize("kw,ported", [
    (dict(potential_type="cosine", laplacian_mode="jvp"), True),
    (dict(problem="fp"), True),
], ids=["kw2", "kw3"])
def test_unported_operator_options_raise(carried, kw, ported):
    """An unported problem raises, naming its ROADMAP item; a ported one
    gives JAX's (Tf, fs) (rtol 1e-4, atol 1e-5 of Tf's scale) and ground
    truth (exactly)."""
    if not ported:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_problem(**kw)
        return
    jf, model = carried
    x = _x()
    kw = dict(kw, ndim=2, neigs=4, laplacian_eps=-1.0)
    jop, jgt, _ = jax_get_problem(**kw)
    top, tgt, _ = get_problem(**kw)
    Tf_j, fs_j = jop(jf, jnp.asarray(x))
    Tf_t, fs_t = top(model, torch.as_tensor(x))
    np.testing.assert_allclose(Tf_t.numpy(), np.asarray(Tf_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(Tf_j)).max())
    np.testing.assert_allclose(fs_t.detach().numpy(), np.asarray(fs_j), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(fs_j)).max())
    np.testing.assert_array_equal(tgt, jgt)


def test_unknown_sampler_mode_raises_naming_it():
    """Every mode of the JAX sampler is ported; a mode neither package
    has raises, naming it."""
    with pytest.raises(NotImplementedError, match="uniform_x"):
        get_sampler("uniform_x", 8, 1, 2, 1.0, device="cpu")


def test_ground_truth_copies_match_jax():
    for neigs in (1, 5, 16, 36):
        np.testing.assert_array_equal(
            ground_truths.Hydrogen2D().get_eigvals(neigs),
            jax_gt.Hydrogen2D().get_eigvals(neigs))
        np.testing.assert_array_equal(
            ground_truths.HarmonicOscillator(ndim=2).get_eigvals(neigs),
            jax_gt.HarmonicOscillator(ndim=2).get_eigvals(neigs))
    np.testing.assert_array_equal(ground_truths.Hydrogen2D().get_degeneracy(16),
                                  jax_gt.Hydrogen2D().get_degeneracy(16))
    r = np.linspace(0.1, 5.0, 7)
    th = np.linspace(-3.0, 3.0, 7)
    for n, l in ((0, 0), (1, -1), (2, 2)):
        np.testing.assert_array_equal(ground_truths.Hydrogen2D().eigfunc(n, l, r, th),
                                      jax_gt.Hydrogen2D().eigfunc(n, l, r, th))


@pytest.mark.parametrize("qnums", [(1, 0, 0), (2, 1, -1), (3, 2, 1), (4, 3, -2)])
def test_hydrogen_3d_eigenfunctions_match_jax(qnums):
    """The 3D hydrogen eigenfunction (n, l, m) and its real spherical
    harmonic on a float64 grid of spherical coordinates (from Cartesian
    points through cartesian_to_spherical), rtol 1e-6 of the largest."""
    n, l, m = qnums
    rng = np.random.default_rng(n)
    xyz = rng.normal(size=(3, 200)) * 2.0
    r, th, phi = ground_truths.cartesian_to_spherical(*xyz)
    for got, want in zip((r, th, phi), jax_gt.cartesian_to_spherical(*xyz)):
        np.testing.assert_array_equal(got, want)
    want = jax_gt.Hydrogen3D(charge=1.5).eigfunc(n, l, m, r, th, phi)
    got = ground_truths.Hydrogen3D(charge=1.5).eigfunc(n, l, m, r, th, phi)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(ground_truths.real_sph_harm_3d(m, l, th, phi),
                               jax_gt.real_sph_harm_3d(m, l, th, phi), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("ells", [(0, 0), (1, 2), (-2, 3), (1, 1, 2), (-1, 2, 4)])
def test_hyperspherical_harmonics_match_jax(ells):
    """sph_harm (complex) and real_sph_harm on S^{D-1}, D = len(ells) + 1,
    and legendre_p at a non-integer degree and order, on float64 angle
    grids: rtol 1e-6 of the largest."""
    rng = np.random.default_rng(len(ells))
    ths = np.concatenate([rng.uniform(-np.pi, np.pi, (1, 50)),
                          rng.uniform(0.05, np.pi - 0.05, (len(ells) - 1, 50))])
    for fn in ("sph_harm", "real_sph_harm"):
        want = getattr(jax_gt, fn)(list(ells), ths)
        got = getattr(ground_truths, fn)(list(ells), ths)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    z = np.cos(ths[-1])
    np.testing.assert_allclose(ground_truths.legendre_p(-1.5, 2.5, z),
                               jax_gt.legendre_p(-1.5, 2.5, z), rtol=1e-6)
