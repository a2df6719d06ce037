"""The PDE CLI slice against the JAX package: config, model, samplers,
schedules and the CLI's first eval.

Inputs are numpy arrays from seeded generators (or the JAX init carried
across with ``params_from_jax``); each test states its tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralsvd_tpu.cli import pde as jax_pde
from neuralsvd_tpu.data import samplers as jax_samplers
from neuralsvd_tpu.models import mlp as jax_mlp
from neuralsvd_tpu.models import wavefunctions as jax_wf
from neuralsvd_tpu.training import optimizers as jax_opt
from neuralsvd_tpu.utils import config as jax_config
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data import samplers
from neuralsvd_tpu_torch.methods.spectrum import _accumulate_evd
from neuralsvd_tpu_torch.models.mlp import make_mlp_eigfuncs
from neuralsvd_tpu_torch.models.wavefunctions import dirichlet_box_mask, make_wavefunctions
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.training import optimizers
from neuralsvd_tpu_torch.utils import config

E4_ARGV = ("--potential_type hydrogen --ndim 2 --neigs 16 --parallel true "
           "--apply_boundary false --laplacian_eps -1 --operator_scale 100 "
           "--use_fourier_feature true --fourier_mapping_size 1024 --fourier_scale 0.1 "
           "--fourier_append_radial true --fourier_append_envelopes 2,0.6667,0.4,0.2857 "
           "--sampling_mode gaussian_mixture --sampling_scales 0.5,2,6,16 "
           "--batch_size 512 --optimizer rmsprop --lr 1e-4 --use_lr_scheduler true "
           "--ema_decay 0.995 --neuralsvd.sequential true").split()
README_ARGV = ("--potential_type hydrogen --ndim 2 --neigs 16 --lim 32 "
               "--operator_scale 100 --laplacian_eps 0.1 --use_fourier_feature true "
               "--fourier_mapping_size 256 --fourier_scale 0.1 --mlp_hidden_dims 128,128,128 "
               "--nonlinearity softplus --sampling_mode gaussian --sampling_scale 16 "
               "--batch_size 512 --optimizer rmsprop --lr 1e-4 --num_iters 200000 "
               "--eval_freq 25000").split()
ARGVS = {
    "default": [],
    "e4": E4_ARGV,
    "nestedlora-seq": ["--loss", "nestedlora", "--neuralsvd.sequential", "true"],
    "readme": README_ARGV,
    "neuralef-mesh-probes": ["--loss", "neuralef", "--neuralef.unbiased", "true",
                             "--mesh", "dp=4", "--laplacian_probes", "2",
                             "--laplacian_eps", "-1", "--sort", "true", "--lim", "3.5"],
    "spin-tail": ["--loss", "spin", "--spin.decay", "0.5", "--tail_lr_boost", "3",
                  "--tail_lr_start", "8", "--spike_reject_factor", "25",
                  "--mol_name", "LiH", "--print_local_energies", "yes"],
}
PORT_ONLY = {"device"}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_pde_config_matches_jax(name):
    """Every JAX field parses to the same value and run_name gives the
    same string; the port adds --device only."""
    jcfg = jax_config.parse_pde_config(ARGVS[name])
    cfg = config.parse_pde_config(ARGVS[name])
    got = dataclasses.asdict(cfg)
    assert set(got) - set(dataclasses.asdict(jcfg)) == PORT_ONLY
    assert {k: v for k, v in got.items() if k not in PORT_ONLY} == dataclasses.asdict(jcfg)
    assert config.run_name(cfg) == jax_config.run_name(jcfg)
    assert config.loss_descriptor(cfg) == jax_config.loss_descriptor(jcfg)
    assert cfg.device is None


def test_port_flags():
    cfg = config.parse_pde_config(["--device", "cpu"])
    assert cfg.device == "cpu"
    with pytest.raises(SystemExit):
        config.parse_pde_config(["--cuda_graph", "false"])


def test_lim_pi_is_pi():
    """--lim pi: the JAX parser declares lim a float and exits on "pi"
    (its own cfg.lim == "pi" branch never runs); the port gives π."""
    with pytest.raises(SystemExit):
        jax_config.parse_pde_config(["--lim", "pi"])
    cfg = config.parse_pde_config(["--lim", "pi"])
    assert cfg.lim == np.pi
    jcfg = jax_config.parse_pde_config(["--lim", str(np.pi)])
    assert config.run_name(cfg) == jax_config.run_name(jcfg)


@pytest.mark.parametrize("ndim,lim,eps", [(1, 4.0, 0.5), (2, 3.0, 0.25), (2, np.pi, 0.1)])
def test_make_val_grid_matches_jax(ndim, lim, eps):
    """Grid and batches equal; the uniform importance equal (exactly)."""
    jdata, jbatches, jimp = jax_samplers.make_val_grid(ndim, lim, eps, 64)
    data, batches, imp = samplers.make_val_grid(ndim, lim, eps, 64)
    np.testing.assert_array_equal(data, jdata)
    for a, b in zip(batches(), jbatches(), strict=True):
        np.testing.assert_array_equal(a, b)
    x = data[:10]
    np.testing.assert_array_equal(imp(torch.as_tensor(x)).numpy(),
                                  np.asarray(jimp(jnp.asarray(x))))


def _points(n=256, d=2, scale=4.0, seed=0):
    """Normal points, the first two far outside any box, one at 0."""
    rng = np.random.default_rng(seed)
    x = scale * rng.standard_normal((n, d)).astype(np.float32)
    x[0], x[1], x[2] = 9 * scale, -9 * scale, 0.0
    return x


@pytest.mark.parametrize("mode", ["dir_box_sqrt", "dir_box_exp"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_dirichlet_box_mask_matches_jax(mode, d):
    """rtol 1e-6 (atol 1e-7 near the box edge, where the mask is 0)."""
    x = _points(d=d, scale=5.0, seed=d)
    want = np.asarray(jax_wf.dirichlet_box_mask(jnp.asarray(x), 8.0, mode))
    got = dirichlet_box_mask(torch.as_tensor(x), 8.0, mode).numpy()
    assert got.shape == want.shape == (len(x), 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


SHARED = dict(ndim=2, neigs=4, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
              parallel=False, use_fourier_feature=True, fourier_mapping_size=8,
              fourier_scale=0.1, apply_boundary=True, lim=6.0)


@pytest.mark.parametrize("kw", [
    dict(), dict(boundary_mode="dir_box_exp"), dict(use_fourier_feature=False),
    dict(parallel=True, fourier_append_radial=True), dict(apply_boundary=False),
], ids=["sqrt", "exp", "raw-input", "parallel-box", "no-box"])
def test_shared_trunk_wavefunction_matches_jax(kw):
    """The CLI default model (shared trunk, box mask) after params_from_jax:
    rtol 1e-5, atol 1e-6 of the largest output."""
    cfg = dict(SHARED, **kw)
    jinit, japply = jax_wf.make_wavefunctions(**cfg)
    params = jinit(jax.random.key(3))
    model = make_wavefunctions(**cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    x = _points(seed=4)
    want = np.asarray(japply(params, jnp.asarray(x)))
    got = model(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_shared_trunk_unported_options_raise():
    """The shared trunk takes weight normalization and bias=False: each
    builds, carries JAX's parameters (the gains g too, through
    params_from_jax) and gives JAX's outputs (rtol 1e-5, atol 1e-6 of the
    largest); it takes a tier, and a split spec raises naming ParallelMLP."""
    x = _points(n=32, seed=5)
    for kw in (dict(weight_normalization=True), dict(bias=False),
               dict(bias=False, weight_normalization=True)):
        jinit, japply = jax_mlp.make_mlp_eigfuncs(2, 4, [8], "softplus", **kw)
        params = jinit(jax.random.key(0))
        model = make_mlp_eigfuncs(2, 4, [8], "softplus", **kw)
        carried = params_from_jax({"base": jax.tree.map(np.asarray, params)})
        model.load_state_dict({k.removeprefix("base."): v for k, v in carried.items()})
        assert ("layers.0.g" in model.state_dict()) == kw.get("weight_normalization", False)
        want = np.asarray(japply(params, jnp.asarray(x)))
        got = model(torch.as_tensor(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    assert make_mlp_eigfuncs(2, 4, [8], "softplus", matmul_precision="high").precision == "high"
    with pytest.raises(ValueError, match="ParallelMLP"):
        make_mlp_eigfuncs(2, 4, [8], "softplus", matmul_precision="highest@1,high")


@pytest.mark.parametrize("mode,scale", [("gaussian", 3.0), ("laplacian", 2.0),
                                        ("uniform", 5.0),
                                        ("gaussian_mixture", (0.5, 2.0, 6.0))])
def test_sampler_densities_match_jax(mode, scale):
    """The importance densities agree on the same x (rtol 1e-6); the port's
    draws have the density's moments (mean |x| within 4% over 20000 rows)."""
    _, jimp = jax_samplers.get_sampler(mode, 8, 1, 2, scale)
    sample, imp = samplers.get_sampler(mode, 20000, 1, 2, scale, device="cpu")
    x = _points(seed=7, scale=3.0)
    x = x[np.abs(x).max(1) < 5.0]
    np.testing.assert_allclose(imp(torch.as_tensor(x)).numpy(),
                               np.asarray(jimp(jnp.asarray(x))), rtol=1e-6)
    draws = sample(torch.Generator().manual_seed(0))
    assert draws.shape == (20000, 2)
    jdraws = np.asarray(jax_samplers.get_sampler(mode, 20000, 1, 2, scale)[0](
        jax.random.key(0)))
    np.testing.assert_allclose(draws.abs().mean().item(), np.abs(jdraws).mean(),
                               rtol=0.04)
    again = sample(torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)


def test_mixture_component_shares():
    """Inverse-CDF components: each scale's share of 40000 draws within 1.5%
    of its weight (|x| of a component has a known law; here the share of
    rows drawn from the tightest scale, told apart by the seed's uniforms)."""
    sample, _ = samplers.get_sampler("gaussian_mixture", 40000, 1, 1, (1e-3, 1e3),
                                     sampling_weights=(1.0, 3.0), device="cpu")
    x = sample(torch.Generator().manual_seed(1))
    tight = (x.abs() < 1.0).float().mean().item()
    assert abs(tight - 0.25) < 0.015


def test_make_val_mc_is_fixed_by_its_seed():
    a, batches, imp = samplers.make_val_mc("gaussian", 300, 1, 3, 2.0, 128, seed=5,
                                           device="cpu")
    b, _, _ = samplers.make_val_mc("gaussian", 300, 1, 3, 2.0, 128, seed=5, device="cpu")
    c, _, _ = samplers.make_val_mc("gaussian", 300, 1, 3, 2.0, 128, seed=6, device="cpu")
    assert a.shape == (300, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert [len(v) for v in batches()] == [128, 128, 44]
    _, jimp = jax_samplers.get_sampler("gaussian", 300, 1, 3, 2.0)
    np.testing.assert_allclose(imp(torch.as_tensor(a)).numpy(),
                               np.asarray(jimp(jnp.asarray(a))), rtol=1e-6)


STEPS = np.array([0, 1, 2, 7, 50, 99, 100, 101, 250])


def test_cosine_annealing_matches_jax():
    """f32 on the same step counts, t clipped at T: rtol 1e-6."""
    for eta_min in (0.0, 1e-6):
        js = jax_opt.cosine_annealing(1e-3, 100, eta_min)
        ts = optimizers.cosine_annealing(1e-3, 100, eta_min)
        for s in STEPS:
            got = ts(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), float(js(jnp.int32(s))), rtol=1e-6)


def _grad_seq(n=12, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"base.ws.0": (4, 3, 2), "base.bs.0": (4, 3, 1)}
    seq = []
    for i in range(n):
        scale = 1e3 if i in (6, 9) else 1.0  # spikes
        seq.append({k: (scale * rng.standard_normal(s)).astype(np.float32)
                    for k, s in shapes.items()})
    if n > 10:
        seq[10]["base.bs.0"][0, 0, 0] = np.inf
    return seq


def _as_jax(d):
    return {"base": {"ws": [jnp.asarray(d["base.ws.0"])],
                     "bs": [jnp.asarray(d["base.bs.0"])]}}


def _from_jax(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def test_reject_spikes_matches_optax():
    """The JAX transformation and the port over a sequence with two spikes
    and a non-finite step, after a warm-up of 3: the same updates (rtol
    1e-6), EMA, count and rejections."""
    jtx = jax_opt.reject_spikes(factor=5.0, decay=0.9, warmup=3)
    ttx = optimizers.reject_spikes(factor=5.0, decay=0.9, warmup=3)
    seq = _grad_seq()
    jstate = jtx.init(_as_jax(seq[0]))
    tstate = ttx.init({k: torch.tensor(v) for k, v in seq[0].items()})
    rejected = 0
    for g in seq:
        jupd, jstate = jtx.update(_as_jax(g), jstate)
        tupd, tstate = ttx.update({k: torch.tensor(v) for k, v in g.items()}, tstate)
        want = _from_jax(jupd)
        for k in g:
            np.testing.assert_allclose(tupd[k].numpy(), want[k].numpy(), rtol=1e-6)
        np.testing.assert_allclose(tstate["gnorm_ema"].item(), float(jstate.gnorm_ema),
                                   rtol=1e-6)
        assert int(tstate["count"]) == int(jstate.count)
        assert int(tstate["rejected"]) == int(jstate.rejected)
        rejected = int(jstate.rejected)
    assert rejected == 3


def test_per_mode_lr_and_the_mode_axis_guard_match_jax():
    """per_mode_lr after RMSprop with a cosine schedule, chained as the CLI
    chains it: the same updates over 5 steps (rtol 1e-6)."""
    scales = np.where(np.arange(4) >= 2, 3.0, 1.0).astype(np.float32)
    jtx = optax.chain(jax_opt.build_optimizer(
        "rmsprop", 1e-3, lr_schedule=jax_opt.cosine_annealing(1e-3, 8),
        spike_reject_factor=25.0), jax_opt.per_mode_lr(scales, 4))
    ttx = optimizers.chain(optimizers.build_optimizer(
        "rmsprop", 1e-3, lr_schedule=optimizers.cosine_annealing(1e-3, 8),
        spike_reject_factor=25.0), optimizers.per_mode_lr(scales, 4))
    seq = _grad_seq(5, seed=1)
    jparams = _as_jax(seq[0])
    tparams = {k: torch.tensor(v) for k, v in seq[0].items()}
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for g in seq:
        jupd, jstate = jtx.update(_as_jax(g), jstate, jparams)
        tupd, tstate = ttx.update({k: torch.tensor(v) for k, v in g.items()}, tstate,
                                  tparams)
        want = _from_jax(jupd)
        for k in g:
            np.testing.assert_allclose(tupd[k].numpy(), want[k].numpy(), rtol=1e-6)
    jax_opt.assert_mode_axis_unambiguous(jparams, 4)
    optimizers.assert_mode_axis_unambiguous(tparams, 4)
    shared = {"base.layers.0.w": torch.zeros(4, 4), "base.layers.0.b": torch.zeros(3)}
    with pytest.raises(ValueError, match="base.layers.0.b"):
        optimizers.assert_mode_axis_unambiguous(shared, 4)
    with pytest.raises(ValueError):
        jax_opt.assert_mode_axis_unambiguous({"w": jnp.zeros(4), "b": jnp.zeros(3)}, 4)


# -- the CLI ------------------------------------------------------------------

TINY = dict(seed=3, neigs=4, mlp_hidden_dims="16,16", batch_size=64, lim=4.0,
            val_eps=0.5, num_iters=2, print_freq=1, eval_freq=2, lr=0.0,
            use_fourier_feature=True, fourier_mapping_size=8, fourier_scale=0.1,
            operator_scale=10.0)
# the CLI default model (shared trunk, box mask, gaussian sampling) on the
# exact Laplacian and on its default finite differences (eps 0.1), and
# the E4 model; rtol of the first eval's eigvals, port vs JAX
CLI_CASES = {
    "default-model": dict(sampling_mode="gaussian", sampling_scale=2.0,
                          laplacian_eps=-1.0),
    "default-model-fd": dict(sampling_mode="gaussian", sampling_scale=2.0),
    "e4-model": dict(parallel=True, apply_boundary=False, laplacian_eps=-1.0,
                     fourier_append_radial=True, fourier_append_envelopes="2,0.6667",
                     sampling_mode="gaussian_mixture", sampling_scales="0.5,2,6",
                     use_lr_scheduler=True, ema_decay=0.995,
                     loss=jax_config.LossConfig(
                         neuralsvd=jax_config.NeuralSVDOpts(sequential=True))),
    # the Fokker–Planck problem: scale_operator reaches the operator; shift
    # 10 keeps every eigenvalue away from zero, and the recipe's shift 4
    # puts one near it
    "fp-model": dict(problem="fp", parallel=True, apply_boundary=False,
                     laplacian_eps=-1.0, sampling_mode="uniform", sampling_scale=4.0,
                     scale_operator=2.0, operator_shift=10.0),
    "fp-model-shift4": dict(problem="fp", parallel=True, apply_boundary=False,
                            laplacian_eps=-1.0, sampling_mode="uniform",
                            sampling_scale=4.0, scale_operator=2.0, operator_shift=4.0),
}


# In f32 a central difference at eps 0.1 loses ~1/eps² = 100x of the
# model's rounding, so on finite differences the two packages' f32 eigvals
# each differ from a float64 evaluation of the same model, grid and
# operator by more than 1e-5 (the test checks it for JAX's); both are held
# to that float64 value at 1e-4, and to each other at 1e-4.
CLI_RTOL = {"default-model": 1e-5, "default-model-fd": 1e-4, "e4-model": 1e-5,
            "fp-model": 1e-5, "fp-model-shift4": 1e-5}
# At the FP recipe's shift 4 one eigenvalue sits near zero (0.0085 at this
# init): the float32 Rayleigh quotient of the shifted operator cancels
# there, so each package's f32 value differs from a float64 evaluation by
# more than 1e-5 relative (the test checks it for JAX's) and by ~1e-6 in
# absolute terms.  That case is held to the float64 value, and the two
# packages to each other, at rtol 1e-5 with atol 1e-6 of the largest
# |eigval|, the convention the gradient checks use.
CLI_ATOL = {"fp-model-shift4": 1e-6}


def _configs(tmp_path, case):
    kw = dict(TINY, **CLI_CASES[case])
    loss = kw.pop("loss", None)
    jcfg = jax_config.PDEConfig(log_dir=str(tmp_path / "jax"), **kw)
    cfg = config.PDEConfig(log_dir=str(tmp_path / "port"), device="cpu", **kw)
    if loss is not None:
        jcfg.loss = loss
        cfg.loss = config.LossConfig(
            neuralsvd=config.NeuralSVDOpts(**dataclasses.asdict(loss.neuralsvd)))
    return jcfg, cfg


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_first_eval_matches_jax(tmp_path, monkeypatch, case):
    """At lr 0 the parameters stay at the JAX init carried across, so the
    CLI's first eval (EMA params, the val grid, the operator and the
    Rayleigh quotients) gives JAX's eigvals and norms: rtol 1e-5 (1e-4 on
    finite differences, CLI_RTOL; an atol for an eigenvalue near zero,
    CLI_ATOL)."""
    jcfg, cfg = _configs(tmp_path, case)
    _, jeigvals, jnorms = jax_pde.main(jcfg)

    jinit = jax_wf.make_wavefunctions(
        ndim=cfg.ndim, neigs=cfg.neigs, mlp_hidden_dims=[16, 16],
        nonlinearity=cfg.nonlinearity, parallel=cfg.parallel,
        use_fourier_feature=True, fourier_mapping_size=8, fourier_scale=0.1,
        fourier_append_radial=cfg.fourier_append_radial,
        fourier_append_envelopes=tuple(
            float(v) for v in cfg.fourier_append_envelopes.split(",") if v),
        fourier_seed=cfg.seed, apply_boundary=cfg.apply_boundary, lim=cfg.lim)[0]
    state = params_from_jax(jax.tree.map(np.asarray, jinit(jax.random.key(cfg.seed))))

    model_kw = {}

    def with_jax_init(**kw):
        model_kw.update(kw)
        model = make_wavefunctions(**kw)
        model.load_state_dict(state)
        return model

    monkeypatch.setattr(pde, "make_wavefunctions", with_jax_init)
    _, eigvals, norms = pde.main(cfg)
    assert len(eigvals) == len(jeigvals) == 1
    np.testing.assert_allclose(eigvals[0], np.asarray(jeigvals[0]), rtol=CLI_RTOL[case],
                               atol=CLI_ATOL.get(case, 0.0) * np.abs(jeigvals[0]).max())
    np.testing.assert_allclose(norms[0], np.asarray(jnorms[0]), rtol=1e-5)
    if case == "default-model-fd":
        ref = _float64_eigvals(cfg, model_kw, state)
        jrel = np.abs(np.asarray(jeigvals[0]) - ref) / np.abs(ref)
        rel = np.abs(eigvals[0] - ref) / np.abs(ref)
        assert jrel.max() > 1e-5, jrel
        assert jrel.max() <= 1e-4 and rel.max() <= 1e-4, (jrel, rel)
    if case == "fp-model-shift4":
        ref = _float64_eigvals(cfg, model_kw, state)
        jrel = np.abs(np.asarray(jeigvals[0]) - ref) / np.abs(ref)
        assert jrel.max() > 1e-5, jrel
        for got in (np.asarray(jeigvals[0]), eigvals[0]):
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=CLI_ATOL[case] * np.abs(ref).max())


def _float64_eigvals(cfg, model_kw, state):
    """The first eval's Rayleigh quotients with the CLI's model, operator,
    sampling density and grid, in float64."""
    model = make_wavefunctions(**model_kw).double()
    model.load_state_dict({k: v.double() for k, v in state.items()})
    operator, _, _ = get_problem(problem=cfg.problem, potential_type=cfg.potential_type,
                                 ndim=cfg.ndim, neigs=cfg.neigs,
                                 laplacian_eps=cfg.laplacian_eps,
                                 operator_scale=cfg.operator_scale,
                                 operator_shift=cfg.operator_shift,
                                 scale_operator=cfg.scale_operator)
    _, imp = samplers.get_sampler(cfg.sampling_mode, cfg.batch_size, 1, cfg.ndim,
                                  cfg.sampling_scale, device="cpu")
    _, batches, imp_val = samplers.make_val_grid(cfg.ndim, cfg.lim, cfg.val_eps,
                                                 cfg.batch_size)
    cov = quad = 0.0
    with torch.no_grad():
        for x in batches():
            c, q, _ = _accumulate_evd(model, operator, torch.as_tensor(x, dtype=torch.float64),
                                      imp, imp_val, False)
            cov, quad = cov + c, quad + q
    return (torch.diagonal(quad) / torch.diagonal(cov)).numpy()


# rescue, exp-mask, cosine, neuralef, fp, spin, spinx and the precision
# tiers are ported now: those cases train (match None)
@pytest.mark.parametrize("kw,match", [
    (dict(loss=config.LossConfig(name="neuralef")), None),
    (dict(loss=config.LossConfig(name="spin")), None),
    (dict(loss=config.LossConfig(name="spinx")), None),
    (dict(problem="fp"), None),
    # --mesh dp and tp run, SpIN on tp too (test_torch_cli_mesh.py, test_torch_tp.py,
    # test_torch_tp_spin.py); a tp=2 mesh in one process is refused before training
    (dict(mesh="tp=2", loss=config.LossConfig(name="spin")), "needs 2 devices, only 1"),
    (dict(rescue=True, parallel=True), None),
    (dict(matmul_precision="high"), None),
    (dict(apply_exp_mask=True), None),
    (dict(potential_type="cosine"), None),
], ids=["neuralef", "spin", "spinx", "fp", "mesh", "rescue", "precision", "exp-mask",
        "cosine"])
def test_unported_flags_raise_before_training(tmp_path, kw, match):
    """A flag that cannot run raises before any training (a mesh wider than
    the ranks: ValueError); a ported one trains: finite eigenvalues and a
    checkpoint."""
    cfg = config.PDEConfig(log_dir=str(tmp_path), device="cpu", **dict(TINY, **kw))
    if match is None:
        ts, eigvals, _ = pde.main(cfg)
        assert int(ts.step) == cfg.num_iters and np.isfinite(eigvals[0]).all()
        assert list(tmp_path.rglob(f"ckpt_{cfg.num_iters}"))
        return
    with pytest.raises(ValueError, match=match):
        pde.main(cfg)
    assert not list(tmp_path.rglob("ckpt_*"))


def test_cli_refuses_an_existing_log_dir(tmp_path):
    cfg = config.PDEConfig(log_dir=str(tmp_path), device="cpu", **TINY)
    pde.main(cfg)
    with pytest.raises(ValueError, match="overwrite"):
        pde.main(cfg)
    pde.main(dataclasses.replace(cfg, overwrite=True))


def test_tail_lr_boost_needs_per_mode_towers(tmp_path):
    cfg = config.PDEConfig(log_dir=str(tmp_path), device="cpu", tail_lr_boost=2.0,
                           **TINY)
    with pytest.raises(ValueError, match="parallel"):
        pde.main(cfg)


def test_cli_default_device_is_the_gpu(tmp_path):
    """Without --device the CLI asks for CUDA and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = config.parse_pde_config(["--log_dir", str(tmp_path), "--neigs", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pde.main(cfg)
