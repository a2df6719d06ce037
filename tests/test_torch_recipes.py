"""The paper's two PDE recipes and the rest of ``--problem sch`` against the
JAX package: the exponential mask, the potentials and their ground
truths, and both recipes' first step and CLI runs at tiny widths.

Inputs are numpy arrays from seeded generators and parameters the JAX
init carried across with ``params_from_jax``; each test states its
tolerance.  The recipes' argv is the ``args=( ... )`` list of
``scripts/exps/pde/hydrogen.sh`` and ``oscillator.sh`` with ``--loss
neuralsvd``, read from the scripts.
"""
import dataclasses
import logging
import os
import shlex
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.methods.factories import get_evd_method as jax_get_evd_method
from neuralsvd_tpu.models.mlp import parse_dims as jax_parse_dims
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.operators import ground_truths as jax_gt
from neuralsvd_tpu.operators import molecule as jax_molecule
from neuralsvd_tpu.operators import schrodinger as jax_sch
from neuralsvd_tpu.operators.problems import get_problem as jax_get_problem
from neuralsvd_tpu.ops.forward_laplacian import forward_laplacian as jax_forward
from neuralsvd_tpu.utils import config as jax_config
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators import ground_truths, molecule, schrodinger
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.ops import forward_laplacian as engine
from neuralsvd_tpu_torch.ops.forward_laplacian import forward_laplacian
from neuralsvd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from neuralsvd_tpu_torch.utils import config

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts" / "exps" / "pde"


def script_argv(name, batch=512, sequential=0):
    """The ``args=( ... )`` list of scripts/exps/pde/<name>.sh with the
    script's defaults substituted, plus ``--loss neuralsvd``."""
    block = (SCRIPTS / f"{name}.sh").read_text().split("args=(", 1)[1].split("\n)", 1)[0]
    argv = []
    for line in block.splitlines():
        line = line.split("#", 1)[0]
        line = line.replace('"$BATCH"', str(batch)).replace('"$SEQUENTIAL"', str(sequential))
        argv += shlex.split(line)
    return argv + ["--loss", "neuralsvd"]


def with_flags(argv, **flags):
    """``argv`` with each ``--<flag>`` set to the given value (replaced in
    place where present, else appended)."""
    argv = list(argv)
    for flag, value in flags.items():
        name = "--" + flag
        if name in argv:
            argv[argv.index(name) + 1] = str(value)
        else:
            argv += [name, str(value)]
    return argv


# tiny widths of the recipes: every other flag is the script's
TINY = {"hydrogen": dict(neigs=6, mlp_hidden_dims="16,16,16", fourier_mapping_size=16,
                         batch_size=64),
        "oscillator": dict(neigs=5, mlp_hidden_dims="16,16,16", fourier_mapping_size=16,
                           batch_size=64)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


def _points(n=64, d=2, seed=0, scales=(0.5, 2.0, 6.0)):
    rng = np.random.default_rng(seed)
    return (rng.choice(scales, size=(n, 1)) * rng.normal(size=(n, d))).astype(np.float32)


def _carried(kw, key=0):
    """(JAX apply bound to its init, the port's model carrying that init)."""
    jinit, japply = jax_make_wavefunctions(**kw)
    params = jinit(jax.random.key(key))
    model = make_wavefunctions(**kw, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, japply, model


# -- the exponential mask -----------------------------------------------------

MASKED = dict(ndim=2, neigs=5, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
              parallel=True, use_fourier_feature=True, fourier_mapping_size=8,
              fourier_scale=1.0, apply_boundary=False, apply_exp_mask=True,
              exp_mask_init_scale=10.0, lim=6.0)
_, _GAUSS = jax_get_sampler("gaussian", 8, 1, 2, 4.0)
_, _TGAUSS = get_sampler("gaussian", 8, 1, 2, 4.0, device="cpu")
MASK_CASES = {
    "scalar": dict(),
    "ladder": dict(exp_mask_init_scale=(0.5, 8.0)),
    "per-mode": dict(exp_mask_init_scale=(0.5, 1.0, 2.0, 4.0, 8.0)),
    "scalar-box": dict(apply_boundary=True),
    "ladder-box-exp": dict(exp_mask_init_scale=(0.5, 8.0), apply_boundary=True,
                           boundary_mode="dir_box_exp"),
    "shared-trunk": dict(parallel=False, apply_boundary=True),
    "conjugate": dict(exp_mask_conjugate_importance="gaussian"),
    "conjugate-box": dict(exp_mask_conjugate_importance="gaussian", apply_boundary=True),
}


def _mask_kw(case):
    kw = dict(MASKED, **MASK_CASES[case])
    if kw.get("exp_mask_conjugate_importance"):
        return (dict(kw, exp_mask_conjugate_importance=_GAUSS),
                dict(kw, exp_mask_conjugate_importance=_TGAUSS))
    return kw, kw


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_exp_masked_wavefunction_matches_jax(case):
    """Outputs against JAX apply on carried params (the mask's scales
    included, as ``mask.scales``): rtol 1e-5, atol 1e-6 of the largest;
    the points include the origin and points outside the box."""
    jkw, tkw = _mask_kw(case)
    jinit, japply = jax_make_wavefunctions(**jkw)
    params = jinit(jax.random.key(1))
    model = make_wavefunctions(**tkw, device="cpu")
    state = params_from_jax(jax.tree.map(np.asarray, params))
    assert "mask.scales" in state
    model.load_state_dict(state)
    x = _points(seed=2)
    x[0], x[1] = 0.0, 9.0
    want = np.asarray(japply(params, jnp.asarray(x)))
    got = model(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case", ["scalar", "ladder-box-exp", "conjugate", "shared-trunk"])
def test_exp_masked_laplacian_matches_jax_engine(case):
    """The forward-Laplacian engine on an exp-masked model against JAX's,
    with no fallback call: value, gradient and Laplacian (_rel under 3e-6,
    3e-5, 3e-5, the JAX engine tests' tolerances); then the oscillator's
    -H under √w conjugation (rtol 1e-4, atol 1e-5 of Tf's scale)."""
    jkw, tkw = _mask_kw(case)
    jinit, japply = jax_make_wavefunctions(**jkw)
    params = jinit(jax.random.key(3))
    model = make_wavefunctions(**tkw, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    x = _points(48, seed=4)
    jf = lambda xx: japply(params, xx)  # noqa: E731
    engine.fallback_rule.calls = 0
    lj, gj, vj = jax_forward(jf, jnp.asarray(x), return_grad=True)
    lt, gt, vt = forward_laplacian(model, torch.as_tensor(x), return_grad=True)
    assert _rel(vj, vt) < 3e-6 and _rel(gj, gt) < 3e-5 and _rel(lj, lt) < 3e-5
    kw = dict(problem="sch", potential_type="harmonic_oscillator", ndim=2, neigs=5,
              laplacian_eps=-1.0, operator_shift=16.0)
    Tf_j, fs_j = jax_get_problem(**kw)[0](jf, jnp.asarray(x), _GAUSS)
    Tf_t, fs_t = get_problem(**kw)[0](model, torch.as_tensor(x), _TGAUSS)
    np.testing.assert_allclose(Tf_t.numpy(), np.asarray(Tf_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(Tf_j)).max())
    np.testing.assert_allclose(fs_t.detach().numpy(), np.asarray(fs_j), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(fs_j)).max())
    assert engine.fallback_rule.calls == 0


# -- the potentials, ground truths and molecules --------------------------------

POTENTIALS = {
    "infinite_well": dict(potential_type="infinite_well", ndim=2, lim=3.0),
    "cosine-1d": dict(potential_type="cosine", ndim=1),
    "cosine-2d": dict(potential_type="cosine", ndim=2, neigs=30),
    "cosine-5d": dict(potential_type="cosine", ndim=5),
    "cosine-10d": dict(potential_type="cosine", ndim=10),
    "hydrogen-3d": dict(potential_type="hydrogen", ndim=3, charge=2.0),
    "hydrogen_mol_ion": dict(potential_type="hydrogen_mol_ion", ndim=2,
                             hydrogen_mol_ion_R=1.5),
    "h2-2d": dict(potential_type="quantum_chemistry", ndim=2, mol_name="H2"),
    "h2-3d": dict(potential_type="quantum_chemistry", ndim=3, mol_name="H2"),
}


@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_potential_operator_matches_jax(name):
    """Each new ``sch`` potential through get_problem in both packages: the
    potential at the same points (rtol 1e-6, atol 1e-6 of the largest
    |V|: the cosine sums ten float32 terms), the ground truth and
    n_particles exactly, and (Tf, fs) of the operator on carried params
    under √w conjugation by the sampler's density (exact Laplacian: the
    port's forward engine against JAX's; rtol 1e-4, atol 1e-5 of Tf's
    scale).  quantum_chemistry is H2, two electrons: the sampler, the
    per-particle radial feature and the operator's reshape see
    n_particles = 2."""
    kw = dict(dict(problem="sch", neigs=4, laplacian_eps=-1.0, operator_scale=2.0,
                   operator_shift=1.0), **POTENTIALS[name])
    jop, jgt, jn = jax_get_problem(**kw)
    top, tgt, tn = get_problem(**kw)
    assert tn == jn
    if jgt is None:
        assert tgt is None
    else:
        np.testing.assert_array_equal(tgt, jgt)
    assert top.singular_at_origin == jop.singular_at_origin
    d = kw["ndim"] * tn
    x = _points(48, d=d, seed=5, scales=(0.5, 1.0, 2.0))
    # the potentials themselves, in the (B, n_particles, D) layout
    xs = x.reshape(len(x), tn, -1)
    V = np.asarray(jop.operator.local_potential_ftn(jnp.asarray(xs)))
    np.testing.assert_allclose(
        top.operator.local_potential_ftn(torch.as_tensor(xs)).numpy(), V, rtol=1e-6,
        atol=1e-6 * np.abs(V).max())
    wf = dict(ndim=kw["ndim"], neigs=4, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
              n_particles=tn, parallel=True, use_fourier_feature=True,
              fourier_mapping_size=8, fourier_scale=0.5, fourier_append_radial=True,
              fourier_append_envelopes=(1.0,), apply_boundary=False)
    params, japply, model = _carried(wf)
    _, jimp = jax_get_sampler("gaussian", 8, tn, kw["ndim"], 2.0)
    _, timp = get_sampler("gaussian", 8, tn, kw["ndim"], 2.0, device="cpu")
    np.testing.assert_allclose(timp(torch.as_tensor(x)).numpy(),
                               np.asarray(jimp(jnp.asarray(x))), rtol=1e-5)
    engine.fallback_rule.calls = 0
    Tf_j, fs_j = jop(lambda xx: japply(params, xx), jnp.asarray(x), jimp)
    Tf_t, fs_t = top(model, torch.as_tensor(x), timp)
    np.testing.assert_allclose(Tf_t.numpy(), np.asarray(Tf_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(Tf_j)).max())
    np.testing.assert_allclose(fs_t.detach().numpy(), np.asarray(fs_j), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(fs_j)).max())
    assert engine.fallback_rule.calls == 0


def test_ground_truths_and_molecules_are_copies():
    """InfiniteWell2D and Hydrogen3D eigenvalues, and every molecule of the
    database, equal the JAX package's exactly."""
    for neigs in (1, 5, 16, 36, 55):
        for L_ in (1.0, 6.0):
            np.testing.assert_array_equal(
                ground_truths.InfiniteWell2D(L=L_).get_eigvals(neigs),
                jax_gt.InfiniteWell2D(L=L_).get_eigvals(neigs))
        np.testing.assert_array_equal(ground_truths.Hydrogen3D(2.0).get_eigvals(neigs),
                                      jax_gt.Hydrogen3D(2.0).get_eigvals(neigs))
    np.testing.assert_array_equal(ground_truths.Hydrogen3D().get_degeneracy(14),
                                  [1, 5, 14])
    x = np.linspace(0, 6, 7)
    np.testing.assert_array_equal(ground_truths.InfiniteWell2D(6.0).eigfunc(1, 2, x, x),
                                  jax_gt.InfiniteWell2D(6.0).eigfunc(1, 2, x, x))
    assert molecule.Molecule.all_names == jax_molecule.Molecule.all_names
    for name in sorted(molecule.Molecule.all_names):
        a, b = molecule.Molecule.from_name(name), jax_molecule.Molecule.from_name(name)
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.charges, b.charges)
        assert (a.n_electrons, a.charge, a.spin) == (b.n_electrons, b.charge, b.spin)
    for name, kw in (("Hn", dict(n=3, dist=1.4)), ("H4_rect", dict(dist=2.0))):
        np.testing.assert_array_equal(molecule.Molecule.from_name(name, **kw).coords,
                                      jax_molecule.Molecule.from_name(name, **kw).coords)


def test_quantum_chemistry_energy_terms_match_jax():
    """nuclear_energy, nuclear_potential and electronic_potential of H2O's
    ten electrons in 3D (rtol 1e-6)."""
    mol = jax_molecule.Molecule.from_name("H2O")
    rs = _points(32, d=30, seed=6).reshape(32, 10, 3)
    c32, q32 = mol.coords.astype(np.float32), mol.charges.astype(np.float32)
    tc, tq = torch.as_tensor(c32), torch.as_tensor(q32)
    np.testing.assert_allclose(schrodinger.nuclear_energy(tc, tq).item(),
                               float(jax_sch.nuclear_energy(jnp.asarray(c32), jnp.asarray(q32))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        schrodinger.nuclear_potential(torch.as_tensor(rs), tc, tq).numpy(),
        np.asarray(jax_sch.nuclear_potential(jnp.asarray(rs), jnp.asarray(c32),
                                             jnp.asarray(q32))), rtol=1e-6)
    np.testing.assert_allclose(
        schrodinger.electronic_potential(torch.as_tensor(rs)).numpy(),
        np.asarray(jax_sch.electronic_potential(jnp.asarray(rs))), rtol=1e-6)


# -- both recipes -----------------------------------------------------------------


def test_recipe_argv_is_the_scripts():
    """Both scripts' lists parse in both packages to the same config, at the
    paper widths: hydrogen L 36 with the rescue, oscillator L 55 with the
    exp mask at 10."""
    for name, neigs in (("hydrogen", 36), ("oscillator", 55)):
        argv = script_argv(name)
        cfg, jcfg = config.parse_pde_config(argv), jax_config.parse_pde_config(argv)
        assert {k: v for k, v in dataclasses.asdict(cfg).items() if k != "device"} == \
            dataclasses.asdict(jcfg)
        assert cfg.neigs == neigs and cfg.batch_size == 512 and cfg.parallel
    assert config.parse_pde_config(script_argv("hydrogen")).rescue
    osc = config.parse_pde_config(script_argv("oscillator"))
    assert osc.apply_exp_mask and osc.exp_mask_init_scale == 10.0 and not osc.apply_boundary


def _recipe_parts(name):
    """(JAX params, JAX method/operator/importance, port build) of a recipe
    at its tiny width, the port carrying the JAX init."""
    argv = with_flags(script_argv(name), **TINY[name], seed=2)
    jcfg = jax_config.parse_pde_config(argv)
    cfg = config.parse_pde_config(argv + ["--device", "cpu"])
    jop, _, n = jax_get_problem(
        problem=jcfg.problem, potential_type=jcfg.potential_type, ndim=jcfg.ndim,
        neigs=jcfg.neigs, lim=jcfg.lim, charge=jcfg.charge,
        laplacian_eps=jcfg.laplacian_eps, operator_scale=jcfg.operator_scale,
        operator_shift=jcfg.operator_shift)
    jinit, japply = jax_make_wavefunctions(
        ndim=jcfg.ndim, neigs=jcfg.neigs, mlp_hidden_dims=jax_parse_dims(jcfg.mlp_hidden_dims),
        nonlinearity=jcfg.nonlinearity, n_particles=n, parallel=jcfg.parallel,
        use_fourier_feature=jcfg.use_fourier_feature,
        fourier_mapping_size=jcfg.fourier_mapping_size, fourier_scale=jcfg.fourier_scale,
        fourier_append_radial=jcfg.fourier_append_radial,
        fourier_append_envelopes=tuple(
            float(v) for v in jcfg.fourier_append_envelopes.split(",") if v),
        fourier_seed=jcfg.seed, apply_boundary=jcfg.apply_boundary, lim=jcfg.lim,
        apply_exp_mask=jcfg.apply_exp_mask, exp_mask_init_scale=jcfg.exp_mask_init_scale)
    scale = (tuple(float(v) for v in jcfg.sampling_scales.split(","))
             if jcfg.sampling_mode == "gaussian_mixture" else jcfg.sampling_scale)
    _, jimp = jax_get_sampler(jcfg.sampling_mode, jcfg.batch_size, n, jcfg.ndim, scale)
    jmethod = jax_get_evd_method("neuralsvd", japply, jcfg.neigs,
                                 **vars(jcfg.loss.neuralsvd))
    params = jinit(jax.random.key(jcfg.seed))
    run = pde.build(cfg)
    run.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, (jmethod, jop, jimp, scale), run, cfg


@pytest.mark.parametrize("name", ["hydrogen", "oscillator"])
def test_recipe_first_step_matches_jax(name):
    """The recipe's model, operator (central differences at eps 0.01),
    importance density and joint-nesting NestedLoRA at tiny widths: the
    loss (rtol 1e-5) and gradients (rtol 1e-4, atol 1e-6 of the largest
    entry) of the first step's batch on the JAX init, mask scales
    included.  The model and the operator run in float64 in both packages
    and the loss in float32, as the JAX package pins it: in float32 a
    central difference at eps 0.01 carries ~1/eps² = 1e4 times the model's
    rounding, and the two packages' all-float32 losses differ by up to
    0.6% on the hydrogen recipe (operator_scale 100)."""
    params, (jmethod, jop, jimp, scale), run, cfg = _recipe_parts(name)
    rng = np.random.default_rng(7)
    if cfg.sampling_mode == "gaussian_mixture":
        s = rng.choice(scale, size=(cfg.batch_size, 1))
    else:
        s = scale
    x = s * rng.normal(size=(cfg.batch_size, cfg.ndim))
    with jax.enable_x64(True):
        params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        jloss, jgrads = jmethod.loss_and_grad(
            params64, {}, jnp.asarray(x), _to_f32(jop, lambda a: a.astype(jnp.float32)),
            jimp)[:2]
        jloss, jgrads = float(jloss), jax.tree.map(np.asarray, jgrads)
    run.model.double()
    loss, grads, _, _ = run.method.loss_and_grad(
        dict(run.model.named_parameters()), {}, torch.as_tensor(x),
        _to_f32(run.operator, lambda a: a.float()), run.importance_train)
    assert grads["base.ws.0"].dtype == torch.float64
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    ref = {k: np.asarray(v, np.float64) for k, v in _flat(jgrads).items()}
    assert set(ref) == set(grads) and ("mask.scales" in ref) == (name == "oscillator")
    for k, r in ref.items():
        np.testing.assert_allclose(grads[k].numpy(), r, rtol=1e-4,
                                   atol=1e-6 * np.abs(r).max(), err_msg=k)


def _to_f32(operator, cast):
    """``operator`` with its (Tf, fs) cast to float32 for the loss."""
    return lambda f, x, importance=None: tuple(cast(a) for a in operator(f, x, importance))


def _flat(tree):
    """A JAX wavefunction tree as {port name: array}, dtype kept."""
    out = {f"base.{g}.{i}": leaf for g in ("ws", "bs")
           for i, leaf in enumerate(tree["base"].get(g, []))}
    if "mask" in tree:
        out["mask.scales"] = tree["mask"]["scales"]
    return out


def _cli(tmp_path, name, **flags):
    argv = with_flags(script_argv(name), **TINY[name], seed=2, val_eps=2.0, **flags)
    return config.parse_pde_config(argv + ["--log_dir", str(tmp_path), "--device", "cpu"])


def test_oscillator_recipe_trains_through_the_cli(tmp_path):
    """The oscillator recipe (exp mask at 10, no box, L 5 here) through
    cli.pde.main for 6 steps in blocks of 3 and one eval: finite losses
    and eigenvalues, a checkpoint, and learned mask scales moved off 10.
    The val grid is coarsened (--val_eps 2) for the CPU."""
    cfg = _cli(tmp_path, "oscillator", num_iters=6, print_freq=3, eval_freq=6, lr=1e-2)
    ts, eigvals, _ = pde.main(cfg)
    assert int(ts.step) == 6 and len(eigvals) == 1
    assert np.isfinite(eigvals[0]).all() and eigvals[0].shape == (5,)
    scales = ts.params["mask.scales"].detach()
    assert (scales != 10.0).all() and torch.isfinite(scales).all()
    run_dir = tmp_path / config.run_name(cfg)
    assert (run_dir / "ckpt_6").exists() and (run_dir / "stats.npz").exists()


def test_hydrogen_recipe_rescues_a_forced_duplicate(tmp_path, caplog):
    """The hydrogen recipe (L 6 here) through cli.pde.main: a run of 4
    steps checkpoints at an eval; one mode of that checkpoint is made a
    copy of another (params, EMA and both RMSprop moments); --resume to 10
    steps flags the duplicate at the eval at 6 (inside rescue_until · 10),
    rescues it in place, and trains on with finite losses.  The
    checkpoint written after the rescue holds the tail slots' EMA equal to
    their params, each slot off its clone source."""
    src, dst = 1, 4
    first = _cli(tmp_path, "hydrogen", num_iters=4, print_freq=2, eval_freq=4)
    pde.main(first)
    resumed = _cli(tmp_path, "hydrogen", num_iters=10, print_freq=2, eval_freq=6,
                   resume="true")
    run_dir = tmp_path / config.run_name(resumed)
    os.makedirs(run_dir)
    tree = load_checkpoint(str(tmp_path / config.run_name(first) / "ckpt_4"))
    rms = tree["opt_state"][0]  # (RMSprop, schedule) under --use_lr_scheduler
    for t in (tree["params"], tree["ema_params"], rms[0], rms[1]):
        for k, v in t.items():
            if v.ndim and v.shape[0] == first.neigs:
                v[dst] = v[src]
    save_checkpoint(str(run_dir / "ckpt_4"), tree)
    with caplog.at_level(logging.INFO, logger="neuralsvd_tpu_torch"):
        ts, eigvals, _ = pde.main(resumed)
    assert any(f"DUPLICATE: mode {m} ~" in caplog.text for m in (src, dst))
    assert "it6 rescue: exiled + re-initialized" in caplog.text
    assert "state tensors kept in place" in caplog.text
    assert int(ts.step) == 10 and all(np.isfinite(e).all() for e in eigvals)
    after = load_checkpoint(str(run_dir / "ckpt_6"))
    line = next(r for r in caplog.records if "clone sources" in r.getMessage())
    tail, sources = line.args[1], line.args[2]
    assert tail and len(sources) == len(tail)
    for k, p in after["params"].items():
        assert torch.equal(after["ema_params"][k][tail], p[tail])
    for t, s in zip(tail, sources):
        assert not torch.equal(after["params"]["base.ws.0"][t], after["params"]["base.ws.0"][s])


def test_cli_runs_every_sch_potential(tmp_path):
    """Every potential of --problem sch through cli.pde.main for two steps
    and an eval at a toy size; quantum_chemistry (H2, two electrons in
    2D) takes the Monte-Carlo val set."""
    for i, (potential, extra) in enumerate((
            ("infinite_well", {}), ("cosine", {}), ("hydrogen_mol_ion", {}),
            ("quantum_chemistry", dict(mol_name="H2", val_mc_size=256)))):
        cfg = config.PDEConfig(
            log_dir=str(tmp_path / str(i)), device="cpu", potential_type=potential,
            neigs=3, mlp_hidden_dims="16", batch_size=32, lim=3.0, val_eps=0.5,
            num_iters=2, print_freq=1, eval_freq=2, use_fourier_feature=True,
            fourier_mapping_size=8, fourier_scale=0.5, sampling_scale=1.0, **extra)
        ts, eigvals, _ = pde.main(cfg)
        assert int(ts.step) == 2 and np.isfinite(eigvals[0]).all(), potential
