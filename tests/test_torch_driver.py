"""The host driver slice: the multi-step block, resume, the monitor
statistics and the eval's diagnostics, against the JAX package where it
has a counterpart and bit for bit against the port's own eager steps.

Inputs are numpy arrays from seeded generators; each test states its
tolerance.
"""
import importlib
import os
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.methods import spectrum as jax_spectrum
from neuralsvd_tpu.training import ewm as jax_ewm
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.data import samplers
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods import spectrum
from neuralsvd_tpu_torch.methods.factories import get_evd_method
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.parallel.mesh import ModeShards
from neuralsvd_tpu_torch.training import ewm
from neuralsvd_tpu_torch.training.checkpoint import (
    latest_iteration_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from neuralsvd_tpu_torch.training.optimizers import build_optimizer, cosine_annealing
from neuralsvd_tpu_torch.training.train_operator import (
    ScannedTrainStep,
    batch_stats,
    block_seed,
    make_scanned_train_step,
    make_train_step,
    train_operator,
)
from neuralsvd_tpu_torch.training.train_state import (
    init_train_state,
    load_state_tree,
    state_pointers,
    state_tree,
)
from neuralsvd_tpu_torch.utils import config, plotting

# the package exports a function of the module's name
jax_train = importlib.import_module("neuralsvd_tpu.training.train_operator")

L, B = 4, 64
SMALL = dict(ndim=2, neigs=L, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
             parallel=True, use_fourier_feature=True, fourier_mapping_size=8,
             fourier_scale=0.1, fourier_append_radial=True,
             fourier_append_envelopes=(2.0, 2 / 3), apply_boundary=False)


def _setup(probes=0, spike=0.0, seed=0):
    model = make_wavefunctions(**SMALL, seed=seed, device="cpu")
    operator, _, _ = get_problem(problem="sch", potential_type="hydrogen", ndim=2,
                                 neigs=L, laplacian_eps=-1.0, laplacian_probes=probes,
                                 operator_scale=100.0)
    sampler, importance = get_sampler("gaussian_mixture", B, 1, 2, (0.5, 2.0, 6.0),
                                      device="cpu")
    method = NestedLoRA(model, neigs=L, sequential=True)
    optimizer = build_optimizer("rmsprop", 1e-3, lr_schedule=cosine_annealing(1e-3, 40),
                                spike_reject_factor=spike)
    return model, operator, sampler, importance, method, optimizer


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
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


@pytest.mark.parametrize("probes,spike", [(0, 0.0), (2, 0.0), (0, 3.0)],
                         ids=["exact", "hutchinson", "spike-reject"])
def test_scanned_block_equals_eager_steps(probes, spike):
    """On the CPU the block runs the step in a loop: two blocks equal the
    same steps taken one at a time with generators seeded at the block
    starts, bit for bit (params, optimizer state, EMA, step, traces)."""
    model, op, sampler, imp, method, opt = _setup(probes, spike)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    block = make_scanned_train_step(method, op, opt, sampler, importance=imp,
                                    ema_decay=0.995, steps_per_call=5, seed=11)
    ts = init_train_state(model, opt, method)
    traces = []
    for s in (0, 5):
        ts, m = block(ts, s)
        traces.append(m)
    got = state_tree(ts)

    model.load_state_dict(start)
    step = make_train_step(method, op, opt, sampler, importance=imp, ema_decay=0.995)
    ts = init_train_state(model, opt, method)
    for s in (0, 5):
        gen = torch.Generator().manual_seed(block_seed(11, s))
        probe_gen = torch.Generator().manual_seed(block_seed(11, s, 0x0BE5))
        losses = [step(ts, gen, probe_gen)[1]["loss"] for _ in range(5)]
        assert torch.equal(torch.stack(losses), traces[s // 5]["loss"])
    _assert_trees_equal(got, state_tree(ts))
    assert int(ts.step) == 10
    assert traces[0]["loss"].shape == (5,) and not traces[1]["skipped"].any()


@pytest.mark.parametrize("probes,spike", [(0, 0.0), (2, 0.0), (0, 3.0)],
                         ids=["exact", "hutchinson", "spike-reject"])
def test_steps_keep_the_state_buffers(probes, spike):
    """A captured step replays on the tensors the state held at capture:
    a block of steps updates every tensor of the state in place, so
    ``state_pointers`` stays the same, and replacing one changes it."""
    model, op, sampler, imp, method, opt = _setup(probes, spike)
    block = make_scanned_train_step(method, op, opt, sampler, importance=imp,
                                    ema_decay=0.995, steps_per_call=3, seed=11)
    ts = init_train_state(model, opt, method)
    before = state_pointers(ts)
    ts, _ = block(ts, 0)
    assert int(ts.step) == 3 and state_pointers(ts) == before
    ts.ema_params = {k: v.clone() for k, v in ts.ema_params.items()}
    assert state_pointers(ts) != before


def test_block_seeds_differ_by_start_seed_and_stream():
    seeds = {block_seed(s, it, st) for s in (0, 1) for it in (0, 5, 10) for st in (0, 0x0BE5)}
    assert len(seeds) == 12
    assert all(0 <= v < 2 ** 63 for v in seeds)
    assert block_seed(3, 7) == block_seed(3, 7)


def test_block_rejects_a_longer_block():
    block = ScannedTrainStep(lambda ts, g, p: (ts, {}), steps_per_call=4)
    with pytest.raises(ValueError):
        block(None, 0, 5)


def _cfg(tmp_path, **kw):
    base = dict(log_dir=str(tmp_path), device="cpu", seed=5, neigs=L,
                mlp_hidden_dims="16,16", batch_size=B, lim=4.0, val_eps=1.0,
                num_iters=8, print_freq=4, eval_freq=4, lr=1e-3, parallel=True,
                apply_boundary=False, laplacian_eps=-1.0, use_fourier_feature=True,
                fourier_mapping_size=8, fourier_scale=0.1, use_lr_scheduler=True,
                sampling_mode="gaussian_mixture", sampling_scales="0.5,2,6",
                operator_scale=10.0, ema_decay=0.995)
    base.update(kw)
    return config.PDEConfig(**base)


def _run_dir(tmp_path):
    return next(r for r, _, files in os.walk(tmp_path) if "stats.npz" in files)


@pytest.mark.parametrize("probes", [0, 2], ids=["exact", "hutchinson"])
def test_resume_reproduces_the_straight_run(tmp_path, probes):
    """Two blocks straight equal the first block's checkpoint, --resume and
    one more block, bit for bit (the whole state and the second eval)."""
    ts_a, ev_a, _ = pde.main(_cfg(tmp_path / "a", laplacian_probes=probes))
    run_a = _run_dir(tmp_path / "a")
    for name in ("ckpt_4", "ckpt_8", "stats.npz", "spectrum_it4.npz",
                 "eigfuncs2d_it8.npz"):
        assert os.path.exists(os.path.join(run_a, name)), name

    # the run killed after its first eval: only ckpt_4 is left
    run_b = run_a.replace(str(tmp_path / "a"), str(tmp_path / "b"))
    os.makedirs(run_b)
    shutil.copy(os.path.join(run_a, "ckpt_4"), run_b)
    ts_b, ev_b, _ = pde.main(_cfg(tmp_path / "b", laplacian_probes=probes, resume=True))
    assert len(ev_b) == 1
    _assert_trees_equal(state_tree(ts_a), state_tree(ts_b))
    np.testing.assert_array_equal(ev_a[-1], ev_b[-1])


def test_resume_without_a_checkpoint_is_a_fresh_start(tmp_path):
    ts, ev, _ = pde.main(_cfg(tmp_path, resume=True))
    assert len(ev) == 2 and int(ts.step) == 8


def test_monitor_path_takes_the_same_steps(tmp_path):
    """--print_local_energies runs eager steps with the (9, L) statistics
    fed to the EWM monitors; the steps are the block path's, bit for bit."""
    ts_a, ev_a, _ = pde.main(_cfg(tmp_path / "a"))
    ts_b, ev_b, _ = pde.main(_cfg(tmp_path / "b", print_local_energies=True))
    _assert_trees_equal(state_tree(ts_a), state_tree(ts_b))
    np.testing.assert_array_equal(ev_a[-1], ev_b[-1])


def test_driver_options(tmp_path):
    """Spike rejection, the tail LR boost, post-alignment, a remainder
    block, the profile window and the timings run; losses finite."""
    timings = {}
    cfg = _cfg(tmp_path, num_iters=10, spike_reject_factor=25.0, tail_lr_boost=2.0,
               tail_lr_start=2, post_align=True, profile=True, profile_start=4,
               profile_steps=2)
    ts, ev, norms = pde.main(cfg, timings=timings)
    assert int(ts.step) == 10 and len(ev) == 2
    assert [n for n, _ in timings["block_eager"]] == [4, 4, 2]
    assert len(timings["eval"]) == 2
    assert os.path.exists(os.path.join(_run_dir(tmp_path), "profile", "trace.json"))
    assert all(np.isfinite(e).all() for e in ev)
    assert all(torch.isfinite(p).all() for p in ts.params.values())


def test_checkpoint_round_trip(tmp_path):
    model, op, sampler, imp, method, opt = _setup(spike=3.0)
    block = make_scanned_train_step(method, op, opt, sampler, importance=imp,
                                    steps_per_call=3, seed=2)
    ts, _ = block(init_train_state(model, opt, method), 0)
    save_checkpoint(str(tmp_path / "ckpt_3"), state_tree(ts))
    save_checkpoint(str(tmp_path / "ckpt_12"), state_tree(ts))
    save_checkpoint(str(tmp_path / "ckpt_x"), {})
    it, path = latest_iteration_checkpoint(str(tmp_path))
    assert it == 12 and path.endswith("ckpt_12")
    fresh = init_train_state(make_wavefunctions(**SMALL, seed=9, device="cpu"), opt, method)
    load_state_tree(fresh, load_checkpoint(path))
    _assert_trees_equal(state_tree(fresh), state_tree(ts))
    os.makedirs(tmp_path / "empty")
    assert latest_iteration_checkpoint(str(tmp_path / "empty")) is None


class _TpMesh:
    """A mesh's names, sizes and groups, dp=1 x tp=2 (stand-in groups)."""
    mesh_dim_names = ("dp", "tp")
    groups = {"dp": object(), "tp": object()}

    def size(self, dim):
        return (1, 2)[dim]

    def get_group(self, axis):
        return self.groups[axis]


def test_train_operator_refuses_unported_options():
    """On a tp mesh: train_operator refuses a method not built for the
    mesh's groups (its ``axis_name`` the dp group, its ``mode_axis`` the tp
    group of the shards) before any step, SpIN and SpINx as NestedLoRA.
    (The tp path itself: tests/test_torch_tp.py, test_torch_tp_spin.py.)"""
    model, op, sampler, imp, method, opt = _setup()
    mesh = _TpMesh()
    shards = ModeShards(mesh.groups["tp"], L, {"base.ws.0": 0})
    for name in ("spin", "spinx"):
        spin = get_evd_method(name, model, L, axis_name=mesh.groups["dp"])
        with pytest.raises(ValueError, match="mode_axis"):
            train_operator(spin, op, sampler, opt, model, 4, mesh=mesh, shards=shards)
    with pytest.raises(ValueError, match="axis_name"):
        train_operator(method, op, sampler, opt, model, 4, mesh=mesh)
    method = NestedLoRA(model, neigs=L, sequential=True, axis_name=mesh.groups["dp"])
    with pytest.raises(ValueError, match="mode_axis"):
        train_operator(method, op, sampler, opt, model, 4, mesh=mesh, shards=shards)


# -- the monitor statistics ----------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 4), (513, 16), (7, 3)])
def test_batch_stats_match_jax(shape):
    """(9, L) erf-spaced percentiles and means, linear interpolation both:
    rtol 1e-5, atol 1e-6 of the largest |value|."""
    rng = np.random.default_rng(shape[0])
    v = (rng.standard_normal(shape) * 10.0 ** rng.integers(-2, 3, size=shape[1])).astype(
        np.float32)
    want = np.asarray(jax_train._batch_stats(jnp.asarray(v)))
    got = batch_stats(torch.as_tensor(v)).numpy()
    assert got.shape == (9, shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(v).max())


def test_ewm_monitor_matches_jax():
    """The copied monitor over 60 steps with a blow-up: the same means,
    variances, outlier flags and blow-up state (exact: the same numpy)."""
    rng = np.random.default_rng(0)
    a, b = jax_ewm.EWMMonitor(), ewm.EWMMonitor()
    for i in range(60):
        stat = rng.standard_normal(9) + (50.0 * (i - 30) if 30 <= i < 36 else 0.0)
        out_a, _ = a.update_stats(stat)
        out_b, _ = b.update_stats(stat)
        np.testing.assert_array_equal(out_a, out_b)
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)
        assert a.blowup.keys() == b.blowup.keys()
    x = rng.standard_normal(100)
    np.testing.assert_array_equal(a.update(x)[0], b.update(x)[0])
    assert a.mean_of("med") == b.mean_of("med")


# -- the eval's diagnostics --------------------------------------------------

def _accumulators(kind, Lm=6, seed=0):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((400, Lm))
    if kind in ("duplicate", "both"):
        phi[:, 4] = 0.9 * phi[:, 1] + 0.01 * phi[:, 4]
    if kind in ("dead", "both"):
        phi[:, 5] *= 1e-5
    t = np.linspace(5.0, 1.0, Lm)
    cov = phi.T @ phi / len(phi)
    quad = (phi * t).T @ phi / len(phi)
    return cov, quad


@pytest.mark.parametrize("kind", ["clean", "duplicate", "dead", "both"])
def test_mode_health_and_grouped_rayleigh_match_jax(kind):
    cov, quad = _accumulators(kind)
    want, got = jax_spectrum.mode_health(cov, quad), spectrum.mode_health(cov, quad)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert spectrum.format_mode_health(got) == jax_spectrum.format_mode_health(want)
    assert (spectrum.format_mode_health(got) == "") == (kind == "clean")
    for groups, full in (([1, 2, 3], None), ([2, 2, 2], cov)):
        np.testing.assert_array_equal(
            spectrum.grouped_rayleigh(np.diag(quad), np.diag(cov), groups, cov=full),
            jax_spectrum.grouped_rayleigh(np.diag(quad), np.diag(cov), groups, cov=full))


@pytest.mark.parametrize("kind", ["clean", "both"])
def test_post_alignment_and_spectrum_report_match_jax(kind):
    cov, quad = _accumulators(kind, seed=1)
    eigfuncs = np.random.default_rng(2).standard_normal((50, 6))
    with warnings.catch_warnings():  # the "both" case warns of a singular cov
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jax_spectrum.post_alignment(eigfuncs, cov, quad)
        got = spectrum.post_alignment(eigfuncs, cov, quad)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    gt = np.linspace(5.0, 2.0, 4)
    with np.errstate(all="ignore"):
        want = jax_spectrum.spectrum_report(cov, quad, gt, [1, 3], top=4)
        got = spectrum.spectrum_report(cov, quad, gt, [1, 3], top=4)
    for k, v in want.items():
        if k == "health":
            for hk in v:
                np.testing.assert_array_equal(got[k][hk], v[hk])
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_spectrum_eval_post_align_matches_jax_formula():
    """compute_spectrum_evd(post_align=True) adds the aligned outputs of
    post_alignment on its own (normalized) cov and quad."""
    model, op, sampler, imp, method, opt = _setup()
    x = sampler(torch.Generator().manual_seed(0))
    with np.errstate(all="ignore"):
        out = spectrum.compute_spectrum_evd(model, [x], op, importance_train=imp,
                                            normalize=True, post_align=True, device="cpu")
        ef, ev, orth = spectrum.post_alignment(out["eigfuncs"], out["cov"], out["quad"])
    np.testing.assert_array_equal(out["eigvals_aligned"], ev)
    np.testing.assert_array_equal(out["eigfuncs_aligned"], ef)


def test_plot_writers_write_the_arrays(tmp_path):
    rng = np.random.default_rng(0)
    ef = rng.standard_normal((64, 5)).astype(np.float32)
    path = plotting.plot_and_save_spectrum({"RQ": np.arange(5.0), "Norms^2": None},
                                           rng.standard_normal((5, 5)),
                                           ground_truth_spectrum=np.ones(5),
                                           log_dir=str(tmp_path), tag="it3",
                                           termplot=False)
    with np.load(path) as z:
        assert sorted(z) == ["ground_truth", "orthogonality", "spectrum_RQ"]
        assert (z["orthogonality"] >= 0).all()
    with np.load(plotting.plot_2d_eigfuncs(ef, str(tmp_path), tag="it3")) as z:
        np.testing.assert_array_equal(z["images"][2], ef[:, 2].reshape(8, 8))
    x = rng.standard_normal((64, 1))
    with np.load(plotting.plot_1d_eigfuncs(x, ef, str(tmp_path), tag="it3")) as z:
        assert (np.diff(z["x"]) >= 0).all() and z["eigfuncs"].shape == (64, 5)
    assert "RQ" in plotting.term_plot_spectrum({"RQ": [1.0, np.nan, 3.0]})


def test_eigenfunction_files_are_bounded(tmp_path):
    """At hydrogen.sh's grid (lim 50, val_eps 0.1: 1000 x 1000 points) and
    L 36, an eval's 2D eigenfunction file holds every 4th grid point along
    each axis, 36 x 250 x 250 float32 values, at most 10 MB; a 1D grid of
    10⁵ points is cut to at most 4096, in its sorted order; float64 input
    is written as float32."""
    data, _, _ = samplers.make_val_grid(2, 50.0, 0.1, 512)
    n = data.shape[0]
    assert n == 1000 * 1000
    rng = np.random.default_rng(0)
    ef = rng.standard_normal((n, 36), dtype=np.float32)
    path = plotting.plot_2d_eigfuncs(ef, str(tmp_path), tag="it10000")
    assert os.path.getsize(path) <= 10 * 2 ** 20
    with np.load(path) as z:
        images = z["images"]
    assert images.shape == (36, 250, 250) and images.dtype == np.float32
    np.testing.assert_array_equal(images[7], ef[:, 7].reshape(1000, 1000)[::4, ::4])
    del ef
    x = rng.uniform(-5, 5, (100_000, 1))
    ef1 = rng.standard_normal((100_000, 3))
    with np.load(plotting.plot_1d_eigfuncs(x, ef1, str(tmp_path), tag="it1")) as z:
        assert z["x"].shape == (4000,) and z["eigfuncs"].shape == (4000, 3)
        assert z["eigfuncs"].dtype == np.float32 and (np.diff(z["x"]) >= 0).all()
        order = np.argsort(x.ravel())[::25]
        np.testing.assert_array_equal(z["eigfuncs"], ef1[order].astype(np.float32))
