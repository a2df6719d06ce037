"""The port's mode rescue (training/rescue.py) against the JAX package's.

The same TrainState (the JAX init carried across with ``params_from_jax``,
non-trivial RMSprop moments) and the same synthetic accumulators go
through ``neuralsvd_tpu.training.rescue`` and its port.  Fresh draws and
clone noise are injected from JAX (a fresh init carried across; the clone
noise JAX folds into each leaf, passed by leaf name), so both packages
make the same surgery.  Permutations, splices and copies are exact;
values computed from them (clones, rescaled amplitudes) agree at rtol
1e-6.  The port changes the state in place: every tensor keeps its
address.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.models.wavefunctions import scale_mode_amplitudes as jax_scale_amplitudes
from neuralsvd_tpu.training import rescue as jax_rescue
from neuralsvd_tpu.training.optimizers import per_mode_lr as jax_per_mode_lr
from neuralsvd_tpu.training.optimizers import torch_rmsprop as jax_rmsprop
from neuralsvd_tpu.training.train_state import init_train_state as jax_init_train_state
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions, scale_mode_amplitudes
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.training import rescue
from neuralsvd_tpu_torch.training.optimizers import (
    build_optimizer,
    chain,
    cosine_annealing,
    per_mode_lr,
    torch_rmsprop,
)
from neuralsvd_tpu_torch.training.train_operator import train_operator
from neuralsvd_tpu_torch.training.train_state import init_train_state, state_pointers

L = 4
# the JAX rescue tests' model: per-mode towers with an exponential mask
WF = dict(ndim=2, neigs=L, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
          parallel=True, use_fourier_feature=True, fourier_mapping_size=32,
          fourier_scale=1.0, fourier_append_radial=True, apply_boundary=False,
          apply_exp_mask=True, exp_mask_init_scale=5.0)


def _synthetic_accumulators(rng, eigvals, dup_pairs=(), dead=(), n=20000):
    """cov/quad of modes f_i = a_i·u_i on orthonormal directions u, with
    modes made duplicates (mode i := amp·mode j) or dead (tiny norm); the
    JAX rescue tests' fixture."""
    L_ = len(eigvals)
    basis = np.linalg.qr(rng.standard_normal((n, L_ + 4)))[0]
    f = np.zeros((n, L_))
    lam = np.zeros(L_)
    for i, ev in enumerate(eigvals):
        f[:, i] = np.sqrt(ev) * basis[:, i] * np.sqrt(n)
        lam[i] = ev
    for i, j, amp in dup_pairs:
        f[:, i] = amp * f[:, j]
        lam[i] = lam[j]
    for i in dead:
        f[:, i] = 1e-6 * basis[:, L_ + 1] * np.sqrt(n)
        lam[i] = 0.5
    cov = f.T @ f / n
    return cov, cov * lam[None, :]


def _np(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _rms(state):
    """The RMSprop state inside a (possibly chained) optimizer state."""
    while not hasattr(state, "nu"):
        state = state[0]
    return state


def _with_rms(state, rms):
    """``state`` with its RMSprop state replaced by ``rms``."""
    if hasattr(state, "nu"):
        return rms
    return (_with_rms(state[0], rms),) + tuple(state[1:])


class Pair:
    """One TrainState in each package, equal leaf for leaf: params from the
    JAX init, EMA = params, RMSprop moments ν = momentum = |params| + 0.1."""

    def __init__(self, wf=WF, chained_scales=None):
        self.jinit, self.japply = jax_make_wavefunctions(**wf)
        neigs = wf["neigs"]
        params = self.jinit(jax.random.key(0))
        nz = jax.tree.map(lambda p: jnp.abs(p) + 0.1, params)
        jopt, self.topt = jax_rmsprop(1e-3), torch_rmsprop(1e-3, momentum=0.9)
        if chained_scales is not None:
            jopt = optax.chain(jopt, jax_per_mode_lr(chained_scales, neigs))
            self.topt = chain(self.topt, per_mode_lr(chained_scales, neigs))
        jts = jax_init_train_state(params, jopt, _NoState())
        self.jts = jts._replace(opt_state=_with_rms(
            jts.opt_state, type(_rms(jts.opt_state))(nu=nz, momentum=nz)))
        self.model = make_wavefunctions(**wf, device="cpu")
        self.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        self.ts = init_train_state(self.model, self.topt, _NoState())
        moments = _np(nz)
        for tree in _rms(self.ts.opt_state):
            for k, v in tree.items():
                v.copy_(torch.as_tensor(moments[k]))
        self.pointers = state_pointers(self.ts)

    def fresh(self, key):
        """A fresh JAX init, and the port's init_fn returning it carried."""
        fresh = self.jinit(key)
        carried = {k: torch.as_tensor(v) for k, v in _np(fresh).items()}
        return (lambda _key: fresh), (lambda generator: carried)

    def assert_same(self, jts, rtol=0.0):
        """Params, EMA and both moments of the port equal JAX's (exactly,
        or at ``rtol``), and every tensor kept its address."""
        jrms, trms = _rms(jts.opt_state), _rms(self.ts.opt_state)
        for jtree, ttree in ((jts.params, self.ts.params),
                             (jts.ema_params, self.ts.ema_params),
                             (jrms.nu, trms.nu), (jrms.momentum, trms.momentum)):
            want = _np(jtree)
            assert set(want) == set(ttree)
            for k, w in want.items():
                got = ttree[k].detach().numpy()
                if rtol:
                    np.testing.assert_allclose(got, w, rtol=rtol, atol=1e-7, err_msg=k)
                else:
                    np.testing.assert_array_equal(got, w, err_msg=k)
        assert state_pointers(self.ts) == self.pointers


class _NoState:
    def init_state(self, params):
        return {}


def _jax_clone_noise(jparams, key, neigs, n_dst):
    """The per-leaf ε that ``jax_rescue.clone_perturb_tail`` folds from
    ``key`` (its counter runs over the mode leaves in JAX's tree order),
    by the port's leaf name."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    out, counter = {}, 0
    for path, leaf in leaves:
        if not (leaf.ndim >= 1 and leaf.shape[0] == neigs):
            continue
        counter += 1
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = ".".join(str(k) for k in keys)
        eps = jax.random.normal(jax.random.fold_in(key, counter),
                                (n_dst,) + leaf.shape[1:], leaf.dtype)
        out[name] = np.array(eps)
    return out


def _x(n=8, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 2)).astype(np.float32)


def test_tree_permute_modes_roundtrip():
    """A permutation of every mode tensor equals JAX's, exactly; the model
    outputs are the permuted outputs; the inverse restores the state."""
    p = Pair()
    x = _x()
    out = p.model(torch.as_tensor(x)).detach().numpy()
    perm = np.array([2, 0, 3, 1])
    want = _np(jax_rescue.tree_permute_modes(p.jts.params, perm))
    before = {k: v.detach().clone() for k, v in p.ts.params.items()}
    rescue.tree_permute_modes(p.ts.params, perm)
    for k, w in want.items():
        np.testing.assert_array_equal(p.ts.params[k].detach().numpy(), w, err_msg=k)
    np.testing.assert_allclose(p.model(torch.as_tensor(x)).detach().numpy(),
                               out[:, perm], rtol=1e-6)
    rescue.tree_permute_modes(p.ts.params, np.argsort(perm))
    for k, v in before.items():
        assert torch.equal(p.ts.params[k], v)
    assert state_pointers(p.ts) == p.pointers


@pytest.mark.parametrize("case", ["fresh", "amplitude", "all-spurious", "clone", "grace"])
def test_rescue_modes_matches_jax(case):
    """Each path of rescue_modes on the same state and accumulators: the
    plan, the permutation, the fresh splice with zeroed moments or the
    perturbed clones with inherited moments, the amplitude factors and the
    tail EMA equal JAX's."""
    p = Pair()
    rng = np.random.default_rng(2)
    cov, quad = _synthetic_accumulators(rng, [100.0, 100.0, 4.0, 11.0],
                                        dup_pairs=[(1, 0, 0.4)])
    key = jax.random.key(9)
    jinit_fn, tinit_fn = p.fresh(key)
    kw, tkw = {}, {}
    xn = _x(256, seed=5)

    def jnorms(params):
        f = p.japply(params, jnp.asarray(xn))
        return np.asarray(jnp.mean(f * f, axis=0))

    def tnorms(params):
        with torch.no_grad():
            f = torch.func.functional_call(p.model, params, (torch.as_tensor(xn),))
        return torch.mean(f * f, dim=0).numpy()

    if case == "amplitude":
        kw = dict(measure_norms=jnorms, scale_fn=jax_scale_amplitudes)
        tkw = dict(measure_norms=tnorms, scale_fn=scale_mode_amplitudes)
    elif case == "all-spurious":
        cov, quad = np.zeros((L, L)), np.zeros((L, L))
        kw = dict(clone_healthy_tail=True, measure_norms=lambda _: np.ones(L),
                  scale_fn=lambda params, idx, f: params)
        tkw = dict(clone_healthy_tail=True, measure_norms=lambda _: np.ones(L),
                   scale_fn=lambda params, idx, f: None)
    elif case in ("clone", "grace"):
        kw = dict(clone_healthy_tail=True, measure_norms=jnorms,
                  scale_fn=jax_scale_amplitudes)
        tkw = dict(clone_healthy_tail=True, measure_norms=tnorms,
                   scale_fn=scale_mode_amplitudes)
        if case == "grace":  # the duplicate's slot is under grace
            kw["grace_slots"] = tkw["grace_slots"] = [1]
    jts, jinfo = jax_rescue.rescue_modes(p.jts, jinit_fn, key, cov, quad, L, **kw)
    noise = {}
    if "perm" in jinfo:
        permuted = jax_rescue.tree_permute_modes(p.jts.params, jinfo["perm"])
        noise = _jax_clone_noise(permuted, key, L, jinfo["n_spurious"])
    ts, info = rescue.rescue_modes(p.ts, tinit_fn, torch.Generator().manual_seed(0),
                                   cov, quad, L, draw=lambda name, shape: noise[name],
                                   **tkw)
    assert ts is p.ts
    assert info["n_spurious"] == jinfo["n_spurious"]
    if case == "grace":
        assert info["n_spurious"] == 0
        p.assert_same(p.jts)
        return
    np.testing.assert_array_equal(info["perm"], jinfo["perm"])
    np.testing.assert_array_equal(info["tail_slots"], jinfo["tail_slots"])
    np.testing.assert_allclose(info["amplitude_factors"], jinfo["amplitude_factors"],
                               rtol=1e-5)
    if case == "all-spurious":
        assert info["n_spurious"] == L and "clone_sources" not in info
    if case == "clone":
        np.testing.assert_array_equal(info["clone_sources"], jinfo["clone_sources"])
        np.testing.assert_array_equal(info["perm"], [0, 3, 2, 1])
    p.assert_same(jts, rtol=0.0 if case in ("fresh", "all-spurious") else 1e-6)


def test_rescue_noop_when_healthy_and_dead_slot_under_grace():
    """A healthy spectrum changes nothing (bit for bit); a dead slot under
    grace is still exiled, as in JAX."""
    p = Pair()
    rng = np.random.default_rng(3)
    cov, quad = _synthetic_accumulators(rng, [100.0, 11.0, 4.0, 2.0])
    before = [v.detach().clone() for v in p.ts.params.values()]
    _, info = rescue.rescue_modes(p.ts, None, None, cov, quad, L)
    assert info["n_spurious"] == 0
    assert all(torch.equal(a, b) for a, b in zip(before, p.ts.params.values()))
    cov_d, quad_d = _synthetic_accumulators(rng, [100.0, 11.0, 4.0, 2.0], dead=[3])
    _, jinfo = jax_rescue.rescue_modes(p.jts, p.fresh(jax.random.key(5))[0],
                                       jax.random.key(5), cov_d, quad_d, L,
                                       clone_healthy_tail=True, grace_slots=[3])
    _, info = rescue.rescue_modes(p.ts, None, torch.Generator().manual_seed(0),
                                  cov_d, quad_d, L, clone_healthy_tail=True,
                                  grace_slots=[3])
    assert info["n_spurious"] == jinfo["n_spurious"] == 1


@pytest.mark.parametrize("seed", range(4))
def test_rescue_plan_matches_jax(seed):
    """Healthy modes first by Rayleigh descending, spurious by norm
    descending: the same permutation as JAX on random health reports (and
    the JAX test's hand-made one)."""
    rng = np.random.default_rng(seed)
    if seed == 0:
        health = {"healthy": np.array([True, False, True, True]),
                  "rayleigh": np.array([4.0, 50.0, 100.0, 11.0]),
                  "norms": np.array([4.0, 0.5, 100.0, 11.0])}
    else:
        n = 12
        health = {"healthy": rng.random(n) < 0.6, "rayleigh": rng.standard_normal(n),
                  "norms": rng.random(n)}
    perm, n_bad = rescue.rescue_plan(health)
    jperm, jn_bad = jax_rescue.rescue_plan(health)
    assert n_bad == jn_bad
    np.testing.assert_array_equal(perm, jperm)
    if seed == 0:
        np.testing.assert_array_equal(perm, [2, 3, 0, 1])


def test_rescue_with_chained_per_mode_lr_matches_jax_and_steps():
    """The L = 36 gate's optimizer chains RMSprop with per_mode_lr: the
    clone rescue walks the chained state as JAX does, and the rescued
    state takes a finite optimizer update."""
    n = 6
    wf = dict(WF, neigs=n, mlp_hidden_dims=[8, 8], fourier_mapping_size=16)
    scales = np.where(np.arange(n) >= 4, 3.0, 1.0).astype(np.float32)
    p = Pair(wf, chained_scales=scales)
    cov = np.eye(n)
    cov[5, 5] = 1e-8
    cov[0, 5] = cov[5, 0] = 9.9e-5  # a tiny duplicate of mode 0
    quad = np.diag([10.0, 8.0, 6.0, 5.0, 4.0, 1e-7])
    key = jax.random.key(1)
    jts, jinfo = jax_rescue.rescue_modes(p.jts, p.fresh(key)[0], key, cov, quad, n,
                                         clone_healthy_tail=True)
    permuted = jax_rescue.tree_permute_modes(p.jts.params, jinfo["perm"])
    noise = _jax_clone_noise(permuted, key, n, jinfo["n_spurious"])
    _, info = rescue.rescue_modes(p.ts, None, None, cov, quad, n, clone_healthy_tail=True,
                                  draw=lambda name, shape: noise[name])
    assert info["n_spurious"] == jinfo["n_spurious"] >= 1
    p.assert_same(jts, rtol=1e-6)
    grads = {k: torch.ones_like(v) for k, v in p.ts.params.items()}
    updates, _ = p.topt.update(grads, p.ts.opt_state, p.ts.params)
    assert all(torch.isfinite(u).all() for u in updates.values())


def test_clone_noise_comes_from_the_generator():
    """Without ``draw`` the clones' ε come from the CPU generator: the same
    seed gives the same clones, another seed other ones; each clone
    differs from its source."""
    outs = []
    for seed in (0, 0, 1):
        p = Pair()
        rescue.clone_perturb_tail(p.ts.params, L, [1], [3],
                                  torch.Generator().manual_seed(seed))
        outs.append(p.ts.params["base.ws.0"].detach().clone())
        assert not torch.equal(outs[-1][3], outs[-1][1])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_train_operator_rescue_wiring(caplog):
    """The driver's rescue end to end on the CPU: a mode whose last layer is
    zero (a true fixed point: it gets no gradient) is diagnosed at the
    first eval, logged and rescued in place by a clone of a healthy mode
    (the state tensors keep their addresses; the tail EMA equals its
    params), and the run goes on to the three distinct oscillator modes."""
    neigs, num_iters = 3, 1200
    operator, _, _ = get_problem(problem="sch", potential_type="harmonic_oscillator",
                                 ndim=1, neigs=neigs, laplacian_eps=0.1,
                                 operator_shift=10.0)
    wf = dict(ndim=1, neigs=neigs, mlp_hidden_dims=[32, 32], nonlinearity="softplus",
              parallel=True, apply_boundary=True, lim=4.0)
    model = make_wavefunctions(**wf, seed=0, device="cpu")
    with torch.no_grad():
        model.base.ws[-1][1].zero_()
        model.base.bs[-1][1].zero_()
    sampler, importance = get_sampler("gaussian", 256, 1, 1, 1.0, device="cpu")
    method = NestedLoRA(model, neigs=neigs, sequential=True)
    opt = build_optimizer("rmsprop", 1e-3, lr_schedule=cosine_annealing(1e-3, num_iters))
    ts = init_train_state(model, opt, method)
    pointers = state_pointers(ts)
    checkpoints = []

    def init_fn(generator):
        fresh = make_wavefunctions(**wf, generator=generator, device="cpu")
        return {k: v.detach() for k, v in fresh.named_parameters()}

    def checkpoint_fn(ts_, it, outputs):
        checkpoints.append((it, {k: v.detach().clone() for k, v in ts_.params.items()},
                            {k: v.clone() for k, v in ts_.ema_params.items()}))

    grid = np.linspace(-4, 4, 512, dtype=np.float32).reshape(-1, 1)
    with caplog.at_level(logging.INFO, logger="neuralsvd_tpu_torch.training.train_operator"):
        ts_out, all_eigvals, _ = train_operator(
            method, operator, sampler, opt, model, num_iters=num_iters,
            importance_train=importance, val_batches=lambda: [grid], ema_decay=0.995,
            eval_freq=400, print_freq=200, seed=3, rescue_init_fn=init_fn,
            initial_ts=ts, checkpoint_fn=checkpoint_fn)
    assert ts_out is ts and state_pointers(ts) == pointers
    assert "DEAD" in caplog.text or "DUPLICATE" in caplog.text
    assert "it400 rescue: exiled + re-initialized" in caplog.text
    assert "state tensors kept in place" in caplog.text
    it, params, ema = checkpoints[0]
    assert it == 400
    for k in params:  # the rescued tail slot: EMA = params
        torch.testing.assert_close(ema[k][-1], params[k][-1], rtol=0, atol=0)
    # the rescued run reaches the oscillator's top three (-H + 10: 9, 7, 5)
    ev = np.sort(np.asarray(all_eigvals[-1]))[::-1]
    err = np.abs(ev - [9.0, 7.0, 5.0]) / [9.0, 7.0, 5.0]
    assert err.max() < 0.05, ev
