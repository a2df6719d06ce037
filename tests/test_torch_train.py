"""The slice as a whole: the port's E4-style train step vs the JAX package.

A small E4 configuration (hydrogen-2D, per-mode softplus towers, Fourier +
radial + envelope features, gaussian_mixture sampling with √w conjugation,
exact nested-JVP Laplacian, operator_scale 100, sequential nesting,
torch-parity RMSprop, EMA 0.995) runs three steps in JAX on fixed numpy
batches.  Before each step the port is given the JAX state (params,
RMSprop second moments, EMA, step) and runs its own step on the same batch.

Why the state is carried across each step: RMSprop's first update is
lr·sign(g)/√(1-α), whatever |g|.  Where a gradient entry is at f32 noise
level its sign is arbitrary, and two correct implementations then move
that parameter 2·lr/√(1-α) apart.  Loss and gradients are compared tightly
on identical params; the optimizer is compared separately on identical
gradients; post-step params and EMA are compared tightly where the
gradient is resolved, and within that RMSprop sign bound elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.data.samplers import get_sampler as jax_get_sampler
from neuralsvd_tpu.methods.nestedlora import NestedLoRA as JaxNestedLoRA
from neuralsvd_tpu.methods.spectrum import compute_spectrum_evd as jax_spectrum
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.operators.problems import get_problem as jax_get_problem
from neuralsvd_tpu.training.optimizers import torch_rmsprop as jax_rmsprop
from neuralsvd_tpu.training.train_operator import make_train_step as jax_make_train_step
from neuralsvd_tpu.training.train_state import ema_update as jax_ema_update
from neuralsvd_tpu.training.train_state import init_train_state as jax_init_train_state
from neuralsvd_tpu_torch.convert import params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_evd
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.training.optimizers import TorchRMSpropState, torch_rmsprop
from neuralsvd_tpu_torch.training.train_operator import make_train_step
from neuralsvd_tpu_torch.training.train_state import ema_update, init_train_state

L, B, STEPS = 4, 64, 3
LR, ALPHA, EMA = 1e-4, 0.999, 0.995
MIX = (0.5, 2.0, 6.0, 16.0)
SMALL = dict(ndim=2, neigs=L, mlp_hidden_dims=[16, 16, 16],
             nonlinearity="softplus", parallel=True, use_fourier_feature=True,
             fourier_mapping_size=16, fourier_scale=0.1,
             fourier_append_radial=True, fourier_append_envelopes=(2.0, 2 / 3),
             apply_boundary=False)
PROBLEM = dict(problem="sch", potential_type="hydrogen", ndim=2, neigs=L,
               laplacian_eps=-1.0, laplacian_mode="jvp", operator_scale=100.0)
# the most two correct RMSprop steps can differ by: opposite signs of a
# gradient at noise level, lr/√(1-α) each way
SIGN_BOUND = 2 * LR / np.sqrt(1 - ALPHA) * (1 + 1e-3)


def _batches(n, size=B, seed=0):
    rng = np.random.default_rng(seed)
    scales = rng.choice(MIX, size=(n, size, 1))
    return (scales * rng.normal(size=(n, size, 2))).astype(np.float32)


def _np_tree(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _assert_grads_close(got, ref):
    """rtol 1e-4 and atol 1e-6 in units of the tensor's largest entry:
    the grads here reach ~1e4 (operator_scale = 100), where one f32 ulp is
    ~1e-3, so an atol in absolute units could not be met by any f32 sum."""
    for k, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-4,
                                   atol=1e-6 * np.abs(r).max(), err_msg=k)


@pytest.fixture(scope="module", params=[(0.0, 0), (100.0, 10_000)],
                ids=["noclip-step0", "clip-step10000"])
def jax_run(request):
    """Three JAX train steps with their states, losses and gradients.

    Starting at step 0 the EMA decay is on its ramp (1+t)/(10+t); at step
    10000 it is ``EMA``."""
    grad_clip, start = request.param
    jinit, japply = jax_make_wavefunctions(**SMALL)
    _, jimp = jax_get_sampler("gaussian_mixture", B, 1, 2, MIX)
    jop, _, _ = jax_get_problem(**PROBLEM)
    method = JaxNestedLoRA(japply, neigs=L, sequential=True)
    opt = jax_rmsprop(LR, alpha=ALPHA)
    batches = _batches(STEPS)
    stacked = jnp.asarray(batches)

    def sampler(key):  # key(k) -> batch k
        return stacked[jax.random.key_data(key)[-1]]

    step = jax.jit(jax_make_train_step(method, jop, opt, sampler, importance=jimp,
                                       ema_decay=EMA, grad_clip=grad_clip))
    loss_and_grad = jax.jit(lambda p, x: method.loss_and_grad(p, {}, x, jop, jimp)[:2])
    ts = jax_init_train_state(jinit(jax.random.key(0)), opt, method)
    ts = ts._replace(step=jnp.asarray(start, jnp.int32))
    records = []
    for k in range(STEPS):
        loss, grads = loss_and_grad(ts.params, stacked[k])
        new_ts, metrics = step(ts, jax.random.key(k))
        assert not bool(metrics["skipped"])
        records.append(dict(
            params=_np_tree(ts.params), nu=_np_tree(ts.opt_state[0].nu),
            ema=_np_tree(ts.ema_params), loss=float(loss), grads=_np_tree(grads),
            step=int(ts.step), step_loss=float(metrics["loss"]),
            next_params=_np_tree(new_ts.params),
            next_nu=_np_tree(new_ts.opt_state[0].nu),
            next_ema=_np_tree(new_ts.ema_params)))
        ts = new_ts
    return grad_clip, batches, records


def _port_setup(grad_clip, batches):
    model = make_wavefunctions(**SMALL, device="cpu")
    _, timp = get_sampler("gaussian_mixture", B, 1, 2, MIX, device="cpu")
    top, _, _ = get_problem(**PROBLEM)
    method = NestedLoRA(model, neigs=L, sequential=True)
    opt = torch_rmsprop(LR, alpha=ALPHA)
    ts = init_train_state(model, opt, method)
    feed = {"k": 0}
    step = make_train_step(method, top, opt, lambda gen: torch.as_tensor(batches[feed["k"]]),
                           importance=timp, ema_decay=EMA, grad_clip=grad_clip)
    return model, method, top, timp, ts, step, feed


def _assert_step_close(got, ref, grads):
    """Tight (rtol 1e-5, atol a thousandth of one RMSprop step) where the
    gradient is resolved (|g| >= 1e-2 of the tensor's largest entry);
    within the RMSprop sign bound everywhere."""
    for k, r in ref.items():
        r, t, g = r.numpy(), got[k].numpy(), np.abs(grads[k].numpy())
        diff = np.abs(t - r)
        assert diff.max() <= SIGN_BOUND, k
        resolved = g >= 1e-2 * g.max()
        np.testing.assert_allclose(t[resolved], r[resolved], rtol=1e-5,
                                   atol=1e-3 * LR / np.sqrt(1 - ALPHA), err_msg=k)


def test_train_step_matches_jax(jax_run):
    grad_clip, batches, records = jax_run
    model, method, top, timp, ts, step, feed = _port_setup(grad_clip, batches)
    for k, rec in enumerate(records):
        with torch.no_grad():
            for name, p in ts.params.items():
                p.copy_(rec["params"][name])
        # the step writes the state in place: give it copies of the records
        ts.opt_state = TorchRMSpropState(
            nu={k: v.clone() for k, v in rec["nu"].items()}, momentum={})
        ts.ema_params = {k: v.clone() for k, v in rec["ema"].items()}
        ts.step.fill_(rec["step"])
        feed["k"] = k
        loss, grads, _, _ = method.loss_and_grad(ts.params, {}, torch.as_tensor(batches[k]),
                                                 top, timp)
        np.testing.assert_allclose(loss.item(), rec["loss"], rtol=1e-5)
        _assert_grads_close(grads, rec["grads"])

        ts, metrics = step(ts, None)
        assert not bool(metrics["skipped"])
        np.testing.assert_allclose(metrics["loss"].item(), rec["step_loss"], rtol=1e-5)
        _assert_step_close({n: p.detach() for n, p in ts.params.items()},
                           rec["next_params"], rec["grads"])
        _assert_step_close(ts.ema_params, rec["next_ema"], rec["grads"])
        for name, r in rec["next_nu"].items():
            # ν holds g²: twice the gradients' relative tolerance
            np.testing.assert_allclose(ts.opt_state.nu[name].numpy(), r.numpy(),
                                       rtol=2e-4, atol=2e-6 * r.abs().max().item())
        assert int(ts.step) == rec["step"] + 1


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_rmsprop_update_matches_jax_and_torch_optim(momentum):
    """Identical gradients through three updates: the port's written-out
    RMSprop against the JAX package's and against torch.optim.RMSprop
    (rtol 1e-6: the same f32 arithmetic in a different order)."""
    rng = np.random.default_rng(0)
    shapes = {"base.ws.0": (3, 5, 7), "base.bs.0": (3, 5, 1)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 3, size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    def as_jax(d):
        return {"base": {"ws": [jnp.asarray(d["base.ws.0"])],
                         "bs": [jnp.asarray(d["base.bs.0"])], "feature_map": {}}}

    jopt = jax_rmsprop(LR, alpha=ALPHA, momentum=momentum)
    jparams = as_jax(params)
    jstate = jopt.init(jparams)
    topt = torch_rmsprop(LR, alpha=ALPHA, momentum=momentum)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init(tparams)
    ref = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    torch_optim = torch.optim.RMSprop(list(ref.values()), lr=LR, alpha=ALPHA,
                                      eps=1e-10, momentum=momentum)
    for g in grads:
        jupd, jstate = jopt.update(as_jax(g), jstate)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        tupd, tstate = topt.update({k: torch.tensor(v) for k, v in g.items()}, tstate)
        tparams = {k: p + tupd[k] for k, p in tparams.items()}
        for k, p in ref.items():
            p.grad = torch.tensor(g[k])
        torch_optim.step()
        np.testing.assert_allclose(_np_tree_port(tupd), _np_tree_port(_np_tree(jupd)),
                                   rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), _np_tree(jparams)[k].numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(tparams[k].numpy(), ref[k].detach().numpy(),
                                   rtol=1e-6)


def _np_tree_port(d):
    return np.concatenate([d[k].numpy().ravel() for k in sorted(d)])


@pytest.mark.parametrize("step", [None, 0, 3, 10_000])
def test_ema_update_matches_jax(step):
    rng = np.random.default_rng(1)
    e = rng.normal(size=(4, 3)).astype(np.float32)
    p = rng.normal(size=(4, 3)).astype(np.float32)
    jstep = None if step is None else jnp.asarray(step, jnp.int32)
    expect = np.asarray(jax_ema_update(jnp.asarray(e), jnp.asarray(p), EMA, step=jstep))
    got = ema_update({"w": torch.tensor(e)}, {"w": torch.tensor(p)}, EMA, step=step)
    np.testing.assert_allclose(got["w"].numpy(), expect, rtol=1e-6, atol=1e-7)


def test_train_step_skips_nonfinite_batches():
    """A NaN-producing batch leaves params and optimizer state untouched
    and flags metrics['skipped'] (mirror of the JAX test)."""
    rng = np.random.default_rng(0)

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(rng.normal(size=(2, 3)).astype(np.float32)))

        def forward(self, x):
            return x @ self.w

    def operator(f, x, importance=None):
        fs = f(x)
        with torch.no_grad():
            bad = torch.mean(x) > 0  # NaN whenever the batch mean is positive
            Tf = torch.where(bad, torch.nan, 1.0) * fs
        return Tf, fs

    model = Linear()
    method = NestedLoRA(model, neigs=3)
    opt = torch_rmsprop(1e-2)
    step = make_train_step(method, operator, opt,
                           lambda gen: torch.randn(16, 2, generator=gen))
    ts = init_train_state(model, opt, method)
    gen = torch.Generator().manual_seed(0)
    seen_skip = seen_ok = False
    for _ in range(12):
        prev = ts.params["w"].detach().clone()
        prev_nu = ts.opt_state.nu["w"].clone()
        ts, m = step(ts, gen)
        if bool(m["skipped"]):
            seen_skip = True
            assert torch.equal(ts.params["w"], prev)
            assert torch.equal(ts.opt_state.nu["w"], prev_nu)
        else:
            seen_ok = True
            assert (ts.params["w"] - prev).abs().max() > 0
        assert torch.isfinite(ts.params["w"]).all()
    assert seen_skip and seen_ok
    assert ts.step == 12


@pytest.mark.parametrize("normalize,sort,const", [(False, False, False),
                                                  (True, True, False),
                                                  (False, False, True)])
def test_compute_spectrum_evd_matches_jax(normalize, sort, const):
    """Cov/quad Rayleigh eval with the train→val reweighting, the
    non-finite zeroing and the singular-origin gate (a batch holds x = 0):
    rtol 1e-4 (float32 Laplacian), atol 1e-6 of each matrix's scale."""
    jinit, japply = jax_make_wavefunctions(**SMALL)
    params = jinit(jax.random.key(3))
    _, jimp = jax_get_sampler("gaussian_mixture", B, 1, 2, MIX)
    jop, _, _ = jax_get_problem(**PROBLEM)
    _, jimp_val = jax_get_sampler("gaussian", B, 1, 2, 4.0)
    batches = _batches(2, size=32, seed=5)
    batches[1, 0] = 0.0
    jmethod = JaxNestedLoRA(japply, neigs=L, sequential=True)
    expect = jax_spectrum((jmethod.eval_apply, params, {}), list(batches), jop,
                          importance_train=jimp, importance_val=jimp_val,
                          set_first_mode_const=const, normalize=normalize, sort=sort)

    model = make_wavefunctions(**SMALL, device="cpu")
    _, timp = get_sampler("gaussian_mixture", B, 1, 2, MIX, device="cpu")
    _, timp_val = get_sampler("gaussian", B, 1, 2, 4.0, device="cpu")
    top, _, _ = get_problem(**PROBLEM)
    method = NestedLoRA(model, neigs=L, sequential=True)
    got = compute_spectrum_evd((method.eval_apply, _np_tree(params), {}), list(batches),
                               top, importance_train=timp, importance_val=timp_val,
                               set_first_mode_const=const, normalize=normalize,
                               sort=sort, device="cpu")
    for key in ("eigvals", "norms", "cov", "quad", "eigfuncs"):
        ref = np.asarray(expect[key])
        np.testing.assert_allclose(got[key], ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=key)


@pytest.mark.parametrize("use_pallas,kernels", [
    ("auto", False), (True, True), ("true", True), (False, False), ("0", False),
])
def test_loss_route_and_equality(use_pallas, kernels):
    """On CPU tensors "auto" takes the plain path; True the kernel
    packaging (plain versions inside); both give the same loss and grads."""
    model = make_wavefunctions(**SMALL, device="cpu")
    _, timp = get_sampler("gaussian_mixture", B, 1, 2, MIX, device="cpu")
    top, _, _ = get_problem(**PROBLEM)
    x = torch.as_tensor(_batches(1)[0])
    params = dict(model.named_parameters())
    method = NestedLoRA(model, neigs=L, sequential=True, use_pallas=use_pallas)
    Tf, fs = top(method._model(params), x, timp)
    f1, f2 = torch.chunk(fs.contiguous(), 2)
    loss = method._evd_loss(fs.contiguous(), Tf, f1, f2)
    assert ("Kernels" in loss.grad_fn.name()) == kernels
    ref_loss, ref_grads, _, _ = NestedLoRA(model, neigs=L, sequential=True,
                                           use_pallas=False).loss_and_grad(
        params, {}, x, top, timp)
    got_loss, got_grads, _, _ = method.loss_and_grad(params, {}, x, top, timp)
    np.testing.assert_allclose(got_loss.item(), ref_loss.item(), rtol=1e-5)
    _assert_grads_close(got_grads, ref_grads)


def test_registered_eigvals_reorder_modes_like_jax():
    """register_eigvals sorts the model outputs by decreasing eigenvalue
    before the nested loss, as in the JAX method (same loss and grads)."""
    jinit, japply = jax_make_wavefunctions(**SMALL)
    params = jinit(jax.random.key(4))
    _, jimp = jax_get_sampler("gaussian_mixture", B, 1, 2, MIX)
    jop, _, _ = jax_get_problem(**PROBLEM)
    eigvals = [1.0, 7.0, -2.0, 3.0]
    jmethod = JaxNestedLoRA(japply, neigs=L, sequential=True)
    jmethod.register_eigvals(eigvals)
    x = _batches(1, seed=9)[0]
    jloss, jgrads, _, _ = jmethod.loss_and_grad(params, {}, jnp.asarray(x), jop, jimp)

    model = make_wavefunctions(**SMALL, device="cpu")
    model.load_state_dict(_np_tree(params))
    _, timp = get_sampler("gaussian_mixture", B, 1, 2, MIX, device="cpu")
    top, _, _ = get_problem(**PROBLEM)
    method = NestedLoRA(model, neigs=L, sequential=True)
    method.register_eigvals(eigvals)
    np.testing.assert_array_equal(method.sort_indices, [1, 3, 0, 2])
    loss, grads, _, _ = method.loss_and_grad(dict(model.named_parameters()), {},
                                             torch.as_tensor(x), top, timp)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_grads_close(grads, _np_tree(jgrads))
