"""The port's CDK slice against the JAX package: loss, kernel packaging,
towers, method, train step, optimizers and the SVD spectrum.

The same numpy inputs, made from a seed, go through the JAX function and
its port.  Tolerances are the JAX tests' (tests/test_pallas_gram.py,
tests/test_nestedlora_ops.py): rtol 1e-5 on losses; rtol 1e-4 with atol
1e-6 on gradients, parameters and optimizer state (f32 sums in another
order; entries here are 1e-4..1, where atol 1e-6 covers the cancellation
residue of a batch sum).  The density ratios, dot products up to ~40,
take rtol 1e-5 with atol 1e-6 of their largest entry (the rounding of an
L-term f32 dot at that size).  The kernel packaging runs
its plain versions here (CPU tensors); tests/test_torch_cuda.py holds the
CUDA kernels against them at the paper's shape, on a GPU only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from neuralsvd_tpu.cli.sketchy import make_cdk_train_step as jax_make_cdk_train_step
from neuralsvd_tpu.methods.nestedlora import NestedLoRAForCDK as JaxNestedLoRAForCDK
from neuralsvd_tpu.methods.spectrum import compute_spectrum_svd as jax_spectrum_svd
from neuralsvd_tpu.models.two_tower import make_hetero_network
from neuralsvd_tpu.models.two_tower import normalize_embedding as jax_normalize
from neuralsvd_tpu.ops.masks import joint_nesting_masks, step_weights
from neuralsvd_tpu.ops.nestedlora import nestedlora_cdk_loss as jax_cdk_loss
from neuralsvd_tpu.ops.pallas_gram import nestedlora_cdk_loss_pallas
from neuralsvd_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from neuralsvd_tpu.training.optimizers import warmup_cosine_schedule as jax_warmup_cosine
from neuralsvd_tpu_torch.cli.sketchy import make_cdk_train_step
from neuralsvd_tpu_torch.convert import hetero_params_from_jax
from neuralsvd_tpu_torch.methods.factories import get_cdk_method
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRAForCDK
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_svd
from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork, normalize_embedding
from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.ops.cuda_gram import nestedlora_cdk_loss_kernels
from neuralsvd_tpu_torch.ops.nestedlora import nestedlora_cdk_loss
from neuralsvd_tpu_torch.training.optimizers import build_optimizer, warmup_cosine_schedule

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# (B, L): L = 5 and B = 96 are unaligned on purpose
SHAPES = [(96, 5), (256, 16)]
WEIGHTS = [None, "uniform"]


def _loss_inputs(B, L, const, weights, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(B, L)).astype(np.float32)
    g = (0.5 * f + rng.normal(size=(B, L))).astype(np.float32)
    vmask, mmask = joint_nesting_masks(step_weights(L), set_first_mode_const=const)
    bw = (rng.uniform(0.5, 1.5, size=(B, 1)).astype(np.float32)
          if weights == "uniform" else None)
    return f, g, np.asarray(vmask), np.asarray(mmask), bw


def _t(a, grad=False):
    return None if a is None else torch.tensor(np.asarray(a), requires_grad=grad)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _jax_cdk(loss_fn, f, g, vmask, mmask, bw):
    """JAX outputs and the gradients of the loss output w.r.t. f and g."""
    out = loss_fn(_j(f), _j(g), _j(vmask), _j(mmask), _j(bw))
    grads = jax.grad(lambda a, b: loss_fn(a, b, _j(vmask), _j(mmask), _j(bw))[0],
                     argnums=(0, 1))(_j(f), _j(g))
    return [np.asarray(o) for o in out], [np.asarray(x) for x in grads]


def _port_cdk(loss_fn, const, f, g, vmask, mmask, bw):
    tf, tg = _t(f, True), _t(g, True)
    out = loss_fn(const, tf, tg, _t(vmask), _t(mmask), _t(bw), return_ratios=True)
    grads = torch.autograd.grad(out[0], [tf, tg])
    return [o.detach().numpy() for o in out], [x.numpy() for x in grads]


def _assert_cdk_close(got, want):
    (out, grads), (jout, jgrads) = got, want
    for name, o, r in zip(("loss", "loss_operator", "loss_metric"), out[:3], jout[:3]):
        _close(o, r, LOSS_RTOL, err_msg=name)
    for name, o, r in zip(("rs_joint", "rs_indep"), out[3:], jout[3:]):
        assert o.shape == r.shape, name
        _close(o, r, LOSS_RTOL, 1e-6 * np.abs(r).max(), err_msg=name)
    for name, o, r in zip(("grad_f", "grad_g"), grads, jgrads):
        _close(o, r, GRAD_RTOL, GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("const", [True, False])
@pytest.mark.parametrize("B,L", SHAPES)
def test_plain_cdk_loss_matches_jax(B, L, const, weights):
    inputs = _loss_inputs(B, L, const, weights)
    want = _jax_cdk(lambda *a: jax_cdk_loss(None, const, *a), *inputs)
    _assert_cdk_close(_port_cdk(nestedlora_cdk_loss, const, *inputs), want)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("const", [True, False])
@pytest.mark.parametrize("B,L", SHAPES)
def test_cdk_kernel_packaging_matches_pallas(B, L, const, weights):
    """On CPU tensors the packaging's wrappers take their plain versions;
    the Pallas packaging runs in interpret mode."""
    inputs = _loss_inputs(B, L, const, weights, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_cdk(lambda *a: nestedlora_cdk_loss_pallas(const, *a), *inputs)
    cuda_gram.reset_launch_counts()
    _assert_cdk_close(_port_cdk(nestedlora_cdk_loss_kernels, const, *inputs), want)
    assert set(cuda_gram.launch_counts().values()) == {0}  # plain versions only


def test_cdk_ratios_only_on_request():
    f, g, vmask, mmask, _ = _loss_inputs(96, 5, True, None)
    for fn in (nestedlora_cdk_loss, nestedlora_cdk_loss_kernels):
        out = fn(True, _t(f), _t(g), _t(vmask), _t(mmask))
        assert out[3] is None and out[4] is None
        assert not out[1].requires_grad and not out[2].requires_grad


def test_cdk_backward_ignores_batch_weight_chain():
    """The gradient handed to f is the one taken at the weighted f (the
    reference's estimator), not the chain rule through the weights."""
    f, g, vmask, mmask, bw = _loss_inputs(96, 5, False, "uniform")
    (_, grads), (_, plain) = (_port_cdk(nestedlora_cdk_loss, False, f, g, vmask, mmask, w)
                              for w in (bw, None))
    fw, gw = _t(f * bw, True), _t(g * bw, True)
    out = nestedlora_cdk_loss(False, fw, gw, _t(vmask), _t(mmask))
    at_weighted = torch.autograd.grad(out[0], [fw, gw])
    for got, want in zip(grads, at_weighted):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)
    assert not np.allclose(grads[0], plain[0])


@pytest.mark.parametrize("mode", ["l2_ball", "l2_sphere", "clip", "tanh"])
@pytest.mark.parametrize("r_up", [2.0, 0.0])
def test_normalize_embedding_matches_jax(mode, r_up):
    z = (np.random.default_rng(0).normal(size=(64, 8)) * 1.5).astype(np.float32)
    want = np.asarray(jax_normalize(jnp.asarray(z), r_up, mode))
    got = normalize_embedding(torch.as_tensor(z), r_up, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


SMALL = dict(input_dim=16, network_dims=[64, 16], nonlinearity="lrelu0.2", mu=4.0)


def _towers(seed=0, regularize_mode="l2_ball"):
    init, apply, apply_single = make_hetero_network(**SMALL, regularize_mode=regularize_mode)
    jparams = init(jax.random.key(seed))
    port = HeteroNetwork(**SMALL, regularize_mode=regularize_mode)
    params = hetero_params_from_jax(jax.tree.map(np.asarray, jparams))
    port.load_state_dict(params)
    return (jparams, apply, apply_single), port, params


def _pairs(B, seed=0, D=16):
    rng = np.random.default_rng(seed)
    x = (2 * rng.normal(size=(B, D))).astype(np.float32)
    y = (x + rng.normal(size=(B, D))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("mode", ["l2_ball", "tanh"])
def test_hetero_network_matches_jax(mode):
    (jparams, apply, apply_single), port, params = _towers(regularize_mode=mode)
    assert set(params) == set(port.state_dict())
    x, y = _pairs(96)
    jf, jg = apply(jparams, jnp.asarray(x), jnp.asarray(y))
    tf, tg = port(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    ty = port.apply_single(torch.as_tensor(y), "y").detach().numpy()
    np.testing.assert_allclose(ty, np.asarray(apply_single(jparams, jnp.asarray(y), "y")),
                               rtol=1e-5, atol=1e-6)


def test_hetero_init_matches_jax_distribution():
    """The init draws U(-1/√fan_in, 1/√fan_in) for weights and biases, as
    the JAX package does (its numbers differ: other generators)."""
    port = HeteroNetwork(input_dim=256, network_dims=[512, 64],
                         generator=torch.Generator().manual_seed(0))
    for name, p in port.state_dict().items():
        fan_in = 256 if ".layers.0." in name else 512
        bound = 1 / np.sqrt(fan_in)
        assert p.abs().max() <= bound
        assert p.abs().max() > 0.95 * bound, name
        np.testing.assert_allclose(p.std().item(), bound / np.sqrt(3), rtol=0.1)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B", [96, 256])
def test_method_loss_and_grad_matches_jax(B, use_pallas):
    (jparams, apply, _), port, params = _towers()
    params = {k: p.requires_grad_() for k, p in params.items()}
    x, y = _pairs(B, seed=B)
    jm = JaxNestedLoRAForCDK(apply, neigs=16)
    jloss, jgrads, jaux, _ = jm.loss_and_grad(jparams, {}, jnp.asarray(x), jnp.asarray(y))
    method = get_cdk_method("neuralsvd", port, 16, use_pallas=use_pallas)
    assert isinstance(method, NestedLoRAForCDK)
    loss, grads, aux, _ = method.loss_and_grad(params, {}, torch.as_tensor(x),
                                               torch.as_tensor(y))
    _close(loss.item(), float(jloss), LOSS_RTOL)
    for k in ("loss_operator", "loss_metric"):
        _close(aux[k].item(), float(jaux[k]), LOSS_RTOL, err_msg=k)
    _close(aux["f"].numpy(), jaux["f"], 1e-5, 1e-6)  # the towers' outputs
    jg = hetero_params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(jg)
    for k, g in grads.items():
        _close(g.numpy(), jg[k].numpy(), GRAD_RTOL, GRAD_ATOL, err_msg=k)


# -- optimizers --------------------------------------------------------------

def test_warmup_cosine_schedule_matches_jax():
    jsched = jax_warmup_cosine(5e-3, 1e-4, 1e-5, 3, 10)
    sched = warmup_cosine_schedule(5e-3, 1e-4, 1e-5, 3, 10)
    for step in range(12):
        got = sched(torch.tensor(step, dtype=torch.int32)).item()
        np.testing.assert_allclose(got, float(jsched(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {}),
    ("sgd", dict(momentum=0.9, weight_decay=1e-2)),
    ("sgd", dict(momentum=0.0)),
    ("rmsprop", dict(momentum=0.9)),
    ("adamw", dict(weight_decay=1e-2)),
    ("lars", dict(momentum=0.9, weight_decay=1e-2)),
    ("lars", dict(momentum=0.0)),
], ids=["adam", "sgd-momentum-wd", "sgd", "rmsprop", "adamw", "lars-momentum-wd",
        "lars"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_build_optimizer_matches_jax(name, kwargs, scheduled):
    """Three updates on identical gradients (rtol 1e-5: the same f32
    arithmetic in another order; atol 1e-9, far below any update here)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2, size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    lr = 1e-2
    jsched = jax_warmup_cosine(lr, 0.0, 1e-3, 1, 4) if scheduled else None
    sched = warmup_cosine_schedule(lr, 0.0, 1e-3, 1, 4) if scheduled else None
    jopt = jax_build_optimizer(name, lr, lr_schedule=jsched, **kwargs)
    topt = build_optimizer(name, lr, lr_schedule=sched, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        for k in shapes:
            _close(tu[k].numpy(), ju[k], 1e-5, 1e-9, err_msg=k)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}


def test_unported_optimizers_raise():
    """adamw and lars (once refused) against optax where the order of their
    parts shows: adamw decays after Adam's scaling, and lars takes a trust
    ratio of 1 for a tensor whose parameter or update norm is 0 (rtol
    1e-5); an unknown name still raises."""
    params = {"zero": np.zeros((3, 4), np.float32),
              "w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
              "still": np.ones((5,), np.float32)}
    grads = {"zero": np.full((3, 4), 0.5, np.float32),
             "w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
             "still": np.zeros((5,), np.float32)}
    for name, kw in (("adamw", dict(weight_decay=0.1)),
                     ("lars", dict(momentum=0.9, weight_decay=0.0))):
        jopt = jax_build_optimizer(name, 1e-2, **kw)
        topt = build_optimizer(name, 1e-2, **kw)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: torch.tensor(v) for k, v in params.items()}
        ju, _ = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jopt.init(jp), jp)
        tu, _ = topt.update({k: torch.tensor(v) for k, v in grads.items()}, topt.init(tp), tp)
        for k in params:
            _close(tu[k].numpy(), ju[k], 1e-5, 1e-9, err_msg=f"{name} {k}")
    with pytest.raises(NotImplementedError):
        build_optimizer("lamb", 1e-3)


# -- the train step ----------------------------------------------------------

LR, WARMUP, TOTAL, CLIP = 5e-3, 2, 6, 0.05
STEPS = 3


def _jax_sgd_state_to_port(jstate):
    """optax chain (trace, scale_by_schedule) -> the port's (trace, count)."""
    trace = hetero_params_from_jax(jax.tree.map(np.asarray, jstate[0].trace))
    return (trace, {"count": torch.tensor(int(jstate[1].count), dtype=torch.int32)})


def test_cdk_train_step_matches_jax():
    """Three SGD-momentum steps under warmup-cosine and an active grad
    clip; before each step the port takes the JAX state (params, momentum
    trace, schedule count) and its step is compared with JAX's."""
    (jparams, apply, _), port, params = _towers(seed=1)
    jm = JaxNestedLoRAForCDK(apply, neigs=16)
    jopt = jax_build_optimizer("sgd", LR, momentum=0.9,
                               lr_schedule=jax_warmup_cosine(LR, 0.0, 0.0, WARMUP, TOTAL))
    jstep = jax_make_cdk_train_step(jm, jopt, grad_clip=CLIP)
    method = NestedLoRAForCDK(port, neigs=16)
    opt = build_optimizer("sgd", LR, momentum=0.9,
                          lr_schedule=warmup_cosine_schedule(LR, 0.0, 0.0, WARMUP, TOTAL))
    step = make_cdk_train_step(method, opt, grad_clip=CLIP)
    params = dict(port.named_parameters())
    jstate = jopt.init(jparams)
    jskips = jnp.zeros((), jnp.int32)
    for k in range(STEPS):
        x, y = _pairs(96, seed=10 + k)
        with torch.no_grad():
            for name, p in hetero_params_from_jax(jax.tree.map(np.asarray, jparams)).items():
                params[name].copy_(p)
        state = _jax_sgd_state_to_port(jstate)
        _, jgrads, _, _ = jm.loss_and_grad(jparams, {}, jnp.asarray(x), jnp.asarray(y))
        gnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(jgrads))))
        assert gnorm > CLIP  # the clip acts
        jparams, jstate, _, jloss, _, jskips = jstep(
            jparams, jstate, {}, jnp.asarray(x), jnp.asarray(y), jskips)
        skips = torch.zeros((), dtype=torch.int32)
        params, state, _, loss, aux, skips = step(
            params, state, {}, torch.as_tensor(x), torch.as_tensor(y), skips)
        _close(loss.item(), float(jloss), LOSS_RTOL)
        assert int(skips) == 0 and int(jskips) == 0
        want = hetero_params_from_jax(jax.tree.map(np.asarray, jparams))
        want_state = _jax_sgd_state_to_port(jstate)
        for name, p in params.items():
            _close(p.detach().numpy(), want[name].numpy(), GRAD_RTOL, GRAD_ATOL, err_msg=name)
            _close(state[0][name].numpy(), want_state[0][name].numpy(), GRAD_RTOL,
                   GRAD_ATOL, err_msg=f"trace {name}")
        assert int(state[1]["count"]) == int(want_state[1]["count"]) == k + 1


def test_nonfinite_step_is_skipped_with_its_count():
    """A NaN in the batch makes the gradients non-finite: parameters, the
    momentum trace and the schedule count keep their old values, the skip
    counter goes up, and JAX does the same."""
    (jparams, apply, _), port, _ = _towers(seed=2)
    jm = JaxNestedLoRAForCDK(apply, neigs=16)
    jopt = jax_build_optimizer("sgd", LR, momentum=0.9,
                               lr_schedule=jax_warmup_cosine(LR, 0.0, 0.0, WARMUP, TOTAL))
    jstep = jax_make_cdk_train_step(jm, jopt, grad_clip=1.0)
    opt = build_optimizer("sgd", LR, momentum=0.9,
                          lr_schedule=warmup_cosine_schedule(LR, 0.0, 0.0, WARMUP, TOTAL))
    step = make_cdk_train_step(NestedLoRAForCDK(port, neigs=16), opt, grad_clip=1.0)
    params = dict(port.named_parameters())
    state = opt.init(params)
    skips = torch.zeros((), dtype=torch.int32)
    x, y = _pairs(96)
    params, state, _, _, _, skips = step(params, state, {}, torch.as_tensor(x),
                                         torch.as_tensor(y), skips)
    before = {k: p.detach().clone() for k, p in params.items()}
    trace = {k: t.clone() for k, t in state[0].items()}
    x[3, 2] = np.nan
    params, state, _, _, _, skips = step(params, state, {}, torch.as_tensor(x),
                                         torch.as_tensor(y), skips)
    assert int(skips) == 1
    assert int(state[1]["count"]) == 1
    for k, p in params.items():
        assert torch.equal(p.detach(), before[k])
        assert torch.equal(state[0][k], trace[k])
    jstate = jopt.init(jparams)
    jparams2, jstate, _, _, _, jskips = jstep(jparams, jstate, {}, jnp.asarray(x),
                                              jnp.asarray(y), jnp.zeros((), jnp.int32))
    assert int(jskips) == 1 and int(jstate[1].count) == 0


# -- spectrum ----------------------------------------------------------------

@pytest.mark.parametrize("const,sort", [(True, False), (False, True)])
def test_compute_spectrum_svd_matches_jax(const, sort):
    (jparams, apply, _), port, _ = _towers(seed=3)
    batches = [_pairs(64, seed=s) for s in range(3)]
    want = jax_spectrum_svd(lambda x, y: apply(jparams, x, y), iter(batches),
                            sort=sort, set_first_mode_const=const)
    with torch.no_grad():
        got = compute_spectrum_svd(port, iter(batches), sort=sort,
                                   set_first_mode_const=const, device="cpu")
    for name, a, b in zip(("spectrum", "orth_x", "orth_y"), got, want):
        _close(a, b, 1e-5, 1e-6, err_msg=name)  # grams: the loss tolerance
