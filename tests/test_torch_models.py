"""Port's models vs the JAX package on carried parameters.

Parameters are drawn with the JAX init and carried across with
``neuralsvd_tpu_torch.convert.params_from_jax``; inputs come from numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.models.fourier import make_fourier_features
from neuralsvd_tpu.models.mlp import get_activation as jax_get_activation
from neuralsvd_tpu.models.mlp import make_mlp_eigfuncs as jax_make_mlp_eigfuncs
from neuralsvd_tpu.models.mlp import make_parallel_mlp as jax_make_parallel_mlp
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu_torch.convert import _named_leaves, params_from_jax
from neuralsvd_tpu_torch.models.fourier import FourierFeatures
from neuralsvd_tpu_torch.models.mlp import ParallelMLP, get_activation, make_mlp_eigfuncs
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions

SMALL = dict(ndim=2, neigs=4, mlp_hidden_dims=[16, 16, 16],
             nonlinearity="softplus", parallel=True, use_fourier_feature=True,
             fourier_mapping_size=16, fourier_scale=0.1,
             fourier_append_radial=True, fourier_append_envelopes=(2.0, 2 / 3),
             apply_boundary=False)


def _x(n=64, seed=0):
    rng = np.random.default_rng(seed)
    scales = rng.choice([0.5, 2.0, 6.0, 16.0], size=(n, 1))
    return (scales * rng.normal(size=(n, 2))).astype(np.float32)


@pytest.mark.parametrize("kwargs", [
    dict(mapping_size=16, scale=0.1, append_radial=True,
         append_envelopes=(2.0, 2 / 3, 0.4), seed=3),
    dict(mapping_size=4, scale=1.0, deterministic=True, append_raw=True),
])
def test_fourier_features_match_jax(kwargs):
    """The frequency matrix is reproduced bit for bit; the features agree
    to float32 rounding of sin/cos arguments up to ~30 (atol 1e-5)."""
    _, japply = make_fourier_features(2, **kwargs)
    port = FourierFeatures(2, **kwargs)
    x = _x()
    expect = np.asarray(japply({}, jnp.asarray(x)))
    got = port(torch.as_tensor(x)).numpy()
    assert port.feature_dim == japply.feature_dim == got.shape[1]
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-5)
    if not kwargs.get("deterministic"):
        rng = np.random.default_rng(kwargs["seed"])
        B = 2 * np.pi * kwargs["scale"] * rng.standard_normal((2, kwargs["mapping_size"]))
        np.testing.assert_array_equal(port.B.numpy(), B.astype(np.float32))


@pytest.mark.parametrize("name", ["relu", "lrelu0.1", "elu", "elu0.5", "tanh",
                                  "erf", "sin_and_cos", "siren", "softplus",
                                  "linear"])
def test_activations_match_jax(name):
    x = np.linspace(-30, 30, 64, dtype=np.float32).reshape(2, 32)
    expect = np.asarray(jax_get_activation(name)(jnp.asarray(x)))
    got = get_activation(name)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-7)


def _carried(cfg, seed=0):
    jinit, japply = jax_make_wavefunctions(**cfg)
    params = jinit(jax.random.key(seed))
    model = make_wavefunctions(**cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return japply, params, model


@pytest.mark.parametrize("cfg", [
    SMALL,
    dict(SMALL, nonlinearity="tanh", hard_mul_const=2.5, mlp_hidden_dims=[8, 8]),
    dict(SMALL, use_fourier_feature=False, nonlinearity="relu", neigs=3),
])
def test_wavefunctions_match_jax(cfg):
    """make_wavefunctions output on carried params (float32 tower
    products: rtol 1e-5, atol 1e-6 of the output scale)."""
    japply, params, model = _carried(cfg)
    x = _x()
    expect = np.asarray(japply(params, jnp.asarray(x)))
    got = model(torch.as_tensor(x)).detach().numpy()
    assert got.shape == expect.shape == (64, cfg["neigs"])
    np.testing.assert_allclose(got, expect, rtol=1e-5,
                               atol=1e-6 * np.abs(expect).max())


def test_parallel_mlp_equals_independent_mlps():
    """Each mode of the batched tower is its own MLP (mirror of the JAX
    test of the same name)."""
    torch.manual_seed(0)
    mlp = ParallelMLP(3, [8, 8], num_copies=4, nonlinearity="tanh", bias=True,
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for b in mlp.bs:
            b.normal_()
    x = torch.randn(10, 3)
    out = mlp(x)
    for l in range(4):
        h = x
        for i, (w, b) in enumerate(zip(mlp.ws, mlp.bs)):
            h = h @ w[l].T + b[l, :, 0]
            if i < len(mlp.ws) - 1:
                h = torch.tanh(h)
        torch.testing.assert_close(out[:, l], h[:, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weight_normalization,output_dim", [(True, 1), (False, 2)])
def test_parallel_mlp_matches_jax(weight_normalization, output_dim):
    """The tower alone on carried params, with the reference's quirk of
    dividing every layer by the first layer's norm, and (B, L, O) outputs."""
    jinit, japply = jax_make_parallel_mlp(
        3, [8, 8], num_copies=4, output_dim=output_dim, nonlinearity="tanh",
        bias=True, weight_normalization=weight_normalization)
    params = jax.tree.map(np.asarray, jinit(jax.random.key(2)))
    mlp = ParallelMLP(3, [8, 8], num_copies=4, output_dim=output_dim,
                      nonlinearity="tanh", bias=True,
                      weight_normalization=weight_normalization)
    state = {f"{g}.{i}": torch.tensor(a) for g in ("ws", "bs")
             for i, a in enumerate(params[g])}
    mlp.load_state_dict(state)
    x = _x(16)
    x = np.concatenate([x, x[:, :1]], axis=1)
    expect = np.asarray(japply(params, jnp.asarray(x)))
    got = mlp(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_parallel_mlp_init_and_debug():
    mlp = ParallelMLP(64, [128], num_copies=8, bias=True,
                      generator=torch.Generator().manual_seed(0))
    std = mlp.ws[0].detach().std().item()
    assert abs(std / np.sqrt(2.0 / 64) - 1) < 0.05
    assert all((b == 0).all() for b in mlp.bs)
    dbg = ParallelMLP(4, [5], num_copies=2, bias=True, debug=True)
    assert all((p == 0.1).all() for p in dbg.parameters())


def test_multi_output_shape():
    mlp = ParallelMLP(3, [8], num_copies=4, output_dim=2)
    assert mlp(torch.randn(5, 3)).shape == (5, 4, 2)


def test_same_seed_same_model():
    a = make_wavefunctions(**SMALL, seed=7, device="cpu")
    b = make_wavefunctions(**SMALL, seed=7, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


# ids as when the box mask, the shared trunk, the exponential mask and
# the precision options were not ported; every case now builds and
# matches JAX (override0: the shared trunk at "highest", override3: bf16
# per-mode towers, override4: the "high" tier)
@pytest.mark.parametrize("override,bf16", [
    (dict(parallel=False, matmul_precision="highest"), False),
    (dict(apply_exp_mask=True), False),
    (dict(parallel=False, apply_exp_mask=True), False),
    (dict(compute_dtype="bfloat16"), True), (dict(matmul_precision="high"), False),
], ids=[f"override{i}" for i in range(5)])
def test_unported_options_raise(override, bf16):
    """Every option builds and gives JAX's outputs on carried params: rtol
    1e-5, atol 1e-6 of the largest; bf16 towers (both packages round after
    each op) within 2^-12 of the largest, a quarter of a bf16 ulp."""
    kw = dict(SMALL, **override)
    jinit, japply = jax_make_wavefunctions(**kw)
    params = jinit(jax.random.key(2))
    model = make_wavefunctions(**kw, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    x = _x()
    want = np.asarray(japply(params, jnp.asarray(x)))
    got = model(torch.as_tensor(x)).detach().numpy()
    if bf16:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -12 * np.abs(want).max())
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("bias,weight_normalization", [(True, True), (False, True), (False, False)])
def test_shared_trunk_weight_norm_matches_jax(bias, weight_normalization):
    """The shared trunk of make_mlp_eigfuncs (16-16 softplus, L 4) with
    weight normalization and/or without biases, JAX's init carried through
    params_from_jax: outputs rtol 1e-5 / atol 1e-6 of the largest, and the
    gradients of a fixed contraction of the outputs rtol 1e-4 / atol 1e-6
    of the largest (they flow through the norm in both packages); g is ‖w‖
    over axis 0 at JAX's init."""
    kw = dict(bias=bias, weight_normalization=weight_normalization)
    jinit, japply = jax_make_mlp_eigfuncs(2, 4, [16, 16], "softplus", **kw)
    params = jinit(jax.random.key(5))
    model = make_mlp_eigfuncs(2, 4, [16, 16], "softplus", **kw)
    carried = params_from_jax({"base": jax.tree.map(np.asarray, params)})
    model.load_state_dict({k.removeprefix("base."): v for k, v in carried.items()})
    if weight_normalization:
        for layer in params["layers"]:
            np.testing.assert_allclose(np.asarray(layer["g"]),
                                       np.linalg.norm(np.asarray(layer["w"]), axis=0), rtol=1e-6)
    x = _x(32, seed=6) / 4
    c = np.random.default_rng(7).normal(size=(32, 4)).astype(np.float32)

    def jloss(p):
        return jnp.sum(japply(p, jnp.asarray(x)) * c)

    want, jgrads = jax.value_and_grad(jloss)(params)
    jout = np.asarray(japply(params, jnp.asarray(x)))
    out = model(torch.as_tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-6 * np.abs(jout).max())
    loss = torch.sum(out * torch.as_tensor(c))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = dict(zip([k for k, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    jg = {k: np.asarray(v) for k, v in _named_leaves(jgrads)}
    assert set(grads) == set(jg)
    for k, w in jg.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
