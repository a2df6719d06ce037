"""Precision options of the towers: the port against the JAX package.

``compute_dtype`` (bf16 towers: the CDK two-tower network and the
eigenfunction ParallelMLP) against JAX's ``compute_dtype=jnp.bfloat16``
on carried parameters, evaluated op by op in both packages; the
``matmul_precision`` tiers and the split spec, which on the CPU compute
IEEE float32 in both packages and so must equal the untiered model (bit
for bit in float32, and through every transform the port applies to a
model); the 3xTF32 decomposition against float64 with TF32 rounding
emulated; and the CDK trainer's bf16 quality guard
(tests/test_cdk_retrieval.py:109-133).  Inputs are numpy arrays from
seeded generators.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.models.two_tower import make_hetero_network
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.cli.sketchy import get_args, run_training
from neuralsvd_tpu_torch.convert import hetero_params_from_jax, params_from_jax
from neuralsvd_tpu_torch.data.sketchy import ArrayPairLoader
from neuralsvd_tpu_torch.models import mlp
from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.diff_ops import VectorizedLaplacian
from neuralsvd_tpu_torch.ops import forward_laplacian
from neuralsvd_tpu_torch.utils import config

SMALL = dict(ndim=2, neigs=4, mlp_hidden_dims=[16, 16, 16],
             nonlinearity="softplus", parallel=True, use_fourier_feature=True,
             fourier_mapping_size=16, fourier_scale=0.1,
             fourier_append_radial=True, fourier_append_envelopes=(2.0, 2 / 3),
             apply_boundary=False)
# bf16 port vs bf16 JAX, in units of the largest |entry|: a sixteenth of a
# bf16 ulp at the top (both packages round after each op of the chain, so
# they agree to that); each test checks it is at most a quarter of the
# measured bf16-vs-float32 distance, so a missing cast fails it
BF16_ATOL = 2.0 ** -12
# bf16 port vs bf16 JAX weight gradients of the two-tower network, in units
# of the largest entry; checked to be at most a quarter of the distance
GRAD_BF16_ATOL = 2.0 ** -12
# The other bf16 gradients do not agree that closely, for two known
# reasons: JAX sums a bias's bf16 cotangent over the batch in bf16 (the
# transpose of its broadcast), torch in float32; and JAX differentiates
# softplus (logaddexp) by its custom JVP, exp(x - out) rounded to bf16,
# where the port's autograd goes through the ops.  Those gradients are
# held to JAX's within GRAD_BF16_LOOSE times the bf16-vs-float32 distance,
# and to differ from the port's float32 gradients by at least a quarter
# of it (the backward really ran in bf16).
GRAD_BF16_LOOSE = 2.0
TIERS = ["highest", "high", "default", "highest@1,high", "highest@4,high",
         "default@0,high"]


def _x(n=64, seed=0):
    rng = np.random.default_rng(seed)
    scales = rng.choice([0.5, 2.0, 6.0, 16.0], size=(n, 1))
    return (scales * rng.normal(size=(n, 2))).astype(np.float32)


def _err(a, b):
    """max |a - b| over max |b|."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_resolve_matmul_precision():
    assert mlp.resolve_matmul_precision(None) is None
    assert mlp.resolve_matmul_precision("") is None
    for tier in ("default", "high", "highest"):
        assert mlp.resolve_matmul_precision(tier) == tier
    spec = mlp.resolve_matmul_precision("highest@1,high")
    assert spec == ("split", "highest", 1, "high")
    assert mlp.resolve_matmul_precision(spec) == spec
    with pytest.raises(ValueError, match="matmul_precision"):
        mlp.resolve_matmul_precision("fast")
    assert mlp.resolve_compute_dtype("bf16") == torch.bfloat16
    assert mlp.resolve_compute_dtype("bfloat16") == torch.bfloat16
    assert mlp.resolve_compute_dtype("f32") is None
    assert mlp.resolve_compute_dtype(None) is None


# -- compute_dtype: bf16 towers ----------------------------------------------

def test_hetero_network_bf16_matches_jax():
    """The CDK towers in bf16: embeddings against JAX's within BF16_ATOL
    and weight gradients within GRAD_BF16_ATOL (each at most a quarter of
    the bf16-vs-float32 distance), bias gradients by the loose check."""
    D, dims = 32, [128, 16]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, D)).astype(np.float32)
    y = rng.normal(size=(64, D)).astype(np.float32)
    jinit, japply, _ = make_hetero_network(D, dims, mu=16.0)
    _, japply16, _ = make_hetero_network(D, dims, mu=16.0, compute_dtype=jnp.bfloat16)
    jparams = jinit(jax.random.key(0))
    port16 = HeteroNetwork(D, dims, mu=16.0, compute_dtype=torch.bfloat16)
    port16.load_state_dict(hetero_params_from_jax(jax.tree.map(np.asarray, jparams)))
    port32 = HeteroNetwork(D, dims, mu=16.0)
    port32.load_state_dict(port16.state_dict())

    def jloss(apply):
        return lambda p: jnp.sum(jnp.sin(apply(p, x, y)[0]) * apply(p, x, y)[1])

    want32 = np.asarray(japply(jparams, x, y)[0])
    want16 = np.asarray(japply16(jparams, x, y)[0])
    got16 = port16(torch.as_tensor(x), torch.as_tensor(y))
    got32 = port32(torch.as_tensor(x), torch.as_tensor(y))
    assert got16[0].dtype == torch.float32
    dist = _err(want16, want32)
    assert dist > 0 and _err(got16[0].detach(), got32[0].detach()) > 0
    assert BF16_ATOL <= dist / 4
    for got, want in zip(got16, japply16(jparams, x, y)):
        assert _err(got.detach(), want) <= BF16_ATOL

    jg16 = hetero_params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss(japply16))(jparams)))
    jg32 = hetero_params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss(japply))(jparams)))
    loss = torch.sum(torch.sin(got16[0]) * got16[1])
    grads = dict(zip(dict(port16.named_parameters()),
                     torch.autograd.grad(loss, list(port16.parameters()))))
    loss32 = torch.sum(torch.sin(got32[0]) * got32[1])
    grads32 = dict(zip(dict(port32.named_parameters()),
                       torch.autograd.grad(loss32, list(port32.parameters()))))
    for k, g in grads.items():
        _check_bf16_grad(k, g, grads32[k], jg16[k], jg32[k], tight=k.endswith(".w"))


def _check_bf16_grad(name, got, got32, want16, want32, tight):
    """A bf16 gradient against JAX's: float32; within GRAD_BF16_ATOL where
    ``tight`` (at most a quarter of the bf16-vs-float32 distance), else
    within GRAD_BF16_LOOSE times that distance and at least a quarter of it
    away from the port's float32 gradient."""
    assert got.dtype == torch.float32, name
    dist = _err(want16, want32)
    if tight:
        assert GRAD_BF16_ATOL <= dist / 4, name
        assert _err(got, want16) <= GRAD_BF16_ATOL, name
    else:
        assert _err(got, want16) <= GRAD_BF16_LOOSE * dist, name
        assert _err(got, got32) >= dist / 4, name


@pytest.mark.parametrize("parallel", [True, False], ids=["per-mode", "shared-trunk"])
def test_wavefunction_bf16_matches_jax(parallel):
    """The eigenfunction towers in bf16 against JAX's on carried params:
    ParallelMLP within BF16_ATOL (a quarter of the bf16-vs-float32 distance
    at most), gradients as ``_check_bf16_grad`` holds them (softplus: the
    loose check).  JAX's shared trunk drops
    compute_dtype (neuralsvd_tpu/models/mlp.py:307-312); the port's applies
    it: there the port's bf16 output differs from the float32 one, which
    equals JAX's."""
    kw = dict(SMALL, parallel=parallel)
    jinit, japply = jax_make_wavefunctions(**kw)
    _, japply16 = jax_make_wavefunctions(**kw, compute_dtype=jnp.bfloat16)
    jparams = jinit(jax.random.key(2))
    port16 = make_wavefunctions(**kw, compute_dtype="bfloat16", device="cpu")
    port16.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    x = _x()
    want32 = np.asarray(japply(jparams, jnp.asarray(x)))
    want16 = np.asarray(japply16(jparams, jnp.asarray(x)))
    got16 = port16(torch.as_tensor(x))
    assert got16.dtype == torch.float32
    if not parallel:
        np.testing.assert_array_equal(want16, want32)
        dist = _err(got16.detach(), want32)
        assert dist > 0 and dist <= 0.05
        return
    dist = _err(want16, want32)
    assert BF16_ATOL <= dist / 4
    assert _err(got16.detach(), want16) <= BF16_ATOL

    def jloss(apply):
        return lambda p: jnp.sum(apply(p, jnp.asarray(x)) ** 2)

    jg16 = params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss(japply16))(jparams)))
    jg32 = params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss(japply))(jparams)))
    port32 = make_wavefunctions(**kw, device="cpu")
    port32.load_state_dict(port16.state_dict())
    names = [k for k, _ in port16.named_parameters()]
    grads = torch.autograd.grad(torch.sum(got16 ** 2), list(port16.parameters()))
    grads32 = torch.autograd.grad(torch.sum(port32(torch.as_tensor(x)) ** 2),
                                  list(port32.parameters()))
    for k, g, g32 in zip(names, grads, grads32):
        _check_bf16_grad(k, g, g32, jg16[k], jg32[k], tight=False)


def test_bf16_tower_forward_laplacian_is_finite_and_close_to_f32():
    """The forward-Laplacian engine through the bf16 ParallelMLP (its
    channels cast with the value): no fallback, finite, and within JAX's
    own bf16 tolerance of the float32 model (tests/test_models.py:158-187:
    atol 0.05 of the largest entry, rtol 0.1)."""
    m32 = make_wavefunctions(**SMALL, device="cpu", seed=5)
    m16 = make_wavefunctions(**SMALL, device="cpu", seed=5, compute_dtype=torch.bfloat16)
    x = torch.as_tensor(_x(32, seed=3))
    forward_laplacian.fallback_rule.calls = 0
    with torch.no_grad():
        lap16, grad16, f16 = forward_laplacian.forward_laplacian(m16, x, return_grad=True)
        lap32, grad32, f32 = forward_laplacian.forward_laplacian(m32, x, return_grad=True)
    assert forward_laplacian.fallback_rule.calls == 0
    for a, b in ((lap16, lap32), (grad16, grad32), (f16, f32)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.1,
                                   atol=0.05 * b.abs().max().item())
    assert not torch.equal(lap16, lap32)


# -- matmul_precision: the tiers on the CPU ----------------------------------

def _tiered_pair(prec, dtype=torch.float32):
    base = make_wavefunctions(**SMALL, device="cpu", seed=1)
    tiered = make_wavefunctions(**SMALL, device="cpu", seed=1, matmul_precision=prec)
    return base.to(dtype), tiered.to(dtype)


def _grads(out, model, **kw):
    params = list(model.parameters())
    return [g if g is not None else torch.zeros_like(p) for g, p in zip(
        torch.autograd.grad(out, params, allow_unused=True, **kw), params)]


def _assert_grads_close(got, want, rtol=1e-6):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                   atol=rtol * max(w.abs().max().item(), 1e-30))


@pytest.mark.parametrize("prec", TIERS)
def test_tiers_equal_the_untiered_model_on_cpu(prec):
    """On the CPU every tier computes IEEE float32: outputs equal the
    untiered model's bit for bit, gradients within rtol 1e-6, through the
    tier product's own autograd Function (its backward products at the
    tier) where the spec does not collapse."""
    base, tiered = _tiered_pair(prec)
    x = torch.as_tensor(_x())
    out_b, out_t = base(x), tiered(x)
    assert torch.equal(out_t, out_b)
    assert any("TieredProduct" in type(fn).__name__ for fn in _graph_nodes(out_t.grad_fn))
    _assert_grads_close(_grads((out_t ** 2).sum(), tiered), _grads((out_b ** 2).sum(), base))


def _graph_nodes(fn, seen=None):
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return seen
    seen.add(fn)
    for nxt, _ in fn.next_functions:
        _graph_nodes(nxt, seen)
    return seen


@pytest.mark.parametrize("prec", TIERS)
def test_tiers_through_the_laplacians_on_cpu(prec):
    """Every transform the port applies to a model, tiered against
    untiered: the forward engine (no fallback call) and nested JVPs
    (float32, bit for bit), finite differences and nested JVPs with an
    autograd graph (float64: FD multiplies rounding by 1/eps²; rtol 1e-6),
    and SpIN's batched gradients (autograd.grad with is_grads_batched)."""
    base, tiered = _tiered_pair(prec)
    x = torch.as_tensor(_x(32, seed=1))
    forward_laplacian.fallback_rule.calls = 0
    for mode in ("forward", "jvp"):
        op = VectorizedLaplacian(eps=-1.0, exact_mode=mode)
        with torch.no_grad():
            got = op(tiered, x, return_grad=True)
            want = op(base, x, return_grad=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b), mode
    assert forward_laplacian.fallback_rule.calls == 0

    base64, tiered64 = _tiered_pair(prec, torch.float64)
    x64 = x.double()
    for eps, mode in ((0.1, "jvp"), (-1.0, "jvp")):
        op = VectorizedLaplacian(eps=eps, exact_mode=mode)
        lap_t, _, fs_t = op(tiered64, x64, with_graph=True)
        lap_b, _, fs_b = op(base64, x64, with_graph=True)
        _assert_grads_close(_grads((lap_t * fs_t).sum(), tiered64),
                            _grads((lap_b * fs_b).sum(), base64))

    out_t, out_b = tiered(x), base(x)
    cot = torch.as_tensor(np.random.default_rng(2).normal(
        size=(3,) + tuple(out_b.shape)).astype(np.float32))
    _assert_grads_close(_grads(out_t, tiered, grad_outputs=cot, is_grads_batched=True),
                        _grads(out_b, base, grad_outputs=cot, is_grads_batched=True))


def test_split_spec_needs_the_per_mode_towers():
    with pytest.raises(ValueError, match="ParallelMLP"):
        make_wavefunctions(**dict(SMALL, parallel=False), matmul_precision="highest@1,high",
                           device="cpu")
    shared = make_wavefunctions(**dict(SMALL, parallel=False), matmul_precision="high",
                                device="cpu")
    assert shared.base.precision == "high"
    # a degenerate split collapses to one tier (mlp.py:224-227)
    assert make_wavefunctions(**SMALL, matmul_precision="highest@4,high",
                              device="cpu").base.precision == "highest"
    assert make_wavefunctions(**SMALL, matmul_precision="highest@0,high",
                              device="cpu").base.precision == "high"


@pytest.mark.parametrize("eq,shapes", [
    ("lhd,bd->lhb", ((5, 3, 7), (4, 7))),
    ("lhp,lpb->lhb", ((5, 3, 6), (5, 6, 4))),
])
def test_split_product_concatenates_the_modes(eq, shapes):
    """The split product (run where its tiers differ: on the card) is the
    head's product over the first k modes and the tail's over the rest,
    the shared input whole to both."""
    rng = np.random.default_rng(4)
    a, b = (torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in shapes)
    got = mlp._split_product(eq, a, b, 2, "highest", "high")
    shared = b.shape[0] != a.shape[0]
    want = torch.cat([torch.einsum(eq, a[:2], b if shared else b[:2]),
                      torch.einsum(eq, a[2:], b if shared else b[2:])])
    assert torch.equal(got, want)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 mantissa cut to TF32's 10 bits (the tensor
    cores' truncation of a float32 operand)."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_pass(a, b):
    """One emulated TF32 product: operands truncated to TF32, products
    exact, sums in float64, the result rounded to float32."""
    return (_round_tf32(a).double() @ _round_tf32(b).double()).float()


def test_three_pass_error_against_float64():
    """3xTF32 (split_tf32 + three_pass) with TF32 emulated: relative error
    at most 2^-20 against float64, where one TF32 pass is ~2^-11; the split
    is exact (hi + lo == x, hi has TF32's 11 significant bits)."""
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.normal(size=(64, 256)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(256, 48)).astype(np.float32))
    hi, lo = mlp.split_tf32(a)
    assert torch.equal(hi + lo, a) and torch.equal(_round_tf32(hi), hi)
    assert (lo.abs() <= a.abs() * 2.0 ** -11).all()
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    one = (_tf32_pass(a, b).double() - exact).abs().max().item() / scale
    three = (mlp.three_pass(_tf32_pass, a, b).double() - exact).abs().max().item() / scale
    assert three <= 2.0 ** -20
    assert 2.0 ** -14 <= one <= 2.0 ** -9


def test_tier_switch_is_restored_on_the_error_path():
    """The TF32 switch set around a tiered product is restored after it,
    also when the product raises."""
    before = torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(RuntimeError):
        with mlp._tf32(not before):
            assert torch.backends.cuda.matmul.allow_tf32 is (not before)
            raise RuntimeError("product failed")
    assert torch.backends.cuda.matmul.allow_tf32 is before


# -- the CLIs ----------------------------------------------------------------

PDE_TINY = dict(seed=3, neigs=4, mlp_hidden_dims="16,16", batch_size=64, lim=4.0,
                val_eps=0.5, num_iters=4, print_freq=2, eval_freq=4, lr=1e-3,
                use_fourier_feature=True, fourier_mapping_size=8, fourier_scale=0.1,
                operator_scale=10.0, parallel=True, apply_boundary=False,
                laplacian_eps=-1.0, sampling_mode="gaussian", sampling_scale=2.0)


@pytest.mark.parametrize("prec", ["default", "high", "highest", "highest@1,high"])
def test_pde_cli_trains_at_each_tier(tmp_path, prec):
    """``--matmul_precision`` reaches the towers and, on the CPU, changes
    nothing: the run equals the untiered one bit for bit; the float32
    matmul precision is still "highest" after it."""
    runs = {}
    for name, p in (("tier", prec), ("plain", "")):
        cfg = config.PDEConfig(log_dir=str(tmp_path / name), device="cpu",
                               matmul_precision=p, **PDE_TINY)
        assert pde.build(cfg, "cpu").model.base.precision == (
            mlp.resolve_matmul_precision(p) if "@" not in p else ("split", "highest", 1, "high"))
        runs[name] = pde.main(cfg)
        assert torch.get_float32_matmul_precision() == "highest"
    (ts, eig, _), (ts0, eig0, _) = runs["tier"], runs["plain"]
    np.testing.assert_array_equal(np.asarray(eig), np.asarray(eig0))
    for k, p in ts.params.items():
        assert torch.equal(p, ts0.params[k]), k


def _synth_loaders(rng, n_cls=6, per_cls=30, D=16, batch=64):
    """tests/test_cdk_retrieval.py:63-77's class-correlated pairs."""
    centers_x = 3 * rng.normal(size=(n_cls, D)).astype(np.float32)
    centers_y = 3 * rng.normal(size=(n_cls, D)).astype(np.float32)

    def split(seed):
        r = np.random.default_rng(seed)
        cls = np.repeat(np.arange(n_cls), per_cls)
        x = centers_x[cls] + r.normal(size=(len(cls), D)).astype(np.float32)
        y = centers_y[cls] + r.normal(size=(len(cls), D)).astype(np.float32)
        return ArrayPairLoader(x, y, cls, batch_size=batch, seed=seed)

    return split(1), split(2), split(3)


def test_cdk_bf16_matches_f32_quality(tmp_path):
    """The quality guard of tests/test_cdk_retrieval.py:109-133 through the
    port's run_training: bf16 towers reach P@K above twice chance and
    within 0.1 of float32 on the synthetic task."""
    def run(dtype):
        train, test, valid = _synth_loaders(np.random.default_rng(0))
        args = get_args([
            "--log_dir", str(tmp_path / dtype), "--num_epochs", "3",
            "--batch_size", "64", "--network_dims", "64,16", "--neigs", "16",
            "--optimizer", "adam", "--base_lr", "1e-3", "--mu", "4.0",
            "--n_retrievals", "10", "--compute_dtype", dtype, "--device", "cpu",
        ])
        params, _ = run_training(args, train, test, valid, input_dim=16)
        assert all(p.dtype == torch.float32 for p in params.values())
        logs = sorted((tmp_path / dtype).glob("*.csv"))
        with open(logs[0]) as fh:
            rows = list(csv.DictReader(fh))
        assert int(rows[-1]["skips"]) == 0
        return float(rows[-1]["test_P@K"])

    pk32, pk16 = run("f32"), run("bf16")
    assert pk16 > 2 * (1.0 / 6), f"bf16 P@K {pk16} not above chance"
    assert pk16 > pk32 - 0.1, f"bf16 P@K {pk16} far below f32 {pk32}"


def test_sketchy_main_pins_ieee_float32(tmp_path, monkeypatch):
    """``main`` pins float32 matmuls to IEEE, as the JAX CLI pins float32."""
    seen = []
    monkeypatch.setattr("neuralsvd_tpu_torch.cli.sketchy.run_training",
                        lambda *a, **k: seen.append(torch.get_float32_matmul_precision()))
    monkeypatch.setattr("neuralsvd_tpu_torch.cli.sketchy.SketchyVGGDataLoader",
                        lambda *a, **k: type("L", (), {"sketch_features": np.zeros((1, 4))})())
    torch.set_float32_matmul_precision("high")
    try:
        from neuralsvd_tpu_torch.cli import sketchy
        sketchy.main(get_args(["--log_dir", str(tmp_path), "--device", "cpu"]))
    finally:
        torch.set_float32_matmul_precision("highest")
    assert seen == ["highest"]
