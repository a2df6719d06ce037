"""The online classifier heads of the two-tower network and the Siamese
network against the JAX package (``make_hetero_network(num_classes=...)``,
``make_siam_network``), parameters carried over by ``convert.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.models.two_tower import make_hetero_network, make_siam_network
from neuralsvd_tpu_torch.convert import hetero_params_from_jax, siam_params_from_jax
from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork, SiamNetwork

RTOL, ATOL = 1e-5, 1e-6  # atol in units of the largest entry


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30), err_msg=msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("mode", ["l2_ball", "tanh"])
def test_hetero_heads_match_jax_and_train_only_the_heads(mode):
    rng = np.random.default_rng(0)
    init, _, apply_single = make_hetero_network(input_dim=5, network_dims=[8, 4],
                                                num_classes=3, mu=4.0, regularize_mode=mode)
    jparams = init(jax.random.key(0))
    port = HeteroNetwork(5, [8, 4], mu=4.0, regularize_mode=mode, num_classes=3)
    assert set(dict(port.named_parameters())) == set(hetero_params_from_jax(_np(jparams)))
    port.load_state_dict(hetero_params_from_jax(_np(jparams)))
    x = rng.normal(size=(6, 5)).astype(np.float32)
    for side in ("x", "y"):
        jemb, jlogits = apply_single(jparams, jnp.asarray(x), side, classify=True)
        emb, logits = port.apply_single(torch.as_tensor(x), side, classify=True)
        _close(emb, jemb, msg=side)
        _close(logits, jlogits, msg=side)
        _close(port.apply_single(torch.as_tensor(x), side), jemb)

        def jloss(p):
            return jnp.sum(apply_single(p, jnp.asarray(x), side, classify=True)[1] ** 2)

        jg = hetero_params_from_jax(_np(jax.grad(jloss)(jparams)))
        port.zero_grad()
        (port.apply_single(torch.as_tensor(x), side, classify=True)[1] ** 2).sum().backward()
        for name, p in port.named_parameters():
            if name.startswith(f"head_{side}."):
                assert p.grad is not None and p.grad.abs().max() > 0
                _close(p.grad, jg[name], rtol=1e-4, msg=name)
            else:  # the heads read emb.detach(): no gradient reaches the towers
                assert p.grad is None or not p.grad.any(), name
                assert not jg[name].any(), name


def test_hetero_without_heads_refuses_classify_and_keeps_its_towers():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    plain = HeteroNetwork(5, [8, 4], generator=gen())
    headed = HeteroNetwork(5, [8, 4], generator=gen(), num_classes=3)
    for name, p in plain.named_parameters():  # heads drawn after the towers
        assert torch.equal(p, dict(headed.named_parameters())[name])
    with pytest.raises(ValueError, match="online heads"):
        plain.apply_single(torch.zeros(2, 5), "x", classify=True)


SIAM_CASES = {
    "plain": dict(backbone_dims=[16, 8], projector_dims=[12, 6]),
    "plain_no_projector": dict(backbone_dims=[16, 8], projector_dims=[], mu=0.0),
    "separation": dict(backbone_dims=[16, 8], projector_dims=[12, 6], separation=True, mu=4.0),
    "batch_l2norm": dict(backbone_dims=[16, 8], projector_dims=[12, 6], batch_l2norm=True,
                         mu=0.5),
    "batch_l2norm_wide_ball": dict(backbone_dims=[16, 8], projector_dims=[], batch_l2norm=True,
                                   mu=1e4),
}


def _siam_pair(case):
    kw = dict(SIAM_CASES[case])
    init, init_state, apply = make_siam_network(input_dim=5, nonlinearity="relu", **kw)
    jparams, jstate = init(jax.random.key(1)), init_state()
    port = SiamNetwork(5, nonlinearity="relu", **kw)
    port.load_state_dict(siam_params_from_jax(_np(jparams), _np(jstate)))
    return apply, jparams, jstate, port


@pytest.mark.parametrize("case", list(SIAM_CASES))
def test_siam_matches_jax_train_then_eval(case):
    """Two train-mode two-view calls (the l2norm EMA written twice a call,
    z1 then z2), then eval-mode calls on the EMA; outputs, state and the
    train-mode gradient against JAX."""
    apply, jparams, jstate, port = _siam_pair(case)
    rng = np.random.default_rng(2)
    for call in range(2):
        z1, z2 = (rng.normal(size=(7, 5)).astype(np.float32) for _ in range(2))
        jout = apply(jparams, jstate, jnp.asarray(z1), jnp.asarray(z2), train=True)
        jstate = jout[-1]
        port.train()
        out = port(torch.as_tensor(z1), torch.as_tensor(z2))
        for g, w, name in zip(out, jout[:4], ("rep1", "emb1", "rep2", "emb2")):
            _close(g, w, msg=f"{case} call {call} {name}")
        _close(port.l2norm, jstate["l2norm"], msg=f"{case} l2norm")
        assert bool(port.initialized) == bool(jstate["initialized"])

    z = rng.normal(size=(4, 5)).astype(np.float32)
    jrep, jemb, jstate2 = apply(jparams, jstate, jnp.asarray(z), train=False)
    port.eval()
    l2_before = port.l2norm.clone()
    rep, emb = port(torch.as_tensor(z))
    _close(rep, jrep)
    _close(emb, jemb, msg=f"{case} eval")
    assert torch.equal(port.l2norm, l2_before)  # eval writes no state
    _close(port.l2norm, jstate2["l2norm"])

    def jloss(p):
        o = apply(p, jstate, jnp.asarray(z1), jnp.asarray(z2), train=True)
        return jnp.sum(o[1] * o[3]) + jnp.sum(o[0] ** 2)

    jg = siam_params_from_jax(_np(jax.grad(jloss)(jparams)))
    port.train()
    port.zero_grad()
    out = port(torch.as_tensor(z1), torch.as_tensor(z2))
    ((out[1] * out[3]).sum() + (out[0] ** 2).sum()).backward()
    for name, p in port.named_parameters():
        _close(p.grad, jg[name], rtol=1e-4, msg=f"{case} grad {name}")


def test_siam_separation_scales_and_refusal():
    port = SiamNetwork(5, [16, 8], [12, 6], separation=True, mu=4.0)
    want = np.linspace(4.0 / 6, 4.0, 6, dtype=np.float32)[::-1][None, :]
    np.testing.assert_allclose(port.scales_param.detach().numpy(), want, rtol=1e-6)
    assert torch.linalg.vector_norm(port.scales()) <= 2.0 + 1e-6
    with pytest.raises(ValueError, match="exclude"):
        SiamNetwork(5, [8], [], separation=True, batch_l2norm=True)
