"""The kNN monitor, the multi-head probe, the meters and accuracy, and the
evaluation linear algebra against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.eval.knn import knn_monitor as jax_knn_monitor
from neuralsvd_tpu.eval.knn import knn_predict as jax_knn_predict
from neuralsvd_tpu.models.probe import make_multihead_probe as jax_make_probe
from neuralsvd_tpu.utils import linalg as jax_linalg
from neuralsvd_tpu.utils import meters as jax_meters
from neuralsvd_tpu_torch.convert import probe_params_from_jax
from neuralsvd_tpu_torch.eval.knn import knn_monitor, knn_predict
from neuralsvd_tpu_torch.models.probe import make_multihead_probe, register_spectrum
from neuralsvd_tpu_torch.utils import linalg, meters


def _clustered(rng, n, d=16, classes=5, spread=1.0):
    centers = 3 * np.random.default_rng(99).normal(size=(classes, d))
    labels = rng.integers(0, classes, size=n)
    return (centers[labels] + spread * rng.normal(size=(n, d))).astype(np.float32), labels


@pytest.mark.parametrize("k,temperature", [(1, 0.1), (10, 0.1), (50, 0.5)])
def test_knn_predict_matches_jax(k, temperature):
    """Continuous random features (no tied scores): the same labels."""
    rng = np.random.default_rng(k)
    bank, bank_labels = _clustered(rng, 300, spread=2.5)
    query, _ = _clustered(rng, 97, spread=2.5)
    want = jax_knn_predict(query, bank, bank_labels, 5, k=k, temperature=temperature, batch=40)
    got = knn_predict(query, bank, bank_labels, 5, k=k, temperature=temperature, batch=40,
                      device="cpu")
    np.testing.assert_array_equal(got, want)


def test_knn_monitor_matches_jax():
    rng = np.random.default_rng(0)
    bank, bank_labels = _clustered(rng, 400, spread=3.0)
    test, test_labels = _clustered(rng, 150, spread=3.0)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    want = jax_knn_monitor(lambda v: v @ jnp.asarray(w), bank, bank_labels, test, test_labels,
                           5, k=20, batch=64)
    got = knn_monitor(lambda v: v @ torch.as_tensor(w), bank, bank_labels, test, test_labels,
                      5, k=20, batch=64, device="cpu")
    assert got == want and 0.2 < got < 1.0


def _probe_pair(trunc_dims, hidden_dims, sort):
    rng = np.random.default_rng(0)
    D, R, E, C = 6, 10, 8, 3
    W_rep = rng.normal(size=(D, R)).astype(np.float32)
    W_emb = rng.normal(size=(D, E)).astype(np.float32)
    init, apply, jregister = jax_make_probe(
        lambda x: (x @ jnp.asarray(W_rep), x @ jnp.asarray(W_emb)), rep_dim=R, emb_dim=E,
        num_classes=C, trunc_dims=trunc_dims, hidden_dims=hidden_dims, sort=sort)
    jparams = init(jax.random.key(0))
    encoder = torch.nn.Linear(D, R + E, bias=False)
    with torch.no_grad():
        encoder.weight.copy_(torch.as_tensor(np.concatenate([W_rep, W_emb], 1).T))
    port = make_multihead_probe(lambda x: torch.split(encoder(x), [R, E], dim=1), R, E, C,
                                trunc_dims=trunc_dims, hidden_dims=hidden_dims, sort=sort)
    port.load_state_dict(probe_params_from_jax(jax.tree.map(np.asarray, jparams)))
    x = rng.normal(size=(16, D)).astype(np.float32)
    return apply, jregister, jparams, port, encoder, x


@pytest.mark.parametrize("trunc_dims,hidden_dims,sort", [
    ((), None, False), ((4, -4), None, False), ((8, -6), None, True),
    ((3, -5), [16], True)], ids=["emb_only", "trunc", "trunc_sorted", "mlp_sorted"])
def test_probe_matches_jax(trunc_dims, hidden_dims, sort):
    apply, jregister, jparams, port, encoder, x = _probe_pair(trunc_dims, hidden_dims, sort)
    eigvals = np.asarray([1.0, 0.3, 0.9, 0.5, 0.7, 0.2, 0.6, 0.8, 0.4])
    record = register_spectrum(eigvals)
    jrecord = jregister(eigvals)
    np.testing.assert_array_equal(record["sort_indices"], jrecord["sort_indices"])
    for kw in (dict(), dict(spectrum_record=record, normalize=True)):
        jkw = dict(kw, spectrum_record=jrecord) if kw else {}
        want = apply(jparams, jnp.asarray(x), **jkw)
        got = port(torch.as_tensor(x), **kw)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want[name]),
                                       rtol=1e-5, atol=1e-6 * np.abs(want[name]).max(),
                                       err_msg=f"{name} {kw.keys()}")
    if sort:  # sort applies with a record and no normalization too
        want = apply(jparams, jnp.asarray(x), spectrum_record=jrecord)
        got = port(torch.as_tensor(x), spectrum_record=record)
        np.testing.assert_allclose(got["emb"].detach().numpy(), np.asarray(want["emb"]),
                                   rtol=1e-5, atol=1e-6 * np.abs(want["emb"]).max())


def test_probe_trains_its_heads_only():
    _, _, _, port, encoder, x = _probe_pair((4, -4), None, False)
    assert not any(p is encoder.weight for p in port.parameters())
    assert all(n.startswith("heads.") for n, _ in port.named_parameters())
    logits = port(torch.as_tensor(x))
    sum((v ** 2).sum() for v in logits.values()).backward()
    assert encoder.weight.grad is None
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in port.parameters())


@pytest.mark.parametrize("topk", [(1,), (1, 3), (2, 5)])
def test_accuracy_matches_jax(topk):
    rng = np.random.default_rng(sum(topk))
    logits = rng.normal(size=(50, 7)).astype(np.float32)
    targets = rng.integers(0, 7, size=50)
    want = jax_meters.accuracy(logits, targets, topk)
    assert meters.accuracy(logits, targets, topk) == want
    assert meters.accuracy(torch.as_tensor(logits), torch.as_tensor(targets), topk) == want


def test_meters_match_jax():
    ours, ref = meters.AverageMeter("loss", ":.3f"), jax_meters.AverageMeter("loss", ":.3f")
    for v, n in ((1.5, 2), (0.25, 3), (4.0, 1)):
        ours.update(v, n)
        ref.update(v, n)
    assert (ours.val, ours.avg, ours.sum, ours.count) == (ref.val, ref.avg, ref.sum, ref.count)
    assert str(ours) == str(ref)
    assert (meters.ProgressMeter(120, [ours], "ep1").display(7)
            == jax_meters.ProgressMeter(120, [ref], "ep1").display(7))
    for kind in ("avg", "max", "min"):
        a, b = meters.create_metric(kind), jax_meters.create_metric(kind)
        for v in (3.0, 1.0, 2.0):
            assert a.update(v) == b.update(v)
        assert a.val() == b.val()
    with pytest.raises(ValueError):
        meters.Metric("median")


def test_linalg_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 6))
    Ahat = A @ np.linalg.qr(rng.normal(size=(6, 6)))[0] + 0.01 * rng.normal(size=(30, 6))
    assert linalg.subspace_distance(A, Ahat) == jax_linalg.subspace_distance(A, Ahat)
    assert abs(linalg.subspace_distance(A, A)) < 1e-12
    np.testing.assert_array_equal(linalg.rotate(Ahat, A, 1, 4), jax_linalg.rotate(Ahat, A, 1, 4))
    got = linalg.procrustes(A, Ahat, 0, 6)
    np.testing.assert_array_equal(got, jax_linalg.procrustes(A, Ahat, 0, 6))
    assert np.abs(got - A).max() < 0.1
