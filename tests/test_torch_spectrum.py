"""The port's spectrum eval with the constant first mode, normalised.

``compute_spectrum_evd(..., set_first_mode_const=True, normalize=True)``
raises in the JAX package (neuralsvd_tpu/methods/spectrum.py:136): its
eigenfunctions hold the L learned modes, but the norms it divides them by
hold L + 1, the constant mode first.  The port divides by the learned
modes' norms and sorts them by the learned modes' eigenvalues.  Its
output is held against the JAX package's ``normalize=False`` output,
normalised and sorted here by hand: rtol 1e-5 (float32 sums of 32 rows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsvd_tpu.methods.spectrum import compute_spectrum_evd as jax_spectrum
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_evd

L, B = 4, 32
_W = np.random.default_rng(0).normal(size=(2, L)).astype(np.float32)


def _jax_model(x):
    return jnp.tanh(x @ jnp.asarray(_W))


def _jax_operator(f, x, importance):
    phi = f(x)
    return phi * (1.0 + jnp.sum(x ** 2, axis=1, keepdims=True)), phi


def _torch_model(x):
    return torch.tanh(x @ torch.as_tensor(_W))


def _torch_operator(f, x, importance):
    phi = f(x)
    return phi * (1.0 + torch.sum(x ** 2, dim=1, keepdim=True)), phi


@pytest.mark.parametrize("sort", [False, True])
def test_const_mode_normalize_returns_learned_modes(sort):
    batches = [np.random.default_rng(1).normal(size=(B, 2)).astype(np.float32)]
    with pytest.raises(ValueError):
        jax_spectrum(_jax_model, batches, _jax_operator,
                     set_first_mode_const=True, normalize=True, sort=sort)
    ref = jax_spectrum(_jax_model, batches, _jax_operator,
                       set_first_mode_const=True)
    got = compute_spectrum_evd(_torch_model, batches, _torch_operator,
                               set_first_mode_const=True, normalize=True,
                               sort=sort, device="cpu")

    norms = np.asarray(ref["norms"])
    eigvals = np.asarray(ref["eigvals"])
    assert norms.shape == (L + 1,) and got["norms"].shape == (L + 1,)
    want = np.asarray(ref["eigfuncs"]) / np.sqrt(norms[1:])
    idx = np.arange(L + 1)
    if sort:
        idx = np.argsort(eigvals)[::-1]
        want = want[:, np.argsort(eigvals[1:])[::-1]]
    assert got["eigfuncs"].shape == (B, L)
    np.testing.assert_allclose(got["eigfuncs"], want, rtol=1e-5)
    np.testing.assert_allclose(got["eigvals"], eigvals[idx], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], norms[idx], rtol=1e-5)
    sn = np.sqrt(norms)
    np.testing.assert_allclose(got["cov"], (np.asarray(ref["cov"]) / np.outer(sn, sn))[np.ix_(idx, idx)],
                               rtol=1e-5, atol=1e-7)
