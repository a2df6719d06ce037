"""The serving export (utils/export.py) against the JAX package's model.

tests/test_export.py's cases: a wavefunction and a CDK tower initialized by
JAX and carried across by convert.py, exported with a dynamic batch,
reloaded (from bytes and from a ``.pt2`` file) and evaluated at batch sizes
3 and 17 against JAX's ``apply`` at rtol 1e-5, atol 1e-6 (the port's
parity tolerance); the reloaded program equals the eager module bit for
bit on the CPU.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from neuralsvd_tpu.models import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.models.two_tower import make_hetero_network
from neuralsvd_tpu_torch.convert import hetero_params_from_jax, params_from_jax
from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.utils import export

RTOL, ATOL = 1e-5, 1e-6
PSI = dict(ndim=2, neigs=4, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
           parallel=True, use_fourier_feature=True, fourier_mapping_size=8,
           fourier_scale=0.5, apply_boundary=True, boundary_mode="dir_box_sqrt", lim=4.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _psi():
    """(JAX apply, JAX params, the port's apply_fn, its params) of the
    wavefunction of tests/test_export.py."""
    init, apply = jax_make_wavefunctions(**PSI)
    jparams = init(jax.random.key(0))
    model = make_wavefunctions(**PSI, device="cpu")
    params = params_from_jax(_np(jparams))
    model.load_state_dict(params)
    return apply, jparams, lambda p, x: functional_call(model, p, (x,)), params


def test_export_roundtrip_dynamic_batch(tmp_path):
    """One program, any batch size: bytes and a file, against JAX and the
    eager module."""
    apply, jparams, port_apply, params = _psi()
    blob = export.export_evaluator(port_apply, params, input_dim=2)
    assert isinstance(blob, bytes) and len(blob) > 0
    fn = export.load_evaluator(blob)
    rng = np.random.default_rng(0)
    for B in (3, 17):
        x = rng.uniform(-3, 3, (B, 2)).astype(np.float32)
        got = fn(torch.tensor(x))
        assert got.shape == (B, PSI["neigs"])
        np.testing.assert_allclose(got.numpy(), np.asarray(apply(jparams, jnp.asarray(x))),
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got, port_apply(params, torch.tensor(x)), rtol=0, atol=0)
    path = tmp_path / "psi.pt2"
    export.save_evaluator(str(path), port_apply, params, input_dim=2)
    fn2 = export.load_evaluator_file(str(path))
    x = rng.uniform(-3, 3, (5, 2)).astype(np.float32)
    np.testing.assert_allclose(fn2(torch.tensor(x)).numpy(),
                               np.asarray(apply(jparams, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("compute_dtype", [None, "bf16"])
def test_export_cdk_tower(compute_dtype):
    """The retrieval surface: a two-tower embedder (f32, and bf16 as the
    Sketchy script runs it) exports and reproduces its x embeddings; the
    f32 one against JAX's, both bit for bit against the eager module."""
    init, apply, _ = make_hetero_network(input_dim=8, network_dims=[16, 4],
                                         nonlinearity="lrelu0.2", mu=16.0,
                                         regularize_mode="l2_ball")
    jparams = init(jax.random.key(1))
    net = HeteroNetwork(8, [16, 4], mu=16.0, regularize_mode="l2_ball",
                        compute_dtype=compute_dtype)
    params = hetero_params_from_jax(_np(jparams))
    net.load_state_dict(params)

    def embed_x(p, x):
        return functional_call(net, p, (x, x))[0]

    fn = export.load_evaluator(export.export_evaluator(embed_x, params, input_dim=8))
    rng = np.random.default_rng(1)
    for B in (3, 17):
        x = rng.normal(size=(B, 8)).astype(np.float32)
        got = fn(torch.tensor(x))
        torch.testing.assert_close(got, embed_x(params, torch.tensor(x)), rtol=0, atol=0)
        if compute_dtype is None:
            want = np.asarray(apply(jparams, jnp.asarray(x), jnp.asarray(x))[0])
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_export_holds_a_tiered_product_as_one_operator():
    """A tiered tower product runs under cuBLAS's TF32 switch, which no
    graph records, so a program holds it as the operator
    ``neuralsvd_tpu_torch::tiered_einsum`` (here called directly: on the
    CPU the towers take the plain product): the loaded program keeps the
    operator and equals the eager call; and a model at a split tier spec
    exports and equals the eager module."""
    from neuralsvd_tpu_torch.models.mlp import tiered_einsum_op

    w = torch.tensor(np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32))

    def product(p, x):
        return tiered_einsum_op("bi,io->bo", "high", x, p["w"])

    blob = export.export_evaluator(product, {"w": w}, input_dim=4)
    program = torch.export.load(io.BytesIO(blob))
    assert "tiered_einsum" in str(program.graph)
    x = torch.tensor(np.random.default_rng(4).normal(size=(9, 4)).astype(np.float32))
    torch.testing.assert_close(export.load_evaluator(blob)(x), product({"w": w}, x), rtol=0,
                               atol=0)
    model = make_wavefunctions(**dict(PSI, use_fourier_feature=False),
                               matmul_precision="highest@1,high", device="cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}

    def psi(p, x):
        return functional_call(model, p, (x,))

    fn = export.load_evaluator(export.export_evaluator(psi, params, input_dim=2))
    x = torch.tensor(np.random.default_rng(2).normal(size=(7, 2)).astype(np.float32))
    torch.testing.assert_close(fn(x), psi(params, x), rtol=0, atol=0)
