"""Port's gram kernels and EVD loss vs the JAX package.

The port's wrappers (neuralsvd_tpu_torch/ops/cuda_gram.py) take their plain
PyTorch versions on CPU tensors; they are held here against the Pallas
kernels of neuralsvd_tpu/ops/pallas_gram.py run in interpret mode (as
tests/test_pallas_gram.py runs them) and against the XLA loss.  The CUDA
kernels themselves are compared with the plain versions by the ``cuda``
test at the end, on a GPU only.

Tolerances are those of tests/test_pallas_gram.py: rtol 1e-5 on losses and
grams, rtol 1e-4 / atol 1e-6 on gradients (the summation order differs
between the packages, float32 throughout).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from neuralsvd_tpu.ops import joint_nesting_masks, nestedlora_evd_loss, step_weights
from neuralsvd_tpu.ops.masks import sequential_nesting_masks
from neuralsvd_tpu.ops.pallas_gram import (
    masked_gram_pair as jax_masked_gram_pair,
    metric_grads as jax_metric_grads,
    nestedlora_evd_loss_pallas,
    weighted_dot as jax_weighted_dot,
)
from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.ops.cuda_gram import (
    masked_gram_pair,
    metric_grads,
    nestedlora_evd_loss_kernels,
    weighted_dot,
)
from neuralsvd_tpu_torch.ops.nestedlora import nestedlora_evd_loss as torch_evd_loss

# (B, L, nesting): B = 96, L = 5 is unaligned on purpose; 512 x 16 is E4;
# L = 65 and 129 straddle the CUDA kernels' 64-wide tiles by one column
CASES = [(96, 5, "joint"), (512, 16, "sequential"), (200, 65, "joint"),
         (130, 129, "sequential")]


def _data(B, L, nesting, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(B, L)).astype(np.float32)
    Tf = rng.normal(size=(B, L)).astype(np.float32)
    if nesting == "joint":
        vmask, mmask = joint_nesting_masks(step_weights(L))
    else:
        vmask, mmask = sequential_nesting_masks(L)
    return f, Tf, np.asarray(vmask), np.asarray(mmask)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("B,L,nesting", CASES)
def test_masked_gram_pair_matches_pallas(B, L, nesting):
    f, _, _, mmask = _data(B, L, nesting)
    f1, f2 = np.split(f, 2)
    with pltpu.force_tpu_interpret_mode():
        jl, jl1, jl2 = jax_masked_gram_pair(jnp.asarray(f1), jnp.asarray(f2),
                                            jnp.asarray(mmask))
    tl, tl1, tl2, tc1, tc2 = masked_gram_pair(_t(f1), _t(f2), _t(mmask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5, atol=1e-6)
    # the backward's coefficients M⊙Λ, which the JAX kernel forms later
    np.testing.assert_allclose(tc1.numpy(), mmask * np.asarray(jl1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc2.numpy(), mmask * np.asarray(jl2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,L,nesting", CASES)
def test_weighted_dot_matches_pallas(B, L, nesting):
    f, Tf, vmask, _ = _data(B, L, nesting)
    with pltpu.force_tpu_interpret_mode():
        j = jax_weighted_dot(jnp.asarray(f), jnp.asarray(Tf), jnp.asarray(vmask))
    t = weighted_dot(_t(f), _t(Tf), _t(vmask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)


@pytest.mark.parametrize("B,L,nesting", CASES)
def test_metric_grads_match_pallas(B, L, nesting):
    f, _, _, mmask = _data(B, L, nesting)
    f1, f2 = np.split(f, 2)
    lam1 = f1.T @ f1 / f1.shape[0]
    lam2 = f2.T @ f2 / f2.shape[0]
    s1, s2 = 2.0 / f1.shape[0], 2.0 / f2.shape[0]
    with pltpu.force_tpu_interpret_mode():
        j1, j2 = jax_metric_grads(*(jnp.asarray(a) for a in (f1, f2, lam1, lam2, mmask)),
                                  s1, s2)
    t1, t2 = metric_grads(*(_t(a) for a in (f1, f2, mmask * lam1, mmask * lam2)), s1, s2)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-4, atol=1e-6)


def _jax_losses(vmask, mmask):
    vm, mm = jnp.asarray(vmask), jnp.asarray(mmask)

    def xla(f, Tf, f1, f2):
        return nestedlora_evd_loss(None, f, Tf, f1, f2, vm, mm)

    def pallas(f, Tf, f1, f2):
        return nestedlora_evd_loss_pallas(f, Tf, f1, f2, vm, mm)

    return xla, pallas


@pytest.mark.parametrize("port_loss", ["kernels", "plain"])
@pytest.mark.parametrize("B,L,nesting", CASES)
def test_evd_loss_and_grads_match_jax(B, L, nesting, port_loss):
    """Value and the custom backward (f, f1, f2 as separate arguments)
    against both JAX packagings."""
    f, Tf, vmask, mmask = _data(B, L, nesting)
    f1, f2 = np.split(f, 2)
    xla, pallas = _jax_losses(vmask, mmask)
    args = tuple(jnp.asarray(a) for a in (f, Tf, f1, f2))
    with pltpu.force_tpu_interpret_mode():
        lp = pallas(*args)
        gp = jax.grad(pallas, argnums=(0, 2, 3))(*args)
    lx = xla(*args)
    gx = jax.grad(xla, argnums=(0, 2, 3))(*args)

    fn = nestedlora_evd_loss_kernels if port_loss == "kernels" else torch_evd_loss
    tf, tTf, tf1, tf2 = _t(f, True), _t(Tf), _t(f1, True), _t(f2, True)
    loss = fn(tf, tTf, tf1, tf2, _t(vmask), _t(mmask))
    grads = torch.autograd.grad(loss, (tf, tf1, tf2))
    for ref_loss, ref_grads in ((lp, gp), (lx, gx)):
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
        for a, b in zip(grads, ref_grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("B,L,nesting", CASES)
def test_evd_loss_through_split_views_matches_jax(B, L, nesting):
    """As the method calls it: f1/f2 are row views of fs, so the gradient
    of fs sums the operator term and both metric terms."""
    f, Tf, vmask, mmask = _data(B, L, nesting)
    xla, _ = _jax_losses(vmask, mmask)

    def jax_of_fs(fs):
        f1, f2 = jnp.split(fs, 2)
        return xla(fs, jnp.asarray(Tf), f1, f2)

    jl, jg = jax.value_and_grad(jax_of_fs)(jnp.asarray(f))
    fs = _t(f, True)
    f1, f2 = torch.chunk(fs, 2)
    loss = nestedlora_evd_loss_kernels(fs, _t(Tf), f1, f2, _t(vmask), _t(mmask))
    (g,) = torch.autograd.grad(loss, fs)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_plain_evd_loss_matches_xla_for_multi_output():
    """(B, L, O) outputs take the plain path; its einsums keep the O axis."""
    rng = np.random.default_rng(1)
    B, L, O = 32, 4, 3
    f = rng.normal(size=(B, L, O)).astype(np.float32)
    Tf = rng.normal(size=(B, L, O)).astype(np.float32)
    vmask, mmask = (np.asarray(m) for m in joint_nesting_masks(step_weights(L)))
    xla, _ = _jax_losses(vmask, mmask)
    f1, f2 = np.split(f, 2)
    args = tuple(jnp.asarray(a) for a in (f, Tf, f1, f2))
    lx = xla(*args)
    gx = jax.grad(xla, argnums=(0, 2, 3))(*args)
    tf, tf1, tf2 = _t(f, True), _t(f1, True), _t(f2, True)
    loss = torch_evd_loss(tf, _t(Tf), tf1, tf2, _t(vmask), _t(mmask))
    grads = torch.autograd.grad(loss, (tf, tf1, tf2))
    np.testing.assert_allclose(loss.item(), float(lx), rtol=1e-5)
    for a, b in zip(grads, gx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 4), (3, 5, 5)])
def test_off_diagonal_matches_jax(shape):
    from neuralsvd_tpu.ops.gram import off_diagonal as jax_off_diagonal
    from neuralsvd_tpu_torch.ops.gram import off_diagonal

    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(off_diagonal(torch.as_tensor(x)).numpy(),
                                  np.asarray(jax_off_diagonal(jnp.asarray(x))))


def test_tf_receives_no_gradient():
    f, Tf, vmask, mmask = _data(64, 4, "sequential")
    tf, tTf = _t(f, True), _t(Tf, True)
    f1, f2 = torch.chunk(tf, 2)
    for fn in (nestedlora_evd_loss_kernels, torch_evd_loss):
        loss = fn(tf, tTf, f1, f2, _t(vmask), _t(mmask))
        _, gTf = torch.autograd.grad(loss, (tf, tTf), allow_unused=True)
        assert gTf is None


def test_wrappers_reject_mixed_and_unsupported_devices():
    f = torch.zeros(8, 3)
    meta = torch.zeros(8, 3, device="meta")
    with pytest.raises(ValueError):
        weighted_dot(f, meta, torch.zeros(3))
    with pytest.raises(ValueError):
        masked_gram_pair(meta, meta, torch.zeros(3, 3, device="meta"))


def test_launch_counts_reset():
    cuda_gram.reset_launch_counts()
    assert cuda_gram.launch_counts() == {
        "masked_gram_pair": 0, "weighted_dot": 0, "metric_grads": 0}


@pytest.mark.parametrize("L", [1, 5, 16, 63, 64, 65, 513])
def test_upper_tile_table_covers_each_pair_once(L):
    """K1 computes only the tiles of the upper triangle: together they hold
    each (l <= m) exactly once, and no tile lies below the diagonal."""
    tiles = cuda_gram.upper_tiles(L)
    T = cuda_gram.K1_TILE
    assert tiles.dtype == np.int32 and (tiles[:, 0] <= tiles[:, 1]).all()
    count = np.zeros((L, L), dtype=int)
    for l0, m0 in tiles:
        count[l0:l0 + T, m0:m0 + T] += 1
    upper = np.triu(np.ones((L, L), dtype=bool))
    assert (count[upper] == 1).all()


def test_k1_plan_at_the_cdk_shape():
    """4096 x 513: the partials stay in L2 (at most 17 MB, from 67 MB) and
    the grid fills two waves of 132 SMs."""
    plan = cuda_gram.k1_plan(4096, 513)
    assert plan.scratch_bytes <= 17e6
    assert plan.blocks >= 2 * cuda_gram.NUM_SMS
    assert plan.nchunk * plan.rows_per_chunk >= 4096
    assert plan.rows_per_chunk % cuda_gram.K1_BK == 0


def test_k1_plan_at_the_e4_shape():
    """A half-batch of E4 (256 x 16): no more than two CUDA kernels a call."""
    assert cuda_gram.k1_plan(256, 16).launches <= 2


@pytest.mark.parametrize("B,L,vec", [(512, 16, 4), (96, 5, 1), (2048, 64, 4), (2000, 129, 1),
                                     (4096, 513, 1), (4096, 512, 4), (1, 1, 1)])
def test_k2_plan_covers_every_row_and_column(B, L, vec):
    """K2's grid: every (chunk, slot) warp exists, every row group falls
    to a slot, the grid stays within DOT_MAX_BLOCKS, E4 is one block and
    the CDK pair fills the card."""
    plan = cuda_gram.k2_plan(B, L, vec)
    cols = L // vec
    nchunks = 1 if cols <= 32 else -(-cols // 32)
    rows_per_group = 32 // cols if cols <= 32 else 1
    groups = -(-B // rows_per_group)
    assert plan.blocks * cuda_gram.DOT_WARPS >= plan.slots * nchunks
    assert 1 <= plan.slots <= groups
    assert plan.blocks <= cuda_gram.DOT_MAX_BLOCKS
    if (B, L) == (512, 16):
        assert plan.blocks == 1
    if (B, L) == (4096, 513):
        assert plan.blocks >= 3 * cuda_gram.NUM_SMS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(256, 16), (48, 5), (1024, 64), (300, 128)])
def test_cuda_kernels_match_plain_versions(cuda_device, B, L):
    """Each kernel against its plain version on the card; the error bound
    is 1e-5 of the plain version applied to |inputs| (the f32 rounding
    scale of these sums)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    f1, f2, Tf, f = (torch.randn(B, L, generator=g, device=cuda_device)
                     for _ in range(4))
    mmask = torch.triu(torch.ones(L, L, device=cuda_device))
    vmask = torch.rand(L, generator=g, device=cuda_device)
    before = cuda_gram.launch_counts()
    loss, lam1, lam2, _, _ = masked_gram_pair(f1, f2, mmask)
    rl, rl1, rl2, rc1, rc2 = cuda_gram.masked_gram_pair_ref(f1, f2, mmask)
    sl, sl1, _, _, _ = cuda_gram.masked_gram_pair_ref(f1.abs(), f2.abs(), mmask)
    assert (loss - rl).abs() <= 1e-5 * sl
    assert (lam1 - rl1).abs().max() <= 1e-5 * sl1.max()
    assert (lam2 - rl2).abs().max() <= 1e-5 * sl1.max()
    out = weighted_dot(f, Tf, vmask)
    assert (out - cuda_gram.weighted_dot_ref(f, Tf, vmask)).abs() <= (
        1e-5 * cuda_gram.weighted_dot_ref(f.abs(), Tf.abs(), vmask))
    g1, g2 = metric_grads(f1, f2, rc1, rc2, 2.0 / B, 3.0 / B)
    r1, r2 = cuda_gram.metric_grads_ref(f1, f2, rc1, rc2, 2.0 / B, 3.0 / B)
    s1, s2 = cuda_gram.metric_grads_ref(f1.abs(), f2.abs(), rc1.abs(), rc2.abs(),
                                        2.0 / B, 3.0 / B)
    assert ((g1 - r1).abs() <= 1e-5 * s1.max()).all()
    assert ((g2 - r2).abs() <= 1e-5 * s2.max()).all()
    after = cuda_gram.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)
