"""The port's CUDA kernels against their plain versions, on the card only.

This file imports torch and the port alone (no JAX), so it runs on a GPU
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Every test is marked ``cuda`` and skips where torch sees no GPU.  Shapes
are the CDK path's at the Sketchy paper width: f and g of 4096 rows and
L = 512 + the constant mode = 513 columns (not a multiple of the kernels'
64-wide tiles, nor of the 4 floats of a 16-byte copy), and a sweep of
widths on both sides of the tile edges.
"""
import pytest
import torch

from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.ops.cuda_gram import nestedlora_cdk_loss_kernels
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)
from neuralsvd_tpu_torch.ops.nestedlora import nestedlora_cdk_loss

B, L = 4096, 512
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # atol in units of the largest entry
KERNEL_RTOL = 1e-5  # of the plain version on |inputs|: f32 rounding scale


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _masks(device):
    return tuple(torch.as_tensor(m, device=device)
                 for m in joint_nesting_masks(step_weights(L), set_first_mode_const=True))


def _pair(device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.randn(B, L + 1, generator=gen, device=device)
    g = f + torch.randn(B, L + 1, generator=gen, device=device)
    return f, g


@pytest.mark.cuda
def test_kernels_match_plain_versions_at_cdk_shape(cuda_device):
    """K1-K3 at (4096, 513), each within 1e-5 of its plain version applied
    to |inputs| (the f32 rounding scale of these sums); one launch each."""
    f, g = _pair(cuda_device)
    vmask, mmask = _masks(cuda_device)
    s = 2.0 / B
    before = cuda_gram.launch_counts()
    got = cuda_gram.masked_gram_pair(f, g, mmask)
    want = cuda_gram.masked_gram_pair_ref(f, g, mmask)
    scale = cuda_gram.masked_gram_pair_ref(f.abs(), g.abs(), mmask)
    for a, b, sc in zip(got, want, scale):
        assert ((a - b).abs().max() <= KERNEL_RTOL * sc.abs().max()).item()
    dot = cuda_gram.weighted_dot(f, g, vmask)
    assert ((dot - cuda_gram.weighted_dot_ref(f, g, vmask)).abs()
            <= KERNEL_RTOL * cuda_gram.weighted_dot_ref(f.abs(), g.abs(), vmask)).item()
    mlam_f, mlam_g = want[3:]
    got = cuda_gram.metric_grads(f, g, mlam_f, mlam_g, s, s)
    want = cuda_gram.metric_grads_ref(f, g, mlam_f, mlam_g, s, s)
    scale = cuda_gram.metric_grads_ref(f.abs(), g.abs(), mlam_f.abs(), mlam_g.abs(), s, s)
    for a, b, sc in zip(got, want, scale):
        assert ((a - b).abs().max() <= KERNEL_RTOL * sc.abs().max()).item()
    torch.cuda.synchronize()
    after = cuda_gram.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


@pytest.mark.cuda
def test_masked_gram_pair_repeats_bit_for_bit(cuda_device):
    """No float atomics: the same inputs give the same bits."""
    f, g = _pair(cuda_device, seed=1)
    _, mmask = _masks(cuda_device)
    first = cuda_gram.masked_gram_pair(f, g, mmask)
    second = cuda_gram.masked_gram_pair(f, g, mmask)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _within(got, want, scale):
    """Each output within KERNEL_RTOL of the largest entry of its plain
    version on |inputs|."""
    for a, b, sc in zip(got, want, scale):
        err = (a - b).abs().max().item()
        assert err <= KERNEL_RTOL * sc.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("nesting", ["joint", "sequential"])
@pytest.mark.parametrize("rows", [33, 1000, 4096])
@pytest.mark.parametrize("width", [1, 5, 16, 63, 64, 65, 127, 128, 129, 513])
def test_k1_k3_match_plain_versions_across_tile_edges(cuda_device, width, rows,
                                                      nesting):
    """K1 and K3 at widths on both sides of the 64-wide tiles (and of the
    16-byte copies) and at row counts that leave partial chunks; the
    sequential mask is upper triangular, so neither kernel may take M or
    M⊙Λ as symmetric."""
    gen = torch.Generator(device=cuda_device).manual_seed(width * 10007 + rows)
    f1 = torch.randn(rows, width, generator=gen, device=cuda_device)
    f2 = torch.randn(rows, width, generator=gen, device=cuda_device)
    masks = (joint_nesting_masks(step_weights(width)) if nesting == "joint"
             else sequential_nesting_masks(width))
    mmask = torch.as_tensor(masks[1], device=cuda_device)
    got = cuda_gram.masked_gram_pair(f1, f2, mmask)
    want = cuda_gram.masked_gram_pair_ref(f1, f2, mmask)
    _within(got, want, cuda_gram.masked_gram_pair_ref(f1.abs(), f2.abs(), mmask))
    assert torch.equal(got[1], got[1].T) and torch.equal(got[2], got[2].T)
    s1, s2 = 2.0 / rows, 3.0 / rows
    mlam1, mlam2 = want[3:]
    got = cuda_gram.metric_grads(f1, f2, mlam1, mlam2, s1, s2)
    want = cuda_gram.metric_grads_ref(f1, f2, mlam1, mlam2, s1, s2)
    _within(got, want, cuda_gram.metric_grads_ref(f1.abs(), f2.abs(), mlam1.abs(),
                                                  mlam2.abs(), s1, s2))


@pytest.mark.cuda
def test_metric_grads_repeat_bit_for_bit(cuda_device):
    """No float atomics in K3 either: the same inputs give the same bits."""
    f, g = _pair(cuda_device, seed=3)
    _, mmask = _masks(cuda_device)
    _, _, _, mlam_f, mlam_g = cuda_gram.masked_gram_pair(f, g, mmask)
    first = cuda_gram.metric_grads(f, g, mlam_f, mlam_g, 2.0 / B, 2.0 / B)
    second = cuda_gram.metric_grads(f, g, mlam_f, mlam_g, 2.0 / B, 2.0 / B)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", [False, True])
def test_cdk_packaging_matches_plain_loss(cuda_device, weights):
    """Kernel packaging vs the plain CDK loss on rows of norm ≤ 4 (the
    towers' √μ ball): losses and ratios rtol 1e-5, gradients rtol 1e-4 /
    atol 1e-6 of the largest entry."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    f = torch.nn.functional.normalize(torch.randn(B, L, generator=gen, device=cuda_device), dim=1)
    g = torch.nn.functional.normalize(f + torch.randn(B, L, generator=gen, device=cuda_device), dim=1)
    f, g = 4 * f, 4 * g
    bw = (torch.rand(B, 1, generator=gen, device=cuda_device) + 0.5) if weights else None
    vmask, mmask = _masks(cuda_device)
    outs, grads = [], []
    for fn in (nestedlora_cdk_loss_kernels, nestedlora_cdk_loss):
        a, b = f.clone().requires_grad_(), g.clone().requires_grad_()
        before = cuda_gram.launch_counts()
        out = fn(True, a, b, vmask, mmask, bw, return_ratios=True)
        grads.append(torch.autograd.grad(out[0], [a, b]))
        outs.append(out)
        after = cuda_gram.launch_counts()
        launched = int(fn is nestedlora_cdk_loss_kernels)
        assert all(after[k] - before[k] == launched for k in after)
    for got, want in zip(outs[0], outs[1]):
        torch.testing.assert_close(got, want, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * want.abs().max().item())
    for got, want in zip(grads[0], grads[1]):
        torch.testing.assert_close(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * want.abs().max().item())
