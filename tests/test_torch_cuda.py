"""The port's CUDA kernels against their plain versions, on the card only.

This file imports torch and the port alone (no JAX), so it runs on a GPU
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Every test is marked ``cuda`` and skips where torch sees no GPU.  Shapes
are the CDK path's at the Sketchy paper width: f and g of 4096 rows and
L = 512 + the constant mode = 513 columns (not a multiple of the kernels'
32-wide tiles).
"""
import pytest
import torch

from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.ops.cuda_gram import nestedlora_cdk_loss_kernels
from neuralsvd_tpu_torch.ops.masks import joint_nesting_masks, step_weights
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
    _, lam_f, lam_g = want
    got = cuda_gram.metric_grads(f, g, lam_f, lam_g, mmask, s, s)
    want = cuda_gram.metric_grads_ref(f, g, lam_f, lam_g, mmask, s, s)
    scale = cuda_gram.metric_grads_ref(f.abs(), g.abs(), lam_f.abs(), lam_g.abs(), mmask, s, s)
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
