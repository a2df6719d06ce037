"""The port's CUDA kernels against their plain versions, on the card only.

This file imports torch and the port alone (no JAX), so it runs on a GPU
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Every test is marked ``cuda`` and skips where torch sees no GPU.  Shapes
are the CDK path's at the Sketchy paper width: f and g of 4096 rows and
L = 512 + the constant mode = 513 columns (not a multiple of the kernels'
64-wide tiles, nor of the 4 floats of a 16-byte copy), and a sweep of
widths on both sides of the tile edges; K2 also at the smoke's five shapes.
The last tests capture a small E4-style train step (and a NeuralEF and a
Fokker–Planck step) in a CUDA graph and hold its replays against the same
steps run eagerly; Nyström's default device is checked to be the card.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.methods.neuralef import NeuralEigenfunctions
from neuralsvd_tpu_torch.methods.nystrom import Nystrom, run_nystrom
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.diff_ops import VectorizedLaplacian
from neuralsvd_tpu_torch.ops import cuda_gram, forward_laplacian
from neuralsvd_tpu_torch.ops.cuda_gram import nestedlora_cdk_loss_kernels
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)
from neuralsvd_tpu_torch.ops.nestedlora import nestedlora_cdk_loss
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.training.optimizers import build_optimizer, cosine_annealing
from neuralsvd_tpu_torch.training.train_operator import (
    GRAPH_WARMUP_STEPS,
    ScannedTrainStep,
    make_scanned_train_step,
)
from neuralsvd_tpu_torch.training.train_state import (
    init_train_state,
    load_state_tree,
    state_tree,
)

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


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(512, 16), (96, 5), (2048, 64), (2000, 129), (4096, 513),
                                 (4096, 512)])
def test_weighted_dot_is_one_launch_and_repeats_bit_for_bit(cuda_device, B, L):
    """K2 at the smoke's five shapes (and 4096 x 512, whose rows take
    16-byte loads): one CUDA kernel a call, the same bits every call,
    within 1e-5 of its plain version on |inputs|."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + L)
    f = torch.randn(B, L, generator=gen, device=cuda_device)
    tf = torch.randn(B, L, generator=gen, device=cuda_device)
    w = torch.rand(L, generator=gen, device=cuda_device)
    first = cuda_gram.weighted_dot(f, tf, w)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [cuda_gram.weighted_dot(f, tf, w) for _ in range(calls)]
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert all("weighted_dot_kernel" in k for k in kernels), kernels
    assert sum(kernels.values()) == calls, kernels
    assert all(torch.equal(first, o) for o in outs)
    want = cuda_gram.weighted_dot_ref(f, tf, w)
    scale = cuda_gram.weighted_dot_ref(f.abs(), tf.abs(), w)
    assert ((first - want).abs() <= KERNEL_RTOL * scale).item()


@pytest.mark.cuda
@pytest.mark.parametrize("probes", [0, 2])
def test_forward_engine_on_the_card(cuda_device, probes):
    """The E4 wavefunction at a small width on the card, under √w
    conjugation: the forward engine against nested JVPs (rtol 1e-4, atol
    1e-5 of the largest entry), with no fallback call; with probes, the
    Hutchinson estimate on the card equals the engine's l channel over the
    same probes."""
    kw = dict(ndim=2, neigs=6, mlp_hidden_dims=[32, 32], nonlinearity="softplus",
              parallel=True, use_fourier_feature=True, fourier_mapping_size=16,
              fourier_scale=0.1, fourier_append_radial=True,
              fourier_append_envelopes=(2.0, 2 / 3), apply_boundary=False)
    model = make_wavefunctions(**kw, device=cuda_device)
    sample, imp = get_sampler("gaussian_mixture", 256, 1, 2, (0.5, 2.0, 6.0, 16.0),
                              device=cuda_device)
    x = sample(torch.Generator(device=cuda_device).manual_seed(0))
    forward_laplacian.fallback_rule.calls = 0
    with torch.no_grad():
        if probes:
            lap = VectorizedLaplacian(eps=-1.0, num_probes=probes)(
                model, x, imp, generator=torch.Generator(device=cuda_device).manual_seed(1))[0]
            r = forward_laplacian.rademacher(
                (probes, 256, 2), torch.Generator(device=cuda_device).manual_seed(1),
                x.dtype, cuda_device)
            g = lambda xx: torch.sqrt(imp(xx)) * model(xx)  # noqa: E731
            l = forward_laplacian.propagate(g, x, r)[2]
            sqrt_ws = torch.clamp(torch.sqrt(imp(x)), min=1e-5)
            assert torch.equal(lap, l / probes / sqrt_ws)
        else:
            got = VectorizedLaplacian(eps=-1.0)(model, x, imp, return_grad=True)
            want = VectorizedLaplacian(eps=-1.0, exact_mode="jvp")(model, x, imp,
                                                                   return_grad=True)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * b.abs().max().item())
    assert forward_laplacian.fallback_rule.calls == 0


# -- the captured train step ---------------------------------------------------

GRAPH_STEPS = 20
GRAPH_MODEL = dict(ndim=2, neigs=6, mlp_hidden_dims=[32, 32], nonlinearity="softplus",
                   parallel=True, use_fourier_feature=True, fourier_mapping_size=16,
                   fourier_scale=0.1, fourier_append_radial=True,
                   fourier_append_envelopes=(2.0, 2 / 3), apply_boundary=False)


def _graph_setup(device, probes, use_graph):
    model = make_wavefunctions(**GRAPH_MODEL, seed=1, device=device)
    operator, _, _ = get_problem(problem="sch", potential_type="hydrogen", ndim=2,
                                 neigs=6, laplacian_eps=-1.0, laplacian_probes=probes,
                                 operator_scale=100.0)
    sampler, importance = get_sampler("gaussian_mixture", 256, 1, 2,
                                      (0.5, 2.0, 6.0, 16.0), device=device)
    method = NestedLoRA(model, neigs=6, sequential=True)
    optimizer = build_optimizer("rmsprop", 1e-3, lr_schedule=cosine_annealing(1e-3, 60))
    block = make_scanned_train_step(method, operator, optimizer, sampler,
                                    importance=importance, ema_decay=0.995,
                                    steps_per_call=GRAPH_STEPS, seed=7,
                                    use_graph=use_graph)
    return init_train_state(model, optimizer, method), block


def _assert_states_close(got, want):
    """rtol 1e-5 and atol 1e-6 of the largest entry, leaf by leaf."""
    if isinstance(want, torch.Tensor):
        if want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-6 * want.abs().max().item())
        else:
            assert torch.equal(got, want)
    elif isinstance(want, dict):
        for k in want:
            _assert_states_close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        for a, b in zip(got, want, strict=True):
            _assert_states_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("probes", [0, 2], ids=["exact", "hutchinson"])
def test_graph_blocks_match_eager_steps(cuda_device, probes):
    """Two blocks of GRAPH_STEPS replays of the captured step against the
    same steps run eagerly from the same state and block seeds: the whole
    state (params, RMSprop moments, schedule count, EMA, step) within rtol
    1e-5 / atol 1e-6 of the largest entry.  The EMA ramp and the cosine LR
    read the device step counter, so they advance across replays (a frozen
    counter would leave the graph's EMA and update sizes at step 0's).
    K2's ticket counters are back at zero after the replays.  The
    wrappers count the eager warm-up's launches alone: the capture
    launches nothing and the replays do not call them."""
    ts, graph = _graph_setup(cuda_device, probes, use_graph=True)
    start = state_tree(ts)
    cuda_gram.reset_launch_counts()
    losses = []
    for s in (0, GRAPH_STEPS):
        ts, m = graph(ts, s)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    assert all(v == 0 for v in cuda_gram.ticket_values().values())
    counts = cuda_gram.launch_counts()
    assert all(n == GRAPH_WARMUP_STEPS for n in counts.values()), counts
    assert graph.graph is not None
    got = state_tree(ts)
    assert int(got["step"]) == 2 * GRAPH_STEPS
    assert int(got["opt_state"][1]["count"]) == 2 * GRAPH_STEPS

    ts_e, eager = _graph_setup(cuda_device, probes, use_graph=False)
    load_state_tree(ts_e, start)
    eager_losses = [eager(ts_e, s)[1]["loss"] for s in (0, GRAPH_STEPS)]
    assert eager.graph is None
    _assert_states_close(got, state_tree(ts_e))
    for a, b in zip(losses, eager_losses):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_replayed_block_launches_each_kernel_once_a_step(cuda_device):
    """The profiler sees one launch of K1's SYRK pass, K2 and K3 a step in
    a replayed block."""
    ts, graph = _graph_setup(cuda_device, 0, use_graph=True)
    graph(ts, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph(ts, GRAPH_STEPS)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA for _ in range(e.count)]
    for kernel in ("masked_gram_syrk_kernel", "weighted_dot_kernel", "metric_grads_kernel"):
        assert sum(kernel in n for n in names) == GRAPH_STEPS, kernel


@pytest.mark.cuda
def test_replacing_a_state_tensor_after_capture_raises(cuda_device):
    """The graph writes the tensors the state held at capture: a block
    after one of them was replaced raises instead of training a copy the
    state no longer holds, and replaying on in-place updates still runs."""
    ts, graph = _graph_setup(cuda_device, 0, use_graph=True)
    graph(ts, 0)
    load_state_tree(ts, state_tree(ts))  # in place: the graph stays valid
    graph(ts, GRAPH_STEPS)
    ts.ema_params = {k: v.clone() for k, v in ts.ema_params.items()}
    with pytest.raises(RuntimeError, match="replaced after the block was captured"):
        graph(ts, 2 * GRAPH_STEPS)
    torch.cuda.synchronize()
    assert int(ts.step) == 2 * GRAPH_STEPS


def _method_setup(device, kind, use_graph):
    """A NeuralEF step (finite differences at eps 0.1, or the forward
    engine), the Fokker–Planck recipe's step (sequential NestedLoRA
    through the kernels, forward engine with return_grad) or a cosine
    -potential step (its constants on the device) in blocks."""
    periodic = kind in ("fp", "cosine")
    model = make_wavefunctions(**dict(GRAPH_MODEL, fourier_append_radial=not periodic,
                                      fourier_append_envelopes=() if periodic else
                                      GRAPH_MODEL["fourier_append_envelopes"]),
                               seed=1, device=device)
    if kind in ("fp", "cosine"):
        operator, _, _ = (
            get_problem(problem="fp", ndim=2, neigs=6, laplacian_eps=-1.0, operator_shift=4.0)
            if kind == "fp" else
            get_problem(potential_type="cosine", ndim=2, neigs=6, laplacian_eps=-1.0,
                        operator_shift=10.0))
        sampler, importance = get_sampler("uniform", 256, 1, 2, 3.141592653589793,
                                          device=device)
        method = NestedLoRA(model, neigs=6, sequential=True)
        optimizer = build_optimizer("adam", 1e-3, lr_schedule=cosine_annealing(1e-3, 60))
    else:
        operator, _, _ = get_problem(problem="sch", potential_type="hydrogen", ndim=2,
                                     neigs=6, laplacian_eps=0.1 if kind == "fd" else -1.0,
                                     operator_scale=100.0)
        sampler, importance = get_sampler("gaussian_mixture", 256, 1, 2,
                                          (0.5, 2.0, 6.0, 16.0), device=device)
        method = NeuralEigenfunctions(model, neigs=6, unbiased=True)
        optimizer = build_optimizer("rmsprop", 1e-4, lr_schedule=cosine_annealing(1e-4, 60))
    block = make_scanned_train_step(method, operator, optimizer, sampler,
                                    importance=importance, ema_decay=0.995,
                                    steps_per_call=GRAPH_STEPS, seed=7,
                                    use_graph=use_graph)
    return init_train_state(model, optimizer, method), block


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fd", "forward", "fp", "cosine"],
                         ids=["neuralef-fd", "neuralef-forward", "fokker-planck", "cosine"])
def test_method_graph_blocks_match_eager_steps(cuda_device, kind):
    """Two blocks of replays against the same steps run eagerly, whole
    state within rtol 1e-5 / atol 1e-6 of the largest entry; NeuralEF's
    norm EMA (written in place, with its bool ``initialized``) included
    and moved off its ones."""
    ts, graph = _method_setup(cuda_device, kind, use_graph=True)
    start = state_tree(ts)
    losses = [graph(ts, s)[1]["loss"] for s in (0, GRAPH_STEPS)]
    torch.cuda.synchronize()
    assert graph.graph is not None
    got = state_tree(ts)
    assert all(torch.isfinite(x).all() for x in losses)
    if kind in ("fd", "forward"):
        assert bool(got["method_state"]["initialized"])
        assert not torch.equal(got["method_state"]["norm_unbiased"], torch.ones(1, 6))
    ts_e, eager = _method_setup(cuda_device, kind, use_graph=False)
    load_state_tree(ts_e, start)
    eager_losses = [eager(ts_e, s)[1]["loss"] for s in (0, GRAPH_STEPS)]
    _assert_states_close(got, state_tree(ts_e))
    for a, b in zip(losses, eager_losses):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_kernels_match_plain_versions_at_the_fp_shape(cuda_device):
    """K1-K3 at the Fokker–Planck recipe's 512 x 7 (halves 256 x 7: 28-byte
    rows on the 4-byte copy path, fewer columns than one 64-wide tile),
    sequential masks: within 1e-5 of each plain version's scale."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    f = torch.randn(512, 7, generator=gen, device=cuda_device)
    Tf = torch.randn(512, 7, generator=gen, device=cuda_device)
    f1, f2 = torch.chunk(f, 2)
    vmask, mmask = (torch.as_tensor(m, device=cuda_device) for m in sequential_nesting_masks(7))
    want = cuda_gram.masked_gram_pair_ref(f1, f2, mmask)
    _within(cuda_gram.masked_gram_pair(f1, f2, mmask), want,
            cuda_gram.masked_gram_pair_ref(f1.abs(), f2.abs(), mmask))
    _within((cuda_gram.weighted_dot(f, Tf, vmask),),
            (cuda_gram.weighted_dot_ref(f, Tf, vmask),),
            (cuda_gram.weighted_dot_ref(f.abs(), Tf.abs(), vmask),))
    mlam1, mlam2 = want[3], want[4]
    _within(cuda_gram.metric_grads(f1, f2, mlam1, mlam2, 1 / 128, 1 / 128),
            cuda_gram.metric_grads_ref(f1, f2, mlam1, mlam2, 1 / 128, 1 / 128),
            cuda_gram.metric_grads_ref(f1.abs(), f2.abs(), mlam1.abs(), mlam2.abs(),
                                       1 / 128, 1 / 128))


def _rank3_kernel(x, y):
    """k(x, y) = Σ_k λ_k φ_k(x) φ_k(y), φ_k = √2 sin(πkx), on x's device."""
    lam = torch.tensor([2.0, 1.0, 0.5], device=x.device)
    k = torch.arange(1, 4, dtype=x.dtype, device=x.device)
    phi = lambda z: math.sqrt(2.0) * torch.sin(math.pi * k * z.reshape(-1, 1))
    return (phi(x) * lam) @ phi(y).T


@pytest.mark.cuda
def test_nystrom_runs_on_the_card_by_default(cuda_device):
    """Numpy samples given to Nyström with no device go to the card, the
    empirical kernel and the extension run there, and the result equals
    the CPU run's (eigvals rtol 1e-5; eigenfunctions up to sign, rtol 1e-4,
    atol 1e-5 of the largest entry)."""
    rng = np.random.default_rng(5)
    xs = rng.uniform(0, 1, size=600).astype(np.float32)
    xval = np.linspace(0, 1, 200).astype(np.float32)
    ny = Nystrom(_rank3_kernel, xs, dim=3)
    assert ny.xs.device.type == "cuda" and ny.eigvecs.device.type == "cuda"
    assert ny(xval).device.type == "cuda"
    ev, ef, _ = run_nystrom(_rank3_kernel, 3, xs, xval)
    ev_c, ef_c, _ = run_nystrom(_rank3_kernel, 3, xs, xval, device="cpu")
    np.testing.assert_allclose(ev, ev_c, rtol=1e-5)
    signs = np.sign(np.sum(ef * ef_c, axis=0))
    np.testing.assert_allclose(ef * signs, ef_c, rtol=1e-4, atol=1e-5 * np.abs(ef_c).max())


@pytest.mark.cuda
def test_a_step_that_reads_the_host_fails_to_capture(cuda_device):
    """A step that reads a device value on the host cannot be captured: the
    block raises and runs no eager steps in its place.  (Last in the file:
    a failed capture may leave the process's CUDA state unusable.)"""
    ts, graph = _graph_setup(cuda_device, 0, use_graph=True)

    def reads_the_host(ts, generator, probes=None):
        ts, metrics = graph.step(ts, generator, probes)
        float(metrics["loss"])
        return ts, metrics

    block = ScannedTrainStep(reads_the_host, GRAPH_STEPS, seed=7)
    with pytest.raises(RuntimeError):
        block(ts, 0)


@pytest.mark.cuda
def test_tiers_error_ordering_on_the_card(cuda_device):
    """A per-mode tower product at each tier against float64 on the card:
    "highest" (IEEE) and "high" (3xTF32) within 2^-18 of the largest
    entry, "default" (one TF32 pass) between 2^-16 and 2^-8, in that
    order; the backward products at the tier too; and the float32 matmul
    precision is "highest" again after each tiered call."""
    from neuralsvd_tpu_torch.models.mlp import tower_product

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn(16, 128, 2053, generator=gen, device=cuda_device)
    x = torch.randn(512, 2053, generator=gen, device=cuda_device)
    exact = torch.einsum("lhd,bd->lhb", w.double(), x.double())
    scale = exact.abs().max().item()
    torch.set_float32_matmul_precision("highest")
    err, grad_err = {}, {}
    g = torch.randn(exact.shape, generator=gen, device=cuda_device)
    grad_exact = torch.einsum("lhb,bd->lhd", g.double(), x.double())
    for tier in ("highest", "high", "default"):
        wr = w.clone().requires_grad_()
        out = tower_product("lhd,bd->lhb", wr, x, tier)
        (gw,) = torch.autograd.grad(out, wr, g)
        assert torch.get_float32_matmul_precision() == "highest"
        err[tier] = (out.double() - exact).abs().max().item() / scale
        grad_err[tier] = ((gw.double() - grad_exact).abs().max()
                          / grad_exact.abs().max()).item()
    assert err["highest"] <= 2.0 ** -18 and err["high"] <= 2.0 ** -18
    assert 2.0 ** -16 <= err["default"] <= 2.0 ** -8
    assert max(err["highest"], err["high"]) < err["default"]
    assert max(grad_err["highest"], grad_err["high"]) < grad_err["default"] <= 2.0 ** -8
