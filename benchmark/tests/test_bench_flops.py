"""The counting modules against counts from the parameters' shapes and
from PyTorch's own FLOP counter, at small sizes."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.flops import cdk_sketchy, e4_hydrogen, gram
from benchmark.reference import cdk, e4


def _flags(name: str, **small) -> dict:
    path = harness.BENCH_DIR / "configs" / f"{name}.json"
    return {**json.loads(path.read_text())["flags"], **small}


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("hidden", ["16,16", "8,12,4"])
def test_e4_step_flops_from_the_towers_shapes(hidden):
    flags = _flags("e4_hydrogen", neigs=3, fourier_mapping_size=6, mlp_hidden_dims=hidden,
                   batch_size=10)
    weights = e4.make_weights(flags, 0, "cpu")
    macs_row = sum(w.numel() for k, w in weights.items() if ".ws." in k)
    first = weights["base.ws.0"]
    want = 2 * 10 * ((2 + 4) * macs_row - first.shape[0] * first.shape[1] * first.shape[2])
    assert e4_hydrogen.step_flops(flags) == want


def test_e4_value_channel_and_its_backward_by_the_flop_counter():
    """One forward of the towers is 2·B·macs_row; the backward to the
    parameters adds the weight gradients and every input gradient but the
    first layer's: together 1/(D+2)-th of the forward Laplacian plus the
    backward, as step_flops counts them."""
    flags = _flags("e4_hydrogen", neigs=3, fourier_mapping_size=6, mlp_hidden_dims="16,16",
                   batch_size=10)
    weights = {k: v.requires_grad_(True) for k, v in e4.make_weights(flags, 0, "cpu").items()}
    prob = e4.Problem(flags, 0, "cpu")
    x = torch.randn(10, 2)
    feats_flops = _flops(lambda: x @ prob.proj)
    fwd = _flops(lambda: prob.model(weights, x)) - feats_flops
    out = prob.model(weights, x)
    bwd = _flops(lambda: torch.autograd.grad(out.sum(), list(weights.values())))
    D = 2
    assert e4_hydrogen.step_flops(flags) == (D + 2) * fwd + bwd


def test_cdk_step_flops_from_the_towers_shapes_and_the_flop_counter():
    flags = _flags("cdk_sketchy", network_dims="24,8", neigs=8, batch_size=12)
    weights = {k: v.requires_grad_(True) for k, v in
               cdk.make_weights(flags, cdk_sketchy.INPUT_DIM, 0, "cpu").items()}
    prob = cdk.Problem(flags, 1, "cpu")
    x, y = torch.randn(12, 512), torch.randn(12, 512)
    fwd = _flops(lambda: (prob.tower(weights, "x", x), prob.tower(weights, "y", y)))
    fx, gy = prob.tower(weights, "x", x), prob.tower(weights, "y", y)
    bwd = _flops(lambda: torch.autograd.grad((fx.sum(), gy.sum()), list(weights.values())))
    L1, B = 9, 12
    grams = 2 * B * (L1 * (L1 + 1) + 2 * L1 * L1)  # two SYRKs, two metric products
    assert cdk_sketchy.step_flops(flags) == fwd + bwd + grams
    macs = sum(w.numel() for k, w in weights.items() if k.endswith(".w"))
    assert fwd == 2 * B * macs


def test_paper_width_counts():
    assert e4_hydrogen.step_flops(_flags("e4_hydrogen")) == pytest.approx(24.761e9, rel=1e-4)
    assert cdk_sketchy.step_flops(_flags("cdk_sketchy")) == pytest.approx(350.069e9, rel=1e-4)


def test_gram_bounds_at_the_cdk_shape():
    """K1's SYRK needs 2.16 GFLOP, K3 4.3 GFLOP, K2 16.8 MB at 4096 x 513:
    32 µs, 64 µs and 5 µs at the H100's peaks (ops/cuda_gram.py)."""
    peaks = json.loads((harness.BENCH_DIR / "peaks.json").read_text())["cards"]
    h100 = peaks["NVIDIA H100 80GB HBM3"]
    k1, k2, k3 = cdk_sketchy.gram_work(_flags("cdk_sketchy"))
    assert k1[1] == pytest.approx(2.16e9, rel=0.01) and k3[1] == pytest.approx(4.32e9, rel=0.01)
    assert k2[0] == pytest.approx(16.8e6, rel=0.01)
    k1_s = gram.bound_s([k1], h100["hbm_bytes_per_s"], h100["f32"])
    assert k1_s == pytest.approx(32.3e-6, rel=0.01)
    total = gram.bound_s([k1, k2, k3], h100["hbm_bytes_per_s"], h100["f32"])
    assert total == pytest.approx(0.102e-3, rel=0.02)


def test_e4_gram_work_is_bound_by_bytes():
    h100 = json.loads((harness.BENCH_DIR / "peaks.json").read_text())["cards"][
        "NVIDIA H100 80GB HBM3"]
    for nbytes, ops in e4_hydrogen.gram_work(_flags("e4_hydrogen")):
        assert nbytes / h100["hbm_bytes_per_s"] > ops / h100["f32"]
