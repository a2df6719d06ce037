"""The port's spans, set-up timings and counters (``utils/tracing.py``).

CPU: a span costs nothing without a profiler; under a CPU profiler a small
E4 eager step and a small CDK step record the span tree of their layers; a
``timed`` interval starts where its profiler range starts; the K1-K3
counters read the same through ``cuda_gram.launch_counts``.  Marked
``cuda`` (run on the card with ``python -m pytest --noconftest
tests/test_torch_tracing.py -m cuda -q``): the graph counters over two
blocks, and a traced CDK window whose device records hold no span's name.

Imports torch and the port alone.
"""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuralsvd_tpu_torch.cli import pde, sketchy
from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.training.train_operator import ScannedTrainStep, make_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state
from neuralsvd_tpu_torch.utils import tracing
from neuralsvd_tpu_torch.utils.config import parse_pde_config

E4_TINY = ("--potential_type hydrogen --ndim 2 --neigs 4 --parallel true "
           "--apply_boundary false --laplacian_eps -1 --operator_scale 100 "
           "--use_fourier_feature true --fourier_mapping_size 8 --fourier_scale 0.1 "
           "--fourier_append_radial true --fourier_append_envelopes 2,0.6667,0.4,0.2857 "
           "--mlp_hidden_dims 16,16 --sampling_mode gaussian_mixture "
           "--sampling_scales 0.5,2,6,16 --batch_size 64 --optimizer rmsprop --lr 1e-4 "
           "--use_lr_scheduler true --ema_decay 0.995 --neuralsvd.sequential true "
           "--laplacian_mode forward --seed 3").split()
CDK_TINY = ["--network_dims", "32,16", "--mu", "16", "--neigs", "16", "--batch_size", "64",
            "--optimizer", "sgd", "--momentum", "0.9", "--base_lr", "5e-3", "--grad_clip", "1.0",
            "--loss", "neuralsvd", "--neuralsvd.step", "1", "--seed", "3"]
PRODUCTS = {"fwdlap.matmul", "fwdlap.__matmul__", "fwdlap.__rmatmul__", "fwdlap.einsum",
            "fwdlap.linear", "fwdlap.tower_product"}
STEP_PARTS = ("train.sample", "train.loss_and_grad", "train.clip", "train.optimizer",
              "train.ema")


def _host_ranges(prof):
    """[(name, start_ns, end_ns, thread)] of the trace's host events."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _e4_blocks(device):
    cfg = parse_pde_config(E4_TINY + ["--device", str(device)])
    run = pde.build(cfg)
    step = make_train_step(run.method, run.operator, run.optimizer, run.sample,
                           importance=run.importance_train, ema_decay=cfg.ema_decay,
                           grad_clip=cfg.grad_clip)
    ts = init_train_state(run.model, run.optimizer, run.method)
    return ScannedTrainStep(step, 4, seed=cfg.seed), ts


def _cdk_trainer(device):
    args = sketchy.get_args(CDK_TINY + ["--device", str(device)])
    tr = sketchy.make_trainer(args, 24, 4)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(64, 24, generator=gen, device=device)
    y = x + torch.randn(64, 24, generator=gen, device=device)
    skips = torch.zeros((), dtype=torch.int32, device=device)
    return tr, x, y, skips


def _cdk_step(tr, x, y, skips):
    return tr.step(tr.params, tr.opt_state, {}, x, y, skips)


def test_span_enters_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} opened without a profiler")

    assert not torch.autograd._profiler_enabled()
    blocks, ts = _e4_blocks("cpu")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert tracing.span("train.step") is tracing.span("op.apply")  # one shared no-op
    blocks.begin_block(ts.step.device, 0)
    blocks.eager_step(ts)
    tr, x, y, skips = _cdk_trainer("cpu")
    _cdk_step(tr, x, y, skips)


def test_e4_eager_step_records_its_span_tree():
    blocks, ts = _e4_blocks("cpu")
    blocks.begin_block(ts.step.device, 0)
    blocks.eager_step(ts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blocks.eager_step(ts)
    ranges = _host_ranges(prof)
    (step,) = _named(ranges, "train.step")
    parts = [_named(ranges, name) for name in STEP_PARTS]
    assert all(len(p) == 1 for p in parts), [len(p) for p in parts]
    parts = [p[0] for p in parts]
    assert all(_inside(p, step) for p in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))  # in order, disjoint
    loss_and_grad = parts[1]
    ops = _named(ranges, "op.apply")
    assert ops and all(_inside(o, loss_and_grad) for o in ops)
    outer = max(ops, key=lambda r: r[2] - r[1])
    engine = [r for r in ranges if r[0].startswith("fwdlap.")]
    products = [r for r in engine if r[0] in PRODUCTS]
    assert products and len(engine) > len(products)
    assert not {"fwdlap.shape", "fwdlap.dtype", "fwdlap.device"} & {r[0] for r in engine}
    assert all(_inside(r, outer) for r in engine)
    (forward,) = _named(ranges, "loss.forward")
    (backward,) = _named(ranges, "loss.backward")
    assert _inside(forward, loss_and_grad) and _inside(backward, loss_and_grad)
    assert outer[2] <= forward[1] and forward[2] <= backward[1]
    (written,) = _named(ranges, "train.metrics")
    assert step[2] <= written[1]


def test_cdk_step_records_its_span_tree():
    tr, x, y, skips = _cdk_trainer("cpu")
    _cdk_step(tr, x, y, skips)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cdk_step(tr, x, y, skips)
    ranges = _host_ranges(prof)
    (step,) = _named(ranges, "train.step")
    parts = [_named(ranges, name)[0] for name in STEP_PARTS[1:4]]
    assert all(_inside(p, step) for p in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))
    assert not _named(ranges, "train.sample") and not _named(ranges, "train.ema")
    for name in ("model.forward", "loss.forward", "loss.backward"):
        (r,) = _named(ranges, name)
        assert _inside(r, parts[0]), name
    assert _named(ranges, "model.forward")[0][2] <= _named(ranges, "loss.forward")[0][1]


def test_timed_starts_with_its_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.timed("setup.probe"):
            time.sleep(0.002)
    name, start, end = tracing.timed_spans()[-1]
    (r,) = _named(_host_ranges(prof), "setup.probe")
    assert name == "setup.probe" and end - start >= 2_000_000
    assert abs(start - r[1]) < 50_000 and abs(end - r[2]) < 50_000
    assert tracing.timed_seconds()["setup.probe"] >= 0.002


def test_timed_keeps_an_interval_without_a_profiler_and_on_a_raise():
    before = len(tracing.timed_spans())

    @tracing.timed("setup.fails")
    def fails():
        raise ValueError("no")

    with pytest.raises(ValueError):
        fails()
    assert [s[0] for s in tracing.timed_spans()[before:]] == ["setup.fails"]


def test_counters_and_launch_counts_agree(monkeypatch):
    # a CPU build of torch has no stream capture to ask about
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    tracing.reset_counts()
    tracing.count("graph.replays", 5)
    for wrapper, n in ((cuda_gram.masked_gram_pair, 2), (cuda_gram.weighted_dot, 3)):
        for _ in range(n):
            cuda_gram._count(wrapper)
    assert cuda_gram.launch_counts() == {"masked_gram_pair": 2, "weighted_dot": 3,
                                         "metric_grads": 0}
    assert tracing.counts() == {"graph.replays": 5, "gram.masked_gram_pair": 2,
                                "gram.weighted_dot": 3}
    cuda_gram.reset_launch_counts()
    assert tracing.counts() == {"graph.replays": 5}
    assert set(cuda_gram.launch_counts().values()) == {0}
    tracing.reset_counts()
    assert tracing.counts() == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_counters_over_two_blocks(cuda_device):
    blocks, ts = _e4_blocks(cuda_device)
    tracing.reset_counts("graph.")
    cuda_gram.reset_launch_counts()
    blocks(ts, 0)
    blocks(ts, 4)
    torch.cuda.synchronize()
    counts = tracing.counts()
    assert counts["graph.captures"] == 1 and counts["graph.replays"] == 8
    # the capture's warm-up steps launch K1-K3; the replays call no wrapper
    assert cuda_gram.launch_counts() == {"masked_gram_pair": 3, "weighted_dot": 3,
                                         "metric_grads": 3}


@pytest.mark.cuda
def test_traced_cdk_window_holds_no_span_on_the_card(cuda_device):
    tr, x, y, skips = _cdk_trainer(cuda_device)
    _cdk_step(tr, x, y, skips)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            _cdk_step(tr, x, y, skips)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    ranges = _host_ranges(prof)
    spans = {r[0] for r in ranges if r[0].startswith(("train.", "model.", "loss."))}
    assert {"train.step", "train.loss_and_grad", "model.forward", "loss.forward",
            "loss.backward", "train.clip", "train.optimizer"} <= spans
    device = [e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert device and not spans & set(device)
    # the loss's backward runs on autograd's device thread, inside the step's
    # loss_and_grad range on the calling thread
    for backward in _named(ranges, "loss.backward"):
        outer = [r for r in _named(ranges, "train.loss_and_grad") if _inside(backward, r)]
        assert len(outer) == 1 and outer[0][3] != backward[3]
