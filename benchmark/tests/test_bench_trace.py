"""Trace reading and the per-layer metrics on synthetic records."""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.trace import Record, Trace, union_us


def R(kind, name, start, dur, corr=0):
    return Record(kind, name, float(start), float(dur), corr)


def _replays(n, kernels, lost=None, start=1000.0, every=100.0):
    """``n`` replays of a graph of ``kernels`` kernels; replay i loses
    ``lost[i]`` of its records."""
    lost = lost or {}
    out = []
    for i in range(n):
        corr = 500 + i
        t = start + i * every
        out.append(R("runtime", "cudaGraphLaunch", t, 5, corr))
        for k in range(kernels - lost.get(i, 0)):
            name = "metric_grads_kernel<4>" if k == 0 else f"kernel_{k}"
            out.append(R("device", name, t + 10 + 8 * k, 6, corr))
    return out


def test_union_counts_overlapping_kernels_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert union_us(spans, 0, 100) == 35
    assert union_us(spans, 8, 45) == 7 + 10 + 5


def test_replay_kernels_reads_whole_replays_only():
    window = R("host", "benchmark.window", 900, 2000)
    trace = Trace([window] + _replays(12, 9, lost={3: 4}))
    assert trace.replay_kernels(window) == 9
    # two replays of twelve lost records: under 90% whole, nothing to read
    trace = Trace([window] + _replays(12, 9, lost={3: 4, 7: 1}))
    assert trace.replay_kernels(window) is None


def test_copies_are_not_kernels():
    window = R("host", "benchmark.window", 900, 2000)
    recs = _replays(10, 5)
    recs += [R("device", "Memcpy DtoD (Device -> Device)", 1000 + 100 * i + 90, 1, 500 + i)
             for i in range(10)]
    assert Trace([window] + recs).replay_kernels(window) == 5


def test_span_attribution_by_correlation_across_threads():
    """Kernels belong to the span in which their launch started, whichever
    thread launched them and whenever they ran."""
    recs = [R("host", "benchmark.step", 0, 100), R("host", "benchmark.method", 10, 60),
            R("host", "benchmark.operator", 15, 20),
            R("runtime", "cudaLaunchKernel", 16, 1, 1),   # operator
            R("runtime", "cudaLaunchKernel", 40, 1, 2),   # method (another thread)
            R("runtime", "cudaLaunchKernel", 80, 1, 3),   # update
            R("runtime", "cudaLaunchKernel", 150, 1, 4),  # outside every step
            R("device", "op", 200, 3000, 1), R("device", "loss", 3300, 500, 2),
            R("device", "adam", 3900, 250, 3), R("device", "later", 4200, 9000, 4)]
    ctx = _ctx(Trace(recs))
    read = {n: harness.metric_reader(harness.CHECKOUT, n)(ctx) for n in
            ("operator_device_ms", "method_device_ms.pde", "update_device_ms.pde")}
    assert read == {"operator_device_ms": 3.0, "method_device_ms.pde": 0.5,
                    "update_device_ms.pde": 0.25}


def test_idle_share_and_gaps():
    window = R("host", "benchmark.window", 0, 1000)
    recs = [window, R("device", "a", 0, 300), R("device", "b", 200, 300),
            R("device", "c", 700, 100), R("runtime", "cudaStreamSynchronize", 550, 100, 9),
            R("host", "aten::copy_", 820, 200)]
    trace = Trace(recs)
    ctx = _ctx(trace)
    idle = harness.metric_reader(harness.CHECKOUT, "device_idle_share.pde")(ctx)
    assert idle == pytest.approx(40.0)
    gaps = trace.idle_gaps(window)
    assert gaps[0] == ["cudaStreamSynchronize", 200e-6]
    assert gaps[1] == ["aten::copy_", 200e-6]


def test_eager_launches_per_step_and_gram_share():
    window = R("host", "benchmark.window", 0, 10_000)
    recs = [window]
    for i in range(4):
        t = 100 + 2000 * i
        recs.append(R("host", "benchmark.step", t, 1500))
        for k in range(3):
            corr = 10 * i + k + 1
            recs.append(R("runtime", "cudaLaunchKernel", t + 10 * k, 2, corr))
            name = "masked_gram_syrk_kernel" if k == 0 else "gemm"
            recs.append(R("device", name, t + 100 + 300 * k, 100, corr))
    ctx = _ctx(Trace(recs), traced_steps=4)
    assert harness.metric_reader(harness.CHECKOUT, "launches_per_step.cdk")(ctx) == 3.0
    share = harness.metric_reader(harness.CHECKOUT, "gram_roofline.cdk")(ctx)
    from benchmark.flops.gram import bound_s

    bound = bound_s(ctx.gram_work, ctx.peak["hbm_bytes_per_s"], ctx.peak["f32"])
    assert share == pytest.approx(100 * bound * 4 / (4 * 100e-6))


def test_every_metric_has_a_reader_and_finds_nothing_without_a_trace():
    spec = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    ctx = _ctx(Trace([]))
    for m in spec["per_layer"]:
        value = harness.metric_reader(harness.CHECKOUT, m["name"])(ctx)
        assert value is None or m["name"].startswith("mfu."), m["name"]


def test_mfu_from_the_window_and_the_count():
    ctx = _ctx(Trace([]))
    mfu = harness.metric_reader(harness.CHECKOUT, "mfu.cdk")(ctx)
    assert mfu == pytest.approx(100 * ctx.step_flops * 500 / 1.0 / 67e12)
    ctx.peak_flops = None
    assert harness.metric_reader(harness.CHECKOUT, "mfu.cdk")(ctx) is None


def _ctx(trace, traced_steps=1):
    cell = harness.load_cell("cdk_sketchy.f32")
    peak = harness.peaks_of(harness.CHECKOUT, "NVIDIA H100 80GB HBM3")
    ctx = harness.Context(cell, [], traced_steps, {"steps": 500, "seconds": 1.0}, peak, "f32")
    ctx.trace = trace
    return ctx
