"""The readers of the program's own spans (``program_spans.py``) on
synthetic records: a layer less its children, kernels launched from
another thread, the replay line-up, the set-up intervals, and nothing
read without a trace.  Marked ``cuda``, run on the card with
``python3 -m pytest benchmark/tests/test_bench_program_spans.py -m cuda -q``:
a traced stretch of each cell at its committed size, whose split adds up
to the step and to the outside spans' readings, printed as one JSON line."""
from __future__ import annotations

import importlib
import json

import pytest

from benchmark import harness, program_spans
from benchmark.trace import Record, Trace

NEW = ("sample_device_ms.pde", "engine_product_device_ms.pde",
       "engine_pointwise_device_ms.pde", "loss_kernels_device_ms.pde",
       "optimizer_device_ms.pde", "ema_device_ms.pde", "update_kernels_per_step.pde",
       "replay_attributed_share.pde", "tower_device_ms.cdk", "loss_kernels_device_ms.cdk",
       "optimizer_device_ms.cdk", "setup_capture_s.pde", "setup_kernels_s",
       "tower_forward_device_ms.cdk")


def R(kind, name, start, dur, corr=0):
    return Record(kind, name, float(start), float(dur), corr)


def _read(name, trace, cell="e4_hydrogen.fwdlap"):
    cell = harness.load_cell(cell)
    ctx = harness.Context(cell, [], 1, {"steps": 10, "seconds": 1.0}, None, "f32")
    ctx.trace = trace
    return harness.metric_reader(harness.CHECKOUT, name)(ctx)


def _e4_step(offset=0, corr=0):
    """One eager E4 step at host time ``offset``: its spans and one kernel
    a part (device µs: sample 5, product 40, element-wise 30, loss fwd 7,
    bwd 9 (another thread), towers' backward 11, clip 3, optimizer 13,
    EMA 17, metrics 2)."""
    o = offset
    recs = [R("host", "train.step", o, 900), R("host", "train.sample", o + 10, 40),
            R("host", "train.loss_and_grad", o + 60, 500),
            R("host", "op.apply", o + 70, 200), R("host", "fwdlap.tower_product", o + 80, 30),
            R("host", "fwdlap.softplus", o + 120, 30), R("host", "loss.forward", o + 300, 40),
            R("host", "loss.backward", o + 360, 50),
            R("host", "train.clip", o + 600, 50), R("host", "train.optimizer", o + 660, 100),
            R("host", "train.ema", o + 770, 100), R("host", "train.metrics", o + 910, 20)]
    for t, d, name in ((20, 5, "sample"), (85, 40, "gemm"), (125, 30, "softplus"),
                       (310, 7, "k1"), (370, 9, "k3"), (450, 11, "gemm_bwd"),
                       (610, 3, "norm"), (670, 13, "rmsprop"), (780, 17, "ema"),
                       (915, 2, "index_copy")):
        corr += 1
        recs.append(R("runtime", "cudaLaunchKernel", o + t, 1, corr))
        recs.append(R("device", name, 50_000 + o + t, d, corr))
    return recs, corr


def test_layers_and_their_self_time():
    recs, corr = _e4_step(0)
    more, _ = _e4_step(1000, corr)
    trace = Trace(recs + more)  # two steps: each reading is a step's
    got = {n: _read(n, trace) for n in NEW[:7]}
    assert got == {"sample_device_ms.pde": 0.005, "engine_product_device_ms.pde": 0.04,
                   "engine_pointwise_device_ms.pde": 0.03,
                   "loss_kernels_device_ms.pde": 0.016, "optimizer_device_ms.pde": 0.016,
                   "ema_device_ms.pde": 0.017, "update_kernels_per_step.pde": 3.0}
    tower = _read("tower_device_ms.cdk", trace, "cdk_sketchy.f32")
    assert tower == pytest.approx(0.081)  # loss_and_grad less loss.*: op.apply and the backward


def test_kernels_launched_from_another_thread_belong_to_the_open_span():
    """The backward's launches come from autograd's thread while the
    caller's thread waits inside ``train.loss_and_grad``: they belong to
    ``loss.backward`` where that range holds them, else to the towers."""
    recs = [R("host", "train.step", 0, 1000), R("host", "train.loss_and_grad", 100, 800),
            R("host", "model.forward", 110, 100), R("host", "loss.forward", 220, 50),
            R("host", "loss.backward", 400, 60)]
    for corr, (t, dur) in enumerate(((120, 100), (230, 10), (300, 200), (410, 20),
                                     (700, 400)), 1):
        recs.append(R("runtime", "cudaLaunchKernel", t, 1, corr))
        recs.append(R("device", f"k{corr}", 5000 + 1000 * corr, dur, corr))
    trace = Trace(recs)
    assert _read("loss_kernels_device_ms.cdk", trace, "cdk_sketchy.f32") == pytest.approx(0.03)
    assert _read("tower_device_ms.cdk", trace, "cdk_sketchy.f32") == pytest.approx(0.7)
    assert _read("tower_forward_device_ms.cdk", trace, "cdk_sketchy.f32") == pytest.approx(0.1)


def _window_of_replays(names, n=10):
    recs = [R("host", "benchmark.window", 0, 100_000)]
    for i in range(n):
        corr = 900 + i
        t = 100 + 1000 * i
        recs.append(R("runtime", "cudaGraphLaunch", t, 5, corr))
        recs += [R("device", name, t + 50 + 10 * k, 5, corr) for k, name in enumerate(names)]
    return recs


def test_replay_lines_up_with_the_eager_step():
    recs, _ = _e4_step(200_000)
    names = [r.name for r in sorted((r for r in recs if r.kind == "device"),
                                    key=lambda r: r.start_us)]
    trace = Trace(_window_of_replays(names) + recs)
    assert _read("replay_attributed_share.pde", trace) == 100.0
    assert program_spans.replay_lineup(trace)["parting"] is None


def test_replay_and_eager_step_part_at_one_kernel():
    recs, _ = _e4_step(200_000)
    names = [r.name for r in sorted((r for r in recs if r.kind == "device"),
                                    key=lambda r: r.start_us)]
    parted = names[:3] + ["other_k1"] + names[4:]
    trace = Trace(_window_of_replays(parted) + recs)
    assert _read("replay_attributed_share.pde", trace) == pytest.approx(90.0)
    assert program_spans.replay_lineup(trace)["parting"] == [3, "other_k1", "k1"]
    # an eager kernel launched outside every program span does not count
    recs = [r for r in recs if r.name != "train.metrics"]
    trace = Trace(_window_of_replays(names) + recs)
    assert program_spans.replay_lineup(trace) == {
        "share": 90.0, "parting": [9, "index_copy", "index_copy"], "kernels": 10}


def test_setup_intervals_less_the_load_inside(monkeypatch):
    from neuralsvd_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "_TIMED", [("setup.build", 0, 10**9),
                                            ("setup.capture", 2 * 10**9, 7 * 10**9),
                                            ("setup.kernels", 3 * 10**9, 4_500_000_000)])
    recs, _ = _e4_step(0)
    assert _read("setup_capture_s.pde", Trace(recs)) == pytest.approx(3.5)
    assert _read("setup_kernels_s", Trace(recs)) == pytest.approx(1.5)
    # an nvcc build inside the load: the capture less the whole load, the
    # load less the build
    monkeypatch.setattr(tracing, "_TIMED", [("setup.capture", 2 * 10**9, 9 * 10**9),
                                            ("setup.kernels.build", 3 * 10**9, 7 * 10**9),
                                            ("setup.kernels", 3 * 10**9, 7_250_000_000)])
    assert _read("setup_capture_s.pde", Trace(recs)) == pytest.approx(2.75)
    assert _read("setup_kernels_s", Trace(recs)) == pytest.approx(0.25)
    # beside a trace with no step of the program, nothing is read
    assert _read("setup_kernels_s", Trace([])) is None


def test_nothing_is_read_without_a_trace_or_the_program_spans():
    window = R("host", "benchmark.window", 0, 1000)
    outside_only = [window, R("host", "benchmark.step", 0, 500),
                    R("runtime", "cudaLaunchKernel", 10, 1, 1), R("device", "k", 20, 5, 1)]
    for trace in (Trace([]), Trace(outside_only)):
        for name in NEW:
            cell = "cdk_sketchy.f32" if name.endswith(".cdk") else "e4_hydrogen.fwdlap"
            assert _read(name, trace, cell) is None, name


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["e4_hydrogen.fwdlap", "cdk_sketchy.f32"])
def test_split_adds_up_on_the_card(card, capsys, name):
    """One timed block and the traced stretch of the cell as committed:
    the program's layers add up to its step and to the outside spans'
    readings, no device record bears a program span's name, and (E4) a
    whole replay lines up with an eager step kernel by kernel."""
    cell = harness.load_cell(name)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['config']['driver']}").Driver(cell, 2 ** 31 + 23, "cuda")
    driver.setup()
    driver.block()
    records, traced_steps = driver.traced()
    import torch

    peak = harness.peaks_of(harness.CHECKOUT, torch.cuda.get_device_name(0))
    ctx = harness.Context(cell, records, traced_steps, {"steps": 1, "seconds": 1.0}, peak,
                          cell["config"]["precision"])
    read = {m["name"]: harness.metric_reader(harness.CHECKOUT, m["name"])(ctx)
            for m in cell["per_layer"] if m["source"] == "device_trace"}
    ms = {"train.step": program_spans.device_ms(ctx, "train.step"),
          "train.loss_and_grad": program_spans.device_ms(ctx, "train.loss_and_grad")}
    if name.startswith("e4"):
        ms.update({"train.sample": program_spans.device_ms(ctx, "train.sample"),
                   "op.apply": program_spans.device_ms(ctx, "op.apply"),
                   "loss_and_grad_less_op": program_spans.device_ms(
                       ctx, "train.loss_and_grad", "op.apply")})
    with capsys.disabled():
        print(json.dumps({"cell": name, "span_ms": ms, "metrics": read,
                          "lineup": program_spans.replay_lineup(ctx.trace)}), flush=True)
    driver.free()
    assert all(v is not None for v in read.values()), read
    assert not [d.name for d in ctx.trace.device if program_spans.is_program_span(d.name)]
    if name.startswith("e4"):
        parts = (ms["train.sample"], ms["op.apply"], ms["loss_and_grad_less_op"],
                 read["optimizer_device_ms.pde"], read["ema_device_ms.pde"])
        assert sum(parts) == pytest.approx(ms["train.step"], rel=0.01)
        assert (read["engine_product_device_ms.pde"] + read["engine_pointwise_device_ms.pde"]
                == pytest.approx(ms["op.apply"], rel=1e-9))
        assert read["replay_attributed_share.pde"] == 100.0
    else:
        assert (read["tower_device_ms.cdk"] + read["loss_kernels_device_ms.cdk"]
                == pytest.approx(read["method_device_ms.cdk"], rel=0.01))
        assert read["optimizer_device_ms.cdk"] < read["update_device_ms.cdk"]
        assert 0 < read["tower_forward_device_ms.cdk"] < read["tower_device_ms.cdk"]
