"""The per-layer metrics' readers, each ``reader(ctx) -> float | None``
(``harness.Context``), None where there is nothing to read.  Each metric's
file under ``metrics/`` names the reader it uses.

Spans are the benchmark's own (``drivers/``): ``benchmark.window`` around
the traced stretch, ``benchmark.step`` around each traced step,
``benchmark.method`` around ``method.loss_and_grad`` and
``benchmark.operator`` around the operator callable the train step gets.
"""
from benchmark.flops.gram import bound_s
from benchmark.trace import STEP, is_kernel

OPERATOR, METHOD = "benchmark.operator", "benchmark.method"


def mfu(ctx):
    """The whole step's share of the card's peak, %: the step's model FLOPs
    (the configuration's counting module, ``flops/``) times the steps of the
    untraced window, over the window's seconds and the published peak of
    the configuration's compute precision (``peaks.json``)."""
    if not ctx.peak_flops or not ctx.window["seconds"]:
        return None
    return 100.0 * ctx.step_flops * ctx.window["steps"] / ctx.window["seconds"] / ctx.peak_flops


def _device_ms(ctx, spans, minus=()):
    """Device ms a traced step of the kernels launched inside ``spans`` and
    not inside the spans ``minus``."""
    t = ctx.trace
    steps = t.spans(STEP)
    if not steps or not spans or not t.device:
        return None
    inner = {id(d) for d in t.launched_in(list(minus))}
    return sum(d.dur_us for d in t.launched_in(spans) if id(d) not in inner) / len(steps) / 1e3


def operator_device_ms(ctx):
    """Device ms a step launched inside the operator span."""
    return _device_ms(ctx, ctx.trace.spans(OPERATOR))


def method_device_ms(ctx):
    """Device ms a step launched inside the method span and outside the
    operator span within it: the loss, its backward and, where the operator
    is no span of its own, the model's forward."""
    return _device_ms(ctx, ctx.trace.spans(METHOD), ctx.trace.spans(OPERATOR))


def update_device_ms(ctx):
    """Device ms a step launched inside the step spans and outside their
    method span: the batch, the norm, clip and skip, the optimizer, the EMA."""
    methods = ctx.trace.spans(METHOD)
    return _device_ms(ctx, ctx.trace.spans(STEP), methods) if methods else None


def launches_per_step(ctx):
    """Device kernels a step in the traced window.  Over CUDA-graph replays,
    a whole replay's kernels (``Trace.replay_kernels``); over eager steps,
    the kernels launched inside the window's step spans over their number."""
    t = ctx.trace
    window = t.window()
    if window is None or not t.device:
        return None
    if t.graph_launches(window):
        return t.replay_kernels(window)
    steps = t.spans(STEP, within=window)
    if not steps:
        return None
    return sum(is_kernel(d) for d in t.launched_in(steps)) / len(steps)


def gram_roofline(ctx):
    """The NestedLoRA gram work's share of its roofline, %: the least time
    the work needs a step (``flops/gram.py``: K1 as a SYRK, K2, K3 at the
    configuration's shapes, each bounded by its bytes at the memory's peak
    or its float32 operations at the float32 peak, the larger) times the
    traced window's steps, over the device time of the kernels that do the
    work (``kernels/gram_work/*.json``) in that window."""
    t = ctx.trace
    window = t.window()
    if window is None or not ctx.peak:
        return None
    names = ctx.kernel_names("gram_work")
    spent_us = sum(d.dur_us for d in t.ran_in(window) if any(n in d.name for n in names))
    if spent_us <= 0:
        return None
    bound = bound_s(ctx.gram_work, ctx.peak["hbm_bytes_per_s"], ctx.peak["f32"])
    return 100.0 * bound * ctx.traced_steps / (spent_us / 1e6)


def device_idle_share(ctx):
    """The traced window's share in which nothing ran on the card, %: 1 -
    the union of the device operations' intervals (an overlap counted once)
    over the window's wall time."""
    t = ctx.trace
    window = t.window()
    if window is None or not t.device or window.dur_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us(window) / window.dur_us)
