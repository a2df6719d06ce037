"""Readers of the program's own spans: the per-layer split of a train step
and of set-up, each ``reader(ctx) -> float | None`` (``harness.Context``).

The port records its spans itself (``neuralsvd_tpu_torch/utils/tracing.py``)
as host ranges of the profiler: ``train.step`` around each step, inside it
``train.sample``, ``train.loss_and_grad`` (``op.apply`` with the forward
engine's ``fwdlap.<function>`` rules, ``model.forward``, ``loss.forward``,
``loss.backward``), ``train.clip``, ``train.optimizer``, ``train.ema``; and
the set-up intervals ``setup.capture``, ``setup.kernels`` and
``setup.kernels.build``, which it keeps in memory
(``tracing.timed_spans``).

A device record belongs to a span when the runtime call that launched it
started inside the span's interval, on any thread (``Trace.launched_in``'s
rule): a kernel launched inside nested spans belongs to each, so "X less
Y" (a set difference) is the kernels whose innermost span lies in X and
not in Y.  Device ms are per step: over the number of ``train.step`` spans
in the trace.  Each reader returns None where the program recorded none of
the spans it reads.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, List, Optional

from benchmark.trace import Record, Trace, is_kernel

STEP = "train.step"
PRODUCTS = frozenset({"fwdlap.matmul", "fwdlap.__matmul__", "fwdlap.__rmatmul__",
                      "fwdlap.einsum", "fwdlap.linear", "fwdlap.tower_product"})
LOSS = frozenset({"loss.forward", "loss.backward"})
UPDATE = frozenset({"train.clip", "train.optimizer", "train.ema"})
PREFIXES = ("train.", "op.", "fwdlap.", "model.", "loss.", "spin.", "setup.")


def _matcher(names) -> Callable[[str], bool]:
    if callable(names):
        return names
    names = frozenset([names] if isinstance(names, str) else names)
    return names.__contains__


def is_program_span(name: str) -> bool:
    return name.startswith(PREFIXES)


class _Intervals:
    """The union of some host spans' intervals, for membership tests."""

    def __init__(self, spans: List[Record]):
        self.starts: list = []
        self.ends: list = []
        for s in sorted(spans, key=lambda r: r.start_us):
            if self.ends and s.start_us <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], s.end_us)
            else:
                self.starts.append(s.start_us)
                self.ends.append(s.end_us)

    def __contains__(self, t: float) -> bool:
        i = bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def spans_of(trace: Trace, names) -> List[Record]:
    """The host records whose name ``names`` matches (a name, a collection
    of names or a predicate)."""
    match = _matcher(names)
    return [r for r in trace.host if match(r.name)]


def _launch_times(trace: Trace) -> dict:
    return {r.correlation: r.start_us for r in trace.runtime}


def launched_in(trace: Trace, names, minus=()) -> Optional[List[Record]]:
    """Device records launched inside a span ``names`` matches and inside
    none that ``minus`` matches; None where no span matches ``names``."""
    spans = spans_of(trace, names)
    if not spans:
        return None
    inside = _Intervals(spans)
    outside = _Intervals(spans_of(trace, minus)) if minus else _Intervals([])
    launch = _launch_times(trace)
    out = []
    for d in trace.device:
        t = launch.get(d.correlation)
        if t is not None and t in inside and t not in outside:
            out.append(d)
    return out


def _steps(ctx) -> int:
    return len(ctx.trace.spans(STEP)) if ctx.trace.device else 0


def device_ms(ctx, names, minus=()) -> Optional[float]:
    """Device ms a step of the records launched inside ``names`` and
    outside ``minus``."""
    steps = _steps(ctx)
    found = launched_in(ctx.trace, names, minus) if steps else None
    if found is None:
        return None
    return sum(d.dur_us for d in found) / steps / 1e3


def kernels_per_step(ctx, names) -> Optional[float]:
    steps = _steps(ctx)
    found = launched_in(ctx.trace, names) if steps else None
    if found is None:
        return None
    return sum(is_kernel(d) for d in found) / steps


def sample_device_ms(ctx):
    """The PDE step's draw of its batch."""
    return device_ms(ctx, "train.sample")


def engine_product_device_ms(ctx):
    """The forward engine's product calls (matmul, linear, einsum, the
    tower product), their channels stacked into one call each."""
    return device_ms(ctx, PRODUCTS)


def engine_pointwise_device_ms(ctx):
    """The operator's kernels outside the engine's product calls: the
    engine's element-wise rules, the potential, Tf."""
    return device_ms(ctx, "op.apply", PRODUCTS)


def loss_kernels_device_ms(ctx):
    """The NestedLoRA loss's forward and backward passes (K1-K3 and the
    packaging's element-wise work)."""
    return device_ms(ctx, LOSS)


def tower_device_ms(ctx):
    """The method's kernels outside the loss: both towers, forward and
    backward."""
    return device_ms(ctx, "train.loss_and_grad", LOSS)


def tower_forward_device_ms(ctx):
    """The towers' forward (``model.forward``); their backward is
    ``tower_device_ms`` less this."""
    return device_ms(ctx, "model.forward")


def optimizer_device_ms(ctx):
    """Gradient norm, finite test, clip and zero mask, the optimizer and
    the parameter and state selects."""
    return device_ms(ctx, ("train.clip", "train.optimizer"))


def ema_device_ms(ctx):
    """The parameter EMA, the method state's assign and the step counter."""
    return device_ms(ctx, "train.ema")


def update_kernels_per_step(ctx):
    """Kernels a step launched inside ``train.clip``, ``train.optimizer``
    and ``train.ema``."""
    return kernels_per_step(ctx, UPDATE)


def _by_device_order(records) -> list:
    return sorted((d for d in records if is_kernel(d)), key=lambda d: d.start_us)


def replay_lineup(trace: Trace) -> Optional[dict]:
    """How a whole graph replay's kernels line up with the eager steps':
    {"share": % of the replay's kernels that, position by position in device
    order, carry the name of the eager step's kernel there, that kernel
    launched inside a program span; "parting": [position, replay kernel,
    eager kernel or None] where they first part, else None; "kernels":
    the replay's kernels}, of the eager step that lines up best.  An eager
    step runs from the start of one ``train.step`` span to the start of the
    next (to the trace's end for the last): the block's write of the step's
    metrics follows the step span and is part of the captured graph.  The
    replay is one whose records are whole (``Trace.replay_kernels``' rule).
    None without a window of replays or an eager step."""
    window = trace.window()
    whole = trace.replay_kernels(window) if window is not None else None
    steps = sorted(trace.spans(STEP), key=lambda r: r.start_us)
    if whole is None or not steps:
        return None
    launches = set(trace.graph_launches(window))
    by_replay: dict = {}
    for d in trace.device:
        if d.correlation in launches:
            by_replay.setdefault(d.correlation, []).append(d)
    full = max(len(v) for v in by_replay.values())
    replay = next(ks for ks in (_by_device_order(v) for v in by_replay.values()
                                if len(v) == full) if len(ks) == whole)
    program = _Intervals(spans_of(trace, is_program_span))
    launch = _launch_times(trace)
    best = None
    for step, nxt in zip(steps, steps[1:] + [None]):
        hi = nxt.start_us if nxt is not None else math.inf
        eager = _by_device_order(d for d in trace.device
                                 if step.start_us <= launch.get(d.correlation, -math.inf) < hi)
        matched, parting = 0, None
        for i, r in enumerate(replay):
            e = eager[i] if i < len(eager) else None
            if e is not None and e.name == r.name and launch[e.correlation] in program:
                matched += 1
            elif parting is None:
                parting = [i, r.name, None if e is None else e.name]
        result = {"share": 100.0 * matched / len(replay), "parting": parting,
                  "kernels": len(replay)}
        if best is None or result["share"] > best["share"]:
            best = result
    return best


def replay_attributed_share(ctx):
    """The share of a whole replay's kernels that line up with an eager
    step's attributed kernels, % (``replay_lineup``)."""
    found = replay_lineup(ctx.trace)
    return None if found is None else found["share"]


def _timed_spans(ctx) -> Optional[list]:
    """The program's set-up intervals [(name, start_ns, end_ns)], read in
    the process that ran the cell; None where the program keeps none or
    the trace holds no step of it."""
    if not ctx.trace.spans(STEP):
        return None
    try:
        from neuralsvd_tpu_torch.utils.tracing import timed_spans
    except ImportError:
        return None
    return timed_spans()


def _less_inside(spans, outer: str, inner: str) -> Optional[float]:
    """Seconds of the ``outer`` intervals less the ``inner`` ones inside
    them; None without an ``outer`` interval."""
    outers = [s for s in spans or () if s[0] == outer]
    if not outers:
        return None
    inners = [s for s in spans if s[0] == inner]
    total = 0
    for _, start, end in outers:
        total += end - start - sum(max(0, min(end, e) - max(start, s)) for _, s, e in inners)
    return total / 1e9


def setup_capture_s(ctx):
    """Seconds of the graph capture with its warm-up steps, less the
    kernel library's load inside it."""
    return _less_inside(_timed_spans(ctx), "setup.capture", "setup.kernels")


def setup_kernels_s(ctx):
    """Seconds of the kernel library's first load less an nvcc build inside
    it (``setup.kernels.build``): the same work whether the library was
    built in the process or found built, which ``kernels.builds`` tells."""
    return _less_inside(_timed_spans(ctx), "setup.kernels", "setup.kernels.build")
