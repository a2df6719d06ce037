"""The port's own measurement: profiler spans, set-up timings and counters.

- ``span(name)``: a range in a running ``torch.profiler`` trace around the
  work it encloses.  It is recorded as a host op
  (``torch._C._profiler._RecordFunctionFast``), which the profiler does not
  mirror onto the GPU timeline as it mirrors a ``record_function``
  annotation, so a trace's device records stay the card's work alone.
  Without a running profiler it does nothing but one check, and a CUDA
  graph's replays run no Python at all, so they carry no span.
- ``spanned(name)``: a decorator, the function's calls inside ``span(name)``.
- ``timed(name)``: once-a-process set-up work (a build, a kernel library
  load, a graph capture).  Always keeps ``(name, start_ns, end_ns)`` in
  memory, on the clock the profiler stamps its host events with
  (``time.time_ns``), and opens a ``span``.  Usable as a decorator.
- ``count(name, n)``, ``counts()``, ``reset_counts()``: process counters,
  plain integers.

The spans, each at a layer boundary of the step (PERF.md §3):

- ``train.step``: one train step (PDE and CDK); inside it ``train.sample``
  (the PDE step's draw), ``train.loss_and_grad`` (``method.loss_and_grad``),
  ``train.clip`` (gradient norm, finite test, clip, zero mask),
  ``train.optimizer`` (the optimizer, the parameter and state selects, the
  skip flag or count) and ``train.ema`` (the parameter EMA, the method
  state, the step counter);
- ``train.metrics``: a block step's write of its metrics; ``train.block``:
  one ``ScannedTrainStep`` block;
- ``op.apply``: an operator call; ``fwdlap.<function>``: one
  forward-Laplacian rule application; ``model.forward``: a two-tower
  network's forward;
- ``loss.forward``, ``loss.backward``: a NestedLoRA loss Function's passes
  (for CUDA tensors the backward runs on autograd's device thread);
- ``spin.pi_channel``, ``spin.sigma_channel``, ``spin.j_avg``: SpIN's parts;
- ``timed``: ``setup.build`` (the CLIs' build), ``setup.kernels`` (the
  first kernel library load, nvcc included), ``setup.kernels.build`` (an
  nvcc run inside it), ``setup.capture`` (a graph capture with its warm-up
  steps).

Counters: ``graph.captures``, ``graph.replays`` (a block's replays at once),
``kernels.builds`` (nvcc runs), ``kernels.loads``, and the K1-K3 launches
``gram.masked_gram_pair``, ``gram.weighted_dot``, ``gram.metric_grads``
(``ops.cuda_gram.launch_counts``).
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

__all__ = ["collecting", "count", "counts", "reset_counts", "span", "spanned", "timed",
           "timed_seconds", "timed_spans"]

_NULL = contextlib.nullcontext()
_COUNTS: dict = {}
_TIMED: list = []


def collecting() -> bool:
    """Whether a profiler is collecting: the one check ``span`` makes."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler range ``name`` while a profiler is collecting, else a
    context that does nothing."""
    if collecting():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


@contextlib.contextmanager
def timed(name: str):
    """``span(name)``, and ``(name, start_ns, end_ns)`` kept in memory."""
    with span(name):
        start = time.time_ns()
        try:
            yield
        finally:
            _TIMED.append((name, start, time.time_ns()))


def timed_spans() -> list:
    """Every ``timed`` interval of the process: [(name, start_ns, end_ns)]."""
    return list(_TIMED)


def timed_seconds() -> dict:
    """{name: seconds} of the ``timed`` intervals, summed by name."""
    out: dict = {}
    for name, start, end in _TIMED:
        out[name] = out.get(name, 0.0) + (end - start) / 1e9
    return out


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> dict:
    return dict(_COUNTS)


def reset_counts(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix`` (all by default)."""
    for name in [k for k in _COUNTS if k.startswith(prefix)]:
        del _COUNTS[name]
