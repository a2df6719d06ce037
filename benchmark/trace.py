"""Reading a profiler trace: records, spans, replays, busy time.

A trace is a list of ``Record``s in one time base (microseconds):

- "device": an operation that ran on the card (a kernel, a copy, a memset),
  with the correlation id of the host call that launched it;
- "runtime": a CUDA runtime call on the host (``cudaLaunchKernel``,
  ``cudaGraphLaunch``, ...), with its correlation id;
- "host": any other host range, the benchmark's own spans
  (``benchmark.window``, ``benchmark.step``, ``benchmark.method``,
  ``benchmark.operator``) among them.

A device record belongs to a span when the runtime call that launched it
started inside the span: CUPTI gives the call and its kernels one
correlation id.  Inside a span, every thread's calls count (the backward
pass launches from autograd's own thread while the span's thread waits).
The kernels of a CUDA-graph replay all carry the correlation id of its
``cudaGraphLaunch``.

The tracer loses records inside graph replays (on an H100, up to ~60 in a
window, all of one replay).  So launches are counted replay by replay: a
replay that lost records holds fewer than the largest, and only the
replays whose records are whole are read (``replay_kernels``).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Iterable, List, Optional

SPAN_PREFIX = "benchmark."
WINDOW = "benchmark.window"
STEP = "benchmark.step"
WHOLE_REPLAY_SHARE = 0.9  # the least share of a window's replays read whole
TOP = 10  # entries of each list of the breakdown


@dataclass(frozen=True)
class Record:
    kind: str  # "device", "runtime" or "host"
    name: str
    start_us: float
    dur_us: float
    correlation: int = 0

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


def is_kernel(rec: Record) -> bool:
    """A device record that is a kernel (not a copy or a memset)."""
    return rec.kind == "device" and not rec.name.startswith(("Memcpy", "Memset", "memcpy",
                                                              "memset"))


def from_profiler(prof) -> List[Record]:
    """The records of a finished ``torch.profiler.profile``, read from its
    own event list (a chrome trace or ``key_averages`` of a long window
    costs tens of seconds more)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.name().startswith(SPAN_PREFIX):  # a span's mirror on the GPU timeline
                out.append(Record("device", e.name(), start, dur, e.correlation_id()))
        elif e.name().startswith(("cuda", "cu")) and e.correlation_id():
            out.append(Record("runtime", e.name(), start, dur, e.correlation_id()))
        else:
            out.append(Record("host", e.name(), start, dur, e.correlation_id()))
    return out


def union_us(intervals: Iterable[tuple], lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]:
    overlapping kernels are counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Trace:
    def __init__(self, records: Iterable[Record]):
        records = list(records)
        self.device = [r for r in records if r.kind == "device"]
        self.runtime = [r for r in records if r.kind == "runtime"]
        self.host = [r for r in records if r.kind == "host"]

    def spans(self, name: str, within: Optional[Record] = None) -> List[Record]:
        """The host spans called ``name`` (inside ``within`` if given)."""
        return [r for r in self.host if r.name == name
                and (within is None or (r.start_us >= within.start_us
                                        and r.end_us <= within.end_us))]

    def window(self) -> Optional[Record]:
        """The traced window: the first ``benchmark.window`` span."""
        found = self.spans(WINDOW)
        return found[0] if found else None

    def launched_in(self, spans: List[Record]) -> List[Record]:
        """Device records launched by a runtime call that started inside
        one of ``spans``."""
        ids = {r.correlation for r in self.runtime
               if any(s.start_us <= r.start_us <= s.end_us for s in spans)}
        return [d for d in self.device if d.correlation in ids]

    def ran_in(self, span: Record) -> List[Record]:
        """Device records that ran wholly inside ``span``."""
        return [d for d in self.device if d.start_us >= span.start_us and d.end_us <= span.end_us]

    def busy_us(self, span: Record) -> float:
        """Microseconds of ``span`` in which some device operation ran."""
        return union_us(((d.start_us, d.end_us) for d in self.device), span.start_us, span.end_us)

    def graph_launches(self, span: Record) -> List[int]:
        """Correlation ids of the ``cudaGraphLaunch`` calls inside ``span``."""
        return [r.correlation for r in self.runtime
                if r.name.startswith("cudaGraphLaunch")
                and span.start_us <= r.start_us <= span.end_us]

    def replay_kernels(self, span: Record) -> Optional[float]:
        """Kernels a replay over the graph replays inside ``span``, from
        the replays whose records are whole; None where there are none, or
        where fewer than WHOLE_REPLAY_SHARE of them are whole."""
        launches = self.graph_launches(span)
        if not launches:
            return None
        records = {c: 0 for c in launches}
        kernels = {c: 0 for c in launches}
        for d in self.device:
            if d.correlation in records:
                records[d.correlation] += 1
                kernels[d.correlation] += is_kernel(d)
        full = max(records.values())
        whole = [c for c in launches if records[c] == full]
        if full == 0 or len(whole) < WHOLE_REPLAY_SHARE * len(launches):
            return None
        return float(Counter(kernels[c] for c in whole).most_common(1)[0][0])

    def device_ops(self, span: Record) -> list:
        """[[name, seconds]] of the device operations that took most time
        inside ``span``, by name."""
        by_name: dict = {}
        for d in self.ran_in(span):
            by_name[d.name] = by_name.get(d.name, 0.0) + d.dur_us
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
        return [[name[:160], us / 1e6] for name, us in top]

    def idle_gaps(self, span: Record) -> list:
        """[[host activity, seconds]] of the longest stretches of ``span``
        in which nothing ran on the device, each named by the innermost
        host call or range open at the gap's middle ("host idle" if none)."""
        busy = sorted((max(d.start_us, span.start_us), min(d.end_us, span.end_us))
                      for d in self.device if d.end_us > span.start_us
                      and d.start_us < span.end_us)
        gaps, edge = [], span.start_us
        for s, e in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if span.end_us > edge:
            gaps.append((edge, span.end_us))
        gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:TOP]
        out = []
        for s, e in gaps:
            mid = (s + e) / 2
            open_ = [r for r in self.runtime + self.host
                     if r.start_us <= mid <= r.end_us and r is not span and r.name != WINDOW]
            name = max(open_, key=lambda r: r.start_us).name if open_ else "host idle"
            out.append([name[:160], (e - s) / 1e6])
        return out
