"""The harness: finds a cell's files by name, runs it, reads its metrics and
decides whether what the timed path produced is correct.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``BENCHMARK.json``'s configuration entry names the configuration's file
  (``configs/<name>.json``: its flags, the driver that builds and steps the
  system, its plain reference, its counting module under ``flops/``, the
  precision of its peak, its control);
- ``traffic/<traffic>.json``: how the cell drives the system (flags of the
  path it takes);
- ``workloads/<cell>.json``: the cell's block and traced sizes and the
  limits of its correctness check;
- ``metrics/<metric>.py``: a reader ``read(ctx) -> float | None`` of one
  per-layer metric;
- ``kernels/<group>/*.json``: the names of the kernels that do one kind of
  work, whatever file added them;
- ``peaks.json``: the published peaks of each card, by its name.

A driver (``drivers/<driver>.py``) is shared by every configuration of one
kind of system.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "neuralsvd_tpu")
# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under an adaptive optimizer: left out of "change"
MOVED_SHARE = 1e-3


class NoDevice(RuntimeError):
    """The card the cell asks for is not there."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, checkout: Path = CHECKOUT) -> dict:
    """The cell ``name`` with its configuration, traffic and workload files
    and the metrics that apply to it."""
    bench = checkout / BENCH_DIR.name
    spec = load_json(checkout / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {"name": name, "entry": entry, "chips": int(entry["chips"]),
            "config": load_json(checkout / configs[entry["config"]]["file"]),
            "traffic": load_json(bench / "traffic" / f"{entry['traffic']}.json"),
            "workload": load_json(bench / "workloads" / f"{name}.json"),
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)],
            "checkout": checkout}


def metric_reader(checkout: Path, name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = checkout / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_names(checkout: Path, group: str) -> list:
    """Every kernel name listed under ``kernels/<group>/``."""
    names = []
    for path in sorted((checkout / BENCH_DIR.name / "kernels" / group).glob("*.json")):
        names += load_json(path)["kernels"]
    return names


def peaks_of(checkout: Path, kind: str) -> Optional[dict]:
    return load_json(checkout / BENCH_DIR.name / "peaks.json")["cards"].get(kind)


class Context:
    """What a metric reader may read."""

    def __init__(self, cell, trace, traced_steps, window, peak, precision):
        from benchmark.trace import Trace

        config = cell["config"]
        flags = {**config["flags"], **cell["traffic"].get("flags", {})}
        counts = importlib.import_module(f"benchmark.flops.{config['flops']}")
        self.cell = cell
        self.trace = Trace(trace or [])
        self.traced_steps = traced_steps
        self.window = window
        self.peak = peak
        self.peak_flops = peak.get(precision) if peak else None
        self.step_flops = counts.step_flops(flags)
        self.gram_work = counts.gram_work(flags)

    def kernel_names(self, group: str) -> list:
        return kernel_names(self.cell["checkout"], group)


def require_devices(chips: int) -> str:
    """The card's name; raises NoDevice without ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch sees no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
    return torch.cuda.get_device_name(0)


def card_state() -> str:
    """What nvidia-smi says of the card: name, power limit and draw, SM
    clock, temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _median(values) -> float:
    return statistics.median(values) if values else 0.0


def _gap(prog: float, ref: float, scale: float) -> float:
    """|prog - ref| / scale; a non-finite reading is the largest float (the
    result line stays JSON)."""
    gap = abs(prog - ref) / scale if scale > 0 else (0.0 if prog == ref else math.inf)
    return gap if math.isfinite(gap) else sys.float_info.max


def training_gaps(prog: dict, ref: dict, initial: dict) -> dict:
    """The numbers compared for a training cell, each by its worst case:

    - ``loss_gap``: each check step's |loss - reference| over the
      reference loss's scale, |operator term| + |metric term|: the two
      terms have opposite signs and their sum can come near 0;
    - ``grad_gap``: each leaf's gap between the norms of the first
      gradient, | ‖g‖ - ‖g_ref‖ | / max(‖g_ref‖, the median leaf's);
    - ``change_gap``: the same of the change from the initial weights after
      the check steps, of the parameters and (where kept) of their EMA,
      over the leaves whose reference gradient is at least MOVED_SHARE of
      the median leaf's."""
    import torch

    losses = [_gap(p, r, scale) for p, r, scale in
              zip(prog["losses"], ref["losses"], ref["loss_scales"])]
    g_ref, g_prog = ref["first_grads"], prog["first_grads"]
    med_g = _median(list(g_ref.values()))
    grads = [_gap(g_prog[k], g_ref[k], max(g_ref[k], med_g)) for k in g_ref]
    moved = [k for k in g_ref if g_ref[k] >= MOVED_SHARE * med_g]
    changes = []
    for group in ("params", "ema"):
        if group not in ref:
            continue
        d_ref = {k: float(torch.linalg.vector_norm(ref[group][k] - initial[k])) for k in moved}
        d_prog = {k: float(torch.linalg.vector_norm(prog[group][k].to(initial[k].device)
                                                    - initial[k])) for k in moved}
        med = _median(list(d_ref.values()))
        changes += [_gap(d_prog[k], d_ref[k], max(d_ref[k], med)) for k in moved]
    return {"loss_gap": max(losses), "grad_gap": max(grads),
            "change_gap": max(changes) if changes else sys.float_info.max}


def _limit_lines(checks: dict) -> list:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            + ("" if c["value"] <= c["limit"] else "  FAILED") for name, c in checks.items()]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", control: bool = False, checkout: Path = CHECKOUT,
             log=print) -> dict:
    """Run one cell and return its result (the last line's object).  Earlier
    lines go to ``log``.  Raises NoDevice where the card is missing (a
    ``device`` "cpu" run skips the look: the tests' rehearsal)."""
    import torch

    cell = load_cell(name, checkout)
    if device == "cuda":
        kind = require_devices(cell["chips"])
        log(json.dumps({"device": kind, "nvidia_smi": card_state(), "torch": torch.__version__,
                        "cuda": torch.version.cuda}))
        torch.cuda.reset_peak_memory_stats()
    else:
        kind = "cpu"
    driver_cls = importlib.import_module(f"benchmark.drivers.{cell['config']['driver']}").Driver
    driver = driver_cls(cell, seed, device, control=control)
    driver.setup()
    setup_s = time.perf_counter() - t_start

    steps = skipped = 0
    t0 = time.perf_counter()
    while True:
        b0 = time.perf_counter()
        n, s = driver.block()
        steps, skipped = steps + n, skipped + s
        now = time.perf_counter()
        log(json.dumps({"block_steps": n, "steps_per_s": n / (now - b0), "skipped": s}))
        if now - t0 >= seconds:
            break
    window = {"steps": steps, "seconds": time.perf_counter() - t0}
    rows_per_s = steps * driver.batch / window["seconds"]
    log(json.dumps({"window_steps": steps, "window_s": window["seconds"],
                    "steps_per_s": steps / window["seconds"]}))

    result_device = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                     "count": cell["chips"]}
    breakdown = None
    if trace:
        records, traced_steps = driver.traced()
        peak = peaks_of(checkout, kind)
        if peak:
            log(json.dumps({"peak_source": peak["source"], "nvidia_smi": card_state()}))
        ctx = Context(cell, records, traced_steps, window, peak, cell["config"]["precision"])
        metrics = {}
        for m in cell["per_layer"]:
            value = metric_reader(checkout, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        span = ctx.trace.window()
        if span is not None and ctx.trace.device:
            result_device["busy_s"] = ctx.trace.busy_us(span) / 1e6
            result_device["window_s"] = span.dur_us / 1e6
            breakdown = {"device_ops": ctx.trace.device_ops(span),
                         "idle_gaps": ctx.trace.idle_gaps(span)}
    else:  # every end-to-end metric but the set-up is the window's rows a second
        metrics = {m["name"]: {"value": setup_s if m["name"] == "setup_s" else rows_per_s,
                               "unit": m["unit"]} for m in cell["end_to_end"]}
    if device == "cuda":
        torch.cuda.synchronize()
        result_device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()

    prog = driver.program_readings()
    driver.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference_readings()
    gaps = training_gaps(prog, ref, driver.initial_weights())
    limits = cell["workload"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": steps, "failed": skipped, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                          log=lambda s: print(s, flush=True))
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {found}", file=sys.stderr)
        return 3
    for line in _limit_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
