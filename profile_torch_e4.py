"""Time and profile the port on one GPU: a train step, or the gram kernels.

    python3 profile_torch_e4.py [--path e4|cdk] [--steps N] [--profile-steps 10] [--out FILE]
    python3 profile_torch_e4.py --path kernels [--out FILE]
    python3 profile_torch_e4.py --path window [--windows 20] [--profile-steps 10]

``--path e4`` builds the E4 configuration and ``--path cdk`` the CDK
two-tower configuration (Sketchy paper width, synthetic features), each
exactly as chip_smoke.py does (full width), and

1. times two variants of the train step in turns (A, B, B, A), each over
   --steps steps after a warm-up, on one card in one process: for E4 the
   per-step loop ("eager": the step's kernels launched from Python one
   step at a time) and the driver's block, one step captured in a CUDA
   graph and replayed ("graph"), both in blocks of E4_BLOCK steps that
   read nothing on the host, with the forward-Laplacian engine and the
   loss on the hand-written kernels; for CDK the loss on the plain path
   and on the kernels;
2. records --profile-steps steps of each variant under torch.profiler and
   reports the device's busy share (kernel time over wall time), device
   time and launches per step, K1-K3's device time per call, and the
   kernels that take the most device time.

``--path kernels`` calls K1-K3 at the E4, edge and CDK shapes of
chip_smoke.py (half-batches 256 x 16, 1000 x 129 and the CDK pair f, g of
4096 x 513) and at the CDK pair one column narrower (4096 x 512, whose
rows take 16-byte copies where 513's take 4-byte ones), checks each
against its plain version, and reports the device time of every CUDA
kernel each wrapper launches (K1 launches two or three passes, K2 one or
two), per call, over KERNEL_CALLS calls under torch.profiler.

``--path window`` checks that a profiler window keeps every kernel of the
replayed E4 steps it spans: --windows pairs of windows in turns, one
opened and closed right at the work, one with PROFILE_MARGIN_S of idle
device inside each edge (as the driver's --profile window and
chip_smoke.py open theirs), and the kernels and K1-K3 launches each kept,
in the profiler's key averages and in its exported trace.

Prints one JSON line; --out also writes the profiler's table.  Needs a GPU.
"""
import argparse
import collections
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from neuralsvd_tpu_torch.cli.sketchy import make_trainer
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.training.optimizers import torch_rmsprop
from neuralsvd_tpu_torch.training.train_operator import PROFILE_MARGIN_S, make_scanned_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state

OUR_KERNELS = smoke.CUDA_KERNELS
WARMUP = 10
# (label, full batch, L): chip_smoke's E4, edge and CDK shapes, and the CDK
# shape one column narrower
KERNEL_SHAPES = [s for s in smoke.KERNEL_SHAPES if s[0] in ("E4", "edge", "cdk")]
KERNEL_SHAPES.append(("cdk512", 2 * smoke.CDK_B, smoke.CDK_L))
KERNEL_CALLS = 20


E4_BLOCK = 10  # steps a block; --steps, WARMUP and --profile-steps are multiples


def e4_runner(use_graph):
    """advance(n): n E4 train steps in blocks of E4_BLOCK, as CUDA graph
    replays or eager steps; returns the last loss."""
    model, operator, _, sampler, importance = smoke._e4_setup("cuda")
    method = NestedLoRA(model, neigs=smoke.NEIGS, sequential=True)
    optimizer = torch_rmsprop(smoke.LR, alpha=smoke.ALPHA)
    block = make_scanned_train_step(method, operator, optimizer, sampler,
                                    importance=importance, ema_decay=smoke.EMA_DECAY,
                                    steps_per_call=E4_BLOCK, seed=smoke.SEED,
                                    use_graph=use_graph)
    state = {"ts": init_train_state(model, optimizer, method), "it": 0}

    def advance(n):
        if n % E4_BLOCK:
            raise ValueError(f"{n} steps: not whole blocks of {E4_BLOCK}")
        for _ in range(n // E4_BLOCK):
            state["ts"], metrics = block(state["ts"], state["it"])
            state["it"] += E4_BLOCK
        return metrics["loss"][-1]

    return advance


def cdk_runner(use_pallas, batches):
    """advance(n): n CDK train steps cycling over device batches."""
    args = smoke._cdk_args("")
    args.use_pallas = use_pallas
    tr = make_trainer(args, smoke.CDK_DIM, smoke.CDK_STEPS)
    state = {"params": tr.params, "opt": tr.opt_state, "i": 0,
             "skips": torch.zeros((), dtype=torch.int32, device="cuda")}

    def advance(n):
        for _ in range(n):
            x, y = batches[state["i"] % len(batches)]
            state["i"] += 1
            state["params"], state["opt"], _, loss, _, state["skips"] = tr.step(
                state["params"], state["opt"], {}, x, y, state["skips"])
        return loss

    return advance


def steps_per_s(advance, n):
    advance(WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = advance(n)
    torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    if not torch.isfinite(loss):
        raise RuntimeError("non-finite loss")
    return rate


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    raise RuntimeError("profiler event without device time")


def _cuda_events(prof):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no CUDA kernel")
    return kernels


def _write_table(path, smi, prof, kernels):
    sort_by = ("self_device_time_total"
               if hasattr(kernels[0], "self_device_time_total")
               else "self_cuda_time_total")
    with open(path, "w") as fh:
        fh.write(smi + "\n")
        fh.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))


def _profile(advance, steps, margin_s=PROFILE_MARGIN_S):
    """torch.profiler over ``steps`` steps, the window opening and closing
    on a device idle for ``margin_s``: (profile, wall seconds)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        t0 = time.perf_counter()
        advance(steps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        time.sleep(margin_s)
    return prof, wall_s


def _step_profile(prof, wall_s, per):
    kernels = _cuda_events(prof)
    device_us = sum(_device_us(e) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    ours = {}
    for short in OUR_KERNELS:
        hits = [e for e in kernels if short in e.key]
        count = sum(e.count for e in hits)
        ours[short] = {"calls_per_step": count / per,
                       "device_us_per_call": (sum(_device_us(e) for e in hits) / count
                                              if count else None)}
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    return {
        "profiled_steps": per,
        "profiled_wall_ms_per_step": wall_s / per * 1e3,
        "device_ms_per_step": device_us / per / 1e3,
        "device_busy_share": device_us / 1e6 / wall_s,
        "kernel_launches_per_step": n_launch / per,
        "gram_kernels": ours,
        "top_kernels": [{"name": e.key[:80], "calls_per_step": e.count / per,
                         "device_ms_per_step": _device_us(e) / per / 1e3}
                        for e in top],
    }


def profile_train(args, smi):
    if args.path == "e4":
        order = ("eager", "graph")
        runs = {name: e4_runner(name == "graph") for name in order}
    else:
        order = ("plain", "kernels")
        train, _, _ = smoke._cdk_data()
        batches = [tuple(torch.as_tensor(a, device="cuda") for a in b[:2])
                   for _, b in zip(range(4), train)]
        runs = {"plain": cdk_runner("false", batches),
                "kernels": cdk_runner("auto", batches)}
    rates = {name: [] for name in order}
    for name in (order[0], order[1], order[1], order[0]):
        rates[name].append(steps_per_s(runs[name], args.steps))
    profiles = {}
    for name in order:
        prof, wall_s = _profile(runs[name], args.profile_steps)
        profiles[name] = _step_profile(prof, wall_s, args.profile_steps)
        if args.out:
            _write_table(f"{args.out}.{name}", smi, prof, _cuda_events(prof))
    row = {
        "path": args.path, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "steps": args.steps, "order": [order[0], order[1], order[1], order[0]],
        "steps_per_s": rates,
        "steps_per_s_median": {k: statistics.median(v) for k, v in rates.items()},
        "profiles": profiles,
    }
    print(json.dumps(row), flush=True)


def _short_replays(events):
    """The graph replays of a trace that hold fewer kernels than the most
    common replay: [replay index of the window, replays, kernels missing,
    the first few missing names].  A kernel belongs to the replay whose
    cudaGraphLaunch has its correlation id."""
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("name") == "cudaGraphLaunch" and "correlation" in e.get("args", {}))
    replay = {c: i for i, (_, c) in enumerate(launches)}
    steps = [collections.Counter() for _ in launches]
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel":
            i = replay.get(e.get("args", {}).get("correlation"))
            if i is not None:
                steps[i][e["name"][:60]] += 1
    if not steps:
        return []
    full = max(steps, key=lambda c: sum(c.values()))
    return [[i, len(steps), sum((full - c).values()), sorted(full - c)[:4]]
            for i, c in enumerate(steps) if c != full]


def profile_window(args, smi):
    """The kernels that a profiler window keeps, over --windows pairs of
    windows of --profile-steps replayed E4 steps, in turns: one opened and
    closed right at the work (after a device sync), one with
    PROFILE_MARGIN_S of idle device inside each edge."""
    advance = e4_runner(True)
    advance(WARMUP)
    kept = {"no_margin": [], "margin": []}
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        for _ in range(args.windows):
            for name, margin_s in (("no_margin", 0.0), ("margin", PROFILE_MARGIN_S)):
                prof, _ = _profile(advance, args.profile_steps, margin_s)
                kernels = _cuda_events(prof)
                row = {"kernels": sum(e.count for e in kernels)}
                for k in smoke.GRAM_KERNELS.values():
                    row[k] = sum(e.count for e in kernels if k in e.key)
                # the exported trace, as the driver's --profile window writes it
                prof.export_chrome_trace(trace)
                with open(trace) as fh:
                    events = json.load(fh)["traceEvents"]
                names = [e.get("name", "") for e in events
                         if str(e.get("cat", "")).lower() == "kernel"]
                row["trace_kernels"] = len(names)
                for k in smoke.GRAM_KERNELS.values():
                    row[f"trace_{k}"] = sum(k in n for n in names)
                row["short_replays"] = _short_replays(events)
                kept[name].append(row)
    steps = args.profile_steps
    counts = list(smoke.GRAM_KERNELS.values())
    counts += [f"trace_{g}" for g in counts]
    print(json.dumps({
        "path": "window", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "steps": steps, "margin_s": PROFILE_MARGIN_S,
        "kernels_range": {k: {c: [min(r[c] for r in v), max(r[c] for r in v)]
                              for c in ("kernels", "trace_kernels")}
                          for k, v in kept.items()},
        "windows_short_of_a_gram_kernel": {
            k: sum(any(r[g] != steps for g in counts) for r in v)
            for k, v in kept.items()},
        "windows": kept}), flush=True)


def profile_kernels(args, smi):
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    shapes = {}
    for label, B, L in KERNEL_SHAPES:
        f, Tf, f1, f2, vmask, mmask = smoke._kernel_inputs(label, B, L, gen)
        # K2's operands: (f, Tf) on the EVD path, the pair (f, g) on the CDK path
        dot_a, dot_b = (f1, f2) if label == "cdk" else (f, Tf)
        s = 2.0 / f1.shape[0]
        _, _, _, mlam1, mlam2 = cuda_gram.masked_gram_pair_ref(f1, f2, mmask)
        wrappers = {
            "masked_gram_pair": (lambda: cuda_gram.masked_gram_pair(f1, f2, mmask),
                                 lambda: cuda_gram.masked_gram_pair_ref(f1, f2, mmask)),
            "weighted_dot": (lambda: cuda_gram.weighted_dot(dot_a, dot_b, vmask),
                             lambda: cuda_gram.weighted_dot_ref(dot_a, dot_b, vmask)),
            "metric_grads": (lambda: cuda_gram.metric_grads(f1, f2, mlam1, mlam2, s, s),
                             lambda: cuda_gram.metric_grads_ref(f1, f2, mlam1, mlam2, s, s)),
        }
        rows = {}
        for name, (run, plain) in wrappers.items():
            got, want = run(), plain()
            got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
            rel = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, want))
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                for _ in range(KERNEL_CALLS):
                    run()
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
            kernels = _cuda_events(prof)
            rows[name] = {
                "rel_err_of_max": rel,
                "device_us_per_call": sum(_device_us(e) for e in kernels) / KERNEL_CALLS,
                "kernels": [{"name": e.key[:120], "launches_per_call": e.count / KERNEL_CALLS,
                             "device_us_per_launch": _device_us(e) / e.count}
                            for e in kernels]}
            if args.out:
                _write_table(f"{args.out}.{label}.{name}", smi, prof, kernels)
        shapes[label] = {"B": f1.shape[0], "L": L, "wrappers": rows}
    print(json.dumps({"path": "kernels", "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "calls": KERNEL_CALLS, "shapes": shapes}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("e4", "cdk", "kernels", "window"), default="e4")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--profile-steps", type=int, default=10)
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.path == "kernels":
        profile_kernels(args, smi)
    elif args.path == "window":
        profile_window(args, smi)
    else:
        profile_train(args, smi)


if __name__ == "__main__":
    main()
