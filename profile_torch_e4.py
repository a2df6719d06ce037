"""Time and profile the port's E4 train step on one GPU.

    python3 profile_torch_e4.py [--steps 100] [--profile-steps 10] [--out FILE]

Builds the E4 configuration exactly as chip_smoke.py does (full width) and

1. times the train step with the loss on the plain path and on the
   hand-written kernels, in turns (plain, kernels, kernels, plain), each
   over --steps steps after a warm-up, on one card in one process;
2. records --profile-steps kernel-path steps under torch.profiler and
   reports the device's busy share (kernel time over wall time), device
   time and launches per step, K1-K3's device time per call, and the
   kernels that take the most device time.

Prints one JSON line; --out also writes the profiler's table.  Needs a GPU.
"""
import argparse
import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as e4
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.training.optimizers import torch_rmsprop
from neuralsvd_tpu_torch.training.train_operator import make_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state

OUR_KERNELS = ("masked_gram_partial_kernel", "masked_gram_finish_kernel",
               "weighted_dot_partial_kernel", "sum_partials_kernel",
               "metric_grads_kernel")


def build(use_pallas):
    model, operator, _, sampler, importance = e4._e4_setup("cuda")
    method = NestedLoRA(model, neigs=e4.NEIGS, sequential=True,
                        use_pallas=use_pallas)
    optimizer = torch_rmsprop(e4.LR, alpha=e4.ALPHA)
    ts = init_train_state(model, optimizer, method)
    step = make_train_step(method, operator, optimizer, sampler,
                           importance=importance, ema_decay=e4.EMA_DECAY)
    return ts, step, torch.Generator(device="cuda").manual_seed(e4.SEED)


def steps_per_s(ts, step, gen, n, warmup=10):
    for _ in range(warmup):
        ts, _ = step(ts, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        ts, metrics = step(ts, gen)
    torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    if not torch.isfinite(metrics["loss"]):
        raise RuntimeError("non-finite loss")
    return ts, rate


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    raise RuntimeError("profiler event without device time")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--profile-steps", type=int, default=10)
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

    runs = {"plain": build(False), "kernels": build("auto")}
    rates = {"plain": [], "kernels": []}
    for name in ("plain", "kernels", "kernels", "plain"):
        ts, step, gen = runs[name]
        ts, rate = steps_per_s(ts, step, gen, args.steps)
        runs[name] = (ts, step, gen)
        rates[name].append(rate)

    ts, step, gen = runs["kernels"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            ts, _ = step(ts, gen)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no CUDA kernel")
    device_us = sum(_device_us(e) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    per = args.profile_steps
    ours = {}
    for short in OUR_KERNELS:
        hits = [e for e in kernels if short in e.key]
        count = sum(e.count for e in hits)
        ours[short] = {"calls_per_step": count / per,
                       "device_us_per_call": (sum(_device_us(e) for e in hits) / count
                                              if count else None)}
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    row = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "steps": args.steps, "steps_per_s": rates,
        "steps_per_s_median": {k: statistics.median(v) for k, v in rates.items()},
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
    print(json.dumps(row), flush=True)
    if args.out:
        sort_by = ("self_device_time_total"
                   if hasattr(kernels[0], "self_device_time_total")
                   else "self_cuda_time_total")
        with open(args.out, "w") as fh:
            fh.write(smi + "\n")
            fh.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))


if __name__ == "__main__":
    main()
