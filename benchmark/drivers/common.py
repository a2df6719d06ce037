"""What the drivers share: flags as argv, spans, seeds, profiling."""
from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

# the profiler loses kernels at the edges of a window opened or closed on a
# busy card, so a traced stretch opens and closes on an idle one
PROFILE_MARGIN_S = 0.1


def argv(flags: dict, bare_true: bool = False) -> list:
    """``{key: value}`` as command-line words.  With ``bare_true`` a True is
    a bare ``--key`` and a False is left out (argparse's store_true);
    otherwise booleans are written "true"/"false"."""
    out = []
    for key, value in flags.items():
        if isinstance(value, bool):
            if bare_true:
                out += [f"--{key}"] if value else []
                continue
            value = "true" if value else "false"
        out += [f"--{key}", str(value)]
    return out


def sub_seed(seed: int, stream: int) -> int:
    """A seed for the benchmark's own generator ``stream`` (weights, data,
    order) of a run seeded ``seed``."""
    hi, lo = np.random.SeedSequence([seed, 0xBE7C, stream]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


def spanned(fn, name: str):
    """``fn`` inside a profiler range ``name`` (a no-op without a profiler,
    and nothing at all in a CUDA-graph replay)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return run


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_weights(params: dict, weights: dict) -> None:
    """Copy the benchmark's weights into the program's parameters in place;
    the names and shapes must match."""
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for k, p in params.items():
            if tuple(p.shape) != tuple(weights[k].shape):
                raise ValueError(f"{k}: shape {tuple(p.shape)} != {tuple(weights[k].shape)}")
            p.copy_(weights[k])


@contextlib.contextmanager
def profiled(device, out: list):
    """A ``torch.profiler`` trace of the block, opened and closed on an idle
    device; its records (``benchmark.trace.from_profiler``) are appended to
    ``out`` when it ends."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import from_profiler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync(device)
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S if cuda else 0.0)
        yield
        sync(device)
        time.sleep(PROFILE_MARGIN_S if cuda else 0.0)
    out.extend(from_profiler(prof))


def find_leaf_dict(tree, names):
    """The first dict inside a nest of tuples, NamedTuples and dicts whose
    keys are ``names`` (an optimizer's per-parameter state)."""
    if isinstance(tree, dict):
        if set(tree) == set(names) and all(isinstance(v, torch.Tensor) for v in tree.values()):
            return tree
        items = tree.values()
    elif isinstance(tree, tuple):
        items = tree
    else:
        return None
    for v in items:
        found = find_leaf_dict(v, names)
        if found is not None:
            return found
    return None
