"""The PyTorch port's mesh across cards: the PDE CLI's ``--mesh dp=N``,
``tp=M`` or ``dp=N,tp=M`` with its NCCL collectives captured in CUDA
graphs.

Run on a host with N cards (N >= 2), from the root of the repository:

    torchrun --standalone --nproc-per-node N scripts/torch_dp_nccl.py [--mesh SPEC] [--out DIR]

``--mesh`` defaults to ``dp`` (dp=N).  Every rank runs
``neuralsvd_tpu_torch.cli.pde.main`` on the E4 flags with that mesh: on a
mesh with dp above 1 the plain loss (``--neuralsvd.use_pallas false``,
which the dp path takes), on a tp-only mesh the default, K1-K3 on the
gathered modes; ITERS steps in graph blocks of BLOCK with one eval at the
end, the second block traced by rank 0; then the same run as eager steps
(the K1-K3 launches of which the wrappers count).  Under tp each rank
holds its share of the modes and gathers them (all-gathers) before the
loss; the run returns the gathered state.  It checks that

- every rank ends the graph run with rank 0's (gathered) state, bit for
  bit;
- the graph run matches the eager run at the CLI's graph-vs-eager
  tolerance (rtol 1e-5, atol 1e-6 of each leaf's largest entry);
- rank 0's traced graph block holds NCCL kernels (at N >= 2: a
  collective replayed inside the graph).

Rank 0 prints the card's name and power limit and, as its last line, one
JSON object (``ok``, the checks, graph-block and eager steps/s, the NCCL
kernels a traced step); the exit code is 1 where a check failed.

``--device cpu`` runs the eager run alone on gloo at small widths (run it
with ``torchrun --standalone --nproc-per-node 2 scripts/torch_dp_nccl.py
--device cpu``, or with ``--mesh tp=2``): a check of the script itself,
not a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neuralsvd_tpu_torch.cli import pde  # noqa: E402
from neuralsvd_tpu_torch.ops import cuda_gram  # noqa: E402
from neuralsvd_tpu_torch.parallel.mesh import parse_mesh_spec  # noqa: E402
from neuralsvd_tpu_torch.training.train_state import state_tree  # noqa: E402
from neuralsvd_tpu_torch.utils.config import parse_pde_config, run_name  # noqa: E402

# the E4 flags (chip_smoke.py's PDE_E4_ARGV); PLAIN where dp is above 1
E4_ARGV = ("--potential_type hydrogen --ndim 2 --neigs 16 --parallel true "
           "--apply_boundary false --laplacian_eps -1 --operator_scale 100 "
           "--use_fourier_feature true --fourier_mapping_size 1024 "
           "--fourier_scale 0.1 --fourier_append_radial true "
           "--fourier_append_envelopes 2,0.6667,0.4,0.2857 "
           "--sampling_mode gaussian_mixture --sampling_scales 0.5,2,6,16 "
           "--batch_size 512 --optimizer rmsprop --lr 1e-4 --use_lr_scheduler true "
           "--ema_decay 0.995 --neuralsvd.sequential true --seed 0 "
           "--overwrite true").split()
PLAIN = ["--neuralsvd.use_pallas", "false"]
ITERS, BLOCK = 1000, 250
CPU_FLAGS = ("--fourier_mapping_size 16 --mlp_hidden_dims 16,16 --batch_size 64 "
             "--lim 4 --val_eps 0.5").split()
CPU_ITERS, CPU_BLOCK = 40, 20
RTOL, ATOL = 1e-5, 1e-6  # graph vs eager, atol of each leaf's largest entry


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix.rstrip("/"), tree


def _excess(got, want):
    """Largest |got - want| over (RTOL·|want| + ATOL·max|want|), leaf by
    leaf, and whether every leaf is equal bit for bit."""
    worst, same = 0.0, True
    want = dict(_leaves(want))
    for k, g in _leaves(got):
        w = want[k]
        same = same and torch.equal(g, w)
        if w.is_floating_point() and w.numel():
            g, w = g.double(), w.double()
            tol = RTOL * w.abs() + ATOL * w.abs().max()
            worst = max(worst, ((g - w).abs() / tol.clamp_min(1e-300)).max().item())
        elif not torch.equal(g, w):
            worst = float("inf")
    return worst, same


def _same_on_every_rank(ts, device) -> bool:
    """Whether every rank's parameters, EMA and optimizer state equal rank
    0's bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for _, t in
                      _leaves({"p": ts.params, "e": ts.ema_params, "o": ts.opt_state})
                      if t.is_floating_point()]).to(device)
    ref = flat.clone()
    dist.broadcast(ref, 0)
    differ = torch.tensor([float(not torch.equal(flat, ref))], device=device)
    dist.all_reduce(differ)
    return differ.item() == 0


def _nccl_kernels_per_step(run_dir, steps):
    """NCCL kernels a step in the trace of the run's --profile window."""
    with open(os.path.join(run_dir, "profile", "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    names = {}
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel" and "nccl" in e.get("name", "").lower():
            names[e["name"]] = names.get(e["name"], 0) + 1 / steps
    return names


def _run(argv, log_dir, use_graph):
    cfg = parse_pde_config(argv + ["--log_dir", log_dir])
    timings = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ts, eigvals, _ = pde.main(cfg, timings=timings, use_graph=use_graph)
    return ts, eigvals, timings, time.perf_counter() - t0, os.path.join(log_dir, run_name(cfg))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: this rank's card")
    p.add_argument("--mesh", default="dp", help="the CLI's --mesh (default: dp, all ranks)")
    p.add_argument("--out", default=None, help="where the runs' log folders go "
                                               "(default: a temporary folder)")
    args = p.parse_args()
    cpu = args.device == "cpu"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    iters, block = (CPU_ITERS, CPU_BLOCK) if cpu else (ITERS, BLOCK)
    sizes = dict(zip(*parse_mesh_spec(args.mesh, world)))
    argv = (E4_ARGV + (PLAIN if sizes.get("dp", 1) > 1 else []) + (CPU_FLAGS if cpu else [])
            + ["--mesh", args.mesh, "--num_iters", str(iters), "--print_freq", str(block),
               "--eval_freq", str(iters)] + (["--device", args.device] if args.device else []))
    traced = ["--profile", "true", "--profile_start", str(block),
              "--profile_steps", str(block)]
    out = {"world": world, "mesh": sizes, "argv": argv, "iters": iters, "block": block}
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        if not cpu:
            gts, geig, gtimes, gsec, gdir = _run(argv + traced, os.path.join(root, "graph"), True)
        cuda_gram.reset_launch_counts()
        ets, eeig, etimes, esec, _ = _run(argv, os.path.join(root, "eager"), False)
        device = ets.step.device
        out["eager_launches"] = cuda_gram.launch_counts()
        checks = {"eager_ranks_equal": _same_on_every_rank(ets, device)}
        out["eager"] = {"run_s": esec, "eigvals": [float(v) for v in eeig[-1]],
                        "steps_per_s": [n / s for n, s in etimes.get("block_eager", [])]}
        if not cpu:
            checks["graph_ranks_equal"] = _same_on_every_rank(gts, device)
            excess, bitwise = _excess(state_tree(gts), state_tree(ets))
            checks["graph_vs_eager"] = excess <= 1.0
            out["graph"] = {"run_s": gsec, "eigvals": [float(v) for v in geig[-1]],
                            "steps_per_s": [n / s for n, s in gtimes["block_graph"][1:]],
                            "vs_eager": {"tol_used": excess, "bit_for_bit": bitwise}}
            if dist.get_rank() == 0:
                nccl = _nccl_kernels_per_step(gdir, block)
                out["graph"]["nccl_kernels_per_traced_step"] = nccl
                checks["nccl_in_graph"] = world < 2 or sum(nccl.values()) > 0
        out["checks"] = checks
    ok = all(checks.values())
    flag = torch.tensor([float(not ok)], device=device)
    dist.all_reduce(flag)
    out["ok"] = ok = flag.item() == 0
    if dist.get_rank() == 0:
        if not cpu:
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip().splitlines()[0], flush=True)
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
