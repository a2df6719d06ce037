"""The PyTorch port's mesh across cards: the PDE CLI's ``--mesh dp=N``,
``tp=M`` or ``dp=N,tp=M`` with its NCCL collectives captured in CUDA
graphs.

Run on a host with N cards (N >= 2), from the root of the repository:

    torchrun --standalone --nproc-per-node N scripts/torch_dp_nccl.py [--mesh SPEC] [--loss LOSS] [--out DIR]

``--mesh`` defaults to ``dp`` (dp=N).  Every rank runs
``neuralsvd_tpu_torch.cli.pde.main`` with that mesh.  ``--loss neuralsvd``
(the default) takes the E4 flags: on a mesh with dp above 1 the plain loss
(``--neuralsvd.use_pallas false``, which the dp path takes), on a tp-only
mesh the default, K1-K3 on the gathered modes; ITERS steps in graph blocks
of BLOCK.  ``--loss spin`` or ``spinx`` takes the flags of
``scripts/exps/pde/hydrogen.sh`` (L 36, finite differences) with that loss,
SPIN_ITERS steps in graph blocks of SPIN_BLOCK; each rank reports the
bytes of its method state (SpIN's ``j_avg``: its share under tp) and its
peak device memory.  One eval at the end of each run, the second block
traced by rank 0; then the same run as eager steps (the K1-K3 launches of
which the wrappers count).  Under tp each rank holds its share of the modes
and gathers them (all-gathers) before the loss; the run returns the
gathered state.  It checks that

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
import logging
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
# scripts/exps/pde/hydrogen.sh's args=( ... ) list (chip_smoke.py's
# HYDROGEN_ARGV), for --loss spin|spinx
HYDROGEN_ARGV = ("--optimizer rmsprop --use_lr_scheduler true --ema_decay 0.995 "
                 "--batch_size 512 --lr 1e-4 --momentum 0. --num_iters 500000 "
                 "--laplacian_eps 0.01 --eval_freq 10000 --overwrite true "
                 "--potential_type hydrogen --ndim 2 --lim 50 --val_eps 0.1 --neigs 36 "
                 "--apply_boundary false --apply_exp_mask false "
                 "--mlp_hidden_dims 128,128,128 --parallel true --nonlinearity softplus "
                 "--sampling_mode gaussian_mixture --sampling_scales 0.5,2,6,16,32 "
                 "--fourier_append_radial true "
                 "--fourier_append_envelopes 2.0,0.6667,0.4,0.2857,0.2222,0.1818 "
                 "--operator_scale 100 --rescue true --use_fourier_feature true "
                 "--fourier_mapping_size 1024 --fourier_scale 0.1 --neuralsvd.step 1 "
                 "--neuralsvd.sequential 0 --neuralef.unbiased true "
                 "--neuralef.include_diag false --neuralef.batchnorm_mode unbiased").split()
SPIN_ITERS, SPIN_BLOCK = 500, 125
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


class _StateBytes(logging.Handler):
    """Keeps train_operator's "method state bytes on this rank" record."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.bytes = {}

    def emit(self, record):
        if record.msg.startswith("method state bytes"):
            self.bytes = dict(record.args)


def _run(argv, log_dir, use_graph):
    cfg = parse_pde_config(argv + ["--log_dir", log_dir])
    timings = {}
    state_bytes = _StateBytes()
    port_log = logging.getLogger("neuralsvd_tpu_torch")
    port_log.addHandler(state_bytes)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            ts, eigvals, _ = pde.main(cfg, timings=timings, use_graph=use_graph)
    finally:
        port_log.removeHandler(state_bytes)
    timings["method_state_bytes"] = state_bytes.bytes
    return ts, eigvals, timings, time.perf_counter() - t0, os.path.join(log_dir, run_name(cfg))


def _per_rank(value):
    """``value`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: this rank's card")
    p.add_argument("--mesh", default="dp", help="the CLI's --mesh (default: dp, all ranks)")
    p.add_argument("--loss", default="neuralsvd", choices=("neuralsvd", "spin", "spinx"),
                   help="neuralsvd: the E4 flags; spin, spinx: hydrogen.sh's")
    p.add_argument("--out", default=None, help="where the runs' log folders go "
                                               "(default: a temporary folder)")
    args = p.parse_args()
    cpu = args.device == "cpu"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    spin = args.loss != "neuralsvd"
    iters, block = ((CPU_ITERS, CPU_BLOCK) if cpu else (SPIN_ITERS, SPIN_BLOCK) if spin
                    else (ITERS, BLOCK))
    sizes = dict(zip(*parse_mesh_spec(args.mesh, world)))
    base = (HYDROGEN_ARGV + ["--loss", args.loss] if spin
            else E4_ARGV + (PLAIN if sizes.get("dp", 1) > 1 else []))
    argv = (base + (CPU_FLAGS + (["--neigs", "4"] if spin else []) if cpu else [])
            + ["--mesh", args.mesh, "--num_iters", str(iters), "--print_freq", str(block),
               "--eval_freq", str(iters)] + (["--device", args.device] if args.device else []))
    traced = ["--profile", "true", "--profile_start", str(block),
              "--profile_steps", str(block)]
    out = {"world": world, "mesh": sizes, "loss": args.loss, "argv": argv, "iters": iters,
           "block": block}
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
            gts, geig, gtimes, gsec, gdir = _run(argv + traced, os.path.join(root, "graph"), True)
            out["method_state_bytes"] = _per_rank(gtimes["method_state_bytes"])
            out["peak_bytes"] = _per_rank(torch.cuda.max_memory_allocated())
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
