"""The CLIs' ``--mesh dp=2`` on 2-rank gloo groups (the ranks run in
spawned processes, tests/torch_dp_workers.py, each spawn bounded by its
own timeout): the Sketchy CLI against a single process at the tolerance
of tests/test_cli_mesh.py::test_cli_sketchy_dp_mesh_matches_single_device
(rtol 2e-4, atol 2e-5), and the PDE CLI's ranks in lockstep, bit for bit,
through evals, the mode rescue and ``--resume``, with the artifacts
written once (by rank 0).
"""
import csv
import os
import re

import numpy as np

import torch_dp_workers as workers
from neuralsvd_tpu_torch.cli.sketchy import get_args, run_training
from neuralsvd_tpu_torch.utils.config import PDEConfig, run_name


def _outs(d, world=2):
    return [dict(np.load(f"{d}/out.{r}.npz")) for r in range(world)]


def _csvs(run_dir):
    return sorted(f for f in os.listdir(run_dir) if f.endswith(".csv"))


def test_sketchy_cli_dp_matches_a_single_process(tmp_path):
    """``run_training --mesh dp=2 --grad_clip 0.5`` on the synthetic
    loaders: every rank keeps its half of each batch's pairs, so the run
    sees the single process's batches; both ranks end on the single
    process's parameters, equal to each other bit for bit, and rank 0
    alone wrote the log and checkpoints."""
    train, test, valid = workers.synth_loaders(np.random.default_rng(0))
    args = get_args(["--log_dir", str(tmp_path / "single")] + workers.SKETCHY_ARGV)
    single, _ = run_training(args, train, test, valid, input_dim=16)
    d = workers.run_ranks(workers.sketchy_rank, tmp_path, str(tmp_path / "dp"))
    outs = _outs(d)
    for k, p in single.items():
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
        np.testing.assert_allclose(outs[0][k], p.detach().numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    logs = _csvs(tmp_path / "dp")
    assert len(logs) == 1
    with open(tmp_path / "dp" / logs[0]) as f:
        assert [int(r["epoch"]) for r in csv.DictReader(f)] == [0, 1]
    assert {"ckpt", "best", "best_stats.npz", "ratios_e1.npz"} <= set(os.listdir(tmp_path / "dp"))


def test_pde_cli_dp_ranks_stay_in_lockstep(tmp_path):
    """``--mesh dp=2`` eager with evals every 20 steps and ``--rescue``: a
    straight run to 40, its ``--resume`` from ckpt_20 to 40 (which lands on
    the straight run's parameters), and a ``--resume`` to 80 from ckpt_40
    with a mode copied onto another, whose eval at 60 diagnoses and rescues
    it.  After each run the two ranks' parameters are equal bit for bit;
    rank 0 alone wrote each run's CSV log, checkpoints and stats."""
    d = workers.run_ranks(workers.pde_rank, tmp_path, str(tmp_path / "log"))
    r0, r1 = _outs(d)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for k in r0:  # the resumed run evaluates at 40 only: its last eval
        if k.startswith("straight/"):
            got, want = r0["resumed/" + k[9:]], r0[k]
            if k.endswith("eigvals"):
                got, want = got[-1], want[-1]
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6, err_msg=k)
    log = open(os.path.join(d, "log.0")).read()
    assert "resuming from" in log and "DUPLICATE" in log
    assert re.search(r"it60 rescue: exiled \+ re-initialized [1-9]", log)
    src, dst = workers.DUP
    w = r0["rescued/param/base.ws.1"]
    assert not np.array_equal(w[src], w[dst])
    cfg = dict(workers.PDE_TINY, log_dir=str(tmp_path / "log"), device="cpu", mesh="dp=2")
    runs = {40: (2, {"ckpt_20", "stats.npz"}), 80: (1, {"ckpt_60", "ckpt_80", "stats.npz"})}
    for num_iters, (n_logs, files) in runs.items():
        run_dir = tmp_path / "log" / run_name(PDEConfig(num_iters=num_iters, **cfg))
        assert len(_csvs(run_dir)) == n_logs  # one per run, rank 0's
        assert files <= set(os.listdir(run_dir))
