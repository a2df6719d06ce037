"""The port's CDK retrieval trainer against the JAX package: retrieval
metrics, loaders, argument parsing, and the whole of ``run_training`` on
the CPU with synthetic class-correlated pairs (the arguments and loaders
of tests/test_cdk_retrieval.py), its artifacts, resume and checkpoints.
"""
import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neuralsvd_tpu.cli.sketchy import get_args as jax_get_args
from neuralsvd_tpu.data.sketchy import SketchyVGGDataLoader as JaxSketchyLoader
from neuralsvd_tpu.eval.retrieval import Retrieval as JaxRetrieval
from neuralsvd_tpu.eval.retrieval import average_precisions as jax_average_precisions
from neuralsvd_tpu.eval.retrieval import precision_at_k as jax_precision_at_k
from neuralsvd_tpu.eval.retrieval import top_k_retrievals as jax_top_k
from neuralsvd_tpu_torch.cli import sketchy as cli
from neuralsvd_tpu_torch.cli.sketchy import get_args, run_training
from neuralsvd_tpu_torch.data.sketchy import (
    ArrayPairLoader,
    SketchyVGGDataLoader,
    write_feature_files,
)
from neuralsvd_tpu_torch.eval.retrieval import (
    Retrieval,
    average_precisions,
    precision_at_k,
    top_k_retrievals,
)
from neuralsvd_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from neuralsvd_tpu_torch.utils.logging import CSVLogger


@pytest.mark.parametrize("metric", ["inner_product", "euclidean"])
def test_top_k_retrievals_match_jax(metric):
    """Tie-free random data (torch.topk and lax.top_k order ties
    differently): the same ranking, index for index."""
    rng = np.random.default_rng(0)
    zx = rng.normal(size=(37, 8)).astype(np.float32)
    zy = rng.normal(size=(101, 8)).astype(np.float32)
    for K in (5, None):
        want = jax_top_k(zx, zy, K=K, metric=metric, batch=16)
        got = top_k_retrievals(zx, zy, K=K, metric=metric, batch=16, device="cpu")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ver", [1, 2, 3])
def test_precision_and_average_precisions_match_jax(ver):
    rng = np.random.default_rng(ver)
    rel = rng.random((20, 30)) < 0.3
    rel[3] = False  # a query without hits
    n_rel = rng.integers(1, 40, size=20)
    np.testing.assert_array_equal(precision_at_k(rel), jax_precision_at_k(rel))
    np.testing.assert_allclose(average_precisions(rel, n_rel, ver=ver),
                               jax_average_precisions(rel, n_rel, ver=ver), rtol=1e-12)


def _synth_loaders(rng, n_cls=6, per_cls=30, D=16, batch=64):
    """Correlated (x, y) pairs: class-dependent means + noise
    (tests/test_cdk_retrieval.py:63-77)."""
    centers_x = 3 * rng.normal(size=(n_cls, D)).astype(np.float32)
    centers_y = 3 * rng.normal(size=(n_cls, D)).astype(np.float32)

    def split(seed):
        r = np.random.default_rng(seed)
        cls = np.repeat(np.arange(n_cls), per_cls)
        x = centers_x[cls] + r.normal(size=(len(cls), D)).astype(np.float32)
        y = centers_y[cls] + r.normal(size=(len(cls), D)).astype(np.float32)
        return ArrayPairLoader(x, y, cls, batch_size=batch, seed=seed)

    return split(1), split(2), split(3)


def test_retrieval_evaluate_matches_jax():
    """Same embeddings (fixed linear maps) through both Retrieval classes:
    P@K and mAP with truncation, negative truncation and a permutation."""
    _, test, _ = _synth_loaders(np.random.default_rng(0))
    w = np.random.default_rng(1).normal(size=(16, 12)).astype(np.float32)
    jr = JaxRetrieval(test, n_retrievals=10, batch_size=64)
    tr = Retrieval(test, n_retrievals=10, batch_size=64, device="cpu")
    perm = np.random.default_rng(2).permutation(12)
    jmodel = lambda v: v @ jnp.asarray(w)  # noqa: E731
    tmodel = lambda v: v @ torch.as_tensor(w)  # noqa: E731
    for kw in (dict(), dict(trunc_dim=4), dict(trunc_dim=-4), dict(trunc_dim=6, perm=perm)):
        jpk, jap = jr.evaluate(jmodel, jmodel, return_map_all=True, **kw)
        tpk, tap = tr.evaluate(tmodel, tmodel, return_map_all=True, **kw)
        np.testing.assert_allclose(tpk, jpk, rtol=1e-12, err_msg=str(kw))
        np.testing.assert_allclose(tap, jap, rtol=1e-12, err_msg=str(kw))


def _write_split_files(root, n_cls=5, per_cls=8, D=12, seed=0):
    rng = np.random.default_rng(seed)
    for phase in ("train", "test", "valid"):
        for kind in ("sketch", "photo"):
            cls = np.repeat([f"cls{i}" for i in range(n_cls)], per_cls)
            feats = rng.normal(size=(len(cls), D)).astype(np.float32)
            write_feature_files(root, "1", phase, kind, feats, cls)


def test_sketchy_loader_matches_jax_python_path(tmp_path):
    """Same files, same seed: the port's loader and the JAX loader on their
    Python pairing path (use_native=False; both draw natively by default)
    draw the same batches."""
    _write_split_files(str(tmp_path))
    port = SketchyVGGDataLoader(7, root_path=str(tmp_path), split="1", seed=3,
                                use_native=False)
    ref = JaxSketchyLoader(7, root_path=str(tmp_path), split="1", seed=3,
                           use_native=False)
    assert port.max_steps == ref.max_steps == 6
    batches = list(zip(port, ref))
    assert len(batches) == 6
    for (x, y, c), (rx, ry, rc) in batches:
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        np.testing.assert_array_equal(c, rc)


ARGV = ["--num_epochs", "3", "--batch_size", "64", "--network_dims", "64,16",
        "--neigs", "16", "--optimizer", "adam", "--base_lr", "1e-3", "--mu", "4.0",
        "--n_retrievals", "10", "--return_map_all", "--n_retrievals_to_save", "5",
        "--trunc_dims", "4", "8", "-8"]


def test_args_parse_like_jax():
    """The JAX CLI's argv gives the same namespace; --device is the port's."""
    argv = ARGV + ["--use_lr_scheduler", "--neuralsvd.sequential",
                   "--neuralsvd.set_first_mode_const", "false", "--randperm"]
    port, ref = vars(get_args(argv)), vars(jax_get_args(argv))
    assert port.pop("device") is None
    assert port == ref


def test_sequential_flag_takes_no_value_in_both():
    """scripts/exps/sketchy.sh:35 passes '--neuralsvd.sequential false';
    the flag is store_true in the JAX CLI and in the port, so both refuse
    the stray 'false' (a fault of the script, ROADMAP §3)."""
    argv = ["--neuralsvd.sequential", "false"]
    for parse in (get_args, jax_get_args):
        with pytest.raises(SystemExit):
            parse(argv)


def _csv_rows(log_dir):
    rows = []
    for f in sorted(os.listdir(log_dir)):
        if f.endswith(".csv"):
            with open(os.path.join(log_dir, f)) as fh:
                rows.extend(csv.DictReader(fh))
    return rows


def test_cdk_end_to_end_synthetic(tmp_path):
    """Two-tower CDK training on the CPU lifts retrieval well above chance
    and writes the JAX CLI's artifacts, with .npz in place of plots."""
    train, test, valid = _synth_loaders(np.random.default_rng(0))
    args = get_args(["--log_dir", str(tmp_path), "--device", "cpu"] + ARGV)
    timings = {}
    params, trunc_results = run_training(args, train, test, valid, input_dim=16,
                                         timings=timings)
    rows = _csv_rows(tmp_path)
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    # seconds by part: once an epoch, and once for the final parts
    assert {k: len(v) for k, v in timings.items()} == {
        "steps": 3, "eval": 3, "checkpoint": 3, "ratios": 3,
        "spectrum": 1, "trunc_sweep": 1}
    assert all(t >= 0 for v in timings.values() for t in v)
    assert all(int(r["skips"]) == 0 for r in rows)
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    final_pk = float(rows[-1]["test_P@K"])
    assert final_pk > 2 * (1.0 / 6), f"P@K {final_pk} not above chance"
    assert set(trunc_results) == {4, 8, -8}
    # the JAX set: log_*.csv, best, ckpt, ratios_e{0,1,2}.png,
    # spectrum_final.png, retrievals_best.npz, best_stats.npz
    names = set(os.listdir(tmp_path))
    assert {n for n in names if not n.endswith(".csv")} == {
        "best", "ckpt", "ratios_e0.npz", "ratios_e1.npz", "ratios_e2.npz",
        "spectrum_final.npz", "retrievals_best.npz", "best_stats.npz"}
    ratios = np.load(tmp_path / "ratios_e2.npz")
    B = 180 - 2 * 64  # the last batch of an epoch
    assert ratios["rs_joint"].shape == (B,) and ratios["rs_indep"].shape == (B * (B - 1),)
    spec = np.load(tmp_path / "spectrum_final.npz")
    assert spec["singvals"].shape == (17,) and spec["orth_x"].shape == (17, 17)
    # the returned parameters are the best ones by valid P@K
    best = load_checkpoint(str(tmp_path / "best"))
    for k, p in params.items():
        assert torch.equal(p.detach(), best[k])


def test_cdk_resume_from_checkpoint(tmp_path):
    """--resume restores params, optimizer state, epoch and the best
    parameters, and continues the log at the next epoch."""
    train, test, valid = _synth_loaders(np.random.default_rng(0))
    base = ["--log_dir", str(tmp_path), "--device", "cpu", "--batch_size", "64",
            "--network_dims", "64,16", "--neigs", "16", "--optimizer", "adam",
            "--base_lr", "1e-3", "--mu", "4.0", "--n_retrievals", "10"]
    run_training(get_args(base + ["--num_epochs", "1"]), train, test, valid, input_dim=16)
    ckpt = load_checkpoint(str(tmp_path / "ckpt"))
    assert ckpt["epoch"] == 1
    assert int(ckpt["opt_state"][0]["count"]) == train.max_steps
    run_training(get_args(base + ["--num_epochs", "2", "--resume"]),
                 train, test, valid, input_dim=16)
    assert [int(r["epoch"]) for r in _csv_rows(tmp_path)] == [0, 1]
    ckpt = load_checkpoint(str(tmp_path / "ckpt"))
    assert ckpt["epoch"] == 2
    assert int(ckpt["opt_state"][0]["count"]) == 2 * train.max_steps


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails leaves the last good checkpoint in place and no
    temporary file; a corrupt file raises on load."""
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"params": {"w": torch.ones(3)}, "epoch": 1})

    def broken_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, {"params": {"w": torch.zeros(3)}, "epoch": 2})
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["ckpt"]
    restored = load_checkpoint(path)
    assert restored["epoch"] == 1 and torch.equal(restored["params"]["w"], torch.ones(3))
    (tmp_path / "ckpt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        load_checkpoint(path)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an aten op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("use_pallas", ["false", "true"])
def test_hot_step_computes_no_batch_gram(use_pallas):
    """No op of the train step returns a (B, B)-sized tensor; the
    once-an-epoch density-ratio function does (the positive control)."""
    B = 96
    args = get_args(["--device", "cpu", "--batch_size", str(B), "--network_dims", "32,8",
                     "--neigs", "8", "--optimizer", "sgd", "--momentum", "0.9",
                     "--use_lr_scheduler", "--grad_clip", "1.0", "--use_pallas", use_pallas])
    tr = cli.make_trainer(args, input_dim=12, steps_per_epoch=4)
    rng = np.random.default_rng(0)
    x, y = (torch.as_tensor(rng.normal(size=(B, 12)).astype(np.float32)) for _ in range(2))
    skips = torch.zeros((), dtype=torch.int32)
    with _Shapes() as rec:
        params, *_ = tr.step(tr.params, tr.opt_state, {}, x, y, skips)
    assert rec.shapes and max(int(np.prod(s)) for s in rec.shapes) < B * (B - 1)
    with _Shapes() as rec:
        rs_joint, rs_indep = cli.make_density_ratio_fn(tr.model, True)(params, x, y)
    assert (B, B) in rec.shapes and rs_indep.shape == (B * (B - 1),)


def test_main_runs_from_a_feature_root(tmp_path):
    """``main`` reads the six split files of a feature root through the
    Sketchy loader and trains (here: made-up features, on the CPU)."""
    _write_split_files(str(tmp_path / "root"), n_cls=4, per_cls=16, D=10)
    args = get_args(["--root_dir", str(tmp_path / "root"), "--log_dir", str(tmp_path / "log"),
                     "--device", "cpu", "--num_epochs", "1", "--batch_size", "16",
                     "--network_dims", "16,4", "--neigs", "4", "--n_retrievals", "5"])
    params, _ = cli.main(args)
    assert params["x.layers.0.w"].shape == (10, 16)
    assert len(_csv_rows(tmp_path / "log")) == 1


# ids as when bf16 towers and lars raised (item 7) and --mesh (item 9);
# they build and train now (match None, --mesh dp: test_torch_cli_mesh.py);
# a tp mesh axis runs too (test_torch_tp.py), but in one process it needs
# more ranks than run
@pytest.mark.parametrize("argv,exc,match", [
    (["--mesh", "dp=1,tp=2"], ValueError, "needs 2 devices, only 1"),
    (["--compute_dtype", "bf16"], None, None),
    (["--optimizer", "lars", "--momentum", "0.9", "--weight_decay", "1e-4"], None, None),
], ids=["argv0-item 9", "argv1-item 7", "argv2-item 7"])
def test_unported_options_raise(argv, exc, match):
    args = get_args(["--device", "cpu", "--network_dims", "8,4", "--neigs", "4"] + argv)
    if exc is not None:
        with pytest.raises(exc, match=match):
            cli.make_trainer(args, input_dim=6, steps_per_epoch=1)
        return
    tr = cli.make_trainer(args, input_dim=6, steps_per_epoch=1)
    rng = np.random.default_rng(0)
    x, y = (torch.as_tensor(rng.normal(size=(16, 6)).astype(np.float32)) for _ in range(2))
    before = {k: p.detach().clone() for k, p in tr.params.items()}
    skips = torch.zeros((), dtype=torch.int32)
    params, _, _, loss, _, skips = tr.step(tr.params, tr.opt_state, {}, x, y, skips)
    assert torch.isfinite(loss) and int(skips) == 0
    assert all(p.dtype == torch.float32 for p in params.values())
    assert any(not torch.equal(params[k], before[k]) for k in before)


class _FrozenClock:
    """Stands in for the ``datetime`` module: now() is one fixed second."""

    class datetime:
        @staticmethod
        def now():
            import datetime
            return datetime.datetime(2026, 1, 1, 12, 0, 0)


def test_csv_logger_keeps_both_logs_within_one_second(tmp_path, monkeypatch):
    """Two loggers opened in the same second: the JAX logger gives both the
    same file, so the second truncates the first's rows (ROADMAP §3); the
    port's keeps both."""
    import neuralsvd_tpu.utils.logging as jax_logging
    import neuralsvd_tpu_torch.utils.logging as port_logging

    monkeypatch.setattr(jax_logging, "datetime", _FrozenClock)
    monkeypatch.setattr(port_logging, "datetime", _FrozenClock)
    ja = jax_logging.CSVLogger(str(tmp_path / "jax"), ["epoch"])
    jb = jax_logging.CSVLogger(str(tmp_path / "jax"), ["epoch"])
    assert ja.path == jb.path
    ja.close()
    jb.close()
    a = CSVLogger(str(tmp_path), ["epoch"])
    b = CSVLogger(str(tmp_path), ["epoch"])
    a.writerow({"epoch": 0})
    b.writerow({"epoch": 1})
    a.close()
    b.close()
    assert a.path != b.path
    assert sorted(int(r["epoch"]) for r in _csv_rows(tmp_path)) == [0, 1]


def test_resume_keeps_the_best_parameters(tmp_path):
    """Resuming after the last epoch: the port returns (and evaluates) the
    best checkpoint; the JAX CLI returns its fresh initial parameters,
    which it never trained (ROADMAP §3)."""
    from neuralsvd_tpu.cli.sketchy import run_training as jax_run_training
    from neuralsvd_tpu.training.checkpoint import load_checkpoint as jax_load

    train, test, valid = _synth_loaders(np.random.default_rng(0))
    base = ["--batch_size", "64", "--network_dims", "32,8", "--neigs", "8",
            "--optimizer", "adam", "--base_lr", "1e-3", "--mu", "4.0",
            "--n_retrievals", "10", "--num_epochs", "1"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    port_args = base + ["--log_dir", port_dir, "--device", "cpu"]
    run_training(get_args(port_args), train, test, valid, input_dim=16)
    params, _ = run_training(get_args(port_args + ["--resume"]), train, test, valid,
                             input_dim=16)
    best = load_checkpoint(os.path.join(port_dir, "best"))
    assert all(torch.equal(p.detach(), best[k]) for k, p in params.items())

    jax_run_training(jax_get_args(base + ["--log_dir", jax_dir]), train, test, valid,
                     input_dim=16)
    jparams, _ = jax_run_training(jax_get_args(base + ["--log_dir", jax_dir, "--resume"]),
                                  train, test, valid, input_dim=16)
    jbest = jax_load(os.path.join(jax_dir, "best"))
    assert not np.allclose(np.asarray(jparams["x"]["layers"][0]["w"]),
                           np.asarray(jbest["x"]["layers"][0]["w"]))
