"""The harness finds a cell's files by name: a configuration, a cell, a
metric and a kernel list are added by files alone; and without a card the
measuring command fails, never falling back to the CPU."""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

from benchmark import harness
from benchmark.tests.tiny import TINY_FLAGS, copy_checkout
from benchmark.trace import Record

NEW_METRIC = '''"""kernels_seen: device records in the traced window (a test's metric)."""


def read(ctx):
    window = ctx.trace.window()
    if window is None:
        return None
    return float(len(ctx.trace.ran_in(window)) + len(ctx.kernel_names("gram_work")))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_configuration_cell_and_metric_are_added_by_files(tmp_path):
    root = copy_checkout(tmp_path)
    bench = root / harness.BENCH_DIR.name
    before = _digests(root)

    config = json.loads((bench / "configs" / "e4_hydrogen.json").read_text())
    config.update(name="e4_small", flags={**config["flags"], **TINY_FLAGS["e4_hydrogen"]})
    (bench / "configs" / "e4_small.json").write_text(json.dumps(config))
    workload = json.loads((bench / "workloads" / "e4_hydrogen.fwdlap.json").read_text())
    workload.update(name="e4_small.fwdlap", block_steps=3, traced_steps=2, eager_traced_steps=1)
    (bench / "workloads" / "e4_small.fwdlap.json").write_text(json.dumps(workload))
    (bench / "metrics" / "kernels_seen.py").write_text(NEW_METRIC)
    (bench / "kernels" / "gram_work" / "later_kernel.json").write_text(
        json.dumps({"kernels": ["later_gram_kernel"]}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "e4_small", "source": "https://arxiv.org/abs/2402.03655",
                            "file": "benchmark/configs/e4_small.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "e4_small.fwdlap", "config": "e4_small",
                              "traffic": "fwdlap", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "kernels_seen", "unit": "records", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "train_samples_per_s", "workloads": ["e4_small.fwdlap"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {root.relative_to(root) / "BENCHMARK.json"}

    cell = harness.load_cell("e4_small.fwdlap", root)
    assert cell["config"]["name"] == "e4_small"
    assert "kernels_seen" in [m["name"] for m in cell["per_layer"]]
    assert "kernels_seen" not in [m["name"] for m in harness.load_cell(
        "cdk_sketchy.f32", root)["per_layer"]]
    names = harness.kernel_names(root, "gram_work")
    assert "later_gram_kernel" in names and "metric_grads_kernel" in names

    ctx = harness.Context(cell, [Record("host", "benchmark.window", 0, 100),
                                 Record("device", "k", 10, 5, 1)], 1,
                          {"steps": 1, "seconds": 1.0}, None, "f32")
    assert harness.metric_reader(root, "kernels_seen")(ctx) == 1 + len(names)

    result = harness.run_cell("e4_small.fwdlap", 5, 0.0, True, time.perf_counter(), device="cpu",
                              checkout=root, log=lambda s: None)
    assert result["correct"]
    assert result["metrics"]["kernels_seen"]["unit"] == "records"
    assert "train_samples_per_s" not in result["metrics"]  # a traced run's are per-layer
    assert "mfu.pde" not in result["metrics"]  # listed for the E4 cell only


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    root = copy_checkout(tmp_path)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cdk_sketchy.f32",
                           "--seed", str(2 ** 40), "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") and '"correct"' in line
                   for line in proc.stdout.splitlines())


def test_result_line_keys_and_checks_last(tmp_path):
    from benchmark.tests.tiny import tiny_checkout

    result = harness.run_cell("cdk_sketchy.f32", 2 ** 35, 0.0, False, time.perf_counter(),
                              device="cpu", checkout=tiny_checkout(tmp_path), log=lambda s: None)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
