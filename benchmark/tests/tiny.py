"""A copy of the benchmark at sizes a CPU test can hold."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness import BENCH_DIR, CHECKOUT

# every width cut, every path kept
TINY_FLAGS = {
    "e4_hydrogen": {"neigs": 4, "fourier_mapping_size": 8, "mlp_hidden_dims": "16,16",
                    "batch_size": 64},
    "cdk_sketchy": {"network_dims": "32,16", "neigs": 16, "batch_size": 64},
}
TINY_DATA = {"cdk_sketchy": {"pool_pairs": 300, "classes": 5}}
TINY_WORKLOAD = {"e4_hydrogen.fwdlap": {"block_steps": 4, "traced_steps": 3,
                                        "eager_traced_steps": 2},
                 "cdk_sketchy.f32": {"traced_steps": 5}}


def edit_json(path: Path, **updates) -> None:
    data = json.loads(path.read_text())
    for key, value in updates.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data, indent=1))


def copy_checkout(dst: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder under ``dst``, as they are."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, dst / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def tiny_checkout(dst: Path) -> Path:
    """``copy_checkout`` with the configurations and cells cut to ``TINY_*``."""
    copy_checkout(dst)
    bench = dst / BENCH_DIR.name
    for name, flags in TINY_FLAGS.items():
        edit_json(bench / "configs" / f"{name}.json", flags=flags,
                  **({"data": TINY_DATA[name]} if name in TINY_DATA else {}))
    for name, sizes in TINY_WORKLOAD.items():
        edit_json(bench / "workloads" / f"{name}.json", **sizes)
    return dst
