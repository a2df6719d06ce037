"""The plain references against the port, and what each may import."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_checkout

REFERENCES = sorted((harness.BENCH_DIR / "reference").glob("*.py"))
# what a chip run imports: the harness, every driver, metric, reference and
# counting module, and the port's modules the drivers build on
CHIP_MODULES = (["benchmark.harness", "benchmark.trace", "benchmark.drivers.common"]
                + [f"benchmark.{d}.{p.stem}" for d in ("drivers", "reference", "flops")
                   for p in sorted((harness.BENCH_DIR / d).glob("*.py"))
                   if p.stem != "__init__"]
                + ["neuralsvd_tpu_torch.cli.pde", "neuralsvd_tpu_torch.cli.sketchy",
                   "neuralsvd_tpu_torch.training.train_operator",
                   "neuralsvd_tpu_torch.training.train_state",
                   "neuralsvd_tpu_torch.utils.config", "neuralsvd_tpu_torch.ops.cuda_gram"])


@pytest.mark.parametrize("cell", ["e4_hydrogen.fwdlap", "cdk_sketchy.f32"])
def test_port_and_reference_agree_on_seeded_weights(tmp_path, cell):
    """The first steps of the timed path, at tiny sizes on the CPU, against
    the reference on the same weights and inputs: float32 rounding apart."""
    result = harness.run_cell(cell, 2 ** 33 + 7, 0.0, False, time.perf_counter(),
                              device="cpu", checkout=tiny_checkout(tmp_path), log=lambda s: None)
    gaps = {k: c["value"] for k, c in result["checks"].items()}
    assert max(gaps.values()) < 1e-5, gaps
    assert result["correct"]


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True,
                         cwd=harness.CHECKOUT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_run_on_the_chip_imports_jax_or_the_jax_package():
    found = _top_level_modules("\n".join(f"import {m}" for m in CHIP_MODULES)
                               + "\nfrom benchmark.harness import metric_reader, CHECKOUT\n"
                               + "".join(f"metric_reader(CHECKOUT, {p.stem!r})\n" for p in
                                         sorted((harness.BENCH_DIR / 'metrics').glob('*.py'))))
    assert "neuralsvd_tpu_torch" in found  # the names are compared whole
    assert not found & set(harness.FORBIDDEN_MODULES)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "neuralsvd_tpu_torchvision_like", sys)
    assert "neuralsvd_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "neuralsvd_tpu.ops", sys)
    assert "neuralsvd_tpu" in harness.forbidden_modules()


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.stem)
def test_no_reference_imports_the_port(path):
    imported = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert not imported & {"neuralsvd_tpu_torch", "neuralsvd_tpu", "jax"}, imported
    loaded = _top_level_modules(f"import benchmark.reference.{path.stem}")
    assert not loaded & {"neuralsvd_tpu_torch", "neuralsvd_tpu", "jax"}


def test_reference_refuses_a_configuration_it_does_not_compute():
    from benchmark.reference import cdk, e4

    flags = json.loads((harness.BENCH_DIR / "configs" / "e4_hydrogen.json").read_text())["flags"]
    with pytest.raises(ValueError, match="laplacian_eps"):
        e4.check_flags({**flags, "laplacian_eps": 0.01})
    with pytest.raises(ValueError, match="compute_dtype"):
        cdk.check_flags({"compute_dtype": "bf16"})


def test_reference_weights_repeat_from_the_seed():
    from benchmark.reference import e4

    flags = json.loads((harness.BENCH_DIR / "configs" / "e4_hydrogen.json").read_text())["flags"]
    small = {**flags, "fourier_mapping_size": 8, "mlp_hidden_dims": "16,16"}
    a, b = e4.make_weights(small, 3, "cpu"), e4.make_weights(small, 3, "cpu")
    c = e4.make_weights(small, 4, "cpu")
    assert all((a[k] == b[k]).all() for k in a)
    assert any((a[k] != c[k]).any() for k in a)
    assert a["base.ws.0"].shape == (16, 16, 2 * 8 + 1 + 4)


def test_batches_are_new_rows_every_step(tmp_path):
    """The check steps' CDK batches hold rows that all differ."""
    import torch

    cell = harness.load_cell("cdk_sketchy.f32", tiny_checkout(tmp_path))
    from benchmark.drivers.cdk_train import Driver

    d = Driver(cell, 11, "cpu")
    d.setup()
    rows = d.first_batches.reshape(-1)
    assert len(torch.unique(rows)) == len(rows)
