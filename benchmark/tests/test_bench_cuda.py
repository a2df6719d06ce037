"""The controls on the card: each configuration's lower precision comes out
not correct, where a sound run at the same size comes out correct.

At widths a test run holds (the full-size readings are ``calibrate.py``'s,
PERF.md).  Run on the card with ``python3 -m pytest benchmark/tests -m cuda``.
"""
from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import edit_json, tiny_checkout

SMALL = {"e4_hydrogen": {"neigs": 8, "fourier_mapping_size": 128, "mlp_hidden_dims": "64,64",
                         "batch_size": 256},
         "cdk_sketchy": {"network_dims": "1024,128", "neigs": 128, "batch_size": 1024}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["e4_hydrogen.fwdlap", "cdk_sketchy.f32"])
def test_control_fails_where_the_sound_run_passes(card, tmp_path, cell):
    root = tiny_checkout(tmp_path)
    config = cell.split(".")[0]
    edit_json(root / harness.BENCH_DIR.name / "configs" / f"{config}.json", flags=SMALL[config])
    if config == "cdk_sketchy":
        edit_json(root / harness.BENCH_DIR.name / "configs" / f"{config}.json",
                  data={"pool_pairs": 8192, "classes": 20})
    runs = {control: harness.run_cell(cell, 2 ** 31 + 17, 0.0, False, time.perf_counter(),
                                      control=control, checkout=root, log=lambda s: None)
            for control in (False, True)}
    assert runs[False]["correct"], runs[False]["checks"]
    assert not runs[True]["correct"], runs[True]["checks"]
