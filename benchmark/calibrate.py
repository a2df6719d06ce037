"""Readings that set the limits of a cell's correctness check.

``python3 benchmark/calibrate.py --workload <cell> --seeds <n,...>
--control-seeds <n,...> --fault-seeds <n,...>`` runs, in one process on
the card and at the cell's own sizes, the set-up of the timed path (its
first steps through the window's own call, as every run makes them) and
prints one JSON line a reading:

- "sound": the program against the plain reference, one a seed (the
  lower reading of each number is the largest over the seeds);
- "control": the configuration's control (its lower precision, the
  configuration file's ``control``) against the reference;
- "fault": a fault planted in the reference put in the program's place
  ("half_batch", "grad_leaf"), against the sound reference.  A state left
  unchanged reads 1 in ``change_gap`` by its definition and is not run.

No measured window: a training cell's readings come from its first steps.
"""
import gc
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(HERE)] + [p for p in sys.path
                                         if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

FAULTS = ("half_batch", "grad_leaf")


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def reading(cell: dict, seed: int, kind: str, fault: str = "", device: str = "cuda") -> dict:
    import importlib

    driver_cls = importlib.import_module(f"benchmark.drivers.{cell['config']['driver']}").Driver
    t0 = time.perf_counter()
    driver = driver_cls(cell, seed, device, control=(kind == "control"))
    driver.setup()
    prog = driver.program_readings()
    driver.free()
    ref = driver.reference_readings()
    if kind == "fault":
        prog = driver.reference_readings(fault=fault)
    gaps = harness.training_gaps(prog, ref, driver.initial_weights())
    losses = {"losses": prog["losses"], "ref_losses": ref["losses"],
              "ref_loss_scales": ref["loss_scales"]}
    del driver, prog, ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"kind": kind, "fault": fault, "seed": seed, **gaps, **losses,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args()
    cell = harness.load_cell(args.workload)
    print(json.dumps({"device": harness.require_devices(cell["chips"]),
                      "nvidia_smi": harness.card_state()}), flush=True)
    runs = ([(s, "sound", "") for s in _seeds(args.seeds)]
            + [(s, "control", "") for s in _seeds(args.control_seeds)]
            + [(s, "fault", f) for f in FAULTS for s in _seeds(args.fault_seeds)])
    for seed, kind, fault in runs:
        print(json.dumps(reading(cell, seed, kind, fault)), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
