"""Driver of the PDE operator-EVD training step (the E4 recipe and its kin).

The system under test is built as the port's PDE CLI builds it
(``cli.pde.build`` on the configuration's flags), with the benchmark's own
weights loaded into the model, and driven as ``train_operator`` drives it:
``make_train_step`` under ``ScannedTrainStep`` blocks of ``block_steps``
(one captured step replayed on the card), a host read of the block's last
loss and skip count after each block.

Set-up: the build, the weights, a first block (the capture and its
warm-up), then the correctness steps: from the initial state again, the
first ``check_steps`` replays of the block at 0, one at a time, reading the
state after the first (the gradient, from RMSprop's ν) and after the last
(parameters and EMA).  The window then runs blocks from the initial state,
as a run does.
"""
from __future__ import annotations

import importlib

import torch

from benchmark.drivers.common import (
    argv,
    find_leaf_dict,
    load_weights,
    profiled,
    spanned,
    sub_seed,
    sync,
)

WEIGHTS_STREAM = 1


class Driver:
    def __init__(self, cell: dict, seed: int, device, control: bool = False):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        config, traffic = cell["config"], cell["traffic"]
        self.ref_flags = {**config["flags"], **traffic.get("flags", {})}
        self.flags = {**self.ref_flags, **(config["control"]["flags"] if control else {})}
        self.block_steps = int(cell["workload"]["block_steps"])
        self.check_steps = int(cell["workload"]["check_steps"])
        w = cell["workload"]
        if max(self.check_steps, int(w["traced_steps"]), 2, int(w["eager_traced_steps"])) \
                > self.block_steps:
            raise ValueError("check, traced and eager steps must fit in one block: "
                             f"{w}")
        self.batch = int(self.flags["batch_size"])
        self.reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
        self.start = 0

    def _weights(self) -> dict:
        return self.reference.make_weights(self.ref_flags, sub_seed(self.seed, WEIGHTS_STREAM),
                                           self.device)

    def setup(self) -> None:
        from neuralsvd_tpu_torch.cli.pde import build
        from neuralsvd_tpu_torch.training.train_operator import ScannedTrainStep, make_train_step
        from neuralsvd_tpu_torch.training.train_state import clone_tree, init_train_state
        from neuralsvd_tpu_torch.utils.config import parse_pde_config

        cfg = parse_pde_config(argv(self.flags) + ["--seed", str(self.seed),
                                                   "--device", str(self.device)])
        torch.set_float32_matmul_precision("highest")  # as cli.pde.main
        run = build(cfg)
        load_weights(dict(run.model.named_parameters()), self._weights())
        self.ts = init_train_state(run.model, run.optimizer, run.method)
        self.device = self.ts.step.device  # "cuda:0": the blocks' buffers are keyed by it
        method = run.method
        method.loss_and_grad = spanned(method.loss_and_grad, "benchmark.method")
        step = make_train_step(method, spanned(run.operator, "benchmark.operator"),
                               run.optimizer, run.sample, importance=run.importance_train,
                               ema_decay=cfg.ema_decay, grad_clip=cfg.grad_clip)
        spanned_step = spanned(step, "benchmark.step")
        spanned_step.needs_probes = step.needs_probes
        self.blocks = ScannedTrainStep(spanned_step, self.block_steps, seed=cfg.seed)
        self.alpha = cfg.rmsprop_decay
        with torch.no_grad():
            self.initial = {name: clone_tree(getattr(self.ts, name))
                            for name in ("step", "params", "opt_state", "ema_params",
                                         "method_state")}
        self.block()  # the capture and its first replays
        self._restore()
        self._replay(0, 1)
        nu = find_leaf_dict(self.ts.opt_state, list(self.ts.params))
        self.first_grads = {k: float(torch.sqrt(torch.sum(v) / (1 - self.alpha)))
                            for k, v in nu.items()}
        self._replay(0, self.check_steps - 1, begin=False)
        sync(self.device)
        traces = self.blocks.buffers(self.device)[2]
        self.readings = {"losses": traces[:self.check_steps, 0].tolist(),
                         "first_grads": self.first_grads,
                         "params": {k: v.detach().clone() for k, v in self.ts.params.items()},
                         "ema": {k: v.detach().clone() for k, v in self.ts.ema_params.items()}}
        self._restore()
        self.start = 0

    def _restore(self) -> None:
        from neuralsvd_tpu_torch.training.train_state import load_state_tree

        load_state_tree(self.ts, self.initial)

    def _replay(self, start: int, n: int, begin: bool = True) -> None:
        """``n`` steps of the block at ``start`` as the window runs them
        (replays of the captured step on the card), from its beginning."""
        if begin:
            self.blocks.begin_block(self.device, start)
        for _ in range(n):
            if self.blocks.graph is not None:
                self.blocks.graph.replay()
            else:
                self.blocks.eager_step(self.ts)

    def block(self) -> tuple:
        """One timed block, ending in the host read ``train_operator``
        makes: (steps, skipped steps)."""
        from neuralsvd_tpu_torch.ops import cuda_gram

        _, metrics = self.blocks(self.ts, self.start)
        _, skips = torch.stack([metrics["loss"][-1],
                                metrics["skipped"].sum().to(torch.float32)]).tolist()
        cuda_gram.check_tickets()
        self.start += self.block_steps
        return self.block_steps, int(skips)

    def traced(self) -> tuple:
        """The traced stretches: ``traced_steps`` replays of the block at
        the next start inside ``benchmark.window``, then
        ``eager_traced_steps`` eager steps (their spans).  Returns (records,
        steps in the window)."""
        n = int(self.cell["workload"]["traced_steps"])
        eager = int(self.cell["workload"]["eager_traced_steps"])
        records: list = []
        self.blocks.begin_block(self.device, self.start)
        for _ in range(2):  # the eager path's first allocations, untraced
            self.blocks.eager_step(self.ts)
        sync(self.device)
        with profiled(self.device, records):
            with torch.profiler.record_function("benchmark.window"):
                self._replay(self.start, n)
                sync(self.device)
            self.blocks.begin_block(self.device, self.start + self.block_steps)
            for _ in range(eager):
                self.blocks.eager_step(self.ts)
        self.start += 2 * self.block_steps
        return records, n

    def program_readings(self) -> dict:
        return self.readings

    def free(self) -> None:
        del self.ts, self.blocks, self.initial

    def reference_readings(self, fault: str = "") -> dict:
        return self.reference.train_steps(self.ref_flags, self.seed, self._weights(),
                                          self.check_steps, self.device, fault=fault)

    def initial_weights(self) -> dict:
        return self._weights()
