"""Driver of the CDK two-tower training step (the Sketchy recipe and its kin).

The system under test is the port's Sketchy CLI trainer
(``cli.sketchy.make_trainer`` on the configuration's flags), with the
benchmark's weights loaded into its parameters, stepped as its driver steps
it: ``Trainer.step`` on device batches, nothing read on the host inside an
epoch.  The inputs are made on the card from the seed: a pool of
``pool_pairs`` class-correlated pairs of ``input_dim`` features (one
centre a class on each side, 3·N(0, 1), plus N(0, 1) noise a row), drawn
in a fresh seeded order every epoch.  A block is one epoch (the pool's
whole batches), ending in a host read of its last loss and skip count.

Set-up: the trainer, the weights, the pool, then the first epoch, whose
first ``check_steps`` steps are the correctness steps (the state read
after the first, the momentum buffer being the clipped gradient, and
after the last); the rest of the epoch warms up.
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

WEIGHTS_STREAM, DATA_STREAM, ORDER_STREAM = 1, 2, 3


class Driver:
    def __init__(self, cell: dict, seed: int, device, control: bool = False):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        config, traffic = cell["config"], cell["traffic"]
        self.ref_flags = {**config["flags"], **traffic.get("flags", {})}
        self.tf32 = bool(control and config["control"].get("tf32"))
        data = config["data"]
        self.input_dim = int(data["input_dim"])
        self.pool = int(data["pool_pairs"])
        self.classes = int(data["classes"])
        self.batch = int(self.ref_flags["batch_size"])
        self.steps_per_epoch = self.pool // self.batch
        self.block_steps = self.steps_per_epoch
        self.check_steps = int(cell["workload"]["check_steps"])
        self.reference = importlib.import_module(f"benchmark.reference.{config['reference']}")

    def _weights(self) -> dict:
        return self.reference.make_weights(self.ref_flags, self.input_dim,
                                           sub_seed(self.seed, WEIGHTS_STREAM), self.device)

    def _make_pool(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, DATA_STREAM))
        n, d, c = self.pool, self.input_dim, self.classes
        cls = torch.arange(n, device=self.device) % c
        centres = 3 * torch.randn((2, c, d), generator=gen, device=self.device)
        noise = torch.randn((2, n, d), generator=gen, device=self.device)
        self.X = centres[0][cls] + noise[0]
        self.Y = centres[1][cls] + noise[1]
        self.order = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, ORDER_STREAM))

    def _epoch(self) -> torch.Tensor:
        """The batches' row indices of the next epoch, (steps, B)."""
        perm = torch.randperm(self.pool, generator=self.order, device=self.device)
        return perm[:self.steps_per_epoch * self.batch].reshape(self.steps_per_epoch, self.batch)

    def _step(self, idx: torch.Tensor):
        x, y = self.X.index_select(0, idx), self.Y.index_select(0, idx)
        self.params, self.opt_state, _, loss, _, self.skips = self.tr.step(
            self.params, self.opt_state, {}, x, y, self.skips)
        return loss

    def setup(self) -> None:
        from neuralsvd_tpu_torch.cli.sketchy import get_args, make_trainer

        args = get_args(argv(self.ref_flags, bare_true=True)
                        + ["--seed", str(self.seed), "--device", str(self.device)])
        self.tr = make_trainer(args, self.input_dim, self.steps_per_epoch)
        load_weights(self.tr.params, self._weights())
        self.params, self.opt_state = self.tr.params, self.tr.opt_state
        self.skips = torch.zeros((), dtype=torch.int32, device=self.device)
        self._make_pool()
        matmul = torch.backends.cuda.matmul
        matmul.allow_tf32 = self.tf32
        try:
            batches = self._epoch()
            self.first_batches = batches[:self.check_steps].clone()
            losses = [self._step(batches[0])]
            trace = find_leaf_dict(self.opt_state, list(self.params))
            first_grads = {k: float(torch.linalg.vector_norm(v)) for k, v in trace.items()}
            losses += [self._step(batches[i]) for i in range(1, self.check_steps)]
            self.readings = {"losses": torch.stack(losses).tolist(), "first_grads": first_grads,
                             "params": {k: v.detach().clone() for k, v in self.params.items()}}
            for i in range(self.check_steps, self.steps_per_epoch):
                self._step(batches[i])
            sync(self.device)
        finally:
            matmul.allow_tf32 = False

    def block(self) -> tuple:
        """One epoch, ending in a host read: (steps, skipped steps so far
        in this block)."""
        before = self.skips.clone()
        losses = [self._step(idx) for idx in self._epoch()]
        _, skipped = torch.stack([losses[-1], (self.skips - before).to(torch.float32)]).tolist()
        return len(losses), int(skipped)

    def traced(self) -> tuple:
        """``traced_steps`` steps inside ``benchmark.window``, each in a
        ``benchmark.step`` span, the method's call in ``benchmark.method``.
        Returns (records, steps in the window)."""
        n = int(self.cell["workload"]["traced_steps"])
        method = self.tr.method
        method.loss_and_grad = spanned(method.loss_and_grad, "benchmark.method")
        step = spanned(self._step, "benchmark.step")
        records: list = []
        try:
            idx = torch.cat([self._epoch() for _ in range(-(-n // self.steps_per_epoch))])
            sync(self.device)
            with profiled(self.device, records):
                with torch.profiler.record_function("benchmark.window"):
                    for i in range(n):
                        step(idx[i])
                    sync(self.device)
        finally:
            del method.loss_and_grad
        return records, n

    def program_readings(self) -> dict:
        return self.readings

    def free(self) -> None:
        del self.tr, self.params, self.opt_state

    def reference_readings(self, fault: str = "") -> dict:
        batches = [(self.X.index_select(0, idx), self.Y.index_select(0, idx))
                   for idx in self.first_batches]
        return self.reference.train_steps(self.ref_flags, self.steps_per_epoch, self._weights(),
                                          batches, self.device, fault=fault)

    def initial_weights(self) -> dict:
        return self._weights()
