"""A run with the timed path broken underneath comes out not correct.

Each cell at the tiny sizes of ``tiny.py`` on the CPU (the harness's look
for a card skipped), once sound and once with each fault a training cell
can have: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; one gradient altered where it is
produced.  (Both cells run on one card: no exchange between chips to leave
out.)
"""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_checkout


def _run(tmp_path, cell):
    return harness.run_cell(cell, 2 ** 32 + 99, 0.0, False, time.perf_counter(), device="cpu",
                            checkout=tiny_checkout(tmp_path), log=lambda s: None)


def _unchanged_e4(monkeypatch):
    from neuralsvd_tpu_torch.training import train_operator
    from neuralsvd_tpu_torch.training.train_state import STATE_FIELDS, clone_tree, load_state_tree

    real = train_operator.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(ts, generator, probes=None):
            saved = {n: clone_tree(getattr(ts, n)) for n in STATE_FIELDS}
            out = step(ts, generator, probes)
            load_state_tree(ts, saved)
            return out

        broken.needs_probes = step.needs_probes
        return broken

    monkeypatch.setattr(train_operator, "make_train_step", make)


def _half_batch_e4(monkeypatch):
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA

    real = NestedLoRA.loss_and_grad
    monkeypatch.setattr(NestedLoRA, "loss_and_grad",
                        lambda self, p, s, x, op, imp=None: real(self, p, s, x[:x.shape[0] // 2],
                                                                 op, imp))


def _grad_leaf_e4(monkeypatch):
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA

    real = NestedLoRA._loss_and_grad

    def altered(self, *args, **kwargs):
        loss, grads, aux, state = real(self, *args, **kwargs)
        k = next(iter(grads))
        grads[k] = 1.5 * grads[k]
        return loss, grads, aux, state

    monkeypatch.setattr(NestedLoRA, "_loss_and_grad", altered)


def _unchanged_cdk(monkeypatch):
    from neuralsvd_tpu_torch.cli import sketchy

    real = sketchy.make_cdk_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(params, opt_state, method_state, x, y, skips):
            saved = {k: p.detach().clone() for k, p in params.items()}
            out = step(params, opt_state, method_state, x, y, skips)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])
            return (params, opt_state) + tuple(out[2:])

        return broken

    monkeypatch.setattr(sketchy, "make_cdk_train_step", make)


def _half_batch_cdk(monkeypatch):
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRAForCDK

    real = NestedLoRAForCDK.loss_and_grad
    monkeypatch.setattr(NestedLoRAForCDK, "loss_and_grad",
                        lambda self, p, s, x, y, w=None: real(self, p, s, x[:x.shape[0] // 2],
                                                              y[:y.shape[0] // 2], w))


def _grad_leaf_cdk(monkeypatch):
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRAForCDK

    real = NestedLoRAForCDK.loss_and_grad

    def altered(self, *args, **kwargs):
        loss, grads, aux, state = real(self, *args, **kwargs)
        k = next(iter(grads))
        grads[k] = 1.5 * grads[k]
        return loss, grads, aux, state

    monkeypatch.setattr(NestedLoRAForCDK, "loss_and_grad", altered)


FAULTS = {"e4_hydrogen.fwdlap": {"unchanged_state": _unchanged_e4, "half_batch": _half_batch_e4,
                                 "grad_leaf": _grad_leaf_e4},
          "cdk_sketchy.f32": {"unchanged_state": _unchanged_cdk, "half_batch": _half_batch_cdk,
                              "grad_leaf": _grad_leaf_cdk}}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(tmp_path, cell):
    assert _run(tmp_path, cell)["correct"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    FAULTS[cell][fault](monkeypatch)
    result = _run(tmp_path, cell)
    assert not result["correct"], result["checks"]
