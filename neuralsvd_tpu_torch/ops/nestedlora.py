"""NestedLoRA EVD loss with its hand-derived backward (plain PyTorch path).

Port of ``neuralsvd_tpu/ops/nestedlora.py:54-101``.

IMPORTANT SEMANTICS (do not "fix"): the backward deliberately differs from
the gradient of the forward scalar.  The operator term's forward is
``-2·E[Σ_l w_l f_l·(Tf)_l]`` but its backward routes the *entire* gradient
``-4/B·w⊙Tf`` through ``f`` and none through ``Tf``.  For a self-adjoint
operator this is the functional gradient, and the operator application
never enters the backward graph.

The f1/f2 sample groups MUST be statistically independent.  The SVD and
CDK losses and the data-parallel ``axis_name`` are not ported yet
(ROADMAP queue 1, items 1 and 14).
"""
from __future__ import annotations

import torch

from neuralsvd_tpu_torch.ops.gram import compute_loss_metric


class NestedLoRAEVDLoss(torch.autograd.Function):
    """(f, Tf, f1, f2, vector_mask, matrix_mask) -> scalar loss.

    f, Tf: (B, L) or (B, L, O); f1, f2: the two half-batches of f.
    """

    @staticmethod
    def forward(ctx, f, Tf, f1, f2, vector_mask, matrix_mask):
        loss_metric, lam_f1, lam_f2 = compute_loss_metric(f1, f2, matrix_mask)
        op = torch.einsum("l,bl...,bl...->b", vector_mask, f, Tf)
        loss = -2.0 * op.mean() + loss_metric
        ctx.save_for_backward(Tf, f1, f2, lam_f1, lam_f2, vector_mask,
                              matrix_mask)
        ctx.batch = f.shape[0]
        return loss

    @staticmethod
    def backward(ctx, g):
        Tf, f1, f2, lam_f1, lam_f2, vector_mask, matrix_mask = ctx.saved_tensors
        # -4/B (not -2/B) through f only; Tf gets no gradient
        operator_f = (-4.0 / ctx.batch) * torch.einsum(
            "l,bl...->bl...", vector_mask, Tf)
        metric_f1 = (2.0 / f1.shape[0]) * torch.einsum(
            "lm,lm,bl...->bm...", matrix_mask, lam_f2, f1)
        metric_f2 = (2.0 / f2.shape[0]) * torch.einsum(
            "lm,lm,bl...->bm...", matrix_mask, lam_f1, f2)
        return g * operator_f, None, g * metric_f1, g * metric_f2, None, None


def nestedlora_evd_loss(f, Tf, f1, f2, vector_mask, matrix_mask):
    """NestedLoRA EVD loss (operator term + metric term)."""
    return NestedLoRAEVDLoss.apply(f, Tf, f1, f2, vector_mask, matrix_mask)
