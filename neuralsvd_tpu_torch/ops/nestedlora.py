"""NestedLoRA EVD, SVD and CDK losses with their hand-derived backwards
(plain PyTorch path).

Port of ``neuralsvd_tpu/ops/nestedlora.py``: the EVD loss (:133-180), the
SVD loss (:187-228) and the CDK loss (:235-314).

IMPORTANT SEMANTICS (do not "fix"): the backward deliberately differs from
the gradient of the forward scalar.  The operator term's forward is
``-2·E[Σ_l w_l f_l·(Tf)_l]`` but its backward routes the *entire* gradient
``-4/B·w⊙Tf`` through ``f`` and none through ``Tf``.  For a self-adjoint
operator this is the functional gradient, and the operator application
never enters the backward graph.

Every loss takes ``axis_name``: a data-parallel process group
(parallel/collectives.py) or None.  With a group the grams and the
operator term's mean are averaged over its ranks in the forward, and the
backward divides by the GLOBAL batch (local rows x ranks), so each rank's
input gradients are its rows of the global gradient (JAX's
``_axis_scale``).  The f1/f2 sample groups MUST be statistically
independent; under data parallelism each rank contributes an independent
half-batch pair, and the mean of their grams keeps the unions independent.
"""
from __future__ import annotations

import torch

from neuralsvd_tpu_torch.ops.gram import compute_loss_metric, off_diagonal
from neuralsvd_tpu_torch.parallel.collectives import axis_size, pmean
from neuralsvd_tpu_torch.utils.tracing import spanned


class NestedLoRAEVDLoss(torch.autograd.Function):
    """(f, Tf, f1, f2, vector_mask, matrix_mask) -> scalar loss.

    f, Tf: (B, L) or (B, L, O); f1, f2: the two half-batches of f.
    """

    @staticmethod
    @spanned("loss.forward")
    def forward(ctx, f, Tf, f1, f2, vector_mask, matrix_mask, axis_name):
        loss_metric, lam_f1, lam_f2 = compute_loss_metric(f1, f2, matrix_mask,
                                                          axis_name)
        op = torch.einsum("l,bl...,bl...->b", vector_mask, f, Tf)
        loss = -2.0 * pmean(op.mean(), axis_name) + loss_metric
        ctx.save_for_backward(Tf, f1, f2, lam_f1, lam_f2, vector_mask,
                              matrix_mask)
        ctx.n = axis_size(axis_name)
        ctx.batch = f.shape[0]
        return loss

    @staticmethod
    @spanned("loss.backward")
    def backward(ctx, g):
        Tf, f1, f2, lam_f1, lam_f2, vector_mask, matrix_mask = ctx.saved_tensors
        n = ctx.n
        # -4/B (not -2/B) through f only; Tf gets no gradient; B global
        operator_f = (-4.0 / (ctx.batch * n)) * torch.einsum(
            "l,bl...->bl...", vector_mask, Tf)
        metric_f1 = (2.0 / (f1.shape[0] * n)) * torch.einsum(
            "lm,lm,bl...->bm...", matrix_mask, lam_f2, f1)
        metric_f2 = (2.0 / (f2.shape[0] * n)) * torch.einsum(
            "lm,lm,bl...->bm...", matrix_mask, lam_f1, f2)
        return (g * operator_f, None, g * metric_f1, g * metric_f2, None, None,
                None)


def nestedlora_evd_loss(f, Tf, f1, f2, vector_mask, matrix_mask, axis_name=None):
    """NestedLoRA EVD loss (operator term + metric term)."""
    return NestedLoRAEVDLoss.apply(f, Tf, f1, f2, vector_mask, matrix_mask,
                                   axis_name)


# ---------------------------------------------------------------------------
# SVD (non-self-adjoint operator) loss
# ---------------------------------------------------------------------------

class NestedLoRASVDLoss(torch.autograd.Function):
    """(f, Tg, g, T†f, vector_mask, matrix_mask, axis_name) -> scalar loss.

    f, Tg (B, L) live on the X side, g, T†f on the Y side; the operator
    term is -2·E[Σ_l w_l f_l (Tg)_l] and the metric term takes the grams of
    f and g.  f gets -2/B·w⊙Tg plus its metric gradient, g gets -2/B·w⊙T†f
    plus its own; Tg and T†f get none.
    """

    @staticmethod
    @spanned("loss.forward")
    def forward(ctx, f, Tg, g, Tadjf, vector_mask, matrix_mask, axis_name):
        loss_metric, lam_f, lam_g = compute_loss_metric(f, g, matrix_mask,
                                                        axis_name)
        op = torch.einsum("l,bl,bl->b", vector_mask, f, Tg)
        loss = -2.0 * pmean(op.mean(), axis_name) + loss_metric
        ctx.save_for_backward(f, Tg, g, Tadjf, lam_f, lam_g, vector_mask,
                              matrix_mask)
        ctx.n = axis_size(axis_name)
        return loss

    @staticmethod
    @spanned("loss.backward")
    def backward(ctx, gout):
        f, Tg, g, Tadjf, lam_f, lam_g, vector_mask, matrix_mask = ctx.saved_tensors
        Bf, Bg = f.shape[0] * ctx.n, g.shape[0] * ctx.n
        grad_f = (-2.0 / Bf) * (vector_mask * Tg) + (2.0 / Bf) * torch.einsum(
            "bi,il,il->bl", f, matrix_mask, lam_g)
        grad_g = (-2.0 / Bg) * (vector_mask * Tadjf) + (2.0 / Bg) * torch.einsum(
            "bi,il,il->bl", g, matrix_mask, lam_f)
        return gout * grad_f, None, gout * grad_g, None, None, None, None


def nestedlora_svd_loss(f, Tg, g, Tadjf, vector_mask, matrix_mask, axis_name=None):
    """NestedLoRA SVD loss (operator term + metric term)."""
    return NestedLoRASVDLoss.apply(f, Tg, g, Tadjf, vector_mask, matrix_mask,
                                   axis_name)


# ---------------------------------------------------------------------------
# CDK (canonical dependence kernel, paired samples) loss
# ---------------------------------------------------------------------------

def cdk_inputs(f, g, set_first_mode_const: bool, batch_weights=None):
    """The (f, g) the CDK loss sees: a constant-1 zeroth column in front
    (const mode), then both rows scaled by ``batch_weights`` (B, 1).
    Both results are contiguous."""
    if set_first_mode_const:
        ones = torch.ones((f.shape[0], 1), dtype=f.dtype, device=f.device)
        f = torch.cat([ones, f], dim=1)
        g = torch.cat([ones, g], dim=1)
    if batch_weights is not None:
        f = f * batch_weights
        g = g * batch_weights
    return f.contiguous(), g.contiguous()


def density_ratios(f, g):
    """(rs_joint, rs_indep): diagonal and off-diagonal of the (B, B)
    density-ratio gram f·gᵀ.  8.6 GFLOP and 67 MB at B = 4096, so it is
    computed only on request (diagnostics), never in the hot step."""
    gram = torch.matmul(f, g.T)
    return torch.diagonal(gram).clone(), off_diagonal(gram)


def cdk_backward(f, g, metric_f, metric_g, vector_mask, set_first_mode_const,
                 gout, n: int = 1):
    """Input gradients from the metric gradients (2/B)·f@(M⊙Λg) and
    (2/B)·g@(M⊙Λf): add the operator terms -2/B·w⊙g and -2/B·w⊙f and strip
    the constant column.  B is the global batch, ``n`` times the local."""
    B = f.shape[0] * n
    grad_f = metric_f + (-2.0 / B) * (vector_mask[None, :] * g)
    grad_g = metric_g + (-2.0 / B) * (vector_mask[None, :] * f)
    if set_first_mode_const:
        grad_f = grad_f[:, 1:]
        grad_g = grad_g[:, 1:]
    return gout * grad_f, gout * grad_g


class NestedLoRACDKLoss(torch.autograd.Function):
    """(f, g, vector_mask, matrix_mask, batch_weights, set_first_mode_const,
    return_ratios, axis_name) -> (loss, loss_operator, loss_metric, rs_joint,
    rs_indep).

    Only ``loss`` carries a gradient, as in the reference.  The gradient
    handed to f and g is the one taken at the padded and weighted (f, g):
    nothing chains through ``batch_weights`` (the JAX backward gives them
    zeros).  rs_joint/rs_indep are None unless ``return_ratios``; with a
    group they are the local rows' (B_local, B_local) ratios, as in JAX.
    """

    @staticmethod
    @spanned("loss.forward")
    def forward(ctx, f, g, vector_mask, matrix_mask, batch_weights,
                set_first_mode_const, return_ratios, axis_name):
        f, g = cdk_inputs(f, g, set_first_mode_const, batch_weights)
        loss_metric, lam_f, lam_g = compute_loss_metric(f, g, matrix_mask,
                                                        axis_name)
        op = torch.einsum("l,bl,bl->b", vector_mask, f, g)
        loss_operator = -2.0 * pmean(op.mean(), axis_name)
        loss = loss_operator + loss_metric
        rs = density_ratios(f, g) if return_ratios else (None, None)
        ctx.save_for_backward(f, g, lam_f, lam_g, vector_mask, matrix_mask)
        ctx.set_first_mode_const = set_first_mode_const
        ctx.n = axis_size(axis_name)
        ctx.mark_non_differentiable(loss_operator, loss_metric,
                                    *(r for r in rs if r is not None))
        return loss, loss_operator, loss_metric, *rs

    @staticmethod
    @spanned("loss.backward")
    def backward(ctx, gout, *_):
        f, g, lam_f, lam_g, vector_mask, matrix_mask = ctx.saved_tensors
        B = f.shape[0] * ctx.n
        metric_f = (2.0 / B) * torch.einsum("il,il,bi->bl", matrix_mask, lam_g, f)
        metric_g = (2.0 / B) * torch.einsum("il,il,bi->bl", matrix_mask, lam_f, g)
        grad_f, grad_g = cdk_backward(f, g, metric_f, metric_g, vector_mask,
                                      ctx.set_first_mode_const, gout, ctx.n)
        return grad_f, grad_g, None, None, None, None, None, None


def nestedlora_cdk_loss(set_first_mode_const, f, g, vector_mask, matrix_mask,
                        batch_weights=None, return_ratios: bool = False,
                        axis_name=None):
    """NestedLoRA loss for the canonical dependence kernel p(x,y)/p(x)p(y)
    from paired samples: -2·E[fᵀ(M)g] operator term plus the masked metric
    term of the two marginal grams.  ``vector_mask``/``matrix_mask`` have
    L+1 entries in const mode."""
    return NestedLoRACDKLoss.apply(f, g, vector_mask, matrix_mask,
                                   batch_weights, set_first_mode_const,
                                   return_ratios, axis_name)
