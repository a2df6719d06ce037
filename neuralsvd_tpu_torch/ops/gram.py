"""Gram/covariance contractions — the O(B·L²) core of every loss.

Port of ``neuralsvd_tpu/ops/gram.py`` (``compute_lambda``, ``compute_gram``,
``compute_loss_metric``, ``global_batch_size``, ``off_diagonal``).
Contractions run in float32; on the GPU
``torch.backends.cuda.matmul.allow_tf32`` must stay False (PyTorch's
default) or eigenvalue estimates degrade the way bf16 grams do on the TPU.

Every gram takes ``axis_name``: a data-parallel process group
(parallel/collectives.py) or None.  With a group the grams of the local
rows are averaged over its ranks, so each rank sees the statistics of the
global batch (equal local batches).
"""
from __future__ import annotations

import torch

from neuralsvd_tpu_torch.parallel.collectives import axis_size, pmean


def global_batch_size(local_batch: int, axis_name=None) -> int:
    """The global batch over the ranks of ``axis_name``."""
    return local_batch * axis_size(axis_name)


def compute_gram(f: torch.Tensor, g: torch.Tensor | None = None,
                 axis_name=None) -> torch.Tensor:
    """E[f gᵀ] cross-gram over the (global) batch: (B, L[, O]) x (B, L[, O])
    -> (L, L); g defaults to f (NeuralEF's coefficients,
    methods/neuralef.py)."""
    if g is None:
        g = f
    return pmean(torch.einsum("bl...,bm...->lm", f, g) / f.shape[0], axis_name)


def compute_lambda(f: torch.Tensor, axis_name=None) -> torch.Tensor:
    """E[f fᵀ] gram over the (global) batch: (B, L[, O]) -> (L, L)."""
    return compute_gram(f, axis_name=axis_name)


def compute_loss_metric(f1: torch.Tensor, f2: torch.Tensor,
                        matrix_mask: torch.Tensor, axis_name=None):
    """Masked metric loss  Σ_{lm} M_{lm} Λf1_{lm} Λf2_{lm}  plus the two grams.

    f1 and f2 must be *independent* sample groups.
    """
    lam_f1 = compute_lambda(f1, axis_name)
    lam_f2 = compute_lambda(f2, axis_name)
    loss = torch.sum(matrix_mask * lam_f1 * lam_f2)
    return loss, lam_f1, lam_f2


def off_diagonal(x: torch.Tensor) -> torch.Tensor:
    """Flattened off-diagonal entries of a square matrix (batched)."""
    n, m = x.shape[-2], x.shape[-1]
    if n != m:
        raise ValueError("off_diagonal expects a square matrix")
    batch_shape = x.shape[:-2]
    flat = x.reshape(*batch_shape, n * n)[..., :-1]
    return flat.reshape(*batch_shape, n - 1, n + 1)[..., 1:].reshape(
        *batch_shape, -1)
