"""Nesting masks for the NestedLoRA objective (copy of neuralsvd_tpu/ops/masks.py).

The "nested" low-rank approximation sums the LoRA objective over prefixes
{f_1..f_l} of the learned modes.  Collapsing that sum yields a per-mode
vector mask w (for the operator term) and an (L, L) matrix mask
M[l, m] = min(w_l, w_m) (for the metric term).  Two nesting schemes:

- *joint*: prefix weights accumulate; vector mask is a reversed cumulative
  sum of per-prefix weights (reference: methods/nestedlora.py:40-46).
- *sequential*: each mode only sees earlier modes; vector mask is all-ones
  and the matrix mask is upper-triangular (reference: methods/nestedlora.py:49-54).

Masks are static numpy arrays; the loss moves them to its device once.
"""
from __future__ import annotations

import numpy as np


def step_weights(neigs: int, step: int = 1) -> np.ndarray:
    """Uniform weights over prefix end-indices {step, 2*step, ..., neigs}.

    Sub-sampling prefixes with ``step`` > 1 reduces the effective number of
    nested objectives (reference: methods/nestedlora.py:186-192).
    """
    end_indices = list(range(step, neigs + 1, step))
    if neigs not in end_indices:
        end_indices.append(neigs)
    w = np.zeros(neigs, dtype=np.float64)
    w[np.asarray(end_indices) - 1] = 1.0
    return w / w.sum()


def joint_nesting_masks(weights: np.ndarray, set_first_mode_const: bool = False):
    """Joint nesting: vector mask = reversed cumsum of prefix weights.

    Returns (vector_mask (L,), matrix_mask (L, L)) float32 numpy arrays.
    With ``set_first_mode_const`` the constant first mode (used by the CDK
    loss) is prepended with the largest weight.
    """
    vector_mask = list(np.cumsum(list(weights)[::-1])[::-1])
    if set_first_mode_const:
        vector_mask = [vector_mask[0]] + vector_mask
    vector_mask = np.asarray(vector_mask, dtype=np.float32)
    matrix_mask = np.minimum(vector_mask[:, None], vector_mask[None, :]).astype(np.float32)
    return vector_mask, matrix_mask


def sequential_nesting_masks(L: int, set_first_mode_const: bool = False):
    """Sequential nesting: all-ones vector mask, upper-triangular matrix mask."""
    if set_first_mode_const:
        L += 1
    vector_mask = np.ones(L, dtype=np.float32)
    matrix_mask = np.triu(np.ones((L, L), dtype=np.float32))
    return vector_mask, matrix_mask
