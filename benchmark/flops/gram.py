"""Bytes and float32 operations of the NestedLoRA gram work, from its shapes.

The gram work of one loss evaluation, whatever kernels do it:

- K1, the masked gram pair: reads f1, f2 (Bh x L each) and M (L x L);
  writes the loss, Λ1, Λ2, M⊙Λ1 and M⊙Λ2.  Λ1 and Λ2 are symmetric, so
  each needs only its L(L+1)/2 distinct entries, 2·Bh operations each (a
  SYRK); the masked sum and the two masked copies are 3·L² more.
- K2, the weighted operator dot Σ_bl w_l a_bl b_bl: reads a, b (Bd x L)
  and w (L); writes one number; 3·Bd·L operations.
- K3, the metric gradients s1·f1 (M⊙Λ2) and s2·f2 (M⊙Λ1): reads f1, f2
  and the two masked grams, writes two (Bh x L) results; 2·2·Bh·L²
  operations for the products, 2·Bh·L for the scales.

Each input byte is counted as read once and each output byte as written
once (float32: 4 bytes).  ``bound_s`` is the least time the chip could
take: the larger of the bytes at the memory's peak and the operations at
the float32 peak.
"""
from __future__ import annotations


def masked_gram_pair(Bh: int, L: int) -> tuple:
    """(bytes, operations) of K1 on two (Bh, L) halves."""
    return 4 * (2 * Bh * L + L * L + 1 + 4 * L * L), 2 * Bh * L * (L + 1) + 3 * L * L


def weighted_dot(Bd: int, L: int) -> tuple:
    """(bytes, operations) of K2 on two (Bd, L) operands."""
    return 4 * (2 * Bd * L + L + 1), 3 * Bd * L


def metric_grads(Bh: int, L: int) -> tuple:
    """(bytes, operations) of K3 on two (Bh, L) halves."""
    return 4 * (2 * Bh * L + 2 * L * L + 2 * Bh * L), 2 * 2 * Bh * L * L + 2 * Bh * L


def bound_s(work, bytes_per_s: float, flops_per_s: float) -> float:
    """Seconds the gram work ``[(bytes, operations), ...]`` needs at the
    least: each part bounded by its bytes or its operations, the larger."""
    return sum(max(b / bytes_per_s, ops / flops_per_s) for b, ops in work)
