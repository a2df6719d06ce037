"""Subspace and alignment linear algebra for evaluation.

Port of ``neuralsvd_tpu/utils/linalg.py`` (numpy and scipy, the port's own
copy).
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import sqrtm


def subspace_distance(A1: np.ndarray, A2: np.ndarray) -> float:
    """1 - tr(P1 P2)/k with Pi the column-space projectors of the (d, k) Ai."""
    k = A1.shape[1]
    P1 = A1 @ np.linalg.inv(A1.T @ A1) @ A1.T
    return 1 - np.trace(A2.T @ P1 @ A2 @ np.linalg.inv(A2.T @ A2)) / k


def rotate(U: np.ndarray, V: np.ndarray, start: int, end: int) -> np.ndarray:
    """Project U's block onto the orthonormalized span of V's block."""
    U_ = U[:, start:end]
    V_ = V[:, start:end]
    Vhat = V_ @ np.linalg.inv(sqrtm(V_.T @ V_))
    return Vhat @ (Vhat.T @ U_)


def procrustes(A: np.ndarray, Ahat: np.ndarray, start: int, end: int):
    """Optimal orthogonal alignment of the learned Ahat block to A's block."""
    A_ = A[:, start:end]
    Ahat_ = Ahat[:, start:end]
    U, _, Vt = np.linalg.svd(Ahat_.T @ A_)
    return Ahat_ @ (U @ Vt)
