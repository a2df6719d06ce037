"""Operator protocol helpers.

Port of ``neuralsvd_tpu/operators/base.py:7-37`` (``OperatorWrapper``);
``generator=`` takes the place of JAX's ``key=``.
``MatrixOperator`` and ``KernelOperator`` are not ported yet (ROADMAP
queue 1, item 6).
"""
from __future__ import annotations

import torch


class OperatorWrapper:
    """Affine spectral transform ``T -> scale*T + shift*I``.

    Shifts/scales the spectrum so the top-L eigenvalues are positive and
    well separated.  The ``shift·fs`` term joins Tf without a gradient, like
    the rest of Tf.
    """

    def __init__(self, operator, scale: float = 1.0, shift: float = 0.0):
        self.operator = operator
        self.scale = scale
        self.shift = shift

    @property
    def singular_at_origin(self) -> bool:
        """Forwarded from the wrapped operator (the spectrum eval zeroes
        T(phi) at the origin only for singular potentials)."""
        return getattr(self.operator, "singular_at_origin", False)

    @property
    def needs_key(self) -> bool:
        """Forwarded: True for stochastic operators (the Hutchinson
        Laplacian), which want a probe generator bound by the train step."""
        return getattr(self.operator, "needs_key", False)

    def __call__(self, f, x, importance=None, generator=None):
        if generator is not None and self.needs_key:
            Tf, fs = self.operator(f, x, importance, generator=generator)
        else:
            Tf, fs = self.operator(f, x, importance)
        with torch.no_grad():
            Tf = self.scale * Tf + self.shift * fs
        return Tf, fs
