"""Schrödinger Hamiltonians and potentials.

Port of ``neuralsvd_tpu/operators/schrodinger.py``: ``hydrogen_potential``
(:21), ``harmonic_oscillator_potential`` and ``NegativeHamiltonian``
(:82-113), whose ``needs_key`` operators (the Hutchinson Laplacian) take
a ``generator=`` where JAX's take ``key=``.  The other potentials are
not ported yet (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from neuralsvd_tpu_torch.operators.diff_ops import VectorizedLaplacian


def hydrogen_potential(x, charge: float = 1.0):
    """V(r) = -Z/|r|; x: (B, n_particles, D) or (B, D). Returns (B, 1)."""
    x = x.reshape(x.shape[0], -1)
    return -(charge / torch.linalg.vector_norm(x, dim=-1)).reshape(-1, 1)


def harmonic_oscillator_potential(x, k: float = 1.0):
    x = x.reshape(x.shape[0], -1)
    return (k * torch.sum(x ** 2, dim=-1)).reshape(-1, 1)


class NegativeHamiltonian:
    """-H f = -(-scale_kinetic ∇²f + V(x) f).

    Negated so the top eigenvalues are the lowest-energy states.  Returns
    (Tf, fs): Tf carries no autograd graph (the EVD loss sends no gradient
    through it); fs does.
    """

    def __init__(self, local_potential_ftn: Callable,
                 scale_kinetic: float = 1.0, laplacian_eps: float = 1e-5,
                 laplacian_mode: str = "forward", n_particles: int = 1,
                 laplacian_probes: int = 0):
        self.laplacian = VectorizedLaplacian(eps=laplacian_eps,
                                             exact_mode=laplacian_mode,
                                             num_probes=laplacian_probes)
        self.local_potential_ftn = local_potential_ftn
        self.scale_kinetic = scale_kinetic
        self.n_particles = n_particles

    @property
    def needs_key(self) -> bool:
        """True when the Laplacian is the stochastic Hutchinson estimator:
        the train step then binds a probe generator; the spectrum eval
        passes none and gets the exact engine."""
        return self.laplacian.needs_key

    def __call__(self, f, xs, importance: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        lap, _, fs = self.laplacian(f, xs, importance, generator=generator)
        with torch.no_grad():
            kinetic = -self.scale_kinetic * lap
            V = self.local_potential_ftn(
                xs.reshape(xs.shape[0], self.n_particles, -1)).reshape(-1, 1)
            hamiltonian = kinetic + V * fs
        return -hamiltonian, fs
