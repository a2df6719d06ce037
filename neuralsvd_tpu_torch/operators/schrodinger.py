"""Schrödinger Hamiltonians and potentials.

Port of ``neuralsvd_tpu/operators/schrodinger.py``: the potentials
(:21-78: hydrogen, the H2+ ion, the infinite well, the oscillator, the
cosine and the quantum-chemistry local energy) and ``NegativeHamiltonian``
(:82-113), whose ``needs_key`` operators (the Hutchinson Laplacian) take
a ``generator=`` where JAX's take ``key=``.  The potentials are evaluated
under ``torch.no_grad()`` outside the Laplacian engine; a constant array
(``cs``, ``coords``, ``charges``, the electron pairs) goes to float32 (the
pairs to int64) on the input's device, as the JAX package's float32
arrays; ``get_problem`` hands each as a ``base.DeviceConstant``, which
makes that tensor once, so that a captured train step copies nothing
from the host.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from neuralsvd_tpu_torch.operators.base import device_constant, graph_mode
from neuralsvd_tpu_torch.operators.diff_ops import VectorizedLaplacian
from neuralsvd_tpu_torch.utils.tracing import spanned


def hydrogen_potential(x, charge: float = 1.0):
    """V(r) = -Z/|r|; x: (B, n_particles, D) or (B, D). Returns (B, 1)."""
    x = x.reshape(x.shape[0], -1)
    return -(charge / torch.linalg.vector_norm(x, dim=-1)).reshape(-1, 1)


def hydrogen_mol_ion_potential(x, R: float, charge: float = 2.0):
    """H2+ two-center Coulomb; nuclei at ±R along the last axis."""
    x = x.reshape(x.shape[0], -1)
    e = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
    e[-1] = 1.0
    return (hydrogen_potential(x - R * e, charge)
            + hydrogen_potential(x + R * e, charge))


def infinite_well_potential(x):
    return torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)


def harmonic_oscillator_potential(x, k: float = 1.0):
    x = x.reshape(x.shape[0], -1)
    return (k * torch.sum(x ** 2, dim=-1)).reshape(-1, 1)


def cosine_potential(x, cs):
    x = x.reshape(x.shape[0], -1)
    return torch.sum(torch.cos(x) * device_constant(cs, x)[None, :], dim=-1).reshape(-1, 1)


def nuclear_energy(coords, charges):
    """Σ_{i<j} Z_i Z_j / |R_i - R_j| over the nuclei (a scalar tensor)."""
    diff = coords[:, None, :] - coords[None, :, :]
    dists = torch.linalg.vector_norm(diff, dim=-1)
    coulombs = charges[:, None] * charges[None, :] / torch.where(
        dists > 0, dists, torch.ones_like(dists))
    return torch.sum(torch.triu(coulombs, diagonal=1))


def nuclear_potential(rs, coords, charges):
    """-Σ_{e,a} Z_a / |r_e - R_a|; rs (B, n_electrons, D) -> (B,)."""
    dists = torch.linalg.vector_norm(
        rs[:, :, None, :] - coords[None, None, :, :], dim=-1)
    return -torch.sum(charges / dists, dim=(-1, -2))


def electronic_potential(rs, pairs=None):
    """Σ_{i<j} 1 / |r_i - r_j| over the electrons; (B, n, D) -> (B,).
    ``pairs``: the (2, n(n-1)/2) indices i < j (default: made here)."""
    if pairs is None:
        pairs = np.stack(np.triu_indices(rs.shape[-2], k=1))
    i, j = device_constant(pairs, rs, torch.int64)
    dists = torch.linalg.vector_norm(rs[:, i, :] - rs[:, j, :], dim=-1)
    return torch.sum(1.0 / dists, dim=-1)


def local_potential_energy(rs, coords, charges, pairs=None):
    """The molecule's potential energy at electron positions rs, (B, 1)."""
    coords, charges = device_constant(coords, rs), device_constant(charges, rs)
    return (nuclear_energy(coords, charges)
            + nuclear_potential(rs, coords, charges)
            + electronic_potential(rs, pairs)).reshape(-1, 1)


class NegativeHamiltonian:
    """-H f = -(-scale_kinetic ∇²f + V(x) f).

    Negated so the top eigenvalues are the lowest-energy states.  Returns
    (Tf, fs): fs carries its autograd graph, and Tf only with
    ``with_graph=True`` (SpIN, SpINx; the EVD losses send no gradient
    through it).
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

    @spanned("op.apply")
    def __call__(self, f, xs, importance: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 with_graph: bool = False):
        lap, _, fs = self.laplacian(f, xs, importance, generator=generator,
                                    with_graph=with_graph)
        with torch.no_grad():
            V = self.local_potential_ftn(
                xs.reshape(xs.shape[0], self.n_particles, -1)).reshape(-1, 1)
        with graph_mode(with_graph):
            kinetic = -self.scale_kinetic * lap
            hamiltonian = kinetic + V * fs
            return -hamiltonian, fs
