"""Molecule database for the quantum-chemistry potentials.

Copy of ``neuralsvd_tpu/operators/molecule.py`` (numpy only): standard
literature geometries (angstrom unless noted), converted to Bohr, and
``Molecule.from_name``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ANGSTROM = 1 / 0.52917721092  # bohr per angstrom

# name -> (coords_angstrom, charges, total_charge, spin)
_SYSTEMS = {
    "H": ([[0.0, 0.0, 0.0]], [1], 0, 1),
    "H2+": ([[-0.52918, 0.0, 0.0], [0.52918, 0.0, 0.0]], [1, 1], 1, 1),
    "H2": ([[0.0, 0.0, 0.0], [0.742, 0.0, 0.0]], [1, 1], 0, 0),
    "He": ([[0.0, 0.0, 0.0]], [2], 0, 0),
    "Li": ([[0.0, 0.0, 0.0]], [3], 0, 1),
    "Be": ([[0.0, 0.0, 0.0]], [4], 0, 0),
    "B": ([[0.0, 0.0, 0.0]], [5], 0, 1),
    "C": ([[0.0, 0.0, 0.0]], [6], 0, 2),
    "N": ([[0.0, 0.0, 0.0]], [7], 0, 1),
    "O": ([[0.0, 0.0, 0.0]], [8], 0, 0),
    "LiH": ([[0.0, 0.0, 0.0], [1.595, 0.0, 0.0]], [3, 1], 0, 0),
    "Li2": ([[-1.3364, 0.0, 0.0], [1.3364, 0.0, 0.0]], [3, 3], 0, 0),
    "Be2": ([[-1.230, 0.0, 0.0], [1.230, 0.0, 0.0]], [4, 4], 0, 0),
    "BeH": ([[0.0, 0.0, 0.0], [1.326903, 0.0, 0.0]], [4, 1], 0, 1),
    "BH": ([[0.0, 0.0, 0.0], [0.0, 0.0, 1.222874]], [5, 1], 0, 0),
    "CH+": ([[0.0, 0.0, 0.0], [1.13092, 0.0, 0.0]], [6, 1], 1, 0),
    "CO": ([[0.0, 0.0, -0.661165], [0.0, 0.0, 0.472379]], [6, 8], 0, 0),
    "CO2": ([[-1.161, 0.0, 0.0], [0.0, 0.0, 0.0], [1.161, 0.0, 0.0]],
            [8, 6, 8], 0, 0),
    "H2O": ([[0.0, 0.0, -0.069903],
             [0.0, 0.757532, 0.518435],
             [0.0, -0.757532, 0.518435]], [8, 1, 1], 0, 0),
    "NH3": ([[0.067759, 0.0, 0.0],
             [-0.313823, 0.468746, -0.811891],
             [-0.313823, -0.937491, 0.0],
             [-0.313823, 0.468746, 0.811891]], [7, 1, 1, 1], 0, 0),
}


@dataclass
class Molecule:
    """Atom coordinates (Bohr), charges, net charge and spin multiplicity."""

    coords: np.ndarray
    charges: np.ndarray
    charge: int = 0
    spin: int = 0

    def __post_init__(self):
        self.coords = np.asarray(self.coords, dtype=np.float64)
        self.charges = np.asarray(self.charges, dtype=np.float64)
        assert len(self.coords) == len(self.charges)

    @property
    def n_electrons(self) -> int:
        return int(self.charges.sum() - self.charge)

    def __len__(self):
        return len(self.charges)

    @classmethod
    def from_name(cls, name: str, **kwargs) -> "Molecule":
        if name in _SYSTEMS:
            coords, charges, charge, spin = _SYSTEMS[name]
            return cls(np.asarray(coords) * ANGSTROM, charges, charge, spin)
        if name == "Hn":
            n, dist = kwargs["n"], kwargs["dist"]
            coords = np.zeros((n, 3))
            coords[:, 0] = np.arange(n) * dist  # dist given in Bohr
            return cls(coords, np.ones(n), 0, n % 2)
        if name == "H4_rect":
            dist = kwargs["dist"]  # Bohr; transverse offset 0.635 A standard
            dy = 0.635 * ANGSTROM
            coords = np.array([[-dist / 2, -dy, 0], [dist / 2, dy, 0],
                               [-dist / 2, dy, 0], [dist / 2, -dy, 0]])
            return cls(coords, np.ones(4), 0, 0)
        raise KeyError(f"unknown molecule: {name}")

    all_names = frozenset(_SYSTEMS.keys())
