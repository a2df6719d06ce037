"""Closed-form spectra and eigenfunctions — the validation oracles.

Copy of ``neuralsvd_tpu/operators/ground_truths.py`` (pure numpy/scipy):
``InfiniteWell2D`` (:38), ``HarmonicOscillator``, ``Hydrogen2D`` and the
eigenvalues of ``Hydrogen3D`` (:126).  Not copied yet (ROADMAP queue 1,
item 6): the 3D hydrogen eigenfunctions and the spherical harmonics
(:151-231).
"""
from __future__ import annotations

import numpy as np
from scipy.special import binom, gammaln, hyp1f1


class ToyProblem:
    def get_eigvals(self, neigs: int) -> np.ndarray:
        raise NotImplementedError

    def eigfunc(self, *args):
        raise NotImplementedError

    def get_degeneracy(self, neigs: int) -> np.ndarray:
        """Cumulative counts of degenerate eigenvalue groups."""
        eigvals = self.get_eigvals(neigs)
        groups = []
        cnt = 1
        for prev, cur in zip(eigvals[:-1], eigvals[1:]):
            if np.isclose(cur, prev):
                cnt += 1
            else:
                groups.append(cnt)
                cnt = 1
        groups.append(cnt)
        return np.cumsum(groups)


class InfiniteWell2D(ToyProblem):
    """Particle in a 2D box of side L: E = (nx²+ny²)π²/L²."""

    def __init__(self, L: float = 1.0):
        self.L = L

    def get_eigvals(self, neigs):
        vals = sorted(nx * nx + ny * ny
                      for nx in range(1, neigs + 1)
                      for ny in range(1, neigs + 1))[:neigs]
        return np.asarray(vals, dtype=np.float64) * np.pi ** 2 / self.L ** 2

    def eigfunc(self, nx, ny, x, y):
        L = self.L
        return 2 / L * np.sin(nx * np.pi * x / L) * np.sin(ny * np.pi * y / L)


class HarmonicOscillator(ToyProblem):
    """d-dim isotropic oscillator: E = sqrt(k)·(2n + d), degeneracy C(d+n-1, n)."""

    def __init__(self, k: float = 1.0, ndim: int = 2):
        self.k = k
        self.ndim = ndim

    def get_eigvals(self, neigs):
        d = self.ndim
        vals = []
        n = 0
        while len(vals) < neigs:
            deg = int(binom(d + n - 1, n))
            vals.extend([2 * n + d] * deg)
            n += 1
        return np.sqrt(self.k) * np.asarray(vals[:neigs], dtype=np.float64)

    def eigfunc(self, nx, ny, x, y, b: float = 1.0):
        assert self.ndim == 2
        return self._eigfunc_1d(nx, x, b) * self._eigfunc_1d(ny, y, b)

    @staticmethod
    def _eigfunc_1d(n, x, b=1.0):
        coeffs = np.zeros(n + 1)
        coeffs[-1] = 1
        herm = np.polynomial.hermite.Hermite(coeffs)
        return (1 / np.sqrt(2 ** n * np.exp(gammaln(n + 1)))
                * (b / np.pi) ** 0.25
                * np.exp(-b * x ** 2 / 2)
                * herm(np.sqrt(b) * x))


class Hydrogen2D(ToyProblem):
    """2D hydrogen: E(n) = -Z²/(4(n+1/2)²), degeneracy 2n+1."""

    def __init__(self, charge: float = 1.0):
        self.charge = charge

    def get_qnums(self, neigs):
        nmax = int(np.ceil(np.sqrt(neigs)))
        qnums = [(n, l) for n in range(nmax + 1) for l in range(-n, n + 1)]
        return qnums[:neigs]

    def get_eigvals(self, neigs):
        ns = []
        n = 0
        while len(ns) < neigs:
            ns.extend([n] * (2 * n + 1))
            n += 1
        ns = np.asarray(ns[:neigs], dtype=np.float64)
        return -self.charge ** 2 / (4 * (ns + 0.5) ** 2)

    def eigfunc(self, n, l, r, th):
        """Radial: confluent hypergeometric 1F1; angular: cos/sin(l·th)."""
        beta = 1 / (n + 0.5)
        al = abs(l)
        radial = np.exp(np.log(beta)
                        - gammaln(2 * al + 1)
                        + 0.5 * (gammaln(n + al + 1) - np.log(2 * n + 1)
                                 - gammaln(n - al + 1))
                        + al * np.log(beta * r + 1e-300)
                        - beta * r / 2) * hyp1f1(-n + al, 2 * al + 1, beta * r)
        if l > 0:
            angular = np.cos(l * th) / np.sqrt(np.pi)
        elif l < 0:
            angular = np.sin(l * th) / np.sqrt(np.pi)
        else:
            angular = 1 / np.sqrt(2 * np.pi)
        return radial * angular


class Hydrogen3D(ToyProblem):
    """3D hydrogen with the reference's convention E(n) = -Z²/(4n²),
    degeneracy n²."""

    def __init__(self, charge: float = 1.0):
        self.charge = charge

    def get_eigvals(self, neigs):
        ns = []
        n = 1
        while len(ns) < neigs:
            ns.extend([n] * (n * n))
            n += 1
        ns = np.asarray(ns[:neigs], dtype=np.float64)
        return -self.charge ** 2 / (4 * ns ** 2)
