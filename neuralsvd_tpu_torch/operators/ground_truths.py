"""Closed-form spectra and eigenfunctions — the validation oracles.

Copy of ``neuralsvd_tpu/operators/ground_truths.py`` (pure numpy/scipy,
host code): ``InfiniteWell2D`` (:38), ``HarmonicOscillator``,
``Hydrogen2D``, ``Hydrogen3D`` with its eigenfunctions (:126-160), the
real spherical harmonics ``real_sph_harm_3d``, ``legendre_p``, the
hyperspherical harmonics ``sph_harm`` and ``real_sph_harm``, and
``cartesian_to_spherical`` (:163-231).
"""
from __future__ import annotations

import numpy as np
from scipy.special import binom, gamma, gammaln, genlaguerre, hyp1f1, hyp2f1, lpmv


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

    def eigfunc(self, n, l, m, r, th, phi):
        a0 = 2 / self.charge
        rho = 2 * r / (n * a0)
        radial = (np.sqrt((2 / (n * a0)) ** 3 / (2 * n))
                  * rho ** l
                  * np.exp(0.5 * (-rho + gammaln(n - l) - gammaln(n + l + 1)))
                  * genlaguerre(n - l - 1, 2 * l + 1)(rho))
        return radial * real_sph_harm_3d(m, l, th, phi)


def real_sph_harm_3d(m, l, th, phi):
    """Real spherical harmonics Y_lm(θ, φ) via associated Legendre lpmv."""
    am = abs(m)
    norm = np.sqrt((2 * l + 1) / (4 * np.pi)
                   * np.exp(gammaln(l - am + 1) - gammaln(l + am + 1)))
    P = lpmv(am, l, np.cos(th))
    if m == 0:
        return norm * P
    if m > 0:
        return np.sqrt(2) * norm * P * np.cos(am * phi)
    return np.sqrt(2) * norm * P * np.sin(am * phi)


def legendre_p(mu, lam, z):
    """Legendre function of the first kind P^μ_λ(z) for |1 − z| < 2.

    Hypergeometric representation (DLMF 14.3.1):
    P^μ_λ(z) = ((1+z)/(1−z))^{μ/2} · ₂F₁(−λ, λ+1; 1−μ; (1−z)/2) / Γ(1−μ).
    Needed for non-integer degree/order in the hyperspherical recursion.
    """
    return (((1 + z) / (1 - z)) ** (mu / 2)
            * hyp2f1(-lam, lam + 1, 1 - mu, (1 - z) / 2) / gamma(1 - mu))


def sph_harm(ells, ths):
    """Hyperspherical harmonic on S^{D−1} (complex), D = len(ells) + 1.

    ``ells = [l_1, …, l_{D−1}]`` with |l_1| ≤ l_2 ≤ … ≤ l_{D−1}; ``ths`` is
    an array (D−1, n) of angles, ths[0] azimuthal.  Built as the standard
    product of normalized Gegenbauer/Legendre factors (Avery's construction;
    capability parity with reference ground_truths.py:218-256):

      Y = e^{i l_1 θ_1}/√(2π) · Π_{j=2}^{D−1} ⱼP̄_{l_j}^{l_{j−1}}(θ_j)

    where ⱼP̄_l^m(θ) = √[(2l+j−1)/2 · Γ(l+m+j−1)/Γ(l−m+1)]
                       · sin^{(2−j)/2}θ · P^{−(m+(j−2)/2)}_{l+(j−2)/2}(cos θ).
    """
    ells = np.asarray(ells)
    ths = np.atleast_2d(np.asarray(ths))
    if len(ells) != ths.shape[0]:
        raise ValueError(f"{len(ells)} degrees for {ths.shape[0]} angles")
    if (len(ells) > 1 and abs(ells[0]) > ells[1]) or np.any(np.diff(ells[1:]) < 0):
        raise ValueError(f"degrees {ells.tolist()} are not |l_1| <= l_2 <= ... <= l_(D-1)")

    out = np.exp(1j * ells[0] * ths[0]) / np.sqrt(2 * np.pi)
    for idx in range(1, len(ells)):
        j = idx + 1  # factor index in the recursion, j = 2..D-1
        m, l, th = ells[idx - 1], ells[idx], ths[idx]
        if j == 2:  # ordinary associated Legendre, integer order
            norm = np.sqrt((2 * l + 1) / 2
                           * np.exp(gammaln(l + m + 1) - gammaln(l - m + 1)))
            out = out * norm * lpmv(-m, l, np.cos(th))
        else:
            norm = np.sqrt((2 * l + j - 1) / 2
                           * np.exp(gammaln(l + m + j - 1) - gammaln(l - m + 1)))
            out = out * (norm * np.sin(th) ** ((2 - j) / 2)
                         * legendre_p(-(m + (j - 2) / 2), l + (j - 2) / 2,
                                      np.cos(th)))
    return out


def real_sph_harm(ells, ths):
    """Real form of :func:`sph_harm` (reference ground_truths.py:259-270)."""
    ells = np.asarray(ells).copy()
    positive = ells[0] > 0
    ells[0] = -abs(ells[0])
    ys = sph_harm(ells, ths)
    if ells[0] == 0:
        return ys.real
    sign = 1 if ells[0] % 2 == 0 else -1
    return np.sqrt(2) * sign * (ys.imag if positive else ys.real)


def cartesian_to_polar(x, y):
    return np.sqrt(x * x + y * y), np.arctan2(y, x)


def cartesian_to_spherical(x, y, z):
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    th = np.arctan2(np.sqrt(x ** 2 + y ** 2), z)
    phi = np.arctan2(y, x)
    return r, th, phi
