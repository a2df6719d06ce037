"""Problem registry: name -> (operator, analytic ground-truth spectrum).

Port of ``neuralsvd_tpu/operators/problems.py:64-163``: the ``sch`` branch
with every potential (``infinite_well``, ``harmonic_oscillator``,
``cosine`` (Han, Lu & Zhou (2020) constants and eigenvalues, copied),
``hydrogen``, ``hydrogen_mol_ion`` and ``quantum_chemistry``) and the
Fokker–Planck problem ``fp`` in 1, 2, 5 or 10 dimensions (its constants
``_FP_CS`` copied), scaled by ``scale_operator``.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from neuralsvd_tpu_torch.operators.base import DeviceConstant, OperatorWrapper
from neuralsvd_tpu_torch.operators.fokker_planck import (
    NegativeLinearFokkerPlanck,
    sin_of_cos_potential,
)
from neuralsvd_tpu_torch.operators.ground_truths import (
    HarmonicOscillator,
    Hydrogen2D,
    Hydrogen3D,
    InfiniteWell2D,
)
from neuralsvd_tpu_torch.operators.molecule import Molecule
from neuralsvd_tpu_torch.operators.schrodinger import (
    NegativeHamiltonian,
    cosine_potential,
    harmonic_oscillator_potential,
    hydrogen_mol_ion_potential,
    hydrogen_potential,
    infinite_well_potential,
    local_potential_energy,
)

# Han, Lu & Zhou (2020) literature eigenvalues, in the negated Schrödinger
# convention (neuralsvd_tpu/operators/problems.py:36-55)
_COSINE_2D_CS = [0.814723686393179, 0.905791937075619]
_COSINE_2D_EIGVALS = [
    -0.591624518674115, 0.623365592493771, 0.662887867122419,
    0.891545971509540, 0.982541637674317,
    1.877877978290306, 2.146058357306075, 2.197531748842203,
    2.465712127857973, 3.699555061533076,
    3.701057706578779, 3.756708397099993, 3.758994296902169,
    4.954067447329610, 4.955570092375313,
    4.971698508267879, 4.973984408070056, 5.239878887283648,
    5.242164787085825, 5.273721217881508,
    5.275223862927211, 8.047887977307184, 8.049390622352888,
    8.050173877109360, 8.051676522155063,
]
_COSINE_5D_CS = [0.162944737278636, 0.181158387415124, 0.025397363258701,
                 0.182675171227804, 0.126471849245082]
_COSINE_10D_CS = _COSINE_5D_CS + [0.019508080999882, 0.055699643773410,
                                  0.109376303840997, 0.191501367086860,
                                  0.192977707039855]
# the Fokker–Planck potential's constants by dimension
# (neuralsvd_tpu/operators/problems.py:56-61)
_FP_CS = {
    1: [1.0],
    2: [1.0, 1.0],
    5: [1.0, 0.8, 0.6, 0.4, 0.2],
    10: [0.1, 0.3, 0.2, 0.5, 0.2, 0.1, 0.3, 0.4, 0.2, 0.2],
}


def get_problem(
    problem: str = "sch",
    potential_type: str = "hydrogen",
    ndim: int = 2,
    neigs: int = 16,
    lim: float = 16.0,
    charge: float = 1.0,
    hydrogen_mol_ion_R: float = 1.0,
    mol_name: Optional[str] = None,
    laplacian_eps: float = 0.1,
    laplacian_mode: str = "forward",
    laplacian_probes: int = 0,
    operator_scale: float = 1.0,
    operator_shift: float = 0.0,
    scale_operator: float = 1.0,
):
    """Build (operator, ground_truth_spectrum, n_particles).

    ``ground_truth_spectrum`` is already transformed by the same affine
    spectral map as the operator (None where there is no closed form).
    """
    ground_truth = None
    n_particles = 1
    if problem == "fp":
        if ndim not in _FP_CS:
            raise ValueError(f"the Fokker–Planck problem has no constants for ndim {ndim}")
        operator = NegativeLinearFokkerPlanck(
            local_potential_ftn=partial(sin_of_cos_potential, cs=DeviceConstant(_FP_CS[ndim])),
            scale=scale_operator, laplacian_eps=laplacian_eps,
            laplacian_mode=laplacian_mode)
        return _wrap(operator, np.zeros(neigs), n_particles, operator_scale,
                     operator_shift)
    if problem != "sch":
        raise NotImplementedError(problem)
    scale_kinetic = 1.0
    if potential_type == "infinite_well":
        assert ndim == 2
        pot = infinite_well_potential
        ground_truth = -InfiniteWell2D(L=2 * lim).get_eigvals(neigs)
    elif potential_type == "harmonic_oscillator":
        pot = partial(harmonic_oscillator_potential, k=1.0)
        ground_truth = -HarmonicOscillator(k=1.0, ndim=ndim).get_eigvals(neigs)
    elif potential_type == "cosine":
        assert ndim in (1, 2, 5, 10)
        if ndim == 1:
            cs = [1.0]
        elif ndim == 2:
            # 25 published eigenvalues; more modes train as guards
            cs = _COSINE_2D_CS
            ground_truth = -np.asarray(_COSINE_2D_EIGVALS[:min(neigs, 25)])
        elif ndim == 5:
            cs = _COSINE_5D_CS
            ground_truth = np.asarray([0.054018930536326] + [0.0] * (neigs - 1))
        else:
            cs = _COSINE_10D_CS
            ground_truth = np.asarray([0.098087448866409] + [0.0] * (neigs - 1))
        pot = partial(cosine_potential, cs=DeviceConstant(cs))
    elif potential_type == "hydrogen":
        pot = partial(hydrogen_potential, charge=charge)
        if ndim == 2:
            ground_truth = -Hydrogen2D(charge=charge).get_eigvals(neigs)
        elif ndim == 3:
            ground_truth = -Hydrogen3D(charge=charge).get_eigvals(neigs)
    elif potential_type == "hydrogen_mol_ion":
        pot = partial(hydrogen_mol_ion_potential, R=hydrogen_mol_ion_R,
                      charge=2 * charge)
    elif potential_type == "quantum_chemistry":
        assert ndim in (2, 3)
        mol = Molecule.from_name(mol_name)
        pot = partial(local_potential_energy,
                      coords=DeviceConstant(mol.coords[:, :ndim]),
                      charges=DeviceConstant(mol.charges),
                      pairs=DeviceConstant(np.stack(np.triu_indices(mol.n_electrons, k=1))))
        n_particles = mol.n_electrons
        scale_kinetic = 0.5
    else:
        raise NotImplementedError(potential_type)
    operator = NegativeHamiltonian(
        local_potential_ftn=pot, scale_kinetic=scale_kinetic,
        laplacian_eps=laplacian_eps, laplacian_mode=laplacian_mode,
        laplacian_probes=laplacian_probes, n_particles=n_particles)
    # the spectrum eval zeroes T(phi) at x == 0 only for potentials that
    # are singular there
    operator.singular_at_origin = potential_type in ("hydrogen", "quantum_chemistry")
    return _wrap(operator, ground_truth, n_particles, operator_scale, operator_shift)


def _wrap(operator, ground_truth, n_particles, operator_scale, operator_shift):
    """The affine spectral map on the operator and on its ground truth."""
    operator = OperatorWrapper(operator, scale=operator_scale, shift=operator_shift)
    if ground_truth is not None:
        ground_truth = operator_scale * ground_truth + operator_shift
    return operator, ground_truth, n_particles
