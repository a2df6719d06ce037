"""Problem registry: name -> (operator, analytic ground-truth spectrum).

Port of the ``sch`` branch of ``neuralsvd_tpu/operators/problems.py:64-163``
for the ``hydrogen`` and ``harmonic_oscillator`` potentials.  The other
potentials and the Fokker–Planck problem are not ported yet (ROADMAP
queue 1, items 6 and 13).
"""
from __future__ import annotations

from functools import partial

from neuralsvd_tpu_torch.operators.base import OperatorWrapper
from neuralsvd_tpu_torch.operators.ground_truths import (
    HarmonicOscillator,
    Hydrogen2D,
)
from neuralsvd_tpu_torch.operators.schrodinger import (
    NegativeHamiltonian,
    harmonic_oscillator_potential,
    hydrogen_potential,
)


def get_problem(
    problem: str = "sch",
    potential_type: str = "hydrogen",
    ndim: int = 2,
    neigs: int = 16,
    charge: float = 1.0,
    laplacian_eps: float = 0.1,
    laplacian_mode: str = "forward",
    laplacian_probes: int = 0,
    operator_scale: float = 1.0,
    operator_shift: float = 0.0,
):
    """Build (operator, ground_truth_spectrum, n_particles).

    ``ground_truth_spectrum`` is already transformed by the same affine
    spectral map as the operator (None where no closed form is ported).
    """
    if problem != "sch":
        raise NotImplementedError(
            f"problem {problem!r} is not ported yet (ROADMAP queue 1, item 13)")
    ground_truth = None
    if potential_type == "harmonic_oscillator":
        pot = partial(harmonic_oscillator_potential, k=1.0)
        ground_truth = -HarmonicOscillator(k=1.0, ndim=ndim).get_eigvals(neigs)
    elif potential_type == "hydrogen":
        pot = partial(hydrogen_potential, charge=charge)
        if ndim == 2:
            ground_truth = -Hydrogen2D(charge=charge).get_eigvals(neigs)
    else:
        raise NotImplementedError(
            f"potential {potential_type!r} is not ported yet "
            "(ROADMAP queue 1, item 6)")
    operator = NegativeHamiltonian(
        local_potential_ftn=pot, scale_kinetic=1.0,
        laplacian_eps=laplacian_eps, laplacian_mode=laplacian_mode,
        laplacian_probes=laplacian_probes, n_particles=1)
    # the spectrum eval zeroes T(phi) at x == 0 only for potentials that
    # are singular there
    operator.singular_at_origin = potential_type == "hydrogen"
    operator = OperatorWrapper(operator, scale=operator_scale,
                               shift=operator_shift)
    if ground_truth is not None:
        ground_truth = operator_scale * ground_truth + operator_shift
    return operator, ground_truth, 1
