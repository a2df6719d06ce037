"""Wavefunction assembly for the PDE experiments.

Port of ``neuralsvd_tpu/models/wavefunctions.py:111-193``:
``wavefunction(x) = hard_mul_const · base_mlp(x)``.  Not ported yet
(ROADMAP queue 1, item 3): the Dirichlet box mask (``apply_boundary``) and
the learnable exponential mask (``apply_exp_mask``); both raise.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from neuralsvd_tpu_torch.device import resolve_device
from neuralsvd_tpu_torch.models.fourier import FourierFeatures
from neuralsvd_tpu_torch.models.mlp import make_mlp_eigfuncs


class Wavefunction(nn.Module):
    """x (B, n_particles, D) or (B, n_particles·D) -> (B, L)."""

    def __init__(self, base: nn.Module, hard_mul_const: float = 1.0):
        super().__init__()
        self.base = base
        self.hard_mul_const = hard_mul_const

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.base(x.reshape(x.shape[0], -1))
        # 1.0·out is out; skipping it saves a multiply that is costly to
        # dispatch under the Laplacian's nested forward-mode JVPs
        return out if self.hard_mul_const == 1.0 else self.hard_mul_const * out


def make_wavefunctions(
    ndim: int,
    neigs: int,
    mlp_hidden_dims: Sequence[int],
    nonlinearity: str = "relu",
    n_particles: int = 1,
    parallel: bool = False,
    use_fourier_feature: bool = False,
    fourier_mapping_size: int = 256,
    fourier_scale: float = 10.0,
    fourier_deterministic: bool = False,
    fourier_append_raw: bool = False,
    fourier_append_radial: bool = False,
    fourier_append_envelopes=(),
    fourier_seed: int = 0,
    apply_boundary: bool = True,
    boundary_mode: str = "dir_box_sqrt",
    lim: float = 1.0,
    apply_exp_mask: bool = False,
    exp_mask_init_scale=1000.0,
    exp_mask_conjugate_importance=None,
    hard_mul_const: float = 1.0,
    debug: bool = False,
    compute_dtype=None,
    matmul_precision=None,
    seed: int = 0,
    device=None,
) -> Wavefunction:
    """Build the wavefunction model on ``device`` (default: the GPU).

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved, so the same seed gives the same model on every device.
    """
    if apply_boundary:
        raise NotImplementedError(
            "apply_boundary (dirichlet_box_mask) is not ported yet "
            "(ROADMAP queue 1, item 3); pass apply_boundary=False")
    if apply_exp_mask:
        raise NotImplementedError(
            "apply_exp_mask (make_exponential_mask) is not ported yet "
            "(ROADMAP queue 1, item 3)")
    dev = resolve_device(device)
    input_dim = ndim * n_particles
    feature_map = None
    if use_fourier_feature:
        feature_map = FourierFeatures(
            input_dim=input_dim, mapping_size=fourier_mapping_size,
            scale=fourier_scale, deterministic=fourier_deterministic,
            append_raw=fourier_append_raw, seed=fourier_seed,
            append_radial=fourier_append_radial,
            append_envelopes=fourier_append_envelopes,
            n_particles=n_particles)
    base = make_mlp_eigfuncs(
        input_dim=input_dim, neigs=neigs, mlp_hidden_dims=mlp_hidden_dims,
        nonlinearity=nonlinearity, parallel=parallel,
        feature_map=feature_map, debug=debug, compute_dtype=compute_dtype,
        matmul_precision=matmul_precision,
        generator=torch.Generator().manual_seed(seed))
    return Wavefunction(base, hard_mul_const).to(dev)
