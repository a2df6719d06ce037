"""Wavefunction assembly for the PDE experiments.

Port of ``neuralsvd_tpu/models/wavefunctions.py:20-35``
(``dirichlet_box_mask``) and ``:111-193``: ``wavefunction(x) =
hard_mul_const · base_mlp(x) · box(x)``, the box mask with
``apply_boundary``.  Not ported yet (ROADMAP queue 1, item 6): the
learnable exponential mask (``apply_exp_mask``), which raises.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from neuralsvd_tpu_torch.device import resolve_device
from neuralsvd_tpu_torch.models.fourier import FourierFeatures
from neuralsvd_tpu_torch.models.mlp import make_mlp_eigfuncs


def dirichlet_box_mask(x: torch.Tensor, lim: float,
                       mode: str = "dir_box_sqrt") -> torch.Tensor:
    """Zero-Dirichlet mask on the box [-lim, lim]^d, (B, 1).

    'dir_box_sqrt' (Pfau et al. 2018) or 'dir_box_exp' (Jin et al. 2022).
    The product over dimensions is written as multiplies of columns, which
    the forward-Laplacian engine has a rule for (``torch.prod`` has none).
    """
    x = torch.clamp(x, -lim, lim).reshape(x.shape[0], -1)
    if mode == "dir_box_sqrt":
        per_dim = torch.clamp(
            (torch.sqrt(2 * lim ** 2 - x ** 2) - lim) / lim, min=0.0)
    elif mode == "dir_box_exp":
        per_dim = (1 - torch.exp(-(lim - x))) * (1 - torch.exp(-(x + lim)))
    else:
        raise NotImplementedError(mode)
    out = per_dim[:, 0:1]
    for i in range(1, per_dim.shape[1]):
        out = out * per_dim[:, i:i + 1]
    return out


class Wavefunction(nn.Module):
    """x (B, n_particles, D) or (B, n_particles·D) -> (B, L); with ``lim``
    set, times the box mask ``dirichlet_box_mask(x, lim, boundary_mode)``."""

    def __init__(self, base: nn.Module, hard_mul_const: float = 1.0,
                 lim=None, boundary_mode: str = "dir_box_sqrt"):
        super().__init__()
        self.base = base
        self.hard_mul_const = hard_mul_const
        self.lim = lim
        self.boundary_mode = boundary_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(x.shape[0], -1)
        out = self.base(x2)
        if self.lim is not None:
            out = out * dirichlet_box_mask(x2, self.lim, self.boundary_mode)
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
    if apply_exp_mask:
        raise NotImplementedError(
            "apply_exp_mask (make_exponential_mask) is not ported yet "
            "(ROADMAP queue 1, item 6)")
    if apply_boundary and boundary_mode not in ("dir_box_sqrt", "dir_box_exp"):
        raise NotImplementedError(boundary_mode)
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
    return Wavefunction(base, hard_mul_const,
                        lim=lim if apply_boundary else None,
                        boundary_mode=boundary_mode).to(dev)
