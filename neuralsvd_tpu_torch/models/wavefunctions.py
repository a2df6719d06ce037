"""Wavefunction assembly for the PDE experiments.

Port of ``neuralsvd_tpu/models/wavefunctions.py``: ``dirichlet_box_mask``
(:20-35), ``make_exponential_mask`` (:37-80, as ``ExponentialMask``),
``scale_mode_amplitudes`` (:83-108) and ``make_wavefunctions``
(:111-193): ``wavefunction(x) = hard_mul_const · base_mlp(x) · mask(x)``,
the mask being the learnable exponential mask (which carries the box
inside it) with ``apply_exp_mask``, else the box with ``apply_boundary``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
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


class ExponentialMask(nn.Module):
    """Learnable radial decay ``exp(-r / s_l)`` per mode, (B, L).

    ``scales`` (L,) is a parameter.  ``init_scale`` is a scalar, L explicit
    per-mode scales, or a pair (lo, hi) giving the geometric ladder
    ``np.geomspace(lo, hi, L)``.  ``conjugate_importance`` w(x) multiplies
    the mask by √(w(0)/w(x)), so that the physical ψ = √w·f carries the
    envelope; with ``lim`` set the box mask is multiplied in.
    """

    def __init__(self, output_dim: int, init_scale=1000.0, lim=None,
                 boundary_mode: str = "dir_box_sqrt",
                 conjugate_importance=None):
        super().__init__()
        if isinstance(init_scale, (tuple, list, np.ndarray)):
            if len(init_scale) == output_dim:
                scales = np.asarray(init_scale)
            else:
                lo, hi = init_scale
                scales = np.geomspace(lo, hi, output_dim)
        else:
            scales = np.full(output_dim, init_scale)
        self.scales = nn.Parameter(torch.as_tensor(scales, dtype=torch.float32))
        self.lim = lim
        self.boundary_mode = boundary_mode
        self.conjugate_importance = conjugate_importance

    def per_mode_parameters(self):
        """The per-mode scales: slot l feeds output l only."""
        return ["scales"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(x.shape[0], -1)
        # the norm as sqrt of a sum, which the forward-Laplacian engine has
        # rules for (torch.linalg.norm would take its fallback)
        r = torch.sqrt(torch.sum(x2 * x2, dim=-1, keepdim=True))
        mask = torch.exp(-r / self.scales[None, :])
        if self.conjugate_importance is not None:
            w = self.conjugate_importance(x2).reshape(-1, 1)
            w0 = self.conjugate_importance(torch.zeros_like(x2[:1])).reshape(1, 1)
            mask = mask * torch.sqrt(w0 / torch.clamp(w, min=1e-30))
        if self.lim is not None:
            mask = mask * dirichlet_box_mask(x2, self.lim, self.boundary_mode)
        return mask


def scale_mode_amplitudes(params, mode_idx, factors) -> None:
    """Multiply, in place, the last tower layer's weights and biases of
    the ParallelMLP modes ``mode_idx`` (K,) by ``factors`` (K,), so those
    outputs scale linearly; ``params`` maps names to tensors
    (``base.ws.<i>`` (L, h, d), ``base.bs.<i>`` (L, h, 1)).  Used by the
    mode rescue to match a fresh mode's amplitude to its peers'."""
    last = max(int(k.rsplit(".", 1)[1]) for k in params if k.startswith("base.ws."))
    with torch.no_grad():
        for name in (f"base.ws.{last}", f"base.bs.{last}"):
            if name not in params:
                continue
            leaf = params[name]
            idx = torch.as_tensor(np.asarray(mode_idx), dtype=torch.long,
                                  device=leaf.device)
            f = torch.as_tensor(np.asarray(factors), dtype=leaf.dtype,
                                device=leaf.device)
            f = f.reshape(-1, *([1] * (leaf.ndim - 1)))
            leaf.index_copy_(0, idx, leaf.index_select(0, idx) * f)


class Wavefunction(nn.Module):
    """x (B, n_particles, D) or (B, n_particles·D) -> (B, L); times
    ``mask(x)`` (an ``ExponentialMask``, registered as ``mask``) when one
    is given, else, with ``lim`` set, times the box mask
    ``dirichlet_box_mask(x, lim, boundary_mode)``."""

    def __init__(self, base: nn.Module, hard_mul_const: float = 1.0,
                 lim=None, boundary_mode: str = "dir_box_sqrt",
                 mask: Optional[ExponentialMask] = None):
        super().__init__()
        self.base = base
        self.hard_mul_const = hard_mul_const
        self.lim = lim
        self.boundary_mode = boundary_mode
        self.mask = mask

    def per_mode_parameters(self):
        """The names of the parameters whose slot l feeds output l only
        (the mode axis leading): those the base network and the mask
        declare; a shared trunk declares none.  The output multiplies the
        two mode by mode, which keeps each slot on its own output."""
        return [f"{prefix}.{name}"
                for prefix, module in (("base", self.base), ("mask", self.mask))
                if hasattr(module, "per_mode_parameters")
                for name in module.per_mode_parameters()]

    def mode_axes(self):
        """{name: mode axis} of the parameters a tp mesh shards by mode
        (parallel/mesh.py ``ModeShards``): every per-mode parameter, on
        its leading axis, where the base network has per-mode towers; none
        on a shared trunk, whose last layer mixes every mode, so that a tp
        mesh replicates the whole model, as the JAX package's
        ``mode_sharded_params`` does (``neuralsvd_tpu/parallel/
        sharding.py:98``).  Then the exponential mask's scales shard too,
        slot l scaling mode l only (JAX replicates them)."""
        if not hasattr(self.base, "per_mode_parameters"):
            return {}
        return {name: 0 for name in self.per_mode_parameters()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(x.shape[0], -1)
        out = self.base(x2)
        if self.mask is not None:
            out = out * self.mask(x2)
        elif self.lim is not None:
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
    generator: Optional[torch.Generator] = None,
) -> Wavefunction:
    """Build the wavefunction model on ``device`` (default: the GPU).

    ``compute_dtype`` and ``matmul_precision`` reach the tower network
    (``models/mlp.py``), as in JAX (``wavefunctions.py:134-164``).  Weights are drawn on the CPU from ``generator`` (default:
    ``torch.Generator().manual_seed(seed)``) and then moved, so the same
    seed gives the same model on every device.
    """
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
        generator=(generator if generator is not None
                   else torch.Generator().manual_seed(seed)))
    box_lim = lim if apply_boundary else None
    mask = None
    if apply_exp_mask:
        mask = ExponentialMask(neigs, init_scale=exp_mask_init_scale,
                               lim=box_lim, boundary_mode=boundary_mode,
                               conjugate_importance=exp_mask_conjugate_importance)
    return Wavefunction(base, hard_mul_const, lim=box_lim,
                        boundary_mode=boundary_mode, mask=mask).to(dev)
