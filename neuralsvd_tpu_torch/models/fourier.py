"""Gaussian / deterministic Fourier feature maps.

Port of ``neuralsvd_tpu/models/fourier.py``.  The projection matrix is a
fixed buffer drawn from ``np.random.default_rng(seed)`` exactly as the JAX
package draws it, so both packages compute the same features.  It is not
part of the state dict (it is a function of the seed) and carries no
trainable parameters.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class FourierFeatures(nn.Module):
    """x (B, n_particles·D) -> [sin(xB), cos(xB), x?, r?, e^{-κr}?].

    deterministic=True uses the integer-frequency bank
    ``B = scale * [I, 2I, ..., mI]``; otherwise ``2π·scale·N(0, 1)``.
    ``append_radial`` adds per-particle ‖x_p‖ (the Coulomb cusp feature);
    ``append_envelopes`` adds per-particle ``exp(-κ_k‖x_p‖)``.
    """

    def __init__(self, input_dim: int, mapping_size: int = 256,
                 scale: float = 10.0, deterministic: bool = False,
                 append_raw: bool = False, seed: int = 0,
                 append_radial: bool = False, append_envelopes=(),
                 n_particles: int = 1):
        super().__init__()
        if deterministic:
            B = scale * np.concatenate(
                [i * np.eye(input_dim) for i in range(1, mapping_size + 1)],
                axis=0).T
            eff_mapping = input_dim * mapping_size
        else:
            rng = np.random.default_rng(seed)
            B = 2 * np.pi * scale * rng.standard_normal((input_dim, mapping_size))
            eff_mapping = mapping_size
        kappas = np.asarray(tuple(append_envelopes), dtype=np.float32)
        self.register_buffer("B", torch.as_tensor(B, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("kappas", torch.as_tensor(kappas),
                             persistent=False)
        self.append_raw = append_raw
        self.append_radial = append_radial
        self.n_particles = n_particles
        self.feature_dim = (2 * eff_mapping + (input_dim if append_raw else 0)
                            + (n_particles if append_radial else 0)
                            + n_particles * len(kappas))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        proj = x @ self.B
        feats = [torch.sin(proj), torch.cos(proj)]
        if self.append_raw:
            feats.append(x)
        if self.append_radial or self.kappas.numel():
            per_particle = x.reshape(x.shape[0], self.n_particles, -1)
            r = torch.sqrt(torch.sum(per_particle ** 2, dim=-1) + 1e-12)
            if self.append_radial:
                feats.append(r)
            if self.kappas.numel():
                env = torch.exp(-r[:, :, None] * self.kappas)
                feats.append(env.reshape(x.shape[0], -1))
        return torch.cat(feats, dim=-1)
