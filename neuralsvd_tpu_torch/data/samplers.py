"""Training-point samplers and their exact importance densities.

Port of ``neuralsvd_tpu/data/samplers.py:18-107`` for the ``gaussian`` and
``gaussian_mixture`` modes.  A JAX sampler is a function of a PRNG key; a
port sampler is a function of a ``torch.Generator`` on the sampler's
device, and draws the batch on that device.  The two give different numbers
for the same seed; the densities agree on the same x.  Not ported yet
(ROADMAP queue 1, item 4): ``laplacian``/``uniform`` modes, ``make_val_mc``
and ``make_val_grid``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from neuralsvd_tpu_torch.device import resolve_device


def get_sampler(sampling_mode: str, batch_size: int, n_particles: int,
                ndim: int, sampling_scale, sampling_weights=None,
                device=None) -> Tuple[Callable, Callable]:
    """Returns (sample(generator) -> (B, n_particles·ndim),
    importance(x) -> (B, 1)), the importance being the sampling density."""
    dev = resolve_device(device)
    d = n_particles * ndim
    shape = (batch_size, d)

    if sampling_mode == "gaussian":
        log_norm = -0.5 * d * np.log(2 * np.pi * sampling_scale ** 2)

        def sample(generator: torch.Generator) -> torch.Tensor:
            return sampling_scale * torch.randn(shape, generator=generator,
                                                device=dev)

        def importance(x: torch.Tensor) -> torch.Tensor:
            x = x.reshape(x.shape[0], -1)
            logp = log_norm - 0.5 * torch.sum(x ** 2, dim=-1) / sampling_scale ** 2
            return torch.exp(logp).reshape(-1, 1)

        return sample, importance

    if sampling_mode == "gaussian_mixture":
        # equal-weight (or sampling_weights) mixture of centred Gaussians
        # with std-devs sampling_scale; the density is exact, so importance
        # conjugation stays unbiased
        scales = np.asarray(sampling_scale, dtype=np.float32).ravel()
        if scales.size < 2:
            raise ValueError("gaussian_mixture needs >= 2 scales")
        K = scales.size
        if sampling_weights is None:
            weights = np.full(K, 1.0 / K, dtype=np.float32)
        else:
            weights = np.asarray(sampling_weights, dtype=np.float32).ravel()
            if weights.size != K or not (weights > 0).all():
                raise ValueError("sampling_weights must be K positive numbers")
            weights = weights / weights.sum()
        log_norms = (-0.5 * d * np.log(2 * np.pi * scales ** 2)).astype(np.float32)
        scales_t = torch.as_tensor(scales, device=dev)
        weights_t = torch.as_tensor(weights, device=dev)
        log_norms_t = torch.as_tensor(log_norms, device=dev)
        log_weights_t = torch.as_tensor(np.log(weights), device=dev)

        def sample(generator: torch.Generator) -> torch.Tensor:
            comp = torch.multinomial(weights_t, batch_size, replacement=True,
                                     generator=generator)
            s = scales_t[comp][:, None]
            return s * torch.randn(shape, generator=generator, device=dev)

        def importance(x: torch.Tensor) -> torch.Tensor:
            x = x.reshape(x.shape[0], -1)
            r2 = torch.sum(x ** 2, dim=-1, keepdim=True)  # (B, 1)
            logps = (log_weights_t.to(x.device)[None, :]
                     + log_norms_t.to(x.device)[None, :]
                     - 0.5 * r2 / scales_t.to(x.device)[None, :] ** 2)
            logp = torch.logsumexp(logps, dim=1)
            return torch.exp(logp).reshape(-1, 1)

        return sample, importance

    raise NotImplementedError(
        f"sampling mode {sampling_mode!r} is not ported yet "
        "(ROADMAP queue 1, item 4)")
