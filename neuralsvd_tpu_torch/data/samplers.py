"""Training-point samplers and their exact importance densities.

Port of ``neuralsvd_tpu/data/samplers.py``: ``get_sampler`` (:18-107,
the ``gaussian``, ``laplacian``, ``gaussian_mixture`` and ``uniform``
modes), ``make_val_mc`` (:109) and ``make_val_grid`` (:135).  A JAX
sampler is a function of a PRNG key; a port sampler is a function of a
``torch.Generator`` on the sampler's device, and draws the batch on that
device.  The two give different numbers for the same seed; the densities
agree on the same x.

Every draw is a fixed number of ``torch.randn``/``torch.rand`` calls of
fixed shapes, so a sampler may run inside a captured CUDA graph (its
generator registered with the graph) and replays the eager draws: the
mixture picks its components by inverse CDF from one uniform a row, not
by ``torch.multinomial``.
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

    if sampling_mode == "laplacian":
        log_norm = -d * np.log(2 * sampling_scale)
        tiny = float(torch.finfo(torch.float32).eps)

        def sample(generator: torch.Generator) -> torch.Tensor:
            # inverse CDF: u uniform on [eps - 1, 1), as torch.distributions'
            # Laplace draws it
            u = torch.rand(shape, generator=generator, device=dev) * (2 - tiny) + (tiny - 1)
            return -sampling_scale * torch.sign(u) * torch.log1p(-torch.abs(u))

        def importance(x: torch.Tensor) -> torch.Tensor:
            x = x.reshape(x.shape[0], -1)
            logp = log_norm - torch.sum(torch.abs(x), dim=-1) / sampling_scale
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
        # component k holds u in [cdf[k-1], cdf[k]); the last edge is open
        cdf_t = torch.as_tensor(np.cumsum(weights)[:-1].astype(np.float32),
                                device=dev)
        log_norms_t = torch.as_tensor(log_norms, device=dev)
        log_weights_t = torch.as_tensor(np.log(weights), device=dev)

        def sample(generator: torch.Generator) -> torch.Tensor:
            u = torch.rand((batch_size, 1), generator=generator, device=dev)
            comp = torch.sum(u >= cdf_t, dim=1)
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

    if sampling_mode == "uniform":
        density = 1.0 / (2 * sampling_scale) ** d

        def sample(generator: torch.Generator) -> torch.Tensor:
            return sampling_scale * (
                2 * torch.rand(shape, generator=generator, device=dev) - 1)

        def importance(x: torch.Tensor) -> torch.Tensor:
            return torch.full((x.shape[0], 1), density, dtype=torch.float32,
                              device=x.device)

        return sample, importance

    raise NotImplementedError(sampling_mode)


def _batches(val_data: np.ndarray, batch_size: int):
    def batches():
        for i in range(0, len(val_data), batch_size):
            yield val_data[i:i + batch_size]

    return batches


def make_val_mc(sampling_mode: str, n_val: int, n_particles: int, ndim: int,
                sampling_scale, batch_size: int, seed: int = 12345,
                sampling_weights=None, device=None):
    """A fixed Monte-Carlo validation set of ``n_val`` points drawn from the
    sampling density by a generator seeded with ``seed``, for dimensions
    where a meshgrid explodes.  Returns (val_data (n_val, D) numpy,
    batch_iter_factory, importance_val = that density)."""
    dev = resolve_device(device)
    sample, importance = get_sampler(sampling_mode, n_val, n_particles,
                                     ndim, sampling_scale,
                                     sampling_weights=sampling_weights,
                                     device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    val_data = sample(generator).cpu().numpy().astype(np.float32)
    return val_data, _batches(val_data, batch_size), importance


def make_val_grid(ndim: int, lim: float, val_eps: float, batch_size: int):
    """Meshgrid validation set over [-lim, lim]^ndim with uniform
    importance: (val_data (N, ndim) numpy, batch_iter_factory,
    importance_val)."""
    xs = np.arange(-lim, lim, val_eps)
    grids = np.meshgrid(*(ndim * [xs]))
    val_data = np.stack([g.ravel() for g in grids], axis=1).astype(np.float32)
    density = 1.0 / (2 * lim) ** ndim

    def importance_val(x: torch.Tensor) -> torch.Tensor:
        return torch.full((x.shape[0], 1), density, dtype=torch.float32,
                          device=x.device)

    return val_data, _batches(val_data, batch_size), importance_val
