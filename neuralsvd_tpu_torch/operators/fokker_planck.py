"""The negative linear Fokker–Planck operator.

Port of ``neuralsvd_tpu/operators/fokker_planck.py``:

    -K f = -(∇²f + ∇V·∇f + f ∇²V), times ``scale``,

with V(x) = sin(Σ_i c_i cos x_i) (``sin_of_cos_potential``).  The
gradients of f and of V come from the same Laplacian with
``return_grad=True`` (finite differences, the forward-Laplacian engine or
nested JVPs).  Under a sampling density w the Laplacian of g = √w·f is
taken and √w divided out without a clip, as the JAX operator does (not
through ``VectorizedLaplacian``'s clipped importance path).  fs carries its
autograd graph, and Tf only with ``with_graph=True``, as in
``NegativeHamiltonian``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from neuralsvd_tpu_torch.operators.base import device_constant, graph_mode
from neuralsvd_tpu_torch.operators.diff_ops import VectorizedLaplacian, conjugate


def sin_of_cos_potential(xs, cs):
    """V(x) = sin(Σ_i c_i cos x_i); xs (B, D) -> (B,)."""
    return torch.sin(torch.sum(torch.cos(xs) * device_constant(cs, xs)[None, :], dim=-1))


class NegativeLinearFokkerPlanck:
    def __init__(self, local_potential_ftn: Callable, scale: float = 1.0,
                 laplacian_eps: float = 1e-5, laplacian_mode: str = "forward"):
        self.laplacian = VectorizedLaplacian(eps=laplacian_eps,
                                             exact_mode=laplacian_mode)
        self.local_potential_ftn = local_potential_ftn
        self.scale = scale

    def __call__(self, f, xs, importance: Optional[Callable] = None,
                 with_graph: bool = False):
        xs = xs.reshape(xs.shape[0], -1)
        if importance is None:
            lap_f, grad_f, fs = self.laplacian(f, xs, return_grad=True,
                                               with_graph=with_graph)
        else:
            lap_g, grad_g, gs = self.laplacian(conjugate(f, importance), xs,
                                               return_grad=True, with_graph=with_graph)
            with torch.no_grad():
                sqrt_ws = torch.sqrt(importance(xs))  # (B, 1)
            with graph_mode(with_graph):
                lap_f = lap_g / sqrt_ws
                grad_f = grad_g / sqrt_ws[..., None]
            fs = gs / sqrt_ws
        with torch.no_grad():
            lap_pot, grad_pot, _ = self.laplacian(
                lambda x: self.local_potential_ftn(x).reshape(-1, 1), xs,
                return_grad=True)
        with graph_mode(with_graph):
            # grad_pot: (B, 1, D); lap_pot: (B, 1)
            Kf = -(lap_f + torch.einsum("bd,bld->bl", grad_pot[:, 0, :], grad_f)
                   + fs * lap_pot)
            Tf = -self.scale * Kf
        return Tf, fs
