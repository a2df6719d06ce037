"""Two-tower (hetero) network for CDK / cross-domain retrieval.

Port of ``neuralsvd_tpu/models/two_tower.py``: ``normalize_embedding``
(:17) and ``make_hetero_network`` (:124, as ``HeteroNetwork``).  Separate
x and y towers, each a plain MLP, with output rows pushed back onto the
radius-√μ L2 ball (the CDK loss's boundedness constraint).  Parameters are
``{"x.layers.<i>.w", "x.layers.<i>.b", "y.layers.<i>.w", ...}``, with
weights (in, out) as in the JAX tree ``{"x": {"layers": [{"w", "b"}]}}``.

``compute_dtype`` (e.g. ``torch.bfloat16``, the Sketchy script's
``--compute_dtype bf16``) runs each tower's chain in that dtype: its
parameters and input are cast inside the forward and its output is cast
back to float32 before ``normalize_embedding``, as JAX's ``apply_single``
does (``two_tower.py:172-177``), so master weights, gradients and the CDK
loss's inputs stay float32; retrieval (``apply_single``) runs the towers
in it too.  Not ported yet: the ``num_classes`` online heads and
``make_siam_network`` (ROADMAP queue 1, item [7b]).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from neuralsvd_tpu_torch.models.mlp import MLP


def normalize_embedding(z: torch.Tensor, r_up: float, mode: str) -> torch.Tensor:
    """Constrain embedding rows to the r_up ball/sphere, clip or tanh."""
    if r_up <= 0:
        return z
    if mode == "l2_ball":
        norms = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        inside = (norms < r_up).to(z.dtype)
        unit = z / torch.clamp(norms, min=1e-12)
        return inside * z + (1 - inside) * r_up * unit
    if mode == "l2_sphere":
        norms = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return r_up * z / torch.clamp(norms, min=1e-12)
    if mode == "clip":
        return torch.clamp(z, -r_up, r_up)
    if mode == "tanh":
        return r_up * torch.tanh(z)
    raise NotImplementedError(mode)


class HeteroNetwork(nn.Module):
    """Two independent MLP towers: ``forward(x, y) -> (fx, gy)``;
    ``apply_single(v, "x"|"y")`` embeds one side (retrieval time); the
    towers' chain in ``compute_dtype`` (None: float32)."""

    def __init__(self, input_dim: int, network_dims: Sequence[int],
                 nonlinearity: str = "lrelu0.2", mu: float = 1.0,
                 regularize_mode: str = "l2_ball",
                 generator: Optional[torch.Generator] = None,
                 compute_dtype=None):
        super().__init__()
        sizes = [input_dim] + list(network_dims)
        self.x = MLP(sizes, nonlinearity, generator=generator,
                     compute_dtype=compute_dtype)
        self.y = MLP(sizes, nonlinearity, generator=generator,
                     compute_dtype=compute_dtype)
        self.r_up = math.sqrt(mu)
        self.regularize_mode = regularize_mode

    def apply_single(self, v: torch.Tensor, side: str) -> torch.Tensor:
        tower = {"x": self.x, "y": self.y}[side]
        return normalize_embedding(tower(v), self.r_up, self.regularize_mode)

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        return self.apply_single(x, "x"), self.apply_single(y, "y")
