"""Two-tower networks for CDK / cross-domain retrieval.

Port of ``neuralsvd_tpu/models/two_tower.py``: ``normalize_embedding``
(:17), ``make_siam_network`` (:36, as ``SiamNetwork``) and
``make_hetero_network`` (:124, as ``HeteroNetwork``).

``HeteroNetwork``: separate x and y towers, each a plain MLP, with output
rows pushed back onto the radius-√μ L2 ball (the CDK loss's boundedness
constraint).  Parameters are ``{"x.layers.<i>.w", "x.layers.<i>.b",
"y.layers.<i>.w", ...}``, with weights (in, out) as in the JAX tree
``{"x": {"layers": [{"w", "b"}]}}``.  ``num_classes > 0`` adds the online
linear classifier heads ``head_x``/``head_y`` (drawn from the generator
after both towers, so the towers' weights do not depend on them):
``apply_single(v, side, classify=True)`` returns ``(emb, logits)``, the
head reading ``emb.detach()``, so a classifier loss trains the heads only.

``compute_dtype`` (e.g. ``torch.bfloat16``, the Sketchy script's
``--compute_dtype bf16``) runs each tower's chain in that dtype: its
parameters and input are cast inside the forward and its output is cast
back to float32 before ``normalize_embedding``, as JAX's ``apply_single``
does (``two_tower.py:172-177``), so master weights, gradients and the CDK
loss's inputs stay float32; retrieval (``apply_single``) runs the towers
in it too.  The heads run in float32, as in JAX.

``SiamNetwork``: one shared backbone MLP and an optional projector MLP;
``forward(z1[, z2])`` returns ``(rep1, emb1[, rep2, emb2])``.  With
``separation`` (per-mode scales ``linspace(mu/d, mu, d)`` reversed, the
parameter ``scales_param``) or ``batch_l2norm`` the embedding is divided by
its per-column batch L2 norm in train mode and by the buffer ``l2norm``
(an EMA of it, momentum 0.9) in eval mode; the buffer is written in place
in train mode only, once a view (z1, then z2).
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
    towers' chain in ``compute_dtype`` (None: float32); ``num_classes``
    online heads (module docstring)."""

    def __init__(self, input_dim: int, network_dims: Sequence[int],
                 nonlinearity: str = "lrelu0.2", mu: float = 1.0,
                 regularize_mode: str = "l2_ball",
                 generator: Optional[torch.Generator] = None,
                 compute_dtype=None, num_classes: int = 0):
        super().__init__()
        sizes = [input_dim] + list(network_dims)
        self.x = MLP(sizes, nonlinearity, generator=generator,
                     compute_dtype=compute_dtype)
        self.y = MLP(sizes, nonlinearity, generator=generator,
                     compute_dtype=compute_dtype)
        self.num_classes = num_classes
        if num_classes > 0:
            head = [network_dims[-1], num_classes]
            self.head_x = MLP(head, generator=generator)
            self.head_y = MLP(head, generator=generator)
        self.r_up = math.sqrt(mu)
        self.regularize_mode = regularize_mode
        # a tp mesh's all-gather of the modes (parallel/sharding.py
        # ``shard_module``), before the row norm of normalize_embedding,
        # which takes every mode, and before the heads
        self.mode_gather = None

    def mode_axes(self):
        """{name: mode axis} of each tower's last layer, the parameters a
        tp mesh shards by mode: w (d, L) by columns, b and a weight
        normalization's gain (L,) (JAX's ``cdk_mode_shardings``,
        ``neuralsvd_tpu/parallel/sharding.py:222-242``)."""
        out = {}
        for side in ("x", "y"):
            layers = getattr(self, side).layers
            last = layers[len(layers) - 1]
            for name, axis in (("w", 1), ("b", 0), ("g", 0)):
                if getattr(last, name, None) is not None:
                    out[f"{side}.layers.{len(layers) - 1}.{name}"] = axis
        return out

    def pre_gather_parameters(self):
        """The towers' hidden layers: replicated on a tp mesh, and used
        before the modes are gathered (the heads come after)."""
        axes = self.mode_axes()
        return [name for name, _ in self.named_parameters()
                if name.startswith(("x.", "y.")) and name not in axes]

    def apply_single(self, v: torch.Tensor, side: str, classify: bool = False):
        tower = {"x": self.x, "y": self.y}[side]
        z = tower(v)
        if self.mode_gather is not None:
            z = self.mode_gather(z)
        emb = normalize_embedding(z, self.r_up, self.regularize_mode)
        if not classify:
            return emb
        if self.num_classes <= 0:
            raise ValueError("built without num_classes: no online heads")
        head = self.head_x if side == "x" else self.head_y
        return emb, head(emb.detach())

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        return self.apply_single(x, "x"), self.apply_single(y, "y")


class SiamNetwork(nn.Module):
    """Shared-weight two-view network (module docstring).  The l2norm EMA
    lives in the buffers ``l2norm`` (d,) and ``initialized`` (bool)."""

    def __init__(self, input_dim: int, backbone_dims: Sequence[int],
                 projector_dims: Sequence[int] = (), nonlinearity: str = "relu",
                 mu: float = 1.0, regularize_mode: str = "l2_ball",
                 separation: bool = False, batch_l2norm: bool = False,
                 momentum: float = 0.9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if separation and batch_l2norm:
            raise ValueError("separation and batch_l2norm exclude each other")
        self.backbone = MLP([input_dim] + list(backbone_dims), nonlinearity,
                            generator=generator)
        self.projector = (MLP([backbone_dims[-1]] + list(projector_dims), nonlinearity,
                              generator=generator) if projector_dims else None)
        feature_dim = (list(projector_dims) or list(backbone_dims))[-1]
        self.r_up = math.sqrt(mu) if mu > 0 else 0.0
        self.regularize_mode = regularize_mode
        self.separation, self.batch_l2norm = separation, batch_l2norm
        self.momentum = momentum
        if separation:
            scales = torch.linspace(mu / feature_dim, mu, feature_dim).flip(0)
            self.scales_param = nn.Parameter(scales[None, :])
        self.register_buffer("l2norm", torch.ones(feature_dim))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))

    def scales(self) -> torch.Tensor:
        """The per-mode scales √|scales_param| on the r_up ball."""
        return normalize_embedding(torch.sqrt(torch.abs(self.scales_param)),
                                   self.r_up, "l2_ball")

    def embed_single(self, z: torch.Tensor):
        rep = self.backbone(z)
        emb = rep if self.projector is None else self.projector(rep)
        if not (self.separation or self.batch_l2norm):
            return rep, normalize_embedding(emb, self.r_up, self.regularize_mode)
        if self.training:
            norm = torch.linalg.vector_norm(emb, dim=0) / math.sqrt(emb.shape[0])
            with torch.no_grad():
                ema = torch.sqrt(self.momentum * self.l2norm ** 2
                                 + (1 - self.momentum) * norm ** 2)
                self.l2norm.copy_(torch.where(self.initialized, ema, norm))
                self.initialized.fill_(True)
        else:
            norm = self.l2norm
        if self.separation:
            return rep, emb / torch.clamp(norm, min=1e-6) * self.scales()
        total = torch.sqrt(torch.sum(norm ** 2))
        scale = torch.where(total > self.r_up,
                            self.r_up / torch.clamp(total, min=1e-6),
                            torch.ones_like(total))
        return rep, emb * scale

    def forward(self, z1: torch.Tensor, z2: Optional[torch.Tensor] = None):
        rep1, emb1 = self.embed_single(z1)
        if z2 is None:
            return rep1, emb1
        rep2, emb2 = self.embed_single(z2)
        return rep1, emb1, rep2, emb2
