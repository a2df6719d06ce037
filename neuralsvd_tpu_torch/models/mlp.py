"""Eigenfunction networks: the plain MLP and the per-mode ParallelMLP.

Port of ``neuralsvd_tpu/models/mlp.py``: ``get_activation`` (:37),
``make_mlp`` (:73, as ``MLP``), ``make_parallel_mlp`` (:184),
``make_mlp_eigfuncs`` (:295: the shared trunk ``MLP`` of sizes
``[feature_dim] + hidden + [neigs]`` or the per-mode ``ParallelMLP``) and
``parse_dims`` (:330).  L independent MLPs run as one batched product
chain with weights laid out (L, h_out, h_in), as in the JAX package; the
products go to ``torch.einsum``/``torch.matmul`` (cuBLAS), as the JAX
package leaves them to XLA.  Not ported yet: the shared trunk without
biases or with weight normalization (ROADMAP queue 1, item 6), ``compute_dtype`` and
``matmul_precision`` (item 10).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _sin_and_cos(x):
    if x.shape[-1] % 2:
        raise ValueError("sin_and_cos needs an even feature dim")
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([torch.sin(x1), torch.cos(x2)], dim=-1)


def get_activation(nonlinearity: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if nonlinearity == "relu":
        return F.relu
    if nonlinearity.startswith("lrelu"):
        slope = float(nonlinearity.replace("lrelu", ""))
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if nonlinearity.startswith("elu"):
        suffix = nonlinearity.replace("elu", "")
        alpha = float(suffix) if suffix else 1.0
        return lambda x: F.elu(x, alpha=alpha)
    if nonlinearity == "tanh":
        return torch.tanh
    if nonlinearity == "erf":
        return torch.erf
    if nonlinearity == "sin_and_cos":
        return _sin_and_cos
    if nonlinearity == "siren":
        return torch.sin
    if nonlinearity == "softplus":
        # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
        # where the two differ by < 3e-9, below one f32 ulp of x.  F.softplus
        # has native (nested) forward-mode derivatives; logaddexp's go
        # through Python decompositions, ~3x slower under torch.func.jvp.
        return F.softplus
    if nonlinearity == "linear":
        return lambda x: x
    raise NotImplementedError(f"unknown nonlinearity: {nonlinearity}")


def parse_dims(dims_str: str):
    """'512,512' -> [512, 512]."""
    return [int(d) for d in dims_str.split(",")] if dims_str else []


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` laid out (in, out), the JAX package's layout,
    so parameters carry across unchanged."""

    def __init__(self, fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(1.0 / fan_in)
        self.w = nn.Parameter(_uniform((fan_in, fan_out), bound, generator))
        self.b = nn.Parameter(_uniform((fan_out,), bound, generator))

    def forward(self, x):
        return torch.matmul(x, self.w) + self.b


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


class MLP(nn.Module):
    """Plain MLP ``sizes[0] -> ... -> sizes[-1]`` with biases, no final
    activation, after an optional parameter-free ``feature_map`` (whose
    ``feature_dim`` is then ``sizes[0]``).

    Init: U(-1/√fan_in, 1/√fan_in) weights and biases (torch.nn.Linear's
    default, the JAX package's ``_kaiming_uniform``) drawn from
    ``generator``: the distribution of the JAX init, not its numbers.
    """

    def __init__(self, sizes: Sequence[int], nonlinearity: str = "relu",
                 generator: Optional[torch.Generator] = None,
                 feature_map: Optional[nn.Module] = None):
        super().__init__()
        sizes = list(sizes)
        self.act = get_activation(nonlinearity)
        self.feature_map = feature_map
        self.layers = nn.ModuleList(
            Dense(sizes[i], sizes[i + 1], generator)
            for i in range(len(sizes) - 1))

    def forward(self, x):
        if self.feature_map is not None:
            x = self.feature_map(x)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = self.act(x)
        return x


class ParallelMLP(nn.Module):
    """L independent MLPs ``feature_map -> hidden... -> output_dim``.

    ``ws[i]`` is (L, h_out, h_in) and ``bs[i]`` (L, h_out, 1), the JAX
    package's layout.  Init: N(0, 2/fan_in) weights and zero biases drawn
    from ``generator`` (the JAX init's distribution, not its numbers);
    ``debug=True`` sets everything to 0.1.  Under weight normalization every
    layer is divided by the *first* layer's norm (the reference's quirk).
    Returns (B, L) for ``output_dim == 1``, else (B, L, O).
    """

    def __init__(self, input_dim: int, mlp_hidden_dims: Sequence[int],
                 num_copies: int, output_dim: int = 1,
                 nonlinearity: str = "relu", bias: bool = False,
                 weight_normalization: bool = False,
                 feature_map: Optional[nn.Module] = None, debug: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(nonlinearity)
        self.output_dim = output_dim
        self.bias = bias
        self.weight_normalization = weight_normalization
        self.feature_map = feature_map
        dims = list(mlp_hidden_dims) + [output_dim]
        h_prev = input_dim if feature_map is None else feature_map.feature_dim
        ws, bs = [], []
        for h in dims:
            if debug:
                w = torch.full((num_copies, h, h_prev), 0.1)
                b = torch.full((num_copies, h, 1), 0.1)
            else:
                w = math.sqrt(2.0 / h_prev) * torch.randn(
                    (num_copies, h, h_prev), generator=generator)
                b = torch.zeros((num_copies, h, 1))
            ws.append(nn.Parameter(w))
            if bias:
                bs.append(nn.Parameter(b))
            h_prev = h
        self.ws = nn.ParameterList(ws)
        self.bs = nn.ParameterList(bs)

    def per_mode_parameters(self):
        """The names of the parameters whose leading axis is the mode axis
        and whose slot l feeds output l only: every ``ws``/``bs`` stack
        (the per-mode weight normalization divides slot l by slot l's
        norm).  SpIN keeps their Jacobian averages block-diagonal."""
        return [name for name, _ in self.named_parameters()
                if name.startswith(("ws.", "bs."))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.feature_map is not None:
            x = self.feature_map(x)
        ws = list(self.ws)
        if self.weight_normalization:
            norm0 = torch.linalg.vector_norm(ws[0], dim=(-1, -2), keepdim=True)
            ws = [w / norm0 for w in ws]
        h = torch.einsum("lhd,bd->lhb", ws[0], x)
        if self.bias:
            h = h + self.bs[0]
        h = self.act(h)
        for i in range(1, len(ws)):
            h = torch.einsum("lhp,lpb->lhb", ws[i], h)
            if self.bias:
                h = h + self.bs[i]
            if i < len(ws) - 1:
                h = self.act(h)
        out = h.permute(2, 0, 1)  # (B, L, O)
        if self.output_dim == 1:
            out = out[..., 0]
        return out


def make_mlp_eigfuncs(input_dim: int, neigs: int,
                      mlp_hidden_dims: Sequence[int], nonlinearity: str,
                      bias: bool = True, weight_normalization: bool = False,
                      parallel: bool = False,
                      feature_map: Optional[nn.Module] = None,
                      debug: bool = False, compute_dtype=None,
                      matmul_precision=None,
                      generator: Optional[torch.Generator] = None) -> nn.Module:
    if compute_dtype is not None or matmul_precision is not None:
        raise NotImplementedError(
            "compute_dtype / matmul_precision tiers are not ported yet "
            "(ROADMAP queue 1, item 10)")
    if not parallel:
        if not bias or weight_normalization:
            raise NotImplementedError(
                "the shared-trunk MLP without biases or with weight "
                "normalization is not ported yet (ROADMAP queue 1, item 6)")
        in_dim = input_dim if feature_map is None else feature_map.feature_dim
        return MLP([in_dim] + list(mlp_hidden_dims) + [neigs], nonlinearity,
                   generator=generator, feature_map=feature_map)
    return ParallelMLP(input_dim, mlp_hidden_dims, num_copies=neigs,
                       output_dim=1, nonlinearity=nonlinearity, bias=bias,
                       weight_normalization=weight_normalization,
                       feature_map=feature_map, debug=debug,
                       generator=generator)
