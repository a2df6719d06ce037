"""Eigenfunction networks: the plain MLP and the per-mode ParallelMLP.

Port of ``neuralsvd_tpu/models/mlp.py``: ``get_activation`` (:37),
``make_mlp`` (:73, as ``MLP``), ``resolve_matmul_precision`` (:133),
``_tower_einsum`` (:166, as ``tower_product``), ``make_parallel_mlp``
(:184), ``make_mlp_eigfuncs`` (:295: the shared trunk ``MLP`` of sizes
``[feature_dim] + hidden + [neigs]`` or the per-mode ``ParallelMLP``) and
``parse_dims`` (:330).  L independent MLPs run as one batched product
chain with weights laid out (L, h_out, h_in), as in the JAX package; the
products go to ``torch.einsum`` (cuBLAS), as the JAX package leaves them
to XLA.  The shared trunk takes ``bias=False`` and
``weight_normalization`` as JAX's ``make_mlp`` does (:73-127): a gain
``g`` per output column, ‖w‖ over the input axis at init, and at apply
``w·g/(‖w‖ + 1e-12)``, the gradient flowing through the norm (not
``torch.nn.utils.weight_norm``, whose parametrization differs).

Precision of the tower products (``matmul_precision``).  A tier applies
to the tower products only, in the forward pass and in both products of
the backward (JAX's transpose of ``dot_general`` carries ``precision``);
the grams, the losses, the feature maps and the eval stay at the ambient
setting, which the CLIs pin to IEEE float32.  On an NVIDIA GPU, for
float32 operands:

- ``"highest"``: IEEE float32, TF32 off;
- ``"high"``: 3xTF32: each operand split into a TF32-representable high
  part and its remainder (``split_tf32``), and the three TF32 products
  hi·lo + lo·hi + hi·hi summed in float32 (``three_pass``): error ~2^-21
  relative, the class of the TPU's 3-pass tier;
- ``"default"``: one TF32 pass (error ~2^-11), what XLA does with
  ``Precision.DEFAULT`` on a GPU;
- ``None``: the ambient setting, untouched.

Each tiered product sets ``torch.backends.cuda.matmul.allow_tf32`` for
its own cuBLAS calls only and restores it, on the error path too.  On the
CPU, and for operands that are not float32, every tier computes the plain
product (XLA's CPU backend ignores ``precision`` too), so on the CPU a
tiered model equals the untiered one bit for bit.  A split spec
``'<head>@<k>,<tail>'`` runs the first k towers at <head> and the rest at
<tail>, concatenated along the mode axis (ParallelMLP only); where the two
tiers compute alike (always on the CPU) it is one product.

``compute_dtype`` (e.g. ``torch.bfloat16``): the tower's parameters and
input are cast to it inside the forward, the chain (products, biases,
activations, each op rounded to it as in JAX: ``get_activation``) runs in
it, and the output is cast back to float32, so
master weights, optimizer state and gradients stay float32 (the cast's
gradient carries them back).  Unlike the JAX package, whose shared trunk
drops ``compute_dtype`` (``neuralsvd_tpu/models/mlp.py:307-312``), the
port's shared trunk applies it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function

TIERS = ("default", "high", "highest")


def _sin_and_cos(x):
    if x.shape[-1] % 2:
        raise ValueError("sin_and_cos needs an even feature dim")
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([torch.sin(x1), torch.cos(x2)], dim=-1)


def get_activation(nonlinearity: str,
                   dtype: Optional[torch.dtype] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation by name.  ``dtype``: the reduced compute dtype the
    activation runs in, if any.  Then leaky_relu and softplus are written
    out op by op as JAX writes them, since in that dtype the rounding
    after each op shows: leaky_relu as ``where(x >= 0, x, slope·x)`` (the
    slope rounded to the dtype, the derivative 1 at an exact 0, which bf16
    sums often give; F.leaky_relu's is the slope there) and softplus as
    ``logaddexp(x, 0)``."""
    if nonlinearity == "relu":
        return F.relu
    if nonlinearity.startswith("lrelu"):
        slope = float(nonlinearity.replace("lrelu", ""))
        if dtype is not None:
            slope = torch.tensor(slope, dtype=dtype).item()
            return lambda x: torch.where(x >= 0, x, x * slope)
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
        if dtype is not None:
            return lambda x: torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
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


def resolve_matmul_precision(precision):
    """None | 'default' | 'high' | 'highest' | a split spec
    ``'<head>@<k>,<tail>'`` -> None (the ambient setting), the tier's name,
    or ``('split', head, k, tail)``; a resolved value is returned as it is."""
    if precision is None or precision == "":
        return None
    if _is_split(precision):
        return precision
    if "@" in precision:
        head, rest = precision.split("@", 1)
        k_str, tail = rest.split(",", 1)
        return ("split", resolve_matmul_precision(head), int(k_str),
                resolve_matmul_precision(tail))
    if precision not in TIERS:
        raise ValueError(f"unknown matmul_precision {precision!r}: one of {TIERS}, "
                         "or a split spec '<head>@<k>,<tail>'")
    return precision


def _is_split(prec) -> bool:
    return isinstance(prec, tuple) and len(prec) == 4 and prec[0] == "split"


def resolve_compute_dtype(dtype) -> Optional[torch.dtype]:
    """None, a torch dtype or its name ('bf16', 'bfloat16', ...) -> the
    dtype of the tower chain; float32 (or None) -> None, no cast."""
    if isinstance(dtype, str):
        dtype = getattr(torch, {"bf16": "bfloat16", "f32": "float32"}.get(dtype, dtype))
    if dtype is not None and not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {dtype} is not a floating dtype")
    return None if dtype in (None, torch.float32) else dtype


@contextlib.contextmanager
def _tf32(enabled: bool):
    """cuBLAS's TF32 switch set for the block, restored after it."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        matmul.allow_tf32 = old


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = x rounded to TF32's 11 significant bits (Veltkamp's
    split by 2^13 + 1) and lo = x - hi, exact in float32."""
    t = 8193.0 * x
    hi = t - (t - x)
    return hi, x - hi


def three_pass(product: Callable, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32: ``product`` (one TF32 pass) of the high and low parts,
    hi·lo + lo·hi + hi·hi, the small terms summed first."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (product(a_hi, b_lo) + product(a_lo, b_hi)) + product(a_hi, b_hi)


def _tiered_einsum(eq: str, tier: str, a: torch.Tensor, b: torch.Tensor,
                   einsum: Callable = torch.einsum):
    """``einsum(eq, a, b)`` at ``tier`` (see the module docstring)."""
    if a.device.type != "cuda" or a.dtype != torch.float32 or b.dtype != torch.float32:
        return einsum(eq, a, b)
    with _tf32(tier != "highest"):
        if tier == "high":
            return three_pass(lambda x, y: einsum(eq, x, y), a, b)
        return einsum(eq, a, b)


def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A two-operand einsum as permutes, reshapes and one ``torch.bmm``:
    what ``torch.einsum`` does, in ops that the batched backward of
    ``autograd.grad(is_grads_batched=True)`` can batch (it has no rule for
    ``torch.einsum`` itself)."""
    lhs, out = eq.split("->")
    sa, sb = lhs.split(",")
    size = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}
    batch = [c for c in out if c in sa and c in sb]
    summed = [c for c in sa if c in sb and c not in out]
    free_a = [c for c in sa if c not in sb]
    free_b = [c for c in sb if c not in sa]

    def n(axes):
        return math.prod(size[c] for c in axes)

    am = a.permute([sa.index(c) for c in batch + free_a + summed]).reshape(
        n(batch), n(free_a), n(summed))
    bm = b.permute([sb.index(c) for c in batch + summed + free_b]).reshape(
        n(batch), n(summed), n(free_b))
    res = batch + free_a + free_b
    return torch.bmm(am, bm).reshape([size[c] for c in res]).permute(
        [res.index(c) for c in out])


class _TieredProduct(torch.autograd.Function):
    """A two-operand einsum 'A,B->O' (each operand axis in the other or in
    O) at a tier, whose backward products 'O,B->A' and 'A,O->B' run at the
    same tier.  Used outside ``torch.func`` transforms only (see
    ``tower_product``)."""

    @staticmethod
    def forward(ctx, eq, tier, a, b):
        ctx.eq, ctx.tier = eq, tier
        ctx.save_for_backward(a, b)
        return _tiered_einsum(eq, tier, a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        lhs, out = ctx.eq.split("->")
        sa, sb = lhs.split(",")
        ga = (_tiered_einsum(f"{out},{sb}->{sa}", ctx.tier, grad, b, _contract)
              if ctx.needs_input_grad[2] else None)
        gb = (_tiered_einsum(f"{sa},{out}->{sb}", ctx.tier, a, grad, _contract)
              if ctx.needs_input_grad[3] else None)
        return None, None, ga, gb


@torch.library.custom_op("neuralsvd_tpu_torch::tiered_einsum", mutates_args=())
def tiered_einsum_op(eq: str, tier: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_tiered_einsum`` as one operator: what a ``torch.export`` program
    holds for a tiered product, since cuBLAS's TF32 switch is a global
    setting that no traced graph records (utils/export.py)."""
    return _tiered_einsum(eq, tier, a, b)


@tiered_einsum_op.register_fake
def _(eq, tier, a, b):
    return torch.einsum(eq, a, b)


def tower_product(eq: str, a: torch.Tensor, b: torch.Tensor, precision=None):
    """The tower product ``torch.einsum(eq, a, b)`` at ``precision`` (None,
    a tier, or a split spec, see ``resolve_matmul_precision``): the
    counterpart of the JAX package's ``_tower_einsum``.  Under a split the
    first operand and the result lead with the mode axis; the second
    operand is split too where it leads with that axis, else (a shared
    input) it goes whole to both parts.  A forward-Laplacian dual reaches
    the engine's rule for this function by name."""
    if has_torch_function((a, b)):
        return handle_torch_function(tower_product, (a, b), eq, a, b,
                                     precision=precision)
    prec = resolve_matmul_precision(precision)
    if _is_split(prec):
        _, head, k, tail = prec
        if head != tail and a.device.type == "cuda":
            return _split_product(eq, a, b, k, head, tail)
        prec = head  # the two tiers compute alike
    if prec is None:
        return torch.einsum(eq, a, b)
    if torch.compiler.is_exporting() and a.device.type == "cuda":
        return tiered_einsum_op(eq, prec, a, b)
    if torch._C._functorch.peek_interpreter_stack() is not None:
        # inside torch.func's jvp or vmap (the nested-JVP Laplacian), whose
        # nested JVPs would not differentiate a Function's own jvp: the
        # product's ops, run at the tier, carry the tangents (3xTF32 splits
        # them as it splits the operands).  A backward through these ops (a
        # graph through nested JVPs) runs at the ambient setting.
        return _tiered_einsum(eq, prec, a, b)
    return _TieredProduct.apply(eq, prec, a, b)


def _split_product(eq, a, b, k, head, tail):
    sa, sb = eq.split("->")[0].split(",")
    shared = sb[0] != sa[0]
    return torch.cat([tower_product(eq, a[:k], b if shared else b[:k], head),
                      tower_product(eq, a[k:], b if shared else b[k:], tail)], 0)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` laid out (in, out), the JAX package's layout,
    so parameters carry across unchanged; without ``bias`` no ``b``; with
    ``weight_normalization`` a gain ``g`` (out,), ‖w‖ over axis 0 at init,
    and the product takes ``w·g/(‖w‖ + 1e-12)``."""

    def __init__(self, fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator] = None, bias: bool = True,
                 weight_normalization: bool = False):
        super().__init__()
        bound = math.sqrt(1.0 / fan_in)
        self.w = nn.Parameter(_uniform((fan_in, fan_out), bound, generator))
        b = _uniform((fan_out,), bound, generator)  # drawn either way, as in JAX
        self.b = nn.Parameter(b) if bias else None
        self.weight_normalization = weight_normalization
        if weight_normalization:
            self.g = nn.Parameter(torch.linalg.vector_norm(self.w.detach(), dim=0))

    def forward(self, x, precision=None, compute_dtype=None):
        """``x`` is already in ``compute_dtype``; ``w`` and ``b`` are cast."""
        w, b = self.w, self.b
        if self.weight_normalization:
            w = w * (self.g / (torch.linalg.vector_norm(w, dim=0) + 1e-12))
        if compute_dtype is not None:
            w = w.to(compute_dtype)
            b = None if b is None else b.to(compute_dtype)
        h = tower_product("bi,io->bo", x, w, precision)
        return h if b is None else h + b


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


class MLP(nn.Module):
    """Plain MLP ``sizes[0] -> ... -> sizes[-1]``, with biases unless
    ``bias=False`` and weight-normalized layers with ``weight_normalization``
    (``Dense``), no final activation, after an optional parameter-free
    ``feature_map`` (whose ``feature_dim`` is then ``sizes[0]``); products
    at ``matmul_precision`` (one tier: a split spec raises ValueError), the
    chain in ``compute_dtype`` (module docstring).

    Init: U(-1/√fan_in, 1/√fan_in) weights and biases (torch.nn.Linear's
    default, the JAX package's ``_kaiming_uniform``) drawn from
    ``generator``: the distribution of the JAX init, not its numbers.
    """

    def __init__(self, sizes: Sequence[int], nonlinearity: str = "relu",
                 generator: Optional[torch.Generator] = None,
                 feature_map: Optional[nn.Module] = None,
                 matmul_precision=None, compute_dtype=None, bias: bool = True,
                 weight_normalization: bool = False):
        super().__init__()
        sizes = list(sizes)
        self.feature_map = feature_map
        self.precision = resolve_matmul_precision(matmul_precision)
        if _is_split(self.precision):
            raise ValueError("split matmul_precision specs ('head@k,tail') "
                             "require the per-mode ParallelMLP (parallel=True)")
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.act = get_activation(nonlinearity, self.compute_dtype)
        self.layers = nn.ModuleList(
            Dense(sizes[i], sizes[i + 1], generator, bias, weight_normalization)
            for i in range(len(sizes) - 1))

    def forward(self, x):
        if self.feature_map is not None:
            x = self.feature_map(x)
        dtype = self.compute_dtype
        if dtype is not None:
            x = x.to(dtype)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x, self.precision, dtype)
            if i < last:
                x = self.act(x)
        return x if dtype is None else x.to(torch.float32)


class ParallelMLP(nn.Module):
    """L independent MLPs ``feature_map -> hidden... -> output_dim``.

    ``ws[i]`` is (L, h_out, h_in) and ``bs[i]`` (L, h_out, 1), the JAX
    package's layout.  Init: N(0, 2/fan_in) weights and zero biases drawn
    from ``generator`` (the JAX init's distribution, not its numbers);
    ``debug=True`` sets everything to 0.1.  Under weight normalization every
    layer is divided by the *first* layer's norm (the reference's quirk).
    Products at ``matmul_precision`` (a degenerate split, k <= 0 or
    k >= num_copies, is one tier), the chain in ``compute_dtype`` (module
    docstring).  Returns (B, L) for ``output_dim == 1``, else (B, L, O).
    """

    def __init__(self, input_dim: int, mlp_hidden_dims: Sequence[int],
                 num_copies: int, output_dim: int = 1,
                 nonlinearity: str = "relu", bias: bool = False,
                 weight_normalization: bool = False,
                 feature_map: Optional[nn.Module] = None, debug: bool = False,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype=None, matmul_precision=None):
        super().__init__()
        prec = resolve_matmul_precision(matmul_precision)
        if _is_split(prec):
            _, head, k, tail = prec
            if not 0 < k < num_copies:  # degenerate split: one tier
                prec = head if k >= num_copies else tail
        self.precision = prec
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.act = get_activation(nonlinearity, self.compute_dtype)
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
        ws, bs = list(self.ws), list(self.bs)
        dtype = self.compute_dtype
        if dtype is not None:
            x = x.to(dtype)
            ws = [w.to(dtype) for w in ws]
            bs = [b.to(dtype) for b in bs]
        if self.weight_normalization:
            norm0 = torch.linalg.vector_norm(ws[0], dim=(-1, -2), keepdim=True)
            ws = [w / norm0 for w in ws]
        h = tower_product("lhd,bd->lhb", ws[0], x, self.precision)
        if self.bias:
            h = h + bs[0]
        h = self.act(h)
        for i in range(1, len(ws)):
            h = tower_product("lhp,lpb->lhb", ws[i], h, self.precision)
            if self.bias:
                h = h + bs[i]
            if i < len(ws) - 1:
                h = self.act(h)
        out = h.permute(2, 0, 1)  # (B, L, O)
        if self.output_dim == 1:
            out = out[..., 0]
        return out if dtype is None else out.to(torch.float32)


def make_mlp_eigfuncs(input_dim: int, neigs: int,
                      mlp_hidden_dims: Sequence[int], nonlinearity: str,
                      bias: bool = True, weight_normalization: bool = False,
                      parallel: bool = False,
                      feature_map: Optional[nn.Module] = None,
                      debug: bool = False, compute_dtype=None,
                      matmul_precision=None,
                      generator: Optional[torch.Generator] = None) -> nn.Module:
    if not parallel:
        in_dim = input_dim if feature_map is None else feature_map.feature_dim
        return MLP([in_dim] + list(mlp_hidden_dims) + [neigs], nonlinearity,
                   generator=generator, feature_map=feature_map,
                   matmul_precision=matmul_precision, compute_dtype=compute_dtype,
                   bias=bias, weight_normalization=weight_normalization)
    return ParallelMLP(input_dim, mlp_hidden_dims, num_copies=neigs,
                       output_dim=1, nonlinearity=nonlinearity, bias=bias,
                       weight_normalization=weight_normalization,
                       feature_map=feature_map, debug=debug,
                       generator=generator, compute_dtype=compute_dtype,
                       matmul_precision=matmul_precision)
