"""Forward-Laplacian propagation: (f, ∇f, ∇²f) in one pass of the model.

Port of ``neuralsvd_tpu/ops/forward_laplacian.py``.  The JAX engine
interprets the function's jaxpr once, carrying a dual triple per array::

    v : the value                                   (shape S)
    j : stacked directional derivatives ∂_d (·)     ((K,) + S)
    l : the Laplacian channel Σ_d ∂²_d (·)          (shape S)

through one rule per primitive.  Here the triple is a ``torch.Tensor``
subclass, ``Dual``, whose data is v and which holds j and l; its
``__torch_function__`` looks the called torch function up in a rule table
by name, so the model's own ``forward`` runs unchanged on it.  Everything
runs under ``torch.no_grad()``: the EVD loss sends no gradient through
the Laplacian (ops/nestedlora.py), so no autograd graph is built.

A product with one dual operand stacks v, the K rows of j and l along the
operand's batch axis and makes ONE product call (``torch.einsum`` or
``torch.matmul``), then splits the result: a ParallelMLP layer is one
batched product over (K + 2)·B columns.  A bias or other constant added
to a dual changes v only.

Rules, with the JAX rule each ports:

- linear and structural ops (``_linear_rule``): reshape, view, flatten,
  squeeze, unsqueeze, permute, transpose, expand, indexing, cat, stack,
  chunk, unbind, sum and mean over dims, neg, clone, contiguous, to;
- add and sub (``_add_sub_rule``), mul (``_mul_rule``), div (``_div_rule``);
- elementwise functions (``_unary_apply`` and ``_UNARY``): exp, sin, cos,
  sqrt, rsqrt, log, log1p, tanh, sigmoid, abs, erf, square, reciprocal,
  relu and ``F.softplus`` (d1 = σ(βx), d2 = β·σ(βx)(1 − σ(βx)), which in
  f32 is jax.nn.softplus = logaddexp(x, 0)'s too);
- powers with a constant exponent (``_integer_pow_rule``, ``_pow_rule``);
- where, clamp, maximum, minimum (``_select_rule``): the channels follow
  the branch the value takes, the a.e. derivative, as nested JVPs give;
- rounding, sign, detach and ``*_like`` (``_cmp_rule``); comparisons need no
  rule (a mask has no channels);
- matmul, einsum, linear (``_dot_general_rule``);
- ``torch.logsumexp``, with the max held constant as ``jax.nn.logsumexp``
  holds it: with p = softmax(x), j' = Σ p·j and
  l' = Σ p·l + Σ_d (Σ p·j_d² − (Σ p·j_d)²);
- any other function with a floating output: ``fallback_rule``, an exact
  local rule by nested ``torch.func.jvp`` (slow but right).  It counts its
  calls in ``fallback_rule.calls``; the E4 path makes none.

In-place operations on a dual raise.

Semantics match ``operators/diff_ops.exact_laplacian``: directions are
global coordinate shifts, so the per-sample Laplacian is recovered only
for sample-diagonal ``f`` (f(xs)[b] depends on xs[b] alone).
"""
from __future__ import annotations

import math
import string
from typing import Callable, Optional

import torch
from torch.func import jvp
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["Dual", "fallback_rule", "forward_laplacian", "hutchinson_laplacian",
           "propagate", "rademacher"]


class Dual(torch.Tensor):
    """A value with its derivative channels; its data is the value ``v``.

    ``j`` ((K,) + v.shape) and ``l`` (v.shape) are plain tensors or None
    (identically zero).  Make one with ``make_dual``.
    """

    v: torch.Tensor
    j: Optional[torch.Tensor]
    l: Optional[torch.Tensor]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "__get__":  # a property: shape, dtype, T, ...
            name = func.__self__.__name__
        rule = _RULES.get(name)
        if rule is not None:
            return rule(func, args, kwargs)
        if name in _INPLACE or (name.endswith("_") and not name.startswith("__")):
            raise RuntimeError(f"in-place {name} on a forward-Laplacian dual")
        return fallback_rule(func, args, kwargs)


def make_dual(v: torch.Tensor, j: Optional[torch.Tensor] = None,
              l: Optional[torch.Tensor] = None):
    """A ``Dual`` of (v, j, l), or v itself when both channels are zero."""
    if j is None and l is None:
        return v
    d = torch.Tensor._make_subclass(Dual, v)
    d.v, d.j, d.l = v, j, l
    return d


# ---------------------------------------------------------------------------
# channel helpers
# ---------------------------------------------------------------------------

def _parts(a):
    """(v, j, l) of a dual; (a, None, None) of anything else."""
    if isinstance(a, Dual):
        return a.v, a.j, a.l
    return a, None, None


def _val(a):
    return a.v if isinstance(a, Dual) else a


def _ndir(*items) -> int:
    for a in items:
        if isinstance(a, Dual) and a.j is not None:
            return a.j.shape[0]
    raise ValueError("no direction channel among the operands")


def _shape(v):
    return v.shape if isinstance(v, torch.Tensor) else torch.Size()


def _pad_j(j, ndim: int):
    """Insert unit axes after the leading (direction or stacked channel)
    axis so j has 1 + ndim axes: numpy's right-aligned broadcasting (and a
    matmul's batch broadcasting) then applies to the value axes."""
    pad = ndim - (j.ndim - 1)
    if pad > 0:
        j = j.reshape(j.shape[:1] + (1,) * pad + j.shape[1:])
    return j


def _fit_j(j, shape):
    """j broadcast to (K,) + shape (a view)."""
    if j is None:
        return None
    j = _pad_j(j, len(shape))
    return j if j.shape[1:] == shape else j.expand(j.shape[0], *shape)


def _fit_l(l, shape):
    if l is None:
        return None
    return l if l.shape == shape else l.expand(shape)


def _j_or_zeros(a, K, like):
    v, j, _ = _parts(a)
    if j is not None:
        return j
    return like.new_zeros((K,) + tuple(_shape(v)))


def _l_or_zeros(a, like):
    v, _, l = _parts(a)
    if l is not None:
        return l
    return like.new_zeros(tuple(_shape(v)))


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _jdim(dim, ndim: int):
    """A dim of v as a dim of j (one leading direction axis more)."""
    if isinstance(dim, (tuple, list)):
        return tuple(_jdim(d, ndim) for d in dim)
    return dim + 1 if dim >= 0 else dim


def _arg(args, kwargs, i, name, default=None):
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


def _sizes(args, kwargs, name):
    """Shape or dim varargs: f(x, 2, 3) and f(x, (2, 3)) alike."""
    if len(args) == 2 and isinstance(args[1], (tuple, list, torch.Size)):
        return tuple(args[1])
    if len(args) > 1:
        return tuple(args[1:])
    return tuple(kwargs[name])


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _passthrough(func, args, kwargs):
    """Metadata (shape, dtype, device, size, ...): read from the value."""
    return func(*[_val(a) for a in args], **kwargs)


def _cmp_rule(func, args, kwargs):
    """Comparisons, rounding, sign, *_like: no derivative channels."""
    flat, spec = tree_flatten((args, kwargs))
    a, kw = tree_unflatten([_val(x) for x in flat], spec)
    return func(*a, **kw)


def _channelwise(op):
    """Linear ops that take no dim and keep the shape (neg, clone, to, ...):
    the same call on each channel."""

    def rule(func, args, kwargs):
        v, j, l = _parts(args[0])
        rest = args[1:]
        return make_dual(op(v, *rest, **kwargs),
                         None if j is None else op(j, *rest, **kwargs),
                         None if l is None else op(l, *rest, **kwargs))

    return rule


def _reshape_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    shape = _sizes(args, kwargs, "shape")
    out = v.reshape(shape)
    return make_dual(out, None if j is None else j.reshape((j.shape[0],) + shape),
                     None if l is None else l.reshape(shape))


def _view_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    shape = _sizes(args, kwargs, "size")
    return make_dual(v.view(shape), None if j is None else j.view((j.shape[0],) + shape),
                     None if l is None else l.view(shape))


def _flatten_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    start = _arg(args, kwargs, 1, "start_dim", 0)
    end = _arg(args, kwargs, 2, "end_dim", -1)
    out = torch.flatten(v, start, end)
    if v.ndim == 0:
        return make_dual(out, None if j is None else j.reshape(j.shape[0], 1),
                         None if l is None else l.reshape(1))
    s, e = start % v.ndim + 1, end % v.ndim + 1
    return make_dual(out, None if j is None else torch.flatten(j, s, e),
                     None if l is None else torch.flatten(l, start, end))


def _squeeze_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    dim = _arg(args, kwargs, 1, "dim", None)
    if dim is None:  # every unit axis of v, never the direction axis
        dim = tuple(i for i, s in enumerate(v.shape) if s == 1)
    return make_dual(torch.squeeze(v, dim),
                     None if j is None else torch.squeeze(j, _jdim(dim, v.ndim)),
                     None if l is None else torch.squeeze(l, dim))


def _unsqueeze_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    dim = _arg(args, kwargs, 1, "dim")
    return make_dual(torch.unsqueeze(v, dim),
                     None if j is None else torch.unsqueeze(j, _jdim(dim, v.ndim + 1)),
                     None if l is None else torch.unsqueeze(l, dim))


def _permute_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    dims = tuple(d % v.ndim for d in _sizes(args, kwargs, "dims"))
    return make_dual(v.permute(dims),
                     None if j is None else j.permute((0,) + tuple(d + 1 for d in dims)),
                     None if l is None else l.permute(dims))


def _transpose_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    d0 = _arg(args, kwargs, 1, "dim0") % v.ndim
    d1 = _arg(args, kwargs, 2, "dim1") % v.ndim
    return make_dual(v.transpose(d0, d1),
                     None if j is None else j.transpose(d0 + 1, d1 + 1),
                     None if l is None else l.transpose(d0, d1))


def _t_rule(func, args, kwargs):
    v = _val(args[0])
    if v.ndim < 2:
        return args[0]
    if v.ndim > 2:
        raise ValueError("Tensor.T of more than 2 dims is not supported on a dual")
    return _transpose_rule(func, (args[0], 0, 1), {})


def _expand_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    sizes = _sizes(args, kwargs, "size")
    out = v.expand(sizes)
    return make_dual(out, _fit_j(j, out.shape), _fit_l(l, out.shape))


def _is_advanced(i):
    return isinstance(i, (torch.Tensor, list)) or hasattr(i, "__array__")


def _getitem_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    idx = args[1]
    out = v[idx]
    if j is not None:
        tup = idx if isinstance(idx, tuple) else (idx,)
        if sum(_is_advanced(i) for i in tup) > 1:
            # separated advanced indices move their axes to the front:
            # index each direction on its own
            j = torch.stack([jd[idx] for jd in j.unbind(0)])
        else:
            j = j[(slice(None),) + tup]
    return make_dual(out, j, None if l is None else l[idx])


def _cat_rule(func, args, kwargs):
    items = list(_arg(args, kwargs, 0, "tensors"))
    dim = _arg(args, kwargs, 1, "dim", 0)
    vs = [_val(a) for a in items]
    out = torch.cat(vs, dim)
    j = l = None
    ref = out
    if any(isinstance(a, Dual) and a.j is not None for a in items):
        K = _ndir(*items)
        j = torch.cat([_j_or_zeros(a, K, ref) for a in items], _jdim(dim, out.ndim))
    if any(isinstance(a, Dual) and a.l is not None for a in items):
        l = torch.cat([_l_or_zeros(a, ref) for a in items], dim)
    return make_dual(out, j, l)


def _stack_rule(func, args, kwargs):
    items = list(_arg(args, kwargs, 0, "tensors"))
    dim = _arg(args, kwargs, 1, "dim", 0)
    out = torch.stack([_val(a) for a in items], dim)
    j = l = None
    if any(isinstance(a, Dual) and a.j is not None for a in items):
        K = _ndir(*items)
        j = torch.stack([_j_or_zeros(a, K, out) for a in items], _jdim(dim, out.ndim))
    if any(isinstance(a, Dual) and a.l is not None for a in items):
        l = torch.stack([_l_or_zeros(a, out) for a in items], dim)
    return make_dual(out, j, l)


def _multi(vs, js, ls):
    js = js if js is not None else [None] * len(vs)
    ls = ls if ls is not None else [None] * len(vs)
    return tuple(make_dual(v, j, l) for v, j, l in zip(vs, js, ls))


def _chunk_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    n = _arg(args, kwargs, 1, "chunks")
    dim = _arg(args, kwargs, 2, "dim", 0)
    return _multi(torch.chunk(v, n, dim),
                  None if j is None else torch.chunk(j, n, _jdim(dim, v.ndim)),
                  None if l is None else torch.chunk(l, n, dim))


def _unbind_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    dim = _arg(args, kwargs, 1, "dim", 0)
    return _multi(torch.unbind(v, dim),
                  None if j is None else torch.unbind(j, _jdim(dim, v.ndim)),
                  None if l is None else torch.unbind(l, dim))


def _reduce_rule(op):
    """sum or mean over dims (all of v's dims when dim is None)."""

    def rule(func, args, kwargs):
        v, j, l = _parts(args[0])
        dim = _arg(args, kwargs, 1, "dim", None)
        keepdim = _arg(args, kwargs, 2, "keepdim", False)
        if v.ndim == 0:
            return args[0]
        if dim is None:
            dim = tuple(range(v.ndim))
        out = op(v, dim, keepdim)
        return make_dual(out,
                         None if j is None else op(j, _jdim(dim, v.ndim), keepdim),
                         None if l is None else op(l, dim, keepdim))

    return rule


def _binary(name, args):
    """(a, b) of a binary op; __r*__ methods take their operands swapped."""
    a, b = args[0], args[1]
    if name.startswith("__r"):
        a, b = b, a
    return a, b


def _add_sub_rule(sign):
    def rule(func, args, kwargs):
        a, b = _binary(func.__name__, args)
        alpha = kwargs.get("alpha", 1)
        av, aj, al = _parts(a)
        bv, bj, bl = _parts(b)
        scale = sign * alpha
        if scale == 1:
            v = av + bv
        elif scale == -1:
            v = av - bv
        else:
            v = av + scale * bv
        shape = v.shape
        if bj is not None and scale != 1:
            bj = scale * bj
        if bl is not None and scale != 1:
            bl = scale * bl
        j = _fit_j(_add(_pad_j(aj, len(shape)) if aj is not None else None,
                        _pad_j(bj, len(shape)) if bj is not None else None), shape)
        l = _fit_l(_add(al, bl), shape)
        return make_dual(v, j, l)

    return rule


def _mul_parts(a, b):
    av, aj, al = _parts(a)
    bv, bj, bl = _parts(b)
    v = av * bv
    n = v.ndim
    j = _add(None if aj is None else _pad_j(aj, n) * bv,
             None if bj is None else av * _pad_j(bj, n))
    l = _add(None if al is None else al * bv, None if bl is None else av * bl)
    if aj is not None and bj is not None:
        l = _add(l, 2.0 * torch.sum(_pad_j(aj, n) * _pad_j(bj, n), dim=0))
    return v, _fit_j(j, v.shape), _fit_l(l, v.shape)


def _mul_rule(func, args, kwargs):
    return make_dual(*_mul_parts(*_binary(func.__name__, args)))


def _div_rule(func, args, kwargs):
    if kwargs.get("rounding_mode") is not None:
        return _cmp_rule(func, args, kwargs)
    a, b = _binary(func.__name__, args)
    if not isinstance(b, Dual):  # linear in a
        av, aj, al = _parts(a)
        v = av / b
        return make_dual(v, None if aj is None else _fit_j(_pad_j(aj, v.ndim) / b, v.shape),
                         None if al is None else _fit_l(al / b, v.shape))
    return make_dual(*_mul_parts(a, _unary_apply(b, *_UNARY["reciprocal"])))


def _unary_apply(d, u, u1, u2):
    """y = u(x); u1, u2 take (x, y) and give the first and second
    derivatives (u2 may return None for zero)."""
    x, j, l = _parts(d)
    y = u(x)
    if j is None and l is None:
        return y
    d1 = u1(x, y)
    jo = None if j is None else d1 * j
    lo = None if l is None else d1 * l
    if j is not None:
        d2 = u2(x, y)
        if d2 is not None:
            lo = _add(lo, d2 * torch.sum(j * j, dim=0))
    return make_dual(y, jo, lo)


def _unary_rule(u, u1, u2):
    def rule(func, args, kwargs):
        if len(args) > 1 or kwargs:
            return fallback_rule(func, args, kwargs)
        return _unary_apply(args[0], u, u1, u2)

    return rule


_UNARY = {
    "exp": (torch.exp, lambda x, y: y, lambda x, y: y),
    "sin": (torch.sin, lambda x, y: torch.cos(x), lambda x, y: -y),
    "cos": (torch.cos, lambda x, y: -torch.sin(x), lambda x, y: -y),
    "sqrt": (torch.sqrt, lambda x, y: 0.5 / y, lambda x, y: -0.25 / (y * x)),
    "rsqrt": (torch.rsqrt, lambda x, y: -0.5 * y / x,
              lambda x, y: 0.75 * y / (x * x)),
    "log": (torch.log, lambda x, y: 1.0 / x, lambda x, y: -1.0 / (x * x)),
    "log1p": (torch.log1p, lambda x, y: 1.0 / (1.0 + x),
              lambda x, y: -1.0 / ((1.0 + x) * (1.0 + x))),
    "tanh": (torch.tanh, lambda x, y: 1.0 - y * y,
             lambda x, y: -2.0 * y * (1.0 - y * y)),
    "sigmoid": (torch.sigmoid, lambda x, y: y * (1.0 - y),
                lambda x, y: y * (1.0 - y) * (1.0 - 2.0 * y)),
    "abs": (torch.abs, lambda x, y: torch.sign(x), lambda x, y: None),
    "erf": (torch.erf, lambda x, y: (2.0 / math.sqrt(math.pi)) * torch.exp(-x * x),
            lambda x, y: (-4.0 / math.sqrt(math.pi)) * x * torch.exp(-x * x)),
    "square": (torch.square, lambda x, y: 2.0 * x, lambda x, y: 2.0),
    "reciprocal": (torch.reciprocal, lambda x, y: -y * y,
                   lambda x, y: 2.0 * y * y * y),
    "relu": (torch.relu, lambda x, y: (x > 0).to(x.dtype), lambda x, y: None),
}


def _softplus_rule(func, args, kwargs):
    """F.softplus(x, beta, threshold): x where βx > threshold, else
    log1p(exp(βx))/β.  Below the threshold d1 = σ(βx), d2 = β·σ(1 − σ);
    above it 1 and 0, which σ(βx) gives exactly in f32 once βx > 17.4
    (exp(-17.4) is under half an ulp of 1), so only a lower threshold
    needs the explicit switch."""
    x, j, l = _parts(args[0])
    beta = _arg(args, kwargs, 1, "beta", 1.0)
    threshold = _arg(args, kwargs, 2, "threshold", 20.0)
    y = torch.nn.functional.softplus(x, beta, threshold)
    if j is None and l is None:
        return y
    bx = x if beta == 1 else beta * x
    s = torch.sigmoid(bx)
    d2 = s * (1.0 - s) if beta == 1 else beta * s * (1.0 - s)
    if threshold < 17.4:
        above = bx > threshold
        s = torch.where(above, 1.0, s)
        d2 = torch.where(above, 0.0, d2)
    jo = None if j is None else s * j
    lo = None if l is None else s * l
    if j is not None:
        lo = _add(lo, d2 * torch.sum(j * j, dim=0))
    return make_dual(y, jo, lo)


def _pow_rule(func, args, kwargs):
    """x ** c for a constant c (``_integer_pow_rule`` and ``_pow_rule``);
    a dual exponent takes the fallback."""
    base, expo = _binary(func.__name__, args)
    if isinstance(expo, Dual) or not isinstance(base, Dual):
        return fallback_rule(func, args, kwargs)
    if isinstance(expo, (int, float)) and float(expo) == 2.0:
        return _unary_apply(base, lambda x: x * x, lambda x, y: 2.0 * x,
                            lambda x, y: 2.0)
    c = expo
    return _unary_apply(base, lambda x: torch.pow(x, c),
                        lambda x, y: c * torch.pow(x, c - 1),
                        lambda x, y: c * (c - 1) * torch.pow(x, c - 2))


def _where_rule(func, args, kwargs):
    cond = _val(_arg(args, kwargs, 0, "condition"))
    a = _arg(args, kwargs, 1, "input")
    b = _arg(args, kwargs, 2, "other")
    return _select(cond, a, b)


def _select(take_a, a, b):
    """Channels follow the branch the value takes."""
    av, _, _ = _parts(a)
    bv, _, _ = _parts(b)
    v = torch.where(take_a, av, bv)
    j = l = None
    if any(isinstance(t, Dual) and t.j is not None for t in (a, b)):
        K = _ndir(a, b)
        n = v.ndim
        ja = _pad_j(_j_or_zeros(a, K, v), n)
        jb = _pad_j(_j_or_zeros(b, K, v), n)
        j = _fit_j(torch.where(take_a, ja, jb), v.shape)
    if any(isinstance(t, Dual) and t.l is not None for t in (a, b)):
        l = _fit_l(torch.where(take_a, _l_or_zeros(a, v), _l_or_zeros(b, v)), v.shape)
    return make_dual(v, j, l)


def _maxmin_rule(take):
    def rule(func, args, kwargs):
        a, b = args[0], _arg(args, kwargs, 1, "other")
        return _select(take(_val(a), _val(b)), a, b)

    return rule


def _clamp_rule(func, args, kwargs):
    x = args[0]
    lo, hi = _arg(args, kwargs, 1, "min"), _arg(args, kwargs, 2, "max")
    if isinstance(lo, Dual) or isinstance(hi, Dual):
        return fallback_rule(func, args, kwargs)
    v, j, l = _parts(x)
    out = torch.clamp(v, lo, hi)
    inside = None
    if lo is not None:
        inside = v >= lo
    if hi is not None:
        inside = (v <= hi) if inside is None else inside & (v <= hi)
    return make_dual(out, None if j is None else torch.where(inside, j, 0.0),
                     None if l is None else torch.where(inside, l, 0.0))


def _logsumexp_rule(func, args, kwargs):
    v, j, l = _parts(args[0])
    dim = _arg(args, kwargs, 1, "dim")
    keepdim = _arg(args, kwargs, 2, "keepdim", False)
    out = torch.logsumexp(v, dim, keepdim)
    dims = dim if isinstance(dim, (tuple, list)) else (dim,)
    p = torch.exp(v - torch.logsumexp(v, dims, keepdim=True))  # softmax over dims
    jo = lo = None
    if j is not None:
        jdims = _jdim(tuple(dims), v.ndim)
        jm = torch.sum(p * j, jdims, keepdim=True)  # (K, ...) keepdim
        jo = jm if keepdim else torch.squeeze(jm, jdims)
        lo = torch.sum(p * torch.sum(j * j, 0), dims, keepdim) - torch.sum(
            jo * jo, 0)
    if l is not None:
        lo = _add(lo, torch.sum(p * l, dims, keepdim))
    return make_dual(out, jo, lo)


# -- products ---------------------------------------------------------------

def _stack_channels(v, j, l, dim):
    """v, the K rows of j and l stacked along ``dim`` of v: one tensor."""
    pieces = [v.unsqueeze(dim)]
    if j is not None:
        pieces.append(torch.movedim(j, 0, dim))
    if l is not None:
        pieces.append(l.unsqueeze(dim))
    return torch.cat(pieces, dim)


def _split_channels(out, dim, K, has_j, has_l):
    v = out.select(dim, 0)
    j = torch.movedim(out.narrow(dim, 1, K), dim, 0) if has_j else None
    l = out.select(dim, out.shape[dim] - 1) if has_l else None
    return v, j, l


def _one_dual_product(product, d, dim, out_dim):
    """Channels of a product linear in the dual ``d``: one product call on
    the channels stacked along ``dim`` of the operand, split along
    ``out_dim`` of the result."""
    v, j, l = _parts(d)
    K = 0 if j is None else j.shape[0]
    out = product(_stack_channels(v, j, l, dim))
    return _split_channels(out, out_dim, K, j is not None, l is not None)


def _matmul_rule(func, args, kwargs):
    a, b = _binary(func.__name__, args)
    av, bv = _val(a), _val(b)
    if isinstance(a, Dual) and not isinstance(b, Dual):
        return make_dual(*_one_dual_product(
            lambda s: torch.matmul(_pad_j(s, bv.ndim), bv), a, 0, 0))
    if isinstance(b, Dual) and not isinstance(a, Dual):
        if bv.ndim == 1:  # channels become columns of a matrix
            return make_dual(*_one_dual_product(lambda s: torch.matmul(av, s), b, 1,
                                                -1 if av.ndim > 1 else 0))
        return make_dual(*_one_dual_product(
            lambda s: torch.matmul(av, _pad_j(s, av.ndim)), b, 0, 0))
    if av.ndim < 2 or bv.ndim < 2:
        return fallback_rule(func, args, kwargs)
    v, ja, la = _one_dual_product(lambda s: torch.matmul(_pad_j(s, bv.ndim), bv), a, 0, 0)
    _, jb, lb = _one_dual_product(lambda s: torch.matmul(av, _pad_j(s, av.ndim)), b, 0, 0)
    j, l = _add(ja, jb), _add(la, lb)
    if a.j is not None and b.j is not None:
        n = max(av.ndim, bv.ndim)
        l = _add(l, 2.0 * torch.sum(torch.matmul(_pad_j(a.j, n), _pad_j(b.j, n)), 0))
    return make_dual(v, j, l)


def _linear_fn_rule(func, args, kwargs):
    x = args[0]
    w = _arg(args, kwargs, 1, "weight")
    bias = _arg(args, kwargs, 2, "bias")
    if isinstance(w, Dual) or isinstance(bias, Dual):
        return fallback_rule(func, args, kwargs)
    v, j, l = _one_dual_product(lambda s: torch.matmul(s, w.t()), x, 0, 0)
    return make_dual(v if bias is None else v + bias, j, l)


def _einsum_rule(func, args, kwargs):
    eq = args[0].replace(" ", "")
    ops = list(args[1]) if len(args) == 2 and isinstance(args[1], (list, tuple)) \
        else list(args[1:])
    duals = [i for i, o in enumerate(ops) if isinstance(o, Dual)]
    if "..." in eq or len(duals) > 2 or (len(duals) == 2 and len(ops) > 2):
        return fallback_rule(func, args, kwargs)
    if "->" in eq:
        lhs, out = eq.split("->")
    else:
        lhs = eq
        out = "".join(sorted(c for c in set(lhs) if c.isalpha() and lhs.count(c) == 1))
    subs = lhs.split(",")
    c = next(ch for ch in string.ascii_letters if ch not in eq)
    vals = [_val(o) for o in ops]

    def single(i, operands):
        s = subs[i]
        others = set("".join(subs[:i] + subs[i + 1:]))
        free = [ch for ch in s if ch in out and ch not in others]
        pos = s.index(free[0]) if free else 0
        opos = out.index(free[0]) if free else 0
        spec = ",".join(subs[:i] + [s[:pos] + c + s[pos:]] + subs[i + 1:])
        spec += "->" + out[:opos] + c + out[opos:]

        def product(stacked):
            o = list(operands)
            o[i] = stacked
            return torch.einsum(spec, *o)

        return _one_dual_product(product, ops[i], pos, opos)

    if len(duals) == 1:
        return make_dual(*single(duals[0], vals))
    a, b = ops
    v, ja, la = single(0, vals)
    _, jb, lb = single(1, vals)
    j, l = _add(ja, jb), _add(la, lb)
    if a.j is not None and b.j is not None:
        cross = torch.einsum(f"{c}{subs[0]},{c}{subs[1]}->{out}", a.j, b.j)
        l = _add(l, 2.0 * cross)
    return make_dual(v, j, l)


# -- the fallback ---------------------------------------------------------------

def fallback_rule(func, args, kwargs):
    """Exact local rule for a function without its own: the Laplacian chain
    rule l_out = J·l_in + Σ_d J_d^T H J_d by nested ``torch.func.jvp``, for
    this one call only.  Outputs that are not floating tensors (sizes,
    masks, indices) carry no channels and are not counted."""
    flat, spec = tree_flatten((args, kwargs))
    pos = [i for i, a in enumerate(flat) if isinstance(a, Dual)]
    duals = [flat[i] for i in pos]
    vs = tuple(d.v for d in duals)

    def g(*vals):
        leaves = list(flat)
        for i, x in zip(pos, vals):
            leaves[i] = x
        a, kw = tree_unflatten(leaves, spec)
        return func(*a, **kw)

    out = g(*vs)
    out_flat, out_spec = tree_flatten(out)
    if not any(isinstance(o, torch.Tensor) and o.is_floating_point() for o in out_flat):
        return out
    fallback_rule.calls += 1
    ls = tuple(_l_or_zeros(d, d.v) for d in duals)
    _, lin = jvp(g, vs, ls)
    K = _ndir(*duals)
    js = [_j_or_zeros(d, K, d.v) for d in duals]
    j_rows, quads = [], []
    for k in range(K):
        t = tuple(jd[k] for jd in js)
        jk, qk = jvp(lambda *z: jvp(g, z, t)[1], vs, t)
        j_rows.append(tree_flatten(jk)[0])
        quads.append(tree_flatten(qk)[0])
    lin_flat = tree_flatten(lin)[0]
    res = []
    for i, o in enumerate(out_flat):
        if isinstance(o, torch.Tensor) and o.is_floating_point():
            j = torch.stack([row[i] for row in j_rows])
            l = lin_flat[i] + torch.sum(torch.stack([q[i] for q in quads]), 0)
            res.append(make_dual(o, j, l))
        else:
            res.append(o)
    return tree_unflatten(res, out_spec)


fallback_rule.calls = 0


# ---------------------------------------------------------------------------
# the rule table, by function name
# ---------------------------------------------------------------------------

_PASSTHROUGH = (
    "shape", "dtype", "device", "ndim", "is_cuda", "requires_grad", "layout",
    "size", "dim", "numel", "stride", "is_contiguous", "data_ptr", "__len__",
    "__repr__", "__format__", "__bool__", "__float__", "item", "tolist", "numpy",
)
# float-valued but piecewise constant; outputs that are not floating (masks,
# indices) need no entry: the fallback returns them uncounted
_CONST = (
    "sign", "sgn", "floor", "ceil", "round", "trunc", "detach", "zeros_like",
    "ones_like", "empty_like", "full_like", "rand_like", "randn_like",
    "new_zeros", "new_ones", "new_empty", "new_full", "new_tensor",
)
_INPLACE = {
    "__iadd__", "__isub__", "__imul__", "__itruediv__", "__idiv__",
    "__ifloordiv__", "__imod__", "__ipow__", "__imatmul__", "__iand__",
    "__ior__", "__ixor__", "__ilshift__", "__irshift__", "__setitem__",
}

_RULES: dict = {}
for _name in _PASSTHROUGH:
    _RULES[_name] = _passthrough
for _name in _CONST:
    _RULES[_name] = _cmp_rule
for _name, (_u, _u1, _u2) in _UNARY.items():
    _RULES[_name] = _unary_rule(_u, _u1, _u2)
_RULES.update({
    "reshape": _reshape_rule, "view": _view_rule, "flatten": _flatten_rule,
    "squeeze": _squeeze_rule, "unsqueeze": _unsqueeze_rule,
    "permute": _permute_rule, "transpose": _transpose_rule, "T": _t_rule,
    "expand": _expand_rule, "__getitem__": _getitem_rule, "cat": _cat_rule,
    "concat": _cat_rule, "stack": _stack_rule, "chunk": _chunk_rule,
    "unbind": _unbind_rule,
    "sum": _reduce_rule(torch.sum), "mean": _reduce_rule(torch.mean),
    "neg": _channelwise(torch.neg), "__neg__": _channelwise(torch.neg),
    "clone": _channelwise(torch.clone),
    "contiguous": _channelwise(torch.Tensor.contiguous),
    "to": _channelwise(torch.Tensor.to), "float": _channelwise(torch.Tensor.float),
    "add": _add_sub_rule(+1), "__add__": _add_sub_rule(+1),
    "__radd__": _add_sub_rule(+1), "sub": _add_sub_rule(-1),
    "__sub__": _add_sub_rule(-1), "__rsub__": _add_sub_rule(-1),
    "mul": _mul_rule, "__mul__": _mul_rule, "__rmul__": _mul_rule,
    "div": _div_rule, "__truediv__": _div_rule, "__rtruediv__": _div_rule,
    "__rdiv__": _div_rule,
    "pow": _pow_rule, "__pow__": _pow_rule, "__rpow__": _pow_rule,
    "softplus": _softplus_rule,
    "where": _where_rule, "clamp": _clamp_rule, "clip": _clamp_rule,
    "maximum": _maxmin_rule(lambda a, b: a >= b),
    "minimum": _maxmin_rule(lambda a, b: a <= b),
    "logsumexp": _logsumexp_rule,
    "matmul": _matmul_rule, "__matmul__": _matmul_rule,
    "__rmatmul__": _matmul_rule, "einsum": _einsum_rule, "linear": _linear_fn_rule,
})


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def propagate(f: Callable, xs: torch.Tensor, directions: torch.Tensor):
    """(v, j, l) of ``f`` at ``xs`` (B, D) with the j channel seeded by
    ``directions`` (K, B, D): j = ∂f along each direction, l = Σ_k
    direction_kᵀ H direction_k (per sample, for sample-diagonal f).
    Channels that come out identically zero are returned as zeros."""
    with torch.no_grad():
        out = f(make_dual(xs, directions, None))
    v, j, l = _parts(out)
    K = directions.shape[0]
    return (v, j if j is not None else v.new_zeros((K,) + v.shape),
            l if l is not None else torch.zeros_like(v))


def forward_laplacian(f: Callable, xs: torch.Tensor, return_grad: bool = False):
    """Exact (∇²f, ∇f, f) at ``xs`` (B, D) in one pass: the drop-in for
    ``operators.diff_ops.exact_laplacian``.  Returns (lap (B, L), grad
    (B, L, D) or 0., fs (B, L)); ``f`` must be sample-diagonal."""
    B, D = xs.shape[0], xs.shape[-1]
    xs_flat = xs.reshape(B, D)
    eye = torch.eye(D, dtype=xs_flat.dtype, device=xs_flat.device)
    v, j, l = propagate(f, xs_flat, eye[:, None, :].expand(D, B, D))
    if return_grad:
        return l, torch.movedim(j, 0, -1), v
    return l, 0.0, v


def rademacher(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """±1 entries with equal odds, drawn from ``generator``."""
    bits = torch.randint(0, 2, shape, generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def hutchinson_laplacian(f: Callable, xs: torch.Tensor,
                         generator: torch.Generator, num_probes: int):
    """Unbiased stochastic Laplacian: (lap_est (B, L), fs (B, L)).

    ``num_probes`` Rademacher probes r_k (from ``generator``, on xs's
    device) seed the j channel, so the l channel is Σ_k r_kᵀ H r_k and
    E[lap_est] = ∇²f, at the cost of num_probes coordinate directions.
    """
    B, D = xs.shape[0], xs.shape[-1]
    xs_flat = xs.reshape(B, D)
    r = rademacher((num_probes, B, D), generator, xs_flat.dtype, xs_flat.device)
    v, _, l = propagate(f, xs_flat, r)
    return l / num_probes, v
