"""Operator protocol helpers.

Port of ``neuralsvd_tpu/operators/base.py``: ``OperatorWrapper`` (:7-37),
``MatrixOperator`` (:39-51) and ``KernelOperator`` (:54-71);
``generator=`` takes the place of JAX's ``key=``, and every operator takes
the port's call keywords (``generator``, ``with_graph``).
``DeviceConstant`` keeps a potential's constant arrays (and an operator's
matrix or fixed landmarks) on the input's device.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


class DeviceConstant:
    """A potential's constant array (``cs``, ``coords``, ``charges``, the
    electron pairs) with its tensors, one per (dtype, device), each made at
    its first use and kept on this object, which the potential holds for
    its lifetime.  A step captured in a CUDA graph, whose eager warm-up
    made the tensor, then copies nothing from the host (a host-to-device
    copy cannot be captured).  Callers must not write to the tensors."""

    def __init__(self, a):
        self.array = np.asarray(a)
        self._tensors: dict = {}

    def like(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        key = (dtype or x.dtype, x.device)
        t = self._tensors.get(key)
        if t is None:
            t = self._tensors[key] = torch.tensor(self.array, dtype=key[0],
                                                  device=key[1])
        return t


def graph_mode(with_graph: bool):
    """The context an operator computes Tf in: the ambient grad mode with
    ``with_graph`` (SpIN and SpINx differentiate through Tf), else
    ``torch.no_grad()``."""
    return contextlib.nullcontext() if with_graph else torch.no_grad()


def device_constant(a, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``a`` as a tensor of ``dtype`` (default: ``like``'s) on ``like``'s
    device: the kept tensor of a ``DeviceConstant``, else a new copy of
    the array (a potential called directly, outside an operator)."""
    if isinstance(a, DeviceConstant):
        return a.like(like, dtype)
    return torch.tensor(np.asarray(a), dtype=dtype or like.dtype, device=like.device)


class OperatorWrapper:
    """Affine spectral transform ``T -> scale*T + shift*I``.

    Shifts/scales the spectrum so the top-L eigenvalues are positive and
    well separated.  The ``shift·fs`` term joins Tf without a gradient, like
    the rest of Tf, unless the call asks for Tf ``with_graph``.
    """

    def __init__(self, operator, scale: float = 1.0, shift: float = 0.0):
        self.operator = operator
        self.scale = scale
        self.shift = shift

    @property
    def singular_at_origin(self) -> bool:
        """Forwarded from the wrapped operator (the spectrum eval zeroes
        T(phi) at the origin only for singular potentials)."""
        return getattr(self.operator, "singular_at_origin", False)

    @property
    def needs_key(self) -> bool:
        """Forwarded: True for stochastic operators (the Hutchinson
        Laplacian), which want a probe generator bound by the train step."""
        return getattr(self.operator, "needs_key", False)

    def __call__(self, f, x, importance=None, generator=None,
                 with_graph: bool = False):
        kw = {"with_graph": True} if with_graph else {}
        if generator is not None and self.needs_key:
            kw["generator"] = generator
        Tf, fs = self.operator(f, x, importance, **kw)
        with graph_mode(with_graph):
            Tf = self.scale * Tf + self.shift * fs
        return Tf, fs


def _on_device(a):
    """A tensor stays as it is (moved to the input's device and dtype at
    use, a no-op where they match: the split-batch landmarks of the kernel
    paths); any other array becomes a ``DeviceConstant``."""
    return a if isinstance(a, torch.Tensor) else DeviceConstant(a)


def _like(a, x: torch.Tensor) -> torch.Tensor:
    if isinstance(a, DeviceConstant):
        return a.like(x)
    return a.to(device=x.device, dtype=x.dtype)


class MatrixOperator:
    """Finite symmetric operator ``(Tf)(x_b) = (A f)_b`` on a fixed grid:
    A (B, B) applied to the batch's function values, the trivial oracle
    operator for tests.  Tf carries no autograd graph unless the call asks
    for it ``with_graph``; fs always does."""

    def __init__(self, A):
        self.A = _on_device(A)

    def __call__(self, f, x, importance=None, generator=None,
                 with_graph: bool = False):
        fs = f(x)
        with graph_mode(with_graph):
            Tf = _like(self.A, fs) @ fs
        return Tf, fs


class KernelOperator:
    """Empirical kernel smoothing operator ``(Tf)(x) = E_{x'}[k(x, x') f(x')]``
    over the landmark batch ``landmarks`` (B', D): ``kernel(x, xp) -> (B,
    B')``, built on the device of ``x``.  Fixed landmarks given as an array
    are kept on each device once (a captured step copies nothing from the
    host); a tensor (the other half of a split batch) is used where it is.
    The model's values at the landmarks, the kernel matrix and Tf carry
    no autograd graph unless the call asks for it ``with_graph`` (SpIN and
    SpINx); fs always does.  ``importance`` is ignored, as in JAX."""

    def __init__(self, kernel, landmarks):
        self.kernel = kernel
        self.landmarks = _on_device(landmarks)

    def __call__(self, f, x, importance=None, generator=None,
                 with_graph: bool = False):
        fs = f(x)
        land = _like(self.landmarks, x)
        with graph_mode(with_graph):
            f_land = f(land)
            Tf = self.kernel(x, land) @ f_land / land.shape[0]
        return Tf, fs
