"""Differential operators: the exact and finite-difference Laplacians.

Port of ``neuralsvd_tpu/operators/diff_ops.py``.

- ``exact_laplacian``: nested forward-mode JVPs (``torch.func.jvp``),
  vmapped over the coordinate directions — the JAX package's independent
  oracle (``laplacian_mode="jvp"``).
- ``batched_fd_laplacian``: central differences, all 2D+1 probe points
  stacked into one model call.
- ``VectorizedLaplacian`` routes the exact Laplacian to the
  forward-Laplacian engine (``exact_mode="forward"``, the default,
  ``ops/forward_laplacian.py``) or to ``exact_laplacian`` ("jvp"), and,
  with ``num_probes > 0`` and a ``generator``, to the Hutchinson estimator.

By default the Laplacian carries no autograd graph: it is computed under
``torch.no_grad()`` (forward-mode tangents are still computed there),
because the EVD losses send no gradient through Tf (ops/nestedlora.py).
``fs`` is computed by a separate model call in the ambient grad mode, as
``(√w·f(x)) / clip(√w, 1e-5)`` under importance conjugation, so gradients
reach the parameters through it.  That is right for a function whose rows
depend on their own inputs only.  A function marked ``batch_coupled``
(NeuralEF's training model, which divides by the batch L2 norm of its own
input rows) takes, under finite differences, fs from the stacked call on
the (2D+1)·B probe rows, with autograd on, as the JAX package does: its
rows are normalised over all the probe rows, and the backward runs over
them.  The exact engines need no such care: their fs is the model on the B
rows in JAX too.

SpIN and SpINx differentiate through Tf (``neuralsvd_tpu/methods/spin.py:90,105``,
``spinx.py:85-101``): a call with ``with_graph=True`` returns lap, grad and
fs with their graphs: under finite differences all from the stacked
(2D+1)·B-row call; on nested JVPs from JVPs taken in grad mode (reverse
over forward); on the forward-Laplacian engine and the Hutchinson
estimator (given a generator) from the engine run in grad mode, fs its
value channel, as ``jax.grad`` differentiates the JAX interpreter
(``tests/test_forward_laplacian.py:69-91``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jvp, vmap

from neuralsvd_tpu_torch.ops.forward_laplacian import (
    forward_laplacian,
    hutchinson_laplacian,
)


def batched_fd_laplacian(f: Callable, xs: torch.Tensor, eps: float,
                         return_grad: bool = False):
    """Finite-difference Laplacian of vector-valued ``f`` at ``xs`` (B, D).

    Returns (lap (B, L), grad (B, L, D) or 0., fs (B, L)).
    """
    B, D = xs.shape[0], xs.shape[-1]
    xs_flat = xs.reshape(B, D)
    eye = torch.eye(D, dtype=xs_flat.dtype, device=xs_flat.device) * eps
    plus = xs_flat[None, :, :] + eye[:, None, :]    # (D, B, D)
    minus = xs_flat[None, :, :] - eye[:, None, :]   # (D, B, D)
    probes = torch.cat([xs_flat[None], plus, minus], dim=0)  # (2D+1, B, D)
    out = f(probes.reshape((2 * D + 1) * B, D))
    out = out.reshape(2 * D + 1, B, *out.shape[1:])
    fs = out[0]
    f_plus = out[1:D + 1]
    f_minus = out[D + 1:]
    lap = (f_plus.sum(0) + f_minus.sum(0) - 2 * D * fs) / (eps ** 2)
    if return_grad:
        grad = torch.movedim((f_plus - f_minus) / (2 * eps), 0, -1)
        return lap, grad, fs
    return lap, 0.0, fs


def conjugate(f: Callable, importance: Callable) -> Callable:
    """g = √w·f, marked ``batch_coupled`` where f is."""
    def g(x):
        return torch.sqrt(importance(x)) * f(x)

    g.batch_coupled = getattr(f, "batch_coupled", False)
    return g


def _nested_jvp_laplacian(f: Callable, xs_flat: torch.Tensor):
    """(∇²f, ∂f stacked over directions (D, B, L)): a pair of JVPs along
    each e_i, vmapped over the D directions as in the JAX package (one
    batched pass instead of D, which halves the per-op dispatch cost that
    dominates nested forward-mode AD in eager PyTorch)."""
    B, D = xs_flat.shape
    dirs = torch.eye(D, dtype=xs_flat.dtype, device=xs_flat.device)
    dirs = dirs[:, None, :].expand(D, B, D)

    def second_dir(e):
        def first_dir(x):
            return jvp(f, (x,), (e,))[1]

        return jvp(first_dir, (xs_flat,), (e,))  # ∂_i f, ∂²_i f

    grads, seconds = vmap(second_dir)(dirs)
    return seconds.sum(0), grads


def exact_laplacian(f: Callable, xs: torch.Tensor, return_grad: bool = False):
    """Exact Laplacian by nested forward-mode JVPs along each e_i.

    Returns (lap, grad (B, L, D) or 0., fs).
    """
    xs_flat = xs.reshape(xs.shape[0], xs.shape[-1])
    lap, grads = _nested_jvp_laplacian(f, xs_flat)
    fs = f(xs_flat)
    if return_grad:
        return lap, torch.movedim(grads, 0, -1), fs
    return lap, 0.0, fs


class VectorizedLaplacian:
    """Laplacian with optional importance-weighted conjugation.

    eps > 0 selects finite differences; eps <= 0 the exact Laplacian, by
    the forward-Laplacian engine (``exact_mode="forward"``, the default:
    one pass carrying value, D directional derivatives and the Laplacian)
    or by nested JVPs ("jvp", the independent oracle).  ``num_probes`` > 0
    (with eps <= 0) selects the unbiased Hutchinson estimator: its
    Rademacher probes seed the same engine and come from a
    ``torch.Generator`` the caller passes (``needs_key``); a call without
    one (the spectrum eval) takes the exact engine.  With a sampling
    density w the Laplacian of g = √w·f is taken and √w (clipped at 1e-5)
    divided out.
    """

    def __init__(self, eps: float = 1e-5, exact_mode: str = "forward",
                 num_probes: int = 0):
        if exact_mode not in ("forward", "jvp"):
            raise ValueError(f"unknown exact_mode {exact_mode!r}")
        self.eps = eps
        self.exact_mode = exact_mode
        self.num_probes = num_probes

    @property
    def needs_key(self) -> bool:
        """True for the stochastic (Hutchinson) Laplacian, which wants a
        probe generator per call."""
        return self.eps <= 0 and self.num_probes > 0

    def _lap(self, f, xs, return_grad, generator=None):
        """(lap, grad or 0.) without an autograd graph; fs is left to the
        caller, which computes it in the ambient grad mode."""
        with torch.no_grad():
            if self.eps > 0:
                lap, grad, _ = batched_fd_laplacian(f, xs, self.eps, return_grad)
                return lap, grad
            if self.needs_key and generator is not None:
                if return_grad:
                    raise ValueError(
                        "the Hutchinson Laplacian carries probe derivatives, "
                        "not the gradient; use an exact mode for return_grad")
                lap, _ = hutchinson_laplacian(f, xs, generator, self.num_probes)
                return lap, 0.0
            if self.exact_mode == "forward":
                lap, grad, _ = forward_laplacian(f, xs, return_grad)
                return lap, grad
            lap, grads = _nested_jvp_laplacian(f, xs)
        return lap, (torch.movedim(grads, 0, -1) if return_grad else 0.0)

    def _lap_and_fs(self, f, xs, return_grad, generator, with_graph=False):
        """(lap, grad or 0., fs): lap and grad without an autograd graph, fs
        with one (from the stacked probe call for a ``batch_coupled`` f
        under finite differences); with ``with_graph`` all three with one."""
        if with_graph:
            return self._lap_with_graph(f, xs, return_grad, generator)
        if self.eps > 0 and getattr(f, "batch_coupled", False):
            lap, grad, fs = batched_fd_laplacian(f, xs, self.eps, return_grad)
            return lap.detach(), (grad.detach() if return_grad else grad), fs
        lap, grad = self._lap(f, xs, return_grad, generator)
        return lap, grad, f(xs)

    def _lap_with_graph(self, f, xs, return_grad, generator):
        """(lap, grad or 0., fs), each with its autograd graph."""
        if self.eps > 0:
            return batched_fd_laplacian(f, xs, self.eps, return_grad)
        if self.needs_key and generator is not None:
            if return_grad:
                raise ValueError(
                    "the Hutchinson Laplacian carries probe derivatives, "
                    "not the gradient; use an exact mode for return_grad")
            lap, fs = hutchinson_laplacian(f, xs, generator, self.num_probes,
                                           with_graph=True)
            return lap, 0.0, fs
        if self.exact_mode == "forward":
            return forward_laplacian(f, xs, return_grad, with_graph=True)
        lap, grads = _nested_jvp_laplacian(f, xs)
        return lap, (torch.movedim(grads, 0, -1) if return_grad else 0.0), f(xs)

    def __call__(self, f: Callable, xs: torch.Tensor,
                 importance: Optional[Callable] = None,
                 return_grad: bool = False,
                 generator: Optional[torch.Generator] = None,
                 with_graph: bool = False):
        xs = xs.reshape(xs.shape[0], -1)
        if importance is None:
            return self._lap_and_fs(f, xs, return_grad, generator, with_graph)
        lap_g, grad_g, gs = self._lap_and_fs(conjugate(f, importance), xs,
                                             return_grad, generator, with_graph)
        sqrt_ws = torch.clamp(torch.sqrt(importance(xs)), min=1e-5)  # (B, 1)
        lap = lap_g / sqrt_ws
        fs = gs / sqrt_ws
        if return_grad:
            return lap, grad_g / sqrt_ws[..., None], fs
        return lap, grad_g, fs
