"""NeuralEF / mu-EigenGame: the loss and the method behind the EVD interface.

Port of ``neuralsvd_tpu/methods/neuralef.py``: ``neuralef_loss`` (:22-73),
a ``torch.autograd.Function`` whose backward returns the saved terms
scaled, 4x the variance term and 2x each align term, and nothing for Tφ.
This is deliberately NOT the gradient of the forward scalar; do not "fix"
it.  ``NeuralEigenfunctions`` (:76-241) divides the model's outputs by
their batch L2 norm while training (the gradient flows through the norm)
and keeps EMAs of those norms, which the eval divides by.

The batch norm couples the rows of a batch, so under finite differences φ
must come from the same stacked model call as the probe points, as in the
JAX package: the training model is marked ``batch_coupled`` and
``operators/diff_ops.VectorizedLaplacian`` then takes fs from that call,
with autograd on.  The exact engines move all rows together (global
coordinate shifts), so there Tφ includes the norm's dependence on the
shifted batch, as in JAX.

The EMA state (``norm_biased``, ``norm_unbiased`` (1, L) and
``initialized``, a bool tensor) is returned by ``loss_and_grad`` and
written in place by the train step (``train_state.assign_state``), also
on a skipped step, as JAX keeps it; so a captured step updates it on
every replay.  The kernel-operator path (``loss_and_grad_kernel``,
JAX's :218-241) takes the same loss; split, each half is smoothed over
the other as landmarks.

``axis_name`` (a data-parallel process group, parallel/collectives.py, or
None): the loss's grams and the loss itself are averaged over the group's
ranks, and so is the squared batch norm, inside the differentiable model
(``pmean_grad``, whose backward sums the cotangents over the ranks as
JAX's ``shard_map(check_vma=False)`` transposes pmean); the variance and
align terms keep the local batch sizes, as in JAX.

``mode_axis`` (a tp process group, or None): ``model`` is a rank's share of
the modes; the batch norm divides each of its modes by that mode's own
norm, and the operator's φ and Tφ are all-gathered along the modes
(``parallel.collectives.gather_modes``) before the loss, as are the raw
outputs from which the norm EMAs, (1, L) on every rank, are updated.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from neuralsvd_tpu_torch.ops.gram import compute_gram
from neuralsvd_tpu_torch.parallel.collectives import gather_modes, pmean, pmean_grad


class NeuralEFLoss(torch.autograd.Function):
    """(unbiased, diagonal, axis_name, φ, Tφ, φ1, Tφ1, φ2, Tφ2) -> scalar loss.

    ``unbiased``: coefficients from the plain grams of φ1, φ2
    (mu-EigenGame), else from the quad forms normalised by their diagonal
    (+1e-5, the original NeuralEF); both keep ``triu(k=diagonal)``.
    """

    @staticmethod
    def forward(ctx, unbiased, diagonal, axis_name, phi, Tphi, phi1, Tphi1,
                phi2, Tphi2):
        variance = -Tphi / phi.shape[0]
        if unbiased:
            coeff1 = torch.triu(compute_gram(phi1, axis_name=axis_name), diagonal)
            coeff2 = torch.triu(compute_gram(phi2, axis_name=axis_name), diagonal)
        else:
            quad1 = compute_gram(phi1, Tphi1, axis_name)
            quad2 = compute_gram(phi2, Tphi2, axis_name)
            coeff1 = torch.triu(quad2, diagonal) / (torch.diagonal(quad2) + 1e-5)[:, None]
            coeff2 = torch.triu(quad1, diagonal) / (torch.diagonal(quad1) + 1e-5)[:, None]
        align1 = torch.einsum("bl...,lm->bm...", Tphi1, coeff1) / phi1.shape[0]
        align2 = torch.einsum("bl...,lm->bm...", Tphi2, coeff2) / phi2.shape[0]
        loss = (torch.sum(phi * variance)
                + 0.5 * (torch.sum(phi1 * align1) + torch.sum(phi2 * align2)))
        ctx.save_for_backward(variance, align1, align2)
        return pmean(loss, axis_name)

    @staticmethod
    def backward(ctx, g):
        variance, align1, align2 = ctx.saved_tensors
        # the estimator's scaling (neuralsvd_tpu/methods/neuralef.py:65-70)
        return (None, None, None, g * 4 * variance, None, g * 2 * align1, None,
                g * 2 * align2, None)


def neuralef_loss(unbiased: bool, diagonal: int, phi, Tphi, phi1, Tphi1,
                  phi2, Tphi2, axis_name=None) -> torch.Tensor:
    return NeuralEFLoss.apply(unbiased, diagonal, axis_name, phi, Tphi, phi1,
                              Tphi1, phi2, Tphi2)


def batch_norm(out: torch.Tensor, axis_name=None) -> torch.Tensor:
    """(B, L) -> (1, L): sqrt(Σ_b out² / B), written with the ops the
    forward-Laplacian engine has rules for (``torch.linalg.norm`` would
    take its fallback); with a group, the square root of the mean of the
    ranks' squares, differentiable (``pmean_grad``)."""
    return torch.sqrt(pmean_grad(torch.sum(out * out, dim=0, keepdim=True) / out.shape[0],
                                 axis_name))


class NeuralEigenfunctions:
    """NeuralEF behind the uniform method interface.

    ``batchnorm_mode``: "biased" | "unbiased" | "none": whether the model's
    outputs are divided by their batch L2 norm in training, and which EMA
    of it the eval divides by.
    """

    name = "neuralef"
    momentum = 0.9  # of the norm EMAs

    def __init__(self, model: nn.Module, neigs: int,
                 batchnorm_mode: str = "unbiased", unbiased: bool = False,
                 include_diag: bool = False, sort: bool = False,
                 axis_name=None, mode_axis=None):
        if batchnorm_mode not in ("biased", "unbiased", "none"):
            raise ValueError(f"unknown batchnorm_mode {batchnorm_mode!r}")
        self.model = model
        self.neigs = neigs
        self.batchnorm_mode = batchnorm_mode
        self.unbiased = unbiased
        self.diagonal = 0 if include_diag else 1
        self.sort = sort  # read by callers, as in the JAX package
        self.axis_name = axis_name
        self.mode_axis = mode_axis
        self.eigvals: Optional[np.ndarray] = None
        self.sort_indices: Optional[np.ndarray] = None

    def register_eigvals(self, eigvals):
        self.eigvals = np.asarray(eigvals)
        self.sort_indices = np.argsort(self.eigvals)[::-1].copy()

    def reset_eigvals(self):
        self.eigvals = None
        self.sort_indices = None

    def init_state(self, params):
        if self.batchnorm_mode == "none":
            return {}
        device = next(iter(params.values())).device
        return {
            "norm_biased": torch.ones((1, self.neigs), device=device),
            "norm_unbiased": torch.ones((1, self.neigs), device=device),
            "initialized": torch.zeros((), dtype=torch.bool, device=device),
        }

    def _raw(self, params, x):
        out = functional_call(self.model, params, (x,))
        if self.sort_indices is not None and self.mode_axis is None:
            out = out[:, torch.as_tensor(self.sort_indices).to(out.device)]
        return out

    def _modes(self, t):
        """All L modes of a rank's share ``t`` under ``mode_axis`` (then
        sorted), ``t`` itself without one."""
        if self.mode_axis is None:
            return t
        t = gather_modes(t, self.mode_axis, self.neigs)
        if self.sort_indices is not None:
            t = t[:, torch.as_tensor(self.sort_indices).to(t.device)]
        return t

    def _train_model(self, params, state):
        """(model, collect): ``model`` divides by the live batch norm (the
        gradient flows through it); ``collect(raw)`` gives the new EMA
        state from the unnormalised outputs of the batch."""
        if self.batchnorm_mode == "none":
            return (lambda x: self._raw(params, x)), (lambda raw: state)

        def model(x):
            out = self._raw(params, x)
            return out / batch_norm(out, self.axis_name)

        model.batch_coupled = True

        def collect(raw):
            with torch.no_grad():
                bn = batch_norm(raw, self.axis_name)
                init = state["initialized"]
                m = self.momentum
                biased = torch.where(init, m * state["norm_biased"] + (1 - m) * bn, bn)
                unbiased = torch.where(
                    init, torch.sqrt(m * state["norm_unbiased"] ** 2 + (1 - m) * bn ** 2),
                    bn)
                return {"norm_biased": biased, "norm_unbiased": unbiased,
                        "initialized": torch.ones_like(init)}

        return model, collect

    def eval_apply(self, params, state, x):
        out = functional_call(self.model, params, (x,))
        if self.batchnorm_mode == "none":
            return out
        key = "norm_biased" if self.batchnorm_mode == "biased" else "norm_unbiased"
        return out / state[key]

    def register_norm(self, params, state, data, batch_size: int = 8192):
        """A new state whose norms are the exact L2 norms of the outputs
        over ``data`` (Σ f² accumulated in full batches of ``batch_size``
        and one ragged tail, as the JAX package sums them)."""
        if self.batchnorm_mode == "none":
            return state
        device = next(iter(params.values())).device
        data = torch.as_tensor(data, device=device)
        n = data.shape[0]
        sq = torch.zeros((1, self.neigs), device=device)
        with torch.no_grad():
            for i in range(0, n, batch_size):
                f = functional_call(self.model, params, (data[i:i + batch_size],))
                sq = sq + torch.sum(f * f, dim=0, keepdim=True)
        norm = torch.sqrt(sq / n)
        return {**state, "norm_biased": norm, "norm_unbiased": norm.clone(),
                "initialized": torch.ones((), dtype=torch.bool, device=device)}

    def loss_and_grad(self, params, state, x, operator, importance=None):
        """(loss, grads {name: tensor}, aux {f, Tf, eigvals}, new state)."""
        model, collect = self._train_model(params, state)
        Tphi, phi = (self._modes(t) for t in operator(model, x, importance))
        if phi.shape[0] % 2:
            raise ValueError("the batch must split into two equal halves")
        phi1, phi2 = torch.chunk(phi, 2)
        Tphi1, Tphi2 = torch.chunk(Tphi, 2)
        loss = neuralef_loss(self.unbiased, self.diagonal, phi, Tphi, phi1, Tphi1,
                             phi2, Tphi2, self.axis_name)
        return self._finish(params, x, collect, loss, phi, Tphi)

    def loss_and_grad_kernel(self, params, state, x, get_approx_kernel_op,
                             importance=None, split_batch: bool = False):
        """The kernel-operator path: ``get_approx_kernel_op(landmarks)`` is
        an operator (``operators.base.KernelOperator``).  Without
        ``split_batch`` the batch is its own landmarks and every term of
        the loss sees the whole batch; with it Kφ1 takes the landmarks x2
        and Kφ2 the landmarks x1.  Returns as ``loss_and_grad``."""
        model, collect = self._train_model(params, state)
        if split_batch:
            if x.shape[0] % 2:
                raise ValueError("the batch must split into two equal halves")
            x1, x2 = torch.chunk(x, 2)
            Kphi1, phi1 = (self._modes(t) for t in
                           get_approx_kernel_op(x2)(model, x1, importance))
            Kphi2, phi2 = (self._modes(t) for t in
                           get_approx_kernel_op(x1)(model, x2, importance))
            phi, Kphi = torch.cat([phi1, phi2]), torch.cat([Kphi1, Kphi2])
            loss = neuralef_loss(self.unbiased, self.diagonal, phi, Kphi, phi1, Kphi1,
                                 phi2, Kphi2, self.axis_name)
        else:
            Kphi, phi = (self._modes(t) for t in get_approx_kernel_op(x)(model, x, importance))
            loss = neuralef_loss(self.unbiased, self.diagonal, phi, Kphi, phi, Kphi,
                                 phi, Kphi, self.axis_name)
        return self._finish(params, x, collect, loss, phi, Kphi)

    def _finish(self, params, x, collect, loss, phi, Tphi):
        """The new norm state from the unnormalised outputs on ``x``, and
        the gradients of ``loss``."""
        with torch.no_grad():
            new_state = collect(self._modes(self._raw(params, x)))  # unnormalised outputs
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        return (loss.detach(), dict(zip(names, grads)),
                dict(f=phi.detach(), Tf=Tphi, eigvals=None), new_state)
