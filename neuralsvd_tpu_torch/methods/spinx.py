"""SpINx: the trace loss and per-mode residual losses with NTK-style weights.

Port of ``neuralsvd_tpu/methods/spinx.py``: ``spinx_losses`` (:23-40) and
``SpINx`` (``init_state`` :54-60, ``loss_and_grad`` :85-101,
``refresh_weights`` :123-137, ``eval_apply`` :139-142).  Gradients are
plain autograd through the Cholesky whitening and through Tφ (the
operator is called with ``with_graph=True``).  The EMA'd σ only feeds the
eval's whitening; the (L+1) loss weights are refreshed between blocks
from the squared gradient norms of the (L+1) losses, each its own
backward, so the (L+1) x P Jacobian is never held.  The state is written
in place (``sigma_avg`` and ``chol`` by the step, ``weights`` by the
refresh), which keeps a captured step's tensors.  The kernel-operator path
(``loss_and_grad_kernel``, and ``refresh_weights`` with ``kernel_op``,
:65-121) takes the batch as its own landmarks, or split, φ1 against the
landmarks x2 with σ from [φ1; φ2] (φ2 with its graph: σ enters the
loss).

``axis_name`` (a data-parallel process group, parallel/collectives.py, or
None): σ, π and the residual losses are averaged over the group's ranks
inside the differentiated function (``pmean_grad``, backward psum(ct)/n,
as JAX's ``shard_map(check_vma=False)`` transposes pmean).

``mode_axis`` (the tensor-parallel group, or None): the model is a rank's
share of the modes (``parallel.sharding.shard_module``); φ and Tφ (and
σ's rows) are gathered along the modes before ``spinx_losses``, and the
gradient is plain autograd through the gather, whose backward hands each
rank its modes' slice.  The batch is then one global batch split over the
dp ranks (the JAX GSPMD path's semantics).  Through ``pmean_grad`` a dp
rank's gradient is n_dp times its share of the global batch's (the
summed cotangent flows back to every rank's rows), so it is divided by
n_dp, and the train step's sum over dp gives the one-process gradient.
The refresh's squared norms are those of the whole gradient: a per-mode
leaf's gradient is whole on its rank and its squares are summed over tp;
a replicated leaf upstream of the gather has a partial gradient on each
rank, summed over tp (and every leaf's share over dp) before it is
squared.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from neuralsvd_tpu_torch.methods.spin import JITTER, cholesky_or_nan, spin_step
from neuralsvd_tpu_torch.parallel.collectives import (
    axis_size,
    gather_modes,
    pmean_grad,
    psum,
    psum_flat,
)
from neuralsvd_tpu_torch.parallel.mesh import mode_layout


def spinx_losses(phi, Tphi, phi1, axis_name=None):
    """((L+1,) losses [trace, per-mode residuals], the batch σ of ``phi1``).

    JAX weighs the trace by ``trace_weights``, constant ones
    (``spinx.py:52``); the sum is taken unweighted here.
    """
    sigma = pmean_grad(phi1.T @ phi1 / phi1.shape[0], axis_name)
    pi = pmean_grad(phi.T @ Tphi / phi.shape[0], axis_name)
    _, chol_inv, _, eigvals = spin_step(sigma, pi)
    residuals = Tphi @ chol_inv.T - (phi @ chol_inv.T) @ torch.diag(eigvals)
    losses = torch.cat([torch.sum(eigvals)[None],
                        pmean_grad(torch.mean(residuals ** 2, dim=0), axis_name)])
    return losses, sigma


class SpINx:
    name = "spinx"

    def __init__(self, model: nn.Module, neigs: int, decay: float = 0.01,
                 axis_name=None, mode_axis=None):
        self.model = model
        self.neigs = neigs
        self.decay = decay
        self.axis_name = axis_name
        self.mode_axis = mode_axis
        self.mode_axes, self.pre_gather = mode_layout(model)

    def init_state(self, params):
        p0 = next(iter(params.values()))
        L = self.neigs
        return {"sigma_avg": p0.new_zeros((L, L)),
                "chol": torch.eye(L, dtype=p0.dtype, device=p0.device),
                "weights": p0.new_ones((L + 1,))}

    def _apply(self, params, x):
        return functional_call(self.model, params, (x,))

    def _loss_vector(self, params, x, operator, importance, split_batch=False,
                     kernel_op=None):
        """((L+1,) losses, σ, φ, Tφ) on the operator, or with ``kernel_op``
        (``landmarks -> operator``) on the kernel path, split or not."""
        model = lambda xx: self._apply(params, xx)  # noqa: E731
        modes = lambda t: gather_modes(t, self.mode_axis, self.neigs)  # noqa: E731
        if kernel_op is None:
            Tphi, phi = operator(model, x, importance, with_graph=True)
            phi_sigma = phi = modes(phi)
        elif split_batch:
            if x.shape[0] % 2:
                raise ValueError("the batch must split into two equal halves")
            x1, x2 = torch.chunk(x, 2)
            Tphi, phi = kernel_op(x2)(model, x1, importance, with_graph=True)
            phi = modes(phi)
            phi_sigma = torch.cat([phi, modes(model(x2))])
        else:
            Tphi, phi = kernel_op(x)(model, x, importance, with_graph=True)
            phi_sigma = phi = modes(phi)
        Tphi = modes(Tphi)
        losses, sigma = spinx_losses(phi, Tphi, phi_sigma, self.axis_name)
        return losses, sigma, phi, Tphi

    def _share(self) -> float:
        """What a dp rank's gradient is multiplied by to be its share of
        the global batch's: 1/n_dp under ``mode_axis``, else 1 (the
        shard_map path's sum of whole local gradients, as JAX's)."""
        return 1.0 / axis_size(self.axis_name) if self.mode_axis is not None else 1.0

    def loss_and_grad(self, params, state, x, operator, importance=None):
        """(loss, grads {name: tensor}, aux {f, Tf, eigvals=None}, state);
        ``sigma_avg`` and ``chol`` are updated in place."""
        return self._step(params, state, self._loss_vector(params, x, operator, importance))

    def loss_and_grad_kernel(self, params, state, x, get_approx_kernel_op,
                             importance=None, split_batch: bool = False):
        """The kernel-operator path (``get_approx_kernel_op(landmarks)`` an
        operator); returns as ``loss_and_grad``, aux {f: φ1, Tf: Kφ1}
        when split."""
        return self._step(params, state, self._loss_vector(
            params, x, None, importance, split_batch, get_approx_kernel_op))

    def _step(self, params, state, loss_vector):
        losses, sigma, phi, Tphi = loss_vector
        loss = torch.sum(losses * state["weights"] / self.neigs)
        names = list(params)
        grads = torch.autograd.grad(loss * self._share(), [params[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            sigma_avg = state["sigma_avg"].lerp_(sigma, self.decay)
            eye = torch.eye(self.neigs, dtype=sigma_avg.dtype, device=sigma_avg.device)
            state["chol"].copy_(cholesky_or_nan(sigma_avg + JITTER * eye))
        return (loss.detach(), dict(zip(names, grads)),
                dict(f=phi.detach(), Tf=Tphi.detach(), eigvals=None), state)

    def refresh_weights(self, params, state, x, operator, importance=None,
                        split_batch: bool = False, kernel_op=None):
        """weights = sqrt(Σ ntk / ntk), ntk[i] the squared norm of loss i's
        gradient over every parameter; written into ``state["weights"]``,
        which is returned.  ``kernel_op`` (with ``split_batch``) takes the
        kernel path's losses, as in ``loss_and_grad_kernel``."""
        losses, *_ = self._loss_vector(params, x, operator, importance, split_batch,
                                       kernel_op)
        names = list(params)
        tp = self.mode_axis
        sharded = [k for k in names if tp is not None and k in self.mode_axes]
        pre = [k for k in names if tp is not None and k in self.pre_gather]
        zero = losses.new_zeros(())
        n = losses.shape[0]
        ntk = []
        for i in range(n):
            grads = dict(zip(names, torch.autograd.grad(
                losses[i] * self._share(), [params[k] for k in names],
                retain_graph=i < n - 1, allow_unused=True, materialize_grads=True)))
            if tp is not None:  # the whole gradient: shares summed before squaring
                grads = dict(zip(names, psum_flat(grads.values(), self.axis_name)))
                grads.update(zip(pre, psum_flat([grads[k] for k in pre], tp)))
            squares = {k: torch.sum(g * g) for k, g in grads.items()}
            ntk.append(torch.stack([sum((squares[k] for k in sharded), zero),
                                    sum((v for k, v in squares.items() if k not in sharded),
                                        zero)]))
        with torch.no_grad():
            ntk = torch.stack(ntk)  # (L+1, 2): the sharded leaves' squares, the rest's
            ntk = psum(ntk[:, 0], tp) + ntk[:, 1]
            state["weights"].copy_(torch.sqrt(torch.sum(ntk) / ntk))
        return state

    def eval_apply(self, params, state, x):
        out = self._apply(params, x)
        return torch.linalg.solve_triangular(state["chol"], out.T, upper=False).T
